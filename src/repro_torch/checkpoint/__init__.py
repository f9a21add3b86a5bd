from .store import CheckpointStore

__all__ = ["CheckpointStore"]
