from .engine import EngineStats, Request, ServingEngine
from .sampler import Sampler

__all__ = ["EngineStats", "Request", "ServingEngine", "Sampler"]
