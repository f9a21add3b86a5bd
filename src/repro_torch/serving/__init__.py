from .engine import EngineStats, Request, ServingEngine
from .prefix_cache import PrefixCache, PrefixMatch, chunk_keys
from .sampler import Sampler

__all__ = ["EngineStats", "PrefixCache", "PrefixMatch", "Request",
           "Sampler", "ServingEngine", "chunk_keys"]
