"""Continuous-batching GPT serving over a paged KV pool."""
from .engine import Request, ServingEngine
from .paged_kv import PagedKVCache

__all__ = ["PagedKVCache", "Request", "ServingEngine"]
