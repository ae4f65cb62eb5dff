"""Continuous-batching GPT serving over a paged KV pool."""
from .engine import Request, ServingEngine
from .paged_kv import PagedKVCache
from .tier_store import HostTierStore

__all__ = ["HostTierStore", "PagedKVCache", "Request", "ServingEngine"]
