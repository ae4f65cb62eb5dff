"""Continuous-batching GPT serving over a paged KV pool."""
from .engine import Request, ServingEngine
from .paged_kv import PagedKVCache
from .prefix_cache import PrefixCache
from .drafters import ngram_draft
from .tier_store import HostTierStore

__all__ = ["HostTierStore", "PagedKVCache", "PrefixCache", "Request",
           "ServingEngine", "ngram_draft"]
