"""Continuous-batching GPT serving over a paged KV pool, and the
in-process serving cluster over it (router, autoscaler, chaos)."""
from .engine import Request, ServingEngine
from .paged_kv import PagedKVCache
from .prefix_cache import PrefixCache
from .drafters import ngram_draft
from .tier_store import HostTierStore
from .cluster import (ServingCluster, ClusterRequest, ClusterOverloaded,
                      RequestExpired, RequestCancelled, ClusterClosed,
                      ClusterFailed)
from .autoscaler import Autoscaler, HistogramWindow
from .chaos import ChaosDriver, ChaosEvent, chaos_schedule

__all__ = ["Autoscaler", "ChaosDriver", "ChaosEvent", "ClusterClosed",
           "ClusterFailed", "ClusterOverloaded", "ClusterRequest",
           "HistogramWindow", "HostTierStore", "PagedKVCache",
           "PrefixCache", "Request", "RequestCancelled", "RequestExpired",
           "ServingCluster", "ServingEngine", "chaos_schedule",
           "ngram_draft"]
