"""Continuous-batching GPT serving over a paged KV pool, and the
serving clusters over it: in process, and disaggregated over worker
processes (router, autoscaler, chaos)."""
from .engine import Request, ServingEngine
from .paged_kv import PagedKVCache
from .prefix_cache import ClusterPrefixIndex, PrefixCache
from .drafters import ngram_draft
from .tier_store import HostTierStore
from .cluster import (ServingCluster, ClusterRequest, ClusterOverloaded,
                      RequestExpired, RequestCancelled, ClusterClosed,
                      ClusterFailed, DisaggServingCluster, run_worker)
from .autoscaler import Autoscaler, HistogramWindow
from .chaos import ChaosDriver, ChaosEvent, chaos_schedule

__all__ = ["Autoscaler", "ChaosDriver", "ChaosEvent", "ClusterClosed",
           "ClusterFailed", "ClusterOverloaded", "ClusterPrefixIndex",
           "ClusterRequest", "DisaggServingCluster", "HistogramWindow",
           "HostTierStore", "PagedKVCache", "PrefixCache", "Request",
           "RequestCancelled", "RequestExpired", "ServingCluster",
           "ServingEngine", "chaos_schedule", "ngram_draft",
           "run_worker"]
