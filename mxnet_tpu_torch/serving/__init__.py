"""Continuous-batching GPT serving over a paged KV pool, and the
serving clusters over it: in process, and disaggregated over worker
processes (router, autoscaler, chaos), and the HTTP/SSE front door."""
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
from .http_frontend import ApiKeyTable, HttpFrontend

__all__ = ["ApiKeyTable", "Autoscaler", "ChaosDriver", "ChaosEvent", "ClusterClosed",
           "ClusterFailed", "ClusterOverloaded", "ClusterPrefixIndex",
           "ClusterRequest", "DisaggServingCluster", "HistogramWindow",
           "HostTierStore", "HttpFrontend", "PagedKVCache", "PrefixCache", "Request",
           "RequestCancelled", "RequestExpired", "ServingCluster",
           "ServingEngine", "chaos_schedule", "ngram_draft",
           "run_worker"]
