"""Serving on the port: the LM continuous-batching engine and sampling, the
paged KV cache and speculative decoding, and the prediction-query service
with its three-tier cache (plan-signature executable cache -> cross-query
materialized result cache -> cost-aware eviction/invalidation) plus
continuous-batching admission (latency-budget coalescing over
shape-bucketed executables), multi-tenant sessions, telemetry, and the
partition-parallel tier: the morsel scheduler and sharded executor, and
the hash-repartition exchange that shards non-co-partitioned equi-joins."""

from .admission import (AdmissionConfig, AdmissionLoop, AdmissionQueueFull,
                        Batcher, Clock, DeadlineUnmeetable, ManualClock,
                        ReadyGroup, SystemClock)
from .cache import CacheEntry, CostAwareCache, value_nbytes
from .context import RequestContext, Session, TenantPolicy
from .engine import InferenceEngine, Request, ServeConfig
from .exchange import (ExchangePlacement, choose_bucket_count, hash_buckets,
                       plan_exchange)
from .kv_cache import PagedKVCache
from .prediction_service import (AggStage, CompiledPrediction,
                                 DistributedSpec, ExchangeSpec, ExplainResult,
                                 PredictionService, PredictionTicket,
                                 ServiceStats, SubplanRef, TenantStats)
from .sampling import restrict_vocab, sample_token
from .speculative import SpecStats, greedy_decode, speculative_decode
from .sharded import (Morsel, ShardedExecutor, ShardPlacement, plan_morsels,
                      side_bucket_rows)
from .telemetry import (NULL_TRACE, MetricsRegistry, Span, Trace,
                        chrome_trace)

__all__ = ["InferenceEngine", "Request", "ServeConfig", "sample_token",
           "restrict_vocab", "PagedKVCache", "SpecStats", "greedy_decode",
           "speculative_decode",
           "PredictionService", "PredictionTicket", "CompiledPrediction",
           "DistributedSpec", "AggStage", "ExchangeSpec", "ServiceStats",
           "SubplanRef", "CostAwareCache",
           "CacheEntry", "value_nbytes", "AdmissionConfig", "AdmissionLoop",
           "AdmissionQueueFull", "Batcher", "Clock", "DeadlineUnmeetable",
           "ManualClock", "ReadyGroup", "SystemClock", "Morsel",
           "ShardedExecutor", "ShardPlacement", "plan_morsels",
           "side_bucket_rows", "ExchangePlacement", "choose_bucket_count",
           "hash_buckets", "plan_exchange",
           "RequestContext", "Session", "TenantPolicy", "TenantStats",
           "ExplainResult", "MetricsRegistry", "NULL_TRACE", "Span", "Trace",
           "chrome_trace"]
