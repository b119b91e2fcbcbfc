"""Serving on the port: the LM continuous-batching engine and sampling, and
the prediction-query service with its three-tier cache (plan-signature
executable cache -> cross-query materialized result cache -> cost-aware
eviction/invalidation) plus continuous-batching admission (latency-budget
coalescing over shape-bucketed executables), multi-tenant sessions and
telemetry.  The partition-parallel tier (sharded execution and the
hash-repartition exchange) is not ported yet."""

from .admission import (AdmissionConfig, AdmissionLoop, AdmissionQueueFull,
                        Batcher, Clock, DeadlineUnmeetable, ManualClock,
                        ReadyGroup, SystemClock)
from .cache import CacheEntry, CostAwareCache, value_nbytes
from .context import RequestContext, Session, TenantPolicy
from .engine import InferenceEngine, Request, ServeConfig
from .prediction_service import (CompiledPrediction, ExplainResult,
                                 PredictionService, PredictionTicket,
                                 ServiceStats, SubplanRef, TenantStats)
from .sampling import restrict_vocab, sample_token
from .telemetry import (NULL_TRACE, MetricsRegistry, Span, Trace,
                        chrome_trace)

__all__ = ["InferenceEngine", "Request", "ServeConfig", "sample_token",
           "restrict_vocab",
           "PredictionService", "PredictionTicket", "CompiledPrediction",
           "ServiceStats", "SubplanRef", "CostAwareCache",
           "CacheEntry", "value_nbytes", "AdmissionConfig", "AdmissionLoop",
           "AdmissionQueueFull", "Batcher", "Clock", "DeadlineUnmeetable",
           "ManualClock", "ReadyGroup", "SystemClock",
           "RequestContext", "Session", "TenantPolicy", "TenantStats",
           "ExplainResult", "MetricsRegistry", "NULL_TRACE", "Span", "Trace",
           "chrome_trace"]
