"""repro_torch.serving -- the deadline-aware dynamic-batching serving
runtime on one device (the port of ``repro.serving``):

  request.py     -- Request, arrival processes, bounded admission queue
  batcher.py     -- shape buckets, deadline-aware coalescing, exact padding
  metrics.py     -- latency histograms, p50/p90/p99/p99.9, QPS, SLO and
                    availability accounting
  runtime.py     -- the discrete-event loop, executors, load sources
  loadgen.py     -- model bindings, padders, request streams (open/closed)
  faults.py      -- deterministic fault injection around any executor
  degradation.py -- retry / circuit breaker / brown-out ladder controller
  updates.py     -- streaming embedding updates between micro-batches
  scrub.py       -- per-page checksum audits on the maintenance seam and
                    page repair from the snapshot and the WAL tail

The engine-facing seam is ``repro_torch.core.pifs.ServeBinding``.
"""
from repro_torch.core.updates import UpdateConfig
from repro_torch.serving.batcher import (BatcherConfig, Bucket,
                                         DynamicBatcher, FixedBatcher,
                                         FixedServiceModel, Flush,
                                         ServiceModel, Wait,
                                         pad_pooled_indices, stack_feature)
from repro_torch.serving.degradation import (RUNGS, BreakerConfig,
                                             CircuitBreaker,
                                             DegradationController,
                                             LadderConfig, RetryPolicy)
from repro_torch.serving.faults import (FaultConfig, FaultInjectingExecutor,
                                        ShardLossFailure,
                                        TransientServingFailure,
                                        corrupt_store, flip_store_bits)
from repro_torch.serving.loadgen import (LoadConfig, bind_model,
                                         closed_loop_factory,
                                         dummy_request_factory, make_padder,
                                         prime_dedup_auto, request_stream,
                                         update_stream)
from repro_torch.serving.metrics import LatencyHistogram, ServingMetrics
from repro_torch.serving.request import (AdmissionQueue, ArrivalConfig,
                                         Request, arrival_times)
from repro_torch.serving.runtime import (BindingExecutor, ClosedLoopSource,
                                         OpenLoopSource, RuntimeConfig,
                                         ServingRuntime, SimulatedExecutor)
from repro_torch.serving.scrub import ScrubConfig, ScrubController
from repro_torch.serving.updates import StreamingUpdater, UpdateBatch

__all__ = [
    "AdmissionQueue", "ArrivalConfig", "BatcherConfig", "BindingExecutor",
    "BreakerConfig", "Bucket", "CircuitBreaker", "ClosedLoopSource",
    "DegradationController", "DynamicBatcher", "FaultConfig",
    "FaultInjectingExecutor", "FixedBatcher", "FixedServiceModel", "Flush",
    "LadderConfig", "LatencyHistogram", "LoadConfig", "OpenLoopSource",
    "RUNGS", "Request", "RetryPolicy", "RuntimeConfig", "ScrubConfig",
    "ScrubController", "ServiceModel",
    "ServingMetrics", "ServingRuntime", "ShardLossFailure",
    "SimulatedExecutor",
    "StreamingUpdater", "TransientServingFailure", "UpdateBatch",
    "UpdateConfig", "Wait", "arrival_times", "bind_model",
    "closed_loop_factory", "corrupt_store", "dummy_request_factory",
    "flip_store_bits", "make_padder", "pad_pooled_indices",
    "prime_dedup_auto", "request_stream", "stack_feature", "update_stream",
]
