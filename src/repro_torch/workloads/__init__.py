"""Request-level WS workload subsystem.

Layers: arrival processes (``arrivals``) -> replica queue + SLO metrics
(``queueing``) -> SLO-aware autoscaling / demand provider (``autoscaler``)
-> scenario campaign runner (``campaign``).
"""
from repro_torch.workloads.arrivals import (GENERATORS, RequestTrace,
                                      burstiness_index, diurnal_arrivals,
                                      flash_crowd_arrivals, make_trace,
                                      mmpp_arrivals, poisson_arrivals)
from repro_torch.workloads.autoscaler import RequestWorkload, SLOAutoscaler
from repro_torch.workloads.queueing import (QueueJob, QueueMetrics,
                                      capacity_steps, plan_queue_buckets,
                                      predicted_percentile_latency,
                                      sakasegawa_wait, simulate_queue,
                                      simulate_queue_batch,
                                      simulate_queue_many,
                                      simulate_queue_reference)

__all__ = [
    "GENERATORS", "RequestTrace", "burstiness_index", "diurnal_arrivals",
    "flash_crowd_arrivals", "make_trace", "mmpp_arrivals",
    "poisson_arrivals", "RequestWorkload", "SLOAutoscaler", "QueueJob",
    "QueueMetrics", "capacity_steps", "plan_queue_buckets",
    "predicted_percentile_latency", "sakasegawa_wait", "simulate_queue",
    "simulate_queue_batch", "simulate_queue_many",
    "simulate_queue_reference",
]
