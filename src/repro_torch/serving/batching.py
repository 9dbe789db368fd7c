"""Continuous-batching request queue for the serving engine.

Requests arrive asynchronously; the scheduler packs compatible requests
(same max_new budget bucket) into batch slots, prefills them together and
interleaves decode steps, retiring sequences as they hit their budget. This
is the WS CMS's unit of work — the pool's replicas each run one of these.

The port's own copy of ``repro.serving.batching`` (framework-free), with the
same logic, so both packages batch and left-pad requests the same way.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray          # [S] int32
    max_new: int
    arrival: float = 0.0
    done: Optional[np.ndarray] = None
    finish_time: float = 0.0


@dataclasses.dataclass(frozen=True)
class ServiceTimeModel:
    """Continuous-batching service-time model for one serving replica.

    A replica prefills at ``prefill_tokens_per_s`` (batch-amortized) and
    decodes each in-flight sequence at ``decode_tokens_per_s``; running b
    sequences concurrently slows every sequence down by a factor
    ``1 + batch_interference * (b - 1)`` (shared KV bandwidth / step sync).
    ``max_batch`` concurrent slots per replica — the same knob as
    ``ContinuousBatcher.max_batch``.

    This is the bridge between the real batcher below and the request-level
    queue simulator in ``repro.workloads.queueing``: both derive service
    times from the same model, so simulated latencies stay comparable to
    what a replica would actually deliver.
    """
    prefill_tokens_per_s: float = 8000.0
    decode_tokens_per_s: float = 160.0
    batch_interference: float = 0.08
    max_batch: int = 4

    def service_times(self, prompt_tokens, decode_tokens,
                      concurrency: Optional[int] = None) -> np.ndarray:
        """Vectorized per-request service seconds at a given concurrency.

        concurrency defaults to max_batch (the steady-state of a loaded
        replica — the conservative planning assumption).
        """
        b = self.max_batch if concurrency is None else max(1, concurrency)
        slow = 1.0 + self.batch_interference * (b - 1)
        prompt_tokens = np.asarray(prompt_tokens, dtype=np.float64)
        decode_tokens = np.asarray(decode_tokens, dtype=np.float64)
        return (prompt_tokens / self.prefill_tokens_per_s
                + decode_tokens * slow / self.decode_tokens_per_s)

    @property
    def slots_per_replica(self) -> int:
        return self.max_batch

    def replica_throughput_rps(self, mean_prompt: float,
                               mean_decode: float) -> float:
        """Requests/s one fully-loaded replica sustains (capacity for the
        80%-utilization rule and the SLO autoscaler's feasibility floor)."""
        s = float(self.service_times([mean_prompt], [mean_decode])[0])
        return self.max_batch / max(s, 1e-9)


class ContinuousBatcher:
    """Greedy slot-packing batcher (static shapes per generation round)."""

    def __init__(self, *, max_batch: int = 8, bucket: int = 64):
        self.max_batch = max_batch
        self.bucket = bucket
        self.queue: Deque[Request] = deque()
        self.completed: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def next_round(self) -> Optional[List[Request]]:
        """Pick up to max_batch requests with compatible shapes."""
        if not self.queue:
            return None
        head = self.queue[0]
        key = (len(head.prompt) // self.bucket, head.max_new // self.bucket)
        round_reqs = []
        rest: Deque[Request] = deque()
        while self.queue and len(round_reqs) < self.max_batch:
            r = self.queue.popleft()
            if (len(r.prompt) // self.bucket,
                    r.max_new // self.bucket) == key:
                round_reqs.append(r)
            else:
                rest.append(r)
        self.queue.extendleft(reversed(rest))
        return round_reqs

    def estimate_round_time(self, reqs: List[Request],
                            model: ServiceTimeModel) -> float:
        """Predicted wall seconds for one generation round of `reqs`.

        Prefill is batch-amortized over the padded prompt block; decode runs
        to the round's max_new with all sequences in flight.
        """
        if not reqs:
            return 0.0
        S = max(len(r.prompt) for r in reqs)
        max_new = max(r.max_new for r in reqs)
        b = len(reqs)
        slow = 1.0 + model.batch_interference * (b - 1)
        return (b * S / model.prefill_tokens_per_s
                + max_new * slow / model.decode_tokens_per_s)

    def run_round(self, reqs: List[Request], generate_fn, now: float = 0.0):
        """generate_fn(prompts [B, S], max_new) -> [B, max_new]."""
        S = max(len(r.prompt) for r in reqs)
        prompts = np.stack([np.pad(r.prompt, (S - len(r.prompt), 0))
                            for r in reqs])
        max_new = max(r.max_new for r in reqs)
        out = generate_fn(prompts.astype(np.int32), max_new)
        for i, r in enumerate(reqs):
            r.done = out[i, :r.max_new]
            r.finish_time = now
            self.completed.append(r)
