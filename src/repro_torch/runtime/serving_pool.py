"""Serving replica pool: the runtime analogue of the paper's WS CMS
(counterpart of ``repro.runtime.serving_pool``).

Each replica holds the model's parameters on one device and serves batched
greedy decoding. The balancer routes requests to the replica with the fewest
outstanding tokens (the paper's LVS least-connection policy); the §III-C
80% utilization rule decides replica count against the pool's capacity.

Replicas follow the granted device objects, as the JAX pool follows its
devices by identity: a ``DevicePool`` over ``["cpu"] * N`` holds N distinct
``torch.device("cpu")`` entries, and two of them granted give two replicas
(on the same CPU), as two cards would.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.model import CausalLM
from repro_torch.serving.engine import make_decode_fn, make_prefill_fn


class Replica:
    def __init__(self, cfg: ModelConfig, model: CausalLM, device,
                 timings: Optional[List[dict]] = None):
        self.cfg = cfg
        self.slot = device          # the granted device object
        self.device = resolve_device(device)
        # parameters move to the replica's device once (no copy if already there)
        self.model = model if model.device == self.device else model.copy_to(self.device)
        self.outstanding = 0
        self._decode = make_decode_fn(cfg)
        # wall seconds of each generate call's prefill and decode phases
        self.timings = [] if timings is None else timings

    def generate(self, prompt: np.ndarray, max_new: int) -> np.ndarray:
        """prompt: [B, S] int32. Greedy decode max_new tokens -> [B, max_new]."""
        self.outstanding += prompt.size + max_new
        try:
            with torch.inference_mode():
                B, S = prompt.shape
                t0 = time.perf_counter()
                tokens = torch.from_numpy(prompt).to(self.device, torch.long)
                nxt, caches = make_prefill_fn(self.cfg, max_len=S + max_new)(
                    self.model, tokens)
                synchronize(self.device)
                t1 = time.perf_counter()
                toks = [nxt]
                for i in range(max_new - 1):
                    nxt, caches = self._decode(self.model, caches,
                                               toks[-1][:, None], S + i)
                    toks.append(nxt)
                out = torch.stack(toks, dim=1).cpu().numpy()
                t2 = time.perf_counter()
            self.timings.append({"batch": B, "prompt_len": S, "max_new": max_new,
                                 "prefill_s": t1 - t0, "decode_s": t2 - t1})
            return out
        finally:
            self.outstanding -= prompt.size + max_new


class ServingPool:
    """Least-outstanding routing + utilization-rule autoscaling."""

    def __init__(self, cfg: ModelConfig, model: CausalLM, *,
                 capacity_tokens_per_replica: float = 4096.0):
        self.cfg = cfg
        self.model = model
        self.capacity = capacity_tokens_per_replica
        self.replicas: List[Replica] = []
        self.timings: List[dict] = []   # every replica's generate timings

    # -------------------------------------------------------------- scaling
    def scale_to(self, devices: Sequence):
        """Reconcile replicas with the granted device set (by identity)."""
        want = {id(d): d for d in devices}
        self.replicas = [r for r in self.replicas if id(r.slot) in want]
        have = {id(r.slot) for r in self.replicas}
        for d in devices:
            if id(d) not in have:
                self.replicas.append(Replica(self.cfg, self.model, d,
                                             timings=self.timings))

    def desired_replicas(self, offered_load_tokens: float) -> int:
        """Paper §III-C rule against token throughput capacity."""
        n = max(1, len(self.replicas))
        util = offered_load_tokens / (n * self.capacity)
        if util > 0.80:
            return n + 1
        if n > 1 and util < 0.80 * (n - 1) / n:
            return n - 1
        return n

    # -------------------------------------------------------------- serving
    def submit(self, prompt: np.ndarray, max_new: int) -> np.ndarray:
        if not self.replicas:
            raise RuntimeError("no replicas provisioned")
        replica = min(self.replicas, key=lambda r: r.outstanding)
        return replica.generate(prompt, max_new)
