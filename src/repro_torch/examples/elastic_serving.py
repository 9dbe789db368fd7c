"""Serving a small model with batched requests through the WS CMS stack:
continuous batcher + least-outstanding balancer + utilization autoscaler.

    PYTHONPATH=src python -m repro_torch.examples.elastic_serving
    PYTHONPATH=src python -m repro_torch.examples.elastic_serving --device cpu

The port's own copy of ``examples/elastic_serving.py``, with the same
control flow and printed lines. Its replicas take the cards (at most 4) by
default and raise without one; ``--device cpu`` gives them ``--devices``
CPU entries (4 by default, the JAX example's forced host devices), one
replica each. The weights are drawn on the CPU from seed 0.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.examples.elastic_train import add_device_args, devices_of
from repro_torch.models import model as M
from repro_torch.runtime.device_pool import DevicePool
from repro_torch.runtime.serving_pool import ServingPool
from repro_torch.serving.batching import ContinuousBatcher, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--requests", type=int, default=24)
    add_device_args(ap)
    args = ap.parse_args(argv)

    devices = DevicePool(devices_of(args, 4)).devices
    cfg = reduced_config(get_config(args.arch))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pool = ServingPool(cfg, params, capacity_tokens_per_replica=400.0)
    pool.scale_to(devices[:1])
    batcher = ContinuousBatcher(max_batch=8, bucket=64)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=(8,), dtype=np.int32)
        batcher.submit(Request(req_id=i, prompt=prompt, max_new=8,
                               arrival=i * 0.01))

    t0 = time.time()
    rounds = 0
    while batcher.queue:
        reqs = batcher.next_round()
        # autoscale against the queue's offered load
        offered = sum(len(r.prompt) + r.max_new for r in list(batcher.queue)
                      + reqs)
        want = pool.desired_replicas(float(offered))
        pool.scale_to(devices[:min(want, 4)])
        batcher.run_round(reqs, pool.submit, now=time.time() - t0)
        rounds += 1
        print(f"round {rounds}: batch={len(reqs)} replicas="
              f"{len(pool.replicas)} queued={len(batcher.queue)}")
    done = batcher.completed
    print(f"\nserved {len(done)} requests in {rounds} rounds, "
          f"{time.time()-t0:.2f}s wall")
    print("throughput:",
          f"{sum(r.max_new for r in done)/(time.time()-t0):.1f} tok/s")
    assert all(r.done is not None and len(r.done) == r.max_new for r in done)
    return 0


if __name__ == "__main__":
    sys.exit(main())
