"""Elastic training under the Phoenix policies — the runtime showcase.

An ElasticTrainer (the "ST job") trains while a synthetic WS load trace
drives the §III-C autoscaler; the provision service reclaims devices from
/ returns devices to the trainer live. Demonstrates
checkpoint-resize-resume with no lost work (vs the paper's kill policy).

    PYTHONPATH=src python -m repro_torch.examples.elastic_train
    PYTHONPATH=src python -m repro_torch.examples.elastic_train --device cpu

The port's own copy of ``examples/elastic_train.py``, with the same control
flow and printed lines. It takes every card by default (``DevicePool()``;
it raises without one); ``--device cpu`` runs on ``--devices`` CPU ranks
(8 by default, the JAX example's forced host devices). The weights are
drawn on the CPU from seed 0.
"""
from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.models import model as M
from repro_torch.runtime.elastic import ElasticTrainer
from repro_torch.runtime.orchestrator import PhoenixOrchestrator
from repro_torch.runtime.serving_pool import ServingPool


def devices_of(args, default: int):
    """``None`` (every card) on the card, ``--devices`` (or ``default``)
    CPU ranks with ``--device cpu``."""
    if args.device == "cuda":
        return None
    return ["cpu"] * (args.devices or default)


def add_device_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="every card (cuda), or CPU ranks")
    ap.add_argument("--devices", type=int, default=0,
                    help="CPU ranks with --device cpu (0: the JAX example's count)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--intervals", type=int, default=6)
    add_device_args(ap)
    args = ap.parse_args(argv)

    cfg = reduced_config(get_config(args.arch))
    ckpt_dir = tempfile.mkdtemp(prefix="phoenix_ckpt_")
    trainer = ElasticTrainer(cfg, TrainConfig(learning_rate=1e-3),
                             global_batch=8, seq_len=32,
                             ckpt_dir=ckpt_dir, model_size=1, init_device="cpu")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pool = ServingPool(cfg, params, capacity_tokens_per_replica=200.0)
    orch = PhoenixOrchestrator(trainer, pool, devices=devices_of(args, 8),
                               min_st_devices=2)
    try:
        orch.start()

        # WS offered load (tokens/interval): trough -> spike -> trough
        loads = np.interp(np.arange(args.intervals),
                          [0, 2, 3, args.intervals - 1], [0, 0, 900, 0])
        for i, load in enumerate(loads):
            orch.ws_tick(float(load))
            m = orch.train_steps(2)
            print(f"interval {i}: ws_load={load:6.0f} "
                  f"replicas={len(pool.replicas)} "
                  f"train_devices={m['devices']} step={m['step']} "
                  f"loss={m['loss']:.4f}")
            if pool.replicas:
                out = pool.submit(np.array([[5, 6, 7, 8]], dtype=np.int32), 4)
                print(f"            served 1 request -> tokens {out[0].tolist()}")
    finally:
        trainer.close()
    print(f"resizes: {trainer.resizes}; ST events: "
          f"{[e for e in orch.events if e['kind'] == 'st_shrink']}")
    print("final step:", trainer.step, "(no work lost across resizes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
