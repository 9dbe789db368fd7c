"""Quickstart: train a small LM with the port's stack (counterpart of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart --arch deepseek-7b --steps 5
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Uses the reduced per-family config, on the card unless ``--device cpu``
(the full configs are counted by the dry run on the meta device:
``python -m repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device, synchronize
from repro_torch.training.train_step import init_state, make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None, state=None) -> int:
    """``state``: a training state to start from in place of seed 0's
    weights (the tests pass the JAX example's, converted)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced_config(ARCHS[args.arch])
    tcfg = TrainConfig(learning_rate=1e-3, z_loss=0.0)
    if state is None:
        state = init_state(cfg, seed=0, device=device)
    step_fn = make_train_step(cfg, tcfg, moe_groups=2)
    data = SyntheticLM(cfg, seed=0, device=device)
    print(f"arch={cfg.name} (reduced) params="
          f"{sum(p.numel() for p in state.params.parameters()):,}")
    for step in range(args.steps):
        t0 = time.time()
        batch = data.batch(step, args.batch, args.seq)
        state, metrics = step_fn(state, batch)
        synchronize(device)
        print(f"step {step}: loss={float(metrics['loss']):.4f} "
              f"nll={float(metrics['nll']):.4f} "
              f"gnorm={float(metrics['grad_norm']):.3f} "
              f"({time.time()-t0:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
