"""End-to-end training example: a ~100M-param LM for a few hundred steps
(counterpart of ``examples/train_100m.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_100m --preset 100m --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_100m --preset 10m --steps 200 \
        --device cpu

The full stack: config -> data pipeline -> train step (AdamW, remat, z-loss)
-> async checkpointing -> metrics log, on the card unless ``--device cpu``.
The presets are the JAX example's, at deepseek-family dimensions (``100m``:
d=768, L=12, ~124M params), float32. With ``--ckpt-dir`` holding a
checkpoint (the port's or the JAX package's: one layout) it starts from
it. Exits 1 when the nll did not improve.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch import convert
from repro_torch.checkpoint.checkpointer import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import ARCHS
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device, synchronize
from repro_torch.training.train_step import init_state, make_train_step

PRESETS = {
    "10m": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=4,
                head_dim=64, d_ff=1024, vocab_size=8192),
    "30m": dict(num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
                head_dim=64, d_ff=2048, vocab_size=16384),
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
                 head_dim=64, d_ff=3072, vocab_size=32768),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="10m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log", default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def config(preset: str):
    return ARCHS["deepseek-7b"].with_(param_dtype="float32", compute_dtype="float32",
                                      **PRESETS[preset])


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = config(args.preset)
    tcfg = TrainConfig(learning_rate=args.lr, z_loss=1e-4, grad_clip=1.0)
    data = SyntheticLM(cfg, seed=0, device=device)
    state = init_state(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"preset={args.preset} params={n_params:,} "
          f"tokens/step={args.batch * args.seq}")

    ckpt = None
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        if latest_step(args.ckpt_dir) is not None:
            state = convert.state_from_leaves(restore(args.ckpt_dir), cfg, device)
            print("resumed from step", latest_step(args.ckpt_dir))

    step_fn = make_train_step(cfg, tcfg)
    log = []
    t0 = time.time()
    for step in range(args.steps):
        batch = data.batch(step, args.batch, args.seq)
        state, metrics = step_fn(state, batch)
        if step % 10 == 0 or step == args.steps - 1:
            synchronize(device)
            row = {"step": step, "loss": float(metrics["loss"]),
                   "nll": float(metrics["nll"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "elapsed_s": round(time.time() - t0, 1)}
            log.append(row)
            print(f"step {step:4d} loss={row['loss']:.4f} "
                  f"gnorm={row['grad_norm']:.3f} ({row['elapsed_s']}s)")
        if ckpt and step and step % args.ckpt_every == 0:
            ckpt.save(convert.state_leaves(state), step=step)
    if ckpt:
        ckpt.save(convert.state_leaves(state), step=args.steps)
        ckpt.close()
    if args.log:
        with open(args.log, "w") as f:
            json.dump(log, f, indent=1)
    first, last = log[0]["nll"], log[-1]["nll"]
    print(f"\nnll {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return 0 if last < first else 1


if __name__ == "__main__":
    sys.exit(main())
