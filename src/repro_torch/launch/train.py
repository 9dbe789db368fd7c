"""Training launcher (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --reduced --steps 20 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu

Wraps the elastic trainer: re-running the same command resumes from the
latest checkpoint. The JAX launcher's flags and defaults, plus ``--device``
(``cuda`` by default: the card, or an error without one; ``cpu`` only when
asked for). ``--devices N`` trains data-parallel with ZeRO-1 over N
devices: N ``gloo`` ranks with ``--device cpu``, N cards with ``cuda``
(raises, naming the count, where fewer are present); 0, the default, means
every visible card, or one CPU rank. One device trains in this process with
no process group. It prints ``devices=`` the mesh's size, which
``ElasticTrainer`` rounds down to a divisor of ``--batch``. ``--model-size
N`` cuts the model over groups of N of those devices (tensor parallelism:
a (devices / N) x N mesh); fewer devices than N raises ``ValueError``,
naming both counts, before any weight is drawn (on one card,
``--model-size 2`` exits non-zero).

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --devices 4 --steps 4 --ckpt-dir "$(mktemp -d)"
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --devices 4 --model-size 2 --steps 4 --ckpt-dir "$(mktemp -d)"

A reduced model's weights are drawn on the CPU and copied to the card, so
``--device cpu`` starts from the same weights. The default arch,
deepseek-7b at its published widths, does not fit one 80 GB card with its
AdamW state and stops with CUDA's out-of-memory error; recurrentgemma-2b
does fit. Every arch of ``repro_torch.configs.ARCHS`` trains reduced; for
the MoE archs (qwen3-moe-30b-a3b, dbrx-132b) the loss adds the routers'
auxiliary losses:

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --arch qwen3-moe-30b-a3b --steps 4 --ckpt-dir "$(mktemp -d)"

musicgen-large trains on ``SyntheticLM``'s per-frame embeddings [B, S, D]
and labels [B, S, 4], one per codebook head:

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --arch musicgen-large --steps 4 --ckpt-dir "$(mktemp -d)"
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-size", type=int, default=1,
                    help="TP width (devices per model replica)")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--devices", type=int, default=0,
                    help="devices to train on: N cards, or N CPU ranks with --device "
                         "cpu; 0 = every card (one CPU rank)")
    ap.add_argument("--log", default="")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import visible_cards
    from repro_torch.runtime.elastic import ElasticTrainer

    if args.device == "cpu":
        devices = ["cpu"] * max(1, args.devices)
    else:
        devices = visible_cards()
        if args.devices > len(devices):
            raise RuntimeError(f"--devices {args.devices}: this host has {len(devices)} "
                               "CUDA device(s)")
        devices = devices[:args.devices or len(devices)]
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    tcfg = TrainConfig(learning_rate=args.lr, microbatch=args.microbatch)
    data = SyntheticLM(cfg, seed=0)
    trainer = ElasticTrainer(cfg, tcfg, global_batch=args.batch,
                             seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                             model_size=args.model_size,
                             data_fn=data.data_fn,
                             init_device="cpu" if args.reduced else None)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    try:
        trainer.start(devices)
        print(f"arch={cfg.name} devices={trainer.mesh.size} start_step={trainer.step}")
        t0 = time.time()
        while trainer.step < args.steps:
            n = min(args.ckpt_every, args.steps - trainer.step)
            m = trainer.train_steps(n)
            trainer.checkpoint()
            print(f"step {m['step']}: loss={m['loss']:.4f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
    finally:
        trainer.close()
    if args.log:
        with open(args.log, "w") as f:
            json.dump(trainer.metrics_log, f, indent=1)
    print("done; checkpoint at", args.ckpt_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
