"""Training launcher (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
        --reduced --steps 20 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu

Wraps the elastic trainer: re-running the same command resumes from the
latest checkpoint. The JAX launcher's flags and defaults, plus ``--device``
(``cuda`` by default: the card, or an error without one; ``cpu`` only when
asked for). ``--devices`` may be 0 or 1 (one card); more raises: multi-card
training waits for ROADMAP.md, queue 1 item 4. A reduced model's weights
are drawn on the CPU and copied to the card, so ``--device cpu`` starts
from the same weights. The default arch, deepseek-7b at its published
widths, does not fit one 80 GB card with its AdamW state and stops with
CUDA's out-of-memory error; recurrentgemma-2b does fit. Every arch of
``repro_torch.configs.ARCHS`` trains reduced; for the MoE archs
(qwen3-moe-30b-a3b, dbrx-132b) the loss adds the routers' auxiliary losses:

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --arch qwen3-moe-30b-a3b --steps 4 --ckpt-dir "$(mktemp -d)"

musicgen-large trains on ``SyntheticLM``'s per-frame embeddings [B, S, D]
and labels [B, S, 4], one per codebook head; reduced only here (at its
published widths its ~52 GB of AdamW state is a later item of ROADMAP.md):

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
                    help="cards to train on: 0 or 1 (one card)")
    ap.add_argument("--log", default="")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.runtime.elastic import ElasticTrainer

    if args.devices not in (0, 1):
        raise NotImplementedError(
            f"--devices {args.devices}: the port trains on one card "
            "(multi-card training: ROADMAP.md, queue 1 item 4)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    tcfg = TrainConfig(learning_rate=args.lr, microbatch=args.microbatch)
    data = SyntheticLM(cfg, seed=0, device=device)
    trainer = ElasticTrainer(cfg, tcfg, global_batch=args.batch,
                             seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                             model_size=args.model_size,
                             data_fn=data.data_fn,
                             init_device="cpu" if args.reduced else device)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    trainer.start([device])
    print(f"arch={cfg.name} devices=1 start_step={trainer.step}")
    t0 = time.time()
    while trainer.step < args.steps:
        n = min(args.ckpt_every, args.steps - trainer.step)
        m = trainer.train_steps(n)
        trainer.checkpoint()
        print(f"step {m['step']}: loss={m['loss']:.4f} "
              f"({(time.time() - t0):.1f}s)", flush=True)
    if args.log:
        with open(args.log, "w") as f:
            json.dump(trainer.metrics_log, f, indent=1)
    print("done; checkpoint at", args.ckpt_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
