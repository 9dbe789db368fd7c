"""Serving launcher: WS-CMS pool + continuous batcher driven by a synthetic
request trace, with the paper's autoscaler (counterpart of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --no-reduced --requests 8 --prompt-len 512 --max-new 32 --max-batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
        --no-reduced --requests 8 --prompt-len 512 --max-new 32 --max-batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        --no-reduced --requests 8 --prompt-len 512 --max-new 32 --max-batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
        --no-reduced --requests 8 --prompt-len 512 --max-new 32 --max-batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \\
        --no-reduced --requests 8 --prompt-len 512 --max-new 32 --max-batch 4

``--arch`` is any of ``repro_torch.configs.ARCHS`` that takes token ids:
deepseek-7b, qwen2-7b, mistral-large-123b, gemma3-12b, chameleon-34b,
qwen3-moe-30b-a3b, dbrx-132b, xlstm-1.3b, recurrentgemma-2b.
musicgen-large takes per-frame embeddings, which ``Replica.generate``'s
token prompts cannot feed (nor can the JAX launcher's): ``--arch
musicgen-large`` raises ``ValueError`` before any weight is drawn. Serve
it through the engine, ``repro_torch.serving.engine.make_prefill_fn`` on
``[B, S, D]`` embeddings, then ``make_decode_fn`` on ``decode_inputs``.

At published widths in bf16 one 80 GB card holds qwen2-7b, deepseek-7b,
xlstm-1.3b, recurrentgemma-2b, gemma3-12b (23.5 GB) and qwen3-moe-30b-a3b
(61.1 GB); the others serve reduced only. Runs on the card unless ``--device cpu``; ``--devices N``
caps the number of cards the pool may use (0 = all). Weights are random, drawn from ``--seed``:
a reduced model's on the CPU and copied to the card, so that the default run
serves the same tokens on the card as with ``--device cpu``; a model at its
published widths on the card, where its billions of parameters are drawn in
parallel and never pass through host memory (drawn on the CPU they would
take the host's cores and a copy of the whole model there; that cost is not
measured). CUDA and CPU generators draw different numbers from one seed, so
a full-width model differs between ``--device cuda`` and ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="tiny same-family config (default) "
                    "or, with --no-reduced, the published widths")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--capacity", type=float, default=400.0,
                    help="tokens/interval one replica absorbs at 100%% util")
    ap.add_argument("--devices", type=int, default=0,
                    help="cap on the number of cards used (0 = all)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run(argv=None) -> dict:
    """Serve the synthetic trace; return what was served and how long it took."""
    args = build_parser().parse_args(argv)

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model as M
    from repro_torch.runtime.device_pool import DevicePool
    from repro_torch.runtime.serving_pool import ServingPool
    from repro_torch.serving.batching import ContinuousBatcher, Request

    cfg = get_config(args.arch)
    cfg = reduced_config(cfg) if args.reduced else cfg
    if cfg.input_mode != "tokens":
        raise ValueError(
            f"{cfg.name} takes {cfg.input_mode} inputs, which the replicas' token "
            "prompts cannot feed: serve it through repro_torch.serving.engine "
            "(make_prefill_fn on [B, S, D] embeddings, make_decode_fn on decode_inputs)")
    if args.device == "cpu":
        devices = [torch.device("cpu")]
    else:
        devices = DevicePool().devices[:args.devices or None]
    init_on = torch.device("cpu") if args.reduced else devices[0]
    model = M.init_params(cfg, torch.Generator(device=init_on).manual_seed(args.seed),
                          init_on)
    pool = ServingPool(cfg, model, capacity_tokens_per_replica=args.capacity)
    pool.scale_to(devices[:1])
    batcher = ContinuousBatcher(max_batch=args.max_batch)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        batcher.submit(Request(
            i, rng.integers(0, cfg.vocab_size, args.prompt_len,
                            dtype=np.int32), args.max_new))
    t0 = time.time()
    rounds = 0
    while batcher.queue:
        reqs = batcher.next_round()
        offered = float(sum(len(r.prompt) + r.max_new
                            for r in list(batcher.queue) + reqs))
        pool.scale_to(devices[:max(
            1, min(pool.desired_replicas(offered), len(devices)))])
        batcher.run_round(reqs, pool.submit, now=time.time() - t0)
        rounds += 1
        print(f"round {rounds}: batch={len(reqs)} "
              f"replicas={len(pool.replicas)} queued={len(batcher.queue)}",
              flush=True)
    dt = time.time() - t0
    total_new = sum(r.max_new for r in batcher.completed)
    print(f"served {len(batcher.completed)} requests / {total_new} tokens "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s)")
    return {"cfg": cfg, "rounds": rounds, "completed": batcher.completed,
            "tokens": total_new, "seconds": dt, "timings": pool.timings,
            "devices": [str(d) for d in devices], "pool": pool}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
