#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. card and build: ``nvidia-smi`` name and power limit; every CUDA kernel is
   built from ``src/repro_torch/kernels/*/csrc`` with ``nvcc``;
2. kernels: each kernel is held against its plain PyTorch version on the
   card (bf16 tolerance 3e-2, float32 2e-5) at the serving path's shapes and
   at the JAX package's test shapes, and timed beside its plain version,
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls)
   and its bound (bytes over HBM rate, operations over bf16 tensor rate);
3. small model: a 2-layer qwen2-shaped model (head_dim 128) in float32
   serves the same prompts on the card and on the CPU; logits and greedy
   tokens must agree;
4. serving at full width: ``repro_torch.launch.serve`` serves 8 requests of
   qwen2-7b (published widths, random bf16 weights from a seed) on cuda:0;
   every launch counter is zeroed first and read after, and the plain
   attention versions are made to raise meanwhile, so the run proves that
   every attention call went through the kernels;
5. profile: ``torch.profiler`` over one prefill and eight decode steps of
   the served model: kernel time by name and the device's idle share.

Earlier lines are JSON records; the last three are the card line from
``nvidia-smi``, ``{"kernels": [...]}`` and ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without a CUDA device or outside the
repository checkout.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# name fragment -> (dense bf16 tensor-core FLOP/s, HBM bytes/s), data sheets;
# the first fragment found in the card's name applies.
PEAKS = (("H100 PCIe", (756e12, 2.0e12)),
         ("H100 NVL", (835e12, 3.9e12)),
         ("H100", (989e12, 3.35e12)),
         ("H200", (989e12, 4.8e12)))

SERVE_ARGV = ["--device", "cuda", "--arch", "qwen2-7b", "--no-reduced",
              "--requests", "8", "--prompt-len", "512", "--max-new", "32",
              "--max-batch", "4", "--devices", "1"]


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def peaks(name: str):
    for fragment, rates in PEAKS:
        if fragment in name:
            return rates
    raise RuntimeError(f"no peak rates known for {name!r}")


def time_ms(torch, fn, inputs, iters: int = 20) -> float:
    """Mean device ms per call, by CUDA events; ``inputs`` rotate per call."""
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, out, ref) -> float:
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    return (out.float() - ref.float()).abs().max().item()


def check_flash(torch, gen, dev):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference
    cases = [  # (B, S, H, K, window, causal, dtype, tol)
        (4, 512, 28, 4, 0, True, torch.bfloat16, 3e-2),     # serving prefill
        (2, 500, 28, 4, 0, True, torch.bfloat16, 3e-2),     # ragged S
        (2, 256, 8, 2, 128, True, torch.bfloat16, 3e-2),
        (2, 256, 4, 2, 0, True, torch.float32, 2e-5),       # tests/test_kernels.py
        (1, 512, 4, 4, 0, True, torch.float32, 2e-5),
        (2, 256, 8, 2, 128, True, torch.float32, 2e-5),
        (1, 256, 2, 1, 64, True, torch.float32, 2e-5),      # MQA + window
        (1, 500, 4, 2, 96, True, torch.float32, 2e-5),      # ragged + window
        (1, 130, 4, 2, 0, False, torch.float32, 2e-5),      # not causal
    ]
    errs = []
    for B, S, H, K, win, causal, dtype, tol in cases:
        q = torch.randn(B, S, H, 128, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, K, 128, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, K, 128, generator=gen, device=dev).to(dtype)
        out = flash_attention(q, k, v, causal=causal, window=win)
        ref = flash_attention_reference(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        err = max_err(torch, out, ref)
        emit({"phase": "check", "kernel": "flash_attention", "shape": [B, S, H, K, 128],
              "window": win, "causal": causal, "dtype": str(dtype), "max_abs_err": err,
              "tol": tol})
        if not err < tol:
            raise AssertionError(f"flash_attention disagrees: {err} >= {tol}")
        errs.append(err)
    return errs[0]


def check_decode(torch, gen, dev):
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_reference
    cases = [  # (B, H, K, L, window, fill, dtype, tol)
        (4, 28, 4, 544, 0, 544, torch.bfloat16, 3e-2),      # serving, last step
        (4, 28, 4, 544, 0, 513, torch.bfloat16, 3e-2),      # serving, first step
        (2, 8, 2, 1024, 0, 1024, torch.float32, 2e-5),      # tests/test_kernels.py
        (2, 8, 4, 1024, 0, 700, torch.float32, 2e-5),       # partial fill
        (1, 4, 1, 512, 256, 512, torch.float32, 2e-5),      # MQA ring window
        (1, 2, 2, 512, 0, 512, torch.float32, 2e-5),
        (2, 28, 4, 256, 256, None, torch.float32, 2e-5),    # wrapped ring
        (1, 32, 32, 300, 0, 300, torch.float32, 2e-5),      # MHA, ragged L
    ]
    errs = []
    for B, H, K, L, win, fill, dtype, tol in cases:
        q = torch.randn(B, H, 128, generator=gen, device=dev).to(dtype)
        ck = torch.randn(B, L, K, 128, generator=gen, device=dev).to(dtype)
        cv = torch.randn(B, L, K, 128, generator=gen, device=dev).to(dtype)
        if fill is None:                    # 700 tokens through a 256-slot ring
            cur = 699
            sp = torch.arange(L, device=dev) + (cur + 1 - L)
            sp = sp.roll(int((cur + 1) % L)).to(torch.int32)
        else:
            cur = fill - 1
            ar = torch.arange(L, device=dev, dtype=torch.int32)
            sp = torch.where(ar < fill, ar, torch.full_like(ar, -1))
        out = decode_attention(q, ck, cv, sp, cur, window=win)
        ref = decode_attention_reference(q, ck, cv, sp, cur, window=win)
        torch.cuda.synchronize()
        err = max_err(torch, out, ref)
        emit({"phase": "check", "kernel": "decode_attention", "shape": [B, H, K, L, 128],
              "window": win, "fill": fill, "dtype": str(dtype), "max_abs_err": err,
              "tol": tol})
        if not err < tol:
            raise AssertionError(f"decode_attention disagrees: {err} >= {tol}")
        errs.append(err)
    return errs[0]


def measure_flash(torch, gen, dev, flops_peak, bw_peak):
    """Serving prefill shape, bf16. Inputs are fresh projections in the model,
    so they are timed warm in L2 (15 MB of q/k/v)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference
    B, S, H, K, hd = 4, 512, 28, 4, 128
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, S, K, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, S, K, hd, generator=gen, device=dev).bfloat16()
    inputs = [(q, k, v)]
    kernel = time_ms(torch, lambda a, b, c: flash_attention(a, b, c), inputs)
    plain = time_ms(torch, lambda a, b, c: flash_attention_reference(a, b, c), inputs)
    library = time_ms(torch, lambda a, b, c: F.scaled_dot_product_attention(
        a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
        is_causal=True, enable_gqa=True), inputs)
    pairs = S * (S + 1) // 2                       # causal (q, k) pairs
    flops = 4 * B * H * hd * pairs
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * K * hd)
    return kernel, plain, library, flops, nbytes, flops_peak, bw_peak


def measure_decode(torch, gen, dev, flops_peak, bw_peak):
    """Serving decode shape at its last step (544 valid slots), bf16. Sixteen
    caches (72 MB) rotate so that reads come from HBM, as in the model,
    where 28 layers' caches do not fit in L2."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_reference
    B, H, K, L, hd = 4, 28, 4, 544, 128
    sp = torch.arange(L, device=dev, dtype=torch.int32)
    cur = L - 1
    inputs = []
    for _ in range(16):
        inputs.append((torch.randn(B, H, hd, generator=gen, device=dev).bfloat16(),
                       torch.randn(B, L, K, hd, generator=gen, device=dev).bfloat16(),
                       torch.randn(B, L, K, hd, generator=gen, device=dev).bfloat16()))
    kernel = time_ms(torch, lambda q, ck, cv: decode_attention(q, ck, cv, sp, cur), inputs)
    plain = time_ms(torch, lambda q, ck, cv: decode_attention_reference(q, ck, cv, sp, cur),
                    inputs)
    mask = (sp >= 0).view(1, 1, 1, L)
    library = time_ms(torch, lambda q, ck, cv: F.scaled_dot_product_attention(
        q[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2), attn_mask=mask,
        enable_gqa=True), inputs)
    flops = 4 * B * H * hd * L
    nbytes = 2 * (2 * B * H * hd + 2 * B * L * K * hd) + 4 * L
    return kernel, plain, library, flops, nbytes, flops_peak, bw_peak


def kernel_row(name, source, replaces, err, measured, launches):
    kernel, plain, library, flops, nbytes, flops_peak, bw_peak = measured
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / bw_peak * 1e3
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": kernel, "plain_ms": plain,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library}


def check_small_model(torch, dev):
    """2-layer qwen2-shaped model (head_dim 128, GQA 7), float32: card vs CPU."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.runtime.serving_pool import ServingPool
    cfg = get_config("qwen2-7b").with_(num_layers=2, d_model=256, d_ff=512,
                                       vocab_size=1024, param_dtype="float32",
                                       compute_dtype="float32")
    cpu_model = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    with torch.no_grad():      # non-zero biases and norm scales
        g = torch.Generator().manual_seed(2)
        for name, p in cpu_model.named_parameters():
            if name.endswith(("bias", "scale")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40),
                                               dtype=np.int32)
    gpu_model = cpu_model.copy_to(dev)
    with torch.inference_mode():
        tokens = torch.from_numpy(prompt).long()
        want, _ = M.prefill(cpu_model, tokens, max_len=48)
        got, _ = M.prefill(gpu_model, tokens.to(dev), max_len=48)
    err = max_err(torch, got.cpu(), want)
    toks = {}
    for d, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        pool = ServingPool(cfg, model)
        pool.scale_to([dev if d == "cuda" else "cpu"])
        toks[d] = pool.submit(prompt, 8)
    same = bool((toks["cpu"] == toks["cuda"]).all())
    emit({"phase": "small_model", "prefill_logits_max_abs_err": err, "tol": 1e-3,
          "greedy_tokens_identical": same, "shape": list(toks["cuda"].shape)})
    if not (err < 1e-3 and same and toks["cuda"].shape == (2, 8)):
        raise AssertionError("port on the card disagrees with the CPU path")


def serve_full_width(torch):
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import serve

    def plain_forbidden(*args, **kwargs):
        raise AssertionError("the plain attention version ran on the main path")

    saved = fops.flash_attention_reference, dops.decode_attention_reference
    fops.flash_attention_reference = dops.decode_attention_reference = plain_forbidden
    torch.cuda.reset_peak_memory_stats()
    fops.flash_attention.launches = 0
    dops.decode_attention.launches = 0
    try:
        t0 = time.perf_counter()
        report = serve.run(SERVE_ARGV)
        wall = time.perf_counter() - t0
    finally:
        fops.flash_attention_reference, dops.decode_attention_reference = saved
    launches = {"flash_attention": fops.flash_attention.launches,
                "decode_attention": dops.decode_attention.launches}
    cfg, rounds = report["cfg"], report["rounds"]
    done = report["completed"]
    ok_tokens = len(done) == 8 and all(
        r.done is not None and len(r.done) == 32 and (r.done >= 0).all()
        and (r.done < cfg.vocab_size).all() for r in done)
    want = {"flash_attention": rounds * cfg.num_layers,
            "decode_attention": rounds * cfg.num_layers * 31}
    t = report["timings"]
    emit({"phase": "serve", "arch": cfg.name, "d_model": cfg.d_model,
          "layers": cfg.num_layers, "devices": report["devices"], "rounds": rounds,
          "requests": len(done), "new_tokens": report["tokens"],
          "serve_s": report["seconds"], "tokens_per_s": report["tokens"] / report["seconds"],
          "prefill_ms_per_round": [x["prefill_s"] * 1e3 for x in t],
          "decode_ms_per_round": [x["decode_s"] * 1e3 for x in t],
          "decode_ms_per_step": [x["decode_s"] * 1e3 / 31 for x in t],
          "wall_s_with_weight_init": wall,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "expected_launches": want, "tokens_ok": ok_tokens})
    if not ok_tokens:
        raise AssertionError("not every request came back with 32 in-vocab tokens")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not report["devices"] == ["cuda:0"]:
        raise AssertionError(f"served on {report['devices']}, not cuda:0")
    return launches, report


def _device_breakdown(torch, prof, wall_s: float, steps: int) -> dict:
    """Kernel time by name from a profiler trace, per step, and the device's
    idle share of the profiled wall time."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total  # noqa: E731
    busy_ms = sum(us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=us, reverse=True)[:8]
    return {"wall_ms_per_step": wall_s * 1e3 / steps,
            "device_busy_ms_per_step": busy_ms / steps if kernels else None,
            "idle_share": 1 - busy_ms / (wall_s * 1e3) if kernels else None,
            "kernels_launched_per_step": sum(e.count for e in kernels) / steps,
            "top_kernels": [{"name": e.key[:80], "ms_per_step": us(e) / 1e3 / steps,
                             "calls_per_step": e.count / steps} for e in top]}


def profile_serving(torch, pool):
    """torch.profiler over one prefill and 8 decode steps of the served model
    (batch 4, prompt 512), after the counted main path."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    model = pool.replicas[0].model
    dev = model.device
    S, steps = 512, 8
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (4, S))).to(dev)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        M.prefill(model, tokens, max_len=S + steps)               # warm-up
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            logits, caches = M.prefill(model, tokens, max_len=S + steps)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        prefill = _device_breakdown(torch, prof, prefill_s, 1)
        tok = logits.argmax(-1)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, caches = M.decode_step(model, caches, tok[:, None], S + i)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
        decode = _device_breakdown(torch, prof, decode_s, steps)
    emit({"phase": "profile", "note": "profiler on: wall times include its "
          "recording overhead", "prefill": prefill, "decode_step": decode})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} missing; run from the repository "
              "checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    name = card.split(",")[0].strip()
    flops_peak, bw_peak = peaks(name)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_count": torch.cuda.device_count()})

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs)})
    print(_build.build_log().strip(), flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flash_err = check_flash(torch, gen, dev)
    decode_err = check_decode(torch, gen, dev)
    flash_t = measure_flash(torch, gen, dev, flops_peak, bw_peak)
    decode_t = measure_decode(torch, gen, dev, flops_peak, bw_peak)
    check_small_model(torch, dev)

    launches, report = serve_full_width(torch)
    profile_serving(torch, report["pool"])
    kernels = [
        kernel_row("flash_attention", "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:80",
                   flash_err, flash_t, launches["flash_attention"]),
        kernel_row("decode_attention", "src/repro_torch/kernels/decode_attention/csrc/"
                   "decode_attention.cu", "src/repro/kernels/decode_attention/kernel.py:69",
                   decode_err, decode_t, launches["decode_attention"]),
    ]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
