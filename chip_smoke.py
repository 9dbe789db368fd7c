#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. card and build: ``nvidia-smi`` name and power limit; every CUDA kernel is
   built from ``src/repro_torch/kernels/*/csrc`` with ``nvcc``; for each
   flash, flash backward, decode, mLSTM (forward and backward), scan
   (forward and backward) and sLSTM (forward, backward and the barrier
   probe) instance its registers and spills
   (``-Xptxas -v``; a queue register instance may have no stack frame)
   and, where ``cuobjdump`` exists, its HGMMA, UTMALDG and UBLKCP counts (an
   instance that spills, a tensor-core instance -- bf16 flash forward and
   backward, the mLSTM state and output passes, the mLSTM backward's state,
   rows, dstate and grads passes -- that lacks HGMMA or UTMALDG, or a scan
   backward without UTMALDG, fails the run);
2. kernels: each kernel is held against its plain PyTorch version on the
   card at the serving paths' shapes and at the JAX package's test shapes
   (attention at head_dim 16, 64, 128 and 256, bf16 3e-2, float32 2e-5,
   bf16 flash also at the edges of its tiles and on slices of a fused qkv,
   decode also with empty splits, a long windowed cache, no valid slot and
   groups of 1 to 16; both also at qwen3-moe-30b-a3b's heads (32 over 4,
   hd 128) and gemma3-12b's (16 over 8, hd 256, window 1024: flash past the
   window at S 1536 and 1100, decode against a wrapped 1024-slot ring); mLSTM: h and the final state, bf16 3e-2 of max|h| and
   state rel 1e-3, float32 rel 1e-4, ragged dv tiles and chunk 73; RG-LRU
   scan: float32 2e-5, bf16 3e-2, also S shorter than a chunk, S = 1, S not
   a multiple of the cluster, several rounds, ragged channel tiles, a chunk
   with a = 0, strided inputs staged by bulk copies and by plain loads;
   the sLSTM recurrence (``slstm_scan``): h and the final (h, c, n, m) at
   atol 1e-5 (a state tensor at 1e-5 of its largest value) at xlstm-1.3b's
   serving prefill [4, 512, 4, 512] and training layer [1, 2048, 4, 512]
   (there also against a float64 run of the plain version: the kernel's
   error at most 3x the plain float32's), a decode step (S = 1) from a
   non-zero state, the launchers' reduced dh 16, the small xLSTM
   model's widths and 35 rows in row groups, a second call bit-equal),
   and timed beside its plain version, one PyTorch call computing the same
   function where there is one (``F.scaled_dot_product_attention``; none
   for the mLSTM, the scan or the sLSTM: a yardstick the port never calls)
   and its bound (bytes over HBM rate, operations over the peak rate of
   their type; the sLSTM also its chain bound, S steps x one cluster
   barrier, one barrier timed on its grid by ``slstm_barrier_kernel``). The kernels and SDPA are timed as CUDA graphs of 20 calls (device
   time, no host gaps) in 7 turns of alternating order: the median, with
   the min and max and the time of calls made one by one from the host
   (``eager_ms``). Flash and decode are timed also at qwen3-moe-30b-a3b's
   and gemma3-12b's serving shapes (``qwen3_moe``, ``gemma3``), flash past
   gemma3's window (SDPA with the same boolean mask) and decode on its
   wrapped ring, and both at musicgen-large's (``musicgen``: 32 heads over
   32 kv heads at hd 64). The scan is timed also at recurrentgemma-2b's training
   shape [1, 3072, 2560] (``training_shape``), the sLSTM also at its
   training layer (``training_shape``). The decode row names its
   split plan and grid size; the decode kernel is also built with its phase
   clocks and each phase's share of a block's cycles printed at both
   serving shapes (``decode_phases``);
3. small models: a 2-layer qwen2-shaped model (head_dim 128), an 8-layer
   xLSTM-shaped model (dqk 128, dv 256), a 5-layer RecurrentGemma-shaped
   model (head_dim 256, 10 heads over 1 kv head, window 16 < S), a 2-layer
   qwen3-moe-shaped model (QK-norm, group 8, an MoE whose prefill drops
   pairs), a 6-layer gemma3-shaped model (QK-norm, hd 256, group 2,
   window 16 < S, local theta) and a 2-layer musicgen-shaped model
   (embedding inputs, four codebook heads, hd 64, group 1; served through
   the engine) in float32 serve the same prompts on the card and on the
   CPU; logits and greedy tokens must agree, and the MoE model's prefill
   must give the same bits on a second call;
4. serving: ``repro_torch.launch.serve`` first with its defaults (the card,
   reduced float32 models at head_dim 16: qwen2-7b, recurrentgemma-2b,
   xlstm-1.3b, qwen3-moe-30b-a3b and gemma3-12b, 32 requests each), whose
   greedy tokens must equal the same run's with ``--device cpu``; then 8
   requests of qwen2-7b, xlstm-1.3b, recurrentgemma-2b, qwen3-moe-30b-a3b
   and gemma3-12b at their published widths (random bf16 weights from a
   seed) on cuda:0, one model at a time; then ``serve musicgen-large`` at
   its published widths through the engine (a prefill of [4, 512, 2048]
   bf16 frames, 31 decode steps on ``decode_inputs``; every token of the
   [4, 32, 4] output in [0, 2048); peak memory, prefill ms and decode ms a
   step of a counted and a second round, and its profile). Before each run
   every launch counter is zeroed, and the plain attention, mLSTM, scan and
   sLSTM versions are made to raise until it ends, so each run proves that
   every attention, mLSTM, RG-LRU or sLSTM call went through the kernels
   (xlstm-1.3b: one ``slstm_scan`` launch a layer in each prefill and each
   decode step);
   ``orchestrator``: the runtime orchestrator on ``DevicePool()`` (the
   card) over the one-card scenario (a WS spike, ``start()``, zero load
   (the idle card reflows to the trainer, which starts), 2 train steps, a
   second spike that gets nothing, the card failing and repaired (one
   resize), 2 more steps, zero load), its WS department a recurrentgemma-2b
   ``ServingPool`` at published widths serving 8 requests of 512 + 32
   through ``pool.submit`` while it holds the card, its HPC department the
   train launcher's reduced recurrentgemma-2b ``ElasticTrainer``; the
   events must equal a stub run's, the losses an uninterrupted trainer's
   bit for bit, the launches the serve's and the 4 steps' exactly, and
   ``repro_torch.trace validate`` must accept the trace; each tick's wall
   and the peak memory are printed;
5. profile: ``torch.profiler`` over one prefill and eight decode steps of
   each served model: kernel time by name (the top eight and every kernel of
   the port) and the device's idle share; for xlstm-1.3b also the wall time
   of one mLSTM and one sLSTM block; for qwen3-moe-30b-a3b the MoE's share
   of a decode step (router and dispatch, expert products, combine, each
   timed over the 48 layers in turn; ``moe_decode_split``) beside the
   weight-read bounds, one MoE layer's bits on a second prefill-sized call,
   and the sampler on the profiled prefill's logits (``filter_logits`` on
   the card gives the CPU's bits, ``sample`` with the same noise the same
   tokens);
6. campaign: the batched WS request-queue kernel (``queue_flush``, one
   launch a flush) against its plain version on random jobs of both
   capacity kinds, the CPU tests' edges, the 192-job piecewise set, the
   dedicated-node constant set, ``wide_long`` and jobs at each register
   tier's edges (K 32/33 ... 512/513) and at 600 slots (the shared-memory
   instance), one launch a set (every column but the two sums bit-equal, the
   sums within 1e-5 relative), against the float64 oracle (golden
   tolerance), alone vs co-launched and register vs shared-memory instance
   (bit-identical), and the bucket form on the edges; then ``python -m
   repro_torch.workloads.campaign --grid mix_tiny --trace DIR`` on the card
   with the launch count zeroed and the plain versions raising (traces equal
   the goldens byte for byte, one launch a flush, rows agree with the
   ``--device cpu`` run); ``--grid full --shard 0/252`` the same way
   (cells/s, queue requests/s, each flush's wall and device time and ns a
   request of its longest job); the kernel's device time for one flush of
   that run's first chunk and of the 192-job set beside the plain
   version's, its bytes bound and its chain bound (the longest job x 8
   cycles at the SM clock ``nvidia-smi`` reads meanwhile); and the phase
   clocks' shares of a block's cycles on both flushes (``queue_phases``);
7. control-plane tools (``control_plane_tools``, after ``campaign_full``):
   the port's trace CLI (``python -m repro_torch.trace``) gates the card's
   ``mix_tiny`` traces (``regress`` against the goldens, ``validate``,
   ``replay`` and ``bisect`` against its golden on each); ``--grid full
   --shard 0/252 --trace`` on the card in a run of its own (one launch a
   chunk, plain versions raising), its 24 traces validated and replayed;
   ``repro_torch.examples.sharded_campaign`` on the card (one launch for
   each chunk of the cells each of its four campaigns executes); and the
   paper's SC-vs-DC sweep, ``repro_torch.examples.consolidation_sim --ws
   timeseries`` (host work; every claim must hold);
8. training: the four backward kernels (flash attention's: the tensor-core
   dQ, dK/dV and partial-sum kernels for bf16 at head dims 64-256, the
   CUDA-core dQ and dK/dV kernels otherwise; the RG-LRU scan's reverse
   recurrence; the chunkwise mLSTM's five tensor-core launches for bf16 at
   dqk and dv of 64 and up, its six CUDA-core launches otherwise, each
   check record naming its path; the sLSTM's reverse walk, dxz, dxi, dxf,
   dxo and drec under ``grad_tol`` at [1, 2048, 4, 512], the launchers'
   reduced shapes, the small model's widths and on inputs where the floor
   max(n, 1e-6) wins from step 0, its share printed, a second call
   bit-equal) against their
   plain formulas on the card (the mLSTM's dq, dk, dv, di, df at
   xlstm-1.3b's training layer [1, 2048, 4, 512, 1024] and prefill batch,
   the launchers' reduced shapes, S 300, one chunk, dqk != dv below 64 and
   inputs on which the denominator's floor wins at part of the positions,
   its share printed, a second call bit-equal; flash at
   recurrentgemma-2b's [1, 3072, 10, 1, 256] window 2048, musicgen-large's
   [1, 2048, 32, 32, 64] causal and qwen2-7b's heads, bf16 and float32 at head dims 16, 64, 128 and 256, bf16 also at
   each tensor-core instance's edges, with the forward kernels'
   log-sum-exp, and a second call bit-equal to the first; the scan at
   [1, 3072, 2560], [4, 512, 2560], the launchers' shapes and its plan's
   edges, a second call bit-equal, each case's staging path printed, TMA
   at the recurrentgemma-2b shapes and there the plain loads' bits the
   same) and timed beside their bounds (flash also beside SDPA's backward
   with the same mask, and at musicgen-large's training shape the flash
   forward beside SDPA too; the scan at both recurrentgemma-2b shapes with its
   plan, blocks, blocks an SM, resident clusters and shared bytes; the
   mLSTM's at [1, 2048, 4, 512, 1024] bf16 beside the plain formulas; the
   sLSTM's at [1, 2048, 4, 512] beside the plain formulas and its chain
   bound, one barrier a step, with drec's product timed on its own);
   ``train_reduced``: the first batch's gradients (leaf by leaf) and
   three steps of the train launcher's reduced
   recurrentgemma-2b, qwen2-7b, qwen3-moe-30b-a3b (its loss with the
   MoE's auxiliary losses), musicgen-large (embeddings in, codebook
   labels) and xlstm-1.3b (the mLSTM and sLSTM forward and backward
   kernels; chaotic after its first step, which alone is held)
   on the card against the same on the CPU;
   ``train_launcher``: ``python -m repro_torch.launch.train
   --reduced --arch recurrentgemma-2b --devices 1`` for 4 steps, resumed to
   6, against an uninterrupted 6, and ``--devices`` one more than the host's
   cards refused; ``train_full_width``: recurrentgemma-2b (4 steps of 1 ×
   3072 tokens), musicgen-large (4 steps of 1 × 2048 frames) and
   xlstm-1.3b (4 steps of 1 × 2048 tokens, then profiled and counted as the
   other two, and one mLSTM and one sLSTM block timed as a step runs them,
   ``xlstm_train_blocks``) at their
   published widths through ``ElasticTrainer.train_steps`` on one card
   (world size 1, no process group), remat ``block``, each with its peak
   memory under 80 GB; ``phoenix``: the paper's ``PhoenixOrchestrator`` on
   ``DevicePool()`` between a full-width recurrentgemma-2b ``ServingPool``
   (8 requests of 512 + 32 while it holds the card) and a full-width
   recurrentgemma-2b ``ElasticTrainer`` (``train_full_width``'s setup)
   that the reflow starts: 2 steps, a WS spike that gets nothing, a timed
   resize by checkpoint (write and restore walls, bytes, the filesystem's
   free bytes), 2 steps; the events must equal a stub run's and the four
   losses ``train_full_width``'s bits. Each training run zeroes every launch
   count, makes every plain version (forward and backward) raise, and
   checks the exact launches of every forward and backward kernel;
9. cost (``cost``, after ``phoenix``): the cost tooling held to steps that
   ran on this card. Five one-card cells -- recurrentgemma-2b training at
   1 x 3072, musicgen-large and xlstm-1.3b at 1 x 2048 (remat block; one
   more step of ``train_full_width``'s trainer, untimed), qwen2-7b's served [4, 512]
   prefill into 544 slots and one decode step at position 512 (after its
   serve) -- are counted on the card by ``cost.analysis.CostCounter`` and
   dry-run on ``meta`` (``launch.dryrun.cell_record``, a 1 x 1 abstract
   mesh): FLOPs and launches by kernel equal, the launches the exact
   counts, the predicted peak within 10% of ``max_memory_allocated``; each
   cell's ``roofline.score`` bound and ideal floor beside the measured time
   of the phase that timed it. Then the production cells on the abstract
   16 x 16 and 2 x 16 x 16 meshes (qwen2-7b's three shapes, recurrentgemma-2b
   ``long_500k``, qwen3-moe-30b-a3b ``train_4k`` with ``--moe-ep``), every
   record ``ok``, each with its summary line and wall;
10. examples: ``repro_torch.examples.train_100m --preset 100m --steps 300``
   (it exits 0 only when the nll improved; step ms, tokens/s, peak memory)
   and ``quickstart --arch deepseek-7b --steps 5`` on the card, each with
   its exact launches and the plain versions raising.
Earlier lines are JSON records; the last three are the card line from
``nvidia-smi``, ``{"kernels": [...]}`` (ten rows: flash, decode, mLSTM,
scan, queue core, flash backward, scan backward, mLSTM backward, sLSTM,
sLSTM backward; the forward rows'
``launches_by_run`` also count the training runs, the orchestrator and
phoenix phases, musicgen-large's serve, the cost phase's counted steps and
the examples; flash and decode carry a ``musicgen``
sub-object, flash and flash backward a ``musicgen_training`` one) and ``{"ok": true,
"device": ...}``.
Exits non-zero, printing no result, without a CUDA device or outside the
repository checkout.
"""
from __future__ import annotations

import ast
import contextlib
import gc
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# name fragment -> (dense bf16 tensor-core FLOP/s, HBM bytes/s, float32
# CUDA-core FLOP/s), data sheets; the first fragment found in the card's name
# applies. The H100 SXM5's row is the port's table, ``launch.mesh.HW``, which
# the cost tooling scores against.
PEAKS = (("H100 PCIe", (756e12, 2.0e12, 51e12)),
         ("H100 NVL", (835e12, 3.9e12, 60e12)),
         ("H100", "launch.mesh.HW"),
         ("H200", (989e12, 4.8e12, 67e12)))

SERVE_ARGV = ["--device", "cuda", "--no-reduced", "--requests", "8",
              "--prompt-len", "512", "--max-new", "32", "--max-batch", "4",
              "--devices", "1"]


T0 = time.perf_counter()


def emit(record: dict) -> None:
    """One JSON record a line, with the seconds since the script started."""
    print(json.dumps({**record, "elapsed_s": round(time.perf_counter() - T0, 3)}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def peaks(name: str):
    for fragment, rates in PEAKS:
        if fragment in name:
            if rates == "launch.mesh.HW":
                from repro_torch.launch.mesh import HW
                return HW["peak_flops_bf16"], HW["hbm_bw"], HW["peak_flops_fp32"]
            return rates
    raise RuntimeError(f"no peak rates known for {name!r}")


def time_ms(torch, fn, inputs, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms per call, by CUDA events; ``inputs`` rotate per call."""
    for i in range(warmup):
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


def time_interleaved(torch, fns, inputs, repeats: int = 7, iters: int = 20) -> dict:
    """Device time of each of ``fns`` (name -> fn): ``iters`` calls are
    captured in a CUDA graph, so the host's per-call work (the wrappers'
    Python, tensor-map encoding, launch) leaves no gaps between kernels, and
    the graphs are replayed ``repeats`` times in turns that alternate the
    order (a b b a a b ...). Returns name -> {"median": ms, "min_max": [ms,
    ms], "eager_ms": ms}, per call; ``eager_ms`` is the mean of ``iters``
    calls made one by one from the host, as the served model makes them."""
    graphs, eager = {}, {}
    for name, fn in fns.items():
        eager[name] = time_ms(torch, fn, inputs, iters)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for i in range(iters):
                fn(*inputs[i % len(inputs)])
    runs = {name: [] for name in fns}
    order = list(fns)
    for r in range(repeats):
        for name in (order if r % 2 == 0 else order[::-1]):
            runs[name].append(time_ms(torch, graphs[name].replay, [()], 1, warmup=0) / iters)
    return {name: {"median": sorted(v)[len(v) // 2], "min_max": [min(v), max(v)],
                   "eager_ms": eager[name]} for name, v in runs.items()}


def max_err(torch, out, ref) -> float:
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    return (out.float() - ref.float()).abs().max().item()


# library -> (phase name, entry-function pattern, {instance pattern: the SASS
# instructions such an instance must contain}): wgmma (HGMMA), TMA loads
# (UTMALDG), bulk copies (UBLKCP). Every instance must be free of spills.
TENSOR_CORE = ("HGMMA", "UTMALDG")
BUILD_REPORTS = {
    "flash_attention": ("flash_build", r"flash_(tc|cc)_kernel", {r"flash_tc": TENSOR_CORE}),
    "flash_attention_bwd": ("flash_bwd_build", r"flash_bwd_\w+_kernel",
                            {r"flash_bwd_tc": TENSOR_CORE}),
    "decode_attention": ("decode_build", r"decode_split_kernel", {}),
    "mlstm_chunk": ("mlstm_build", r"mlstm_(state|out|chunk)_kernel",
                    {r"mlstm_(state|out)": TENSOR_CORE}),
    "mlstm_chunk_bwd": ("mlstm_bwd_build", r"mlstm_bwd_\w+_kernel",
                        {r"mlstm_bwd_tc_(state|rows|dstate|grads)": TENSOR_CORE}),
    "rglru_scan": ("scan_build", r"rglru_scan(_bwd)?_kernel", {r"rglru_scan_bwd": ("UTMALDG",)}),
    "slstm_scan": ("slstm_build", r"slstm_(scan|scan_bwd|barrier)_kernel", {}),
    "queue_core": ("queue_build", r"queue_flush_kernel", {}),
}
SASS_COUNTS = ("HGMMA", "UTMALDG", "UBLKCP")


QUEUE_INSTANCES = [f"queue_flush<{r}>" for r in (0, 1, 2, 4, 8, 16)]


def _instance_label(name: str, match) -> str:
    """flash_tc<128>, decode_split<bf16,256>, rglru_scan<f32>, mlstm_state:
    the kernel and its template arguments from the mangled name."""
    template = re.search(r"_kernelI(.*?)Ev", name)
    args = [{"13__nv_bfloat16": "bf16", "f": "f32"}.get(a) or a[2:-1]
            for a in re.findall(r"13__nv_bfloat16|^f|L[ib]\d+E",
                                template.group(1) if template else "")]
    base = match.group(0).replace("_kernel", "")
    return f"{base}<{','.join(args)}>" if args else base


def build_report(libs) -> None:
    """Registers and spills (``-Xptxas -v``) of each kernel instance and,
    where ``cuobjdump`` exists, its count of HGMMA (wgmma), UTMALDG (TMA
    load) and UBLKCP (bulk copy) instructions, one record per library. Fails
    if an instance spills, or lacks an instruction ``BUILD_REPORTS`` requires
    of it."""
    from repro_torch.kernels import _build
    log = _build.build_log()
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    for lib, (phase, pattern, required) in BUILD_REPORTS.items():
        instances = {}
        for name, body in re.findall(r"Compiling entry function '(\w+)'[^\n]*\n(.*?)"
                                     r"(?=Compiling entry function|\Z)", log, re.S):
            kind = re.search(pattern, name)
            if kind is None:
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
            frame = re.search(r"(\d+) bytes stack frame", body)
            instances[name] = {"instance": _instance_label(name, kind),
                               "registers": int(re.search(r"Used (\d+) registers",
                                                          body).group(1)),
                               "spill_stores": int(spill.group(1)),
                               "spill_loads": int(spill.group(2)),
                               "stack_frame": int(frame.group(1)) if frame else None}
        if cuobjdump.is_file():
            sass = subprocess.run([str(cuobjdump), "--dump-sass", str(libs[lib])],
                                  capture_output=True, text=True, check=True,
                                  timeout=300).stdout
            for section in sass.split("Function : ")[1:]:
                fn = section.split(None, 1)[0]
                if fn in instances:
                    instances[fn].update({op: section.count(op) for op in SASS_COUNTS})
        rows = sorted(instances.values(), key=lambda r: r["instance"])
        emit({"phase": phase, "cuobjdump": cuobjdump.is_file(), "instances": rows})
        if not rows:
            raise AssertionError(f"no kernel instance of {lib} in the build log")
        for r in rows:
            if r["spill_stores"] or r["spill_loads"]:
                raise AssertionError(f"{lib} instance {r} spills")
            for which, ops in required.items():
                if re.match(which, r["instance"]) and any(r.get(op, 1) == 0 for op in ops):
                    raise AssertionError(f"{lib} instance {r} lacks one of {ops}")
        if lib == "queue_core":               # every slot tier built, register ones in registers
            if {r["instance"] for r in rows} != set(QUEUE_INSTANCES):
                raise AssertionError(f"queue_core instances {rows}")
            if any(r["stack_frame"] for r in rows if r["instance"] != "queue_flush<0>"):
                raise AssertionError(f"a queue_core register instance has a stack frame: {rows}")


def check_flash(torch, gen, dev):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference
    cases = [  # (B, S, H, K, hd, window, causal, dtype, tol)
        (4, 512, 28, 4, 128, 0, True, torch.bfloat16, 3e-2),     # qwen2-7b prefill
        (2, 500, 28, 4, 128, 0, True, torch.bfloat16, 3e-2),     # ragged S
        (2, 256, 8, 2, 128, 128, True, torch.bfloat16, 3e-2),
        (2, 256, 4, 2, 128, 0, True, torch.float32, 2e-5),       # tests/test_kernels.py
        (1, 512, 4, 4, 128, 0, True, torch.float32, 2e-5),
        (2, 256, 8, 2, 128, 128, True, torch.float32, 2e-5),
        (1, 256, 2, 1, 128, 64, True, torch.float32, 2e-5),      # MQA + window
        (1, 500, 4, 2, 128, 96, True, torch.float32, 2e-5),      # ragged + window
        (1, 130, 4, 2, 128, 0, False, torch.float32, 2e-5),      # not causal
        (4, 512, 10, 1, 256, 2048, True, torch.bfloat16, 3e-2),  # recurrentgemma-2b
        (2, 512, 10, 1, 256, 128, True, torch.bfloat16, 3e-2),   # window < S
        (2, 512, 10, 1, 256, 128, True, torch.float32, 2e-5),
        (1, 300, 10, 1, 256, 0, True, torch.float32, 2e-5),      # ragged S
        # bf16 takes the tensor-core kernel: edges of its 64-row query tiles and
        # its K/V tiles (64 keys at both head dims)
        (1, 300, 10, 1, 256, 0, True, torch.bfloat16, 3e-2),     # ragged S, G 10
        (2, 130, 4, 2, 128, 0, False, torch.bfloat16, 3e-2),     # ragged, not causal
        (2, 130, 4, 2, 256, 0, False, torch.bfloat16, 3e-2),
        (1, 256, 4, 4, 128, 63, True, torch.bfloat16, 3e-2),     # G 1, windows at edges
        (1, 256, 7, 1, 128, 64, True, torch.bfloat16, 3e-2),     # G 7
        (1, 300, 10, 1, 256, 65, True, torch.bfloat16, 3e-2),
        (1, 500, 4, 2, 256, 127, True, torch.bfloat16, 3e-2),
        (2, 300, 8, 2, 128, 0, True, "fused", 3e-2),             # slices of a fused qkv
        # head_dim 16 (every reduced config; bf16 on the CUDA-core kernel) and
        # 64 (musicgen-large; bf16 on the tensor-core kernel, one box a row)
        (8, 8, 4, 2, 16, 0, True, torch.float32, 2e-5),          # reduced qwen2-7b prefill
        (8, 8, 4, 1, 16, 16, True, torch.float32, 2e-5),         # reduced recurrentgemma-2b
        (2, 500, 28, 4, 16, 0, True, torch.float32, 2e-5),
        (1, 300, 10, 1, 16, 65, True, torch.bfloat16, 3e-2),
        (2, 130, 4, 2, 16, 0, False, torch.bfloat16, 3e-2),
        (4, 512, 32, 32, 64, 0, True, torch.bfloat16, 3e-2),     # musicgen-large's heads
        (1, 2048, 32, 32, 64, 0, True, torch.bfloat16, 3e-2),    # musicgen-large training
        (2, 500, 28, 4, 64, 0, True, torch.bfloat16, 3e-2),
        (1, 300, 10, 1, 64, 65, True, torch.bfloat16, 3e-2),
        (2, 130, 4, 2, 64, 0, False, torch.bfloat16, 3e-2),
        (2, 300, 8, 2, 64, 0, True, "fused", 3e-2),
        (2, 500, 28, 4, 64, 0, True, torch.float32, 2e-5),
        (1, 256, 4, 4, 64, 63, True, torch.float32, 2e-5),
        # qwen3-moe-30b-a3b (group 8, QK-norm in front) and gemma3-12b (group 2,
        # hd 256, window 1024 on its local layers; past the window at S > 1024)
        (4, 512, 32, 4, 128, 0, True, torch.bfloat16, 3e-2),
        (2, 300, 32, 4, 128, 0, True, torch.float32, 2e-5),
        (4, 512, 16, 8, 256, 1024, True, torch.bfloat16, 3e-2),
        (4, 512, 16, 8, 256, 0, True, torch.bfloat16, 3e-2),
        (1, 1536, 16, 8, 256, 1024, True, torch.bfloat16, 3e-2),
        (1, 1100, 16, 8, 256, 1024, True, torch.float32, 2e-5),
    ]
    errs = {}
    for B, S, H, K, hd, win, causal, dtype, tol in cases:
        if dtype == "fused":     # q, k, v as head slices of one bf16 tensor
            qkv = torch.randn(B, S, H + 2 * K, hd, generator=gen, device=dev).bfloat16()
            q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
        else:
            q = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, S, K, hd, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, S, K, hd, generator=gen, device=dev).to(dtype)
        out = flash_attention(q, k, v, causal=causal, window=win)
        ref = flash_attention_reference(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        err = max_err(torch, out, ref)
        emit({"phase": "check", "kernel": "flash_attention", "shape": [B, S, H, K, hd],
              "window": win, "causal": causal, "dtype": str(dtype), "max_abs_err": err,
              "tol": tol})
        if not err < tol:
            raise AssertionError(f"flash_attention disagrees: {err} >= {tol}")
        errs.setdefault(hd, err)              # the first case of each head dim
        if dtype == torch.bfloat16:           # and of each bf16 shape
            errs.setdefault((B, S, H, K, hd, win), err)
    return errs


def check_decode(torch, gen, dev):
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_reference
    cases = [  # (B, H, K, hd, L, window, fill, dtype, tol)
        (4, 28, 4, 128, 544, 0, 544, torch.bfloat16, 3e-2),      # qwen2-7b, last step
        (4, 28, 4, 128, 544, 0, 513, torch.bfloat16, 3e-2),      # qwen2-7b, first step
        (2, 8, 2, 128, 1024, 0, 1024, torch.float32, 2e-5),      # tests/test_kernels.py
        (2, 8, 4, 128, 1024, 0, 700, torch.float32, 2e-5),       # partial fill
        (1, 4, 1, 128, 512, 256, 512, torch.float32, 2e-5),      # MQA ring window
        (1, 2, 2, 128, 512, 0, 512, torch.float32, 2e-5),
        (2, 28, 4, 128, 256, 256, None, torch.float32, 2e-5),    # wrapped ring
        (1, 32, 32, 128, 300, 0, 300, torch.float32, 2e-5),      # MHA, ragged L
        (4, 10, 1, 256, 544, 2048, 544, torch.bfloat16, 3e-2),   # recurrentgemma-2b
        (4, 10, 1, 256, 544, 2048, 513, torch.bfloat16, 3e-2),
        (2, 10, 1, 256, 544, 128, 544, torch.float32, 2e-5),     # window < filled
        (2, 10, 1, 256, 256, 256, None, torch.float32, 2e-5),    # wrapped ring
        (1, 16, 1, 256, 300, 0, 300, torch.float32, 2e-5),       # group 16
        # the split-L cluster kernel: empty splits, a long windowed cache, a
        # call with no valid slot (v averaged over every slot), groups 1 to 16
        (2, 8, 2, 128, 5, 0, 5, torch.bfloat16, 3e-2),           # L 5 < splits
        (2, 10, 1, 256, 5, 0, 5, torch.float32, 2e-5),
        (1, 8, 2, 128, 4096, 1024, 4096, torch.bfloat16, 3e-2),  # L 4096, window 1024
        (1, 10, 1, 256, 4096, 1024, 4096, torch.float32, 2e-5),
        (2, 8, 2, 128, 300, 0, 0, torch.bfloat16, 3e-2),         # no valid slot
        (2, 10, 1, 256, 300, 0, 0, torch.float32, 2e-5),
        (2, 4, 4, 128, 544, 0, 513, torch.bfloat16, 3e-2),       # group 1
        (1, 7, 1, 256, 544, 0, 544, torch.bfloat16, 3e-2),       # group 7
        (4, 10, 1, 128, 544, 0, 544, torch.bfloat16, 3e-2),      # group 10
        (1, 16, 1, 128, 300, 0, 300, torch.bfloat16, 3e-2),      # group 16
        (1, 16, 1, 256, 544, 0, 544, torch.bfloat16, 3e-2),
        # head_dim 16 (a bf16 row is 2 lanes' chunks) and 64
        (8, 4, 2, 16, 16, 0, 9, torch.float32, 2e-5),            # reduced qwen2-7b decode
        (8, 4, 1, 16, 16, 16, 16, torch.float32, 2e-5),          # reduced recurrentgemma-2b
        (4, 28, 4, 16, 544, 0, 513, torch.bfloat16, 3e-2),
        (2, 8, 2, 16, 300, 0, 0, torch.bfloat16, 3e-2),          # no valid slot
        (1, 16, 1, 16, 4096, 1024, 4096, torch.float32, 2e-5),   # group 16, long window
        (4, 32, 32, 64, 544, 0, 544, torch.bfloat16, 3e-2),      # musicgen-large's heads
        (4, 10, 1, 64, 544, 2048, 513, torch.bfloat16, 3e-2),
        (2, 8, 2, 64, 5, 0, 5, torch.float32, 2e-5),             # L 5 < splits
        (1, 16, 1, 64, 300, 0, 300, torch.float32, 2e-5),
        # qwen3-moe-30b-a3b (group 8) and gemma3-12b (group 2, hd 256; its local
        # layers' ring of 1024 slots, wrapped)
        (4, 32, 4, 128, 544, 0, 544, torch.bfloat16, 3e-2),      # qwen3-moe, last step
        (4, 32, 4, 128, 544, 0, 513, torch.bfloat16, 3e-2),      # first step
        (2, 32, 4, 128, 300, 0, 300, torch.float32, 2e-5),
        (4, 16, 8, 256, 544, 1024, 544, torch.bfloat16, 3e-2),   # gemma3, local layer
        (4, 16, 8, 256, 544, 0, 513, torch.bfloat16, 3e-2),      # global layer
        (4, 16, 8, 256, 1024, 1024, None, torch.bfloat16, 3e-2),  # wrapped ring
        (1, 16, 8, 256, 1024, 1024, None, torch.float32, 2e-5),
    ]
    errs = {}
    for B, H, K, hd, L, win, fill, dtype, tol in cases:
        q = torch.randn(B, H, hd, generator=gen, device=dev).to(dtype)
        ck = torch.randn(B, L, K, hd, generator=gen, device=dev).to(dtype)
        cv = torch.randn(B, L, K, hd, generator=gen, device=dev).to(dtype)
        if fill is None:                    # 700 tokens through a 256-slot ring,
            cur = max(699, L + L // 2 - 1)  # 1536 through a 1024-slot one
            sp = torch.arange(L, device=dev) + (cur + 1 - L)
            sp = sp.roll(int((cur + 1) % L)).to(torch.int32)
        else:                               # fill 0: an empty cache, cur_pos -1
            cur = fill - 1
            ar = torch.arange(L, device=dev, dtype=torch.int32)
            sp = torch.where(ar < fill, ar, torch.full_like(ar, -1))
        out = decode_attention(q, ck, cv, sp, cur, window=win)
        ref = decode_attention_reference(q, ck, cv, sp, cur, window=win)
        torch.cuda.synchronize()
        err = max_err(torch, out, ref)
        emit({"phase": "check", "kernel": "decode_attention", "shape": [B, H, K, L, hd],
              "window": win, "fill": fill, "dtype": str(dtype), "max_abs_err": err,
              "tol": tol})
        if not err < tol:
            raise AssertionError(f"decode_attention disagrees: {err} >= {tol}")
        errs.setdefault(hd, err)              # the first case of each head dim
        if dtype == torch.bfloat16:           # and of each bf16 shape
            errs.setdefault((B, H, K, hd, L, win), err)
    return errs


def measure_flash(torch, gen, dev, peak, B, S, H, K, hd, window=0):
    """A serving prefill shape, bf16, causal, with the model's window
    (2048 >= S for recurrentgemma-2b). Inputs are fresh projections in the
    model, so they are timed warm in L2 (15 MB of q/k/v for qwen2-7b, 13 MB
    for recurrentgemma-2b). With a window shorter than S, SDPA takes the
    same mask as a boolean ``attn_mask`` and the bound counts only the
    visible pairs."""
    from repro_torch.cost import kernels as work
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, S, K, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, S, K, hd, generator=gen, device=dev).bfloat16()
    inputs = [(q, k, v)]
    sdpa_mask = {"is_causal": True}
    if 0 < window < S:
        pos = torch.arange(S, device=dev)
        sdpa_mask = {"attn_mask": (pos[None, :] <= pos[:, None])
                     & (pos[None, :] > pos[:, None] - window)}
    turns = time_interleaved(torch, {
        "kernel": lambda a, b, c: flash_attention(a, b, c, window=window),
        "library": lambda a, b, c: F.scaled_dot_product_attention(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
            enable_gqa=True, **sdpa_mask)}, inputs)
    plain = time_ms(torch, lambda a, b, c: flash_attention_reference(
        a, b, c, window=window), inputs)
    flops, nbytes = work.flash_forward(B, S, H, K, hd, window)
    return interleaved_figures(turns, plain, flops, nbytes, peak)


def measure_decode(torch, gen, dev, peak, B, H, K, L, hd, n_caches, cur=None):
    """A serving decode shape at its last step (all L slots valid), bf16.
    ``n_caches`` caches rotate so that reads come from HBM, as in the model,
    where the layers' caches and weights do not fit in L2 (16 x 4.5 MB for
    qwen2-7b, 48 x 2.2 MB for recurrentgemma-2b). With ``cur`` >= L the
    cache is a ring that has wrapped: slot s holds the newest position
    p <= cur with p % L == s (every slot valid, so the work is the same)."""
    from repro_torch.cost import kernels as work
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import decode_attention_reference
    cur = L - 1 if cur is None else cur
    slot = torch.arange(L, device=dev)
    sp = (cur - (cur - slot) % L).to(torch.int32)
    inputs = []
    for _ in range(n_caches):
        inputs.append((torch.randn(B, H, hd, generator=gen, device=dev).bfloat16(),
                       torch.randn(B, L, K, hd, generator=gen, device=dev).bfloat16(),
                       torch.randn(B, L, K, hd, generator=gen, device=dev).bfloat16()))
    mask = (sp >= 0).view(1, 1, 1, L)
    plan = dops.split_plan(B, K, H // K, L, hd)
    turns = time_interleaved(torch, {
        "kernel": lambda q, ck, cv: dops.decode_attention(q, ck, cv, sp, cur),
        "library": lambda q, ck, cv: F.scaled_dot_product_attention(
            q[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2), attn_mask=mask,
            enable_gqa=True)}, inputs)
    plain = time_ms(torch, lambda q, ck, cv: decode_attention_reference(q, ck, cv, sp, cur),
                    inputs)
    flops, nbytes = work.decode(B, H, K, L, hd)
    return {**interleaved_figures(turns, plain, flops, nbytes, peak),
            "split_plan": list(plan), "blocks": plan.blocks(B, K)}


def decode_phases() -> None:
    """Where a decode block's cycles go at both serving shapes: the kernel
    built with its phase clocks (``kernels/decode_attention/phases.py``)."""
    from repro_torch.kernels.decode_attention import phases
    lib = phases.build()
    for model, shape in phases.SHAPES.items():
        emit({"phase": "decode_phases", "model": model, **phases.measure(lib, *shape)})


def _mlstm_inputs(torch, gen, dev, B, S, H, dqk, dv, dtype):
    """As the JAX kernel test draws them: k / sqrt(dqk), forget gates
    log_sigmoid(N(0,1) + 2); the gates stay float32."""
    q = torch.randn(B, S, H, dqk, generator=gen, device=dev).to(dtype)
    k = (torch.randn(B, S, H, dqk, generator=gen, device=dev) / dqk ** 0.5).to(dtype)
    v = torch.randn(B, S, H, dv, generator=gen, device=dev).to(dtype)
    il = torch.randn(B, S, H, generator=gen, device=dev)
    fl = torch.nn.functional.logsigmoid(torch.randn(B, S, H, generator=gen, device=dev) + 2)
    return q, k, v, il, fl


def launcher_default_shapes():
    """The mLSTM's (B, S, H, dqk, dv, chunk) and the scan's (B, S, W) in the
    prefill of ``python -m repro_torch.launch.serve`` at its defaults
    (``serve_reduced_defaults``): ``--max-batch`` prompts of
    ``--prompt-len`` tokens through the reduced xlstm-1.3b and
    recurrentgemma-2b."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import build_parser
    from repro_torch.models.xlstm import PREFILL_CHUNK, mlstm_dims
    args = build_parser().parse_args([])
    B, S = args.max_batch, args.prompt_len
    _, H, dqk, dv = mlstm_dims(reduced_config(get_config("xlstm-1.3b")))
    W = reduced_config(get_config("recurrentgemma-2b")).lru_width
    return (B, S, H, dqk, dv, PREFILL_CHUNK), (B, S, W)


def check_mlstm(torch, gen, dev):
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    from repro_torch.kernels.mlstm_chunk.ref import chunk_size, mlstm_chunk_reference
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (B, S, H, dqk, dv, chunk, dtype); h tol x max|h|, state rel tol
        (4, 512, 4, 512, 1024, 256, bf16),     # xlstm-1.3b prefill
        (4, 512, 4, 512, 1024, 256, f32),
        (*launcher_default_shapes()[0], f32),  # reduced xlstm-1.3b, launcher defaults
        (1, 511, 4, 512, 1024, 256, bf16),     # chunk 73
        (1, 511, 2, 128, 96, 256, f32),        # chunk 73, ragged dv tile
        (1, 511, 2, 128, 96, 256, bf16),
        (2, 256, 2, 64, 96, 64, bf16),         # ragged dv tile, 4 chunks
        (1, 192, 2, 128, 256, 256, bf16),      # one chunk: no interior state
        (1, 256, 2, 128, 256, 128, f32),       # tests/test_kernels.py
        (2, 512, 4, 128, 128, 128, f32),
        (1, 256, 2, 256, 512, 64, f32),
        (1, 256, 2, 256, 512, 64, bf16),
    ]
    errs = []
    for B, S, H, dqk, dv, chunk, dtype in cases:
        h_tol, state_tol = (3e-2, 1e-3) if dtype == bf16 else (1e-4, 1e-4)
        args = _mlstm_inputs(torch, gen, dev, B, S, H, dqk, dv, dtype)
        h, state = mlstm_chunk(*args, chunk=chunk, return_state=True)
        h_ref, state_ref = mlstm_chunk_reference(*args, chunk=chunk, return_state=True)
        torch.cuda.synchronize()
        err = max_err(torch, h, h_ref)
        rel = err / h_ref.float().abs().max().item()
        state_rel = [max_err(torch, a, b) / b.abs().max().clamp_min(1e-30).item()
                     for a, b in zip(state, state_ref)]
        emit({"phase": "check", "kernel": "mlstm_chunk", "shape": [B, S, H, dqk, dv],
              "chunk": chunk_size(S, chunk), "dtype": str(dtype), "max_abs_err": err,
              "h_rel_err": rel, "h_rel_tol": h_tol, "state_rel_err_C_n_m": state_rel,
              "state_rel_tol": state_tol})
        if not (rel < h_tol and all(r < state_tol for r in state_rel)):
            raise AssertionError(f"mlstm_chunk disagrees: h {rel}, state {state_rel}")
        errs.append(err)
    return errs[0]


def measure_mlstm(torch, gen, dev, peak):
    """xlstm-1.3b prefill shape, bf16, with the final state as the model asks
    for it. Inputs are fresh projections in the model, so they are timed warm
    in L2 (34 MB of q/k/v). The two kernels of a call are short enough that
    the host's per-call work matters, so the call is timed as a CUDA graph
    (``time_interleaved``) with no library yardstick beside it."""
    from repro_torch.cost import kernels as work
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_reference
    B, S, H, dqk, dv, c = 4, 512, 4, 512, 1024, 256
    inputs = [_mlstm_inputs(torch, gen, dev, B, S, H, dqk, dv, torch.bfloat16)]
    turns = time_interleaved(torch, {"kernel": lambda *a: mlstm_chunk(*a, return_state=True)},
                             inputs)["kernel"]
    plain = time_ms(torch, lambda *a: mlstm_chunk_reference(*a, return_state=True),
                    inputs)
    flops, nbytes = work.mlstm(B, S, H, dqk, dv, c)
    return {**measured(turns["median"], plain, None, flops, nbytes, peak[0], peak[1]),
            "min_max_ms": turns["min_max"], "eager_ms": turns["eager_ms"]}


def _rglru_inputs(torch, gen, dev, B, S, W, dtype):
    """As the JAX kernel test draws them: a = sigmoid(N) * 0.2 + 0.79,
    b = N * 0.1, h0 = N."""
    a = torch.sigmoid(torch.randn(B, S, W, generator=gen, device=dev)) * 0.2 + 0.79
    b = torch.randn(B, S, W, generator=gen, device=dev) * 0.1
    h0 = torch.randn(B, W, generator=gen, device=dev)
    return a.to(dtype), b.to(dtype), h0


def check_rglru(torch, gen, dev):
    from repro_torch.kernels.rglru_scan.ops import bulk_copies, rglru_scan, scan_plan
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_reference
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (B, S, W, dtype, tol, variant)
        (4, 512, 2560, f32, 2e-5, None),           # recurrentgemma-2b prefill
        (1, 3072, 2560, f32, 2e-5, None),          # recurrentgemma-2b training
        (*launcher_default_shapes()[1], f32, 2e-5, None),  # reduced, launcher defaults
        (2, 512, 512, f32, 2e-5, None),            # tests/test_kernels.py
        (1, 256, 1024, f32, 2e-5, None),
        (3, 128, 512, f32, 2e-5, None),
        (4, 512, 2560, bf16, 3e-2, None),
        (1, 511, 1000, f32, 2e-5, None),           # ragged S and W
        # the split-S cluster kernel's edges (scan_plan: chunks of <= 64 steps,
        # <= 8 a round): S shorter than a chunk, S = 1, S not a multiple of
        # the cluster, several rounds, ragged channel tiles, a chunk with a =
        # 0, non-zero h0 with strided a and b (bulk copies and plain loads)
        (2, 10, 256, f32, 2e-5, None), (3, 1, 128, f32, 2e-5, None),
        (3, 1, 128, bf16, 3e-2, None), (2, 100, 512, f32, 2e-5, None),
        (2, 1000, 192, f32, 2e-5, None), (1, 5000, 64, bf16, 3e-2, None),
        (2, 300, 33, f32, 2e-5, None), (2, 511, 1000, bf16, 3e-2, None),
        (2, 512, 256, f32, 2e-5, "zero chunk"), (2, 512, 256, bf16, 3e-2, "zero chunk"),
        (3, 200, 96, f32, 2e-5, "strided"), (3, 200, 90, f32, 2e-5, "strided"),
        (3, 200, 96, bf16, 3e-2, "strided"),
    ]
    errs = []
    for B, S, W, dtype, tol, variant in cases:
        a, b, h0 = _rglru_inputs(torch, gen, dev, B, S, W, dtype)
        if variant == "zero chunk":                 # chunk 3's product of a is 0
            c = scan_plan(S).chunk
            a[:, 3 * c:4 * c] = 0
        if variant == "strided":                    # a [S, B, W], b [B, S, 2W] viewed
            a = a.transpose(0, 1).contiguous().transpose(0, 1)
            b = torch.cat([b, b], dim=2)[..., :W]
        out = rglru_scan(a, b, h0)
        ref = rglru_scan_reference(a, b, h0)
        torch.cuda.synchronize()
        err = max_err(torch, out, ref)
        emit({"phase": "check", "kernel": "rglru_scan", "shape": [B, S, W],
              "dtype": str(dtype), "variant": variant, "plan": list(scan_plan(S)),
              "bulk_copies": bulk_copies(a, b), "max_abs_err": err, "tol": tol})
        if not (err < tol and out.dtype == dtype):
            raise AssertionError(f"rglru_scan disagrees: {err} >= {tol}")
        errs.append(err)
    a = torch.full((1, 4, 256), 0.5, device=dev)          # tests/test_kernels.py h0
    h = rglru_scan(a, torch.zeros_like(a), torch.ones(1, 256, device=dev))
    torch.cuda.synchronize()
    want = torch.tensor([0.5, 0.25, 0.125, 0.0625], device=dev)[None, :, None]
    err = max_err(torch, h, want.expand_as(h))
    emit({"phase": "check", "kernel": "rglru_scan", "case": "h0 = 1, a = 0.5, b = 0",
          "max_abs_err": err, "tol": 1e-6})
    if not err < 1e-6:
        raise AssertionError(f"rglru_scan ignores h0: {err}")
    return errs[0], errs[1]


def measure_rglru(torch, gen, dev, peak, B=4, S=512, W=2560):
    """recurrentgemma-2b prefill shape (or its training shape [1, 3072,
    2560]): a, b float32 [4, 512, 2560] from a zero state, as the model calls
    it, timed as the attention kernels are
    (``time_interleaved``: CUDA graphs of 20 calls, 7 turns). 63 MB of a, b
    and h exceed the 50 MB L2, so ``ms`` times one set of inputs. Whether
    some of it stays in L2 from one call to the next shows in
    ``rotated_ms``: the same calls, in the same turns, rotating over three
    sets (189 MB). No library yardstick: no single PyTorch call computes a
    linear recurrence."""
    from repro_torch.cost import kernels as work
    from repro_torch.kernels.rglru_scan.ops import rglru_scan, scan_plan
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_reference
    inputs = [(*_rglru_inputs(torch, gen, dev, B, S, W, torch.float32)[:2],
               torch.zeros(B, W, device=dev)) for _ in range(3)]
    turns = time_interleaved(torch, {"kernel": lambda *_: rglru_scan(*inputs[0]),
                                     "rotated": rglru_scan}, inputs)
    plain = time_ms(torch, rglru_scan_reference, inputs[:1], iters=5)
    flops, nbytes = work.rglru_forward(B, S, W)
    plan = scan_plan(S)
    one, rotated = turns["kernel"], turns["rotated"]
    return {**measured(one["median"], plain, None, flops, nbytes, peak[2], peak[1]),
            "min_max_ms": one["min_max"], "eager_ms": one["eager_ms"],
            "rotated_ms": rotated["median"], "rotated_min_max_ms": rotated["min_max"],
            "scan_plan": list(plan), "blocks": plan.clusters * -(-W // 64) * B}


# ------------------------------------------------------------------ sLSTM

def _slstm_inputs(torch, gen, dev, B, S, H, dh, nonzero=False, i_shift=0.0):
    """Gate inputs N(0, 1), rec N(0, 1/dh) as ``init_slstm_block`` draws it,
    and a zero state, or a non-zero one (n in [0.5, 2]); ``i_shift`` moves
    the input gate of the first three steps (and the forget gate up by 4)
    so that the normaliser's floor max(n, 1e-6) wins there."""
    x = [torch.randn(B, S, H, dh, generator=gen, device=dev) for _ in range(4)]
    if i_shift:
        x[1][:, :3] += i_shift
        x[2][:, :3] += 4.0
    rec = torch.randn(4, H, dh, dh, generator=gen, device=dev) / dh ** 0.5
    if nonzero:
        state = {"h": torch.randn(B, H, dh, generator=gen, device=dev) * 0.5,
                 "c": torch.randn(B, H, dh, generator=gen, device=dev),
                 "n": torch.rand(B, H, dh, generator=gen, device=dev) * 1.5 + 0.5,
                 "m": torch.randn(B, H, generator=gen, device=dev)}
    else:
        state = {k: torch.zeros((B, H, dh) if k != "m" else (B, H), device=dev)
                 for k in "hcnm"}
    return x, rec, state


def slstm_shapes():
    """(case, B, S, H, dh, a non-zero initial state) of the sLSTM checks:
    xlstm-1.3b's serving prefill and training layer, a decode step from a
    state, the serve and train launchers' reduced dh 16 at their batches,
    and the small xLSTM model's widths (``small_configs``)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import build_parser as serve_parser
    from repro_torch.launch.train import build_parser as train_parser
    full, red = get_config("xlstm-1.3b"), reduced_config(get_config("xlstm-1.3b"))
    small = next(cfg for cfg, _ in small_configs() if cfg.name == "xlstm-1.3b")
    H, dh = full.num_heads, full.d_model // full.num_heads
    rH, rdh = red.num_heads, red.d_model // red.num_heads
    serve, train = serve_parser().parse_args([]), train_parser().parse_args([])
    return [("serving_prefill", 4, 512, H, dh, False), ("training", 1, 2048, H, dh, False),
            ("decode_step", 4, 1, H, dh, True),
            ("serve_launcher_reduced", serve.max_batch, serve.prompt_len, rH, rdh, False),
            ("train_launcher_reduced", train.batch, train.seq, rH, rdh, False),
            ("small_model", 2, 40, small.num_heads, small.d_model // small.num_heads, True)]


# h is held at SLSTM_ATOL, each final state tensor at SLSTM_ATOL x max(1,
# its largest value) (c and n grow with the steps): float32 sums in another
# order. At S 2048 the kernel's worst error in h against a float64 run of
# the plain version is held at SLSTM_F64_RATIO x the plain float32's.
SLSTM_ATOL = 1e-5
SLSTM_F64_RATIO = 3.0


# 35 rows at xlstm-1.3b's heads: several row groups (ops.scan_plan)
SLSTM_BATCH_35 = ("batch_35", 35, 64, 4, 512, True)


def slstm_plan(ops, B, H, dh, dev) -> dict:
    """The kernels' plan at a shape, named, with the clusters the card runs
    at once (``cudaOccupancyMaxActiveClusters``), forward and backward."""
    plan = ops.card_plan(B, H, dh, dev)
    return {"P": plan.blocks, "C": plan.columns, "Bc": plan.rows, "groups": plan.groups,
            "clusters": H * plan.groups,
            "max_active_clusters": {"forward": ops.residency(plan, dh, True)[1],
                                    "backward": ops.residency(plan, dh, False)[1]}}


def check_slstm(torch, gen, dev):
    """The forward kernel against ``slstm_scan_reference`` on the card at
    ``slstm_shapes`` and 35 rows: h and the final (h, c, n, m), and a
    second call's bits. At the training layer also both against float64."""
    from repro_torch.kernels.slstm_scan import ops
    errs = {}
    for case, B, S, H, dh, nonzero in slstm_shapes() + [SLSTM_BATCH_35]:
        x, rec, state = _slstm_inputs(torch, gen, dev, B, S, H, dh, nonzero)
        h, final = ops.slstm_scan(*x, rec, state)
        h2, final2 = ops.slstm_scan(*x, rec, state)
        h_ref, final_ref = ops.slstm_scan_reference(*x, rec, state)
        torch.cuda.synchronize()
        err = {"h": max_err(torch, h, h_ref),
               **{k: max_err(torch, final[k], final_ref[k]) for k in "hcnm"}}
        tol = {"h": SLSTM_ATOL, **{k: SLSTM_ATOL * max(1.0, final_ref[k].abs().max().item())
                                   for k in "hcnm"}}
        same = torch.equal(h, h2) and all(torch.equal(final[k], final2[k]) for k in "hcnm")
        record = {"phase": "check", "kernel": "slstm_scan", "case": case, "shape": [B, S, H, dh],
                  "plan": slstm_plan(ops, B, H, dh, dev), "nonzero_state": nonzero,
                  "max_abs_err": err["h"], "final_state_err": {k: err[k] for k in "hcnm"},
                  "tol": tol, "second_call_bit_equal": same}
        ok = same and all(err[k] <= tol[k] for k in err)
        if case == "training":
            want, _ = ops.slstm_scan_reference(*(t.double() for t in x), rec.double(),
                                               {k: v.double() for k, v in state.items()})
            sides = {"kernel": (h.double() - want).abs().max().item(),
                     "plain": (h_ref.double() - want).abs().max().item()}
            record["h_err_against_float64"] = sides
            record["float64_ratio_limit"] = SLSTM_F64_RATIO
            ok = ok and sides["kernel"] <= SLSTM_F64_RATIO * sides["plain"]
        emit(record)
        if not ok:
            raise AssertionError(f"slstm_scan disagrees: {record}")
        errs[case] = err["h"]
    return errs


def slstm_chain_bound(torch, ops, dev, B, S, H, dh) -> dict:
    """The chain bound of a call: S steps x one cluster barrier, one
    barrier timed as 2,000 of them on the call's grid (``ops.barrier_probe``,
    the forward's shared memory a block)."""
    plan = ops.card_plan(B, H, dh, dev)
    n = 2000
    barrier_ms = time_ms(torch, lambda: ops.barrier_probe(plan, H, dh, n, dev), [()],
                         iters=5, warmup=1) / n
    return {"plan": slstm_plan(ops, B, H, dh, dev),
            "blocks": H * plan.groups * plan.blocks,
            "smem_bytes": {"forward": ops.residency(plan, dh, True)[0],
                           "backward": ops.residency(plan, dh, False)[0]},
            "barrier_us": barrier_ms * 1e3, "barriers_a_step": 1,
            "chain_bound_ms": S * barrier_ms}


def measure_slstm(torch, gen, dev, peak, B, S, H, dh):
    """The forward kernel from a zero state, as the model calls it, timed as
    the other kernels (``time_interleaved``: CUDA graphs of 20 calls, 7
    turns), beside the plain version; its bound by bytes and by float32
    operations (``cost.kernels.slstm``, the factored work) and its chain
    bound (one cluster barrier a step). No library yardstick: no single PyTorch call computes this
    cell (cuDNN's LSTM is another function)."""
    from repro_torch.cost import kernels as work
    from repro_torch.kernels.slstm_scan import ops
    x, rec, state = _slstm_inputs(torch, gen, dev, B, S, H, dh)
    inputs = [(*x, rec, state)]
    turns = time_interleaved(torch, {"kernel": ops.slstm_scan}, inputs)["kernel"]
    plain = time_ms(torch, ops.slstm_scan_reference, inputs, iters=2, warmup=1)
    flops, nbytes = work.slstm(B, S, H, dh)
    chain = slstm_chain_bound(torch, ops, dev, B, S, H, dh)
    return {**measured(turns["median"], plain, None, flops, nbytes, peak[2], peak[1]),
            "min_max_ms": turns["min_max"], "eager_ms": turns["eager_ms"], **chain,
            "chain_share": chain["chain_bound_ms"] / turns["median"]}


def check_slstm_backward(torch, gen, dev):
    """dxz, dxi, dxf, dxo and drec of the backward kernel (and its product)
    against ``slstm_scan_backward_reference`` on the same saved values (the
    plain forward's) under ``grad_tol``; a second call gives the same bits.
    Cases: ``slstm_shapes`` but the decode step, 35 rows, and inputs on
    which the floor max(n, 1e-6) wins from step 0 (its share of the
    positions is printed and must lie strictly between 0 and 1)."""
    from repro_torch.kernels.slstm_scan import ops
    from repro_torch.kernels.slstm_scan.ref import FLOOR
    cases = [(case, B, S, H, dh, nonzero, 0.0)
             for case, B, S, H, dh, nonzero in slstm_shapes() + [SLSTM_BATCH_35] if S > 1]
    cases += [("floor_wins", 2, 64, 4, 512, False, -20.0),
              ("floor_wins_reduced", 2, 40, 4, 16, False, -20.0)]
    names = ("dxz", "dxi", "dxf", "dxo", "drec")
    errs = {}
    for case, B, S, H, dh, nonzero, shift in cases:
        x, rec, state = _slstm_inputs(torch, gen, dev, B, S, H, dh, nonzero, shift)
        h, _, saved = ops.slstm_scan_reference(*x, rec, state, with_saved=True)
        dy = torch.randn(B, S, H, dh, generator=gen, device=dev)
        got = ops.slstm_scan_backward(rec, state, h, saved, dy)
        again = ops.slstm_scan_backward(rec, state, h, saved, dy)
        ref = ops.slstm_scan_backward_reference(rec, state, h, saved, dy)
        torch.cuda.synchronize()
        err, report, ok = grad_errors(torch, got, ref, names, torch.float32, 1e-4)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        share = (saved.n < FLOOR).float().mean().item()
        record = {"phase": "check", "kernel": "slstm_scan_backward", "case": case,
                  "shape": [B, S, H, dh], "plan": slstm_plan(ops, B, H, dh, dev),
                  "floor_share": share, "max_abs_err": err, **report,
                  "second_call_bit_equal": same}
        emit(record)
        if shift:
            ok = ok and 0.0 < share < 1.0 and bool((saved.n[:, 0] < FLOOR).all())
        if not (ok and same):
            raise AssertionError(f"slstm_scan backward disagrees: {record}")
        errs[case] = err
        del x, rec, state, h, saved, dy, got, again, ref
    return errs


def measure_slstm_backward(torch, gen, dev, peak, B=1, S=2048, H=4, dh=512):
    """The backward kernel at xlstm-1.3b's training layer on the forward
    kernel's saved values, timed as the forward (``time_interleaved``),
    beside the plain formulas; its bound (``cost.kernels.slstm_backward``,
    float32) and chain bound (one cluster barrier a step). The product for
    drec is timed on its own (``drec_ms``)."""
    from repro_torch.cost import kernels as work
    from repro_torch.kernels.slstm_scan import ops
    from repro_torch.kernels.slstm_scan.ref import recurrent_grad
    x, rec, state = _slstm_inputs(torch, gen, dev, B, S, H, dh)
    h, _, saved = ops._launch(*x, rec, state, with_saved=True)
    dy = torch.randn(B, S, H, dh, generator=gen, device=dev)
    inputs = [(rec, state, h, saved, dy)]
    turns = time_interleaved(torch, {"kernel": ops._launch_backward}, inputs)["kernel"]
    dx = ops._launch_backward(*inputs[0])
    drec = time_ms(torch, recurrent_grad, [(state["h"], h, dx)], iters=10)
    plain = time_ms(torch, ops.slstm_scan_backward_reference, inputs, iters=1, warmup=1)
    flops, nbytes = work.slstm_backward(B, S, H, dh)
    chain = slstm_chain_bound(torch, ops, dev, B, S, H, dh)
    return {**measured(turns["median"], plain, None, flops, nbytes, peak[2], peak[1]),
            "min_max_ms": turns["min_max"], "eager_ms": turns["eager_ms"], "drec_ms": drec,
            **chain, "chain_share": chain["chain_bound_ms"] / turns["median"]}


def measured(kernel, plain, library, flops, nbytes, flops_peak, bw_peak) -> dict:
    """A ``measure_*`` result (ms); the bound is max(operations / peak rate of
    their type, bytes / HBM rate)."""
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / bw_peak * 1e3
    bound_ms = max(t_ops, t_bytes)
    out = {"ms": kernel, "plain_ms": plain, "bound_ms": bound_ms,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": library, "tflops": flops / kernel / 1e9,
           "bound_share": bound_ms / kernel}
    if library is not None:
        out["ms_over_library_ms"] = kernel / library
    return out


def interleaved_figures(turns, plain, flops, nbytes, peak) -> dict:
    """``measured`` from the medians of a kernel-vs-library
    ``time_interleaved``, with the min and max of each side's turns and the
    eager time (calls made one by one from the host) of each."""
    return {**measured(turns["kernel"]["median"], plain, turns["library"]["median"],
                       flops, nbytes, peak[0], peak[1]),
            "min_max_ms": turns["kernel"]["min_max"],
            "library_min_max_ms": turns["library"]["min_max"],
            "eager_ms": turns["kernel"]["eager_ms"],
            "library_eager_ms": turns["library"]["eager_ms"]}


def kernel_row(name, source, replaces, err, figures, launches, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "max_abs_err": err, **figures,
            "launches_by_run": launches, **extra}


def shape_figures(shape, err, figures):
    """A second shape's figures of a kernel row (recurrentgemma-2b's)."""
    return {"shape": shape, "max_abs_err": err, **figures}


def serve_frames(torch, model, frames, max_new: int):
    """Greedy serve of an embeddings arch through the engine, as the JAX
    package serves one (its replicas feed token ids): a prefill on frames
    [B, S, D], then ``max_new - 1`` decode steps on ``decode_inputs`` (the JAX
    engine's zero frames). Returns (tokens [B, max_new, C] as numpy, prefill
    s, decode s), host clock after a synchronize."""
    from repro_torch.device import synchronize
    from repro_torch.serving.engine import decode_inputs, make_decode_fn, make_prefill_fn
    cfg, dev = model.cfg, model.device
    B, S = frames.shape[:2]
    decode = make_decode_fn(cfg)
    step_in = decode_inputs(cfg, B, device=dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        tok, caches = make_prefill_fn(cfg, max_len=S + max_new)(model, frames)
        synchronize(dev)
        t1 = time.perf_counter()
        toks = [tok]
        for i in range(max_new - 1):
            tok, caches = decode(model, caches, step_in, S + i)
            toks.append(tok)
        out = torch.stack(toks, dim=1).cpu().numpy()
        t2 = time.perf_counter()
    return out, t1 - t0, t2 - t1


def check_small_model(torch, dev, cfg, S: int):
    """A small float32 model: prefill logits and greedy tokens, card vs CPU
    (token archs through a ``ServingPool``, an embeddings arch through the
    engine, ``serve_frames``). For an MoE model also the pairs its prefill
    dropped on the card (some must drop) and a second prefill's logits, which
    must be the same bits."""
    import numpy as np
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.runtime.serving_pool import ServingPool
    cpu_model = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    with torch.no_grad():      # non-zero biases, norm scales, conv_b, out_scale
        g = torch.Generator().manual_seed(2)
        for name, p in cpu_model.named_parameters():
            if name.endswith(("bias", "scale", "conv_b")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.3 + 0.1)
    rng = np.random.default_rng(3)
    embeds = cfg.input_mode == "embeddings"
    if embeds:
        prompt = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
        inputs = torch.from_numpy(prompt)
    else:
        prompt = rng.integers(0, cfg.vocab_size, (2, S), dtype=np.int32)
        inputs = torch.from_numpy(prompt).long()
    gpu_model = cpu_model.copy_to(dev)
    with torch.inference_mode():
        want, _ = M.prefill(cpu_model, inputs, max_len=S + 8)
        got, _ = M.prefill(gpu_model, inputs.to(dev), max_len=S + 8)
    err = max_err(torch, got.cpu(), want)
    moe_record, moe_ok = {}, True
    if cfg.moe is not None:
        dropped, dispatch = [], moe.dispatch

        def counted(*args):
            buf, coords = dispatch(*args)
            dropped.append(int((~coords[3]).sum()))
            return buf, coords

        moe.dispatch = counted
        try:
            with torch.inference_mode():
                again, _ = M.prefill(gpu_model, inputs.to(dev), max_len=S + 8)
        finally:
            moe.dispatch = dispatch
        moe_record = {"moe_pairs_dropped_by_layer": dropped,
                      "moe_second_call_bit_equal": torch.equal(again, got)}
        moe_ok = sum(dropped) > 0 and moe_record["moe_second_call_bit_equal"]
    toks = {}
    for d, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        if embeds:
            toks[d] = serve_frames(torch, model, inputs.to(model.device), 8)[0]
            continue
        pool = ServingPool(cfg, model)
        pool.scale_to([dev if d == "cuda" else "cpu"])
        toks[d] = pool.submit(prompt, 8)
    same = bool((toks["cpu"] == toks["cuda"]).all())
    shape = (2, 8, cfg.num_codebooks) if cfg.num_codebooks else (2, 8)
    emit({"phase": "small_model", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "head_dim": cfg.head_dim, "prompt": list(prompt.shape),
          "prefill_logits_max_abs_err": err, "tol": 1e-3, "greedy_tokens_identical": same,
          "shape": list(toks["cuda"].shape), **moe_record})
    if not (err < 1e-3 and same and toks["cuda"].shape == shape and moe_ok):
        raise AssertionError(f"{cfg.name}: port on the card disagrees with the CPU path")


def small_configs():
    """qwen2-shaped (head_dim 128, GQA 7), xLSTM-shaped (dqk 128, dv 256, the
    7:1 pattern), RecurrentGemma-shaped (head_dim 256, 10 heads over 1 kv
    head, window 16 < S, one pattern repeat and a 2-layer rglru tail, tied
    embeddings, softcap), qwen3-moe-shaped (QK-norm, head_dim 128, 32 heads
    over 4; 8 experts, top-2, capacity factor 1: the prefill's 80 tokens
    give an expert 24 slots for 20 pairs on average, so some drop) and
    gemma3-shaped (QK-norm, head_dim 256, 16 heads over 8, 5 local layers
    at theta 10k with window 16 < S and a global one, tied embeddings, gelu)
    and musicgen-shaped (embedding inputs, four codebook heads, head_dim 64,
    group 1, LayerNorm, gelu) float32 models, small enough for the CPU."""
    from repro_torch.configs import MoEConfig, get_config
    f32 = dict(param_dtype="float32", compute_dtype="float32", vocab_size=1024)
    return [(get_config("qwen2-7b").with_(num_layers=2, d_model=256, d_ff=512, **f32), 40),
            (get_config("xlstm-1.3b").with_(num_layers=8, d_model=256, num_heads=2,
                                            **f32), 40),
            (get_config("recurrentgemma-2b").with_(num_layers=5, d_model=256, d_ff=512,
                                                   rnn_width=256, window_size=16,
                                                   **f32), 40),
            (get_config("qwen3-moe-30b-a3b").with_(
                num_layers=2, d_model=256, moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                                                         capacity_factor=1.0), **f32), 40),
            (get_config("gemma3-12b").with_(num_layers=6, d_model=256, d_ff=512,
                                            window_size=16, **f32), 40),
            (get_config("musicgen-large").with_(num_layers=2, d_model=256, num_heads=4,
                                                num_kv_heads=4, d_ff=512, **f32), 40)]


PLAIN_VERSIONS = {  # wrapper module, plain version a CPU tensor takes
    "flash_attention": ("flash_attention", "flash_attention_reference"),
    "flash_attention_backward": ("flash_attention", "flash_attention_backward_reference"),
    "decode_attention": ("decode_attention", "decode_attention_reference"),
    "mlstm_chunk": ("mlstm_chunk", "mlstm_chunk_reference"),
    "mlstm_chunk_backward": ("mlstm_chunk", "mlstm_chunk_backward_reference"),
    "rglru_scan": ("rglru_scan", "rglru_scan_reference"),
    "rglru_scan_backward": ("rglru_scan", "rglru_scan_backward_reference"),
    "slstm_scan": ("slstm_scan", "slstm_scan_reference"),
    "slstm_scan_backward": ("slstm_scan", "slstm_scan_backward_reference"),
}
TRAIN_KERNELS = ("flash_attention", "flash_attention_backward", "rglru_scan",
                 "rglru_scan_backward", "mlstm_chunk", "mlstm_chunk_backward", "slstm_scan",
                 "slstm_scan_backward")


@contextlib.contextmanager
def counted_on_card(launches: dict):
    """Zero every model kernel's launch count, make every plain version
    raise, and on leaving fill ``launches`` (wrapper name -> launches) and
    restore the plain versions."""
    import importlib
    mods = {name: importlib.import_module(f"repro_torch.kernels.{mod}.ops")
            for name, (mod, _) in PLAIN_VERSIONS.items()}

    def plain_forbidden(*args, **kwargs):
        raise AssertionError("a plain kernel version ran on the main path")

    saved = {name: getattr(mods[name], attr) for name, (_, attr) in PLAIN_VERSIONS.items()}
    for name, (_, attr) in PLAIN_VERSIONS.items():
        setattr(mods[name], attr, plain_forbidden)
        getattr(mods[name], name).launches = 0
    try:
        yield launches
    finally:
        launches.update({name: getattr(mods[name], name).launches for name in PLAIN_VERSIONS})
        for name, (_, attr) in PLAIN_VERSIONS.items():
            setattr(mods[name], attr, saved[name])


def serve_counted(torch, argv):
    """Run the launcher (``repro_torch.launch.serve``) with ``argv``, counted
    (``counted_on_card``). Checks the launch counts against the model's
    layers and returns (launches, report)."""
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    launches = {}
    with counted_on_card(launches):
        report = serve.run(argv)
    args = serve.build_parser().parse_args(argv)
    cfg, rounds = report["cfg"], report["rounds"]
    kinds = cfg.layer_kinds()
    n_attn = sum(k in ("attn", "local") for k in kinds)
    want = {name: 0 for name in PLAIN_VERSIONS}
    want.update({"flash_attention": rounds * n_attn,
                 "decode_attention": rounds * n_attn * (args.max_new - 1),
                 "mlstm_chunk": rounds * kinds.count("mlstm"),
                 "rglru_scan": rounds * kinds.count("rglru"),
                 "slstm_scan": rounds * kinds.count("slstm") * args.max_new})
    done = report["completed"]
    ok_tokens = len(done) == args.requests and all(
        r.done is not None and len(r.done) == args.max_new and (r.done >= 0).all()
        and (r.done < cfg.vocab_size).all() for r in done)
    if not ok_tokens:
        raise AssertionError(f"not every request came back with {args.max_new} "
                             "in-vocab tokens")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not report["devices"][0].startswith("cuda"):
        raise AssertionError(f"served on {report['devices']}, not the card")
    return launches, report


def serve_full_width(torch, arch: str):
    """Serve 8 requests of ``arch`` at its published widths on cuda:0,
    counted (``serve_counted``)."""
    t0 = time.perf_counter()
    launches, report = serve_counted(torch, SERVE_ARGV + ["--arch", arch])
    wall = time.perf_counter() - t0
    cfg, rounds, done = report["cfg"], report["rounds"], report["completed"]
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
          "launches": launches, "tokens_ok": True})
    if not report["devices"] == ["cuda:0"]:
        raise AssertionError(f"served on {report['devices']}, not cuda:0")
    return launches, report


def serve_reduced_defaults(torch, arch: str):
    """``python -m repro_torch.launch.serve --arch <arch>`` with every other
    option at its default: the card, a reduced float32 model (head_dim 16;
    xlstm-1.3b has no attention, so its mLSTM kernel runs at the reduced
    widths), 32 requests of 8 prompt and 8 new tokens. Counted
    (``serve_counted``); the greedy tokens must equal those of the same run
    with ``--device cpu``, on the plain versions."""
    import numpy as np
    from repro_torch.launch import serve
    launches, card = serve_counted(torch, ["--arch", arch])
    cpu = serve.run(["--arch", arch, "--device", "cpu"])
    got = {r.req_id: r.done for r in card["completed"]}
    want = {r.req_id: r.done for r in cpu["completed"]}
    same = got.keys() == want.keys() and all(np.array_equal(got[i], want[i]) for i in want)
    cfg = card["cfg"]
    emit({"phase": "serve_reduced_defaults", "arch": cfg.name, "head_dim": cfg.head_dim,
          "d_model": cfg.d_model, "layers": cfg.num_layers, "dtype": cfg.param_dtype,
          "devices": card["devices"], "rounds": card["rounds"], "requests": len(got),
          "launches": launches, "tokens_equal_cpu_run": same})
    if not same:
        raise AssertionError(f"{arch}: the default serve on the card and on the CPU "
                             "gave different tokens")
    return launches


def serve_musicgen(torch, dev) -> dict:
    """musicgen-large at its published widths (bf16 weights drawn on the card
    from seed 0) served through the engine (``serve_frames``): a prefill of
    [4, 512, 2048] bf16 frames from a seeded generator, then 31 decode steps
    on ``decode_inputs``. Counted (``counted_on_card``: flash once a layer,
    decode once a layer a step, the plain versions raising); every token of
    the [4, 32, 4] output must lie in [0, 2048). A second, uncounted round
    gives warm prefill and decode times; then one prefill and 8 decode steps
    are profiled (``profile_serving``). Returns the launches and the model."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("musicgen-large")
    B, S, new = 4, 512, 32
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frames = torch.randn(B, S, cfg.d_model, device=dev, generator=torch.Generator(
        device=dev).manual_seed(1)).bfloat16()
    launches, rounds = {}, []
    with counted_on_card(launches):
        toks, prefill_s, decode_s = serve_frames(torch, model, frames, new)
    rounds.append((prefill_s, decode_s))
    again, prefill_s, decode_s = serve_frames(torch, model, frames, new)
    rounds.append((prefill_s, decode_s))
    n_attn = cfg.num_layers
    want = {name: 0 for name in PLAIN_VERSIONS}
    want.update({"flash_attention": n_attn, "decode_attention": n_attn * (new - 1)})
    in_range = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    record = {"phase": "serve musicgen-large", "arch": cfg.name, "d_model": cfg.d_model,
              "layers": cfg.num_layers, "params": sum(p.numel() for p in model.parameters()),
              "frames": [B, S, cfg.d_model], "dtype": str(frames.dtype),
              "tokens_shape": list(toks.shape), "tokens_in_range": in_range,
              "second_round_same_tokens": bool((again == toks).all()),
              "prefill_ms_by_round": [r[0] * 1e3 for r in rounds],
              "decode_ms_per_step_by_round": [r[1] * 1e3 / (new - 1) for r in rounds],
              "init_s": init_s, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "launches": launches, "expected_launches": want}
    emit(record)
    if not (toks.shape == (B, new, cfg.num_codebooks) and in_range and launches == want):
        raise AssertionError(f"musicgen-large serve failed: {record}")
    profiled = profile_serving(torch, model)
    if profiled["prefill_logits"].shape != (B, cfg.num_codebooks, cfg.vocab_size):
        raise AssertionError(f"musicgen-large logits {profiled['prefill_logits'].shape}")
    return launches


class StubTrainer:
    """Duck-typed ElasticTrainer for the orchestrator's reference run."""
    model_size, global_batch, step = 1, 8, 0

    def start(self, devices):
        pass

    def resize(self, devices):
        pass

    def train_steps(self, n):
        self.step += n
        return {"step": self.step}


class StubPool:
    """Duck-typed ServingPool for the orchestrator's reference run."""

    def __init__(self):
        self.replicas = []

    def scale_to(self, devices):
        self.replicas = list(devices)


SPIKE = ("latency_tick_slo", "ws", 5.0, 0.35, 1.0)
QUIET = ("latency_tick_slo", "ws", 0.0, 0.35, 1.0)
ONE_CARD_TICKS = [SPIKE, ("start",), QUIET, ("train_steps", "hpc", 2), SPIKE,
                  ("fail_node",), ("repair_node",), ("train_steps", "hpc", 2), QUIET]


def one_card_orchestrator(devices, pool, trainer, tracer):
    """The one-card scenario's departments: ``ws`` (latency, priority 0,
    an SLO autoscaler at 2 s with n_min 0 and n_max 1, so it gives the card
    back when its load falls to zero) and ``hpc`` (batch, priority 1, one
    device at least), policy ``paper``; ``devices`` None takes
    ``DevicePool()``'s, every CUDA device."""
    from repro_torch.core.types import SLOConfig
    from repro_torch.runtime.orchestrator import MultiTenantOrchestrator
    from repro_torch.serving.batching import ServiceTimeModel
    from repro_torch.workloads.autoscaler import SLOAutoscaler
    orch = MultiTenantOrchestrator(devices=devices, policy="paper", tracer=tracer)
    orch.add_latency("ws", pool, priority=0, slo_autoscaler=SLOAutoscaler(
        ServiceTimeModel(), SLOConfig(latency_target_s=2.0), n_min=0, n_max=1))
    orch.add_batch("hpc", trainer, priority=1, min_devices=1)
    return orch


def orchestrator_phase(torch, out_dir: Path) -> dict:
    """The runtime orchestrator on ``DevicePool()`` (every CUDA device: the
    card) with real port workloads, over the one-card scenario's ticks: a WS
    spike, ``start()``, the load falling to zero (the idle card reflows to
    the trainer, which starts), 2 train steps, a second spike (no card to
    give: the trainer is at its floor), the card failing and repaired (the
    repair re-grants it: one resize), 2 more train steps, zero load again.
    ``ws`` is a ``ServingPool`` of recurrentgemma-2b at its published widths
    (bf16 weights drawn on the card from seed 0); while the card is its own
    it serves 8 requests of 512 + 32 tokens, batch 4, through
    ``pool.submit``, and the p99 of their latencies is fed back by
    ``observe_latency``. ``hpc`` is an ``ElasticTrainer`` of the train
    launcher's reduced recurrentgemma-2b (its defaults: batch 8 x 128,
    weights drawn on the CPU) checkpointing into ``out_dir``. Counted
    (``counted_on_card``), plain versions raising. Fails unless the events
    equal the same ticks through the orchestrator with stub workloads, the
    trainer was started by the reflow and resized once, its losses equal an
    uninterrupted trainer's bit for bit, the pools check after every tick
    and ``python -m repro_torch.trace validate`` accepts the trace."""
    import shutil
    import numpy as np
    from repro_torch import trace
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.telemetry import Tracer, percentile
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import build_parser
    from repro_torch.models import model as M
    from repro_torch.runtime.device_pool import cuda_devices
    from repro_torch.runtime.elastic import ElasticTrainer
    from repro_torch.runtime.serving_pool import ServingPool
    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    stub = one_card_orchestrator(["cuda:0"], StubPool(), StubTrainer(), Tracer())
    for op in ONE_CARD_TICKS:
        getattr(stub, op[0])(*op[1:])

    args = build_parser().parse_args([])
    tcfg = TrainConfig()
    train_cfg = reduced_config(get_config("recurrentgemma-2b"))

    def trainer(name):
        return ElasticTrainer(train_cfg, tcfg, global_batch=args.batch, seq_len=args.seq,
                              ckpt_dir=str(out_dir / name), init_device="cpu",
                              data_fn=SyntheticLM(train_cfg, seed=0).data_fn)

    serve_cfg = get_config("recurrentgemma-2b")
    torch.cuda.reset_peak_memory_stats()
    dev = cuda_devices()[0]                    # what DevicePool() takes
    model = M.init_params(serve_cfg, torch.Generator(device=dev).manual_seed(0), dev)
    pool, hpc, tracer = ServingPool(serve_cfg, model), trainer("elastic"), Tracer()
    orch = one_card_orchestrator(None, pool, hpc, tracer)
    prompts = np.random.default_rng(0).integers(0, serve_cfg.vocab_size, (8, 512),
                                                dtype=np.int32)
    ticks, served, started_at, p99, launches = [], [], None, None, {}
    with counted_on_card(launches):
        for i, op in enumerate(ONE_CARD_TICKS):
            t0 = time.perf_counter()
            getattr(orch, op[0])(*op[1:])
            torch.cuda.synchronize()
            ticks.append({"tick": op[0], "args": list(op[2:]), "wall_ms":
                          (time.perf_counter() - t0) * 1e3,
                          "ws": len(orch.devs.groups["ws"]), "hpc": len(orch.devs.groups["hpc"])})
            orch.devs.check()
            orch.svc.check()
            if started_at is None and hpc.state is not None:
                started_at = i
            if op[0] == "start":          # the card is the WS department's
                if [r.device for r in pool.replicas] != [dev] or hpc.state is not None:
                    raise AssertionError("the WS department does not hold the card")
                t0 = time.perf_counter()
                served = [pool.submit(prompts[j:j + 4], 32) for j in (0, 4)]
                ticks[-1]["serve_ms"] = (time.perf_counter() - t0) * 1e3
                lat = sorted(t["prefill_s"] + t["decode_s"] for t in pool.timings)
                p99 = percentile(lat, 99.0)
                orch.observe_latency("ws", p99)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    straight = trainer("straight")
    straight.start([dev])
    for _ in range(2):
        straight.train_steps(2)
    path = out_dir / "orchestrator.trace.jsonl"
    tracer.to_jsonl(str(path))
    rc, out = quiet(trace.main, ["validate", str(path)])
    kinds = serve_cfg.layer_kinds()
    n_attn = sum(k in ("attn", "local") for k in kinds)
    want = train_launches(train_cfg, 4, tcfg.remat != "none")
    want["flash_attention"] += 2 * n_attn
    want["decode_attention"] += 2 * n_attn * 31
    want["rglru_scan"] += 2 * kinds.count("rglru")
    tokens_ok = all(t.shape == (4, 32) and (t >= 0).all() and (t < serve_cfg.vocab_size).all()
                    for t in served)
    record = {"phase": "orchestrator", "policy": "paper", "devices": [str(d) for d in
                                                                      orch.devs.devices],
              "serve": {"arch": serve_cfg.name, "requests": 8, "prompt_len": 512,
                        "max_new": 32, "batch": 4, "tokens_ok": tokens_ok,
                        "timings_ms": [{k: v * 1e3 for k, v in t.items() if k.endswith("_s")}
                                       for t in pool.timings],
                        "p99_latency_s_observed": p99},
              "train": {"arch": train_cfg.name, "batch": [args.batch, args.seq],
                        "started_at_tick": started_at, "resizes": hpc.resizes,
                        "metrics": hpc.metrics_log,
                        "equal_to_uninterrupted": hpc.metrics_log == straight.metrics_log},
              "ticks": ticks, "events": orch.events, "stub_events": stub.events,
              "trace_events": len(tracer.events), "trace_validate_rc": rc,
              "trace_validate": out.strip().splitlines()[-1:],
              "max_memory_allocated_bytes": peak, "launches": launches,
              "expected_launches": want}
    emit(record)
    ok = (orch.events == stub.events and started_at == 2 and hpc.resizes == 1
          and record["train"]["equal_to_uninterrupted"] and len(hpc.metrics_log) == 2
          and rc == 0 and tokens_ok and launches == want and orch.devs.total == 1)
    if not ok:
        raise AssertionError(f"orchestrator phase failed: {record}")
    del orch, pool, model, hpc, straight        # free the weights before later phases
    gc.collect()
    torch.cuda.empty_cache()
    return launches


PORT_KERNELS = (r"flash_(tc|cc)_kernel|flash_bwd_\w+_kernel|decode_split_kernel|"
                r"mlstm_\w+_kernel|rglru_scan(_bwd)?_kernel|slstm_scan(_bwd)?_kernel")
GEMM_KERNELS = r"nvjet|gemm|cutlass|xmma"


def _device_breakdown(torch, prof, wall_s: float, steps: int) -> dict:
    """Kernel time by name from a profiler trace, per step, and the device's
    idle share of the profiled wall time; the port's own kernels are listed
    whatever their rank."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total  # noqa: E731
    busy_ms = sum(us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=us, reverse=True)[:8]
    port = [e for e in kernels if re.search(PORT_KERNELS, e.key)]
    row = lambda e: {"name": e.key[:80], "ms_per_step": us(e) / 1e3 / steps,  # noqa: E731
                     "calls_per_step": e.count / steps}
    return {"wall_ms_per_step": wall_s * 1e3 / steps,
            "device_busy_ms_per_step": busy_ms / steps if kernels else None,
            "idle_share": 1 - busy_ms / (wall_s * 1e3) if kernels else None,
            "kernels_launched_per_step": sum(e.count for e in kernels) / steps,
            "top_kernels": [row(e) for e in top],
            "port_kernels": [row(e) for e in port]}


def profile_serving(torch, model) -> dict:
    """torch.profiler over one prefill and 8 decode steps of the served model
    (batch 4, prompt 512; an embeddings arch takes seeded frames [4, 512, D]
    and then ``decode_inputs``), after the counted main path. Returns the
    decode step's breakdown and the profiled prefill's logits [4, V] (or
    [4, C, V]; on the card)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    from repro_torch.serving.engine import decode_inputs
    cfg, dev = model.cfg, model.device
    S, steps = 512, 8
    if cfg.input_mode == "embeddings":
        tokens = torch.randn(4, S, cfg.d_model, device=dev, generator=torch.Generator(
            device=dev).manual_seed(1)).to(model.compute_dtype)
        step_in = decode_inputs(cfg, 4, device=dev)
        next_in = lambda tok: step_in  # noqa: E731
    else:
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (4, S))).to(dev)
        next_in = lambda tok: tok[:, None]  # noqa: E731
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
        prefill_logits = logits
        tok = logits.argmax(-1)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, caches = M.decode_step(model, caches, next_in(tok), S + i)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
        decode = _device_breakdown(torch, prof, decode_s, steps)
    emit({"phase": "profile", "arch": model.cfg.name, "note": "profiler on: wall "
          "times include its recording overhead", "prefill": prefill,
          "decode_step": decode})
    return {"decode_step": decode, "prefill_logits": prefill_logits}


def moe_decode_split(torch, model, peak, decode: dict, serve_ms_per_step: float) -> None:
    """Where a decode step's MoE time goes in the served MoE model (batch 4,
    one token a row): the router and the dispatch, the expert products and
    the combine of each layer, over every layer in turn (so each layer's
    experts come from HBM, as in a step), times the layers: device time
    (``torch.profiler``'s kernel time) and CUDA-event time of calls made one
    by one from the host (launch gaps included); beside the profiled step's
    device busy and wall time
    (``decode``), the unprofiled serve's ms a step, the expert products'
    weight-read bound and the whole step's (every weight but the embedding
    table read once). Also: one layer's MoE on a prefill-sized input
    ([4, 512], where pairs drop) gives the same bits on a second call."""
    from repro_torch.models import moe
    layers = [b.moe for b in model.layers]
    m, n = layers[0].m, len(layers)
    D = model.cfg.d_model
    gen = torch.Generator(device=model.device).manual_seed(5)
    xf = torch.randn(1, 4, D, generator=gen, device=model.device).to(model.compute_dtype)
    cap = moe.capacity(4, m)

    def route_dispatch(layer):
        _, _, top_p, top_i = layer.route(xf)
        return moe.dispatch(xf, top_p, top_i, m.num_experts, cap)

    def device_ms(fn, inputs):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for args in inputs:
                fn(*args)
            torch.cuda.synchronize()
        return _device_breakdown(torch, prof, time.perf_counter() - t0,
                                 len(inputs))["device_busy_ms_per_step"]

    with torch.inference_mode():
        staged = [route_dispatch(layer) for layer in layers]
        outs = [layer.experts(buf) for layer, (buf, _) in zip(layers, staged)]
        pieces = {
            "router_and_dispatch": (route_dispatch, [(layer,) for layer in layers]),
            "expert_products": (lambda layer, buf: layer.experts(buf),
                                [(layer, buf) for layer, (buf, _) in zip(layers, staged)]),
            "combine": (lambda yb, coords: moe.combine(yb, coords, m.top_k),
                        [(yb, coords) for yb, (_, coords) in zip(outs, staged)]),
            "whole_moe_layer": (lambda layer: layer(xf.view(4, 1, D), groups=1,
                                                    with_aux=False),
                                [(layer,) for layer in layers])}
        event = {k: time_ms(torch, fn, inputs, iters=n) for k, (fn, inputs) in pieces.items()}
        device = {k: device_ms(fn, inputs) for k, (fn, inputs) in pieces.items()}
        x = torch.randn(4, 512, D, generator=gen, device=model.device).to(model.compute_dtype)
        first, _ = layers[0](x, groups=1, with_aux=False)
        second, _ = layers[0](x, groups=1, with_aux=False)
        bit_equal = torch.equal(first, second)
    per_step = {k: v * n for k, v in device.items()}
    expert_bytes = sum(w.numel() * w.element_size() for layer in layers
                       for w in (layer.wi_gate, layer.wi_up, layer.wo))
    weight_bytes = sum(p.numel() * p.element_size() for name, p in model.named_parameters()
                       if name != "embed.table")
    busy = decode["device_busy_ms_per_step"]
    emit({"phase": "moe_decode_split", "arch": model.cfg.name, "layers": n,
          "tokens": 4, "capacity": cap, "device_ms_per_call": device,
          "event_ms_per_call_one_by_one": event, "device_ms_per_step": per_step,
          "share_of_device_busy": {k: v / busy for k, v in per_step.items()},
          "profiled_step_device_busy_ms": busy,
          "profiled_step_wall_ms": decode["wall_ms_per_step"],
          "serve_decode_ms_per_step": serve_ms_per_step,
          "expert_weight_bytes_per_step": expert_bytes,
          "expert_products_bound_ms": expert_bytes / peak[1] * 1e3,
          "weight_bytes_per_step": weight_bytes,
          "step_weight_read_bound_ms": weight_bytes / peak[1] * 1e3,
          "prefill_sized_moe_second_call_bit_equal": bit_equal})
    if not bit_equal:
        raise AssertionError("the MoE gave other bits on a second call")


SAMPLER_CONFIGS = (dict(greedy=True), dict(), dict(temperature=0.7), dict(top_k=50),
                   dict(top_p=0.9), dict(temperature=1.3, top_k=40, top_p=0.8))


def sampler_on_card(torch, logits, arch: str) -> None:
    """The port's sampler on one served round's logits (the prefill's, on
    the card): ``filter_logits`` gives the CPU's bits, and ``sample`` with
    the same Gumbel noise (drawn on the CPU) the CPU's tokens; a draw from a
    card generator gives in-vocabulary tokens."""
    from repro_torch.serving.sampler import SamplerConfig, filter_logits, gumbel, sample
    cpu = logits.cpu()
    noise = gumbel(cpu.shape, torch.Generator().manual_seed(0))
    rows, ok = [], True
    for kw in SAMPLER_CONFIGS:
        cfg = SamplerConfig(**kw)
        same_bits = torch.equal(filter_logits(logits, cfg).cpu(), filter_logits(cpu, cfg))
        card = sample(logits, None, cfg, noise=noise.to(logits.device)).cpu()
        want = sample(cpu, None, cfg, noise=noise)
        drawn = sample(logits, torch.Generator(device=logits.device).manual_seed(1), cfg)
        rows.append({"config": kw, "filtered_bits_equal": same_bits,
                     "tokens": card.tolist(), "tokens_equal_cpu": torch.equal(card, want),
                     "card_generator_tokens": drawn.tolist()})
        ok = ok and same_bits and torch.equal(card, want) and bool(
            ((drawn >= 0) & (drawn < logits.shape[-1])).all())
    emit({"phase": "sampler", "arch": arch, "logits": list(logits.shape), "configs": rows})
    if not ok:
        raise AssertionError(f"the sampler on the card disagrees with the CPU: {rows}")


def time_xlstm_blocks(torch, pool):
    """Host wall ms (after a synchronize) of one mLSTM and one sLSTM block of
    the served model: prefill of [4, 512] and one decode step."""
    model = pool.replicas[0].model
    x = torch.randn(4, 512, model.cfg.d_model, device=model.device).to(model.compute_dtype)
    out = {}
    with torch.inference_mode():
        for kind in ("mlstm", "slstm"):
            block = next(b for b in model.layers if b.kind == kind)
            block.prefill(x, 0)                                     # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache = block.prefill(x, 0)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            block.decode(x[:, -1:], cache, 512)
            torch.cuda.synchronize()
            out[kind] = {"prefill_ms": (t1 - t0) * 1e3,
                         "decode_step_ms": (time.perf_counter() - t1) * 1e3}
    emit({"phase": "xlstm_blocks", "shape": list(x.shape), **out})


# ------------------------------------------------------------ campaign phase

QUEUE_EXACT = [0, 1, 2, 3, 5, 7]       # FOLD_COLS but the two sums (mean, mean wait)
QUEUE_SUMS = [4, 6]


def queue_sets():
    """The queue-core check sets, from seeds: random piecewise and constant
    jobs, the edges of the CPU tests, the 192-job piecewise set (as
    ``benchmarks/paper_figs.py:238-253`` builds it) and the dedicated-node
    constant set (the small grid's three traces at 8, 12 and 16 nodes, as
    ``paper_figs.py`` builds it), and ``wide_long_jobs``."""
    import numpy as np
    from repro_torch.core.types import SLOConfig
    from repro_torch.serving.batching import ServiceTimeModel
    from repro_torch.workloads import QueueJob, RequestTrace, make_trace
    model, slo30 = ServiceTimeModel(), SLOConfig(latency_target_s=30.0)
    kinds = ("poisson", "mmpp", "diurnal", "flash_crowd")

    def cut(tr, n):
        return RequestTrace(tr.t[:n], tr.prompt_tokens[:n], tr.decode_tokens[:n], tr.kind)

    random_jobs = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        for i in range(8):
            rate = float(rng.uniform(0.4, 3.0)) * (0.1 if i % 4 == 3 else 1.0)
            tr = make_trace(kinds[i % 4], rate, 1800.0, seed + i)
            if i % 3 == 2:
                ev = [(0.0, int(rng.integers(0, 8)))]
            else:
                ev = [(0.0, int(rng.integers(0, 10)))]
                for _ in range(int(rng.integers(0, 12))):
                    ev.append((float(rng.uniform(0.0, 1800.0)), int(rng.integers(0, 10))))
            random_jobs.append(QueueJob(tr, ev, model, slo30, 1800.0))
    tr = make_trace("poisson", 1.0, 600.0, 0)
    edges = [(tr, [(0.0, 0)], 600.0), (tr, [(0.0, 0), (300.0, 1), (450.0, 0), (500.0, 2)], 550.0),
             (tr, [(0.0, 5), (100.0, 1)], 600.0), (tr, [(0.0, 2), (200.0, 0), (400.0, 2)], 600.0),
             (tr, [(0.0, 1), (590.0, 8)], 595.0), (tr, [(0.0, 1), (200.0, 3)], 300.0),
             (tr, [(0.0, 1), (200.0, 3)], None),
             (tr, [(50.0 * i, (i * 5) % 13) for i in range(12)], 600.0),    # e_pad 16, k_pad 48
             (tr, [(0.0, 12), (300.0, 2)], 600.0), (tr, [(0.0, 0)], 300.0),
             (tr, [(0.0, 1)], 600.0), (tr, [(0.0, 50)], None),
             (cut(make_trace("poisson", 1.0, 600.0, 1), 1), [(0.0, 1), (5.0, 2)], 600.0),
             (cut(make_trace("poisson", 1.0, 600.0, 1), 1), [(0.0, 1)], 600.0)]
    for n in (256, 257, 384):
        big = cut(make_trace("mmpp", 2.0, 1800.0, n), n)
        edges += [(big, [(0.0, 1), (600.0, 2), (900.0, 0), (1000.0, 3)], 1800.0),
                  (big, [(0.0, 2)], 1800.0)]
    edge_jobs = [QueueJob(t, ev, model, slo30, hz) for t, ev, hz in edges]
    rng = np.random.default_rng(7)
    pw192 = []
    for seed in range(192):
        tr = make_trace(kinds[seed % 4], float(rng.uniform(0.1, 0.5)), 7200.0, 500 + seed)
        ev = [(0.0, int(rng.integers(1, 5)))]
        for _ in range(int(rng.integers(5, 21))):
            ev.append((float(rng.uniform(0.0, 7200.0)), int(rng.integers(0, 5))))
        pw192.append(QueueJob(tr, tuple(ev), model, slo30, horizon=7200.0))
    dedicated = [QueueJob(make_trace(a, 2.0, 7200.0, 0), [(0.0, nodes)], model, slo30, 7200.0)
                 for a in ("poisson", "mmpp", "flash_crowd") for nodes in (8, 12, 16)]
    return {"random": random_jobs, "edges": edge_jobs, "piecewise_192": pw192,
            "dedicated_8_12_16": dedicated, "wide_long": wide_long_jobs(),
            "many_intervals": many_interval_jobs()}


MANY_INTERVALS = (33, 40, 64, 100)


def many_interval_jobs():
    """Piecewise jobs with more capacity intervals than a warp holds (33, 40,
    64 and 100), so the kernel's cursor and its later windows run: intervals
    of a few seconds to a minute that end while requests wait (the cursor
    moves past them), closed ones (0 nodes), a run of 34 closed in a row
    mid-schedule (the search goes on past the window once, then the cursor
    jumps), a horizon inside the trace, and a schedule whose last 34
    intervals are closed, from about 900 s of an 1,800 s horizon (every
    later request searches every window, is unserved and drains the slots).
    At most 8 nodes of 4 slots (K <= 32), so one flush's tables run on every
    instance."""
    import numpy as np
    from repro_torch.core.types import SLOConfig
    from repro_torch.serving.batching import ServiceTimeModel
    from repro_torch.workloads import QueueJob, make_trace
    model, slo30 = ServiceTimeModel(), SLOConfig(latency_target_s=30.0)
    rng = np.random.default_rng(13)
    jobs = []
    for i, E in enumerate(MANY_INTERVALS):
        end = 1400 if i == 3 else 1800
        times = np.sort(rng.choice(np.arange(1, end), E - 1, replace=False))
        nodes = rng.integers(0, 9, E)
        if i == 2:
            nodes[E // 2 - 17:E // 2 + 17] = 0
        if i == 3:
            nodes[E - 34:] = 0
        ev = [(0.0, int(nodes[0]))] + [(float(t), int(k)) for t, k in zip(times, nodes[1:])]
        jobs.append(QueueJob(make_trace(("mmpp", "poisson", "diurnal", "flash_crowd")[i],
                                        (2.5, 2.5, 2.5, 0.5)[i], 1800.0, 970 + i), ev, model,
                             slo30, 1500.0 if i == 1 else 1800.0))
    return jobs


def wide_long_jobs():
    """Jobs as wide and long as the ``full`` grid's, and more: 7.7k-28k
    requests (n_pad 8192-32768) over 7200 s, piecewise capacity of 68-120
    slots a level with zero and low levels between (queues that build up
    and drain), one schedule up to 480 slots whose closed interval runs
    past its horizon (the heap drain), a horizon before the trace's end,
    and constant 68 and 120 slots."""
    import numpy as np
    from repro_torch.core.types import SLOConfig
    from repro_torch.serving.batching import ServiceTimeModel
    from repro_torch.workloads import QueueJob, make_trace
    model, slo30 = ServiceTimeModel(), SLOConfig(latency_target_s=30.0)
    rng = np.random.default_rng(11)
    jobs = []
    fixed = [(0.0, 120), (900.0, 6), (1800.0, 0), (2100.0, 90), (3600.0, 2), (4500.0, 72),
             (6000.0, 0), (6300.0, 100)]
    for i, kind in enumerate(("mmpp", "diurnal", "flash_crowd", "poisson")):
        ev = fixed if i == 0 else [(0.0, int(rng.integers(17, 31)))]
        for _ in range(0 if i == 0 else int(rng.integers(10, 31))):
            ev.append((float(rng.uniform(0.0, 7200.0)), int(rng.integers(0, 31))))
        jobs.append(QueueJob(make_trace(kind, 2.2, 7200.0, 900 + i), ev, model, slo30,
                             (6200.0, 7200.0, 5000.0, 7200.0)[i]))
    for nodes in (17, 30):
        jobs.append(QueueJob(make_trace("mmpp", 2.2, 7200.0, 950 + nodes), [(0.0, nodes)],
                             model, slo30, 7200.0))
    return jobs


def assert_golden(m, ref, ctx, rtol=3e-4, atol=2e-3):
    """float32 batched metrics vs the float64 oracle, as
    ``tests/test_queueing_equivalence.py:48`` states the tolerance (a few
    served/unserved flips at window and horizon edges; after a flip only the
    count is compared)."""
    import math
    if m.n_requests != ref.n_requests or abs(m.unserved - ref.unserved) > max(
            2, int(0.002 * max(ref.n_requests, 1))):
        raise AssertionError(f"{ctx}: counts {m} vs {ref}")
    if m.unserved != ref.unserved:
        return
    for f in ("p50_s", "p95_s", "p99_s", "mean_s", "max_s", "mean_wait_s", "violation_rate"):
        a, b = getattr(m, f), getattr(ref, f)
        if not ((math.isinf(a) and math.isinf(b)) or abs(a - b) <= atol + rtol * abs(b)):
            raise AssertionError(f"{ctx}: {f} {a} vs oracle {b}")


def tier_jobs(K, horizon=600.0):
    """Jobs at exactly K slots (one slot a replica): a piecewise schedule
    that reaches K between lower levels, constant K, and a small job beside
    them; K at a register tier's edge, or >= 513 for the shared-memory
    instance."""
    from repro_torch.core.types import SLOConfig
    from repro_torch.serving.batching import ServiceTimeModel
    from repro_torch.workloads import QueueJob, make_trace
    model, slo30 = ServiceTimeModel(max_batch=1), SLOConfig(latency_target_s=30.0)
    tr = make_trace("mmpp", 3.0, horizon, K)
    return [QueueJob(tr, [(0.0, max(K // 3, 1)), (horizon / 6, K), (horizon / 2, 2),
                          (2 * horizon / 3, K)], model, slo30, horizon),
            QueueJob(tr, [(0.0, K)], model, slo30, horizon),
            QueueJob(make_trace("poisson", 1.0, horizon, K + 1), [(0.0, 3), (horizon / 3, 1)],
                     model, slo30, 0.8 * horizon)]


TIER_EDGES = (32, 33, 64, 65, 128, 129, 256, 257, 512, 513, 600)
INSTANCE_K_MAX = (32, 64, 128, 256, 512, 600)      # k_max that picks each instance


def flush_tensors(torch, jobs, dev):
    """(flat tables of one flush of ``jobs`` on ``dev``, k_max)."""
    from repro_torch.workloads import queueing as Q
    caps = Q._job_caps(jobs)
    buf, spans, k_max = Q.flush_inputs(jobs, [i for i, c in enumerate(caps) if c is not None],
                                       caps)
    return Q.flush_tensors(buf.to(dev), spans), k_max


def hold_rows(torch, got, want, what) -> tuple:
    """Kernel rows against plain rows: every column but the two sums
    bit-equal, the sums within 1e-5 relative. Returns (max abs error over
    the finite entries, the sums' max relative error)."""
    got, want = got.cpu(), want.cpu()
    if not torch.equal(got[:, QUEUE_EXACT], want[:, QUEUE_EXACT]):
        raise AssertionError(f"queue_flush {what}: {got} vs plain {want}")
    rel = ((got[:, QUEUE_SUMS] - want[:, QUEUE_SUMS]).abs()
           / want[:, QUEUE_SUMS].abs().clamp(min=1e-30)).max().item()
    if not rel <= 1e-5:
        raise AssertionError(f"queue_flush {what}: sums off by {rel}")
    fin = torch.isfinite(want)
    return (got[fin] - want[fin]).abs().max().item(), rel


def check_queue(torch, dev):
    """The flat kernel (one launch a set) against its plain version on the
    CPU (the same float32 arithmetic) on every check set and at each register
    tier's edges and the shared-memory instance (K 513 and 600); the jobs of
    33 to 100 intervals on every instance; the card's
    metrics against the float64 oracle under the golden tolerance; a job's
    metrics alone and co-launched, on the card, the same bits; and the
    bucket form (the JAX package's shape buckets packed into the flat form)
    on the edges."""
    from repro_torch.kernels.queue_core import ops
    from repro_torch.kernels.queue_core.ref import queue_core_reference, queue_flush_reference
    from repro_torch.workloads import queueing as Q
    worst = 0.0
    sets = {**queue_sets(), **{f"K {k}": tier_jobs(k) for k in TIER_EDGES}}
    for name, jobs in sets.items():
        args, k_max = flush_tensors(torch, jobs, dev)
        before = ops.queue_flush.launches
        got = ops.queue_flush(*args, k_max)
        launched = ops.queue_flush.launches - before
        err, rel = hold_rows(torch, got, queue_flush_reference(*(a.cpu() for a in args)), name)
        worst = max(worst, err)
        if not name.startswith("K "):
            card = Q.simulate_queue_batch(jobs, device=dev)
            for i, (job, m) in enumerate(zip(jobs, card)):
                ref = Q.simulate_queue(job.trace, job.capacity_events, job.model, job.slo,
                                       horizon=job.horizon)
                assert_golden(m, ref, f"{name} job {i}")
        emit({"phase": "check", "kernel": "queue_core", "set": name, "jobs": len(jobs),
              "requests": sum(len(j.trace) for j in jobs), "k_max": k_max,
              "instance": ops.INSTANCES[ops.slot_registers(k_max)], "launches": launched,
              "exact_columns_bit_equal": True, "sums_max_rel_err": rel, "tol": 1e-5,
              "oracle_golden_tolerance": not name.startswith("K ")})
        if launched != 1:
            raise AssertionError(f"queue_flush {name}: {launched} launches for one flush")
    args, k_max = flush_tensors(torch, sets["many_intervals"], dev)
    off = args[7].cpu()
    if int((off[1:] - off[:-1]).min()) <= 32 or k_max > 32:
        raise AssertionError("many_intervals: every job needs > 32 intervals, K <= 32")
    want, rows = queue_flush_reference(*(a.cpu() for a in args)), {}
    for k in INSTANCE_K_MAX:                    # the cursor and later windows, every instance
        name = ops.INSTANCES[ops.slot_registers(k)]
        rows[name] = ops.queue_flush(*args, k)
        worst = max(worst, hold_rows(torch, rows[name], want, f"many_intervals, {name}")[0])
    if not all(torch.equal(r, rows["registers_1"]) for r in rows.values()):
        raise AssertionError("queue_core: many_intervals rows differ between instances")
    emit({"phase": "check", "kernel": "queue_core", "set": "many_intervals",
          "intervals": MANY_INTERVALS, "instances": sorted(rows),
          "exact_columns_bit_equal": True, "rows_bit_identical_across_instances": True})
    jobs = sets["random"][:8] + sets["edges"][:6]
    grouped = Q.simulate_queue_batch(jobs, device=dev)
    if any(Q.simulate_queue_batch([j], device=dev)[0] != m for j, m in zip(jobs, grouped)):
        raise AssertionError("queue_core: a job's metrics depend on its flush")
    alone, k_alone = flush_tensors(torch, sets["edges"], dev)
    beside, k_beside = flush_tensors(torch, sets["edges"] + tier_jobs(600)[:1], dev)
    rows = ops.queue_flush(*alone, k_alone)
    if not torch.equal(rows, ops.queue_flush(*beside, k_beside)[:rows.shape[0]]):
        raise AssertionError("queue_core: a job's row depends on the kernel instance")
    emit({"phase": "check", "kernel": "queue_core", "case": "composition independence",
          "jobs": len(jobs), "bit_identical": True,
          "register_vs_shared_memory_instance_bit_identical": True})
    buckets, caps = Q._plan(sets["edges"])
    for key, rows in sorted(buckets.items()):
        kind, *arrays, k_pad = Q.bucket_inputs(sets["edges"], key, rows, caps)
        got = ops.queue_core(kind, *(torch.from_numpy(a).to(dev) for a in arrays), k_pad)
        want = queue_core_reference(kind, *(torch.from_numpy(a) for a in arrays), k_pad)
        worst = max(worst, hold_rows(torch, got, want, f"bucket form {key}")[0])
    emit({"phase": "check", "kernel": "queue_core", "case": "bucket form", "set": "edges",
          "buckets": len(buckets), "exact_columns_bit_equal": True})
    return worst


def forbid_plain_queue():
    """Make both plain queue versions raise; returns the function that
    restores them."""
    from repro_torch.kernels.queue_core import ops
    saved = ops.queue_flush_reference, ops.queue_core_reference

    def plain_forbidden(*args, **kwargs):
        raise AssertionError("the plain queue core ran on the main path")

    ops.queue_flush_reference = ops.queue_core_reference = plain_forbidden

    def restore():
        ops.queue_flush_reference, ops.queue_core_reference = saved
    return restore


def campaign_traced(torch, out_dir: Path):
    """``python -m repro_torch.workloads.campaign --grid mix_tiny --trace DIR``
    on the card (its defaults), the launch count zeroed just before and the
    plain queue versions raising until it ends: the traces must equal the
    goldens byte for byte, the kernel must have launched once a chunk (one
    flush), and the rows must agree with the same call's ``--device cpu``
    run (deterministic columns equal, queue columns within the golden
    tolerance). Returns the launch count."""
    from repro_torch.kernels.queue_core import ops
    from repro_torch.workloads import campaign as C
    trace_dir, out = out_dir / "traces", out_dir / "mix_tiny.json"
    restore = forbid_plain_queue()
    ops.reset_launches()
    try:
        t0 = time.perf_counter()
        rc = C.main(["--grid", "mix_tiny", "--trace", str(trace_dir), "--out", str(out)])
        wall = time.perf_counter() - t0
    finally:
        launches = ops.queue_flush.launches
        restore()
    golden = ROOT / "goldens" / "mix_tiny_traces"
    names = sorted(p.name for p in golden.glob("*.trace.jsonl"))
    same = [n for n in names if (trace_dir / n).is_file()
            and (trace_dir / n).read_bytes() == (golden / n).read_bytes()]
    want = -(-len(C.make_grid("mix_tiny")) // C.QUEUE_CHUNK)
    card = json.loads(out.read_text())
    cpu_out = out_dir / "mix_tiny_cpu.json"
    C.main(["--grid", "mix_tiny", "--device", "cpu", "--out", str(cpu_out)])
    cpu = json.loads(cpu_out.read_text())
    queue_keys = ("ws_p50_s", "ws_p95_s", "ws_p99_s", "ws_violation_rate")
    diffs = []
    for a, b in zip(card["cells"], cpu["cells"]):
        for k in C.REDUCE_KEYS:
            x, y = a["metrics"][k], b["metrics"][k]
            if k in queue_keys:
                ok = abs(x - y) <= 2e-3 + 3e-4 * abs(y)
            elif k == "ws_unserved":
                ok = abs(x - y) <= max(2, 0.002 * a["ws_requests"])
            else:
                ok = x == y
            if not ok:
                diffs.append((a["cell_id"], k, x, y))
    emit({"phase": "campaign_traced", "grid": "mix_tiny", "cells": card["n_cells"],
          "exit_code": rc, "wall_s": wall, "traces_equal_goldens": f"{len(same)}/{len(names)}",
          "launches": launches, "launches_expected": want,
          "queue_impls": card["throughput"]["queue_impls"],
          "rows_agree_with_cpu_run": not diffs})
    if rc != 0 or len(same) != len(names) or len(names) != 7:
        raise AssertionError(f"mix_tiny traces on the card differ from the goldens: {same}")
    if launches != want or card["throughput"]["queue_impls"] != {"cuda_batched": 14}:
        raise AssertionError(f"queue_flush launches {launches} != {want}")
    if diffs:
        raise AssertionError(f"card and CPU campaign rows disagree: {diffs[:5]}")
    return launches


def flush_shape(torch, args) -> dict:
    """Jobs, requests and the longest job's requests of a flush's tables."""
    off = args[3].cpu()
    n = off[1:] - off[:-1]
    return {"jobs": int(n.numel()), "requests": int(n.sum()), "longest_job": int(n.max())}


def campaign_full_shard(torch, out_dir: Path):
    """``--grid full --shard 0/252`` on the card (24 cells, 3 chunks), the
    launch count zeroed just before and the plain queue versions raising
    until it ends: cells/s and queue requests/s from the artifact, each
    flush's host wall time against its device time (CUDA events around its
    one launch), its ms and ns a request of its longest job (the chain).
    Returns (launches, the first flush's tables, its k_max)."""
    from repro_torch.kernels.queue_core import ops
    from repro_torch.workloads import campaign as C, queueing as Q
    flushes, launches_in = [], []
    real_flush, real_batch = Q.queue_flush, C.simulate_queue_batch

    def timed_flush(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_flush(*args, **kw)
        end.record()
        launches_in.append((args, start, end))
        return out

    def timed_batch(jobs, **kw):
        first = len(launches_in)
        t0 = time.perf_counter()
        res = real_batch(jobs, **kw)
        flushes.append((time.perf_counter() - t0, first, len(launches_in)))
        return res

    Q.queue_flush, C.simulate_queue_batch = timed_flush, timed_batch
    restore = forbid_plain_queue()
    ops.reset_launches()
    out = out_dir / "full_shard.json"
    try:
        t0 = time.perf_counter()
        rc = C.main(["--grid", "full", "--shard", "0/252", "--out", str(out)])
        wall = time.perf_counter() - t0
    finally:
        Q.queue_flush, C.simulate_queue_batch = real_flush, real_batch
        launches = ops.queue_flush.launches
        restore()
    torch.cuda.synchronize()
    art = json.loads(out.read_text())
    tp = art["throughput"]
    flush_rows = []
    for w, a, b in flushes:
        ms = sum(start.elapsed_time(end) for _, start, end in launches_in[a:b])
        shape = flush_shape(torch, launches_in[a][0])
        flush_rows.append({"wall_ms": w * 1e3, "device_ms": ms, "launches": b - a, **shape,
                           "k_max": launches_in[a][0][-1],
                           "ns_per_request_longest": ms * 1e6 / shape["longest_job"]})
    sim_s = sum(r["metrics"]["wall_s"] for r in art["cells"]) - tp["queue_sim_s"]
    emit({"phase": "campaign_full", "grid": "full", "shard": "0/252", "exit_code": rc,
          "cells": art["n_cells"], "wall_s": wall, "run_wall_s": tp["run_wall_s"],
          "cells_per_s": tp["cells_per_s"], "queue_requests": tp["queue_requests"],
          "queue_sim_s": tp["queue_sim_s"], "queue_requests_per_s": tp["queue_requests_per_s"],
          "host_sim_s": sim_s, "queue_impls": tp["queue_impls"], "launches": launches,
          "flushes": flush_rows, "inf_rate": art["reductions"]["overall"]["inf_rate"]})
    if rc != 0 or art["n_cells"] != 24 or launches != len(flushes) or len(flushes) != 3 or \
            any(r["launches"] != 1 for r in flush_rows) or \
            set(tp["queue_impls"]) != {"cuda_batched"}:
        raise AssertionError(f"full shard on the card: rc {rc}, {art['n_cells']} cells, "
                             f"{launches} launches in {len(flushes)} flushes, "
                             f"{tp['queue_impls']}")
    first = launches_in[flushes[0][1]][0]
    return launches, list(first[:-1]), first[-1]


def quiet(fn, argv) -> tuple:
    """(exit code, standard output) of ``fn(argv)`` with its output caught."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn([str(a) for a in argv])
    return rc, buf.getvalue()


def control_plane_tools(out_dir: Path, card_traces: Path) -> dict:
    """The port's control-plane tools on the card's machine, none of the JAX
    package: ``repro_torch.trace`` gates the card's ``mix_tiny`` traces
    (``regress`` against the goldens; ``validate``, ``replay`` and
    ``bisect`` against its golden on each); ``--grid full --shard 0/252
    --trace`` on the card (a run of its own, so ``campaign_full``'s flush
    timings stay as they were) with its 24 traces validated and replayed;
    ``repro_torch.examples.sharded_campaign`` on the card (four
    ``run_campaign`` calls: ``queue_flush`` must launch once for each
    ``QUEUE_CHUNK`` of the cells each call executes); and
    ``repro_torch.examples.consolidation_sim --ws timeseries`` (host work:
    every paper claim must hold). The plain queue versions raise while the
    two campaigns run. Returns the launches by run."""
    from repro_torch import trace
    from repro_torch.examples import consolidation_sim, sharded_campaign
    from repro_torch.kernels.queue_core import ops
    from repro_torch.workloads import campaign as C
    golden = ROOT / "goldens" / "mix_tiny_traces"
    failed, cli_calls = [], []

    def gate(what, argv):
        rc, out = quiet(trace.main, argv)
        cli_calls.append(what)
        if rc != 0:
            failed.append((what, rc, out[-2000:]))

    names = sorted(p.name for p in golden.glob("*.trace.jsonl"))
    t0 = time.perf_counter()
    gate("regress mix_tiny", ["regress", golden, card_traces])
    for n in names:
        for cmd in ("validate", "replay"):
            gate(f"{cmd} {n}", [cmd, card_traces / n])
        gate(f"bisect {n}", ["bisect", golden / n, card_traces / n])
    mix_tiny_s, mix_tiny_calls = time.perf_counter() - t0, len(cli_calls)

    full_traces, full_out = out_dir / "full_traces", out_dir / "full_shard_traced.json"
    restore = forbid_plain_queue()
    ops.reset_launches()
    try:
        t0 = time.perf_counter()
        full_rc = C.main(["--grid", "full", "--shard", "0/252", "--trace",
                          str(full_traces), "--out", str(full_out)])
        full_wall = time.perf_counter() - t0
    finally:
        full_launches = ops.queue_flush.launches
        restore()
    full_cells = len(C.shard_cells(C.make_grid("full"), "0/252"))
    full_want = -(-full_cells // C.QUEUE_CHUNK)
    traces = sorted(full_traces.glob("*.trace.jsonl"))
    if full_rc != 0 or len(traces) != full_cells or full_launches != full_want:
        failed.append(("full shard traced", full_rc, len(traces), full_launches, full_want))
    t0 = time.perf_counter()
    for p in traces:
        for cmd in ("validate", "replay"):
            gate(f"{cmd} {p.name}", [cmd, p])
    full_cli_s = time.perf_counter() - t0

    cells = C.make_grid("mix_tiny")
    half = C.shard_cells(cells, "1/2")
    executed_want = [len(C.shard_cells(cells, "0/2")), len(half) // 2,
                     len(half) - len(half) // 2, len(cells)]
    by_call_want = [(n, -(-n // C.QUEUE_CHUNK)) for n in executed_want]
    sharded_want = sum(n for _, n in by_call_want)
    calls, real_run = [], sharded_campaign.run_campaign

    def counted_run(*args, **kw):
        before = ops.queue_flush.launches
        art = real_run(*args, **kw)
        calls.append((art["throughput"]["executed"], ops.queue_flush.launches - before))
        return art

    sharded_campaign.run_campaign = counted_run
    restore = forbid_plain_queue()
    ops.reset_launches()
    try:
        t0 = time.perf_counter()
        rc, _ = quiet(sharded_campaign.main, ["--grid", "mix_tiny", "--workers", "1"])
        sharded_wall = time.perf_counter() - t0
    finally:
        sharded_launches = ops.queue_flush.launches
        sharded_campaign.run_campaign = real_run
        restore()
    if rc != 0 or sharded_launches != sharded_want or calls != by_call_want:
        failed.append(("sharded_campaign", rc, calls, sharded_launches, sharded_want))

    t0 = time.perf_counter()
    rc, out = quiet(consolidation_sim.main, ["--ws", "timeseries"])
    sim_wall = time.perf_counter() - t0
    line = [ln for ln in out.splitlines() if ln.startswith("paper-claim validation:")]
    claims = ast.literal_eval(line[0].split(":", 1)[1].strip()) if line else {}
    held = {k: v for k, v in claims.items() if k != "cost_ratio_at_160"}
    if rc != 0 or len(held) != 4 or not all(v is True for v in held.values()):
        failed.append(("consolidation_sim", rc, claims))

    emit({"phase": "control_plane_tools",
          "mix_tiny_card_traces": {"traces": len(names), "cli_calls": mix_tiny_calls,
                                   "cli_wall_s": mix_tiny_s},
          "full_shard_traced": {"shard": "0/252", "cells": full_cells, "exit_code": full_rc,
                                "wall_s": full_wall, "launches": full_launches,
                                "launches_expected": full_want, "traces": len(traces),
                                "cli_calls": len(cli_calls) - mix_tiny_calls,
                                "validate_replay_cli_wall_s": full_cli_s},
          "sharded_campaign": {"grid": "mix_tiny", "workers": 1, "wall_s": sharded_wall,
                               "executed_and_launches_by_call": calls,
                               "launches": sharded_launches,
                               "launches_expected": sharded_want},
          "consolidation_sim": {"argv": ["--ws", "timeseries"], "wall_s": sim_wall,
                                "paper_claims": claims},
          "failed": [str(f) for f in failed]})
    if failed:
        raise AssertionError(f"control-plane tools failed: {failed[:5]}")
    return {"full, shard 0/252, traced": full_launches,
            "sharded_campaign example (mix_tiny)": sharded_launches}


def queue_bytes(args) -> int:
    """Bytes the queue core must move: t and s once for each request (8 B),
    the capacity tables (12 B an interval), the job tables (kind, offsets,
    horizon, SLO: 20 B a job) and the [J, 8] float32 result."""
    J, N, E = args[0].numel(), args[1].numel(), args[4].numel()
    return 8 * N + 12 * E + 20 * J + 32 * J


def sm_clock_mhz(torch, fn, seconds: float = 2.0) -> list:
    """The SM clock (MHz) that ``nvidia-smi`` reads every 100 ms while ``fn``
    runs back to back for ``seconds``."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.5)
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    return [float(x) for x in out.split() if re.fullmatch(r"\d+(\.\d+)?", x)]


def measure_queue(torch, peak, name, args, k_max) -> dict:
    """Device time of one flush (one launch) against the plain version's on
    the same tables on the card: the kernel as one CUDA graph of 20 flushes
    in 7 turns (``time_interleaved``), the plain version (a Python loop over
    requests; not capturable) once, and the kernel's rows held against the
    plain run's (every column but the two sums bit-equal, the sums within
    1e-5 relative). Bounds: bytes over HBM rate (``bound_ms``), and the chain
    -- the longest job x 8 cycles (one dependent fmaxf and one __fadd_rn) at
    the SM clock read while the flush runs -- which is what binds."""
    from repro_torch.kernels.queue_core import ops
    from repro_torch.kernels.queue_core.ref import queue_flush_reference

    def flush(*_):
        ops.queue_flush(*args, k_max)

    turns = time_interleaved(torch, {"kernel": flush}, [()])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            flush()
    clocks = sm_clock_mhz(torch, graph.replay)
    if not clocks:
        raise AssertionError("nvidia-smi read no SM clock")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = queue_flush_reference(*args)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    worst, max_rel = hold_rows(torch, ops.queue_flush(*args, k_max), want, name)
    shape = flush_shape(torch, args)
    clock = sorted(clocks)[len(clocks) // 2]
    ms = turns["kernel"]["median"]
    chain_ms = shape["longest_job"] * 8 / (clock * 1e6) * 1e3
    emit({"phase": "check", "kernel": "queue_core", "set": name, **shape, "k_max": k_max,
          "instance": ops.INSTANCES[ops.slot_registers(k_max)],
          "exact_columns_bit_equal": True, "sums_max_rel_err": max_rel, "tol": 1e-5})
    figures = measured(ms, plain, None, 0, queue_bytes(args), peak[2], peak[1])
    return {**figures, "max_abs_err": worst, "min_max_ms": turns["kernel"]["min_max"],
            "eager_ms": turns["kernel"]["eager_ms"], **shape,
            "instance": ops.INSTANCES[ops.slot_registers(k_max)],
            "ns_per_request_longest": ms * 1e6 / shape["longest_job"],
            "chain_bound_ms": chain_ms, "chain_bound_share": chain_ms / ms,
            "binds": "chain" if chain_ms > figures["bound_ms"] else figures["bound_by"],
            "sm_clock_mhz_median": clock, "sm_clock_mhz_min_max": [min(clocks), max(clocks)]}


def queue_phases(torch, sets) -> None:
    """Where a queue block's cycles go: the kernel built with its phase
    clocks (``kernels/queue_core/phases.py``) on each flush of ``sets``
    (name -> (tables, k_max))."""
    from repro_torch.kernels.queue_core import phases
    lib = phases.build()
    for name, (args, k_max) in sets.items():
        emit({"phase": "queue_phases", "set": name, **phases.measure(lib, args, k_max)})


# ------------------------------------------------------------------ training

def train_launches(cfg, steps: int, remat: bool) -> dict:
    """Exact launches of ``steps`` train steps: each forward kernel once a
    layer, twice under remat (the backward recomputes each repetition), each
    backward kernel once a layer."""
    kinds = cfg.layer_kinds()
    n_attn = sum(k in ("attn", "local") for k in kinds)
    n_rglru = kinds.count("rglru")
    n_mlstm = kinds.count("mlstm")
    n_slstm = kinds.count("slstm")
    fwd = 2 if remat else 1
    want = {name: 0 for name in PLAIN_VERSIONS}
    want.update({"flash_attention": fwd * n_attn * steps,
                 "flash_attention_backward": n_attn * steps,
                 "rglru_scan": fwd * n_rglru * steps,
                 "rglru_scan_backward": n_rglru * steps,
                 "mlstm_chunk": fwd * n_mlstm * steps,
                 "mlstm_chunk_backward": n_mlstm * steps,
                 "slstm_scan": fwd * n_slstm * steps,
                 "slstm_scan_backward": n_slstm * steps})
    return want


def grad_tol(torch, dtype) -> tuple:
    """(rtol, atol, rel_tol) of a gradient check, each gradient held on its
    own: every element within rtol * |ref| + atol * rms(ref), and the whole
    tensor within ||got - ref|| <= rel_tol * ||ref||. bf16: one rounding of
    the same float32 value lands at most one ulp (2^-7 |ref|) away, and
    1e-2 rms for float32 sums in another order before it; float32: sums
    over up to S keys or steps in another order, 1e-5 relative and 1e-4 rms
    (5e-5 rms failed float32 at recurrentgemma-2b's training shape, 2048
    keys a query)."""
    return (2.0 ** -7, 1e-2, 1e-2) if dtype == torch.bfloat16 else (1e-5, 1e-4, 1e-4)


def grad_errors(torch, got, ref, names, dtype, scale: float, share_limit: float = 1.0) -> tuple:
    """Each gradient against its plain version under ``grad_tol`` (each
    element's share of its tolerance at most ``share_limit``), and all of
    them within the one bound ``scale`` x max(1, their largest value) that
    the checks held before: (the largest absolute error over them, a record
    per gradient -- its largest error beside its rms, its relative error
    and its worst element's share of that element's tolerance -- and
    whether all pass)."""
    rtol, atol, rel_tol = grad_tol(torch, dtype)
    bound = scale * max(1.0, max(r.float().abs().max().item() for r in ref))
    records, ok = [], True
    for name, g, r in zip(names, got, ref):
        err = max_err(torch, g, r)
        wide = torch.float64 if r.dtype == torch.float64 else torch.float32
        g, r = g.to(wide), r.to(wide)
        d = (g - r).abs()
        rms = r.square().mean().sqrt()
        share = (d / (rtol * r.abs() + atol * rms).clamp_min(1e-30)).max().item()
        rel = (d.norm() / r.norm().clamp_min(1e-30)).item()
        records.append({"grad": name, "max_abs_err": err, "rms": rms.item(),
                        "rel_err": rel, "worst_element_share": share})
        ok = (ok and share <= share_limit and rel <= rel_tol and err < bound
              and g.shape == r.shape)
    tol = {"rtol": rtol, "atol_rms": atol, "rel_tol": rel_tol, "max_abs": bound,
           "share_limit": share_limit}
    return max(rec["max_abs_err"] for rec in records), {"tol": tol, "grads": records}, ok


def _flash_bwd_inputs(torch, gen, dev, B, S, H, K, hd, dtype):
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, S, K, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, S, K, hd, generator=gen, device=dev).to(dtype)
    do = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype)
    return q, k, v, do


# (B, S, H, K, hd, window, causal) of bf16 cases at the tensor-core
# backward's edges, for each of its head dims: S not a multiple of 64, S
# below 64, non-causal (also with a window), window edges (2, 64, 65, 100),
# and groups G = H / K of 1, 4 and 7.
FLASH_BWD_TC_EDGES = [
    (1, 200, 7, 1, 64, 0, True), (2, 40, 4, 1, 64, 0, True), (1, 130, 4, 2, 64, 0, False),
    (2, 300, 8, 2, 64, 100, True), (1, 200, 4, 2, 64, 50, False),
    (1, 333, 4, 4, 128, 0, True), (2, 50, 7, 1, 128, 20, True), (1, 260, 8, 2, 128, 64, True),
    (1, 200, 4, 1, 128, 0, False),
    (1, 300, 10, 1, 256, 65, True), (1, 63, 7, 1, 256, 0, False),
    (2, 190, 4, 4, 256, 128, True), (1, 129, 4, 1, 256, 2, True),
]


def check_flash_backward(torch, gen, dev):
    """The backward kernels' dq, dk, dv against the plain formulas on the
    card, each under ``grad_tol``, from the forward kernel's output and
    log-sum-exp (itself held against the plain one: float32 1e-4, bf16
    1e-3); a second call must give the same bits (no atomics)."""
    from repro_torch.kernels.flash_attention import ops
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (B, S, H, K, hd, window, causal, dtype)
        (1, 3072, 10, 1, 256, 2048, True, bf16),   # recurrentgemma-2b, train_full_width
        (4, 512, 28, 4, 128, 0, True, bf16),       # qwen2-7b's heads
        (1, 2048, 32, 32, 64, 0, True, bf16),      # musicgen-large, train_full_width
        (8, 128, 4, 1, 16, 16, True, f32),         # reduced recurrentgemma-2b, launcher
        (8, 128, 4, 2, 16, 0, True, f32),          # reduced qwen2-7b, launcher
        (2, 300, 8, 2, 16, 100, True, bf16), (2, 300, 8, 2, 64, 100, True, f32),
        (1, 300, 10, 1, 256, 65, True, f32), (2, 200, 6, 2, 128, 0, False, f32),
        *((*c, bf16) for c in FLASH_BWD_TC_EDGES),
    ]
    errs = {}
    for B, S, H, K, hd, win, causal, dtype in cases:
        q, k, v, do = _flash_bwd_inputs(torch, gen, dev, B, S, H, K, hd, dtype)
        o, lse = ops._launch(q, k, v, causal=causal, window=win, lse=True)
        _, lse_ref = ops.flash_attention_reference(q, k, v, causal=causal, window=win,
                                                   return_lse=True)
        got = ops.flash_attention_backward(q, k, v, o, do, lse, causal=causal, window=win)
        again = ops.flash_attention_backward(q, k, v, o, do, lse, causal=causal, window=win)
        ref = ops.flash_attention_backward_reference(q, k, v, o, do, lse, causal=causal,
                                                     window=win)
        torch.cuda.synchronize()
        err, report, ok = grad_errors(torch, got, ref, ("dq", "dk", "dv"), dtype,
                                      {f32: 1e-4, bf16: 2e-2}[dtype])
        same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
        lse_err = max_err(torch, lse, lse_ref)
        lse_tol = {f32: 1e-4, bf16: 1e-3}[dtype]
        emit({"phase": "check", "kernel": "flash_attention_backward",
              "shape": [B, S, H, K, hd], "window": win, "causal": causal,
              "dtype": str(dtype), "instance": ops.backward_instance(dtype, hd),
              "max_abs_err": err, **report, "second_call_bit_equal": same_bits,
              "lse_max_abs_err": lse_err, "lse_tol": lse_tol})
        if not (ok and same_bits and lse_err < lse_tol and all(g.dtype == dtype for g in got)):
            raise AssertionError(f"flash_attention backward disagrees: {report}, "
                                 f"bit-equal {same_bits}, or lse {lse_err} >= {lse_tol}")
        errs.setdefault((B, S, H, K, hd), err)
        del q, k, v, do, o, lse, lse_ref, got, again, ref
    return errs


def check_rglru_backward(torch, gen, dev):
    """da, db, dh0 of the backward kernel against the plain reverse
    recurrence on the card, each under ``grad_tol`` (float32), and a second
    call bit-equal to the first. Each record names the plan and the staging
    path (TMA where ``ops.tma_staging`` allows, else plain loads); the
    recurrentgemma-2b shapes must take TMA, and there plain loads must give
    the same bits. (2, 3081, 64) leaves a last chunk holding t = 0 alone, (3,
    1, 128) a chunk of one step: boxes wholly outside the sequence."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.launch.train import build_parser
    targs = build_parser().parse_args([])
    W = reduced_config(get_config("recurrentgemma-2b")).lru_width
    rg_shapes = [(1, 3072, 2560), (4, 512, 2560)]
    cases = [*rg_shapes, (targs.batch, targs.seq, W), launcher_default_shapes()[1],
             (2, 10, 256), (3, 1, 128), (1, 5000, 64), (2, 300, 33), (2, 3081, 64),
             (2, 1000, 100)]
    errs = {}
    for B, S, W in cases:
        a, b, h0 = _rglru_inputs(torch, gen, dev, B, S, W, torch.float32)
        h = ops.rglru_scan(a, b, h0)
        dh = torch.randn(B, S, W, generator=gen, device=dev)
        got = ops.rglru_scan_backward(a, h, h0, dh)
        again = ops.rglru_scan_backward(a, h, h0, dh)
        ref = ops.rglru_scan_backward_reference(a, h, h0, dh)
        torch.cuda.synchronize()
        err, report, ok = grad_errors(torch, got, ref, ("da", "db", "dh0"), torch.float32,
                                      2e-5)
        tma = ops.tma_staging(a, h, dh)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        record = {"phase": "check", "kernel": "rglru_scan_backward", "shape": [B, S, W],
                  "plan": list(ops.scan_plan(S)),
                  "staging": "tma" if tma else "plain loads", "second_call_bit_equal": same}
        if (B, S, W) in rg_shapes:
            plain = ops._launch_backward(a, h, h0, dh, tma=False)
            record["plain_loads_bit_equal"] = all(torch.equal(x, y) for x, y in zip(got, plain))
            ok = ok and tma and record["plain_loads_bit_equal"]
        emit({**record, "max_abs_err": err, **report})
        if not (ok and same):
            raise AssertionError(f"rglru_scan backward disagrees: {record} {report}")
        errs[(B, S, W)] = err
    return errs


def measure_flash_backward(torch, gen, dev, peak, B, S, H, K, hd, window):
    """The backward kernels at a training shape (bf16), timed as the forward
    kernels are (``time_interleaved``: CUDA graphs of 20 calls, 7 turns) in
    turns with SDPA: ``torch.autograd.grad`` of
    ``F.scaled_dot_product_attention`` with the same boolean mask, timed
    whole (forward and backward) and its forward alone; ``library_ms`` is
    the difference, the backward's share. The bound counts five products
    over the visible pairs at the bf16 tensor-core rate, and q, k, v, o,
    dO, lse in and dq, dk, dv out once."""
    from repro_torch.cost import kernels as work
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    q, k, v, do = _flash_bwd_inputs(torch, gen, dev, B, S, H, K, hd, torch.bfloat16)
    o, lse = ops._launch(q, k, v, causal=True, window=window, lse=True)
    qp = torch.arange(S, device=dev)[:, None]
    kp = torch.arange(S, device=dev)[None, :]
    mask = (kp <= qp) & ((kp > qp - window) if window > 0 else True)
    lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    ldo = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask, enable_gqa=True)

    with torch.no_grad():
        sdpa_err = max_err(torch, sdpa().transpose(1, 2), o)   # same function
    turns = time_interleaved(torch, {
        "kernel": lambda: ops.flash_attention_backward(q, k, v, o, do, lse, window=window),
        "library_fwd_bwd": lambda: torch.autograd.grad(sdpa(), (lq, lk, lv), ldo),
        "library_fwd": lambda: sdpa().detach()}, [()], iters=5)
    plain = time_ms(torch, lambda: ops.flash_attention_backward_reference(
        q, k, v, o, do, lse, window=window), [()], iters=2, warmup=1)
    flops, nbytes = work.flash_backward(B, S, H, K, hd, window)
    library = turns["library_fwd_bwd"]["median"] - turns["library_fwd"]["median"]
    return {**measured(turns["kernel"]["median"], plain, library, flops, nbytes,
                       peak[0], peak[1]),
            "min_max_ms": turns["kernel"]["min_max"], "eager_ms": turns["kernel"]["eager_ms"],
            "library_fwd_bwd_ms": turns["library_fwd_bwd"]["median"],
            "library_fwd_ms": turns["library_fwd"]["median"],
            "library_note": "SDPA (boolean mask, enable_gqa) forward+backward minus its "
                            "forward", "sdpa_vs_forward_kernel_max_abs_err": sdpa_err,
            "blocks": ops.backward_grids(torch.bfloat16, B, S, H, K, hd)}


def measure_rglru_backward(torch, gen, dev, peak, B, S, W):
    """The backward kernel at a training shape (float32), as
    ``measure_rglru`` times the forward (CUDA graphs of 20 calls, 7
    turns). Bound: a, h, dh and h0 read and da, db, dh0 written once; two
    FMA-sized operations and a product a step at the float32 rate. No
    library yardstick: no single PyTorch call computes the reverse
    recurrence. Also the plan (the forward's ``ops.scan_plan``), its blocks
    and clusters, shared bytes a block and the clusters the card holds at
    once (``ops.backward_residency``: the CUDA runtime's count), the blocks an SM
    that makes, and the staging path."""
    from repro_torch.cost import kernels as work
    from repro_torch.kernels.rglru_scan import ops
    a, b, h0 = _rglru_inputs(torch, gen, dev, B, S, W, torch.float32)
    h = ops.rglru_scan(a, b, h0)
    dh = torch.randn(B, S, W, generator=gen, device=dev)
    inputs = [(a, h, h0, dh)]
    turns = time_interleaved(torch, {"kernel": ops.rglru_scan_backward}, inputs)
    plain = time_ms(torch, ops.rglru_scan_backward_reference, inputs, iters=1, warmup=1)
    flops, nbytes = work.rglru_backward(B, S, W)
    plan = ops.scan_plan(S)
    clusters = -(-W // ops.BWD_TILE_W) * B
    smem, resident = ops.backward_residency(plan)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    one = turns["kernel"]
    return {**measured(one["median"], plain, None, flops, nbytes, peak[2], peak[1]),
            "min_max_ms": one["min_max"], "eager_ms": one["eager_ms"],
            "scan_plan": list(plan), "blocks": clusters * plan.clusters, "clusters": clusters,
            "smem_bytes": smem, "resident_clusters": resident,
            "resident_blocks_per_sm": resident * plan.clusters / sms,
            "staging": "tma" if ops.tma_staging(a, h, dh) else "plain loads"}


def _mlstm_floor_inputs(torch, dev, B, S, H, dqk, dv, dtype, q_scale, i_shift, seed=0):
    """q, k, v, the gates and dh drawn as ``tests/test_torch_mlstm_backward.py``
    draws them (numpy, ``seed``), q scaled by ``q_scale`` and the input gate
    shifted by ``i_shift`` so that the denominator's floor wins at part of
    the positions; on the card in ``dtype`` (gates float32)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dqk)) * q_scale
    k = rng.standard_normal((B, S, H, dqk)) / np.sqrt(dqk)
    v = rng.standard_normal((B, S, H, dv))
    il = rng.standard_normal((B, S, H)) + i_shift
    x = rng.standard_normal((B, S, H)).astype(np.float32) + 2.0
    fl = -np.logaddexp(0.0, -x)
    dh = rng.standard_normal((B, S, H, dv))
    card = lambda a, t: torch.from_numpy(a.astype(np.float32)).to(dev).to(t)  # noqa: E731
    return (card(q, dtype), card(k, dtype), card(v, dtype), card(il, torch.float32),
            card(fl, torch.float32)), card(dh, dtype)


# float32 at S 2048 against float64: the kernels' and the plain formulas'
# worst elements, as shares of grad_tol, measured at 0.3-2.24 over five
# input draws on an H100 (either order may be the worse one); each is held
# at 3.
MLSTM_F64_SHARE = 3.0


def check_mlstm_backward(torch, gen, dev):
    """dq, dk, dv, di and df of the backward kernels against the plain
    formulas (``mlstm_chunk_backward_reference``) on the card, each under
    ``grad_tol``, from the forward kernels' h (the plain forward's where the
    bf16 forward does not take dqk or dv below 64); a second call must give
    the same bits (no atomics). Cases: xlstm-1.3b's training layer, its
    prefill batch, the serve and train launchers' reduced shapes, S 300
    (chunk 150), one chunk, dqk != dv below 64, and inputs drawn as the CPU
    test draws them on which the floor exp(-m_j) wins at part of the
    positions (the share is printed and must lie strictly between 0 and
    1). Then float32 at the training layer, where grad_tol cannot tell two
    float32 orders apart: the kernels and the plain formulas each against
    the formulas in float64 on the same inputs, each element within
    ``MLSTM_F64_SHARE`` x grad_tol."""
    from repro_torch.kernels.mlstm_chunk import ops
    from repro_torch.kernels.mlstm_chunk.ref import chunk_size, floor_share
    from repro_torch.launch.train import build_parser
    bf16, f32 = torch.bfloat16, torch.float32
    targs = build_parser().parse_args([])
    reduced = launcher_default_shapes()[0]
    train_reduced_shape = (targs.batch, targs.seq, *reduced[2:])
    cases = [  # (B, S, H, dqk, dv, chunk, dtype, floor inputs (q scale, i shift) or None)
        (1, 2048, 4, 512, 1024, 256, bf16, None),     # xlstm-1.3b, train_full_width
        (4, 512, 4, 512, 1024, 256, bf16, None),
        (*reduced, f32, None),                        # the serve launcher's reduced shape
        (*train_reduced_shape, f32, None),            # the train launcher's, train_reduced
        (1, 300, 4, 64, 96, 256, f32, None),          # chunk 150, ragged tiles
        (1, 300, 4, 64, 96, 256, bf16, None),
        (2, 192, 2, 128, 256, 256, bf16, None),       # one chunk
        (2, 256, 2, 16, 48, 64, f32, None),           # dqk != dv, below 64
        (2, 256, 2, 48, 16, 64, bf16, None),
        (2, 512, 4, 128, 256, 256, f32, (1.0, 0.0)),  # floor wins at a few positions
        (2, 512, 4, 128, 256, 256, f32, (0.3, -1.0)),  # ... at most
        (2, 512, 4, 128, 256, 256, bf16, (0.3, -1.0)),
    ]
    errs = {}
    for B, S, H, dqk, dv, chunk, dtype, floor in cases:
        if floor is None:
            args = _mlstm_inputs(torch, gen, dev, B, S, H, dqk, dv, dtype)
            dh = torch.randn(B, S, H, dv, generator=gen, device=dev).to(dtype)
        else:
            args, dh = _mlstm_floor_inputs(torch, dev, B, S, H, dqk, dv, dtype, *floor)
        with torch.no_grad():
            h = (ops.mlstm_chunk(*args, chunk=chunk) if dtype == f32 or min(dqk, dv) >= 64
                 else ops.mlstm_chunk_reference(*args, chunk=chunk))
        got = ops.mlstm_chunk_backward(*args, h, dh, chunk=chunk)
        again = ops.mlstm_chunk_backward(*args, h, dh, chunk=chunk)
        ref = ops.mlstm_chunk_backward_reference(*args, h, dh, chunk=chunk)
        torch.cuda.synchronize()
        err, report, ok = grad_errors(torch, got, ref, ("dq", "dk", "dv", "di", "df"), dtype,
                                      {f32: 1e-4, bf16: 2e-2}[dtype])
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        share = floor_share(args[0], args[1], args[3], args[4], chunk=chunk)
        record = {"phase": "check", "kernel": "mlstm_chunk_backward",
                  "shape": [B, S, H, dqk, dv], "chunk": chunk_size(S, chunk),
                  "dtype": str(dtype), "path": ops.backward_path(dtype, dqk, dv),
                  "floor_inputs": floor, "floor_share": share,
                  "max_abs_err": err, **report, "second_call_bit_equal": same}
        emit(record)
        if floor is not None:
            ok = ok and 0.0 < share < 1.0
        if not (ok and same and [g.dtype for g in got] == [dtype] * 3 + [f32] * 2):
            raise AssertionError(f"mlstm_chunk backward disagrees: {record}")
        errs.setdefault((B, S, H, dqk, dv), err)
        del args, dh, h, got, again, ref
    B, S, H, dqk, dv = 1, 2048, 4, 512, 1024
    args = _mlstm_inputs(torch, gen, dev, B, S, H, dqk, dv, f32)
    with torch.no_grad():
        h = ops.mlstm_chunk(*args)
    args = (*args, h, torch.randn(B, S, H, dv, generator=gen, device=dev))
    want = ops.mlstm_chunk_backward_reference(*(t.double() for t in args))
    sides = {}
    for side, fn in (("kernel", ops.mlstm_chunk_backward),
                     ("plain", ops.mlstm_chunk_backward_reference)):
        err, report, ok = grad_errors(torch, fn(*args), want, ("dq", "dk", "dv", "di", "df"),
                                      f32, 1e-4, MLSTM_F64_SHARE)
        sides[side] = {"max_abs_err": err, **report, "ok": ok}
    torch.cuda.synchronize()
    record = {"phase": "check", "kernel": "mlstm_chunk_backward", "shape": [B, S, H, dqk, dv],
              "chunk": 256, "dtype": str(f32), "path": ops.backward_path(f32, dqk, dv),
              "against_float64": sides}
    emit(record)
    if not (sides["kernel"]["ok"] and sides["plain"]["ok"]):
        raise AssertionError(f"mlstm_chunk backward, float32 against float64: {record}")
    errs[(B, S, H, dqk, dv, "float32")] = sides["kernel"]["max_abs_err"]
    del args, h, want
    return errs


def measure_mlstm_backward(torch, gen, dev, peak, B=1, S=2048, H=4, dqk=512, dv=1024):
    """The backward kernels at xlstm-1.3b's training layer (bf16), timed as
    the forward (``time_interleaved``: CUDA graphs of 20 calls, 7 turns),
    beside the plain formulas. Bound: q, k, v, h, dh and the gates read and
    the five gradients written once, and the backward's own products
    (``cost.kernels.mlstm_backward(as_built=False)``: no state recomputed,
    the scores once) at the rate of the inputs' type, bf16, as the forward
    row's. No library yardstick: no single PyTorch call computes this
    backward. ``passes``: each of its kernels' device ms and launches a
    call, from ``torch.profiler`` over 5 calls; ``launches_a_call``, their
    sum; ``workspace_bytes``, the allocator's growth over one call less the
    five gradients (each block rounded up to the allocator's 512 bytes)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cost import kernels as work
    from repro_torch.kernels.mlstm_chunk import ops
    args = _mlstm_inputs(torch, gen, dev, B, S, H, dqk, dv, torch.bfloat16)
    with torch.no_grad():
        h = ops.mlstm_chunk(*args)
    dh = torch.randn(B, S, H, dv, generator=gen, device=dev).to(torch.bfloat16)
    inputs = [(*args, h, dh)]
    turns = time_interleaved(torch, {"kernel": ops.mlstm_chunk_backward}, inputs)["kernel"]
    plain = time_ms(torch, ops.mlstm_chunk_backward_reference, inputs, iters=2, warmup=1)
    flops, nbytes = work.mlstm_backward(B, S, H, dqk, dv, 256, as_built=False)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            ops.mlstm_chunk_backward(*inputs[0])
        torch.cuda.synchronize()
    passes = [{"name": re.search(r"mlstm_bwd_\w+_kernel", p["name"]).group(0),
               "ms": p["ms_per_step"], "calls_per_step": p["calls_per_step"]}
              for p in _device_breakdown(torch, prof, time.perf_counter() - t0, 5)["port_kernels"]]
    block = lambda n: -(-n // 512) * 512  # noqa: E731
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = ops.mlstm_chunk_backward(*inputs[0])
    torch.cuda.synchronize()
    workspace = (torch.cuda.max_memory_allocated() - base
                 - sum(block(g.untyped_storage().nbytes()) for g in grads))
    del grads
    return {**measured(turns["median"], plain, None, flops, nbytes, peak[0], peak[1]),
            "min_max_ms": turns["min_max"], "eager_ms": turns["eager_ms"],
            "passes": passes, "path": ops.backward_path(torch.bfloat16, dqk, dv),
            "workspace_bytes": workspace,
            "launches_a_call": sum(p["calls_per_step"] for p in passes)}


def _metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


# (arch, steps whose loss, nll and grad norm are held, the rtol of step 1's
# gradients leaf by leaf), three steps each. Card against CPU, leaf by leaf,
# the worst relative gap of a leaf measured on an H100 80GB: 2.1e-6 for the
# four archs (1e-4 held), 7.1e-4 for xlstm-1.3b (2e-3 held; the mLSTM
# leaves of its last layers, where the normaliser max(|den|, e^-m)
# amplifies float32 reordering: the card's plain formulas under autograd,
# no kernel, leave the CPU's by 1.0e-3, the kernels the card's plain
# formulas by 3.6e-4). The reduced xLSTM at the default learning rate is
# chaotic (grad norm ~140, clipped; Adam's first update moves every element
# by about the rate, whatever its gradient's size): card and CPU agree on
# the first step and then part (step 3's loss by 3.4e-3), as two runs of
# the same steps on the CPU do (step 3's grad norm by 5.3e-3 relative). So
# its later steps are printed, not held.
TRAIN_REDUCED = (("recurrentgemma-2b", 3, 1e-4), ("qwen2-7b", 3, 1e-4),
                 ("qwen3-moe-30b-a3b", 3, 1e-4), ("musicgen-large", 3, 1e-4),
                 ("xlstm-1.3b", 1, 2e-3))
# the atol of step 1's gradients leaf by leaf, a share of the whole
# gradient's norm: leaves whose gradient is noise on both sides (~1e-10 of
# the whole) are held by it
LEAF_ATOL = 1e-7


def leaf_errors(torch, got: dict, want: dict, rtol: float) -> tuple:
    """Each leaf's ||got - want|| against ``rtol`` ||want|| + ``LEAF_ATOL``
    ||all of want||: (records of the worst eight by their share of that
    bound, the number of leaves, whether all pass)."""
    total = math.sqrt(sum(float(w.float().square().sum()) for w in want.values()))
    rows = []
    for name, w in want.items():
        w = w.float()
        d = float((got[name].float().cpu() - w).norm())
        norm = float(w.norm())
        rows.append({"leaf": name, "norm": norm, "err": d, "rel_err": d / max(norm, 1e-30),
                     "share": d / (rtol * norm + LEAF_ATOL * total)})
    rows.sort(key=lambda r: -r["share"])
    return rows[:8], len(rows), all(r["share"] <= 1.0 for r in rows)


def train_reduced(torch, dev, arch: str, held: int, leaf_rtol: float, steps: int = 3) -> dict:
    """The train launcher's reduced config of ``arch`` (float32, head_dim
    16, batch 8 x 128 tokens, remat "block", the default learning rate):
    the first batch's gradients, then ``steps`` steps, on the CPU (the plain
    versions), then the same on the card from the same weights, counted
    with the plain versions raising. The gradients leaf by leaf
    (``leaf_errors`` at ``leaf_rtol``); loss and nll 1e-4, grad_norm 1e-4
    relative, on the first ``held`` steps: float32 sums in another order,
    compounded over the steps. Every step finite."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import build_parser
    from repro_torch.training.train_step import (init_state, make_grads_fn, make_train_step,
                                                 train_state)
    args = build_parser().parse_args([])
    cfg = reduced_config(get_config(arch))
    tcfg = TrainConfig()
    data = SyntheticLM(cfg, seed=0)
    batches = [data.batch(i, args.batch, args.seq) for i in range(steps)]
    cpu = init_state(cfg, seed=0, device="cpu")
    card = train_state(cpu.params.copy_to(dev))
    grads, step = make_grads_fn(cfg, tcfg), make_train_step(cfg, tcfg)
    want_grads = grads(cpu.params, batches[0])[2]
    want, got, launches = [], [], {}
    for b in batches:
        cpu, m = step(cpu, b)
        want.append(_metrics(m))
    with counted_on_card(launches):
        got_grads = grads(card.params, {k: t.to(dev) for k, t in batches[0].items()})[2]
        for b in batches:
            card, m = step(card, {k: t.to(dev) for k, t in b.items()})
            got.append(_metrics(m))
        torch.cuda.synchronize()
    worst_leaves, n_leaves, leaves_ok = leaf_errors(torch, got_grads, want_grads, leaf_rtol)
    expected = train_launches(cfg, steps + 1, tcfg.remat != "none")
    diffs = [{k: abs(g[k] - w[k]) / (max(1.0, abs(w[k])) if k == "grad_norm" else 1.0)
              for k in w} for g, w in zip(got, want)]
    emit({"phase": "train_reduced", "arch": arch, "batch": [args.batch, args.seq],
          "steps": steps, "held_steps": held, "remat": tcfg.remat,
          "learning_rate": tcfg.learning_rate, "card": got, "cpu": want, "diff": diffs,
          "tol": 1e-4, "step_1_leaves": n_leaves, "step_1_worst_leaves": worst_leaves,
          "leaf_tol": {"rtol": leaf_rtol, "atol_of_total": LEAF_ATOL},
          "launches": launches, "expected_launches": expected})
    if launches != expected:
        raise AssertionError(f"{arch}: launches {launches} != {expected}")
    if not leaves_ok:
        raise AssertionError(f"{arch}: step 1's gradients disagree: {worst_leaves}")
    if not all(d < 1e-4 for row in diffs[:held] for d in row.values()):
        raise AssertionError(f"{arch}: card and CPU training disagree: {diffs}")
    if not all(math.isfinite(v) for row in got for v in row.values()):
        raise AssertionError(f"{arch}: the card's steps are not finite: {got}")
    return {k: launches[k] for k in TRAIN_KERNELS}


def train_launcher(torch, out_dir: Path) -> dict:
    """``python -m repro_torch.launch.train --reduced --arch recurrentgemma-2b
    --devices 1`` in this process on the card (the elastic trainer at world
    size 1: no process group): ``--steps 4 --ckpt-every 2``, then the same
    command with ``--steps 6`` (it must resume at step 4), and an
    uninterrupted 6-step run beside it; the resumed step-6 loss must equal
    the uninterrupted one. Counted, plain versions raising. Then
    ``--devices`` one more than this host's cards must raise, naming the
    count, before any weight is drawn."""
    import shutil
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import train
    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    base = ["--reduced", "--arch", "recurrentgemma-2b", "--devices", "1"]
    resumed = base + ["--ckpt-dir", str(out_dir / "resumed")]
    straight = base + ["--ckpt-dir", str(out_dir / "straight")]
    launches, outs = {}, []
    with counted_on_card(launches):
        for argv in (resumed + ["--steps", "4", "--ckpt-every", "2"],
                     resumed + ["--steps", "6", "--log", str(out_dir / "resumed.json")],
                     straight + ["--steps", "6", "--log", str(out_dir / "straight.json")]):
            rc, out = quiet(train.main, argv)
            if rc != 0:
                raise AssertionError(f"train {argv} exited {rc}")
            outs.append(out)
        torch.cuda.synchronize()
    first_lines = [o.splitlines()[0] for o in outs]
    a = json.loads((out_dir / "resumed.json").read_text())[-1]
    b = json.loads((out_dir / "straight.json").read_text())[-1]
    cfg = reduced_config(get_config("recurrentgemma-2b"))
    expected = train_launches(cfg, 4 + 2 + 6, True)
    too_many = torch.cuda.device_count() + 1
    try:
        train.main(base[:-1] + [str(too_many), "--steps", "1",
                                "--ckpt-dir", str(out_dir / "too_many")])
        refused = None
    except RuntimeError as e:
        refused = str(e)
    emit({"phase": "train_launcher", "first_lines": first_lines,
          "resumed_step_6": a, "uninterrupted_step_6": b, "launches": launches,
          "expected_launches": expected, f"devices_{too_many}": refused})
    if not (first_lines[0].endswith("devices=1 start_step=0") and first_lines[1].endswith(
            "devices=1 start_step=4") and "done; checkpoint at" in outs[1]):
        raise AssertionError(f"the launcher did not resume: {first_lines}")
    if a != b:
        raise AssertionError(f"resumed step 6 {a} != uninterrupted {b}")
    if launches != expected:
        raise AssertionError(f"train launcher launches {launches} != {expected}")
    if not (refused and f"{too_many - 1} CUDA device" in refused):
        raise AssertionError(f"--devices {too_many} on {too_many - 1} card(s): {refused}")
    return {k: launches[k] for k in TRAIN_KERNELS}


# (arch, batch, sequence, least parameters, then): "cost" profiles a step and
# counts one for the cost phase's cell; "xlstm_blocks" then times one mLSTM and
# one sLSTM block as a step runs them
FULL_WIDTH_TRAINING = (
    ("recurrentgemma-2b", 1, 3072, 2.8e9, ("cost",)),   # longer than its 2048 window
    ("musicgen-large", 1, 2048, 3.2e9, ("cost",)),      # frames of SyntheticLM's embeddings
    ("xlstm-1.3b", 1, 2048, 2.8e9, ("cost", "xlstm_blocks")),  # 42 mLSTM, 6 sLSTM layers
)


def time_xlstm_train_blocks(torch, model, B: int, S: int, step_ms: float) -> None:
    """Host wall ms (after a synchronize) of one mLSTM and one sLSTM block of
    a training model at [B, S, D] as a step under remat "block" runs each:
    a forward without grad, the forward again under autograd, and its
    backward; each kind's share of the step, by its layer count."""
    x = torch.randn(B, S, model.cfg.d_model, device=model.device).to(model.compute_dtype)
    kinds = model.cfg.layer_kinds()
    out = {}
    for kind in ("mlstm", "slstm"):
        block = next(b for b in model.layers if b.kind == kind)
        leaves = [x.requires_grad_(True), *block.parameters()]

        def step():
            with torch.no_grad():
                block(x)
            y, _ = block(x)
            torch.autograd.grad(y, leaves, torch.ones_like(y))

        torch.cuda.synchronize()                                # warm: the steps ran
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[kind] = {"block_ms": ms, "layers": kinds.count(kind),
                     "share_of_step": ms * kinds.count(kind) / step_ms}
    emit({"phase": "xlstm_train_blocks", "shape": list(x.shape), "step_ms": step_ms, **out})


def train_full_width(torch, dev, out_dir: Path, arch: str, B: int, S: int,
                     min_params: float, then: str, cost_cells: dict, steps: int = 4) -> dict:
    """``arch`` at its published widths (bf16 weights from seed 0, float32
    AdamW state) through the port's ``ElasticTrainer.train_steps`` on one
    card (world size 1: no process group, no collective), batch B x S of
    ``SyntheticLM`` (musicgen-large: per-frame embeddings and 4-codebook
    labels), remat "block", no checkpoint. Per step: loss, grad_norm, wall
    ms (host clock around a step that ends in a synchronize); peak device
    memory, which must stay under the card's 80 GB; exact launches of the
    forward and backward kernels. Then, for each of ``then``, a profiled
    step and a counted one for the cost phase ("cost"), or the mLSTM and
    sLSTM blocks' times (``time_xlstm_train_blocks``, "xlstm_blocks").
    Returns the launches and the losses."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.elastic import ElasticTrainer
    if out_dir.exists():
        shutil.rmtree(out_dir)
    cfg = get_config(arch)
    tcfg = TrainConfig(remat="block")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = ElasticTrainer(cfg, tcfg, global_batch=B, seq_len=S, ckpt_dir=str(out_dir),
                             data_fn=SyntheticLM(cfg, seed=0).data_fn)
    trainer.start([dev])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.state.params.parameters())
    state_bytes = torch.cuda.memory_allocated()
    launches, rows = {}, []
    with counted_on_card(launches):
        for _ in range(steps):
            t = time.perf_counter()
            m = trainer.train_steps(1)
            torch.cuda.synchronize()
            rows.append({"step": m["step"], "loss": m["loss"], "nll": m["nll"],
                         "grad_norm": m["grad_norm"],
                         "wall_ms": (time.perf_counter() - t) * 1e3})
    expected = train_launches(cfg, steps, True)
    steady = sorted(r["wall_ms"] for r in rows[1:])
    step_ms = steady[len(steady) // 2]
    peak_bytes = torch.cuda.max_memory_allocated()
    record = {"phase": "train_full_width", "arch": cfg.name, "params": n_params,
              "batch": [B, S], "remat": tcfg.remat, "dtype": cfg.param_dtype,
              "devices": trainer.mesh.size, "steps": rows, "loss_step_1": rows[0]["loss"],
              "step_ms_median_steps_2_on": step_ms, "tokens_per_s": B * S / step_ms * 1e3,
              "init_s": init_s, "state_bytes_after_init": state_bytes,
              "max_memory_allocated_bytes": peak_bytes,
              "launches": launches, "expected_launches": expected,
              "nvidia_smi": card_line()}
    emit(record)
    for follow in then:
        if follow == "cost":
            profile_training(torch, trainer)
            cost_cells[cfg.name] = counted_step(torch, lambda: trainer.train_steps(1),
                                                (trainer.state,))
            cost_cells[cfg.name]["measured_ms"] = step_ms
        elif follow == "xlstm_blocks":
            time_xlstm_train_blocks(torch, trainer.state.params, B, S, step_ms)
        else:
            raise ValueError(f"{arch}: unknown follow-up {follow!r}")
    finite = all(math.isfinite(r[k]) for r in rows for k in ("loss", "nll", "grad_norm"))
    if not (finite and launches == expected and n_params > min_params
            and peak_bytes < 80e9 and trainer.mesh.size == 1):
        raise AssertionError(f"full-width training failed: {record}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] for k in TRAIN_KERNELS}, [r["loss"] for r in rows]


# The phoenix phase's ticks. WS ticks go through ws_tick_slo with an SLO
# autoscaler of n_min 0: the utilization rule of ws_tick never asks for
# fewer than one replica, so WS would never give the only card back and the
# trainer would never start (the stub run of PHOENIX_UTIL_TICKS shows it).
PHX_SPIKE = ("ws_tick_slo", 5.0, 0.35, 1.0)
PHX_QUIET = ("ws_tick_slo", 0.0, 0.35, 1.0)
PHOENIX_TICKS = [PHX_SPIKE, ("start",), ("submit",), PHX_QUIET, ("train_steps", 2),
                 PHX_SPIKE, ("resize",), ("train_steps", 2)]
PHOENIX_UTIL_TICKS = [("ws_tick", 1e6), ("start",), ("ws_tick", 0.0), ("train_steps", 2)]


class StubUtilPool(StubPool):
    """A stub pool with ``ServingPool.desired_replicas``' §III-C rule."""
    capacity = 4096.0

    def desired_replicas(self, load):
        from repro_torch.runtime.serving_pool import ServingPool
        return ServingPool.desired_replicas(self, load)


def phoenix_orchestrator(trainer, pool, devices):
    """The paper's two-department wiring (``PhoenixOrchestrator``) with an
    SLO autoscaler at 2 s, n_min 0 and n_max 1; ``devices`` None takes
    ``DevicePool()``'s, every CUDA device."""
    from repro_torch.core.types import SLOConfig
    from repro_torch.runtime.orchestrator import PhoenixOrchestrator
    from repro_torch.serving.batching import ServiceTimeModel
    from repro_torch.workloads.autoscaler import SLOAutoscaler
    return PhoenixOrchestrator(trainer, pool, devices=devices, slo_autoscaler=SLOAutoscaler(
        ServiceTimeModel(), SLOConfig(latency_target_s=2.0), n_min=0, n_max=1))


def phoenix_tick(orch, op):
    """One tick of ``PHOENIX_TICKS`` (``submit`` is the caller's); n train
    steps as n calls of one, so that each step's metrics are logged."""
    if op[0] == "resize":               # what _resize_trainer does on a grant
        orch.trainer.resize(orch.devs.st)
    elif op[0] == "train_steps":
        for _ in range(op[1]):
            orch.train_steps(1)
    elif op[0] != "submit":
        getattr(orch, op[0])(*op[1:])


def _tree_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def phoenix_phase(torch, out_dir: Path, want_losses: list) -> dict:
    """The paper's ``PhoenixOrchestrator`` on ``DevicePool()`` (the card) with
    full-width workloads on both sides. WS: a ``ServingPool`` of
    recurrentgemma-2b at its published widths (bf16 weights drawn on the
    card from seed 0). HPC: an ``ElasticTrainer`` of recurrentgemma-2b at
    its published widths with ``train_full_width``'s setup (1 x 3072 tokens,
    remat ``block``, ``SyntheticLM`` seed 0), checkpointing into
    ``out_dir``. The ticks (``PHOENIX_TICKS``): a WS spike before
    ``start()`` takes the idle card; ``start()`` finds nothing idle, so the
    trainer does not start; 8 requests of 512 + 32 tokens at batch 4
    through ``pool.submit``; zero WS load gives the card back, it reflows to
    ST and ``_grant_st`` starts the trainer; 2 train steps; a second spike
    gets nothing (ST is at its floor: ``min_st`` is at least one device);
    ``trainer.resize(orch.devs.st)``, the call ``_resize_trainer`` makes on
    a grant, made directly because on one card no grant can follow a
    reclaim (timed: the checkpoint's write, the restore, the bytes and the
    free space before the write); 2 more train steps. Counted, plain
    versions raising. Fails unless the events equal the same ticks through
    ``PhoenixOrchestrator`` with stub workloads, the trainer was resized
    once, its four losses equal ``want_losses`` (``train_full_width``'s
    recurrentgemma-2b losses of this run) bit for bit, the served tokens
    are in range, the launches are exact and the peak memory stays under
    80 GB. The checkpoint is deleted after the phase."""
    import shutil
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.runtime.device_pool import cuda_devices
    from repro_torch.runtime.elastic import ElasticTrainer
    from repro_torch.runtime.serving_pool import ServingPool
    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    stub = phoenix_orchestrator(StubTrainer(), StubPool(), ["cuda:0"])
    for op in PHOENIX_TICKS:
        phoenix_tick(stub, op)
    util = phoenix_orchestrator(StubTrainer(), StubUtilPool(), ["cuda:0"])
    for op in PHOENIX_UTIL_TICKS:
        getattr(util, op[0])(*op[1:])

    cfg = get_config("recurrentgemma-2b")
    B, S = 1, 3072
    torch.cuda.reset_peak_memory_stats()
    dev = cuda_devices()[0]                    # what DevicePool() takes
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    pool = ServingPool(cfg, model)
    trainer = ElasticTrainer(cfg, TrainConfig(remat="block"), global_batch=B, seq_len=S,
                             ckpt_dir=str(out_dir), data_fn=SyntheticLM(cfg, seed=0).data_fn)
    walls = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            return out
        return run
    trainer.checkpoint = timed("checkpoint_s", trainer.checkpoint)
    trainer._try_restore = timed("restore_s", trainer._try_restore)
    orch = phoenix_orchestrator(trainer, pool, None)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 512), dtype=np.int32)
    ticks, served, launches, resize, started_at = [], [], {}, {}, None
    with counted_on_card(launches):
        for i, op in enumerate(PHOENIX_TICKS):
            if op[0] == "resize":
                resize["free_bytes_before"] = shutil.disk_usage(out_dir).free
                resize["memory_allocated_before_bytes"] = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            if op[0] == "submit":
                if [r.device for r in pool.replicas] != [dev] or trainer.mesh is not None:
                    raise AssertionError("the WS department does not hold the card")
                served = [pool.submit(prompts[j:j + 4], 32) for j in (0, 4)]
            phoenix_tick(orch, op)
            torch.cuda.synchronize()
            ticks.append({"tick": op[0], "args": list(op[1:]),
                          "wall_ms": (time.perf_counter() - t0) * 1e3,
                          "st": len(orch.devs.st), "ws": len(orch.devs.ws),
                          "replicas": len(pool.replicas)})
            orch.devs.check()
            orch.rps.check()
            if started_at is None and trainer.mesh is not None:
                started_at = i
            if op[0] == "resize":
                resize.update(wall_s=ticks[-1]["wall_ms"] / 1e3, **walls,
                              checkpoint_bytes=_tree_bytes(out_dir), step=trainer.step)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in trainer.metrics_log]
    kinds = cfg.layer_kinds()
    n_attn = sum(k in ("attn", "local") for k in kinds)
    want = train_launches(cfg, 4, True)
    want["flash_attention"] += 2 * n_attn
    want["decode_attention"] += 2 * n_attn * 31
    want["rglru_scan"] += 2 * kinds.count("rglru")
    tokens_ok = all(t.shape == (4, 32) and (t >= 0).all() and (t < cfg.vocab_size).all()
                    for t in served)
    record = {"phase": "phoenix", "devices": [str(d) for d in orch.devs.devices],
              "serve": {"arch": cfg.name, "d_model": cfg.d_model, "requests": 8,
                        "prompt_len": 512, "max_new": 32, "batch": 4, "tokens_ok": tokens_ok,
                        "timings_ms": [{k: v * 1e3 for k, v in t.items() if k.endswith("_s")}
                                       for t in pool.timings]},
              "train": {"arch": cfg.name, "batch": [B, S], "remat": "block",
                        "started_at_tick": started_at, "resizes": trainer.resizes,
                        "metrics": trainer.metrics_log, "losses": losses,
                        "train_full_width_losses": want_losses,
                        "losses_bit_equal": losses == want_losses},
              "resize": resize, "ticks": ticks, "events": orch.events,
              "stub_events": stub.events,
              "utilization_rule_stub": {"ticks": [list(op) for op in PHOENIX_UTIL_TICKS],
                                        "events": util.events,
                                        "trainer_started": util._started},
              "max_memory_allocated_bytes": peak, "launches": launches,
              "expected_launches": want, "nvidia_smi": card_line()}
    emit(record)
    ok = (orch.events == stub.events and started_at == 3 and trainer.resizes == 1
          and losses == want_losses and tokens_ok and launches == want and peak < 80e9
          and orch.devs.total == 1)
    if not ok:
        raise AssertionError(f"phoenix phase failed: {record}")
    del orch, pool, model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches


def counted_step(torch, fn, live) -> dict:
    """One more step (``fn``), untimed, under the cost counter
    (``cost.analysis.CostCounter``, ``live`` held from the start) with the
    exact launches counted and the plain versions raising; the card's peak
    memory over it (``max_memory_allocated`` after a reset)."""
    from repro_torch.cost.analysis import CostCounter
    launches = {}
    with counted_on_card(launches):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with CostCounter(live=live) as counter:
            fn()
            torch.cuda.synchronize()
    return {"card": counter.totals(), "card_peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": {k: n for k, n in launches.items() if n}}


def serve_cost_cells(torch, model, report, cost_cells: dict) -> dict:
    """qwen2-7b's served shapes counted on the card: a [4, 512] prefill into
    caches of 544 slots and one decode step at position 512 (the serve
    phase's last round times them). Returns the launches."""
    from repro_torch.serving.engine import make_decode_fn, make_prefill_fn
    cfg, dev = model.cfg, model.device
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 512), device=dev, generator=gen)
    t = report["timings"][-1]
    out = {}
    with torch.no_grad():
        out["prefill"] = counted_step(
            torch, lambda: out.setdefault("caches", make_prefill_fn(cfg, max_len=544)(
                model, tokens)[1]), (model, tokens))
        caches, nxt = out.pop("caches"), tokens[:, -1:].contiguous()
        out["decode"] = counted_step(
            torch, lambda: make_decode_fn(cfg)(model, caches, nxt, 512), (model, caches, nxt))
    out["prefill"]["measured_ms"] = t["prefill_s"] * 1e3
    out["decode"]["measured_ms"] = t["decode_s"] * 1e3 / (t["max_new"] - 1)
    cost_cells[f"{cfg.name} prefill"], cost_cells[f"{cfg.name} decode"] = out["prefill"], \
        out["decode"]
    launches = {}
    for cell in out.values():
        for k, n in cell["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return launches


# the one-card cells: the name the card's counted step is kept under, the
# arch, the dry run's shape and its plan's overrides
COST_CELLS = (
    ("recurrentgemma-2b", "recurrentgemma-2b", ("train_1x3072", 3072, 1, "train"),
     {"remat": "block"}),
    ("musicgen-large", "musicgen-large", ("train_1x2048", 2048, 1, "train"),
     {"remat": "block"}),
    ("xlstm-1.3b", "xlstm-1.3b", ("train_1x2048", 2048, 1, "train"), {"remat": "block"}),
    ("qwen2-7b prefill", "qwen2-7b", ("prefill_4x512", 512, 4, "prefill"), {"max_len": 544}),
    ("qwen2-7b decode", "qwen2-7b", ("decode_4x544", 544, 4, "decode"), {}),
)
# the production cells: the dry run's arguments
PRODUCTION_CELLS = (
    ["--arch", "qwen2-7b", "--mesh", "single"],
    ["--arch", "recurrentgemma-2b", "--shape", "long_500k", "--mesh", "single"],
    ["--arch", "qwen3-moe-30b-a3b", "--shape", "train_4k", "--mesh", "multi", "--moe-ep"],
)


def cost_phase(torch, cost_cells: dict, out_dir: Path) -> None:
    """The cost tooling held to steps that ran on this card: each one-card
    cell dry-run on ``meta`` (``launch.dryrun.cell_record`` on a 1 x 1
    abstract mesh) against the same cell's counted step on the card. The
    FLOPs and the launches by kernel must be equal, the launches must be the
    exact counts, and the predicted peak within 10% of the card's; each
    cell's roofline bound is printed beside the measured time of the phase
    that timed it (the share of the bound it reached). Then the production
    cells on the 16 x 16 and 2 x 16 x 16 abstract meshes, every record
    ``ok``."""
    import dataclasses
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import cell_plan
    mesh = make_mesh((1, 1), ("data", "model"), ["meta"])
    for name, arch, shape_args, overrides in COST_CELLS:
        cfg, shape = get_config(arch), ShapeConfig(*shape_args)
        plan = cell_plan(cfg, shape, mesh)
        if "remat" in overrides:
            plan = dataclasses.replace(plan, tcfg=dataclasses.replace(
                plan.tcfg, remat=overrides["remat"]))
        if "max_len" in overrides:
            plan = dataclasses.replace(plan, max_len=overrides["max_len"])
        rec = dryrun.cell_record(cfg, shape, mesh, plan, "one card")
        if rec["status"] != "ok":
            raise AssertionError(f"dry run of {name}: {rec['error']}\n{rec['traceback']}")
        card = cost_cells[name]
        meta_k = {k: v["launches"] for k, v in rec["cost"]["kernel_detail"].items()}
        card_k = {k: v["launches"] for k, v in card["card"]["kernel_detail"].items()}
        peak, measured_peak = rec["memory"]["peak_bytes_est"], card["card_peak_bytes"]
        bound_ms = rec["roofline"]["bound_s"] * 1e3
        ideal_ms = max(rec["roofline"]["ideal_compute_s"], rec["roofline"]["ideal_memory_s"]) * 1e3
        emit({"phase": "cost", "cell": name, "shape": list(shape_args), "plan": rec["plan"],
              "flops_meta": rec["cost"]["flops"], "flops_card": card["card"]["flops"],
              "model_flops": rec["roofline"]["model_flops"],
              "hbm_bytes_meta": rec["cost"]["hbm_bytes"],
              "hbm_bytes_card": card["card"]["hbm_bytes"],
              "launches_meta": meta_k, "launches_card": card_k,
              "launches_exact": card["launches"],
              "peak_bytes_predicted": peak, "max_memory_allocated_bytes": measured_peak,
              "peak_ratio": peak / measured_peak, "roofline": rec["roofline"],
              "bound_ms": bound_ms, "measured_ms": card["measured_ms"],
              "roofline_share": bound_ms / card["measured_ms"], "ideal_ms": ideal_ms,
              "ideal_share": ideal_ms / card["measured_ms"], "trace_s": rec["trace_s"],
              "nvidia_smi": card_line()})
        if rec["cost"]["flops"] != card["card"]["flops"]:
            raise AssertionError(f"{name}: meta FLOPs {rec['cost']['flops']} != card "
                                 f"{card['card']['flops']}")
        if not meta_k == card_k == card["launches"]:
            raise AssertionError(f"{name}: launches meta {meta_k}, card {card_k}, "
                                 f"exact {card['launches']}")
        if abs(peak / measured_peak - 1) > 0.10:
            raise AssertionError(f"{name}: predicted peak {peak} vs {measured_peak}")
    if out_dir.exists():
        shutil.rmtree(out_dir)
    for i, argv in enumerate(PRODUCTION_CELLS):
        t0 = time.perf_counter()
        rc, out = quiet(dryrun.main, argv + ["--out", str(out_dir / str(i))])
        wall = time.perf_counter() - t0
        records = [json.loads(p.read_text()) for p in sorted((out_dir / str(i)).glob("*/*.json"))]
        for rec in records:
            emit({"phase": "cost_production", "arch": rec["arch"], "shape": rec["shape"],
                  "mesh": rec["mesh"], "mesh_shape": rec["mesh_shape"], "status": rec["status"],
                  "summary": dryrun.summary(rec), "trace_s": rec.get("trace_s"),
                  "peak_bytes_est": rec.get("memory", {}).get("peak_bytes_est"),
                  "fits_hbm": rec.get("fits_hbm"),
                  "collective_detail": rec.get("collective_detail"),
                  "roofline": rec.get("roofline"), "command_wall_s": wall})
        if rc != 0 or not records or any(r["status"] != "ok" for r in records):
            raise AssertionError(f"dry run {argv} exited {rc}:\n{out}")


def examples_phase(torch, out_dir: Path) -> dict:
    """``python -m repro_torch.examples.train_100m --preset 100m --steps 300``
    and ``quickstart --arch deepseek-7b --steps 5`` on the card, counted (the
    exact launches, plain versions raising); train_100m must exit 0 (its nll
    improved). Step ms, tokens/s and peak memory of train_100m."""
    import shutil
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.examples import quickstart, train_100m
    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    log = out_dir / "train_100m.json"
    runs = {}
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_on_card(launches):
        rc, out = quiet(train_100m.main, ["--preset", "100m", "--steps", "300", "--log", log])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = json.loads(log.read_text())
    expected = train_launches(train_100m.config("100m"), 300, True)
    step_ms = rows[-1]["elapsed_s"] * 1e3 / rows[-1]["step"] if rows[-1]["step"] else None
    emit({"phase": "examples", "example": "train_100m --preset 100m --steps 300", "rc": rc,
          "first_line": out.splitlines()[0], "last_line": out.strip().splitlines()[-1],
          "nll_first": rows[0]["nll"], "nll_last": rows[-1]["nll"],
          "step_ms": step_ms, "tokens_per_s": 4 * 256 / step_ms * 1e3 if step_ms else None,
          "wall_s": wall, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "expected_launches": expected})
    if rc != 0 or launches != expected:
        raise AssertionError(f"train_100m exited {rc}, launches {launches} != {expected}:\n{out}")
    runs["examples: train_100m --preset 100m (300 steps)"] = launches
    launches = {}
    with counted_on_card(launches):
        rc, out = quiet(quickstart.main, ["--arch", "deepseek-7b", "--steps", "5"])
        torch.cuda.synchronize()
    expected = train_launches(reduced_config(ARCHS["deepseek-7b"]), 5, True)
    lines = out.strip().splitlines()
    emit({"phase": "examples", "example": "quickstart --arch deepseek-7b --steps 5", "rc": rc,
          "lines": lines, "launches": launches, "expected_launches": expected})
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines[1:]]
    if rc != 0 or launches != expected or len(losses) != 5 or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"quickstart exited {rc}, launches {launches}:\n{out}")
    runs["examples: quickstart deepseek-7b reduced (5 steps)"] = launches
    return runs


def profile_training(torch, trainer) -> None:
    """torch.profiler over one more full-width step (after the counted
    ones): device busy and idle share, kernels by name, and device time by
    family: cuBLAS products, the port's kernels, everything else."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_steps(1)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    breakdown = _device_breakdown(torch, prof, wall_s, 1)
    us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total  # noqa: E731
    families = {"gemm": 0.0, "port_kernels": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            family = ("port_kernels" if re.search(PORT_KERNELS, e.key) else
                      "gemm" if re.search(GEMM_KERNELS, e.key) else "other")
            families[family] += us(e) / 1e3
    emit({"phase": "train_profile", "arch": trainer.cfg.name, "note": "profiler on: wall "
          "times include its recording overhead", "step": breakdown,
          "device_ms_by_family": families})


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
    peak = peaks(name)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_count": torch.cuda.device_count()})

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs)})
    print(_build.build_log().strip(), flush=True)
    build_report(libs)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flash_err = check_flash(torch, gen, dev)
    decode_err = check_decode(torch, gen, dev)
    mlstm_err = check_mlstm(torch, gen, dev)
    rglru_err, rglru_train_err = check_rglru(torch, gen, dev)
    slstm_err = check_slstm(torch, gen, dev)
    flash_t = measure_flash(torch, gen, dev, peak, 4, 512, 28, 4, 128)
    flash_rg_t = measure_flash(torch, gen, dev, peak, 4, 512, 10, 1, 256, window=2048)
    decode_t = measure_decode(torch, gen, dev, peak, 4, 28, 4, 544, 128, n_caches=16)
    decode_rg_t = measure_decode(torch, gen, dev, peak, 4, 10, 1, 544, 256, n_caches=48)
    # qwen3-moe-30b-a3b and gemma3-12b: prefill, its local layers past their
    # window, decode, and a wrapped 1024-slot ring (35 MB a cache, 4 rotate)
    flash_q3_t = measure_flash(torch, gen, dev, peak, 4, 512, 32, 4, 128)
    flash_g3_t = measure_flash(torch, gen, dev, peak, 4, 512, 16, 8, 256, window=1024)
    flash_g3w_t = measure_flash(torch, gen, dev, peak, 1, 1536, 16, 8, 256, window=1024)
    decode_q3_t = measure_decode(torch, gen, dev, peak, 4, 32, 4, 544, 128, n_caches=16)
    decode_g3_t = measure_decode(torch, gen, dev, peak, 4, 16, 8, 544, 256, n_caches=8)
    decode_g3r_t = measure_decode(torch, gen, dev, peak, 4, 16, 8, 1024, 256, n_caches=4,
                                  cur=1535)
    # musicgen-large: 32 heads over 32 kv heads at hd 64 (8.9 MB a cache,
    # 16 rotate)
    flash_mg_t = measure_flash(torch, gen, dev, peak, 4, 512, 32, 32, 64)
    decode_mg_t = measure_decode(torch, gen, dev, peak, 4, 32, 32, 544, 64, n_caches=16)
    decode_phases()
    mlstm_t = measure_mlstm(torch, gen, dev, peak)
    rglru_t = measure_rglru(torch, gen, dev, peak)
    rglru_train_t = measure_rglru(torch, gen, dev, peak, 1, 3072, 2560)
    slstm_t = measure_slstm(torch, gen, dev, peak, 4, 512, 4, 512)
    slstm_train_t = measure_slstm(torch, gen, dev, peak, 1, 2048, 4, 512)
    flash_bwd_err = check_flash_backward(torch, gen, dev)
    rglru_bwd_err = check_rglru_backward(torch, gen, dev)
    mlstm_bwd_err = check_mlstm_backward(torch, gen, dev)
    slstm_bwd_err = check_slstm_backward(torch, gen, dev)
    flash_bwd_t = measure_flash_backward(torch, gen, dev, peak, 1, 3072, 10, 1, 256, 2048)
    flash_bwd_qwen_t = measure_flash_backward(torch, gen, dev, peak, 4, 512, 28, 4, 128, 0)
    # musicgen-large's training shape, forward (SDPA beside) and backward
    flash_mg_train_t = measure_flash(torch, gen, dev, peak, 1, 2048, 32, 32, 64)
    flash_bwd_mg_t = measure_flash_backward(torch, gen, dev, peak, 1, 2048, 32, 32, 64, 0)
    rglru_bwd_t = measure_rglru_backward(torch, gen, dev, peak, 1, 3072, 2560)
    rglru_bwd_4_t = measure_rglru_backward(torch, gen, dev, peak, 4, 512, 2560)
    mlstm_bwd_t = measure_mlstm_backward(torch, gen, dev, peak)
    slstm_bwd_t = measure_slstm_backward(torch, gen, dev, peak)
    from repro_torch.kernels.queue_core import ops as queue_ops
    queue_err = check_queue(torch, dev)
    campaign_dir = ROOT / "build" / "chip_smoke_campaign"
    queue_launches = {"mix_tiny, traced": campaign_traced(torch, campaign_dir)}
    by_instance = {"mix_tiny, traced": dict(queue_ops.queue_flush.instance_launches)}
    queue_launches["full, shard 0/252"], *full_chunk = campaign_full_shard(torch, campaign_dir)
    by_instance["full, shard 0/252"] = dict(queue_ops.queue_flush.instance_launches)
    queue_launches.update(control_plane_tools(campaign_dir, campaign_dir / "traces"))
    set_192 = flush_tensors(torch, queue_sets()["piecewise_192"], dev)
    queue_full_t = measure_queue(torch, peak, "full, shard 0/252, first chunk", *full_chunk)
    queue_192_t = measure_queue(torch, peak, "piecewise_192", *set_192)
    queue_phases(torch, {"full, shard 0/252, first chunk": full_chunk,
                         "piecewise_192": set_192})
    queue_err = max(queue_err, queue_full_t.pop("max_abs_err"), queue_192_t.pop("max_abs_err"))
    for cfg, S in small_configs():
        check_small_model(torch, dev, cfg, S)

    launches = {}                               # kernel -> {run: launches}
    cost_cells = {}                             # one-card cost cell -> the card's counts
    for arch in ("qwen2-7b", "recurrentgemma-2b", "xlstm-1.3b", "qwen3-moe-30b-a3b",
                 "gemma3-12b"):
        for kernel, n in serve_reduced_defaults(torch, arch).items():
            if n:
                launches.setdefault(kernel, {})[f"{arch}, reduced (launcher defaults)"] = n
    for arch in ("qwen2-7b", "xlstm-1.3b", "recurrentgemma-2b", "qwen3-moe-30b-a3b",
                 "gemma3-12b"):
        served, report = serve_full_width(torch, arch)
        for kernel, n in served.items():
            if n:
                launches.setdefault(kernel, {})[arch] = n
        model = report["pool"].replicas[0].model
        if arch == "qwen2-7b":
            for kernel, n in serve_cost_cells(torch, model, report, cost_cells).items():
                launches.setdefault(kernel, {})[
                    "cost: qwen2-7b [4, 512] prefill + 1 decode step (counted)"] = n
        profiled = profile_serving(torch, model)
        if arch == "xlstm-1.3b":
            time_xlstm_blocks(torch, report["pool"])
        if model.cfg.moe is not None:
            t = report["timings"][-1]
            moe_decode_split(torch, model, peak, profiled["decode_step"],
                             t["decode_s"] * 1e3 / (t["max_new"] - 1))
            sampler_on_card(torch, profiled["prefill_logits"], arch)
        del report, profiled, model             # free the weights before the next
        gc.collect()
        torch.cuda.empty_cache()
    for kernel, n in serve_musicgen(torch, dev).items():
        if n:
            launches.setdefault(kernel, {})["musicgen-large (engine)"] = n
    gc.collect()
    torch.cuda.empty_cache()
    for kernel, n in orchestrator_phase(torch, ROOT / "build" / "chip_smoke_orchestrator").items():
        if n:
            launches.setdefault(kernel, {})[
                "orchestrator: recurrentgemma-2b serve + reduced trainer (4 steps)"] = n
    train_runs = {f"train_reduced {arch} (gradients + 3 steps)": train_reduced(
        torch, dev, arch, held, leaf_rtol) for arch, held, leaf_rtol in TRAIN_REDUCED}
    train_runs["train_launcher (4 + 2 + 6 steps)"] = train_launcher(
        torch, ROOT / "build" / "chip_smoke_train")
    full_width_losses = {}
    for arch, B, S, min_params, then in FULL_WIDTH_TRAINING:
        train_runs[f"train_full_width {arch} (4 steps)"], full_width_losses[arch] = \
            train_full_width(torch, dev, ROOT / "build" / "chip_smoke_train_full", arch, B, S,
                             min_params, then, cost_cells)
        if arch in cost_cells:
            train_runs[f"cost: {arch} (1 counted step)"] = cost_cells[arch]["launches"]
    train_runs["phoenix: recurrentgemma-2b serve + full-width trainer (4 steps, 1 resize)"] = \
        phoenix_phase(torch, ROOT / "build" / "chip_smoke_phoenix",
                      full_width_losses["recurrentgemma-2b"])
    cost_phase(torch, cost_cells, ROOT / "build" / "chip_smoke_dryrun")
    train_runs.update(examples_phase(torch, ROOT / "build" / "chip_smoke_examples"))
    for run, counts in train_runs.items():
        for kernel, n in counts.items():
            if n:
                launches.setdefault(kernel, {})[run] = n
    kernels = [
        kernel_row("flash_attention", "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:80",
                   flash_err[128], flash_t, launches["flash_attention"],
                   head_dim_256=shape_figures([4, 512, 10, 1, 256], flash_err[256],
                                              flash_rg_t),
                   max_abs_err_head_dim_16_64=[flash_err[16], flash_err[64]],
                   qwen3_moe=shape_figures([4, 512, 32, 4, 128], flash_err[
                       (4, 512, 32, 4, 128, 0)], flash_q3_t),
                   gemma3=shape_figures([4, 512, 16, 8, 256, "window 1024"], flash_err[
                       (4, 512, 16, 8, 256, 1024)], flash_g3_t),
                   gemma3_past_window=shape_figures(
                       [1, 1536, 16, 8, 256, "window 1024"],
                       flash_err[(1, 1536, 16, 8, 256, 1024)], flash_g3w_t),
                   musicgen=shape_figures([4, 512, 32, 32, 64], flash_err[
                       (4, 512, 32, 32, 64, 0)], flash_mg_t),
                   musicgen_training=shape_figures([1, 2048, 32, 32, 64], flash_err[
                       (1, 2048, 32, 32, 64, 0)], flash_mg_train_t)),
        kernel_row("decode_attention", "src/repro_torch/kernels/decode_attention/csrc/"
                   "decode_attention.cu", "src/repro/kernels/decode_attention/kernel.py:69",
                   decode_err[128], decode_t, launches["decode_attention"],
                   head_dim_256=shape_figures([4, 10, 1, 544, 256], decode_err[256],
                                              decode_rg_t),
                   max_abs_err_head_dim_16_64=[decode_err[16], decode_err[64]],
                   qwen3_moe=shape_figures([4, 32, 4, 544, 128], decode_err[
                       (4, 32, 4, 128, 544, 0)], decode_q3_t),
                   gemma3=shape_figures([4, 16, 8, 544, 256, "window 1024"], decode_err[
                       (4, 16, 8, 256, 544, 1024)], decode_g3_t),
                   gemma3_wrapped_ring=shape_figures(
                       [4, 16, 8, 1024, 256, "window 1024, position 1535"],
                       decode_err[(4, 16, 8, 256, 1024, 1024)], decode_g3r_t),
                   musicgen=shape_figures([4, 32, 32, 544, 64], decode_err[
                       (4, 32, 32, 64, 544, 0)], decode_mg_t)),
        kernel_row("mlstm_chunk", "src/repro_torch/kernels/mlstm_chunk/csrc/"
                   "mlstm_chunk.cu", "src/repro/kernels/mlstm_chunk/kernel.py:89",
                   mlstm_err, mlstm_t, launches["mlstm_chunk"]),
        kernel_row("rglru_scan", "src/repro_torch/kernels/rglru_scan/csrc/"
                   "rglru_scan.cu", "src/repro/kernels/rglru_scan/kernel.py:46",
                   rglru_err, rglru_t, launches["rglru_scan"],
                   training_shape=shape_figures([1, 3072, 2560], rglru_train_err,
                                                rglru_train_t)),
        kernel_row("queue_core", "src/repro_torch/kernels/queue_core/csrc/queue_core.cu",
                   "src/repro/workloads/queueing.py:598", queue_err, queue_full_t,
                   queue_launches, shape="full grid, shard 0/252, first chunk's flush",
                   launches_by_instance=by_instance,
                   replaces_all=["src/repro/workloads/queueing.py:491 (_device_fold)",
                                 "src/repro/workloads/queueing.py:556 (_kw_batched_core)",
                                 "src/repro/workloads/queueing.py:598 (_pw_batched_core)"],
                   replaces_kind="XLA programs (jit(vmap(lax.scan))), not Pallas",
                   piecewise_192=shape_figures("192 piecewise jobs, 7200 s", queue_err,
                                               queue_192_t)),
        kernel_row("flash_attention_backward", "src/repro_torch/kernels/flash_attention/"
                   "csrc/flash_attention_bwd.cu", "src/repro/models/attention.py:83",
                   flash_bwd_err[(1, 3072, 10, 1, 256)], flash_bwd_t,
                   launches["flash_attention_backward"],
                   replaces_kind="new: the JAX package differentiates chunked_causal_attention "
                                 "through XLA; no Pallas backward",
                   shape=[1, 3072, 10, 1, 256, "window 2048", "bf16"],
                   qwen2_heads=shape_figures([4, 512, 28, 4, 128], flash_bwd_err[
                       (4, 512, 28, 4, 128)], flash_bwd_qwen_t),
                   musicgen_training=shape_figures([1, 2048, 32, 32, 64], flash_bwd_err[
                       (1, 2048, 32, 32, 64)], flash_bwd_mg_t)),
        kernel_row("rglru_scan_backward", "src/repro_torch/kernels/rglru_scan/csrc/"
                   "rglru_scan.cu", "src/repro/models/rglru.py:68",
                   rglru_bwd_err[(1, 3072, 2560)], rglru_bwd_t,
                   launches["rglru_scan_backward"],
                   replaces_kind="new: the JAX package differentiates lax.associative_scan "
                                 "through XLA; no Pallas backward",
                   shape=[1, 3072, 2560, "float32"],
                   batch_4=shape_figures([4, 512, 2560], rglru_bwd_err[(4, 512, 2560)],
                                         rglru_bwd_4_t)),
        kernel_row("mlstm_chunk_backward", "src/repro_torch/kernels/mlstm_chunk/csrc/"
                   "mlstm_chunk_bwd.cu", "src/repro/models/xlstm.py:83",
                   mlstm_bwd_err[(1, 2048, 4, 512, 1024)], mlstm_bwd_t,
                   launches["mlstm_chunk_backward"],
                   replaces_kind="new: the JAX package differentiates mlstm_chunkwise "
                                 "through XLA; no Pallas backward",
                   shape=[1, 2048, 4, 512, 1024, "chunk 256", "bf16"]),
        kernel_row("slstm_scan", "src/repro_torch/kernels/slstm_scan/csrc/slstm_scan.cu",
                   "src/repro/models/xlstm.py:306", slstm_err["serving_prefill"], slstm_t,
                   launches["slstm_scan"],
                   replaces_kind="XLA program (lax.scan of _slstm_cell), not Pallas",
                   shape=[4, 512, 4, 512, "float32"],
                   training_shape=shape_figures([1, 2048, 4, 512], slstm_err["training"],
                                                slstm_train_t)),
        kernel_row("slstm_scan_backward", "src/repro_torch/kernels/slstm_scan/csrc/"
                   "slstm_scan.cu", "src/repro/models/xlstm.py:306",
                   slstm_bwd_err["training"], slstm_bwd_t, launches["slstm_scan_backward"],
                   replaces_kind="new: the JAX package differentiates the lax.scan of "
                                 "_slstm_cell through XLA; no Pallas backward",
                   shape=[1, 2048, 4, 512, "float32"]),
    ]
    emit({"phase": "done"})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
