"""The readings that the limits of ``correct`` are set from, on the card at a
cell's own size: the program's numbers on each seed and, with ``--control``,
the control's (the reference computed with every product's operands rounded
to float8 e4m3, the precision below the configuration's bf16, put in the
program's place). ``--fault half_batch`` also reads a training program that
takes half of each batch's rows and the mean over them. ``--program-only``
runs no reference: it reads the numbers the program gives alone
(``update_gap``) and each step's global gradient norm.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--control] \\
        [--fault half_batch] [--program-only] [--dump DIR] [--model JSON] [--traffic JSON]

One JSON line a seed, with each side's global gradient norm a step
(``global_norms``); ``--dump`` also writes every reading, leaf by leaf, and
``--model`` / ``--traffic`` change fields of the cell's model or mix (the
float32 witness: ``--model '{"param_dtype": "float32", "compute_dtype":
"float32"}' --traffic '{"batch": 1}'``). The benchmark's own runs do not run
this.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

import torch  # noqa: E402

from portbench.core import check, cli, registry, train, traffic  # noqa: E402
from portbench.core.run import Run  # noqa: E402
from portbench.reference.common import fp8_matmul  # noqa: E402


def values(prog, ref, run: Run) -> dict:
    return check.train_values(prog, ref, run.model["num_layers"], run.spec["grad_tail_layers"])


def program_readings(run: Run, batches, half: bool = False):
    """A trainer's checked steps; ``half``: each batch cut to its first half
    of rows where the program reads it (the fault)."""
    import repro_torch.runtime.elastic as elastic
    whole = elastic._global_batch

    def halved(job, step):
        return {k: t[: t.shape[0] // 2] for k, t in whole(job, step).items()}

    elastic._global_batch = halved if half else whole
    trainer = None
    try:
        with tempfile.TemporaryDirectory(prefix="portbench-ckpt-") as ckpt:
            trainer = train.trainer_for(run, batches, ckpt)
            readings = train.checked_steps(run, trainer)
            trainer.close()
    finally:
        elastic._global_batch = whole
    del trainer
    run.free()
    return readings


def dump(path, seed: int, **readings) -> None:
    """Every reading of a seed, leaf by leaf, as JSON under ``path``."""
    if path:
        Path(path).mkdir(parents=True, exist_ok=True)
        with open(Path(path) / f"readings-{seed}.json", "w") as f:
            json.dump({k: r._asdict() for k, r in readings.items()}, f)


def train_seed(run: Run, control: bool, faults, program_only: bool, dump_to: str = "") -> dict:
    batches = traffic.train_batches(run.traffic, run.model, run.seed, run.device)
    t = [time.perf_counter()]
    prog = program_readings(run, batches)
    extra = {f: program_readings(run, batches, half=True) for f in faults}
    t.append(time.perf_counter())
    out = {"program_s": t[1] - t[0],
           "global_norms": {"program": prog.global_norms,
                            **{f: r.global_norms for f, r in extra.items()}}}
    if program_only:
        out["program"] = {"update_gap": prog.update_gap}
        out.update({f: {"update_gap": r.update_gap} for f, r in extra.items()})
        dump(dump_to, run.seed, program=prog, **extra)
        return out
    ref = train.reference_readings(run, batches)
    t.append(time.perf_counter())
    out.update(program=values(prog, ref, run), reference_s=t[2] - t[1])
    out["global_norms"]["reference"] = ref.global_norms
    for f, readings in extra.items():
        out[f] = values(readings, ref, run)
    if control:
        ref8 = train.reference_readings(run, batches, mm=fp8_matmul)
        out["control"] = values(ref8, ref, run)
        out["global_norms"]["control"] = ref8.global_norms
        out["control_s"] = time.perf_counter() - t[2]
    dump(dump_to, run.seed, program=prog, reference=ref, **extra,
         **({"control": ref8} if control else {}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", action="append", default=[], choices=("half_batch",))
    ap.add_argument("--program-only", action="store_true", help="run no reference")
    ap.add_argument("--dump", default="", help="a directory for every reading, leaf by leaf")
    ap.add_argument("--model", default="{}", help="JSON of fields to change in the model")
    ap.add_argument("--traffic", default="{}", help="JSON of fields to change in the mix")
    args = ap.parse_args()
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    device = cli.chips(cell.entry["chips"])
    if device is None:
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = Run(bench, cell, seed, 0.0, False, device, t0,
                  model={**cell.model, **json.loads(args.model)},
                  traffic={**cell.traffic, **json.loads(args.traffic)})
        out = train_seed(run, args.control, args.fault, args.program_only, args.dump)
        run.free()
        out.update(seed=seed, wall_s=time.perf_counter() - t0,
                   peak_bytes=int(torch.cuda.max_memory_allocated(device)))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
