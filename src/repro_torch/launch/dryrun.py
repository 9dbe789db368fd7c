"""Dry run: count one rank's step of every (arch x shape x mesh) cell
(counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both

It runs on the ``meta`` device by its nature: no card, no CPU tensor, no
world. For each cell it builds rank 0's cut of the model on an abstract
mesh of ``--devices`` meta devices (``launch.mesh.make_mesh``), with the
plan of ``launch.specs.cell_plan`` (FSDP, microbatching, remat, sequence
parallelism, MoE groups; ``--moe-ep`` for expert parallelism), and runs one
train step (``training.data_parallel.make_sharded_step``; on a mesh of one
device ``training.train_step.make_train_step``, as the trainer does),
prefill or decode step on the rank's rows under the cost counter
(``cost.analysis``). The collectives send nothing and are counted; the
kernels' wrappers give outputs of their shapes and count their work.

Each cell writes ``<out>/<mesh>/<arch>__<shape><tag>.json`` with the JAX
record's keys where they mean the same (``arch``, ``shape``, ``mesh``,
``mesh_shape``, ``devices``, ``plan``, ``status``, ``memory.peak_bytes_est``,
``fits_hbm`` against ``launch.mesh.HW``'s 80 GB, ``collective_detail``,
``roofline``), the counts under ``cost`` and ``trace_s`` (the counted
step's wall) in place of ``lower_s`` and ``compile_s``. There is no HLO, so
the JAX flag ``--no-hlo`` has no counterpart. A cell that fails is recorded
with ``status: "error"`` and the run exits 1.

The step is the port's program: a rank of a model group serving holds the
KV heads its query heads read (every head where they do not divide the
group) and its whole cache length, and the MoE routes a prefill's tokens as
one group. An xLSTM training step counts the mLSTM's forward and backward
kernels (``mlstm_chunk``, ``mlstm_chunk_backward``) by their formulas.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ARCHS, SHAPES_BY_NAME, shapes_for
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.cost.analysis import CostCounter
from repro_torch.cost.roofline import score
from repro_torch.launch.mesh import HW, Mesh, make_mesh
from repro_torch.launch.specs import CellPlan, cell_plan, input_specs
from repro_torch.models import model as M
from repro_torch.serving.engine import make_decode_fn, make_prefill_fn
from repro_torch.sharding import partitioning as pt
from repro_torch.training import data_parallel as dp
from repro_torch.training.train_step import make_train_step, train_state


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Dry run on the meta device: count one rank's step of every "
                    "(arch x shape x mesh) cell; record memory/cost/roofline.")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--devices", type=int, default=512,
                    help="meta devices of the abstract mesh")
    ap.add_argument("--mesh-shape", default="",
                    help="override mesh, e.g. '2,4' or '2,2,4' (test-scale)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--sequence-parallel", default="",
                    help="force on/off (hillclimb experiments)")
    ap.add_argument("--fsdp", default="", help="force on/off")
    ap.add_argument("--remat", default="", help="override remat policy")
    ap.add_argument("--moe-ep", action="store_true",
                    help="expert-parallel MoE (all-to-all dispatch)")
    ap.add_argument("--microbatch", type=int, default=-1,
                    help="override gradient-accumulation count (-1 = plan)")
    ap.add_argument("--tp", type=int, default=-1,
                    help="-1=auto (train: pure-FSDP, serve: TP); "
                         "0=force model-axis TP; 1=force pure FSDP")
    ap.add_argument("--tag", default="", help="suffix for result files")
    return ap


def mesh_for(tag: str, args) -> Mesh:
    """The abstract mesh of a cell: ``--mesh-shape`` or the production
    16 x 16 (``single``) / 2 x 16 x 16 (``multi``), over ``--devices``
    meta devices."""
    devices = ["meta"] * args.devices
    if args.mesh_shape:
        dims = tuple(int(x) for x in args.mesh_shape.split(","))
        if tag == "multi":
            if len(dims) != 3:
                raise ValueError("multi mesh override needs 3 dims")
            return make_mesh(dims, ("pod", "data", "model"), devices)
        return make_mesh(dims[-2:], ("data", "model"), devices)
    if tag == "multi":
        return make_mesh((2, 16, 16), ("pod", "data", "model"), devices)
    return make_mesh((16, 16), ("data", "model"), devices)


def plan_for(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, args) -> CellPlan:
    """``cell_plan`` with the command line's overrides."""
    plan = cell_plan(cfg, shape, mesh, tp=args.tp)
    tcfg = plan.tcfg
    if args.sequence_parallel:
        tcfg = dataclasses.replace(tcfg, sequence_parallel=args.sequence_parallel == "on")
    if args.remat:
        tcfg = dataclasses.replace(tcfg, remat=args.remat)
    if args.microbatch >= 0:
        tcfg = dataclasses.replace(tcfg, microbatch=args.microbatch)
    plan = dataclasses.replace(plan, tcfg=tcfg)
    if args.fsdp:
        plan = dataclasses.replace(plan, fsdp=args.fsdp == "on")
    return plan


def _rank_inputs(cfg, shape: ShapeConfig, mesh: Mesh, tp: int):
    """Rank 0's block of each input (the batch dim over ``data_spec``'s
    axes), the batch's group and its size."""
    out, axes = {}, None
    for name, t in input_specs(cfg, shape).items():
        if t.dim() == 0:
            out[name] = t
            continue
        axes = pt.data_spec(mesh, tuple(t.shape), tp=tp)[0]
        size = 1 if axes is None else pt._block(axes, mesh.coords(), mesh.shape)[0]
        out[name] = torch.empty((t.shape[0] // size,) + tuple(t.shape[1:]), dtype=t.dtype,
                                device="meta")
    return out, None if axes is None else mesh.group(axes), size


def _model_parallel(cfg, mesh: Mesh, plan: CellPlan, train: bool) -> pt.ModelParallel:
    ep = cfg.moe is not None and cfg.moe.expert_parallel and mesh.shape["data"] > 1
    if plan.tp == 0 and mesh.shape["model"] > 1:
        return pt.model_parallel(mesh, sequence_parallel=train and plan.tcfg.sequence_parallel,
                                 expert_parallel=ep)
    if ep:
        return pt.ModelParallel(data_group=mesh.group("data"), data_size=mesh.shape["data"],
                                data_rank=mesh.coords()["data"])
    return pt.NONE


def _rank_model(cfg, mesh: Mesh, plan: CellPlan, mp, zero1: bool):
    """Rank 0's model on meta, cut over the model group and (``plan.fsdp``)
    FSDP-cut, and its leaf layout."""
    model = M.CausalLM(cfg, device="meta", mp=mp)
    layout = dp.leaf_layout(model, mesh, zero1, fsdp=plan.fsdp, tp=plan.tp)
    if plan.fsdp:
        layout = dp.fsdp_layout(model, layout, mesh)
    return model, layout


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, plan: CellPlan) -> dict:
    """Rank 0's step of the cell on meta under the cost counter; its totals."""
    tcfg = plan.tcfg
    ins, group, dp_size = _rank_inputs(cfg, shape, mesh, plan.tp)
    if shape.kind == "train":
        if mesh.size == 1:
            state = train_state(M.CausalLM(cfg, device="meta"))
            step = make_train_step(cfg, tcfg, moe_groups=plan.moe_groups)
        else:
            if plan.tp == 0 and "pod" in mesh.shape:
                raise NotImplementedError("model-axis TP training over pods: the port's "
                                          "data group is the data axis alone")
            mp = _model_parallel(cfg, mesh, plan, train=True)
            model, layout = _rank_model(cfg, mesh, plan, mp, tcfg.zero1)
            rest = None
            if mp.data_size > 1 and dp_size > mp.data_size:
                rest = mesh.group("model")
            index = 0 if group is None else group.rank
            comm = dp.Comm(group, dp_size, index, mesh, mp, rest)
            state = dp.fresh_state(model, layout, comm)
            step = dp.make_sharded_step(cfg, tcfg, layout, comm)
        with CostCounter(live=(state, ins)) as c:
            step(state, ins)
        return c.totals()
    mp = _model_parallel(cfg, mesh, plan, train=False)
    model, _ = _rank_model(cfg, mesh, plan, mp, False)
    with torch.no_grad():
        if shape.kind == "prefill":
            fn = make_prefill_fn(cfg, max_len=plan.max_len)
            with CostCounter(live=(model, ins)) as c:
                fn(model, ins["batch_in"])
            return c.totals()
        # decode: caches of the cell's length, filled by a one-token prefill
        tokens = ins["tokens"]
        _, caches = M.prefill(model, tokens, max_len=plan.max_len)
        fn = make_decode_fn(cfg)
        with CostCounter(live=(model, caches, tokens)) as c:
            fn(model, caches, tokens, plan.max_len - 1)
        return c.totals()


def cell_record(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, plan: CellPlan,
                mesh_tag: str = "single") -> dict:
    """The record of one cell (``status`` ``"error"`` with the exception
    where it fails)."""
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_tag,
           "mesh_shape": dict(mesh.shape), "devices": mesh.size,
           "plan": plan.as_dict(), "status": "ok"}
    t0 = time.perf_counter()
    try:
        totals = trace_cell(cfg, shape, mesh, plan)
        rec["trace_s"] = round(time.perf_counter() - t0, 3)
        rec["memory"] = {"peak_bytes_est": totals["peak_bytes"]}
        rec["fits_hbm"] = totals["peak_bytes"] <= HW["hbm_bytes"]
        rec["cost"] = {k: v for k, v in totals.items() if k != "collective_detail"}
        rec["collective_detail"] = totals["collective_detail"]
        rec["roofline"] = score(cfg, shape, mesh.size, rec["plan"], totals)
    except Exception as e:  # noqa: BLE001 — the sweep survives a cell's failure
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def run_cell(arch: str, shape_name: str, mesh_tag: str, args) -> dict:
    cfg = ARCHS[arch]
    if args.moe_ep and cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, expert_parallel=True))
    shape = SHAPES_BY_NAME[shape_name]
    mesh = mesh_for(mesh_tag, args)
    return cell_record(cfg, shape, mesh, plan_for(cfg, shape, mesh, args), mesh_tag)


def summary(rec: dict) -> str:
    """The sweep's line for one record."""
    if rec["status"] != "ok":
        return f"  ERROR {rec['error']}"
    r = rec["roofline"]
    return (f"  ok trace={rec['trace_s']}s "
            f"peak={rec['memory']['peak_bytes_est'] / 1e9:.2f}GB "
            f"dom={r['dominant']} frac={r['roofline_fraction']:.3f}")


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    archs = sorted(ARCHS) if args.arch == "all" else args.arch.split(",")
    mesh_tags = {"single": ["single"], "multi": ["multi"],
                 "both": ["single", "multi"]}[args.mesh]
    failures = 0
    for mesh_tag in mesh_tags:
        os.makedirs(os.path.join(args.out, mesh_tag), exist_ok=True)
        for arch in archs:
            cfg = ARCHS[arch]
            names = [s.name for s in shapes_for(cfg)] if args.shape == "all" \
                else [s for s in args.shape.split(",")
                      if s in {x.name for x in shapes_for(cfg)}]
            for shape_name in names:
                path = os.path.join(args.out, mesh_tag,
                                    f"{arch}__{shape_name}{args.tag}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {mesh_tag} {arch} {shape_name}", flush=True)
                    continue
                print(f"[cell] {mesh_tag} {arch} {shape_name} ...", flush=True)
                rec = run_cell(arch, shape_name, mesh_tag, args)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(summary(rec), flush=True)
                failures += rec["status"] != "ok"
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
