"""Rank processes of ``test_torch_fsdp``: one rank of a 2 x 2 ``gloo`` mesh
training a config from a JAX initial checkpoint. Imports nothing of JAX,
so that a rank starts fast.

* ``fsdp``: the dry run's training layout (``tp=1``: pure FSDP over both
  axes, no tensor parallelism); each rank stores its cut of every leaf the
  spec cuts, gathers it before the layer that reads it, and keeps m, v and
  the master on the same cut. Three steps; the metrics, every parameter's
  stored shape and (rank 0) the gathered checkpoint leaves are written.
* ``tp``: the elastic trainer's layout with a model group of 2 (tensor
  parallelism, ZeRO-1), one step counted by the cost counter on CPU
  tensors; rank 0 writes its collective bytes.
"""
import json

import torch
import torch.distributed as dist


def main(rank, n, store, mode, cfg, tcfg, batch, seq, init_dir, out):
    from repro_torch import convert
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.cost.analysis import CostCounter
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import partitioning as pt
    from repro_torch.training import data_parallel as dp
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * n)
        leaves = ckpt.restore(init_dir)
        params = convert.leaf_tree(leaves, ".params/")
        data = SyntheticLM(cfg, seed=0)
        if mode == "fsdp":
            model = convert.model_from_tree(params, cfg, "cpu", pt.NONE)
            layout = dp.leaf_layout(model, mesh, tcfg.zero1, fsdp=True, tp=1)
            layout = dp.fsdp_layout(model, layout, mesh)
            comm = dp.Comm(mesh.group(("data", "model")), n, rank, mesh, pt.NONE)
        else:
            mp = pt.model_parallel(mesh, sequence_parallel=tcfg.sequence_parallel)
            model = convert.model_from_tree(params, cfg, "cpu", mp)
            layout = dp.leaf_layout(model, mesh, tcfg.zero1)
            comm = dp.Comm(mesh.group("data"), 2, mesh.coords()["data"], mesh, mp)
        state = dp.fresh_state(model, layout, comm)
        step = dp.make_sharded_step(cfg, tcfg, layout, comm)
        rows = dp.rank_rows(batch, tcfg.microbatch, comm)
        result = {"shapes": {name: list(p.shape) for name, p in model.named_parameters()},
                  "fsdp_leaves": [leaf.key for leaf in layout if leaf.fsdp],
                  "metrics": []}
        for i in range(3 if mode == "fsdp" else 1):
            b = {k: t[rows] for k, t in data.batch(i, batch, seq).items()}
            if mode == "tp":
                with CostCounter() as c:
                    state, m = step(state, b)
                result["collective_detail"] = c.totals()["collective_detail"]
            else:
                state, m = step(state, b)
            result["metrics"].append({k: float(v) for k, v in m.items()})
        if mode == "fsdp":
            gathered = dp.state_leaves(state, layout, comm, keep=rank == 0)
            if rank == 0:
                torch.save(gathered, f"{out}.leaves")
        with open(f"{out}.{rank}", "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
