"""FSDP in the port's data-parallel step, and the collectives the cost
counter sees on real ranks.

Four ``gloo`` CPU ranks of a 2 x 2 mesh train three steps in the dry run's
training layout (``tp=1``: pure FSDP over both axes; ``fsdp_ranks.main``)
from the JAX initial checkpoint, for qwen2-7b and qwen3-moe-30b-a3b reduced
and widened to d_model 256 (at the reduced width of 64 no leaf reaches the
FSDP spec's 65,536 elements). Held to:

* the JAX trainer on one device (``make_train_step``, the MoE's four token
  groups one a rank): losses within 1e-5, grad norms within 1e-5 relative;
* each rank stores a quarter of every leaf the FSDP spec cuts, and every
  other leaf whole;
* ``state_leaves`` gathers the checkpoint an unsharded run of the port
  writes (one device, the same steps): every leaf within 1e-5 of its
  largest magnitude (float32 sums over ranks add in another order).

And the dry run's collective bytes for a reduced tensor-parallel step on an
abstract 2 x 2 mesh equal what rank 0 of four ``gloo`` ranks sends in the
same step (model group 2, ZeRO-1), counted by the same counter on CPU
tensors: the same code issues them.
"""
import dataclasses
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.checkpoint import checkpointer as jckpt  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.training import train_step as JS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import checkpointer as ckpt  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402

B, S, N = 8, 32, 4
TOL = 1e-5
ARCHS = {"qwen2": "qwen2-7b", "moe": "qwen3-moe-30b-a3b"}
WIDE = dict(d_model=256, d_ff=512, head_dim=64)


def _cfgs(name, **change):
    arch = ARCHS[name]
    return (JC.reduced_config(JC.ARCHS[arch]).with_(**change),
            TC.reduced_config(TC.get_config(arch)).with_(**change))


def _spawn(mode, cfg, tcfg, init_dir, out, tmp):
    import fsdp_ranks
    from repro_torch.runtime.elastic import process_context
    ctx = process_context()
    store = str(tmp / f"store_{mode}")
    procs = [ctx.Process(target=fsdp_ranks.main,
                         args=(r, N, store, mode, cfg, tcfg, B, S, str(init_dir), str(out)))
             for r in range(N)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 240
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    return [json.loads(open(f"{out}.{r}").read()) for r in range(N)]


@pytest.fixture(scope="module", params=sorted(ARCHS))
def fsdp_run(request, tmp_path_factory):
    name = request.param
    jcfg, cfg = _cfgs(name, **WIDE)
    tmp = tmp_path_factory.mktemp(name)
    jstate = JS.init_state(jax.random.PRNGKey(0), jcfg)
    jckpt.save(str(tmp / "init"), jstate, step=0)
    ranks = _spawn("fsdp", cfg, TrainConfig(), tmp / "init", tmp / "fsdp", tmp)
    step = jax.jit(JS.make_train_step(jcfg, JTrainConfig(), moe_groups=N))
    data = JSyntheticLM(jcfg, seed=0)
    want = []
    for i in range(3):
        jstate, m = step(jstate, data.batch(i, B, S))
        want.append({k: float(v) for k, v in m.items()})
    one = convert.state_from_leaves(ckpt.restore(str(tmp / "init")), cfg, "cpu")
    tstep = make_train_step(cfg, TrainConfig(), moe_groups=N)
    tdata = SyntheticLM(cfg, seed=0)
    for i in range(3):
        one, _ = tstep(one, tdata.batch(i, B, S))
    return {"name": name, "cfg": cfg, "ranks": ranks, "jax": want,
            "gathered": torch.load(f"{tmp / 'fsdp'}.leaves"),
            "unsharded": convert.state_leaves(one)}


def test_fsdp_losses_and_norms_match_jax_on_one_device(fsdp_run):
    for got in (r["metrics"] for r in fsdp_run["ranks"]):
        assert len(got) == len(fsdp_run["jax"]) == 3
        for g, w in zip(got, fsdp_run["jax"]):
            assert abs(g["loss"] - w["loss"]) <= TOL, (g, w)
            assert abs(g["nll"] - w["nll"]) <= TOL, (g, w)
            assert abs(g["grad_norm"] - w["grad_norm"]) <= TOL * w["grad_norm"], (g, w)


def test_each_rank_stores_a_quarter_of_every_cut_leaf(fsdp_run):
    from repro_torch.models import model as M
    from repro_torch.sharding import partitioning as pt
    from repro_torch.launch.mesh import make_mesh
    cfg = fsdp_run["cfg"]
    whole = M.CausalLM(cfg, device="meta")
    shapes = pt.param_shape_tree(whole)
    specs = pt.param_specs(shapes, cfg, make_mesh((2, 2), ("data", "model"), ["meta"] * 4),
                           fsdp=True, tp=1)
    cut = {k for k, s in specs.items() if pt.data_dim(s) is not None}
    assert cut, "no leaf is cut: the test config is too narrow"
    for r in fsdp_run["ranks"]:
        assert sorted(r["fsdp_leaves"]) == sorted(k.replace("/", ".") for k in cut)
        for name, p in whole.named_parameters():
            key = M.jax_leaf(name, cfg)[0].replace(".", "/")
            n = int(np.prod(r["shapes"][name]))
            assert n * (N if key in cut else 1) == p.numel(), (name, r["shapes"][name])


def test_state_leaves_gathers_the_unsharded_checkpoint(fsdp_run):
    got, want = fsdp_run["gathered"], fsdp_run["unsharded"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        scale = max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= TOL * scale, k


def test_dry_run_collective_bytes_equal_what_real_ranks_send(tmp_path):
    """A reduced qwen2-7b step with a model group of 2 (the elastic
    trainer's layout) on 4 gloo ranks, counted on CPU tensors, against the
    dry run's count on an abstract 2 x 2 mesh with the same plan."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import cell_plan
    jcfg, cfg = _cfgs("qwen2")
    jckpt.save(str(tmp_path / "init"), JS.init_state(jax.random.PRNGKey(0), jcfg), step=0)
    mesh = make_mesh((2, 2), ("data", "model"), ["meta"] * 4)
    shape = ShapeConfig("train_reduced", S, B, "train")
    plan = cell_plan(cfg, shape, mesh, tp=0)
    assert not plan.fsdp and plan.tp == 0
    rec = dryrun.cell_record(cfg, shape, mesh, plan)
    assert rec["status"] == "ok", rec.get("traceback")
    ranks = _spawn("tp", cfg, plan.tcfg, tmp_path / "init", tmp_path / "tp", tmp_path)
    assert rec["collective_detail"] == ranks[0]["collective_detail"]
    assert set(rec["collective_detail"]) >= {"all-reduce", "all-gather", "reduce-scatter"}
    assert rec["cost"]["collective_bytes"] == sum(ranks[0]["collective_detail"].values())


def test_fsdp_on_an_abstract_mesh_gathers_each_layer_again_under_remat():
    """On meta, the dry run's layout: every cut leaf is gathered in the
    forward, again in the recomputation, and its gradient reduce-scattered
    once."""
    from repro_torch.cost.analysis import CostCounter
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import cell_plan
    _, cfg = _cfgs("qwen2", **WIDE)
    mesh = make_mesh((2, 2), ("data", "model"), ["meta"] * 4)
    shape = ShapeConfig("train_reduced", S, B, "train")
    out = {}
    for remat in ("none", "full"):
        plan = cell_plan(cfg, shape, mesh)
        plan = dataclasses.replace(plan, tcfg=dataclasses.replace(plan.tcfg, remat=remat))
        assert plan.fsdp and plan.tp == 1
        with CostCounter():
            rec = dryrun.cell_record(cfg, shape, mesh, plan)
        assert rec["status"] == "ok", rec.get("traceback")
        out[remat] = rec["collective_detail"]
    # the layers' weights are gathered twice under remat; the head and the
    # embedding (outside the rematted layers) once either way
    assert out["full"]["all-gather"] > out["none"]["all-gather"]
    assert out["full"]["reduce-scatter"] == out["none"]["reduce-scatter"]
