"""The port's roofline (``repro_torch.cost.roofline``) against the JAX
package's (``repro.hlo.roofline``) on every arch × shape × mesh cell of the
dry run, with each cell's plan: ``model_flops``, ``_cache_bytes_global``
and ``mandatory_bytes_per_chip`` exactly equal, and ``score`` given the same
totals and JAX's hardware table (``hw=``) equal to 1e-12 relative. Also the
port's own table: the H100 figures the kernel bounds divide by."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.hlo import roofline as JR  # noqa: E402
from repro.launch import mesh as JM  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.cost import roofline as TR  # noqa: E402
from repro_torch.launch.mesh import HW  # noqa: E402

MESHES = {"single": ({"data": 16, "model": 16}, 256),
          "multi": ({"pod": 2, "data": 16, "model": 16}, 512)}


def _cells():
    for tag, (shape, devices) in sorted(MESHES.items()):
        mesh = types.SimpleNamespace(shape=shape)
        for arch in sorted(JC.ARCHS):
            for s in JC.shapes_for(JC.ARCHS[arch]):
                for tp in (-1, 0, 1):
                    yield arch, s.name, devices, JS.cell_plan(JC.ARCHS[arch], s, mesh,
                                                              tp=tp).as_dict()


CELLS = list(_cells())


def test_every_cell_is_scored():
    assert len(CELLS) == 2 * 33 * 3


@pytest.mark.parametrize("arch", sorted(JC.ARCHS))
def test_floors_match_jax(arch):
    for a, name, devices, plan in CELLS:
        if a != arch:
            continue
        j, t = JC.ARCHS[arch], TC.ARCHS[arch]
        js, ts = JC.SHAPES_BY_NAME[name], TC.SHAPES_BY_NAME[name]
        assert TR.model_flops(t, ts) == JR.model_flops(j, js)
        assert TR._cache_bytes_global(t, ts) == JR._cache_bytes_global(j, js)
        assert TR.mandatory_bytes_per_chip(t, ts, devices, plan) == \
            JR.mandatory_bytes_per_chip(j, js, devices, plan)


@pytest.mark.parametrize("arch", sorted(JC.ARCHS))
def test_score_matches_jax_given_the_same_totals(arch):
    rng = np.random.default_rng(0)
    for a, name, devices, plan in CELLS:
        if a != arch:
            continue
        totals = {"flops": float(rng.uniform(1e12, 1e16)),
                  "hbm_bytes": float(rng.uniform(1e9, 1e13)),
                  "collective_bytes": float(rng.uniform(0, 1e11)),
                  "collective_detail": {}}
        want = JR.score(JC.ARCHS[arch], JC.SHAPES_BY_NAME[name], devices, plan, totals)
        got = TR.score(TC.ARCHS[arch], TC.SHAPES_BY_NAME[name], devices, plan, totals,
                       hw=JM.HW)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if isinstance(v, str):
                assert got[k] == v, k
            else:
                assert got[k] == pytest.approx(v, rel=1e-12, abs=0.0), k


def test_default_table_is_the_h100s():
    """The port scores against the H100 SXM5 80GB's data sheet (700 W), not
    the JAX table's TPU figures."""
    assert (HW["peak_flops_bf16"], HW["hbm_bw"], HW["ici_bw"], HW["hbm_bytes"]) == \
        (989e12, 3.35e12, 450e9, 80e9)
    assert HW["peak_flops_fp32"] == 67e12
    cfg, shape = TC.ARCHS["qwen2-7b"], TC.SHAPES_BY_NAME["train_4k"]
    plan = {"fsdp": True, "tp": 1, "sequence_parallel": True}
    totals = {"flops": 989e12, "hbm_bytes": 3.35e12 / 2, "collective_bytes": 450e9 / 4}
    r = TR.score(cfg, shape, 256, plan, totals)
    assert (r["compute_s"], r["memory_s"], r["collective_s"]) == (1.0, 0.5, 0.25)
    assert r["dominant"] == "compute_s" and r["bound_s"] == 1.0
