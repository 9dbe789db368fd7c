"""The port's cell shapes, parameter counts, cell plans and abstract input
specs against the JAX package's, for all ten archs on every arch × shape ×
{16 × 16, 2 × 16 × 16} × tp ∈ {-1, 0, 1}. Exact equality: both are integer
arithmetic on the same config."""
import types

import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = sorted(JC.ARCHS)


def _jax_mesh(tag):
    """JAX's cell_plan reads only ``mesh.shape``: a stand-in with it."""
    shape, axes = MESHES[tag]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


def _port_mesh(tag):
    shape, axes = MESHES[tag]
    return make_mesh(shape, axes, ["meta"] * 512)


def test_the_port_has_the_ten_archs():
    assert sorted(TC.ARCHS) == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_shapes_match_jax(arch):
    j, t = JC.ARCHS[arch], TC.ARCHS[arch]
    for active in (False, True):
        assert t.param_count(active_only=active) == j.param_count(active_only=active)
    assert [vars(s) for s in TC.shapes_for(t)] == [vars(s) for s in JC.shapes_for(j)]
    assert {k: vars(v) for k, v in TC.SHAPES_BY_NAME.items()} == \
        {k: vars(v) for k, v in JC.SHAPES_BY_NAME.items()}
    for s in TC.ALL_SHAPES:
        assert s.tokens == JC.SHAPES_BY_NAME[s.name].tokens


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_plans_match_jax(arch, tag):
    j, t = JC.ARCHS[arch], TC.ARCHS[arch]
    jmesh, tmesh = _jax_mesh(tag), _port_mesh(tag)
    for shape in JC.shapes_for(j):
        tshape = TC.SHAPES_BY_NAME[shape.name]
        for tp in (-1, 0, 1):
            want = JS.cell_plan(j, shape, jmesh, tp=tp)
            got = TS.cell_plan(t, tshape, tmesh, tp=tp)
            assert got.as_dict() == want.as_dict(), (shape.name, tp)
            assert got.max_len == want.max_len
            assert vars(got.tcfg) == vars(want.tcfg)


_DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
           jnp.float32: torch.float32}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    j, t = JC.ARCHS[arch], TC.ARCHS[arch]
    for shape in JC.shapes_for(j):
        want = JS.input_specs(j, shape)
        got = TS.input_specs(t, TC.SHAPES_BY_NAME[shape.name])
        assert sorted(got) == sorted(want)
        for k, spec in want.items():
            assert tuple(got[k].shape) == tuple(spec.shape), k
            assert got[k].dtype == _DTYPES[spec.dtype.type], k
            assert got[k].device.type == "meta"


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_batch_shardings_match_jax(tag):
    from repro.sharding import partitioning as jpt
    from jax.sharding import PartitionSpec as P
    jmesh, tmesh = _jax_mesh(tag), _port_mesh(tag)
    for arch in ARCHS:
        j, t = JC.ARCHS[arch], TC.ARCHS[arch]
        for shape in JC.shapes_for(j):
            for tp in (0, 1):
                got = TS.batch_shardings(t, TC.SHAPES_BY_NAME[shape.name], tmesh, tp=tp)
                for k, v in JS.input_specs(j, shape).items():
                    want = P() if k == "cur_pos" else jpt.data_spec(jmesh, v.shape, tp=tp)
                    assert tuple(got[k]) == tuple(want), (arch, shape.name, k)
