"""Port parity for the sharding rules: ``repro_torch.sharding.partitioning``
against ``repro.sharding.partitioning``, leaf for leaf, for every arch of
``ARCHS`` at its published widths on three fake meshes (only ``.shape`` is
read, as ``tests/test_partitioning.py`` does).

The JAX shapes come from ``jax.eval_shape`` (no weights drawn); the port's
params tree from ``param_shape_tree`` of a ``CausalLM`` on the meta device,
which must equal JAX's tree shape for shape. Specs are compared as tuples
(``PartitionSpec`` and the port's ``Spec`` entries: an axis name, ``None``
or a tuple of names); they must be equal, with no tolerance.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding import partitioning as jpt  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models.model import CausalLM  # noqa: E402
from repro_torch.sharding import partitioning as pt  # noqa: E402

ARCHS = sorted(TC.ARCHS)
MESHES = {"16x16": {"data": 16, "model": 16}, "4x2": {"data": 4, "model": 2},
          "8x1": {"data": 8, "model": 1}}
# (fsdp, tp) of each param layout; "ep" turns expert parallelism on (MoE archs)
LAYOUTS = {"tp": (False, 0), "fsdp": (True, 0), "tp1": (False, 1),
           "fsdp_tp1": (True, 1), "ep": (True, 0)}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _flat(tree, leaf=lambda x: x, is_leaf=None):
    return {_path(p): leaf(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _specs(tree):
    return _flat(tree, tuple, lambda x: isinstance(x, PartitionSpec))


def _ep(cfg):
    return cfg.with_(moe=dataclasses.replace(cfg.moe, expert_parallel=True))


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch: str, ep: bool):
    cfg = JC.ARCHS[arch]
    cfg = _ep(cfg) if ep else cfg
    return cfg, jax.eval_shape(lambda k: JM.init_params(k, cfg), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_shapes(arch: str, ep: bool):
    cfg = TC.ARCHS[arch]
    cfg = _ep(cfg) if ep else cfg
    return cfg, pt.param_shape_tree(CausalLM(cfg, device="meta"))


def _cases():
    for arch in ARCHS:
        for mesh in MESHES:
            for layout in LAYOUTS:
                if layout != "ep" or TC.ARCHS[arch].moe is not None:
                    yield arch, mesh, layout


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shape_tree_is_the_jax_tree(arch):
    _, jshapes = _jax_shapes(arch, False)
    _, tree = _port_shapes(arch, False)
    assert tree == _flat(jshapes, lambda s: tuple(s.shape))


@pytest.mark.parametrize("arch,mesh,layout", list(_cases()))
def test_param_specs_match_jax(arch, mesh, layout):
    fsdp, tp = LAYOUTS[layout]
    ep = layout == "ep"
    m = FakeMesh(MESHES[mesh])
    jcfg, jshapes = _jax_shapes(arch, ep)
    tcfg, tree = _port_shapes(arch, ep)
    want = _specs(jpt.param_specs(jshapes, jcfg, m, fsdp=fsdp, tp=tp))
    got = pt.param_specs(tree, tcfg, m, fsdp=fsdp, tp=tp)
    assert all(isinstance(s, pt.Spec) for s in got.values())
    assert {k: tuple(v) for k, v in got.items()} == want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_zero1_specs_match_jax(arch, mesh):
    m = FakeMesh(MESHES[mesh])
    jcfg, jshapes = _jax_shapes(arch, False)
    tcfg, tree = _port_shapes(arch, False)
    jz = jpt.zero1_specs(jpt.param_specs(jshapes, jcfg, m), jshapes, m)
    tz = pt.zero1_specs(pt.param_specs(tree, tcfg, m), tree, m)
    want = _specs(jz)
    assert {k: tuple(v) for k, v in tz.items()} == want
    # the dim the port's trainer cuts m, v and master along
    for k, spec in tz.items():
        d = pt.data_dim(spec)
        assert d == next((i for i, a in enumerate(want[k]) if a == "data"), None), k


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("tp", [0, 1])
def test_cache_specs_match_jax(arch, mesh, tp):
    m = FakeMesh(MESHES[mesh])
    jcfg, tcfg = JC.ARCHS[arch], TC.ARCHS[arch]
    cache = JM.init_cache(jcfg, 128, 32768, abstract=True)
    tree = _flat(cache, lambda s: tuple(s.shape))
    want = _specs(jpt.cache_specs(cache, jcfg, m, tp=tp))
    got = pt.cache_specs(tree, tcfg, m, tp=tp)
    assert {k: tuple(v) for k, v in got.items()} == want


@pytest.mark.parametrize("shape", [(256, 128), (512, 128), (48, 128), (8, 16), (3, 5),
                                   (7, 32, 4)])
@pytest.mark.parametrize("tp", [0, 1])
@pytest.mark.parametrize("mesh", [{"pod": 2, "data": 16, "model": 16},
                                  {"data": 4, "model": 2}, {"data": 8, "model": 1}])
def test_data_spec_and_dp_size_match_jax(shape, tp, mesh):
    m = FakeMesh(mesh)
    for batch_dim in range(len(shape)):
        want = jpt.data_spec(m, shape, batch_dim=batch_dim, tp=tp)
        got = pt.data_spec(m, shape, batch_dim=batch_dim, tp=tp)
        assert tuple(got) == tuple(want)
    assert pt.batch_axes(m, tp) == jpt.batch_axes(m, tp)
    assert pt.dp_size(m, tp) == jpt.dp_size(m, tp)


def test_spec_names_its_axes():
    s = pt.Spec(("data", "model"), None, "model")
    assert s.axes() == {"data", "model"} and tuple(s) == (("data", "model"), None, "model")
    assert pt.data_dim(s) == 0 and pt.data_dim(pt.Spec(None, "model")) is None
    assert repr(pt.Spec("data", None)) == "Spec('data', None)"
