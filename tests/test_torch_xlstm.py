"""Port parity: the port's xLSTM blocks vs repro.models.xlstm on the reduced
xlstm-1.3b config, float32, CPU, with the JAX block parameters (biases,
conv_b and out_scale made random and non-zero) loaded by leaf name.

MLSTMBlock prefill (h through the plain mlstm_chunk, the cache's final
state and conv rows) and decode steps, and SLSTMBlock forward and decode
steps, are compared at atol 1e-4 (float32, sums in another order). The
port's own chunkwise-vs-stepwise check mirrors tests/test_kernels.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.models.layers import activation as jax_activation  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402

ATOL = 1e-4
JCFG = JC.reduced_config(JC.ARCHS["xlstm-1.3b"])
TCFG = TC.reduced_config(TC.get_config("xlstm-1.3b"))


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _block(kind: str, seed: int):
    """(JAX params, port module) of one block, same weights."""
    init = JX.init_mlstm_block if kind == "mlstm" else JX.init_slstm_block
    rng = np.random.default_rng(seed)
    params = jax.device_get(init(jax.random.PRNGKey(seed), JCFG, jnp.float32))

    def fill(path, leaf):
        leaf = np.array(leaf)
        if path[-1].key in ("bias", "conv_b", "out_scale"):
            leaf = (rng.normal(size=leaf.shape) * 0.3 + 0.1).astype(leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(fill, params)
    cls = TX.MLSTMBlock if kind == "mlstm" else TX.SLSTMBlock
    module = cls(TCFG, dtype=torch.float32, device="cpu")
    module.load_state_dict({k: torch.from_numpy(v) for k, v in _flatten(params).items()},
                           strict=True)
    return jax.tree.map(jnp.asarray, params), module


def _x(B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, JCFG.d_model),
                                                       dtype=np.float32)


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for key, leaf in got.items():
        ref = np.asarray(want[key])
        assert leaf.shape == ref.shape, key
        np.testing.assert_allclose(leaf.numpy(), ref, atol=ATOL, err_msg=key)


def test_block_leaves_and_dtypes_match_jax():
    cfg = JCFG.with_(param_dtype="bfloat16")
    tcfg = TCFG.with_(param_dtype="bfloat16")
    for kind in ("mlstm", "slstm"):
        init = JX.init_mlstm_block if kind == "mlstm" else JX.init_slstm_block
        leaves = _flatten(jax.eval_shape(lambda k: init(k, cfg, jnp.bfloat16),
                                         jax.random.PRNGKey(0)))
        cls = TX.MLSTMBlock if kind == "mlstm" else TX.SLSTMBlock
        port = dict(cls(tcfg, dtype=torch.bfloat16, device="cpu").named_parameters())
        assert set(port) == set(leaves)
        for name, p in port.items():
            assert tuple(p.shape) == leaves[name].shape, name
            assert str(p.dtype).removeprefix("torch.") == str(leaves[name].dtype), name


@pytest.mark.parametrize("S", [12, 37, 300])
def test_mlstm_block_prefill_and_decode_match_jax(S):
    """The model's chunk 256 shrinks to 12, 37 and 150."""
    params, block = _block("mlstm", seed=S)
    x = _x(2, S, seed=1)
    with torch.inference_mode():
        y, cache = block.prefill(torch.from_numpy(x))
    y_ref, cache_ref = JX.mlstm_block_prefill(params, jnp.asarray(x), JCFG)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)
    _close(cache, cache_ref)
    for i in range(3):
        xt = _x(2, 1, seed=10 + i)
        with torch.inference_mode():
            y, cache = block.decode(torch.from_numpy(xt), cache)
        y_ref, cache_ref = JX.mlstm_block_decode(params, jnp.asarray(xt), cache_ref, JCFG)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)
        _close(cache, cache_ref)


@pytest.mark.parametrize("S", [1, 9])
def test_slstm_block_forward_and_decode_match_jax(S):
    params, block = _block("slstm", seed=S)
    act = jax_activation(JCFG.act)
    x = _x(2, S, seed=2)
    with torch.inference_mode():
        y, state = block.prefill(torch.from_numpy(x))
    y_ref, state_ref = JX.slstm_block_forward(params, jnp.asarray(x), JCFG, act,
                                              return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)
    _close(state, state_ref)
    for i in range(3):
        xt = _x(2, 1, seed=20 + i)
        with torch.inference_mode():
            y, state = block.decode(torch.from_numpy(xt), state)
        y_ref, state_ref = JX.slstm_block_decode(params, jnp.asarray(xt), state_ref,
                                                 JCFG, act)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)
        _close(state, state_ref)


def test_mlstm_chunkwise_matches_stepwise_decode():
    """Chunkwise prefill == the decode recurrence on the last token, as
    tests/test_kernels.py checks it for the JAX model. S 300 runs 2 chunks
    of 150, its prefix S 299 = 13 x 23 runs 13 chunks of 23."""
    _, block = _block("mlstm", seed=0)
    x = torch.from_numpy(_x(2, 300, seed=3))
    with torch.inference_mode():
        y_seq, _ = block.prefill(x)
        _, cache_pre = block.prefill(x[:, :-1])
        y_last, _ = block.decode(x[:, -1:], cache_pre)
    assert (y_last - y_seq[:, -1:]).abs().max().item() < 1e-3


def test_slstm_prefill_matches_stepwise_decode():
    _, block = _block("slstm", seed=0)
    x = torch.from_numpy(_x(2, 7, seed=4))
    with torch.inference_mode():
        y_seq, state_seq = block.prefill(x)
        _, state = block.prefill(x[:, :-1])
        y_last, state = block.decode(x[:, -1:], state)
    assert (y_last - y_seq[:, -1:]).abs().max().item() < 1e-5
    for key in state:
        assert torch.allclose(state[key], state_seq[key], atol=1e-6), key
