"""Port parity: the port's RGLRUBlock vs repro.models.rglru on the reduced
recurrentgemma-2b config, float32, CPU, with the JAX block parameters
(``lam``, the gate biases and ``rg_conv_b`` random and non-zero) loaded by
leaf name.

The prefill output (h through the plain rglru_scan) and both cache leaves
against ``rglru_block_prefill``, then decode steps against
``rglru_block_decode``, at atol 1e-4 (float32, sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models.layers import activation as jax_activation  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402

ATOL = 1e-4
JCFG = JC.reduced_config(JC.ARCHS["recurrentgemma-2b"])
TCFG = TC.reduced_config(TC.get_config("recurrentgemma-2b"))


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _block(seed: int):
    """(JAX params, port module) of one RG-LRU block, same weights."""
    rng = np.random.default_rng(seed)
    params = jax.device_get(JR.init_rglru_block(jax.random.PRNGKey(seed), JCFG,
                                                jnp.float32))

    def fill(path, leaf):
        leaf = np.array(leaf)
        if path[-1].key in ("bias", "rg_conv_b"):
            leaf = (rng.normal(size=leaf.shape) * 0.3 + 0.1).astype(leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(fill, params)
    module = TR.RGLRUBlock(TCFG, dtype=torch.float32, device="cpu")
    module.load_state_dict({k: torch.from_numpy(v) for k, v in _flatten(params).items()},
                           strict=True)
    assert module.lam.dtype == torch.float32
    return jax.tree.map(jnp.asarray, params), module


def _x(B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, JCFG.d_model),
                                                       dtype=np.float32)


def test_rglru_prefill_and_cache_match_jax():
    params, block = _block(0)
    x = _x(2, 24, seed=1)
    with torch.inference_mode():
        y, cache = block.prefill(torch.from_numpy(x))
    y_ref, c_ref = JR.rglru_block_prefill(params, jnp.asarray(x), JCFG,
                                          jax_activation(JCFG.act))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)
    assert set(cache) == set(c_ref) == {"h", "conv"}
    for name in cache:
        assert cache[name].shape == c_ref[name].shape, name
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(c_ref[name]),
                                   atol=ATOL)
    assert cache["h"].dtype == torch.float32


def test_rglru_decode_steps_update_the_cache_in_place():
    params, block = _block(2)
    x = _x(2, 10, seed=3)
    act = jax_activation(JCFG.act)
    with torch.inference_mode():
        _, cache = block.prefill(torch.from_numpy(x[:, :6]))
    _, c_ref = JR.rglru_block_prefill(params, jnp.asarray(x[:, :6]), JCFG, act)
    for t in range(6, 10):
        xt = x[:, t:t + 1]
        with torch.inference_mode():
            y, returned = block.decode(torch.from_numpy(xt), cache, t)
        assert returned is cache                     # the model drops the return
        y_ref, c_ref = JR.rglru_block_decode(params, jnp.asarray(xt), c_ref, JCFG, act)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)
        for name in ("h", "conv"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(c_ref[name]),
                                       atol=ATOL)
    # decoding the tail token by token reaches the full prefill's state
    with torch.inference_mode():
        _, full = block.prefill(torch.from_numpy(x))
    np.testing.assert_allclose(cache["h"].numpy(), full["h"].numpy(), atol=ATOL)


def test_rglru_init_draws_lam_in_range():
    """a = exp(-8 softplus(lam)) is U(0.9, 0.999) at init, as in JAX."""
    block = TR.RGLRUBlock(TCFG.with_(rnn_width=4096), dtype=torch.float32, device="cpu")
    with torch.no_grad():
        block.reset_parameters(torch.Generator().manual_seed(0))
    a = torch.exp(-8.0 * torch.nn.functional.softplus(block.lam))
    assert 0.9 - 1e-5 <= a.min().item() and a.max().item() <= 0.999 + 1e-5
    assert abs(a.mean().item() - 0.9495) < 3e-3
    assert not block.rg_conv_b.any() and not block.w_rg.bias.any()
