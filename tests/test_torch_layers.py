"""Port parity: repro_torch.models.layers vs repro.models.layers (CPU, float32).

Inputs are made with numpy from a seed and fed to both sides. Tolerance
rtol 1e-5 / atol 1e-6: both sides compute the same float32 expressions, so
they differ only by the rounding of differently ordered sums and of the
transcendental functions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
RTOL, ATOL = 1e-5, 1e-6


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_rmsnorm_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    scale = rng.normal(size=(48,)).astype(np.float32)
    norm = TL.RMSNorm(48)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
    _close(norm(torch.from_numpy(x)),
           JL.apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))


@pytest.mark.parametrize("seed", [0, 1])
def test_layernorm_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 5, 48)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=(48,)).astype(np.float32)
    bias = rng.normal(size=(48,)).astype(np.float32)
    norm = TL.make_norm("layernorm", 48)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    _close(norm(torch.from_numpy(x)),
           JL.apply_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                         jnp.asarray(x)))
    init = JL.init_norm("layernorm", 48)
    norm.reset_parameters()
    assert set(dict(norm.named_parameters())) == set(init)
    for name, p in norm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(init[name]))


@pytest.mark.parametrize("theta,batched_pos", [(10_000.0, False),
                                               (1_000_000.0, True)])
def test_rope_matches_jax(theta, batched_pos):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) + 40
    if batched_pos:
        pos = np.stack([pos, pos + 3])
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_dense_with_bias_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 32)).astype(np.float32)
    w = rng.normal(size=(32, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    dense = TL.Dense(32, 24, bias=True, dtype=torch.float32)
    with torch.no_grad():
        dense.kernel.copy_(torch.from_numpy(w))
        dense.bias.copy_(torch.from_numpy(b))
    _close(dense(torch.from_numpy(x)),
           JL.dense({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                    jnp.asarray(x)))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp_matches_jax(act):
    rng = np.random.default_rng(4)
    d, ff = 32, 64
    x = rng.normal(size=(2, 3, d)).astype(np.float32)
    ws = {n: (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)
          for n, shape in (("wi_gate", (d, ff)), ("wi_up", (d, ff)),
                           ("wo", (ff, d)))}
    mlp = TL.MLP(d, ff, act, dtype=torch.float32, device=None)
    with torch.no_grad():
        for n, w in ws.items():
            getattr(mlp, n).kernel.copy_(torch.from_numpy(w))
    ref = JL.mlp({n: {"kernel": jnp.asarray(w)} for n, w in ws.items()},
                 jnp.asarray(x), act)
    _close(mlp(torch.from_numpy(x)), ref)


def test_init_draws_match_jax_distributions():
    """Same distributions as repro.models.layers' init: kernel std 1/sqrt(in),
    embedding std 0.02, zero bias, zero norm scale (statistical check)."""
    g = torch.Generator().manual_seed(0)
    dense = TL.Dense(256, 512, bias=True, dtype=torch.float32)
    emb = TL.Embedding(1000, 64, dtype=torch.float32, device=None)
    norm = TL.RMSNorm(8)
    with torch.no_grad():
        dense.reset_parameters(g)
        emb.reset_parameters(g)
        norm.reset_parameters()
    assert abs(dense.kernel.std().item() - 1 / 16) < 2e-3
    assert abs(emb.table.std().item() - 0.02) < 5e-4
    assert not dense.bias.any() and not norm.scale.any()


@pytest.mark.parametrize("cap", [30.0, 0.0])
def test_softcap_matches_jax(cap):
    x = (np.random.default_rng(5).normal(size=(3, 50)) * 40).astype(np.float32)
    _close(TL.softcap(torch.from_numpy(x), cap), JL.softcap(jnp.asarray(x), cap))


def test_tied_unembed_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    table = rng.normal(size=(40, 16)).astype(np.float32)
    emb = TL.Embedding(40, 16, dtype=torch.float32, device=None)
    with torch.no_grad():
        emb.table.copy_(torch.from_numpy(table))
    _close(emb.unembed(torch.from_numpy(x)),
           JL.unembed({"table": jnp.asarray(table)}, jnp.asarray(x)))
