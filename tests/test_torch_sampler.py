"""Port parity for the sampler: ``repro_torch.serving.sampler`` vs
``repro.serving.sampler`` on the CPU.

``jax.random.categorical(key, logits)`` is ``argmax(gumbel(key,
logits.shape) + logits)``. So the port's ``filter_logits`` plus JAX's own
noise (``np.asarray(jax.random.gumbel(key, shape))``, passed to ``sample``)
must draw exactly the JAX ``sample(logits, key, cfg)`` tokens, for greedy,
temperature, top-k and top-p; the filtered logits must equal the JAX
function's before its draw bit for bit (float32 division, sort and select
only). Logits are float32 normal draws from a numpy seed, so no two tie.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving import sampler as JSamp  # noqa: E402
from repro_torch.serving import sampler as TSamp  # noqa: E402

CONFIGS = {
    "greedy": dict(greedy=True),
    "plain": dict(),
    "temperature": dict(temperature=0.7),
    "top_k": dict(top_k=5),
    "top_p": dict(top_p=0.9),
    "all": dict(temperature=1.3, top_k=40, top_p=0.8),
}


def _jax_filtered(logits, cfg):
    """The JAX sample's logits just before ``categorical``: its own body,
    with the draw replaced by returning the logits."""
    seen = {}

    def fake_categorical(key, lg, axis=-1):
        seen["logits"] = lg
        return jnp.argmax(lg, axis=axis)

    real = jax.random.categorical
    jax.random.categorical = fake_categorical
    try:
        JSamp.sample(jnp.asarray(logits), jax.random.PRNGKey(0), cfg)
    finally:
        jax.random.categorical = real
    return np.asarray(seen["logits"])


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_with_jax_noise_draws_the_jax_tokens(name, seed):
    jcfg = JSamp.SamplerConfig(**CONFIGS[name])
    tcfg = TSamp.SamplerConfig(**CONFIGS[name])
    logits = (np.random.default_rng(seed).standard_normal((4, 3, 512)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(JSamp.sample(jnp.asarray(logits), key, jcfg))
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, logits.shape)))
    got = TSamp.sample(torch.from_numpy(logits), None, tcfg, noise=noise)
    np.testing.assert_array_equal(got.numpy(), want)
    if not tcfg.greedy:
        np.testing.assert_array_equal(TSamp.filter_logits(torch.from_numpy(logits), tcfg).numpy(),
                                      _jax_filtered(logits, jcfg))


def test_sample_draws_from_its_generator():
    """The same generator seed draws the same tokens; the draws follow the
    filtered distribution (top-k 3: only the top three tokens, each often)."""
    cfg = TSamp.SamplerConfig(top_k=3)
    logits = torch.tensor([[0.0, 1.0, 1.2, 0.9, -2.0, 0.5]]).repeat(2000, 1)
    a = TSamp.sample(logits, torch.Generator().manual_seed(7), cfg)
    b = TSamp.sample(logits, torch.Generator().manual_seed(7), cfg)
    assert torch.equal(a, b)
    counts = torch.bincount(a, minlength=6)
    assert set(torch.nonzero(counts).flatten().tolist()) == {1, 2, 3}
    p = torch.softmax(torch.tensor([1.0, 1.2, 0.9]), 0)
    assert torch.allclose(counts[1:4] / 2000.0, p, atol=0.04)
    noise = TSamp.gumbel((100000,), torch.Generator().manual_seed(0))
    assert torch.isfinite(noise).all()
    assert abs(noise.mean().item() - 0.5772) < 0.02            # Euler-Mascheroni
