"""Port parity: the port's model vs repro.models.model on reduced configs
(dense qwen2/deepseek/mistral-large, gemma3 and chameleon with QK-norm, the
MoE archs qwen3-moe (QK-norm too) and dbrx, xLSTM, RecurrentGemma, and
musicgen-large: embedding inputs [B, S, D] and four codebook heads, logits
[..., 4, V], greedy tokens [B, 4]).

Weights come from the JAX ``init_params``, with every bias, norm scale,
``conv_b``, ``rg_conv_b`` and ``out_scale`` overwritten by random non-zero
values (they are zero or one at init and would hide a bug; the QK-norm
scales among them), and are carried across with
``params_from_jax``. Prefill logits, every layer's cache and four decode
steps' logits are compared in float32 at atol 1e-4 (a whole model: several
layers of float32 products summed in another order), and the greedy tokens
must be identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import cache_to_jax_layout, params_from_jax  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
ATOL = 1e-4


VARIANTS = {  # suffix -> config changes
    "-local": dict(block_pattern=("local", "attn"), num_layers=3, window_size=8),
    # two pattern repeats and a tail (mlstm, slstm): params_from_jax's tail path
    "-tail": dict(block_pattern=("mlstm", "slstm", "mlstm"), num_layers=8),
}
ARCH_VARIANTS = {  # arch -> its own suffix -> config changes (or cfg -> changes)
    "recurrentgemma-2b": {
        # one (rglru, rglru, local) repeat and a 2-layer rglru tail
        "-tail": dict(num_layers=5),
        # window 8 < S 12: the local layer's ring buffer wraps
        "-window": dict(window_size=8),
    },
    "gemma3-12b": {
        # window 8 < S 12: the five local layers' ring buffers wrap
        "-window": dict(window_size=8),
    },
    "qwen3-moe-30b-a3b": {
        # capacity factor 1: the prefill's 24 tokens give each of the 8
        # experts 8 slots for 48 pairs, so the most chosen experts drop some
        "-drop": lambda cfg: dict(moe=dataclasses.replace(cfg.moe, capacity_factor=1.0)),
    },
}
NEW_ARCHS = ["qwen3-moe-30b-a3b", "dbrx-132b", "gemma3-12b", "chameleon-34b",
             "mistral-large-123b", "musicgen-large"]


def configs(arch: str):
    """(JAX cfg, port cfg) of the reduced arch, with a ``VARIANTS`` or
    ``ARCH_VARIANTS`` suffix."""
    base = next((a for a in ARCH_VARIANTS if arch.startswith(a)), None)
    variants = ARCH_VARIANTS[base] if base else VARIANTS
    suffix = next((v for v in variants if arch.endswith(v)), "")
    base = arch.removesuffix(suffix)
    jcfg = JC.reduced_config(JC.ARCHS[base])
    tcfg = TC.reduced_config(TC.get_config(base))
    if suffix:
        change = variants[suffix]
        jcfg, tcfg = (c.with_(**(change(c) if callable(change) else change))
                      for c in (jcfg, tcfg))
    return jcfg, tcfg


def jax_params(cfg, seed: int):
    """JAX init_params with biases, norm scales, conv_b, rg_conv_b and
    out_scale made random and non-zero."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        leaf = np.array(leaf)
        if path[-1].key in ("bias", "scale", "conv_b", "rg_conv_b", "out_scale"):
            leaf = (rng.normal(size=leaf.shape) * 0.3 + 0.1).astype(leaf.dtype)
        return leaf

    params = jax.device_get(JM.init_params(jax.random.PRNGKey(seed), cfg))
    return jax.tree_util.tree_map_with_path(fill, params)


def model_inputs(cfg, rng, B: int, S: int) -> np.ndarray:
    """Token ids [B, S] int32, or for an embeddings arch per-frame
    embeddings [B, S, D] float32 (standard normal)."""
    if cfg.input_mode == "embeddings":
        return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)


def port_inputs(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(arr) if arr.dtype == np.float32 else torch.from_numpy(arr).long()


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-7b", "xlstm-1.3b",
                                  "recurrentgemma-2b", *NEW_ARCHS, "gemma3-12b-window",
                                  "qwen3-moe-30b-a3b-drop"])
def test_port_config_matches_jax_config(arch):
    jcfg, tcfg = configs(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    arch = jcfg.name
    full_j, full_t = JC.ARCHS[arch], TC.get_config(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert full_t.lru_width == full_j.lru_width


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-7b", "qwen2-7b-local",
                                  "xlstm-1.3b", "xlstm-1.3b-tail",
                                  "recurrentgemma-2b", "recurrentgemma-2b-tail",
                                  "recurrentgemma-2b-window", *NEW_ARCHS,
                                  "gemma3-12b-window", "qwen3-moe-30b-a3b-drop"])
def test_prefill_cache_and_decode_match_jax(arch):
    jcfg, tcfg = configs(arch)
    params = jax_params(jcfg, seed=3)
    model = params_from_jax(params, tcfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    B, S, steps = 2, 12, 4
    rng = np.random.default_rng(5)
    prompt = model_inputs(jcfg, rng, B, S)
    max_len = S + steps
    with torch.inference_mode():
        t_logits, t_cache = TM.prefill(model, port_inputs(prompt), max_len=max_len)
    j_logits, j_cache = JM.prefill(jparams, jnp.asarray(prompt), jcfg,
                                   max_len=max_len)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=ATOL)

    got = cache_to_jax_layout(t_cache, tcfg)
    want = jax.device_get(j_cache)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want) > 0
    for path, leaf in flat_got:
        ref = flat_want[path]
        assert leaf.shape == ref.shape, path
        if path[-1].key == "pos":
            np.testing.assert_array_equal(leaf, ref)
        else:
            np.testing.assert_allclose(leaf, ref, atol=ATOL)

    tok = np.argmax(np.asarray(j_logits), axis=-1)       # [B], or [B, C]
    assert tok.shape == ((B, jcfg.num_codebooks) if jcfg.num_codebooks else (B,))
    assert np.array_equal(t_logits.argmax(-1).numpy(), tok)
    for i in range(steps):
        # an embeddings arch takes fresh frames: its tokens are codes of the
        # four codebooks, which a frontend (not ported, as in JAX) embeds
        step_in = (model_inputs(jcfg, rng, B, 1) if jcfg.input_mode == "embeddings"
                   else tok[:, None])
        with torch.inference_mode():
            t_logits, t_cache = TM.decode_step(model, t_cache, port_inputs(step_in), S + i)
        j_logits, j_cache = JM.decode_step(jparams, j_cache, jnp.asarray(step_in),
                                           jnp.int32(S + i), jcfg)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=ATOL)
        tok = np.argmax(np.asarray(j_logits), axis=-1)
        assert np.array_equal(t_logits.argmax(-1).numpy(), tok)


@pytest.mark.parametrize("arch", ["qwen2-7b", "musicgen-large"])
def test_train_forward_matches_jax(arch):
    """The train-mode forward's logits at every position: [B, S, V], or
    [B, S, 4, V] from musicgen-large's embeddings."""
    jcfg, tcfg = configs(arch)
    params = jax_params(jcfg, seed=4)
    model = params_from_jax(params, tcfg, device="cpu")
    x = model_inputs(jcfg, np.random.default_rng(6), 2, 10)
    want, _ = JM.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, aux = model(port_inputs(x))
    assert got.shape == want.shape and aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_unported_archs_and_blocks_raise():
    """Every arch of the JAX package is ported: musicgen-large, codebook heads
    and embedding inputs, QK-norm and the MoE, which used to raise, build and
    run on the CPU. An unknown arch (KeyError, as in JAX) and an unknown
    block kind (ValueError) still raise, and so does a model with no device
    named when there is no card."""
    assert len(TC.ARCHS) == 10 and set(TC.ARCHS) == set(JC.ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("musicgen-small")
    cfg = TC.reduced_config(TC.get_config("qwen2-7b"))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    for built in (cfg.with_(qk_norm=True), cfg.with_(moe=TC.MoEConfig(4, 2, 32))):
        model = TM.init_params(built, torch.Generator().manual_seed(0), "cpu")
        logits, aux = model(tokens)
        assert logits.shape == (1, 4, cfg.vocab_size) and torch.isfinite(logits).all()
        assert set(aux) == ({"moe_lb", "moe_z"} if built.moe else set())
    frames = torch.randn((1, 4, cfg.d_model), generator=torch.Generator().manual_seed(2))
    for built, x, shape in (
            (cfg.with_(num_codebooks=4), tokens, (1, 4, 4, cfg.vocab_size)),
            (cfg.with_(input_mode="embeddings"), frames, (1, 4, cfg.vocab_size)),
            (TC.reduced_config(TC.get_config("musicgen-large")), frames,
             (1, 4, 4, cfg.vocab_size))):
        model = TM.init_params(built, torch.Generator().manual_seed(1), "cpu")
        logits, aux = model(x)
        assert logits.shape == shape and torch.isfinite(logits).all() and aux == {}
        heads = max(built.num_codebooks, 1)
        assert model.head.kernel.shape == (cfg.d_model, heads * cfg.vocab_size)
        assert model.embed.table.shape == (cfg.vocab_size, cfg.d_model)
    with pytest.raises(ValueError):
        TM.CausalLM(cfg.with_(block_pattern=("mamba", "attn")), device="cpu")
    if not torch.cuda.is_available():       # no device named: the card, or raise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.init_params(cfg, torch.Generator().manual_seed(1))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.init_cache(cfg, 1, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params_from_jax(jax_params(configs("qwen2-7b")[0], seed=0), cfg)


@pytest.mark.parametrize("arch", ["qwen2-7b", "xlstm-1.3b", "recurrentgemma-2b",
                                  "qwen3-moe-30b-a3b", "gemma3-12b", "musicgen-large"])
def test_init_params_draws_the_jax_distributions(arch):
    """Leaf by leaf: constant leaves (zero biases, conv_b and rg_conv_b, norm
    scales, out_scale) equal JAX's; random leaves have JAX's std within 15 %
    (the generators differ; the smallest such leaf has 256 values). The
    RG-LRU ``lam`` (64 values at this width) is held to its range instead:
    a = exp(-8 softplus(lam)) in [0.9, 0.999]."""
    jcfg, tcfg = configs(arch)
    jax_init = jax.device_get(JM.init_params(jax.random.PRNGKey(0), jcfg))
    want = params_from_jax(jax_init, tcfg, device="cpu").state_dict()
    got = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu").state_dict()
    assert got.keys() == want.keys()
    for name, ref in want.items():
        leaf = got[name]
        assert leaf.dtype == ref.dtype and leaf.shape == ref.shape, name
        if ref.numel() == 1 or ref.std() == 0:
            assert torch.equal(leaf, ref), name
        elif name.endswith("mixer.lam"):
            for lam in (leaf, ref):
                a = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
                assert a.min() >= 0.9 - 1e-5 and a.max() <= 0.999 + 1e-5, name
        else:
            assert abs(leaf.std().item() / ref.std().item() - 1) < 0.15, name


def test_gemma3_local_layers_take_the_local_rope_theta():
    """gemma3-12b at full width: the five local layers of a repetition
    rotate at ``rope_theta_local`` 10k with window 1024, the global one at
    1M with no window (blocks built on the meta device: no weights)."""
    cfg = TC.get_config("gemma3-12b")
    blocks = [TM.Block(kind, cfg, dtype=torch.bfloat16, device="meta")
              for kind in cfg.layer_kinds()[:6]]
    got = [(b.kind, b.mixer.theta, b.mixer.window) for b in blocks]
    assert got == [("local", 10_000.0, 1024)] * 5 + [("attn", 1_000_000.0, 0)]
    assert all(b.mixer.q_norm.scale.shape == (256,) for b in blocks)


def test_init_params_on_device_is_seeded():
    cfg = TC.reduced_config(TC.get_config("qwen2-7b"))
    a = TM.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    b = TM.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
        assert pa.dtype == (torch.float32 if "scale" in name
                            else getattr(torch, cfg.param_dtype))
