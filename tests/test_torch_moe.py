"""Port parity for the sort-based MoE and QK-norm attention: the port's
``models/moe.py`` and ``Attention`` with ``qk_norm`` vs ``repro.models.moe``
and ``repro.models.attention`` on the CPU, from the same numpy inputs and
JAX-drawn weights.

Tolerances: float32 outputs, the aux losses and the caches at 1e-5 (one
layer's float32 products and sums in another order); the dispatch's sort,
slots and kept/dropped pairs exactly. The router's probabilities come from
random normal inputs, so no two experts tie for a token's top-k and
``torch.topk`` picks what ``lax.top_k`` picks (exact ties could be ordered
differently). Also: ``capacity`` over a grid against ``_capacity``, the
combine's bits across calls, and the MoE and QK-norm leaves through
``convert`` and a checkpoint both ways.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.checkpoint import checkpointer as jckpt  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.training import train_step as JS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import checkpointer as ckpt  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.attention import Attention  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
ARCH = "qwen3-moe-30b-a3b"
TOL = 1e-5


def _cfgs(capacity_factor=None):
    jcfg, tcfg = JC.reduced_config(JC.ARCHS[ARCH]), TC.reduced_config(TC.get_config(ARCH))
    if capacity_factor is not None:
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor))
        tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe, capacity_factor=capacity_factor))
    return jcfg, tcfg


def _moe(jcfg, tcfg, seed=0):
    """JAX ``init_moe`` weights (numpy) and the port's MoE holding them."""
    p = jax.device_get(JMoE.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    layer = TMoE.MoE(tcfg, dtype=torch.float32, device="cpu")
    layer.load_state_dict({"router.kernel": torch.from_numpy(np.array(p["router"]["kernel"])),
                           **{k: torch.from_numpy(np.array(p[k]))
                              for k in ("wi_gate", "wi_up", "wo")}})
    return p, layer


def _x(B, S, D, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_forward_matches_jax(groups):
    jcfg, tcfg = _cfgs()
    p, layer = _moe(jcfg, tcfg)
    x = _x(2, 16, jcfg.d_model)
    want, want_aux = JMoE.moe_forward(p, jnp.asarray(x), jcfg, num_groups=groups)
    with torch.no_grad():
        got, aux = layer(torch.from_numpy(x), groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    assert aux.keys() == want_aux.keys() == {"moe_lb", "moe_z"}
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_dropping_moe_keeps_and_drops_what_jax_does(groups):
    """capacity_factor 1.0 on 128 tokens: some experts get more pairs than
    their slots. The sort, each pair's slot, and the kept/dropped pairs
    equal JAX's ``_dispatch_group``'s, and the output JAX's."""
    jcfg, tcfg = _cfgs(capacity_factor=1.0)
    p, layer = _moe(jcfg, tcfg)
    m = jcfg.moe
    B, S = 4, 32
    x = _x(B, S, jcfg.d_model, seed=2)
    n = B * S // groups
    cap = JMoE._capacity(n, m)
    assert TMoE.capacity(n, tcfg.moe) == cap
    xf = x.reshape(groups, n, -1)
    logits = xf @ np.asarray(p["router"]["kernel"])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    top_p, top_i = (np.asarray(a) for a in jax.lax.top_k(jnp.asarray(probs), m.top_k))
    top_p = top_p / top_p.sum(-1, keepdims=True)
    jbuf, jcoords = jax.vmap(lambda xg, pg, ig: JMoE._dispatch_group(
        xg, pg, ig, m.num_experts, cap))(jnp.asarray(xf), jnp.asarray(top_p),
                                         jnp.asarray(top_i))
    tbuf, tcoords = TMoE.dispatch(*(torch.from_numpy(np.array(a)) for a in (xf, top_p, top_i)),
                                  m.num_experts, cap)
    names = ("token", "expert", "slot", "keep", "prob")
    for name, want, got in zip(names, jcoords, tcoords):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    keep = tcoords[3].numpy()
    assert 0 < (~keep).sum() < keep.size // 4, "the case must drop some pairs, not most"
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))

    want, want_aux = JMoE.moe_forward(p, jnp.asarray(x), jcfg, num_groups=groups)
    with torch.no_grad():
        got, aux = layer(torch.from_numpy(x), groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]), atol=TOL, rtol=TOL)
    # a token whose pairs were all dropped gets exactly zero
    dropped_all = np.ones(B * S, bool)
    token, keep = tcoords[0].numpy().reshape(-1) + np.repeat(
        np.arange(groups) * n, n * m.top_k), tcoords[3].numpy().reshape(-1)
    dropped_all[token[keep]] = False
    assert (got.reshape(B * S, -1).numpy()[dropped_all] == 0).all()


def test_capacity_matches_jax_over_a_grid():
    for tokens, E, k, cf in itertools.product((1, 4, 7, 64, 100, 2048, 4097),
                                              (8, 16, 128), (1, 2, 4, 8),
                                              (0.5, 1.0, 1.25, 8.0)):
        jm = JC.base.MoEConfig(num_experts=E, top_k=k, d_ff_expert=32, capacity_factor=cf)
        tm = TC.MoEConfig(num_experts=E, top_k=k, d_ff_expert=32, capacity_factor=cf)
        assert TMoE.capacity(tokens, tm) == JMoE._capacity(tokens, jm), (tokens, E, k, cf)


def test_num_groups_follows_moe_forward():
    m = TC.MoEConfig(num_experts=8, top_k=2, d_ff_expert=32)
    assert [TMoE.num_groups(N, g, m) for N, g in
            ((32, 4, ), (30, 4), (3, 8), (7, 0), (12, 5))] == [4, 3, 3, 1, 4]
    assert TMoE.num_groups(32, 0, dataclasses.replace(m, num_groups=8)) == 8


def test_moe_output_is_the_same_bits_on_every_call():
    """The combine sums each token's pairs in a fixed order: bf16 output and
    both aux losses bit-equal across calls (the card check repeats this)."""
    _, tcfg = _cfgs(capacity_factor=1.0)
    layer = TMoE.MoE(tcfg.with_(param_dtype="bfloat16"), dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        layer.reset_parameters(torch.Generator().manual_seed(0))
        x = torch.from_numpy(_x(4, 32, tcfg.d_model)).bfloat16()
        (a, aa), (b, ab) = layer(x), layer(x)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert all(torch.equal(aa[k], ab[k]) for k in aa)


def test_moe_init_draws_the_jax_distributions():
    """Router normal·1/√D in float32; wi_gate, wi_up normal·1/√D and wo
    normal·1/√F stored in param_dtype; std within 15 % of JAX's draw."""
    jcfg, tcfg = _cfgs()
    want = jax.device_get(JMoE.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    layer = TMoE.MoE(tcfg, dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        layer.reset_parameters(torch.Generator().manual_seed(0))
    got = dict(layer.named_parameters())
    assert got["router.kernel"].dtype == torch.float32
    for name, ref in (("router.kernel", want["router"]["kernel"]),
                      ("wi_gate", want["wi_gate"]), ("wi_up", want["wi_up"]),
                      ("wo", want["wo"])):
        leaf = got[name]
        assert tuple(leaf.shape) == ref.shape, name
        assert str(leaf.dtype).removeprefix("torch.") == str(ref.dtype), name
        ref_std = float(np.asarray(ref, np.float32).std())
        assert abs(leaf.float().std().item() / ref_std - 1) < 0.15, name


@pytest.mark.parametrize("window", [0, 8])
def test_qk_norm_attention_matches_jax_in_every_mode(window):
    """Reduced gemma3-12b attention (QK-norm, local theta 10k for a window
    layer) with random non-zero norm scales: train-mode output, prefill
    output and cache, and four decode steps against JAX at 1e-5."""
    jcfg = JC.reduced_config(JC.ARCHS["gemma3-12b"])
    tcfg = TC.reduced_config(TC.get_config("gemma3-12b"))
    theta = jcfg.rope_theta_local if window else jcfg.rope_theta
    rng = np.random.default_rng(4)
    p = jax.device_get(JA.init_attention(jax.random.PRNGKey(0), jcfg, jnp.float32))
    for norm in ("q_norm", "k_norm"):
        p[norm]["scale"] = (rng.standard_normal(jcfg.head_dim) * 0.3 + 0.1).astype(np.float32)
    layer = Attention(tcfg, window=window, theta=theta, dtype=torch.float32, device="cpu")
    state = {f"{a}.kernel": torch.from_numpy(np.array(p[a]["kernel"]))
             for a in ("wq", "wk", "wv", "wo")}
    state.update({f"{n}.scale": torch.from_numpy(p[n]["scale"]) for n in ("q_norm", "k_norm")})
    layer.load_state_dict(state)
    B, S, steps = 2, 12, 4
    x = _x(B, S + steps, jcfg.d_model, seed=5)
    jp = jax.tree.map(jnp.asarray, p)
    pos = jnp.arange(S, dtype=jnp.int32)
    with torch.no_grad():
        got = layer(torch.from_numpy(x[:, :S]))
        y, cache = layer.prefill(torch.from_numpy(x[:, :S]), S + steps)
    want = JA.attention_forward(jp, jnp.asarray(x[:, :S]), jcfg, pos, window=window, theta=theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    jy, jcache = JA.attention_prefill(jp, jnp.asarray(x[:, :S]), jcfg, pos, window=window,
                                      theta=theta, max_len=S + steps)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)
    for i in range(steps):
        for k in ("k", "v"):
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), atol=TOL)
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
        with torch.no_grad():
            y, cache = layer.decode(torch.from_numpy(x[:, S + i:S + i + 1]), cache, S + i)
        jy, jcache = JA.attention_decode(jp, jnp.asarray(x[:, S + i:S + i + 1]), jcache, jcfg,
                                         S + i, window=window, theta=theta)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)


def test_moe_and_qk_norm_leaves_round_trip_through_convert():
    """params_to_jax(params_from_jax(p)) gives every leaf of the JAX tree
    back bit for bit, the stacked expert leaves ([repeat, E, D, F]) and the
    QK-norm scales included."""
    jcfg, tcfg = _cfgs()
    params = jax.device_get(JM.init_params(jax.random.PRNGKey(0), jcfg))
    block = params["repeats"]["b0"]
    assert block["moe"]["wi_gate"].shape[:2] == (jcfg.num_layers, jcfg.moe.num_experts)
    assert set(block["mixer"]) >= {"q_norm", "k_norm"}
    model = convert.params_from_jax(params, tcfg, device="cpu")
    names = dict(model.named_parameters())
    assert {"layers.1.moe.router.kernel", "layers.1.moe.wi_gate", "layers.1.moe.wo",
            "layers.1.mixer.q_norm.scale", "layers.1.mixer.k_norm.scale"} <= names.keys()
    back = convert.params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_moe_checkpoint_round_trips_both_ways(tmp_path):
    """A JAX TrainState of reduced qwen3-moe saved by the JAX checkpointer
    restores into the port, and the port's saves the same leaves in the
    same order and restores into JAX, bit for bit."""
    jcfg, tcfg = _cfgs()
    state = jax.device_get(JS.init_state(jax.random.PRNGKey(0), jcfg))
    jckpt.save(str(tmp_path / "jax"), state, step=1)
    port = convert.state_from_leaves(ckpt.restore(str(tmp_path / "jax")), tcfg, "cpu")
    back = convert.state_to_jax(port)
    jax.tree.map(np.testing.assert_array_equal, back["params"], state.params)
    for name in ("m", "v", "master"):
        jax.tree.map(np.testing.assert_array_equal, back["opt"][name],
                     getattr(state.opt, name))
    ckpt.save(str(tmp_path / "port"), convert.state_leaves(port), step=1)
    target = jax.eval_shape(lambda k: JS.init_state(k, jcfg), jax.random.PRNGKey(0))
    restored = jax.device_get(jckpt.restore(str(tmp_path / "port"), target))
    jax.tree.map(np.testing.assert_array_equal, restored, state)
    assert TS.init_state(tcfg, seed=0, device="cpu").params.layers[0].moe is not None
