"""Port parity for training: the port's train step vs ``repro.training`` on
the CPU (reduced recurrentgemma-2b, qwen2-7b, and qwen3-moe-30b-a3b with its
MoE auxiliary losses).

Both start from the JAX ``init_state(PRNGKey(0))`` (carried across with
``convert.state_from_jax``) and take three steps on the same
``SyntheticLM`` batches (batch 4, 32 tokens: longer than the reduced
recurrentgemma-2b's window of 16). Tolerances (TOLS):

* float32 and int8 gradients: loss and nll 1e-5, grad_norm 1e-5 relative
  (one model's float32 sums in another order; measured <= 1e-6); the params
  after the third step 1e-4 (AdamW divides by sqrt(v): a gradient near zero
  that differs in its last bits moves its weight by a fraction of the
  learning rate, 3e-4; measured <= 4.2e-5); each leaf's update over the
  three steps 1e-2 relative to its norm (measured 1.1e-3, and 4.2e-3 on
  qwen2-7b's k bias, whose exact gradient is zero: a softmax ignores a
  shift common to all keys); m and v 1e-4 relative (measured 1.1e-5), int8
  5e-3 (a gradient on a rounding edge lands one quantum away; 4.2e-4);
* bfloat16: 5e-3 on the loss, 1e-2 relative on grad_norm, params 8e-3 (the
  frameworks round to bf16 at other places; measured 1.8e-3, 2.7e-3 and
  1.7e-3; one bf16 ulp at 1 is 7.8e-3); the whole tree's update 0.15
  relative (measured 0.059) and each leaf's m and v 0.1 (measured 0.043).

``test_adamw_update_matches_jax`` holds one optimizer step from the same
gradients at 1e-6, where the weight-decay term is 30x the tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.training import train_step as JS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

B, S, STEPS = 4, 32, 3
TOLS = {  # variant -> (loss atol, grad_norm rtol, params atol, update rtol, moments rtol)
    "float32": (1e-5, 1e-5, 1e-4, ("leaf", 1e-2), 1e-4),
    "int8": (1e-5, 1e-5, 1e-4, ("leaf", 1e-2), 5e-3),
    "bfloat16": (5e-3, 1e-2, 8e-3, ("tree", 0.15), 0.1),
}
def _rel_err(want, got) -> float:
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


VARIANTS = {  # name -> (arch, TrainConfig kwargs, dtype, tolerance)
    "recurrentgemma-2b": ("recurrentgemma-2b", {}, None, "float32"),
    "qwen2-7b": ("qwen2-7b", {}, None, "float32"),
    "recurrentgemma-2b-microbatch2": ("recurrentgemma-2b", {"microbatch": 2}, None, "float32"),
    "qwen2-7b-int8": ("qwen2-7b", {"grad_compression": "int8"}, None, "int8"),
    "qwen2-7b-bf16": ("qwen2-7b", {}, "bfloat16", "bfloat16"),
    # the MoE's auxiliary losses in the loss (MOE_LB_COEF, MOE_Z_COEF), QK-norm
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}, None, "float32"),
}


def _configs(arch, dtype):
    jcfg = JC.reduced_config(JC.ARCHS[arch])
    tcfg = TC.reduced_config(TC.get_config(arch))
    if dtype:
        jcfg = jcfg.with_(param_dtype=dtype, compute_dtype=dtype)
        tcfg = tcfg.with_(param_dtype=dtype, compute_dtype=dtype)
    return jcfg, tcfg


def _port_run(tcfg, train_kw, jax_state):
    """Three port steps from the JAX initial state: (metrics per step, state)."""
    state = convert.state_from_jax(jax_state, tcfg, "cpu")
    step = TS.make_train_step(tcfg, TrainConfig(**train_kw))
    data = SyntheticLM(tcfg, seed=0)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, data.batch(i, B, S))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@pytest.fixture(scope="module", params=list(VARIANTS))
def runs(request):
    """The JAX run (metrics per step, final params) and the port's."""
    arch, train_kw, dtype, tol = VARIANTS[request.param]
    jcfg, tcfg = _configs(arch, dtype)
    init = jax.device_get(JS.init_state(jax.random.PRNGKey(0), jcfg))
    step = jax.jit(JS.make_train_step(jcfg, JTrainConfig(**train_kw)))
    data = JSyntheticLM(jcfg, seed=0)
    state, jm = JS.init_state(jax.random.PRNGKey(0), jcfg), []
    for i in range(STEPS):
        state, m = step(state, data.batch(i, B, S))
        jm.append({k: float(v) for k, v in m.items()})
    tm, tstate = _port_run(tcfg, train_kw, init)
    return {"jax": (jm, jax.device_get(state.params)), "port": (tm, tstate),
            "jax_opt": jax.device_get(state.opt), "tol": TOLS[tol],
            "init": init}


def test_train_steps_match_jax(runs):
    (jm, _), (tm, _) = runs["jax"], runs["port"]
    loss_tol, gn_tol = runs["tol"][:2]
    for step, (a, b) in enumerate(zip(jm, tm)):
        assert set(a) == set(b) == {"loss", "nll", "grad_norm"}
        assert abs(a["loss"] - b["loss"]) <= loss_tol, (step, a, b)
        assert abs(a["nll"] - b["nll"]) <= loss_tol, (step, a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= gn_tol * a["grad_norm"], (step, a, b)
    assert tm[-1]["loss"] < tm[0]["loss"]


def test_params_after_three_steps_match_jax(runs):
    (_, jparams), (_, tstate) = runs["jax"], runs["port"]
    tparams = convert.params_to_jax(tstate.params)
    err = jax.tree.map(lambda a, b: float(np.max(np.abs(
        np.asarray(a, np.float32) - np.asarray(b, np.float32)))), jparams, tparams)
    worst = max(jax.tree.leaves(err))
    assert worst <= runs["tol"][2], worst


def test_updates_after_three_steps_match_jax(runs):
    """The float32 update over the three steps (master after minus master
    before) against the JAX update, as ||d_port - d_jax|| / ||d_jax||: each
    leaf's (float32, int8), or the whole tree's (bfloat16: Adam divides
    each gradient by its own size, so the gradients' bf16 rounding moves a
    small gradient's update by up to the learning rate). The params check
    above cannot see a skipped or wrong update, which is smaller than its
    tolerance."""
    scope, rtol = runs["tol"][3]
    init = runs["init"].opt.master
    got = convert.state_to_jax(runs["port"][1])["opt"]["master"]
    if scope == "tree":
        init, want, got = ([np.concatenate([np.ravel(x) for x in jax.tree.leaves(t)])]
                           for t in (init, runs["jax_opt"].master, got))
    else:
        init, want, got = (jax.tree.leaves(t) for t in (init, runs["jax_opt"].master, got))
    worst = max(_rel_err(b - a, c - a) for a, b, c in zip(init, want, got))
    assert worst <= rtol, worst


def test_moments_after_three_steps_match_jax(runs):
    """Each leaf's first and second moments against the JAX ones, as
    ||port - jax|| / ||jax||: the gradients themselves, before Adam's
    division."""
    got = convert.state_to_jax(runs["port"][1])["opt"]
    worst = max(_rel_err(w, g) for name in ("m", "v")
                for w, g in zip(jax.tree.leaves(getattr(runs["jax_opt"], name)),
                                jax.tree.leaves(got[name])))
    assert worst <= runs["tol"][4], worst


def test_optimizer_state_matches_jax_layout(runs):
    """The port's m, v and master convert back to the JAX pytrees' layout
    (every leaf, shape and dtype), and the step counter is 3."""
    _, tstate = runs["port"]
    tree = convert.state_to_jax(tstate)
    init = runs["init"]
    assert int(tree["opt"]["step"]) == STEPS
    for name in ("m", "v", "master"):
        want = jax.tree.map(lambda x: (x.shape, "float32"), getattr(init.opt, name))
        got = jax.tree.map(lambda x: (x.shape, str(x.dtype)), tree["opt"][name])
        assert got == want, name


def test_remat_none_gives_the_same_numbers_as_block():
    """Recomputing each pattern repetition in the backward pass changes
    nothing: remat "none" and "block" give equal losses, norms and params."""
    jcfg, tcfg = _configs("recurrentgemma-2b", None)
    init = jax.device_get(JS.init_state(jax.random.PRNGKey(1), jcfg))
    block_m, block_s = _port_run(tcfg, {"remat": "block"}, init)
    none_m, none_s = _port_run(tcfg, {"remat": "none"}, init)
    assert block_m == none_m
    for (n, a), (_, b) in zip(block_s.params.named_parameters(),
                              none_s.params.named_parameters()):
        assert torch.equal(a, b), n


def test_train_forward_matches_jax_forward_for_xlstm():
    """xLSTM's train-mode forward (mLSTM and sLSTM blocks, the plain mLSTM
    version carrying autograd on the CPU) gives the JAX logits, and its loss
    has a finite gradient for every parameter. The last position is held at
    1e-4 as in test_torch_model; every position at 5e-4, since the mLSTM
    normaliser max(|q·n|, e^-m) amplifies float32 reordering at a few of
    this random model's positions (measured 2.6e-4 at one)."""
    from repro.models import model as JM
    jcfg, tcfg = _configs("xlstm-1.3b", None)
    params = jax.device_get(JM.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16), dtype=np.int32)
    want, _ = JM.forward(params, tokens, jcfg)
    state = convert.state_from_jax(JS.TrainState(params, JS.init_opt_state(params)),
                                   tcfg, "cpu")
    logits, aux = state.params(torch.from_numpy(tokens), remat="block")
    assert aux == {}
    got, want = logits.detach().numpy(), np.asarray(want)
    np.testing.assert_allclose(got[:, -1], want[:, -1], atol=1e-4)
    np.testing.assert_allclose(got, want, atol=5e-4)
    loss, _ = TS.cross_entropy(logits, torch.from_numpy(tokens), 1e-4)
    grads = torch.autograd.grad(loss, list(state.params.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(compression, dtype):
    """One ``adamw_update`` from the same state and gradients: the port's
    m, v, master and params against the JAX ones (the same float32
    operations). Weights of size 1, so the weight-decay term
    (lr * wd * |w| = 3e-5 |w|) is 30x the tolerance at the largest weight; the
    gradients' norm is above grad_clip, so the clip binds. The JAX tree
    stacks two layers in leaf ``w``; the port has them as ``w0`` and ``w1``
    of one int8 group, which must share the stacked leaf's scale. The
    tolerance is 1e-6 of each leaf's largest value: the global norm sums
    the leaves in another order, so the clip factor may differ in its last
    bit."""
    from repro.training import optimizer as JO
    from repro_torch.training import optimizer as TO
    rng = np.random.default_rng(3)
    f32 = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    jp = {"w": f32(2, 8, 16), "b": f32(16)}
    jg = {"w": f32(2, 8, 16, scale=0.1), "b": f32(16, scale=0.01)}
    jg["w"][1] *= 10.0   # one layer's gradients dominate the stacked leaf's scale
    jm = {"w": f32(2, 8, 16, scale=0.01), "b": f32(16, scale=0.01)}
    jv = {"w": np.abs(f32(2, 8, 16, scale=1e-3)), "b": np.abs(f32(16, scale=1e-3))}
    jp = {k: jnp_cast(x, dtype) for k, x in jp.items()}
    tcfg = dict(grad_compression=compression)
    jopt = JO.OptState(np.int32(4), jm, jv, {k: np.asarray(x, np.float32) for k, x in jp.items()})
    want_p, want, _ = JO.adamw_update(jopt, jg, jp, JTrainConfig(**tcfg))

    split = lambda t: {"w0": t["w"][0], "w1": t["w"][1], "b": t["b"]}
    tensors = lambda t: {k: convert.to_tensor(np.array(x)) for k, x in split(t).items()}
    groups = {"w0": "w", "w1": "w", "b": "b"}

    def port(weight_decay):
        topt = TO.OptState(torch.tensor(4, dtype=torch.int32), tensors(jm), tensors(jv),
                           tensors(jopt.master))
        params = tensors(jp)
        _, topt, _ = TO.adamw_update(topt, tensors(jg), params, TrainConfig(
            weight_decay=weight_decay, **tcfg), groups)
        return topt, params

    topt, params = port(TrainConfig.weight_decay)
    tol = 1e-6

    def close(got, ref, what):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * np.abs(ref).max(),
                                   err_msg=what)

    for name in ("m", "v", "master"):
        ref = split(jax.device_get(getattr(want, name)))
        for k, t in getattr(topt, name).items():
            close(t.numpy(), ref[k], f"{name}.{k}")
    ref = split(jax.device_get(want_p))
    for k, t in params.items():
        assert t.dtype == getattr(torch, dtype)
        close(t.float().numpy(), ref[k], k)
    assert int(topt.step) == 5
    no_decay, _ = port(0.0)
    for k, w in topt.master.items():
        gap = float((no_decay.master[k] - w).abs().max())
        assert gap > 10 * tol * float(w.abs().max()), (k, gap)


def jnp_cast(x, dtype):
    """A numpy leaf in ``dtype`` (bfloat16 through ``ml_dtypes``)."""
    import ml_dtypes
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x
