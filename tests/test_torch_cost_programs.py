"""The port's counted FLOPs (``cost.analysis`` on the meta device) against
the JAX package's for the same reduced cell: ``analyze_text`` of the
program the test lowers and compiles.

The two programs differ by known terms, each computed here by formula and
named; what is left is held within 2%:

* attention: JAX's ``chunked_causal_attention`` visits whole chunks, which
  at these lengths is the whole S × S block (``attention.py:95–98``; a
  windowed layer pads a whole chunk of keys in front: S × 2S), and its
  backward multiplies 4 products; the port's flash kernels count the
  causal pairs they visit (``cost.kernels``), the backward 5 products;
* mLSTM: JAX's ``mlstm_chunkwise`` multiplies the whole c × c block of each
  chunk (q k^T, W v and W k) and the inter-chunk products; the port's
  kernel counts the causal pairs (``cost.kernels.mlstm``). In a train step
  JAX differentiates it through XLA: its forward and backward are counted
  as one program of their own (``jax.vjp`` of ``mlstm_chunkwise`` at the
  layer's shapes, by the same ``analyze_text``), the port's by its two
  kernels' formulas (``cost.kernels.mlstm`` and ``mlstm_backward``).
* sLSTM: JAX runs a ``lax.scan`` of ``_slstm_cell`` (four einsums a step),
  and in a train step differentiates it through XLA (``jax.vjp`` of that
  scan, counted as a program of its own at the layer's shapes); the port
  runs one ``slstm_scan`` kernel a layer and, in training, its backward
  kernel and one product for the recurrent weights' gradient, counted by
  ``cost.kernels.slstm`` and ``slstm_backward`` and the product's formula.

Decode attention reads every slot on both sides: no term.
"""
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.hlo.analysis import analyze_text  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.training import train_step as JS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.cost import kernels as work  # noqa: E402
from repro_torch.cost.analysis import CostCounter  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import make_decode_fn, make_prefill_fn  # noqa: E402
from repro_torch.training.train_step import make_train_step, train_state  # noqa: E402

RTOL = 0.02


def _cfgs(arch):
    return JC.reduced_config(JC.ARCHS[arch]), TC.reduced_config(TC.get_config(arch))


def _jax_flops(fn, *args):
    return analyze_text(jax.jit(fn).lower(*args).compile().as_text())["flops"]


def _attention_terms(cfg, B, S, passes):
    """(JAX's, the port's) attention FLOPs of one step: ``passes`` is
    "forward" or "train" (forward and backward, no remat)."""
    H, hd = cfg.num_heads, cfg.head_dim
    jax_f = port_f = 0
    for kind in cfg.layer_kinds():
        if kind not in ("attn", "local"):
            continue
        window = cfg.window_size if kind == "local" else 0
        keys = 2 * S if window else S          # the padded chunk of keys in front
        block = 2 * B * H * S * keys * hd       # one product over the visited block
        jax_f += 2 * block + (4 * block if passes == "train" else 0)
        port_f += work.flash_forward(B, S, H, cfg.num_kv_heads, hd, window)[0]
        if passes == "train":
            port_f += work.flash_backward(B, S, H, cfg.num_kv_heads, hd, window)[0]
    return jax_f, port_f


def _mlstm_terms(cfg, B, S):
    """(JAX's, the port's) mLSTM FLOPs of one forward."""
    from repro_torch.kernels.mlstm_chunk import ops
    from repro_torch.kernels.mlstm_chunk.ref import chunk_size
    from repro_torch.models.xlstm import mlstm_dims
    _, H, dqk, dv = mlstm_dims(cfg)
    c = chunk_size(S, 256)
    n = cfg.layer_kinds().count("mlstm")
    per_chunk = (2 * c * c * (2 * dqk + dv)    # q k^T, W v, W k over the whole block
                 + 4 * c * dqk * dv             # q C, the C update
                 + 6 * c * dqk)                 # q . n, q . n_intra, the n update
    jax_f = n * B * H * (S // c) * per_chunk
    port_f = n * work.mlstm(B, S, H, dqk, dv, c)[0]
    return jax_f, port_f


def _mlstm_train_terms(cfg, jcfg, B, S):
    """(JAX's, the port's) mLSTM FLOPs of one train step without remat:
    forward and backward of every mLSTM layer."""
    from repro.models.xlstm import mlstm_chunkwise
    from repro_torch.kernels.mlstm_chunk import ops
    from repro_torch.kernels.mlstm_chunk.ref import chunk_size
    from repro_torch.models.xlstm import mlstm_dims
    _, H, dqk, dv = mlstm_dims(cfg)
    c = chunk_size(S, 256)
    n = cfg.layer_kinds().count("mlstm")
    dt = jnp.dtype(jcfg.compute_dtype)
    args = [jax.ShapeDtypeStruct(shape, t) for shape, t in (
        ((B, S, H, dqk), dt), ((B, S, H, dqk), dt), ((B, S, H, dv), dt),
        ((B, S, H), jnp.float32), ((B, S, H), jnp.float32))]

    def fwd_bwd(*a):
        h, vjp = jax.vjp(lambda *x: mlstm_chunkwise(*x, chunk=256), *a)
        return vjp(h)

    jax_f = n * _jax_flops(fwd_bwd, *args)
    path = ops.backward_path(getattr(torch, dt.name), dqk, dv)
    port_f = n * (work.mlstm(B, S, H, dqk, dv, c)[0]
                  + work.mlstm_backward(B, S, H, dqk, dv, c, path=path)[0])
    return jax_f, port_f


def _slstm_terms(cfg, B, S, passes):
    """(JAX's, the port's) sLSTM FLOPs of one forward (``passes`` "forward")
    or of a train step without remat ("train")."""
    from repro.models.xlstm import _slstm_cell
    n = cfg.layer_kinds().count("slstm")
    H = cfg.num_heads
    dh = cfg.d_model // H
    f32 = jnp.float32
    args = [jax.ShapeDtypeStruct(shape, f32) for shape in
            [(B, S, H, dh)] * 4 + [(4, H, dh, dh)]]

    def scan(xz, xi, xf, xo, rec):
        state = {k: jnp.zeros((B, H, dh) if k != "m" else (B, H), f32) for k in "hcnm"}

        def step(st, inp):
            st = _slstm_cell(rec, *inp, st)
            return st, st["h"]

        _, hs = jax.lax.scan(step, state, tuple(a.transpose(1, 0, 2, 3)
                                                for a in (xz, xi, xf, xo)))
        return hs

    if passes == "forward":
        return n * _jax_flops(scan, *args), n * work.slstm(B, S, H, dh)[0]

    def fwd_bwd(*a):
        h, vjp = jax.vjp(scan, *a)
        return vjp(h)

    drec = 2 * 4 * H * dh * B * S * dh          # the product h_{t-1}^T dpre
    port_f = (work.slstm(B, S, H, dh, saved=True)[0] + work.slstm_backward(B, S, H, dh)[0]
              + drec)
    return n * _jax_flops(fwd_bwd, *args), n * port_f


def _hold(jax_total, port_total, terms):
    jax_rest = jax_total - sum(t[0] for t in terms.values())
    port_rest = port_total - sum(t[1] for t in terms.values())
    assert port_rest == pytest.approx(jax_rest, rel=RTOL), (jax_total, port_total, terms)


def test_qwen2_train_step_flops_match_jax():
    jcfg, cfg = _cfgs("qwen2-7b")
    B, S = 2, 64
    jtcfg, tcfg = JTrainConfig(remat="none"), TrainConfig(remat="none")
    state = jax.eval_shape(lambda k: JS.init_state(k, jcfg), jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    jf = _jax_flops(JS.make_train_step(jcfg, jtcfg), state, batch)
    tstate = train_state(M.CausalLM(cfg, device="meta"))
    tbatch = {k: torch.empty((B, S), dtype=torch.int32, device="meta") for k in batch}
    with CostCounter() as c:
        make_train_step(cfg, tcfg)(tstate, tbatch)
    _hold(jf, c.totals()["flops"], {"attention": _attention_terms(cfg, B, S, "train")})


def test_xlstm_train_step_flops_match_jax():
    jcfg, cfg = _cfgs("xlstm-1.3b")
    B, S = 2, 64
    jtcfg, tcfg = JTrainConfig(remat="none"), TrainConfig(remat="none")
    state = jax.eval_shape(lambda k: JS.init_state(k, jcfg), jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    jf = _jax_flops(JS.make_train_step(jcfg, jtcfg), state, batch)
    tstate = train_state(M.CausalLM(cfg, device="meta"))
    tbatch = {k: torch.empty((B, S), dtype=torch.int32, device="meta") for k in batch}
    with CostCounter() as c:
        make_train_step(cfg, tcfg)(tstate, tbatch)
    t = c.totals()
    n, n_s = cfg.layer_kinds().count("mlstm"), cfg.layer_kinds().count("slstm")
    assert {k: v["launches"] for k, v in t["kernel_detail"].items()} == {
        "mlstm_chunk": n, "mlstm_chunk_backward": n, "slstm_scan": n_s,
        "slstm_scan_backward": n_s}
    _hold(jf, t["flops"], {"mlstm": _mlstm_train_terms(cfg, jcfg, B, S),
                           "slstm": _slstm_terms(cfg, B, S, "train")})


def test_qwen3_moe_prefill_flops_match_jax():
    jcfg, cfg = _cfgs("qwen3-moe-30b-a3b")
    B, S = 2, 64
    params = jax.eval_shape(lambda k: JM.init_params(k, jcfg), jax.random.PRNGKey(0))
    jf = _jax_flops(JE.make_prefill_fn(jcfg, moe_groups=1, max_len=S), params,
                    jax.ShapeDtypeStruct((B, S), jnp.int32))
    model = M.CausalLM(cfg, device="meta")
    with torch.no_grad(), CostCounter() as c:
        make_prefill_fn(cfg, max_len=S)(model, torch.empty((B, S), dtype=torch.int32,
                                                              device="meta"))
    _hold(jf, c.totals()["flops"], {"attention": _attention_terms(cfg, B, S, "forward")})


def test_recurrentgemma_decode_flops_match_jax():
    jcfg, cfg = _cfgs("recurrentgemma-2b")
    B, L = 2, 64
    params = jax.eval_shape(lambda k: JM.init_params(k, jcfg), jax.random.PRNGKey(0))
    cache = JM.init_cache(jcfg, B, L, dtype=jnp.float32, abstract=True)
    jf = _jax_flops(JE.make_decode_fn(jcfg), params, cache,
                    jax.ShapeDtypeStruct((B, 1), jnp.int32), jax.ShapeDtypeStruct((), jnp.int32))
    model = M.CausalLM(cfg, device="meta")
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
    with torch.no_grad():
        _, caches = M.prefill(model, tokens, max_len=L)
        with CostCounter() as c:
            make_decode_fn(cfg)(model, caches, tokens, L - 1)
    t = c.totals()
    assert t["kernel_detail"]["decode_attention"]["launches"] == \
        cfg.layer_kinds().count("local") + cfg.layer_kinds().count("attn")
    _hold(jf, t["flops"], {})


def test_xlstm_prefill_flops_match_jax():
    jcfg, cfg = _cfgs("xlstm-1.3b")
    B, S = 2, 64
    params = jax.eval_shape(lambda k: JM.init_params(k, jcfg), jax.random.PRNGKey(0))
    jf = _jax_flops(JE.make_prefill_fn(jcfg, max_len=S), params,
                    jax.ShapeDtypeStruct((B, S), jnp.int32))
    model = M.CausalLM(cfg, device="meta")
    with torch.no_grad(), CostCounter() as c:
        make_prefill_fn(cfg, max_len=S)(model, torch.empty((B, S), dtype=torch.int32,
                                                              device="meta"))
    t = c.totals()
    kinds = cfg.layer_kinds()
    assert {k: v["launches"] for k, v in t["kernel_detail"].items()} == {
        "mlstm_chunk": kinds.count("mlstm"), "slstm_scan": kinds.count("slstm")}
    _hold(jf, t["flops"], {"mlstm": _mlstm_terms(cfg, B, S),
                           "slstm": _slstm_terms(cfg, B, S, "forward")})
