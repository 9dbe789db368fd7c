"""The port's per-rank cost counter (``repro_torch.cost.analysis``) against
the JAX package's HLO counter (``repro.hlo.analysis``), and the kernels'
counts on the meta device.

* FLOPs of a small program within 1% of the products' count and of the
  JAX counter's on the same program (``test_real_lowered_program_flops``'s
  counterpart); a loop of six products counts six times one
  (``test_scan_vs_unroll_parity``'s counterpart: an eager loop is unrolled
  by nature);
* the wire bytes of each collective kind over 2, 4 and 8 ranks equal
  ``HloCostModel._ring_factor``'s for the same payload, through the port's
  collectives on an abstract group;
* each kernel wrapper on meta tensors returns its kernel's shapes, launches
  nothing, and reports exactly its ``cost.kernels`` formula, forward and
  the three backward kernels; the CUDA path's scratch counts in the peak;
* the peak counts storages, not views, from their allocation to their
  release, with the ``live`` tensors from the start.
"""
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.hlo.analysis import HloCostModel, analyze_text  # noqa: E402
from repro_torch.cost import analysis, kernels as work  # noqa: E402
from repro_torch.cost.analysis import CostCounter  # noqa: E402
from repro_torch.sharding import collectives as coll  # noqa: E402


def test_real_program_flops():
    def f(x, w1, w2):
        return torch.sum(torch.tanh(x @ w1) @ w2)

    x, w1, w2 = torch.randn(32, 64), torch.randn(64, 128), torch.randn(128, 16)
    t = analysis.analyze(f, x, w1, w2)
    want = 2 * 32 * 64 * 128 + 2 * 32 * 128 * 16
    assert t["flops"] == pytest.approx(want, rel=0.01)

    def jf(x, w1, w2):
        return jnp.sum(jnp.tanh(x @ w1) @ w2)

    shapes = (jax.ShapeDtypeStruct((32, 64), jnp.float32),
              jax.ShapeDtypeStruct((64, 128), jnp.float32),
              jax.ShapeDtypeStruct((128, 16), jnp.float32))
    jt = analyze_text(jax.jit(jf).lower(*shapes).compile().as_text())
    assert t["flops"] == pytest.approx(jt["flops"], rel=0.01)


def test_a_loop_of_six_products_counts_six_times_one():
    x, ws = torch.randn(16, 32, device="meta"), torch.randn(6, 32, 32, device="meta")

    def body(x, w):
        return torch.tanh(x @ w)

    def loop(x, ws):
        for i in range(6):
            x = body(x, ws[i])
        return x

    one = analysis.analyze(body, x, ws[0])["flops"]
    six = analysis.analyze(loop, x, ws)["flops"]
    assert one == 2 * 16 * 32 * 32
    assert six == pytest.approx(6 * one, rel=0.01)


_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")


@pytest.mark.parametrize("n", [2, 4, 8])
def test_collective_wire_bytes_match_the_ring_factors(n):
    """Each kind through the port's collectives on an abstract group of n
    ranks (meta tensors: nothing is sent) against the HLO counter's factor
    for the op whose result type it would read."""
    hlo = HloCostModel("")
    attrs = f"replica_groups=[1,{n}]<={n}"
    group = coll.AbstractGroup(n, 0)
    x = torch.empty(8 * n, 16, device="meta")               # the whole payload
    block = torch.empty(8, 16, device="meta")
    for kind in _KINDS:
        with CostCounter() as c:
            if kind == "all-reduce":
                coll.all_reduce(x, group)
                result = f"f32[{8 * n},16]"
            elif kind == "all-gather":
                out = coll.all_gather_into(torch.empty_like(x), block, group)
                assert out.shape == x.shape
                result = f"f32[{8 * n},16]"
            elif kind == "reduce-scatter":
                out = coll.reduce_scatter_into(torch.empty_like(block), x, group)
                assert out.shape == block.shape
                result = "f32[8,16]"
            else:
                coll.all_to_all_into(torch.empty_like(x), x, group)
                result = f"f32[{8 * n},16]"
        want = hlo._ring_factor(kind, attrs, result)
        assert c.totals()["collective_detail"] == {kind: pytest.approx(want, rel=1e-12)}
        assert c.totals()["collective_bytes"] == pytest.approx(want, rel=1e-12)


def test_a_real_group_of_one_rank_sends_nothing_and_abstract_groups_take_meta_only():
    assert analysis.ring_bytes("all-reduce", 1024.0, 1) == 0.0
    with pytest.raises(ValueError):
        coll.all_reduce(torch.ones(4), coll.AbstractGroup(2, 0))


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def _kernels(c):
    return {k: (v["launches"], v["flops"], v["bytes"])
            for k, v in c.totals()["kernel_detail"].items()}


@pytest.mark.parametrize("hd,dtype", [(64, torch.bfloat16), (16, torch.float32),
                                      (256, torch.bfloat16)])
def test_flash_on_meta_counts_its_formula_forward_and_backward(hd, dtype):
    from repro_torch.kernels.flash_attention import ops
    B, S, H, K, window = 2, 96, 4, 2, 40
    q = _meta(B, S, H, hd, dtype=dtype, grad=True)
    k, v = _meta(B, S, K, hd, dtype=dtype, grad=True), _meta(B, S, K, hd, dtype=dtype,
                                                             grad=True)
    before = (ops.flash_attention.launches, ops.flash_attention_backward.launches)
    es = q.element_size()
    with torch.no_grad(), CostCounter() as c:
        out = ops.flash_attention(q, k, v, window=window)
    assert out.shape == q.shape and out.device.type == "meta" and out.dtype == dtype
    assert _kernels(c) == {"flash_attention": (1, *work.flash_forward(
        B, S, H, K, hd, window, es))}
    with CostCounter() as c:
        out = ops.flash_attention(q, k, v, window=window)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert _kernels(c) == {
        "flash_attention": (1, *work.flash_forward(B, S, H, K, hd, window, es, lse=True)),
        "flash_attention_backward": (1, *work.flash_backward(B, S, H, K, hd, window, es))}
    assert (ops.flash_attention.launches, ops.flash_attention_backward.launches) == before


def test_flash_backward_on_meta_holds_the_cuda_paths_scratch():
    """The tensor-core backward's row and partial buffers count in the peak
    as they would on the card."""
    from repro_torch.kernels.flash_attention import ops
    B, S, H, K, hd = 1, 128, 4, 2, 64
    q, o, do = (_meta(B, S, H, hd) for _ in range(3))
    k, v = _meta(B, S, K, hd), _meta(B, S, K, hd)
    lse = _meta(B, H, S, dtype=torch.float32)
    live = (q, k, v, o, do, lse)
    with CostCounter(live=live) as c:
        dq, dk, dv = ops.flash_attention_backward(q, k, v, o, do, lse)
    held = sum(t.numel() * t.element_size() for t in live)
    grads = sum(t.numel() * t.element_size() for t in (dq, dk, dv))
    rows = 4 * 2 * B * H * -(-S // ops.BWD_BLOCK) * ops.BWD_BLOCK
    part = 4 * 2 * B * S * H * hd
    assert c.totals()["peak_bytes"] == held + grads + rows + part


def test_decode_on_meta_counts_the_whole_cache():
    from repro_torch.kernels.decode_attention import ops
    B, H, K, L, hd = 3, 8, 2, 100, 128
    q, ck, cv = _meta(B, H, hd), _meta(B, L, K, hd), _meta(B, L, K, hd)
    pos = torch.empty(L, dtype=torch.int32, device="meta")
    before = ops.decode_attention.launches
    with CostCounter() as c:
        out = ops.decode_attention(q, ck, cv, pos, 10)
    assert out.shape == q.shape and out.device.type == "meta"
    assert _kernels(c) == {"decode_attention": (1, *work.decode(B, H, K, L, hd))}
    assert ops.decode_attention.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mlstm_on_meta_counts_its_formula_and_its_scratch(dtype):
    from repro_torch.kernels.mlstm_chunk import ops
    B, S, H, dqk, dv, chunk = 2, 192, 2, 64, 128, 64
    q, k = _meta(B, S, H, dqk, dtype=dtype), _meta(B, S, H, dqk, dtype=dtype)
    v = _meta(B, S, H, dv, dtype=dtype)
    i_log, f_log = _meta(B, S, H, dtype=torch.float32), _meta(B, S, H, dtype=torch.float32)
    live = (q, k, v, i_log, f_log)
    with CostCounter(live=live) as c:
        h, (C, n, m) = ops.mlstm_chunk(q, k, v, i_log, f_log, chunk=chunk, return_state=True)
    assert (h.shape, C.shape, n.shape, m.shape) == ((B, S, H, dv), (B, H, dqk, dv),
                                                    (B, H, dqk), (B, H))
    assert _kernels(c) == {"mlstm_chunk": (1, *work.mlstm(B, S, H, dqk, dv, chunk,
                                                           q.element_size()))}
    outs = sum(t.numel() * t.element_size() for t in (h, C, n, m))
    interior = B * H * (S // chunk - 1)
    scratch = interior * (dqk * dv * 2 + dqk * 4) if dtype == torch.bfloat16 else 0
    held = sum(t.numel() * t.element_size() for t in live)
    assert c.totals()["peak_bytes"] == held + outs + scratch


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mlstm_on_meta_under_autograd_counts_forward_and_backward(dtype):
    """Under autograd the meta call takes ``MLSTMChunkFunction``: the
    forward and the backward kernels each report their formula once, no
    plain version runs, nothing launches, and the gradients have the inputs'
    shapes and dtypes; the backward's float32 scratch counts in the peak."""
    from repro_torch.kernels.mlstm_chunk import ops
    B, S, H, dqk, dv, chunk = 1, 192, 2, 64, 96, 64
    q, k = _meta(B, S, H, dqk, dtype=dtype, grad=True), _meta(B, S, H, dqk, dtype=dtype, grad=True)
    v = _meta(B, S, H, dv, dtype=dtype, grad=True)
    i_log, f_log = (_meta(B, S, H, dtype=torch.float32, grad=True) for _ in range(2))
    ins = (q, k, v, i_log, f_log)
    before = (ops.mlstm_chunk.launches, ops.mlstm_chunk_backward.launches)
    with CostCounter() as c:
        h = ops.mlstm_chunk(*ins, chunk=chunk)
        grads = torch.autograd.grad(h, ins, torch.empty_like(h))
    assert [(g.shape, g.dtype) for g in grads] == [(t.shape, t.dtype) for t in ins]
    es = q.element_size()
    assert _kernels(c) == {
        "mlstm_chunk": (1, *work.mlstm(B, S, H, dqk, dv, chunk, es)),
        "mlstm_chunk_backward": (1, *work.mlstm_backward(
            B, S, H, dqk, dv, chunk, es, path=ops.backward_path(dtype, dqk, dv)))}
    assert "plain_versions" not in c.totals()
    assert c.totals()["peak_bytes"] >= 4 * ops.workspace_floats(B, S, H, dqk, dv, chunk, dtype)
    assert (ops.mlstm_chunk.launches, ops.mlstm_chunk_backward.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_on_meta_counts_forward_and_backward(dtype):
    from repro_torch.kernels.rglru_scan import ops
    B, S, W = 2, 300, 96
    a, b = _meta(B, S, W, dtype=dtype, grad=True), _meta(B, S, W, dtype=dtype, grad=True)
    h0 = _meta(B, W, dtype=torch.float32)
    before = (ops.rglru_scan.launches, ops.rglru_scan_backward.launches)
    with CostCounter() as c:
        h = ops.rglru_scan(a, b, h0)
        da, db = torch.autograd.grad(h, (a, b), torch.empty_like(h))
    assert h.shape == (B, S, W) and h.dtype == dtype
    assert (da.shape, db.shape, da.dtype) == (a.shape, b.shape, dtype)
    es = a.element_size()
    assert _kernels(c) == {"rglru_scan": (1, *work.rglru_forward(B, S, W, es, es)),
                           "rglru_scan_backward": (1, *work.rglru_backward(B, S, W))}
    assert (ops.rglru_scan.launches, ops.rglru_scan_backward.launches) == before


def test_the_formulas_are_chip_smokes_bounds():
    """The closed form of the visible pairs is the sum chip_smoke's rows
    took, and the formulas give the integers its kernel rows divided."""
    for S in (1, 2, 7, 64, 513, 3072):
        for window in (0, 1, 5, 64, 2048, 5000):
            want = sum(min(q + 1, window) if window > 0 else q + 1 for q in range(S))
            assert work.visible_pairs(S, window) == want
    B, S, H, K, hd = 4, 512, 28, 4, 128
    assert work.flash_forward(B, S, H, K, hd) == (
        4 * B * H * hd * S * (S + 1) // 2, 2 * (2 * B * S * H * hd + 2 * B * S * K * hd))
    assert work.decode(4, 28, 4, 544, 128) == (4 * 4 * 28 * 128 * 544,
                                                2 * (2 * 4 * 28 * 128 + 2 * 4 * 544 * 4 * 128)
                                                + 4 * 544)
    assert work.rglru_forward(4, 512, 2560) == (2 * 4 * 512 * 2560,
                                                4 * (3 * 4 * 512 * 2560 + 4 * 2560))
    assert work.rglru_backward(1, 3072, 2560) == (3 * 3072 * 2560,
                                                  4 * (5 * 3072 * 2560 + 2 * 2560))
    c, dqk, dv = 256, 512, 1024                        # xlstm-1.3b's training layer
    pairs = c * (c + 1) // 2
    # bf16 on the tensor cores: 7 chunk boundaries, each [c, dqk] x [c, dv]
    # product (two walks, three inter terms) twice for its hi and lo operand;
    # the intra products with dS or W' twice, the scores and dP once
    per_head = 7 * (20 * c * dqk * dv + 10 * c * dqk) + 8 * (pairs * (10 * dqk + 6 * dv)
                                                             + 2 * c * dv) + 6 * 2 * dqk * dv
    assert work.mlstm_backward(1, 2048, 4, dqk, dv, c) == (
        4 * per_head, 2 * 2048 * 4 * (4 * dqk + 4 * dv) + 16 * 2048 * 4)
    # float32 on CUDA cores: the states recomputed, the scores twice
    per_chunk = 10 * c * dqk * dv + pairs * (8 * dqk + 4 * dv) + 6 * c * dqk + 2 * c * dv
    assert work.mlstm_backward(1, 2048, 4, dqk, dv, c, 4, path="cuda_cores") == (
        4 * 8 * per_chunk, 4 * 2048 * 4 * (4 * dqk + 4 * dv) + 16 * 2048 * 4)
    own = 8 * c * dqk * dv + c * (c + 1) // 2 * (6 * dqk + 4 * dv) + 4 * c * dqk + 2 * c * dv
    assert work.mlstm_backward(1, 2048, 4, dqk, dv, c, as_built=False) == (
        4 * 8 * own, 2 * 2048 * 4 * (4 * dqk + 4 * dv) + 16 * 2048 * 4)


def test_peak_counts_storages_not_views_until_released():
    n = 1 << 20
    x = torch.empty(n, device="meta")                        # 4 MiB, live
    with CostCounter(live=(x,)) as c:
        y = x * 2                                            # +4
        v = y.view(2, -1)[0]                                 # a view: +0
        z = torch.cat([v, v])                                # +4 -> 12
        del y, z                                             # v holds y's storage
        w = torch.empty(2 * n, device="meta")                # +8 -> 16
        del w, v
        u = torch.empty(n // 2, device="meta")               # 4 + 2
    t = c.totals()
    assert t["peak_bytes"] == 16 * n
    assert c.current == 4 * n + 2 * n
    del u
