"""The sLSTM recurrence's plain versions (``kernels/slstm_scan/ref.py``, what
``csrc/slstm_scan.cu`` computes) and its wrapper, on the CPU.

* The forward, ``slstm_scan_reference``, against the JAX recurrence built
  here as ``repro.models.xlstm.slstm_block_forward`` builds it (a
  ``lax.scan`` of ``_slstm_cell``): h and the final (h, c, n, m) at atol
  1e-5 (float32 sums in another order).
* The backward formulas, ``slstm_scan_backward_reference``, against
  ``jax.vjp`` of that scan for dxz, dxi, dxf, dxo and drec, each within
  1e-5 of the gradient's largest value (torch autograd through the plain
  loop measured 3.2e-7), also where the normaliser's floor max(n, 1e-6)
  wins: the input gate's pre-activation 20 below the forget gate's on the
  first steps, so i_log - f_log < -14 there (the share is asserted).
* ``SLSTMScanFunction`` on the CPU (the plain forward and the backward
  formulas) against torch autograd through the plain loop, within 2e-6 of
  each gradient's largest value.
* ``meta``: the kernels' shapes, no launch, and the work each call reports
  to the cost counter equal to ``cost.kernels.slstm``/``slstm_backward``;
  the sLSTM block's prefill, decode and train step reach the kernels.
* The plan (one cluster a head and row group) and the rejects.

Inputs are drawn with numpy from a seed: gate inputs N(0, 1), rec N(0,
1/dh) as ``init_slstm_block`` draws it, and a non-zero initial state where
a case asks for one (n in [0.5, 2], as a state from earlier steps has).
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.xlstm import _slstm_cell  # noqa: E402
from repro_torch.cost import kernels as work  # noqa: E402
from repro_torch.cost.analysis import CostCounter  # noqa: E402
from repro_torch.kernels.slstm_scan import ops  # noqa: E402
from repro_torch.kernels.slstm_scan.ref import (  # noqa: E402
    FLOOR, Saved, slstm_scan_backward_reference, slstm_scan_reference)

CASES = {  # name: (B, S, H, dh, non-zero initial state, input gate shift on the first steps)
    "2x64x4x16": (2, 64, 4, 16, False, 0.0),
    "1x33x4x64": (1, 33, 4, 64, False, 0.0),
    "decode_step": (3, 1, 4, 16, True, 0.0),
    "from_a_state": (2, 24, 2, 32, True, 0.0),
    "floor_wins": (2, 40, 4, 16, False, -20.0),
}
NAMES = ("dxz", "dxi", "dxf", "dxo", "drec")
FLOOR_STEPS = 3


def _inputs(B, S, H, dh, with_state, i_shift, seed=0):
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((B, S, H, dh)).astype(np.float32) for _ in range(4)]
    x[1][:, :FLOOR_STEPS] += i_shift
    if i_shift:
        x[2][:, :FLOOR_STEPS] += 4.0             # f_log near 0: i_log - f_log < -14
    rec = (rng.standard_normal((4, H, dh, dh)) / np.sqrt(dh)).astype(np.float32)
    if with_state:
        state = {"h": rng.standard_normal((B, H, dh)) * 0.5,
                 "c": rng.standard_normal((B, H, dh)),
                 "n": rng.uniform(0.5, 2.0, (B, H, dh)),
                 "m": rng.standard_normal((B, H))}
    else:
        state = {k: np.zeros((B, H, dh) if k != "m" else (B, H)) for k in "hcnm"}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    dh_out = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    return x, rec, state, dh_out


def _jax_scan(xz, xi, xf, xo, rec, state):
    def step(st, inp):
        st = _slstm_cell(rec, *inp, st)
        return st, st["h"]

    xs = tuple(a.transpose(1, 0, 2, 3) for a in (xz, xi, xf, xo))
    state, hs = jax.lax.scan(step, state, xs)
    return hs.transpose(1, 0, 2, 3), state


def _torch(arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _hold(got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        g = np.asarray(g.detach() if isinstance(g, torch.Tensor) else g, np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= tol, (name, err)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_the_jax_scan(case):
    x, rec, state, _ = _inputs(*CASES[case])
    h, final = slstm_scan_reference(*_torch(x), torch.from_numpy(rec),
                                    {k: torch.from_numpy(v) for k, v in state.items()})
    h_ref, final_ref = _jax_scan(*(jnp.asarray(a) for a in x), jnp.asarray(rec),
                                 {k: jnp.asarray(v) for k, v in state.items()})
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-5)
    assert set(final) == set(final_ref)
    for k in final:
        np.testing.assert_allclose(final[k].numpy(), np.asarray(final_ref[k]), atol=1e-5,
                                   err_msg=k)


def _formulas(x, rec, state, dh_out):
    st = {k: torch.from_numpy(v) for k, v in state.items()}
    rec_t = torch.from_numpy(rec)
    h, _, saved = slstm_scan_reference(*_torch(x), rec_t, st, with_saved=True)
    return h, saved, slstm_scan_backward_reference(rec_t, st, h, saved,
                                                   torch.from_numpy(dh_out))


def _floor_share(saved: Saved) -> float:
    return float((saved.n < FLOOR).double().mean())


@pytest.mark.parametrize("case", list(CASES))
def test_backward_formulas_match_jax_vjp(case):
    B, S, H, dh, with_state, i_shift = CASES[case]
    x, rec, state, dh_out = _inputs(*CASES[case])
    _, saved, got = _formulas(x, rec, state, dh_out)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    _, vjp = jax.vjp(lambda *a: _jax_scan(*a, jstate)[0], *(jnp.asarray(a) for a in x),
                     jnp.asarray(rec))
    _hold(got, vjp(jnp.asarray(dh_out)), 1e-5)
    share = _floor_share(saved)
    if i_shift:
        assert 0.0 < share < 1.0, share
        assert bool((saved.n[:, 0] < FLOOR).all())         # from step 0 on
    else:
        assert share == 0.0


@pytest.mark.parametrize("case", ["2x64x4x16", "from_a_state", "floor_wins"])
def test_autograd_function_on_the_cpu_matches_autograd_of_the_loop(case):
    x, rec, state, dh_out = _inputs(*CASES[case])
    st = {k: torch.from_numpy(v) for k, v in state.items()}
    leaves = _torch(x, grad=True) + _torch([rec], grad=True)
    h, final = ops.slstm_scan(*leaves, st)
    assert all(not t.requires_grad for t in final.values())
    got = torch.autograd.grad(h, leaves, torch.from_numpy(dh_out))
    h_ref, _ = slstm_scan_reference(*leaves, st)
    want = torch.autograd.grad(h_ref, leaves, torch.from_numpy(dh_out))
    assert torch.equal(h.detach(), h_ref.detach())
    _hold(got, want, 2e-6)


def test_saved_values_are_the_forwards():
    """The forward keeps what the backward reads: c, n, z, o of every step,
    and i_log, f_raw and m a head, consistent with h and the final state."""
    x, rec, state, _ = _inputs(*CASES["from_a_state"])
    st = {k: torch.from_numpy(v) for k, v in state.items()}
    h, final, saved = slstm_scan_reference(*_torch(x), torch.from_numpy(rec), st,
                                           with_saved=True)
    torch.testing.assert_close(h, saved.o * saved.c / saved.n.clamp_min(FLOOR))
    for k, got in (("c", saved.c[:, -1]), ("n", saved.n[:, -1]), ("m", saved.gates[:, -1, :, 2])):
        assert torch.equal(final[k], got), k
    assert saved.gates.shape == h.shape[:3] + (3,)


# ------------------------------------------------------------------ meta


def _meta(B, S, H, dh, grad=False):
    x = [torch.empty(B, S, H, dh, device="meta", requires_grad=grad) for _ in range(4)]
    rec = torch.empty(4, H, dh, dh, device="meta", requires_grad=grad)
    state = {k: torch.zeros((B, H, dh) if k != "m" else (B, H), device="meta") for k in "hcnm"}
    return x, rec, state


@pytest.mark.parametrize("B,S,H,dh", [(4, 512, 4, 512), (1, 2048, 4, 512), (2, 9, 4, 16)])
def test_meta_gives_the_kernels_shapes_and_reports_their_work(B, S, H, dh):
    before = (ops.slstm_scan.launches, ops.slstm_scan_backward.launches)
    x, rec, state = _meta(B, S, H, dh)
    with torch.no_grad(), CostCounter() as c:
        h, final = ops.slstm_scan(*x, rec, state)
    assert h.device.type == "meta" and h.shape == (B, S, H, dh) and h.dtype == torch.float32
    assert {k: tuple(v.shape) for k, v in final.items()} == {
        k: tuple(state[k].shape) for k in "hcnm"}
    assert c.totals()["kernel_detail"] == {"slstm_scan": {
        "launches": 1, "flops": work.slstm(B, S, H, dh)[0], "bytes": work.slstm(B, S, H, dh)[1]}}
    x, rec, state = _meta(B, S, H, dh, grad=True)
    with CostCounter() as c:
        h, _ = ops.slstm_scan(*x, rec, state)
        grads = torch.autograd.grad(h, [*x, rec], torch.empty_like(h))
    detail = c.totals()["kernel_detail"]
    assert detail["slstm_scan"]["flops"] == work.slstm(B, S, H, dh, saved=True)[0]
    assert detail["slstm_scan"]["bytes"] == work.slstm(B, S, H, dh, saved=True)[1]
    assert detail["slstm_scan_backward"] == {
        "launches": 1, "flops": work.slstm_backward(B, S, H, dh)[0],
        "bytes": work.slstm_backward(B, S, H, dh)[1]}
    assert [tuple(g.shape) for g in grads] == [(B, S, H, dh)] * 4 + [(4, H, dh, dh)]
    assert (ops.slstm_scan.launches, ops.slstm_scan_backward.launches) == before


@pytest.mark.parametrize("step", ["prefill", "decode", "train"])
def test_the_slstm_block_reaches_the_kernels(step):
    """SLSTMBlock on meta: one forward kernel a prefill and a decode step,
    forward and backward in a train step; no per-token loop of plain ops."""
    from repro_torch.configs import get_config
    from repro_torch.models.xlstm import SLSTMBlock, init_slstm_cache
    cfg = get_config("xlstm-1.3b")
    block = SLSTMBlock(cfg, dtype=torch.bfloat16, device="meta")
    block.rec.requires_grad_(step == "train")
    S = 1 if step == "decode" else 2048
    x = torch.empty(1, S, cfg.d_model, dtype=torch.bfloat16, device="meta",
                    requires_grad=step == "train")
    with CostCounter() as c:
        if step == "train":
            y = block(x)
            torch.autograd.grad(y, [x, block.rec], torch.empty_like(y))
        elif step == "decode":
            with torch.no_grad():
                block.decode(x, init_slstm_cache(cfg, 1, device="meta"))
        else:
            with torch.no_grad():
                block.prefill(x)
    t = c.totals()
    want = {"slstm_scan": 1} if step != "train" else {"slstm_scan": 1, "slstm_scan_backward": 1}
    assert {k: v["launches"] for k, v in t["kernel_detail"].items()} == want
    assert t["ops"] < 200, t["ops"]


# ---------------------------------------------------------- plan, rejects


def test_plan_at_the_model_shapes():
    """(C, P, Bc, groups): a cluster of 16 blocks of 32 columns a head at
    xlstm-1.3b's dh 512, one block where a head fits in it."""
    assert ops.scan_plan(4, 4, 512, 132) == (32, 16, 4, 1)    # xlstm-1.3b, serving
    assert ops.scan_plan(1, 4, 512, 132) == (32, 16, 1, 1)    # training
    assert ops.scan_plan(4, 4, 512, 114) == (32, 16, 4, 1)    # H100 PCIe
    assert ops.scan_plan(35, 4, 512, 132) == (32, 16, 7, 5)   # 35 rows in five groups
    assert ops.scan_plan(8, 4, 16, 132) == (16, 1, 8, 1)      # the launchers' reduced dh
    assert ops.scan_plan(2, 2, 128, 132) == (128, 1, 2, 1)    # chip_smoke's small model
    for B, H, dh, sms in ((4, 4, 512, 132), (1, 4, 512, 114), (2, 2, 128, 132), (3, 4, 64, 132),
                          (3, 3, 100, 132), (300, 4, 16, 132), (64, 64, 512, 132)):
        C, P, Bc, groups = ops.scan_plan(B, H, dh, sms)
        assert P <= ops.MAX_CLUSTER and P & (P - 1) == 0 and C == -(-dh // P)
        assert Bc * C <= ops.THREADS and Bc <= ops.MAX_ROWS and Bc * (groups - 1) < B <= Bc * groups
        assert 4 * max(ops.forward_smem_floats(Bc, dh, C, P),
                       ops.backward_smem_floats(Bc, dh, C, P)) <= ops.SMEM_LIMIT
    source = (Path(ops.__file__).parent / "csrc" / "slstm_scan.cu").read_text()
    for name in ("THREADS", "MAX_CLUSTER", "MAX_ROWS", "RING"):
        assert f"constexpr int {name} = {getattr(ops, name)};" in source, name


@pytest.mark.parametrize("B,H,dh,sms", [(0, 4, 16, 132), (4, 4, 1024, 132), (1, 4, 512, 8),
                                        (2, 0, 16, 132), (1, 1, 2048, 132)])
def test_plan_raises_where_no_resident_grid_exists(B, H, dh, sms):
    """No rows or heads, a head too wide for a cluster of 16 blocks (dh
    1024, 2048), or fewer SMs than the cluster a head needs."""
    with pytest.raises(ValueError):
        ops.scan_plan(B, H, dh, sms)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    x, rec, state = _meta(2, 8, 4, 16)
    with pytest.raises(ValueError):                     # shapes
        ops.slstm_scan(x[0], x[1][:, :4], x[2], x[3], rec, state)
    with pytest.raises(ValueError):
        ops.slstm_scan(*x, rec[:, :2], state)
    with pytest.raises(ValueError):
        ops.slstm_scan(*x, rec, {**state, "m": state["m"][:1]})
    with pytest.raises(ValueError):                     # dtype
        ops.slstm_scan(x[0].double(), *x[1:], rec, state)
    with pytest.raises(ValueError):                     # contiguity
        ops.slstm_scan(*x[:3], x[3].transpose(0, 1).contiguous().transpose(0, 1), rec, state)
    with pytest.raises(ValueError):                     # a head too wide for a cluster
        x, rec, state = _meta(2, 8, 1, 1024)
        ops.slstm_scan(*x, rec, state)
    with pytest.raises(ValueError):                     # one device
        cpu = torch.zeros(2, 8, 4, 16)
        ops.slstm_scan(cpu, *_meta(2, 8, 4, 16)[0][1:], *_meta(2, 8, 4, 16)[1:])


def test_a_card_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.card_plan(4, 4, 512, torch.device("cuda"))
