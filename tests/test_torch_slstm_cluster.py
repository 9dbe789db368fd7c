"""The cluster design of ``kernels/slstm_scan`` on the CPU: its plan and
the factored gate arithmetic it computes.

* ``ops.scan_plan`` at every shape the repo runs (xlstm-1.3b's dh 512 at B
  1 and 4 on 132 and on 114 SMs, every B up to 35 there, the launchers'
  reduced dh 16 at B 8, chip_smoke's small model B 2, H 2, dh 128): the
  blocks a cluster P, the columns a block C, the rows a cluster Bc and the
  row groups, each block's shared bytes within ``SMEM_LIMIT``. The 114-SM
  cases check the plan only: whether an H100 PCIe schedules a 16-block
  cluster of these blocks depends on how its SMs are grouped, and was read
  (``ops.residency``) on an H100 SXM alone.
* ``factored_scan``, the forward written here in the kernel's order: the
  head's i and f pre-activation means as sums over P blocks, in rank
  order, of per-block partials sum_e (xi_e / dh + h_e rho[e]) with rho
  rec's row means; only the z and o gates take full products. Held to
  ``slstm_scan_reference`` and to the JAX package's ``lax.scan`` of
  ``_slstm_cell`` at ``SLSTM_ATOL`` (1e-5, as chip_smoke holds the kernel).

Run as a script it holds the factored order against a float64 run of the
plain version at a large shape, with chip_smoke's inputs (x ~ N(0, 1), rec
~ N(0, 1 / dh), a zero state), beside the plain float32 version::

    PYTHONPATH=src python tests/test_torch_slstm_cluster.py --shape 1,2048,4,512

and prints both worst errors in h and their ratio (chip_smoke's limit for
the kernel is 3.0).
"""
import argparse
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.models.xlstm import _slstm_cell  # noqa: E402
from repro_torch.kernels.slstm_scan import ops  # noqa: E402
from repro_torch.kernels.slstm_scan.ref import FLOOR, slstm_scan_reference  # noqa: E402

SLSTM_ATOL = 1e-5


def factored_scan(xz, xi, xf, xo, rec, state, P: int):
    """h [B, S, H, dh] and the final state of the sLSTM recurrence with the
    sums in ``csrc/slstm_scan.cu``'s order for clusters of P blocks."""
    B, S, H, dh = xz.shape
    C = -(-dh // P)
    pad = P * C - dh
    rho = rec[1:3].sum(dim=-1) * (1.0 / dh)                   # [2, H, dh]
    w_zo = torch.cat((rec[0], rec[3]), dim=-1)                 # [H, dh, 2 dh]
    h, c, n, m = (state[k] for k in "hcnm")
    hs = []
    for t in range(S):
        sums = []
        for g, x in ((0, xi), (1, xf)):
            term = x[:, t] / dh + h * rho[g]                   # [B, H, dh]
            part = F.pad(term, (0, pad)).view(B, H, P, C).sum(dim=-1)
            total = part[..., 0]
            for q in range(1, P):                              # rank order
                total = total + part[..., q]
            sums.append(total)
        il, fr = sums
        fl = F.logsigmoid(fr)
        mn = torch.maximum(fl + m, il)
        ib, fb = torch.exp(il - mn)[..., None], torch.exp(fl + m - mn)[..., None]
        r = torch.einsum("bhd,hde->bhe", h, w_zo)
        z = torch.tanh(xz[:, t] + r[..., :dh])
        o = torch.sigmoid(xo[:, t] + r[..., dh:])
        c = fb * c + ib * z
        n = fb * n + ib
        h = o * c / n.clamp_min(FLOOR)
        m = mn
        hs.append(h)
    return torch.stack(hs, dim=1), {"h": h, "c": c, "n": n, "m": m}


def _inputs(B, S, H, dh, with_state, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((B, S, H, dh)) for _ in range(4)]
    rec = rng.standard_normal((4, H, dh, dh)) / np.sqrt(dh)
    if with_state:
        state = {"h": rng.standard_normal((B, H, dh)) * 0.5,
                 "c": rng.standard_normal((B, H, dh)),
                 "n": rng.uniform(0.5, 2.0, (B, H, dh)),
                 "m": rng.standard_normal((B, H))}
    else:
        state = {k: np.zeros((B, H, dh) if k != "m" else (B, H)) for k in "hcnm"}
    return ([a.astype(dtype) for a in x], rec.astype(dtype),
            {k: v.astype(dtype) for k, v in state.items()})


def _torch(x, rec, state, dtype=torch.float32):
    return ([torch.from_numpy(a).to(dtype) for a in x], torch.from_numpy(rec).to(dtype),
            {k: torch.from_numpy(v).to(dtype) for k, v in state.items()})


# ------------------------------------------------------------------ plan

PLANS = {  # (B, H, dh, SMs): (C, P, Bc, groups)
    "serving_prefill": ((4, 4, 512, 132), (32, 16, 4, 1)),
    "training": ((1, 4, 512, 132), (32, 16, 1, 1)),
    "serving_prefill_pcie": ((4, 4, 512, 114), (32, 16, 4, 1)),
    "training_pcie": ((1, 4, 512, 114), (32, 16, 1, 1)),
    "batch_35": ((35, 4, 512, 132), (32, 16, 7, 5)),
    "launchers_reduced": ((8, 4, 16, 132), (16, 1, 8, 1)),
    "small_model": ((2, 2, 128, 132), (128, 1, 2, 1)),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_plan_at_the_repos_shapes(case):
    (B, H, dh, sms), want = PLANS[case]
    plan = ops.scan_plan(B, H, dh, sms)
    assert plan == want
    C, P, Bc, groups = plan
    for floats in (ops.forward_smem_floats, ops.backward_smem_floats):
        assert 4 * floats(Bc, dh, C, P) <= ops.SMEM_LIMIT


@pytest.mark.parametrize("sms", [132, 114])
def test_plan_takes_every_batch_up_to_35_at_dh_512(sms):
    for B in range(1, 36):
        C, P, Bc, groups = ops.scan_plan(B, 4, 512, sms)
        assert (C, P) == (32, 16)
        assert Bc * (groups - 1) < B <= Bc * groups and Bc <= ops.MAX_ROWS
        assert groups == -(-B // 7)                     # 7 rows fit the backward's block
        for floats in (ops.forward_smem_floats, ops.backward_smem_floats):
            assert 4 * floats(Bc, 512, C, P) <= ops.SMEM_LIMIT


def test_shared_bytes_at_xlstm_widths():
    """The block's bytes: rec's z and o slices (128 KB) and its buffers."""
    assert 4 * ops.forward_smem_floats(4, 512, 32, 16) == 174336
    assert 4 * ops.backward_smem_floats(4, 512, 32, 16) == 203008
    assert 4 * ops.backward_smem_floats(8, 512, 32, 16) > ops.SMEM_LIMIT


# ------------------------------------------------------------------ the factored order

CASES = {  # name: (B, S, H, dh, a non-zero initial state, P)
    "one_block": (2, 40, 4, 16, False, 1),
    "four_blocks": (2, 24, 2, 32, True, 4),
    "sixteen_blocks": (1, 33, 4, 64, True, 16),
    "ragged_columns": (3, 20, 2, 20, True, 8),   # C 3: block 6 holds 2 columns, block 7 none
}


@pytest.mark.parametrize("case", list(CASES))
def test_factored_order_matches_the_plain_version(case):
    B, S, H, dh, with_state, P = CASES[case]
    x, rec, state = _torch(*_inputs(B, S, H, dh, with_state))
    h, final = factored_scan(*x, rec, state, P)
    h_ref, final_ref = slstm_scan_reference(*x, rec, state)
    torch.testing.assert_close(h, h_ref, atol=SLSTM_ATOL, rtol=0)
    for k in "hcnm":
        tol = SLSTM_ATOL * max(1.0, final_ref[k].abs().max().item())
        torch.testing.assert_close(final[k], final_ref[k], atol=tol, rtol=0, msg=k)


@pytest.mark.parametrize("case", ["four_blocks", "sixteen_blocks"])
def test_factored_order_matches_the_jax_scan(case):
    B, S, H, dh, with_state, P = CASES[case]
    xn, recn, staten = _inputs(B, S, H, dh, with_state)

    def step(st, inp):
        st = _slstm_cell(jnp.asarray(recn), *inp, st)
        return st, st["h"]

    xs = tuple(jnp.asarray(a.transpose(1, 0, 2, 3)) for a in xn)
    final_ref, hs = jax.lax.scan(step, {k: jnp.asarray(v) for k, v in staten.items()}, xs)
    x, rec, state = _torch(xn, recn, staten)
    h, final = factored_scan(*x, rec, state, P)
    np.testing.assert_allclose(h.numpy(), np.asarray(hs).transpose(1, 0, 2, 3), atol=SLSTM_ATOL)
    for k in "hcnm":
        tol = SLSTM_ATOL * max(1.0, float(np.abs(np.asarray(final_ref[k])).max()))
        np.testing.assert_allclose(final[k].numpy(), np.asarray(final_ref[k]), atol=tol,
                                   err_msg=k)


def test_factored_order_at_one_block_is_the_means():
    """With one block the partial sums are the means themselves: the
    factoring alone moves i_log and f_raw by float32 rounding only."""
    x, rec, state = _torch(*_inputs(2, 1, 2, 16, True))
    h, _ = factored_scan(*x, rec, state, 1)
    h64, _ = slstm_scan_reference(*(t.double() for t in x), rec.double(),
                                  {k: v.double() for k, v in state.items()})
    assert (h.double() - h64).abs().max().item() < 1e-6


def float64_errors(B: int, S: int, H: int, dh: int, P: int, seed: int = 0) -> dict:
    """The worst error in h against a float64 run of the plain version, of
    the factored order and of the plain version, both in float32."""
    xn, recn, staten = _inputs(B, S, H, dh, False, seed)
    x64, rec64, state64 = _torch(xn, recn, staten, torch.float64)
    want, _ = slstm_scan_reference(*x64, rec64, state64)
    x, rec, state = _torch(xn, recn, staten)
    fact, _ = factored_scan(*x, rec, state, P)
    plain, _ = slstm_scan_reference(*x, rec, state)
    err = {"factored": (fact.double() - want).abs().max().item(),
           "plain": (plain.double() - want).abs().max().item()}
    return {**err, "ratio": err["factored"] / err["plain"],
            "factored_vs_plain": (fact - plain).abs().max().item()}


def test_float64_errors_at_a_small_shape():
    err = float64_errors(1, 64, 2, 64, 16)
    assert err["factored"] <= 3.0 * err["plain"] and err["factored_vs_plain"] <= SLSTM_ATOL


def test_phase_build_names_the_kernel_phases():
    """The phase tool's names follow the kernel's ``enum Phase``; the phase
    clocks are the source's only diagnostic build."""
    import re
    from pathlib import Path
    from repro_torch.kernels.slstm_scan import phases
    source = (Path(ops.__file__).parent / "csrc" / "slstm_scan.cu").read_text()
    enum = re.search(r"enum Phase \{([^}]*)\}", source).group(1)
    assert [n.strip().lower() for n in enum.split(",")] == [*phases.PHASES, "n_phases"]
    assert set(re.findall(r"#ifn?def (\w+)", source)) == {phases.FLAG.removeprefix("-D")}
    assert set(phases.SHAPES.values()) == {(4, 512, 4, 512), (1, 2048, 4, 512)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shape", default="1,2048,4,512", help="B,S,H,dh")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    B, S, H, dh = (int(v) for v in args.shape.split(","))
    plan = ops.scan_plan(B, H, dh, ops.H100_SMS)
    print(json.dumps({"shape": [B, S, H, dh], "plan": list(plan),
                      **float64_errors(B, S, H, dh, plan.blocks, args.seed)}))


if __name__ == "__main__":
    main()
