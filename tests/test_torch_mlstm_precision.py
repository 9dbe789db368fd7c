"""Which operands of the bf16 mLSTM backward need float32 accuracy.

The tensor-core path of ``kernels/mlstm_chunk/csrc/mlstm_chunk_bwd.cu``
feeds every product bf16 operands. q, k, v and dh are bf16 already; the
float32 values that enter a product -- dec_k k in the state walk, dec_q q /
N in the dstate walk, the chunk-start states C_t, their gradients G_t, dS and
W' -- are each split into bf16 hi + lo (two products, ~2^-17 a term).
``backward_rounded`` evaluates ``ref.mlstm_chunk_backward_reference``'s
formulas in float32 with chosen ones of those operands rounded to bf16 once
instead; the tests hold it, with nothing rounded, to the reference itself.

Run as a script, it prints each gradient's worst element as a share of
chip_smoke's bf16 ``grad_tol`` (2^-7 |ref| + 1e-2 rms(ref)) against the
reference on the same inputs, for the kernel's choice (none rounded), each
operand rounded alone and all of them rounded, on the CPU::

    PYTHONPATH=src python tests/test_torch_mlstm_precision.py --shape 1,512,2,128,256
"""
import argparse
import json
from typing import Iterable

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mlstm_chunk.ref import (  # noqa: E402
    _join, _split, chunk_gates, chunk_size, mlstm_chunk_backward_reference,
    mlstm_chunk_reference)

OPERANDS = ("state", "dstate", "C", "G", "dS", "W")
NAMES = ("dq", "dk", "dv", "di", "df")


def _bf16(x: torch.Tensor, rounded: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype) if rounded else x


def backward_rounded(q, k, v, i_log, f_log, h, dh, *, chunk: int = 256,
                     rounded: Iterable[str] = ()):
    """dq, dk, dv (bf16) and di, df (float32) by the reference's formulas,
    with the operands named in ``rounded`` (of ``OPERANDS``) rounded to bf16
    where the kernel feeds them to a product."""
    rounded = set(rounded)
    if not rounded <= set(OPERANDS):
        raise ValueError(f"operands are {OPERANDS}, got {sorted(rounded)}")
    B, S, H, dqk = q.shape
    dv = v.shape[-1]
    c = chunk_size(S, chunk)
    T = S // c
    qs, ks, vs, hs, dhs, il, fl = (_split(x, B, T, c, H) for x in (q, k, v, h, dh, i_log, f_log))
    C = torch.zeros((B, H, dqk, dv))
    n = torch.zeros((B, H, dqk))
    m = torch.zeros((B, H))
    states = []
    for t in range(T):
        gates = chunk_gates(il[t], fl[t], m)
        states.append((C, n, gates))
        kd = ks[t] * gates.dec_k[..., None]
        C = C * gates.decay[..., None, None] + _bf16(kd, "state" in rounded).transpose(-1, -2) @ vs[t]
        n = n * gates.decay[..., None] + kd.sum(dim=-2)
        m = gates.m_state
    G = torch.zeros((B, H, dqk, dv))
    dn = torch.zeros((B, H, dqk))
    grads = [None] * T
    for t in reversed(range(T)):
        C, n, g = states[t]
        qc, kc, vc = qs[t], ks[t], vs[t]
        s = qc @ kc.transpose(-1, -2)
        den = (s * s * g.d_mat).sum(dim=-1) + (qc @ n[..., None])[..., 0] * g.dec_q
        floor = torch.exp(-g.m_j)
        N = torch.maximum(den.abs(), floor)
        dN = -(dhs[t] * hs[t]).sum(dim=-1) / N
        dd = torch.where(den.abs() >= floor, dN * torch.sign(den), torch.zeros_like(dN))
        dp = (dhs[t] @ vc.transpose(-1, -2)) / N[..., None]
        ds = g.d_mat * (dp + 2.0 * s * dd[..., None])
        w = s * g.d_mat / N[..., None]
        dlog_d = g.d_mat * s * (dp + s * dd[..., None])
        Cb, Gb = _bf16(C, "C" in rounded), _bf16(G, "G" in rounded)
        inter = (dhs[t] @ Cb.transpose(-1, -2)) / N[..., None] + dd[..., None] * n[..., None, :]
        r = vc @ Gb.transpose(-1, -2) + dn[..., None, :]
        dg = g.dec_k * (kc * r).sum(dim=-1)
        db = dlog_d.sum(dim=-1) - dlog_d.sum(dim=-2) - dg + g.dec_q * (qc * inter).sum(dim=-1)
        db[..., -1] += dg.sum(dim=-1) + g.decay * ((Cb * G).sum(dim=(-2, -1))
                                                   + (n * dn).sum(dim=-1))
        dsb, wb = _bf16(ds, "dS" in rounded), _bf16(w, "W" in rounded)
        grads[t] = (dsb @ kc + g.dec_q[..., None] * inter,
                    dsb.transpose(-1, -2) @ qc + g.dec_k[..., None] * r,
                    wb.transpose(-1, -2) @ dhs[t] + g.dec_k[..., None] * (kc @ Gb),
                    dlog_d.sum(dim=-2) + dg,
                    torch.flip(torch.cumsum(torch.flip(db, (-1,)), dim=-1), (-1,)))
        qn = qc * (g.dec_q / N)[..., None]
        G = g.decay[..., None, None] * G + _bf16(qn, "dstate" in rounded).transpose(-1, -2) @ dhs[t]
        dn = g.decay[..., None] * dn + (qc * (g.dec_q * dd)[..., None]).sum(dim=-2)
    dq, dk, dvs, di, df = zip(*grads)
    return (_join(dq, B, S, H, q.dtype), _join(dk, B, S, H, k.dtype),
            _join(dvs, B, S, H, v.dtype), _join(di, B, S, H, torch.float32),
            _join(df, B, S, H, torch.float32))


def worst_shares(got, ref) -> dict:
    """Each gradient's worst element as a share of its bf16 tolerance,
    2^-7 |ref| + 1e-2 rms(ref) (chip_smoke's ``grad_tol``)."""
    out = {}
    for name, g, r in zip(NAMES, got, ref):
        g, r = g.float(), r.float()
        tol = 2.0 ** -7 * r.abs() + 1e-2 * r.square().mean().sqrt()
        out[name] = ((g - r).abs() / tol.clamp_min(1e-30)).max().item()
    return out


def inputs(B: int, S: int, H: int, dqk: int, dv: int, seed: int = 0):
    """bf16 q, k, v, float32 gates and bf16 dh drawn as chip_smoke draws the
    mLSTM's (k / sqrt(dqk), forget gates log_sigmoid(N(0, 1) + 2)), on the
    CPU."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, dqk, generator=gen)
    k = torch.randn(B, S, H, dqk, generator=gen) / dqk ** 0.5
    v = torch.randn(B, S, H, dv, generator=gen)
    il = torch.randn(B, S, H, generator=gen)
    fl = torch.nn.functional.logsigmoid(torch.randn(B, S, H, generator=gen) + 2)
    dh = torch.randn(B, S, H, dv, generator=gen)
    bf16 = torch.bfloat16
    return (q.to(bf16), k.to(bf16), v.to(bf16), il, fl), dh.to(bf16)


def test_precision_emulation_rounds_only_what_it_names():
    """``backward_rounded`` with nothing rounded is the reference's formulas
    (same float32 operations, another grouping); rounding every float32
    operand to bf16 once moves the gradients, finite."""
    args, dh = inputs(1, 128, 2, 16, 24, seed=1)
    h = mlstm_chunk_reference(*args, chunk=64)
    ref = mlstm_chunk_backward_reference(*args, h, dh, chunk=64)
    exact = backward_rounded(*args, h, dh, chunk=64)
    shares = worst_shares(exact, ref)
    assert set(shares) == set(NAMES) and max(shares.values()) < 0.5, shares
    assert [g.dtype for g in exact] == [g.dtype for g in ref]
    rounded = backward_rounded(*args, h, dh, chunk=64, rounded=OPERANDS)
    assert all(torch.isfinite(g.float()).all() for g in rounded)
    assert max(worst_shares(rounded, ref).values()) > max(shares.values())
    with pytest.raises(ValueError):
        backward_rounded(*args, h, dh, chunk=64, rounded=("q",))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shape", default="1,512,2,128,256", help="B,S,H,dqk,dv")
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    shape = tuple(int(x) for x in a.shape.split(","))
    args, dh = inputs(*shape, seed=a.seed)
    h = mlstm_chunk_reference(*args, chunk=a.chunk)
    ref = mlstm_chunk_backward_reference(*args, h, dh, chunk=a.chunk)
    variants = {"none (the kernel)": (), **{f"{o} alone": (o,) for o in OPERANDS},
                "all": OPERANDS}
    for label, rounded in variants.items():
        got = backward_rounded(*args, h, dh, chunk=a.chunk, rounded=rounded)
        print(json.dumps({"shape": list(shape), "chunk": a.chunk, "rounded": label,
                          "worst_share": worst_shares(got, ref)}), flush=True)


if __name__ == "__main__":
    main()
