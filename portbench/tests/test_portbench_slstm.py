"""The xlstm reference's sLSTM backward, a reverse walk written out by hand
(``reference.xlstm._backward``), is the gradient of its forward loop: autograd
through the same steps (``slstm_autograd``) gives the same gradients in
float64, where the normaliser's floor wins too."""
import pytest
import torch

from portbench.reference import xlstm

CASES = {
    "plain": dict(B=2, S=12, H=2, dh=8, i_shift=0.0, f_shift=0.0),
    "floor_wins": dict(B=2, S=10, H=2, dh=8, i_shift=-40.0, f_shift=6.0),
    "input_gate_wins": dict(B=1, S=16, H=3, dh=4, i_shift=3.0, f_shift=-3.0),
}


def inputs(B, S, H, dh, i_shift, f_shift, seed=5):
    gen = torch.Generator().manual_seed(seed)
    x = [torch.randn((B, S, H, dh), generator=gen, dtype=torch.float64) for _ in range(4)]
    x[1] = x[1] + i_shift
    x[2] = x[2] + f_shift
    rec = torch.randn((4, H, dh, dh), generator=gen, dtype=torch.float64) / dh ** 0.5
    return [t.requires_grad_(True) for t in x + [rec]]


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_reverse_walk_is_autograd_of_the_loop(case):
    args = inputs(**CASES[case])
    h = xlstm.slstm_recurrence(*args, xlstm.matmul)
    h_ref = xlstm.slstm_autograd(*args)
    assert torch.allclose(h, h_ref, rtol=0, atol=1e-12)
    dh = torch.randn(h.shape, generator=torch.Generator().manual_seed(9), dtype=torch.float64)
    got = torch.autograd.grad(h, args, dh)
    want = torch.autograd.grad(h_ref, args, dh)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-9, atol=1e-9 * float(w.abs().max())), \
            float((g - w).abs().max())
    if case == "floor_wins":
        _, saved = xlstm._recurrence(*[a.detach() for a in args], xlstm.matmul, saved=True)
        assert bool((saved[1] < xlstm.FLOOR).any())
