"""Rank processes of ``test_torch_tensor_parallel``'s layer tests: each
parallel layer of the port on one rank of a 1 x n ``gloo`` mesh against its
unsplit self on the same inputs (made from a seed with numpy), forward and
gradients. A mismatch raises, and the rank exits non-zero. Imports nothing
of JAX, so that a rank starts fast.
"""
import numpy as np
import torch
import torch.distributed as dist
from torch import nn

RTOL = 1e-5       # of each output's largest magnitude (at least 1)


def main(rank, n, store, name):
    """One rank of a 1 x n mesh: each parallel layer against its unsplit
    self on the same inputs, forward and gradients (raises on a mismatch)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import Dense, Embedding
    from repro_torch.sharding import partitioning as pt
    from repro_torch.training.train_step import cross_entropy
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n)
    try:
        mesh = make_mesh((1, n), ("data", "model"), ["cpu"] * n)
        mp = pt.model_parallel(mesh)
        rng = np.random.default_rng(7)
        t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
        D, F, V, B, S = 16, 24, 32, 2, 8
        x, kernel, up = t(B, S, D), t(D, F), t(B, S, F)

        def check(got, want, what):
            err = (got - want).abs().max().item()
            assert err <= RTOL * max(1.0, want.abs().max().item()), (what, err)

        def layer(kind, shape, full):
            d = Dense(shape[0], shape[1], dtype=torch.float32, device="cpu")
            spec = pt.Spec(None, "model") if kind == "column" else pt.Spec("model", None)
            d.kernel = nn.Parameter(pt.local_cut(full, spec, mesh.coords(), mesh).clone())
            d.mp = mp
            return d

        if name == "column":        # [D, F] cut on F: x replicated -> y block
            dense = layer("column", (D, F), kernel)
            xr = x.clone().requires_grad_(True)
            y = dense(xr)
            (y * mp.split(up, -1)).sum().backward()
            xf = x.clone().requires_grad_(True)
            kf = kernel.clone().requires_grad_(True)
            yf = xf @ kf
            (yf * up).sum().backward()
            check(y, mp.split(yf.detach(), -1), "forward")
            check(xr.grad, xf.grad, "input gradient")
            check(dense.kernel.grad, pt.local_cut(kf.grad, pt.Spec(None, "model"),
                                                  mesh.coords(), mesh), "kernel gradient")
        elif name == "row":         # [F, D] cut on F: x block -> y replicated
            kT, xin, dy = t(F, D), t(B, S, F), t(B, S, D)
            dense = layer("row", (F, D), kT)
            xl = mp.split(xin, -1).clone().requires_grad_(True)
            y = dense(xl)
            (y * dy).sum().backward()
            xf = xin.clone().requires_grad_(True)
            kf = kT.clone().requires_grad_(True)
            yf = xf @ kf
            (yf * dy).sum().backward()
            check(y, yf.detach(), "forward")
            check(xl.grad, mp.split(xf.grad, -1), "input gradient")
            check(dense.kernel.grad, pt.local_cut(kf.grad, pt.Spec("model", None),
                                                  mesh.coords(), mesh), "kernel gradient")
            # a whole input is cut by the layer itself, and under sequence
            # parallelism the output is this rank's block of the sequence
            xw = xin.clone().requires_grad_(True)
            ys = dense(xw, seq_cut=True)
            (ys * mp.split(dy, 1)).sum().backward()
            check(ys, mp.split(yf.detach(), 1), "seq-cut forward")
            check(xw.grad, xf.grad, "whole-input gradient")
        elif name == "embedding":   # [V, D] cut on V
            table = t(V, D)
            ids = torch.from_numpy(rng.integers(0, V, (B, S)))
            emb = Embedding(V, D, dtype=torch.float32, device="cpu")
            emb.table = nn.Parameter(pt.local_cut(table, pt.Spec("model", None),
                                                  mesh.coords(), mesh).clone())
            emb.mp = mp
            dx = t(B, S, D)
            y = emb(ids, torch.float32)
            (y * dx).sum().backward()
            tf = table.clone().requires_grad_(True)
            yf = tf[ids]
            (yf * dx).sum().backward()
            check(y, yf.detach(), "forward")
            check(emb.table.grad, pt.local_cut(tf.grad, pt.Spec("model", None),
                                               mesh.coords(), mesh), "table gradient")
            h = t(B, S, D)
            hr = h.clone().requires_grad_(True)
            logits = emb.unembed(hr)
            dl = t(B, S, V)
            (logits * mp.split(dl, -1)).sum().backward()
            hf = h.clone().requires_grad_(True)
            (hf @ table.T * dl).sum().backward()
            check(logits, mp.split((h @ table.T), -1), "unembed forward")
            check(hr.grad, hf.grad, "unembed input gradient")
        elif name == "cross_entropy":
            logits, labels = t(B, S, V), torch.from_numpy(rng.integers(0, V, (B, S)))
            lc = mp.split(logits, -1).clone().requires_grad_(True)
            loss, nll = cross_entropy(lc, labels, 1e-4, mp, V)
            loss.backward()
            lf = logits.clone().requires_grad_(True)
            want, want_nll = cross_entropy(lf, labels, 1e-4)
            want.backward()
            check(loss.detach(), want.detach(), "loss")
            check(nll, want_nll.detach(), "nll")
            check(lc.grad, mp.split(lf.grad, -1), "logit gradient")
        dist.barrier()
    finally:
        dist.destroy_process_group()
