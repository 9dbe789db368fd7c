"""The backward formulas the port's CUDA backward kernels implement, held on
the CPU against autograd of the plain forward versions and against the JAX
package's gradients (``jax.vjp`` of ``chunked_causal_attention`` and of the
``associative_scan`` recurrence, the functions JAX training differentiates).

* Flash attention (``flash_attention_backward_reference``, also through
  ``flash_attention`` with inputs that require grad): head dims 16 and 64,
  causal with and without a window, G = H / K > 1, and non-causal. float32,
  tolerance 2e-5 against autograd (the same float32 products summed in
  another order) and 1e-4 against JAX (a chunked online softmax on that
  side; gradients are sums over up to S keys).
* RG-LRU scan (``rglru_scan_backward_reference``): the reverse recurrence
  with a nonzero h0, 1e-5 against autograd of the step loop and 1e-4
  against JAX (an associative scan rounds otherwise; the JAX forward test
  holds h at 2e-4 for the same reason).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru_scan.ref import rglru_scan_reference as jax_scan_ref  # noqa: E402
from repro.models.attention import chunked_causal_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_backward_reference, flash_attention_reference)
from repro_torch.kernels.rglru_scan import ops as rops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_scan_backward_reference, rglru_scan_reference)

FLASH_CASES = [  # (B, S, H, K, hd, window, causal)
    (2, 48, 4, 2, 16, 0, True),
    (1, 64, 6, 2, 16, 24, True),
    (2, 40, 4, 1, 64, 0, True),
    (1, 64, 8, 2, 64, 16, True),
    (1, 32, 4, 4, 64, 0, False),
]


def _flash_inputs(B, S, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd))]


def _autograd_flash(q, k, v, do, causal, window):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention_reference(*ts, causal=causal, window=window)
    return torch.autograd.grad(out, ts, torch.from_numpy(do))


@pytest.mark.parametrize("B,S,H,K,hd,window,causal", FLASH_CASES)
def test_flash_backward_formulas_match_autograd(B, S, H, K, hd, window, causal):
    q, k, v, do = _flash_inputs(B, S, H, K, hd)
    want = _autograd_flash(q, k, v, do, causal, window)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_attention_reference(tq, tk, tv, causal=causal, window=window,
                                         return_lse=True)
    got = flash_attention_backward_reference(tq, tk, tv, out, torch.from_numpy(do), lse,
                                             causal=causal, window=window)
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=2e-5, rtol=0, msg=f"d{name}")


@pytest.mark.parametrize("B,S,H,K,hd,window,causal", FLASH_CASES[:4])
def test_flash_backward_matches_jax_vjp(B, S, H, K, hd, window, causal):
    q, k, v, do = _flash_inputs(B, S, H, K, hd, seed=1)
    pos = jnp.arange(S, dtype=jnp.int32)
    _, vjp = jax.vjp(lambda a, b, c: chunked_causal_attention(a, b, c, pos, window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = fops.flash_attention_backward.launches
    out = fops.flash_attention(*ts, causal=True, window=window)   # the autograd Function
    got = torch.autograd.grad(out, ts, torch.from_numpy(do))
    assert fops.flash_attention_backward.launches == before        # no kernel on the CPU
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, err_msg=f"d{name}")


def test_flash_forward_lse_is_the_masked_logsumexp():
    q, k, v, _ = _flash_inputs(2, 40, 6, 3, 16)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_attention_reference(tq, tk, tv, causal=True, window=8, return_lse=True)
    assert torch.equal(out, flash_attention_reference(tq, tk, tv, causal=True, window=8))
    s = torch.einsum("bqhd,bshd->bhqs", tq, tk.repeat_interleave(2, dim=2)) / 4.0
    qp, kp = torch.arange(40)[:, None], torch.arange(40)[None, :]
    s = s.masked_fill(~((kp <= qp) & (kp > qp - 8)), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), atol=1e-5, rtol=0)


def test_flash_function_records_only_under_autograd():
    """Inputs without grad take the plain forward as before (no LSE); with
    grad, the Function's forward gives the same output."""
    q, k, v, _ = _flash_inputs(1, 32, 4, 2, 16)
    plain = fops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert plain.grad_fn is None
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fops.flash_attention(*ts)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    assert torch.equal(out.detach(), plain)
    with torch.no_grad():
        assert fops.flash_attention(*ts).grad_fn is None


def _scan_inputs(B, S, W, seed=0):
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, W)))) * 0.2 + 0.79
    return [x.astype(np.float32) for x in (a, rng.standard_normal((B, S, W)) * 0.1,
                                            rng.standard_normal((B, W)),
                                            rng.standard_normal((B, S, W)))]


@pytest.mark.parametrize("B,S,W", [(2, 37, 24), (1, 64, 8), (3, 1, 5)])
def test_scan_backward_formulas_match_autograd(B, S, W):
    a, b, h0, dh = _scan_inputs(B, S, W)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (a, b, h0)]
    h = rglru_scan_reference(*ts)
    want = torch.autograd.grad(h, ts, torch.from_numpy(dh))
    got = rglru_scan_backward_reference(torch.from_numpy(a), h.detach(),
                                        torch.from_numpy(h0), torch.from_numpy(dh))
    for g, w, name in zip(got, want, ("a", "b", "h0")):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0, msg=f"d{name}")


def test_scan_backward_matches_jax_vjp():
    a, b, h0, dh = _scan_inputs(2, 48, 16, seed=3)
    _, vjp = jax.vjp(jax_scan_ref, jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    want = vjp(jnp.asarray(dh))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (a, b, h0)]
    before = rops.rglru_scan_backward.launches
    h = rops.rglru_scan(*ts)                                      # the autograd Function
    assert type(h.grad_fn).__name__ == "RGLRUScanFunctionBackward"
    got = torch.autograd.grad(h, ts, torch.from_numpy(dh))
    assert rops.rglru_scan_backward.launches == before
    for g, w, name in zip(got, want, ("a", "b", "h0")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, err_msg=f"d{name}")


def test_backward_wrappers_reject_bad_shapes():
    q, k, v, do = (torch.from_numpy(x) for x in _flash_inputs(1, 16, 2, 1, 16))
    out, lse = flash_attention_reference(q, k, v, return_lse=True)
    with pytest.raises(ValueError):
        fops.flash_attention_backward(q, k, v, out, do[:, :8], lse)
    with pytest.raises(ValueError):
        fops.flash_attention_backward(q, k, v, out, do, lse[:, :, :8])
    a, b, h0, dh = (torch.from_numpy(x) for x in _scan_inputs(1, 8, 4))
    with pytest.raises(ValueError):
        rops.rglru_scan_backward(a, b, h0, dh[:, :4])
