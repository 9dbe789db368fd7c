"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``gpu``: they build the kernels with nvcc and skip where there is no
CUDA device. Run them on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

Tolerances are those of the JAX package's kernel tests: float32 2e-5 (sums
in another order), bf16 3e-2 (one rounding of the output to bf16).
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,win,causal", [
    (2, 256, 4, 2, 0, True), (1, 512, 4, 4, 0, True), (2, 256, 8, 2, 128, True),
    (1, 256, 2, 1, 64, True), (1, 500, 28, 4, 0, True), (1, 130, 4, 2, 0, False),
])
def test_flash_kernel_matches_plain(cuda, B, S, H, K, win, causal, dtype):
    from repro_torch.kernels.flash_attention import ops
    q = _randn(cuda, B, S, H, 128, dtype=dtype)
    k = _randn(cuda, B, S, K, 128, dtype=dtype)
    v = _randn(cuda, B, S, K, 128, dtype=dtype)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=win)
    ref = ops.flash_attention_reference(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,L,win,fill", [
    (2, 8, 2, 1024, 0, 1024), (2, 8, 4, 1024, 0, 700), (1, 4, 1, 512, 256, 512),
    (4, 28, 4, 544, 0, 513), (1, 32, 32, 300, 0, 300),
])
def test_decode_kernel_matches_plain(cuda, B, H, K, L, win, fill, dtype):
    from repro_torch.kernels.decode_attention import ops
    q = _randn(cuda, B, H, 128, dtype=dtype)
    ck = _randn(cuda, B, L, K, 128, dtype=dtype)
    cv = _randn(cuda, B, L, K, 128, dtype=dtype)
    ar = torch.arange(L, device="cuda", dtype=torch.int32)
    sp = torch.where(ar < fill, ar, torch.full_like(ar, -1))
    before = ops.decode_attention.launches
    out = ops.decode_attention(q, ck, cv, sp, fill - 1, window=win)
    ref = ops.decode_attention_reference(q, ck, cv, sp, fill - 1, window=win)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


def test_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    q = _randn(cuda, 1, 64, 4, 64, dtype=torch.float32)       # head_dim 64
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = _randn(cuda, 1, 4, 128, dtype=torch.float16)
    c = _randn(cuda, 1, 16, 2, 128, dtype=torch.float16)
    with pytest.raises(ValueError):
        decode_attention(q, c, c, torch.arange(16, device="cuda", dtype=torch.int32), 15)
