"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``gpu``: they build the kernels with nvcc and skip where there is no
CUDA device. Run them on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

Tolerances are those of the JAX package's kernel tests: float32 2e-5 (sums
in another order), bf16 3e-2 (one rounding of the output to bf16); the mLSTM
kernel's are stated at its test.
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


def _launcher_default_shapes():
    """The mLSTM's (B, S, H, dqk, dv, chunk) and the scan's (B, S, W) in the
    prefill of ``python -m repro_torch.launch.serve`` at its defaults: a
    batch of ``--max-batch`` prompts of ``--prompt-len`` tokens through the
    reduced xlstm-1.3b and recurrentgemma-2b."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import build_parser
    from repro_torch.models.xlstm import PREFILL_CHUNK, mlstm_dims
    args = build_parser().parse_args([])
    B, S = args.max_batch, args.prompt_len
    _, H, dqk, dv = mlstm_dims(reduced_config(get_config("xlstm-1.3b")))
    W = reduced_config(get_config("recurrentgemma-2b")).lru_width
    return (B, S, H, dqk, dv, PREFILL_CHUNK), (B, S, W)


MLSTM_DEFAULTS, SCAN_DEFAULTS = _launcher_default_shapes()


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


def _flash_case(gen, B, S, H, K, hd, dtype=torch.bfloat16):
    return (_randn(gen, B, S, H, hd, dtype=dtype), _randn(gen, B, S, K, hd, dtype=dtype),
            _randn(gen, B, S, K, hd, dtype=dtype))


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("B,S,H,K,win,causal", [
    (2, 500, 28, 4, 0, True),                    # ragged S, group 7
    (1, 300, 10, 1, 0, True),                    # group 10
    (2, 130, 4, 2, 0, False),                    # ragged, not causal
    (1, 256, 4, 4, 63, True),                    # group 1; windows at tile edges
    (1, 256, 7, 1, 64, True),
    (1, 300, 10, 1, 65, True),
    (1, 500, 4, 2, 127, True),
    (1, 200, 4, 2, 64, False),                   # window, not causal
])
def test_flash_bf16_tensor_core_kernel_edges(cuda, B, S, H, K, win, causal, hd):
    """The wgmma/TMA kernel at the edges of its 64-row and BK-key tiles."""
    from repro_torch.kernels.flash_attention import ops
    q, k, v = _flash_case(cuda, B, S, H, K, hd)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=win)
    ref = ops.flash_attention_reference(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (B, S, H, hd)
    assert (out.float() - ref.float()).abs().max().item() < TOL[torch.bfloat16]


@pytest.mark.parametrize("hd", [16, 64, 128, 256])
def test_flash_bf16_every_compiled_instance_matches_plain(cuda, hd):
    """The head dim's one bf16 instance, over shapes in turn: each call reuses
    or adds a cached plan and must still read its own tensors (head_dim 16
    takes the CUDA-core kernel, the others the tensor-core one)."""
    from repro_torch.kernels.flash_attention import ops
    for B, S, H, K, win, causal in [(2, 500, 28, 4, 0, True), (1, 130, 4, 2, 0, False),
                                    (1, 300, 10, 1, 65, True), (1, 256, 7, 1, 64, True),
                                    (2, 500, 28, 4, 0, True)]:
        q, k, v = _flash_case(cuda, B, S, H, K, hd)
        ref = ops.flash_attention_reference(q, k, v, causal=causal, window=win)
        out = ops.flash_attention(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        assert err < TOL[torch.bfloat16], ((B, S, H, K, win, causal), err)


@pytest.mark.parametrize("hd", [128, 256])
def test_flash_bf16_takes_slices_of_a_fused_qkv(cuda, hd):
    """q, k and v as head slices of one [B, S, H + 2K, hd] tensor: TMA reads
    them through their own strides, no copy."""
    from repro_torch.kernels.flash_attention import ops
    B, S, H, K = 2, 300, 8, 2
    fused = _randn(cuda, B, S, H + 2 * K, hd, dtype=torch.bfloat16)
    q, k, v = fused[:, :, :H], fused[:, :, H:H + K], fused[:, :, H + K:]
    assert not q.is_contiguous()
    out = ops.flash_attention(q, k, v)
    ref = ops.flash_attention_reference(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() < TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("B,S,H,K,win,causal", [
    (8, 8, 4, 2, 0, True),                       # reduced qwen2-7b's prefill at the defaults
    (8, 8, 4, 1, 16, True),                      # reduced recurrentgemma-2b's (window 16)
    (2, 500, 28, 4, 0, True), (1, 300, 10, 1, 65, True),   # ragged S; groups 7, 10
    (2, 130, 4, 2, 0, False), (1, 256, 4, 4, 63, True),    # not causal; window at an edge
])
def test_flash_kernel_small_head_dims_match_plain(cuda, B, S, H, K, win, causal, hd, dtype):
    """head_dim 16 (every reduced config) and 64 (musicgen-large)."""
    from repro_torch.kernels.flash_attention import ops
    q, k, v = _flash_case(cuda, B, S, H, K, hd, dtype)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=win)
    ref = ops.flash_attention_reference(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, S, H, hd)
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


def test_flash_bf16_rejects_layouts_tma_cannot_take(cuda):
    from repro_torch.kernels.flash_attention import ops
    B, S, H, hd = 1, 64, 4, 128
    q, k, v = _flash_case(cuda, B, S, H, H, hd)
    n = B * S * H * hd
    shifted = _randn(cuda, n + 8, dtype=torch.bfloat16)[1:n + 1].view(B, S, H, hd)
    odd_rows = _randn(cuda, B, S, H * hd + 1, dtype=torch.bfloat16)[..., :H * hd]
    odd_rows = odd_rows.unflatten(-1, (H, hd))                 # seq stride 1026 bytes
    strided_hd = _randn(cuda, B, S, H, 2 * hd, dtype=torch.bfloat16)[..., ::2]
    before = ops.flash_attention.launches
    for bad in (shifted, odd_rows, strided_hd):
        with pytest.raises(ValueError, match="TMA"):
            ops.flash_attention(bad, k, v)
        with pytest.raises(ValueError, match="TMA"):
            ops.flash_attention(q, k, bad)
    assert ops.flash_attention.launches == before


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,win", [(4, 512, 0), (2, 300, 0), (2, 512, 128),
                                     (1, 130, 64)])
def test_flash_kernel_head_dim_256_group_10_matches_plain(cuda, B, S, win, dtype):
    """recurrentgemma-2b's heads: 10 query heads over 1 kv head, head_dim 256."""
    from repro_torch.kernels.flash_attention import ops
    q = _randn(cuda, B, S, 10, 256, dtype=dtype)
    k = _randn(cuda, B, S, 1, 256, dtype=dtype)
    v = _randn(cuda, B, S, 1, 256, dtype=dtype)
    out = ops.flash_attention(q, k, v, window=win)
    ref = ops.flash_attention_reference(q, k, v, window=win)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,L,win,fill", [
    (4, 10, 1, 544, 0, 544), (4, 10, 1, 544, 0, 513),   # recurrentgemma-2b decode
    (2, 10, 1, 320, 128, 300),                          # window < filled slots
    (1, 16, 1, 256, 0, 200), (2, 6, 2, 100, 0, 100),    # 2 x 8 heads; 3 heads
    (1, 4, 4, 64, 0, 64),
])
def test_decode_kernel_head_dim_256_matches_plain(cuda, B, H, K, L, win, fill, dtype):
    from repro_torch.kernels.decode_attention import ops
    q = _randn(cuda, B, H, 256, dtype=dtype)
    ck = _randn(cuda, B, L, K, 256, dtype=dtype)
    cv = _randn(cuda, B, L, K, 256, dtype=dtype)
    ar = torch.arange(L, device="cuda", dtype=torch.int32)
    sp = torch.where(ar < fill, ar, torch.full_like(ar, -1))
    out = ops.decode_attention(q, ck, cv, sp, fill - 1, window=win)
    ref = ops.decode_attention_reference(q, ck, cv, sp, fill - 1, window=win)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,hd,win", [
    (4, 512, 32, 4, 128, 0),        # qwen3-moe-30b-a3b prefill: group 8
    (2, 300, 32, 4, 128, 0),
    (4, 512, 16, 8, 256, 1024),     # gemma3-12b prefill, a local layer (window > S)
    (4, 512, 16, 8, 256, 0),        # gemma3-12b, a global layer
    (1, 1536, 16, 8, 256, 1024),    # gemma3-12b local layer past its window
    (1, 1100, 16, 8, 256, 1024),
])
def test_flash_kernel_at_the_new_archs_shapes_matches_plain(cuda, B, S, H, K, hd, win, dtype):
    from repro_torch.kernels.flash_attention import ops
    q = _randn(cuda, B, S, H, hd, dtype=dtype)
    k = _randn(cuda, B, S, K, hd, dtype=dtype)
    v = _randn(cuda, B, S, K, hd, dtype=dtype)
    out = ops.flash_attention(q, k, v, window=win)
    ref = ops.flash_attention_reference(q, k, v, window=win)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,hd,L,win,cur", [
    (4, 32, 4, 128, 544, 0, 543),       # qwen3-moe-30b-a3b decode, last step
    (4, 32, 4, 128, 544, 0, 512),       # first step
    (4, 16, 8, 256, 544, 1024, 543),    # gemma3-12b decode, a local layer
    (4, 16, 8, 256, 544, 0, 512),       # a global layer
    (4, 16, 8, 256, 1024, 1024, 1535),  # the local layers' 1024-slot ring, wrapped
    (1, 16, 8, 256, 1024, 1024, 3000),
])
def test_decode_kernel_at_the_new_archs_shapes_matches_plain(cuda, B, H, K, hd, L, win,
                                                             cur, dtype):
    """Slots hold positions as the model's cache does: p in slot p % L for
    the last min(L, cur + 1) positions, -1 elsewhere."""
    from repro_torch.kernels.decode_attention import ops
    q, ck, cv = _decode_case(cuda, B, H, K, hd, L, dtype)
    slot = torch.arange(L, device="cuda")
    newest = cur - (cur - slot) % L                     # the position each slot holds
    sp = torch.where(newest >= 0, newest, -1).to(torch.int32)
    out = ops.decode_attention(q, ck, cv, sp, cur, window=win)
    ref = ops.decode_attention_reference(q, ck, cv, sp, cur, window=win)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


def test_moe_on_the_card_is_the_same_bits_every_call_and_matches_the_cpu(cuda):
    """The MoE (plain PyTorch) at a dropping capacity: bf16 output bit-equal
    across calls on the card (the combine sums in a fixed order, no
    atomics); float32 output within 1e-5 of the CPU's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.moe import MoE
    cfg = get_config("qwen3-moe-30b-a3b").with_(d_model=256)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, num_experts=16, top_k=4,
                                            d_ff_expert=64, capacity_factor=1.0))
    for dtype in (torch.float32, torch.bfloat16):
        cpu = MoE(cfg, dtype=dtype, device="cpu")
        with torch.no_grad():
            cpu.reset_parameters(torch.Generator().manual_seed(0))
        card = MoE(cfg, dtype=dtype, device="cuda")
        card.load_state_dict(cpu.state_dict())
        x = torch.randn(4, 96, 256, generator=torch.Generator().manual_seed(1)).to(dtype)
        with torch.no_grad():
            a, _ = card(x.cuda())
            b, _ = card(x.cuda())
            want, _ = cpu(x)
        assert torch.equal(a, b)
        if dtype == torch.float32:
            assert (a.cpu() - want).abs().max().item() < 1e-5


def test_sampler_filters_on_the_card_as_on_the_cpu(cuda):
    """filter_logits gives the CPU's bits on the card, and sample with the
    same noise the same tokens."""
    from repro_torch.serving.sampler import SamplerConfig, filter_logits, gumbel, sample
    logits = torch.randn(4, 151936, generator=torch.Generator().manual_seed(2)) * 4
    noise = gumbel(logits.shape, torch.Generator().manual_seed(3))
    for kw in (dict(greedy=True), dict(), dict(temperature=0.7), dict(top_k=50),
               dict(top_p=0.9), dict(temperature=1.3, top_k=40, top_p=0.8)):
        cfg = SamplerConfig(**kw)
        assert torch.equal(filter_logits(logits.cuda(), cfg).cpu(), filter_logits(logits, cfg))
        assert torch.equal(sample(logits.cuda(), None, cfg, noise=noise.cuda()).cpu(),
                           sample(logits, None, cfg, noise=noise))


def _decode_case(gen, B, H, K, hd, L, dtype):
    return (_randn(gen, B, H, hd, dtype=dtype), _randn(gen, B, L, K, hd, dtype=dtype),
            _randn(gen, B, L, K, hd, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("case", ["L 5 < splits", "L 4096, window 1024", "no valid slot",
                                  "G 1", "G 7", "G 10", "G 16"])
def test_decode_split_kernel_edges(cuda, case, hd, dtype):
    """The split-L cluster kernel: empty splits, long windowed caches, a call
    with no valid slot (v averaged over all slots, as the plain version and
    the JAX kernel give), and groups of 1 to 16 heads."""
    from repro_torch.kernels.decode_attention import ops
    B, H, K, L, win, fill = {
        "L 5 < splits": (2, 8, 2, 5, 0, 5),
        "L 4096, window 1024": (1, 8, 2, 4096, 1024, 4096),
        "no valid slot": (2, 8, 2, 300, 0, 0),
        "G 1": (2, 4, 4, 544, 0, 513), "G 7": (1, 28, 4, 544, 0, 544),
        "G 10": (4, 10, 1, 544, 2048, 513), "G 16": (1, 16, 1, 300, 0, 300),
    }[case]
    q, ck, cv = _decode_case(cuda, B, H, K, hd, L, dtype)
    ar = torch.arange(L, device="cuda", dtype=torch.int32)
    sp = torch.where(ar < fill, ar, torch.full_like(ar, -1))
    cur = max(fill - 1, 0)
    before = ops.decode_attention.launches
    out = ops.decode_attention(q, ck, cv, sp, cur, window=win)
    ref = ops.decode_attention_reference(q, ck, cv, sp, cur, window=win)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("B,H,K,L,win,fill", [
    (8, 4, 2, 16, 0, 9), (8, 4, 2, 16, 0, 16),  # reduced qwen2-7b at the defaults
    (8, 4, 1, 16, 16, 16),                       # reduced recurrentgemma-2b (window 16)
    (4, 28, 4, 544, 0, 513), (4, 10, 1, 544, 2048, 544),   # groups 7 and 10
    (2, 8, 2, 5, 0, 5), (1, 8, 2, 4096, 1024, 4096),       # L 5 < splits; long, windowed
    (2, 8, 2, 300, 0, 0), (1, 16, 1, 300, 0, 300),         # no valid slot; group 16
])
def test_decode_kernel_small_head_dims_match_plain(cuda, B, H, K, L, win, fill, hd, dtype):
    """head_dim 16 and 64: a row is 2 to 16 lanes' chunks, so several rows
    share a warp and a lane may finish several heads' dots."""
    from repro_torch.kernels.decode_attention import ops
    q, ck, cv = _decode_case(cuda, B, H, K, hd, L, dtype)
    ar = torch.arange(L, device="cuda", dtype=torch.int32)
    sp = torch.where(ar < fill, ar, torch.full_like(ar, -1))
    cur = max(fill - 1, 0)
    before = ops.decode_attention.launches
    out = ops.decode_attention(q, ck, cv, sp, cur, window=win)
    ref = ops.decode_attention_reference(q, ck, cv, sp, cur, window=win)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("plan", [(2, 8, 68), (2, 1, 544), (5, 3, 182), (10, 4, 136)])
def test_decode_kernel_takes_any_split_plan(cuda, plan):
    """recurrentgemma-2b's decode shape under its split plan, one block per
    (batch, kv head, head block), an odd cluster of 3 and one head a block."""
    from repro_torch.kernels.decode_attention import ops
    q, ck, cv = _decode_case(cuda, 4, 10, 1, 256, 544, torch.bfloat16)
    sp = torch.arange(544, device="cuda", dtype=torch.int32)
    out = ops._launch(q, ck, cv, sp, 543, 0, ops.SplitPlan(*plan))
    ref = ops.decode_attention_reference(q, ck, cv, sp, 543)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() < TOL[torch.bfloat16]


def test_decode_kernel_rejects_unaligned_cache_rows(cuda):
    from repro_torch.kernels.decode_attention.ops import decode_attention
    q = _randn(cuda, 1, 4, 128, dtype=torch.bfloat16)
    c = _randn(cuda, 1, 16, 2, 129, dtype=torch.bfloat16)[..., :128]   # 258-byte rows
    with pytest.raises(ValueError, match="aligned"):
        decode_attention(q, c, c, torch.arange(16, device="cuda", dtype=torch.int32), 15)


def _rglru_inputs(gen, B, S, W, dtype):
    """As the JAX kernel test draws them: a = sigmoid(N) * 0.2 + 0.79,
    b = N * 0.1, h0 = N."""
    a = torch.sigmoid(torch.randn(B, S, W, generator=gen, device="cuda")) * 0.2 + 0.79
    b = torch.randn(B, S, W, generator=gen, device="cuda") * 0.1
    h0 = torch.randn(B, W, generator=gen, device="cuda")
    return a.to(dtype), b.to(dtype), h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W", [
    (2, 512, 512), (1, 256, 1024), (3, 128, 512),       # tests/test_kernels.py
    (4, 512, 2560),                                      # recurrentgemma-2b prefill
    (1, 511, 1000), (2, 7, 33),                          # ragged S and W
    SCAN_DEFAULTS,                                       # the launcher's default serve
    # the split-S kernel's shapes (scan_plan: chunks of <= 64 steps, <= 8 a
    # round): S shorter than a chunk, S = 1, 6 chunks of 17, 2 and 10 rounds,
    # a ragged channel tile, W = 33 staged by plain loads
    (2, 10, 256), (3, 1, 128), (2, 100, 512), (2, 1000, 192), (1, 5000, 64),
    (2, 511, 1000), (2, 300, 33),
])
def test_rglru_kernel_matches_plain(cuda, B, S, W, dtype):
    """float32 2e-5 (an FMA where the plain loop rounds twice; the plain
    loop is held to the JAX oracle at 2e-4 on the CPU); bf16 3e-2 (one
    rounding of h to bf16). Rows of W elements that are not a multiple of
    16 bytes are staged by plain loads, the others by bulk copies."""
    from repro_torch.kernels.rglru_scan import ops
    a, b, h0 = _rglru_inputs(cuda, B, S, W, dtype)
    assert ops.bulk_copies(a, b) == (W * a.element_size() % 16 == 0)
    before = ops.rglru_scan.launches
    h = ops.rglru_scan(a, b, h0)
    ref = ops.rglru_scan_reference(a, b, h0)
    torch.cuda.synchronize()
    assert ops.rglru_scan.launches == before + 1
    assert h.dtype == dtype and h.shape == (B, S, W) and torch.isfinite(h).all()
    assert (h.float() - ref.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["a = 0 on chunk 3", "strided, bulk", "strided, plain loads"])
def test_rglru_split_kernel_edges(cuda, case, dtype):
    """The split-S cluster kernel: a chunk whose product of a is 0 (the carry
    is cut there), and a non-zero h0 with non-contiguous batch and seq dims,
    both staged by bulk copies and by plain loads."""
    from repro_torch.kernels.rglru_scan import ops
    B, S, W = {"a = 0 on chunk 3": (2, 512, 256), "strided, bulk": (3, 200, 96),
               "strided, plain loads": (3, 200, 90)}[case]
    a, b, h0 = _rglru_inputs(cuda, B, S, W, dtype)
    if case.startswith("a = 0"):
        c = ops.scan_plan(S).chunk
        a[:, 3 * c:4 * c] = 0
    if case.startswith("strided"):      # a [S, B, W] and a [B, S, 2W] layout
        a = a.transpose(0, 1).contiguous().transpose(0, 1)
        b = torch.cat([b, b], dim=2)[..., :W]
    if case.endswith("plain loads"):
        assert not ops.bulk_copies(a, b)
    else:
        assert ops.bulk_copies(a, b)
    before = ops.rglru_scan.launches
    h = ops.rglru_scan(a, b, h0)
    ref = ops.rglru_scan_reference(a, b, h0)
    torch.cuda.synchronize()
    assert ops.rglru_scan.launches == before + 1
    assert h.dtype == dtype and h.shape == (B, S, W) and torch.isfinite(h).all()
    assert (h.float() - ref.float()).abs().max().item() < TOL[dtype]


def test_rglru_kernel_respects_initial_state_and_strides(cuda):
    from repro_torch.kernels.rglru_scan.ops import rglru_scan, rglru_scan_reference
    a = torch.full((1, 4, 256), 0.5, device="cuda")
    h = rglru_scan(a, torch.zeros_like(a), torch.ones(1, 256, device="cuda"))
    torch.cuda.synchronize()
    assert (h[:, 0] - 0.5).abs().max().item() < 1e-6
    assert (h[:, 3] - 0.5 ** 4).abs().max().item() < 1e-6
    # a [S, B, W] layout viewed as [B, S, W]: batch and seq strides swapped
    a, b, h0 = _rglru_inputs(cuda, 3, 40, 96, torch.float32)
    a_t = a.transpose(0, 1).contiguous().transpose(0, 1)
    out = rglru_scan(a_t, b, h0)
    torch.cuda.synchronize()
    assert (out - rglru_scan_reference(a, b, h0)).abs().max().item() < 2e-5


def test_rglru_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    a, b, h0 = _rglru_inputs(cuda, 1, 16, 64, torch.float32)
    with pytest.raises(ValueError):
        rglru_scan(a.half(), b.half(), h0)                   # float16
    with pytest.raises(ValueError):
        rglru_scan(a, b.bfloat16(), h0)                      # mixed dtypes
    with pytest.raises(ValueError):
        rglru_scan(a.transpose(1, 2), b.transpose(1, 2), h0[:, :16])  # strided W
    from repro_torch.kernels.decode_attention.ops import decode_attention
    q = _randn(cuda, 1, 20, 256, dtype=torch.float32)        # group 20 > 16
    c = _randn(cuda, 1, 16, 1, 256, dtype=torch.float32)
    with pytest.raises(ValueError):
        decode_attention(q, c, c, torch.arange(16, device="cuda", dtype=torch.int32), 15)


def test_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn(cuda, 1, 64, 4, 48, dtype=dtype)           # head_dim 48
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention(q, q[:, :, :2], q[:, :, :2])
        c = _randn(cuda, 1, 16, 2, 48, dtype=dtype)
        with pytest.raises(ValueError, match="head_dim"):
            decode_attention(q[:, 0], c, c, torch.arange(16, device="cuda", dtype=torch.int32),
                             15)
    q = _randn(cuda, 1, 4, 128, dtype=torch.float16)
    c = _randn(cuda, 1, 16, 2, 128, dtype=torch.float16)
    with pytest.raises(ValueError):
        decode_attention(q, c, c, torch.arange(16, device="cuda", dtype=torch.int32), 15)


def _mlstm_inputs(gen, B, S, H, dqk, dv, dtype):
    """As the JAX kernel test draws them: k / sqrt(dqk), forget gates
    log_sigmoid(N(0,1) + 2); gates stay float32."""
    q = _randn(gen, B, S, H, dqk, dtype=dtype)
    k = (torch.randn(B, S, H, dqk, generator=gen, device="cuda") / dqk ** 0.5).to(dtype)
    v = _randn(gen, B, S, H, dv, dtype=dtype)
    il = torch.randn(B, S, H, generator=gen, device="cuda")
    fl = torch.nn.functional.logsigmoid(
        torch.randn(B, S, H, generator=gen, device="cuda") + 2.0)
    return q, k, v, il, fl


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-9)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,dqk,dv,chunk", [
    (1, 256, 2, 128, 256, 128), (2, 512, 4, 128, 128, 128),     # tests/test_kernels.py
    (1, 256, 2, 256, 512, 64),
    (4, 512, 4, 512, 1024, 256),                                # xlstm-1.3b prefill
    (1, 511, 2, 128, 96, 256),                                  # chunk 73, ragged dv
    (2, 256, 2, 64, 96, 64), (1, 511, 4, 512, 1024, 256),       # ragged dv; chunk 73
    (1, 192, 2, 128, 256, 256),                                 # one chunk: no interior state
])
def test_mlstm_kernel_matches_plain(cuda, B, S, H, dqk, dv, chunk, dtype):
    """h at rel 1e-4 (f32) or 3e-2 of max|h| (bf16, one rounding of h); the
    float32 state (C, n, m) at rel 1e-4 (f32 inputs) or 1e-3 (bf16 inputs)."""
    from repro_torch.kernels.mlstm_chunk import ops
    args = _mlstm_inputs(cuda, B, S, H, dqk, dv, dtype)
    before = ops.mlstm_chunk.launches
    h, state = ops.mlstm_chunk(*args, chunk=chunk, return_state=True)
    h_ref, state_ref = ops.mlstm_chunk_reference(*args, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert ops.mlstm_chunk.launches == before + 1
    assert h.dtype == dtype and h.shape == (B, S, H, dv)
    assert torch.isfinite(h).all()
    assert _rel(h, h_ref) < (1e-4 if dtype == torch.float32 else 3e-2)
    for got, want in zip(state, state_ref):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _rel(got, want) < (1e-4 if dtype == torch.float32 else 1e-3)


def test_mlstm_kernel_at_the_launcher_default_widths_matches_plain(cuda):
    """The float32 kernel at the shape the launcher's default serve gives it
    (reduced xlstm-1.3b: dqk 16, dv 32, one chunk of S), at the tolerances
    of ``test_mlstm_kernel_matches_plain``; bf16 takes dqk >= 64 only."""
    from repro_torch.kernels.mlstm_chunk import ops
    B, S, H, dqk, dv, chunk = MLSTM_DEFAULTS
    args = _mlstm_inputs(cuda, B, S, H, dqk, dv, torch.float32)
    before = ops.mlstm_chunk.launches
    h, state = ops.mlstm_chunk(*args, chunk=chunk, return_state=True)
    h_ref, state_ref = ops.mlstm_chunk_reference(*args, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert ops.mlstm_chunk.launches == before + 1
    assert h.shape == (B, S, H, dv) and torch.isfinite(h).all()
    assert _rel(h, h_ref) < 1e-4
    for got, want in zip(state, state_ref):
        assert got.shape == want.shape and _rel(got, want) < 1e-4


def test_mlstm_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    args = _mlstm_inputs(cuda, 1, 64, 2, 128, 64, torch.float32)
    with pytest.raises(ValueError):
        mlstm_chunk(*args, chunk=512)                           # chunk > 256
    with pytest.raises(ValueError):
        mlstm_chunk(*(a.half() for a in args[:3]), *args[3:])  # float16
    with pytest.raises(ValueError):
        mlstm_chunk(*args[:3], args[3].bfloat16(), args[4])     # bf16 gates
    big = _mlstm_inputs(cuda, 1, 16, 1, 640, 64, torch.float32)
    with pytest.raises(ValueError):
        mlstm_chunk(*big)                                       # dqk > 512
    narrow = _mlstm_inputs(cuda, 1, 64, 2, 32, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="at least 64"):
        mlstm_chunk(*narrow)                                    # bf16 dqk < 64
    odd = _mlstm_inputs(cuda, 1, 64, 2, 128, 100, torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):
        mlstm_chunk(*odd)                                       # 200-byte v rows


@pytest.mark.parametrize("arch", ["qwen2-7b", "recurrentgemma-2b", "xlstm-1.3b",
                                  "qwen3-moe-30b-a3b", "gemma3-12b"])
def test_launcher_defaults_serve_on_the_card(cuda, arch, monkeypatch):
    """``python -m repro_torch.launch.serve`` with its defaults: the card, a
    reduced float32 model (head_dim 16). Every attention, mLSTM and scan call
    goes through a kernel (the plain versions raise meanwhile), and the
    greedy tokens equal those of the same run with ``--device cpu``."""
    import numpy as np
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mlstm_chunk import ops as mops
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.launch import serve
    cpu = serve.run(["--arch", arch, "--device", "cpu"])

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain kernel version ran on the card's path")

    for mod, name in ((fops, "flash_attention_reference"), (dops, "decode_attention_reference"),
                      (mops, "mlstm_chunk_reference"), (rops, "rglru_scan_reference")):
        monkeypatch.setattr(mod, name, forbidden)
    wrappers = {"flash": fops.flash_attention, "decode": dops.decode_attention,
                "mlstm": mops.mlstm_chunk, "scan": rops.rglru_scan}
    before = {name: fn.launches for name, fn in wrappers.items()}
    card = serve.run(["--arch", arch])
    launches = {name: fn.launches - before[name] for name, fn in wrappers.items()}
    kinds, rounds = card["cfg"].layer_kinds(), card["rounds"]
    n_attn = sum(k in ("attn", "local") for k in kinds)
    steps = serve.build_parser().parse_args([]).max_new - 1      # decode steps a round
    assert card["cfg"].head_dim == 16 and card["devices"][0].startswith("cuda")
    assert launches == {"flash": rounds * n_attn, "decode": rounds * n_attn * steps,
                        "mlstm": rounds * kinds.count("mlstm"),
                        "scan": rounds * kinds.count("rglru")}
    got = {r.req_id: r.done for r in card["completed"]}
    want = {r.req_id: r.done for r in cpu["completed"]}
    assert got.keys() == want.keys() and len(got) == 32
    assert all(np.array_equal(got[i], want[i]) for i in want)


# ------------------------------------------------------- batched queue core

QUEUE_EXACT_COLS = [0, 1, 2, 3, 5, 7]     # FOLD_COLS but the two sums (mean, mean wait)
QUEUE_SUM_COLS = [4, 6]


def _queue_trace(kind, rate, horizon, seed, n=None):
    from repro_torch.workloads.arrivals import RequestTrace, make_trace
    tr = make_trace(kind, rate, horizon, seed)
    if n is not None:
        tr = RequestTrace(tr.t[:n], tr.prompt_tokens[:n], tr.decode_tokens[:n], tr.kind)
    return tr


def _random_capacity(rng, horizon, max_nodes=10, max_steps=12):
    """Random piecewise capacity with zero levels (as the JAX package's tests draw it)."""
    ev = [(0.0, int(rng.integers(0, max_nodes)))]
    for _ in range(int(rng.integers(0, max_steps))):
        ev.append((float(rng.uniform(0.0, horizon)), int(rng.integers(0, max_nodes))))
    return ev


def _queue_jobs(seed, n_jobs=8, horizon=1800.0):
    """Random piecewise and constant jobs of four arrival kinds."""
    import numpy as np
    from repro_torch.core.types import SLOConfig
    from repro_torch.serving.batching import ServiceTimeModel
    from repro_torch.workloads.queueing import QueueJob
    rng = np.random.default_rng(seed)
    kinds = ("poisson", "mmpp", "diurnal", "flash_crowd")
    jobs = []
    for i in range(n_jobs):
        tr = _queue_trace(kinds[i % 4], float(rng.uniform(0.4, 3.0)), horizon, seed + i)
        ev = [(0.0, int(rng.integers(0, 8)))] if i % 3 == 2 else _random_capacity(rng, horizon)
        jobs.append(QueueJob(tr, ev, ServiceTimeModel(), SLOConfig(latency_target_s=30.0),
                             horizon))
    return jobs


def _queue_edge_jobs():
    """k = 0 intervals, capacity 0 throughout, the horizon at half the trace
    and None, one request, n at the 256/257/384 bucket edges, more than 8
    intervals and more than 32 slots, constant k = 0, 1 and 50."""
    from repro_torch.core.types import SLOConfig
    from repro_torch.serving.batching import ServiceTimeModel
    from repro_torch.workloads.queueing import QueueJob
    model, slo = ServiceTimeModel(), SLOConfig(latency_target_s=30.0)
    tr = _queue_trace("poisson", 1.0, 600.0, 0)
    steps12 = [(50.0 * i, (i * 5) % 13) for i in range(12)]
    cases = [
        (tr, [(0.0, 0)], 600.0), (tr, [(0.0, 0), (300.0, 1), (450.0, 0), (500.0, 2)], 550.0),
        (tr, [(0.0, 5), (100.0, 1)], 600.0), (tr, [(0.0, 2), (200.0, 0), (400.0, 2)], 600.0),
        (tr, [(0.0, 1), (590.0, 8)], 595.0), (tr, [(0.0, 1), (200.0, 3)], 300.0),
        (tr, [(0.0, 1), (200.0, 3)], None), (tr, steps12, 600.0),
        (tr, [(0.0, 12), (300.0, 2)], 600.0),
        (_queue_trace("poisson", 1.0, 600.0, 1, n=1), [(0.0, 1), (5.0, 2)], 600.0),
        (tr, [(0.0, 0)], 300.0), (tr, [(0.0, 1)], 600.0), (tr, [(0.0, 50)], None),
    ]
    for n in (256, 257, 384):
        big = _queue_trace("mmpp", 2.0, 1800.0, n, n=n)
        cases += [(big, [(0.0, 1), (600.0, 2), (900.0, 0), (1000.0, 3)], 1800.0),
                  (big, [(0.0, 2)], 1800.0)]
    return [QueueJob(t, ev, model, slo, hz) for t, ev, hz in cases]


def _queue_wide_long_jobs():
    """Jobs as wide and long as the ``full`` grid's and more: 7.7k-28k
    requests over 7200 s, piecewise levels of 68-120 slots with zero and low
    levels between, one schedule up to 480 slots closed past its horizon
    (the heap drain), and constant 68 and 120 slots."""
    import numpy as np
    from repro_torch.core.types import SLOConfig
    from repro_torch.serving.batching import ServiceTimeModel
    from repro_torch.workloads.queueing import QueueJob
    model, slo = ServiceTimeModel(), SLOConfig(latency_target_s=30.0)
    rng = np.random.default_rng(11)
    jobs = []
    fixed = [(0.0, 120), (900.0, 6), (1800.0, 0), (2100.0, 90), (3600.0, 2), (4500.0, 72),
             (6000.0, 0), (6300.0, 100)]
    for i, kind in enumerate(("mmpp", "diurnal", "flash_crowd", "poisson")):
        ev = fixed if i == 0 else [(0.0, int(rng.integers(17, 31)))]
        for _ in range(0 if i == 0 else int(rng.integers(10, 31))):
            ev.append((float(rng.uniform(0.0, 7200.0)), int(rng.integers(0, 31))))
        jobs.append(QueueJob(_queue_trace(kind, 2.2, 7200.0, 900 + i), ev, model, slo,
                             (6200.0, 7200.0, 5000.0, 7200.0)[i]))
    for nodes in (17, 30):
        jobs.append(QueueJob(_queue_trace("mmpp", 2.2, 7200.0, 950 + nodes), [(0.0, nodes)],
                             model, slo, 7200.0))
    return jobs


def _hold_queue_kernel_to_plain(jobs):
    """Every bucket of ``jobs`` through the bucket form (one launch each) and
    through the plain version on the same inputs: all columns but the two
    sums bit-equal, the sums within 1e-5 relative."""
    from repro_torch.kernels.queue_core import ops, ref
    from repro_torch.workloads import queueing as Q
    buckets, caps = Q._plan(jobs)
    assert buckets
    for key, rows in sorted(buckets.items()):
        kind, *arrays, k_pad = Q.bucket_inputs(jobs, key, rows, caps)
        before = ops.queue_flush.launches
        got = ops.queue_core(kind, *(torch.from_numpy(a).cuda() for a in arrays), k_pad)
        want = ref.queue_core_reference(kind, *(torch.from_numpy(a) for a in arrays), k_pad)
        torch.cuda.synchronize()
        assert ops.queue_flush.launches == before + 1
        got = got.cpu()
        assert got.shape == (len(rows), 8)
        assert torch.equal(got[:, QUEUE_EXACT_COLS], want[:, QUEUE_EXACT_COLS]), (key, got, want)
        assert torch.allclose(got[:, QUEUE_SUM_COLS], want[:, QUEUE_SUM_COLS],
                              rtol=1e-5, atol=0), key


def _flush_args(jobs):
    """The flat tables of one flush of ``jobs`` on the host, and k_max."""
    from repro_torch.workloads import queueing as Q
    caps = Q._job_caps(jobs)
    rows = [i for i, c in enumerate(caps) if c is not None]
    buf, spans, k_max = Q.flush_inputs(jobs, rows, caps)
    return Q.flush_tensors(buf, spans), k_max


def _hold_flush_to_plain(jobs, instance=None, k_max=None):
    """All of ``jobs`` through the flat kernel (one launch, on ``instance``
    where given, with ``k_max`` slots where given) and through the flat
    plain version on the CPU: every column but the two sums bit-equal, the
    sums within 1e-5 relative. Returns the kernel's rows."""
    from repro_torch.kernels.queue_core import ops, ref
    args, k_jobs = _flush_args(jobs)
    k_max = k_jobs if k_max is None else k_max
    want = ref.queue_flush_reference(*args)
    before, by = ops.queue_flush.launches, dict(ops.queue_flush.instance_launches)
    got = ops.queue_flush(*(a.cuda() for a in args), k_max)
    torch.cuda.synchronize()
    assert ops.queue_flush.launches == before + 1
    name = ops.INSTANCES[ops.slot_registers(k_max)]
    assert ops.queue_flush.instance_launches[name] == by[name] + 1
    assert instance is None or name == instance
    got = got.cpu()
    assert got.shape == want.shape
    assert torch.equal(got[:, QUEUE_EXACT_COLS], want[:, QUEUE_EXACT_COLS]), (got, want)
    assert torch.allclose(got[:, QUEUE_SUM_COLS], want[:, QUEUE_SUM_COLS], rtol=1e-5, atol=0)
    return got


def _chip_smoke():
    """``chip_smoke.py`` as a module: its queue check sets."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_sets", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _full_chunk_jobs():
    """The queue jobs of the first chunk of ``--grid full --shard 0/252``
    (its cells 0, 252, ..., 1764), the flush the campaign phase times."""
    from repro_torch.workloads import campaign as C
    cells = C.shard_cells(C.make_grid("full"), "0/252")[:C.QUEUE_CHUNK]
    return [j for c in cells for j in C._cell_start(c).jobs]


@pytest.mark.parametrize("seed", range(3))
def test_queue_kernel_matches_plain(cuda, seed):
    _hold_queue_kernel_to_plain(_queue_jobs(seed))
    _hold_flush_to_plain(_queue_jobs(seed))


def test_queue_kernel_edges_match_plain(cuda):
    _hold_queue_kernel_to_plain(_queue_edge_jobs())
    _hold_flush_to_plain(_queue_edge_jobs())


def test_queue_kernel_wide_long_jobs_match_plain(cuda):
    """More than 64 slots and 8192 requests a job, where the slot vector
    spans several warp widths and the loop runs past 8192 steps."""
    from repro_torch.workloads import queueing as Q
    jobs = _queue_wide_long_jobs()
    buckets, caps = Q._plan(jobs)
    assert max(key[1] for key in buckets) > 8192
    assert max(Q.bucket_inputs(jobs, key, rows, caps)[-1] for key, rows in buckets.items()) > 64
    _hold_queue_kernel_to_plain(jobs)
    _hold_flush_to_plain(jobs, "registers_16")


def test_queue_kernel_matches_plain_on_the_full_grids_first_chunk(cuda):
    jobs = _full_chunk_jobs()
    assert len(jobs) > 0
    _hold_queue_kernel_to_plain(jobs)
    _hold_flush_to_plain(jobs, "registers_4")


@pytest.mark.parametrize("name", ["random", "edges", "piecewise_192", "dedicated_8_12_16",
                                  "wide_long", "many_intervals"])
def test_queue_flush_matches_plain_on_chip_smokes_sets(cuda, name):
    """The flat kernel against the flat plain version on each set that
    ``chip_smoke.py`` checks, one launch a set."""
    _hold_flush_to_plain(_chip_smoke().queue_sets()[name])


@pytest.mark.parametrize("K,instance", [
    (32, "registers_1"), (33, "registers_2"), (64, "registers_2"), (65, "registers_4"),
    (128, "registers_4"), (129, "registers_8"), (256, "registers_8"), (257, "registers_16"),
    (512, "registers_16"), (513, "shared_memory"), (600, "shared_memory")])
def test_queue_flush_at_the_register_tiers_edges(cuda, K, instance):
    """K slots at each edge of the register tiers; above 512 the
    shared-memory instance (``chip_smoke.tier_jobs``)."""
    _hold_flush_to_plain(_chip_smoke().tier_jobs(K), instance)


@pytest.mark.parametrize("k_max,instance", [
    (32, "registers_1"), (64, "registers_2"), (128, "registers_4"), (256, "registers_8"),
    (512, "registers_16"), (600, "shared_memory")])
def test_queue_flush_runs_the_cursor_on_every_instance(cuda, k_max, instance):
    """Jobs of 33, 40, 64 and 100 intervals (``chip_smoke.many_interval_jobs``:
    the cursor moves, later windows are searched, closed intervals, a
    drain) at K <= 32, on each instance by its k_max."""
    jobs = _chip_smoke().many_interval_jobs()
    assert _flush_args(jobs)[1] == 32
    _hold_flush_to_plain(jobs, instance, k_max)


def test_queue_flush_rows_do_not_depend_on_the_instance(cuda):
    """The same jobs alone (a register instance: 200 slots at most) and
    beside a 600-slot job (the shared-memory instance): the same bits."""
    alone = _hold_flush_to_plain(_queue_edge_jobs(), "registers_8")
    beside = _hold_flush_to_plain(_queue_edge_jobs() + _chip_smoke().tier_jobs(600)[:1], "shared_memory")
    assert torch.equal(alone, beside[:len(alone)])


def test_queue_flush_gives_a_nan_row_where_the_card_cannot_check(cuda):
    """On CUDA tensors the host reads no table: a job whose slots exceed
    k_max, or whose interval starts descend or begin below 0, gets a NaN row
    and the others their own."""
    from repro_torch.kernels.queue_core import ops
    jobs = _queue_edge_jobs()[:4]
    args, k_max = _flush_args(jobs)
    want = ops.queue_flush(*(a.cuda() for a in args), k_max)
    kind, t, s, req_off, cap_t, cap_k, hi_t, cap_off, hz, slo = (a.cuda() for a in args)
    wide = cap_k.clone()
    wide[cap_off[2]] = k_max + 1
    got = ops.queue_flush(kind, t, s, req_off, cap_t, wide, hi_t, cap_off, hz, slo, k_max)
    assert torch.isnan(got[2]).all() and torch.equal(got[[0, 1, 3]], want[[0, 1, 3]])
    lo, hi = int(cap_off[1]), int(cap_off[2])
    assert hi - lo > 2
    swapped = cap_t.clone()
    swapped[lo + 1], swapped[lo + 2] = cap_t[lo + 2], cap_t[lo + 1]
    got = ops.queue_flush(kind, t, s, req_off, swapped, cap_k, hi_t, cap_off, hz, slo, k_max)
    assert torch.isnan(got[1]).all() and torch.equal(got[[0, 2, 3]], want[[0, 2, 3]])
    early = cap_t.clone()
    early[lo] = -1.0
    got = ops.queue_flush(kind, t, s, req_off, early, cap_k, hi_t, cap_off, hz, slo, k_max)
    assert torch.isnan(got[1]).all() and torch.equal(got[[0, 2, 3]], want[[0, 2, 3]])


def test_queue_plain_version_is_the_same_on_the_card(cuda):
    """The plain version on CUDA tensors against itself on the CPU, on the
    full grid's first chunk's 8192 bucket (where the card once divided the
    quantiles by 100 as a reciprocal product, one ulp off in a p99)."""
    from repro_torch.kernels.queue_core import ref
    from repro_torch.workloads import queueing as Q
    jobs = _full_chunk_jobs()
    buckets, caps = Q._plan(jobs)
    kind, *arrays, k_pad = Q.bucket_inputs(jobs, ("pw", 8192), buckets[("pw", 8192)], caps)
    cpu = ref.queue_core_reference(kind, *(torch.from_numpy(a) for a in arrays), k_pad)
    card = ref.queue_core_reference(kind, *(torch.from_numpy(a).cuda() for a in arrays),
                                    k_pad).cpu()
    assert torch.equal(card[:, QUEUE_EXACT_COLS], cpu[:, QUEUE_EXACT_COLS]), (card, cpu)
    assert torch.allclose(card[:, QUEUE_SUM_COLS], cpu[:, QUEUE_SUM_COLS], rtol=1e-5, atol=0)


def test_queue_kernel_rejects_k_pad_below_a_jobs_slots(cuda):
    """Eager: ValueError. Under graph capture the host cannot read cap_k, so
    the kernel gives the offending job a NaN row and the others their own."""
    from repro_torch.kernels.queue_core import ops
    from repro_torch.workloads import queueing as Q
    jobs = _queue_edge_jobs()[:3]
    buckets, caps = Q._plan(jobs)
    kind, *arrays, k_pad = Q.bucket_inputs(jobs, ("pw", 768), buckets[("pw", 768)], caps)
    tensors = [torch.from_numpy(a).cuda() for a in arrays]
    want = ops.queue_core(kind, *tensors, k_pad)
    wide = tensors[6].clone()
    wide[0, 0] = k_pad + 1
    with pytest.raises(ValueError, match="k_pad"):
        ops.queue_core(kind, *tensors[:6], wide, tensors[7], k_pad)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ops.queue_core(kind, *tensors[:6], wide, tensors[7], k_pad)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.isnan(got[0]).all()
    assert torch.equal(got[1:], want[1:])


def test_queue_kernel_is_composition_independent(cuda):
    """A job's metrics on the card are the same bits alone and co-launched."""
    from repro_torch.workloads.queueing import simulate_queue_batch
    jobs = _queue_jobs(42, n_jobs=6) + _queue_edge_jobs()[:4]
    tags = []
    grouped = simulate_queue_batch(jobs, stats_out=tags)
    assert tags == ["cuda_batched"] * len(jobs)
    for job, m in zip(jobs, grouped):
        assert simulate_queue_batch([job], device="cuda")[0] == m


def test_a_full_chunks_flush_is_one_launch(cuda, monkeypatch):
    """``simulate_queue_batch`` on the first ``full`` chunk's 16 jobs (3
    shape buckets): one launch, the plain versions raising."""
    from repro_torch.kernels.queue_core import ops
    from repro_torch.workloads import queueing as Q

    def forbidden(*args, **kwargs):
        raise AssertionError("the plain queue core ran on the card's path")

    monkeypatch.setattr(ops, "queue_flush_reference", forbidden)
    monkeypatch.setattr(ops, "queue_core_reference", forbidden)
    jobs = _full_chunk_jobs()
    assert len(Q.plan_queue_buckets(jobs)) == 3
    before = ops.queue_flush.launches
    got = Q.simulate_queue_batch(jobs)
    assert ops.queue_flush.launches == before + 1 and len(got) == len(jobs)


def test_campaign_traces_on_the_card_match_the_goldens(cuda, tmp_path, monkeypatch):
    """A traced mix_tiny campaign on the card, with the plain queue core made
    to raise: the 7 traces equal the goldens byte for byte, and the kernel
    launched once a chunk (one flush)."""
    from pathlib import Path
    from repro_torch.kernels.queue_core import ops
    from repro_torch.workloads import campaign as C

    def forbidden(*args, **kwargs):
        raise AssertionError("the plain queue core ran on the card's path")

    monkeypatch.setattr(ops, "queue_flush_reference", forbidden)
    monkeypatch.setattr(ops, "queue_core_reference", forbidden)
    cells = C.make_grid("mix_tiny")
    before = ops.queue_flush.launches
    art = C.run_campaign(cells, trace_dir=str(tmp_path), grid_name="mix_tiny")
    launches = ops.queue_flush.launches - before
    golden = Path(__file__).resolve().parents[1] / "goldens" / "mix_tiny_traces"
    names = sorted(p.name for p in golden.glob("*.trace.jsonl"))
    assert names == sorted(p.name for p in tmp_path.glob("*.trace.jsonl")) and len(names) == 7
    for name in names:
        assert (tmp_path / name).read_bytes() == (golden / name).read_bytes(), name
    assert launches == -(-len(cells) // C.QUEUE_CHUNK) == 1
    assert art["throughput"]["queue_impls"] == {"cuda_batched": 14}


def test_campaign_workers_are_spawned_and_stay_on_the_card(cuda, capfd):
    """``--workers 2`` on the card: the pool is spawned (a forked child could
    not use the parent's CUDA context), each worker flushes on the card, and
    the reductions equal the serial run's."""
    from repro_torch.workloads import campaign as C
    cells = C.make_grid("small")[:16]                        # two chunks
    serial = C.run_campaign(cells)
    pooled = C.run_campaign(cells, workers=2)
    assert "process pool unavailable" not in capfd.readouterr().err
    assert pooled["reductions"] == serial["reductions"]
    assert pooled["throughput"]["queue_impls"] == {"cuda_batched": 16}


# ---------------------------------------------------------------- training

def _assert_grads_close(got, ref, names, dtype, scale):
    """Each gradient on its own: every element within rtol * |ref| +
    atol * rms(ref), and ||got - ref|| <= rel_tol * ||ref||. bf16 (2^-7,
    1e-2, 1e-2): one rounding of the same float32 value lands at most one
    ulp away, plus float32 sums in another order before it; float32 (1e-5,
    1e-4, 1e-4): sums over up to S keys or steps in another order. All of
    them also within the one bound the tests held before, ``scale`` x
    max(1, their largest value)."""
    rtol, atol, rel_tol = (2.0 ** -7, 1e-2, 1e-2) if dtype == torch.bfloat16 else (
        1e-5, 1e-4, 1e-4)
    bound = scale * max(1.0, max(r.float().abs().max().item() for r in ref))
    for g, r, name in zip(got, ref, names):
        assert g.dtype == r.dtype and g.shape == r.shape and torch.isfinite(g).all(), name
        g, r = g.float(), r.float()
        d = (g - r).abs()
        assert d.max().item() < bound, name
        rms = r.square().mean().sqrt()
        worst = (d - rtol * r.abs() - atol * rms).max().item()
        assert worst <= 0, (name, worst, rms.item())
        assert d.norm().item() <= rel_tol * r.norm().item(), name


FLASH_BWD_SHAPES = [  # (B, S, H, K, hd, window, causal), float32 and bf16
    (1, 3072, 10, 1, 256, 2048, True),      # recurrentgemma-2b's training shape
    (2, 512, 28, 4, 128, 0, True),          # qwen2-7b's heads
    (2, 300, 8, 2, 64, 100, True), (1, 130, 4, 2, 64, 0, False),
    (2, 64, 4, 1, 16, 16, True),            # the launcher's reduced models
    (3, 77, 4, 4, 16, 0, True), (1, 200, 6, 2, 128, 0, False),
]
# bf16 at the tensor-core backward's edges, at each of its head dims: S not
# a multiple of 64, S below 64, non-causal (also with a window), window
# edges (2, 64, 65, 100) and groups G = H / K of 1, 4 and 7
FLASH_BWD_TC_EDGES = [
    (1, 200, 7, 1, 64, 0, True), (2, 40, 4, 1, 64, 0, True), (1, 200, 4, 2, 64, 50, False),
    (1, 333, 4, 4, 128, 0, True), (2, 50, 7, 1, 128, 20, True), (1, 260, 8, 2, 128, 64, True),
    (1, 200, 4, 1, 128, 0, False),
    (1, 300, 10, 1, 256, 65, True), (1, 63, 7, 1, 256, 0, False),
    (2, 190, 4, 4, 256, 128, True), (1, 129, 4, 1, 256, 2, True),
]


def _flash_bwd_inputs(gen, B, S, H, K, hd, win, causal, dtype):
    from repro_torch.kernels.flash_attention import ops
    q = _randn(gen, B, S, H, hd, dtype=dtype)
    k = _randn(gen, B, S, K, hd, dtype=dtype)
    v = _randn(gen, B, S, K, hd, dtype=dtype)
    do = _randn(gen, B, S, H, hd, dtype=dtype)
    o, lse = ops.flash_attention_reference(q, k, v, causal=causal, window=win,
                                           return_lse=True)
    return q, k, v, o, do, lse


@pytest.mark.parametrize("B,S,H,K,hd,win,causal,dtype", [
    *((*c, d) for c in FLASH_BWD_SHAPES for d in (torch.float32, torch.bfloat16)),
    *((*c, torch.bfloat16) for c in FLASH_BWD_TC_EDGES),
])
def test_flash_backward_kernel_matches_plain(cuda, B, S, H, K, hd, win, causal, dtype):
    """dq, dk, dv of the backward kernels against the plain formulas on the
    same q, k, v, o, dO and log-sum-exp; one launch a call."""
    from repro_torch.kernels.flash_attention import ops
    q, k, v, o, do, lse = _flash_bwd_inputs(cuda, B, S, H, K, hd, win, causal, dtype)
    before = ops.flash_attention_backward.launches
    got = ops.flash_attention_backward(q, k, v, o, do, lse, causal=causal, window=win)
    ref = ops.flash_attention_backward_reference(q, k, v, o, do, lse, causal=causal,
                                                 window=win)
    torch.cuda.synchronize()
    assert ops.flash_attention_backward.launches == before + 1
    assert all(g.dtype == dtype for g in got)
    _assert_grads_close(got, ref, ("dq", "dk", "dv"), dtype,
                        {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype])


@pytest.mark.parametrize("B,S,H,K,hd,win,causal,dtype", [
    (1, 3072, 10, 1, 256, 2048, True, torch.bfloat16), (2, 512, 28, 4, 128, 0, True, torch.bfloat16),
    (1, 200, 7, 1, 64, 0, True, torch.bfloat16), (2, 300, 8, 2, 64, 100, True, torch.float32),
    (2, 64, 4, 1, 16, 16, True, torch.bfloat16),
])
def test_flash_backward_gives_the_same_bits_twice(cuda, B, S, H, K, hd, win, causal, dtype):
    """No atomics: every sum, the tensor-core kernels' head-order sum of the
    partials included, has one order, so two calls are bit-equal."""
    from repro_torch.kernels.flash_attention import ops
    inputs = _flash_bwd_inputs(cuda, B, S, H, K, hd, win, causal, dtype)
    first = ops.flash_attention_backward(*inputs, causal=causal, window=win)
    second = ops.flash_attention_backward(*inputs, causal=causal, window=win)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_backward_bf16_rejects_layouts_tma_cannot_take(cuda):
    """A bf16 dO whose base is not 16-byte aligned (contiguous, so the
    wrapper keeps it) raises ValueError before any launch."""
    from repro_torch.kernels.flash_attention import ops
    q, k, v, o, do, lse = _flash_bwd_inputs(cuda, 1, 64, 4, 2, 128, 0, True, torch.bfloat16)
    n = do.numel()
    shifted = torch.empty(n + 8, dtype=torch.bfloat16, device="cuda")[1:n + 1].view(do.shape)
    shifted.copy_(do)
    before = ops.flash_attention_backward.launches
    with pytest.raises(ValueError, match="16-byte aligned base"):
        ops.flash_attention_backward(q, k, v, o, shifted, lse)
    assert ops.flash_attention_backward.launches == before


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 16), (torch.float32, 256),
                                      (torch.bfloat16, 16), (torch.bfloat16, 64),
                                      (torch.bfloat16, 256)])
def test_flash_forward_lse_matches_plain_and_serving_is_unchanged(cuda, dtype, hd):
    """Both forward kernels' log-sum-exp (float32 1e-4, bf16 1e-3: the same
    products summed in another order); the output with the LSE written is
    bit-equal to the serving call's, which passes a null pointer."""
    from repro_torch.kernels.flash_attention import ops
    q = _randn(cuda, 2, 300, 8, hd, dtype=dtype)
    k = _randn(cuda, 2, 300, 2, hd, dtype=dtype)
    v = _randn(cuda, 2, 300, 2, hd, dtype=dtype)
    serving = ops.flash_attention(q, k, v, causal=True, window=128)
    out, lse = ops._launch(q, k, v, causal=True, window=128, lse=True)
    _, ref = ops.flash_attention_reference(q, k, v, causal=True, window=128, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, serving)
    assert lse.shape == (2, 8, 300) and lse.dtype == torch.float32
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-3}[dtype]
    assert (lse - ref).abs().max().item() < tol


def test_flash_autograd_on_the_card_goes_through_the_kernels(cuda):
    from repro_torch.kernels.flash_attention import ops
    ts = [_randn(cuda, 1, 256, 4, 64, dtype=torch.bfloat16).requires_grad_(True)
          for _ in range(3)]
    f0, b0 = ops.flash_attention.launches, ops.flash_attention_backward.launches
    out = ops.flash_attention(*ts, causal=True, window=64)
    grads = torch.autograd.grad(out.float().square().sum(), ts)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == f0 + 1
    assert ops.flash_attention_backward.launches == b0 + 1
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("B,S,W", [
    (1, 3072, 2560), (4, 512, 2560),                    # recurrentgemma-2b training
    SCAN_DEFAULTS, (2, 128, 64),                        # the launcher's reduced model
    (2, 10, 256), (3, 1, 128), (2, 1000, 192), (1, 5000, 64), (2, 300, 33),
    (2, 3081, 64), (2, 1000, 100),      # t = 0 alone in a chunk; a ragged channel tile
])
def test_rglru_backward_kernel_matches_plain(cuda, B, S, W):
    """da, db, dh0 of the backward kernel against the plain reverse
    recurrence, each under the float32 rule of ``_assert_grads_close`` (the
    carry composed by chunks)."""
    from repro_torch.kernels.rglru_scan import ops
    a, b, h0 = _rglru_inputs(cuda, B, S, W, torch.float32)
    h = ops.rglru_scan(a, b, h0)
    dh = torch.randn(B, S, W, generator=cuda, device="cuda")
    before = ops.rglru_scan_backward.launches
    got = ops.rglru_scan_backward(a, h, h0, dh)
    ref = ops.rglru_scan_backward_reference(a, h, h0, dh)
    torch.cuda.synchronize()
    assert ops.rglru_scan_backward.launches == before + 1
    _assert_grads_close(got, ref, ("da", "db", "dh0"), torch.float32, 2e-5)


def _rglru_backward_inputs(gen, B, S, W):
    from repro_torch.kernels.rglru_scan import ops
    a, b, h0 = _rglru_inputs(gen, B, S, W, torch.float32)
    return a, ops.rglru_scan(a, b, h0), h0, torch.randn(B, S, W, generator=gen, device="cuda")


@pytest.mark.parametrize("B,S,W", [(1, 3072, 2560), (2, 1000, 100), (2, 3081, 64),
                                   (3, 1, 128)])
def test_rglru_backward_gives_the_same_bits_twice_and_by_either_staging(cuda, B, S, W):
    """No atomics: a second call gives the same bits; the plain-load staging
    feeds the same arithmetic in the same order as TMA, so it does too."""
    from repro_torch.kernels.rglru_scan import ops
    inputs = _rglru_backward_inputs(cuda, B, S, W)
    assert ops.tma_staging(inputs[0], inputs[1], inputs[3])
    got = ops.rglru_scan_backward(*inputs)
    again = ops.rglru_scan_backward(*inputs)
    plain = ops._launch_backward(*inputs, tma=False)
    torch.cuda.synchronize()
    for x, y, z in zip(got, again, plain):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.parametrize("plan", [(8, 16, 5), (8, 64, 2), (4, 64, 3), (8, 8, 10), (1, 64, 10),
                                  (2, 1, 300)])
def test_rglru_backward_takes_any_plan(cuda, plan):
    """Any plan that covers S (chunks and rounds, a last round of empty
    chunks too) gives the gradient."""
    from repro_torch.kernels.rglru_scan import ops
    inputs = _rglru_backward_inputs(cuda, 2, 600, 96)
    got = ops._launch_backward(*inputs, plan=ops.ScanPlan(*plan))
    ref = ops.rglru_scan_backward_reference(*inputs)
    torch.cuda.synchronize()
    _assert_grads_close(got, ref, ("da", "db", "dh0"), torch.float32, 2e-5)


def test_rglru_backward_plan_is_resident_and_rejects_tma_where_it_cannot(cuda):
    """At recurrentgemma-2b's training shape the card holds all 80 clusters
    of the plan at once (the CUDA runtime's count), each block within the default
    48 KB; TMA on 132-byte rows raises before any launch."""
    from repro_torch.kernels.rglru_scan import ops
    smem, resident = ops.backward_residency(ops.scan_plan(3072))
    assert smem <= 48 * 1024 and resident >= -(-2560 // ops.BWD_TILE_W)
    inputs = _rglru_backward_inputs(cuda, 2, 40, 33)
    with pytest.raises(ValueError):
        ops._launch_backward(*inputs, tma=True)


MLSTM_BWD_CASES = [  # (B, S, H, dqk, dv, chunk, dtype, floor)
    (1, 2048, 4, 512, 1024, 256, torch.bfloat16, None),   # xlstm-1.3b's training layer
    (4, 512, 4, 512, 1024, 256, torch.float32, None),
    *((1, 300, 2, 64, 96, 256, t, None) for t in (torch.float32, torch.bfloat16)),  # chunk 150
    *((2, 192, 2, 128, 256, 256, t, None) for t in (torch.float32, torch.bfloat16)),  # one chunk
    *((2, 128, 4, 16, 32, 256, t, None) for t in (torch.float32, torch.bfloat16)),  # reduced
    (1, 768, 2, 512, 160, 256, torch.bfloat16, None),     # three chunks, dv ragged at dqk 512
    (2, 512, 4, 128, 256, 256, torch.bfloat16, (0.3, -1.0)),  # chip_smoke's floor-winning draw
]


def _mlstm_bwd_tol(dtype):
    return {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]


def _mlstm_floor_inputs(B, S, H, dqk, dv, dtype, q_scale, i_shift, seed=0):
    """Drawn as ``tests/test_torch_mlstm_backward.py`` draws them (numpy),
    q scaled and the input gate shifted so that the denominator's floor
    exp(-m_j) wins at part of the positions; gates float32."""
    import numpy as np
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dqk)) * q_scale
    k = rng.standard_normal((B, S, H, dqk)) / np.sqrt(dqk)
    v = rng.standard_normal((B, S, H, dv))
    il = rng.standard_normal((B, S, H)) + i_shift
    x = rng.standard_normal((B, S, H)).astype(np.float32) + 2.0
    fl = -np.logaddexp(0.0, -x)
    dh = rng.standard_normal((B, S, H, dv))
    card = lambda a, t: torch.from_numpy(a.astype(np.float32)).cuda().to(t)  # noqa: E731
    return (card(q, dtype), card(k, dtype), card(v, dtype), card(il, torch.float32),
            card(fl, torch.float32)), card(dh, dtype)


@pytest.mark.parametrize("B,S,H,dqk,dv,chunk,dtype,floor", MLSTM_BWD_CASES)
def test_mlstm_backward_kernel_matches_plain(cuda, B, S, H, dqk, dv, chunk, dtype, floor):
    """dq, dk, dv, di, df of the backward kernels against the plain formulas
    on the same inputs, each under ``_assert_grads_close``; a second call
    gives the same bits (no atomics). float32 is held here up to S 512: at
    S 2048 (max/rms of dq ~115) both sides are float32 approximations that
    ``grad_tol`` cannot tell apart, so there each is held against float64
    (``test_mlstm_backward_float32_at_s_2048_against_float64``). The
    training layer runs bf16, held here at S 2048. ``floor`` (q_scale,
    i_shift) draws chip_smoke's floor-winning inputs, where the floor
    exp(-m_j) wins at part of the positions (dden is 0 there)."""
    from repro_torch.kernels.mlstm_chunk import ops
    from repro_torch.kernels.mlstm_chunk.ref import floor_share
    if floor is None:
        q, k, v, i_log, f_log = _mlstm_inputs(cuda, B, S, H, dqk, dv, dtype)
        dh = _randn(cuda, B, S, H, dv, dtype=dtype)
    else:
        (q, k, v, i_log, f_log), dh = _mlstm_floor_inputs(B, S, H, dqk, dv, dtype, *floor)
        assert 0.0 < floor_share(q, k, i_log, f_log, chunk=chunk) < 1.0
    h = ops.mlstm_chunk_reference(q, k, v, i_log, f_log, chunk=chunk)
    before = ops.mlstm_chunk_backward.launches
    got = ops.mlstm_chunk_backward(q, k, v, i_log, f_log, h, dh, chunk=chunk)
    again = ops.mlstm_chunk_backward(q, k, v, i_log, f_log, h, dh, chunk=chunk)
    ref = ops.mlstm_chunk_backward_reference(q, k, v, i_log, f_log, h, dh, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.mlstm_chunk_backward.launches == before + 2
    _assert_grads_close(got, ref, ("dq", "dk", "dv", "di", "df"), dtype, _mlstm_bwd_tol(dtype))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# float32 at S 2048 against a float64 evaluation of the same formulas on the
# same inputs: the kernel's and the plain version's worst element, as a share
# of the float32 tolerance of _assert_grads_close, both measured at 0.3-2.24
# over five input draws on an H100 (either order may be the worse one), so
# each is held at 3.
MLSTM_F64_SHARE = 3.0


@pytest.mark.parametrize("B,S,H,dqk,dv", [(1, 2048, 4, 512, 1024), (2, 2048, 2, 128, 256)])
def test_mlstm_backward_float32_at_s_2048_against_float64(cuda, B, S, H, dqk, dv):
    """xlstm-1.3b's training layer (and a narrower one) in float32: the
    backward kernels and the plain formulas each against the formulas in
    float64 on the same inputs (q, k, v, the gates, h and dh upcast), each
    gradient's worst element within ``MLSTM_F64_SHARE`` x (1e-5 |ref| +
    1e-4 rms(ref)) and ||got - ref|| within 1e-4 ||ref||. Kernel against
    plain at grad_tol cannot tell the two float32 orders apart here (max/rms
    of dq ~115)."""
    from repro_torch.kernels.mlstm_chunk import ops
    q, k, v, i_log, f_log = _mlstm_inputs(cuda, B, S, H, dqk, dv, torch.float32)
    h = ops.mlstm_chunk_reference(q, k, v, i_log, f_log)
    dh = _randn(cuda, B, S, H, dv, dtype=torch.float32)
    args = (q, k, v, i_log, f_log, h, dh)
    want = ops.mlstm_chunk_backward_reference(*(t.double() for t in args))
    for side, got in (("kernel", ops.mlstm_chunk_backward(*args)),
                      ("plain", ops.mlstm_chunk_backward_reference(*args))):
        for name, g, r in zip(("dq", "dk", "dv", "di", "df"), got, want):
            assert g.dtype == torch.float32 and torch.isfinite(g).all(), (side, name)
            d = (g.double() - r).abs()
            rms = r.square().mean().sqrt()
            share = (d / (1e-5 * r.abs() + 1e-4 * rms)).max().item()
            assert share <= MLSTM_F64_SHARE, (side, name, share)
            assert d.norm().item() <= 1e-4 * r.norm().item(), (side, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_chunk_under_autograd_launches_the_backward_on_the_card(cuda, dtype):
    """A CUDA call that autograd records runs the forward kernels once and,
    in the backward pass, the backward kernels once; the gradients are the
    plain formulas' on the same h and dh."""
    from repro_torch.kernels.mlstm_chunk import ops
    q, k, v, i_log, f_log = _mlstm_inputs(cuda, 2, 512, 2, 128, 256, dtype)
    ts = [t.requires_grad_(True) for t in (q, k, v, i_log, f_log)]
    dh = _randn(cuda, 2, 512, 2, 256, dtype=dtype)
    f0, b0 = ops.mlstm_chunk.launches, ops.mlstm_chunk_backward.launches
    h = ops.mlstm_chunk(*ts)
    got = torch.autograd.grad(h, ts, dh)
    torch.cuda.synchronize()
    assert (ops.mlstm_chunk.launches, ops.mlstm_chunk_backward.launches) == (f0 + 1, b0 + 1)
    ref = ops.mlstm_chunk_backward_reference(*(t.detach() for t in ts), h.detach(), dh)
    _assert_grads_close(got, ref, ("dq", "dk", "dv", "di", "df"), dtype, _mlstm_bwd_tol(dtype))


# ----------------------------------------------------------------- sLSTM

SLSTM_CASES = [  # (B, S, H, dh, a non-zero initial state)
    (4, 512, 4, 512, False),     # xlstm-1.3b's serving prefill: a cluster of 16 blocks a head
    (1, 2048, 4, 512, False),    # its training layer
    (4, 1, 4, 512, True),        # a decode step from the cache's state
    (8, 8, 4, 16, False),        # the launchers' reduced dh 16: one block a head
    (2, 40, 2, 128, True),       # chip_smoke's small xLSTM model: one block of 128 columns
    (3, 33, 3, 100, True),       # a whole head of 100 columns a block, two row groups
]


def _slstm_state(gen, B, H, dh, nonzero):
    if not nonzero:
        return {k: torch.zeros((B, H, dh) if k != "m" else (B, H), device="cuda") for k in "hcnm"}
    return {"h": _randn(gen, B, H, dh, dtype=torch.float32) * 0.5,
            "c": _randn(gen, B, H, dh, dtype=torch.float32),
            "n": torch.rand(B, H, dh, generator=gen, device="cuda") * 1.5 + 0.5,
            "m": _randn(gen, B, H, dtype=torch.float32)}


def _slstm_inputs(gen, B, S, H, dh, nonzero=False):
    x = [_randn(gen, B, S, H, dh, dtype=torch.float32) for _ in range(4)]
    rec = _randn(gen, 4, H, dh, dh, dtype=torch.float32) / dh ** 0.5
    return x, rec, _slstm_state(gen, B, H, dh, nonzero)


def _slstm_close(got, want, what):
    """h at atol 1e-5; a state tensor at 1e-5 of max(1, its largest value):
    n and c grow with the steps, float32 sums in another order."""
    tol = 1e-5 * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= tol, (what, err, tol)


@pytest.mark.parametrize("B,S,H,dh,nonzero", SLSTM_CASES)
def test_slstm_scan_kernel_matches_plain(cuda, B, S, H, dh, nonzero):
    from repro_torch.kernels.slstm_scan import ops
    x, rec, state = _slstm_inputs(cuda, B, S, H, dh, nonzero)
    before = ops.slstm_scan.launches
    h, final = ops.slstm_scan(*x, rec, state)
    h2, final2 = ops.slstm_scan(*x, rec, state)
    h_ref, final_ref = ops.slstm_scan_reference(*x, rec, state)
    torch.cuda.synchronize()
    assert ops.slstm_scan.launches == before + 2
    _slstm_close(h, h_ref, "h")
    for k in "hcnm":
        _slstm_close(final[k], final_ref[k], k)
        assert torch.equal(final[k], final2[k]), k
    assert torch.equal(h, h2)


def test_slstm_scan_at_s_2048_against_float64(cuda):
    """The forward at xlstm-1.3b's training layer: the kernel's worst error
    in h against a float64 run of the plain version at most 3x the plain
    float32 version's."""
    from repro_torch.kernels.slstm_scan import ops
    x, rec, state = _slstm_inputs(cuda, 1, 2048, 4, 512)
    want, _ = ops.slstm_scan_reference(*(t.double() for t in x), rec.double(),
                                       {k: v.double() for k, v in state.items()})
    got, _ = ops.slstm_scan(*x, rec, state)
    plain, _ = ops.slstm_scan_reference(*x, rec, state)
    err = (got.double() - want).abs().max().item()
    assert err <= 3 * (plain.double() - want).abs().max().item(), err


SLSTM_BWD_CASES = [  # (B, S, H, dh, input gate shift on the first 3 steps: the floor wins)
    (1, 2048, 4, 512, 0.0), (4, 512, 4, 512, 0.0), (8, 128, 4, 16, 0.0),
    (2, 40, 2, 128, 0.0), (3, 33, 3, 100, 0.0), (2, 64, 4, 512, -20.0), (2, 40, 4, 16, -20.0),
]


@pytest.mark.parametrize("B,S,H,dh,shift", SLSTM_BWD_CASES)
def test_slstm_backward_kernel_matches_plain(cuda, B, S, H, dh, shift):
    """dxz, dxi, dxf, dxo and drec of the backward kernel (and its product)
    against the plain formulas on the same saved values (the plain
    forward's), under ``_assert_grads_close`` at float32; a second call
    gives the same bits. ``shift``: the input gate 20 below the forget
    gate on the first steps, where the floor max(n, 1e-6) wins."""
    from repro_torch.kernels.slstm_scan import ops
    from repro_torch.kernels.slstm_scan.ref import FLOOR
    x, rec, state = _slstm_inputs(cuda, B, S, H, dh)
    if shift:
        x[1][:, :3] += shift
        x[2][:, :3] += 4.0
    h, _, saved = ops.slstm_scan_reference(*x, rec, state, with_saved=True)
    if shift:
        share = (saved.n < FLOOR).float().mean().item()
        assert 0.0 < share < 1.0 and bool((saved.n[:, 0] < FLOOR).all()), share
    dh_out = _randn(cuda, B, S, H, dh, dtype=torch.float32)
    before = ops.slstm_scan_backward.launches
    got = ops.slstm_scan_backward(rec, state, h, saved, dh_out)
    again = ops.slstm_scan_backward(rec, state, h, saved, dh_out)
    ref = ops.slstm_scan_backward_reference(rec, state, h, saved, dh_out)
    torch.cuda.synchronize()
    assert ops.slstm_scan_backward.launches == before + 2
    _assert_grads_close(got, ref, ("dxz", "dxi", "dxf", "dxo", "drec"), torch.float32, 1e-4)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_slstm_kernel_saves_what_the_plain_forward_saves(cuda):
    from repro_torch.kernels.slstm_scan import ops
    x, rec, state = _slstm_inputs(cuda, 2, 300, 4, 512, nonzero=True)
    h, _, saved = ops._launch(*x, rec, state, with_saved=True)
    h_ref, _, saved_ref = ops.slstm_scan_reference(*x, rec, state, with_saved=True)
    _slstm_close(h, h_ref, "h")
    for name, g, r in zip(saved._fields, saved, saved_ref):
        _slstm_close(g, r, name)


def test_slstm_scan_under_autograd_launches_both_kernels_on_the_card(cuda):
    from repro_torch.kernels.slstm_scan import ops
    x, rec, state = _slstm_inputs(cuda, 2, 256, 4, 512)
    leaves = [t.requires_grad_(True) for t in (*x, rec)]
    dh_out = _randn(cuda, 2, 256, 4, 512, dtype=torch.float32)
    f0, b0 = ops.slstm_scan.launches, ops.slstm_scan_backward.launches
    assert not torch.backends.cuda.matmul.allow_tf32          # drec's product in float32
    h, final = ops.slstm_scan(*leaves, state)
    got = torch.autograd.grad(h, leaves, dh_out)
    torch.cuda.synchronize()
    assert (ops.slstm_scan.launches, ops.slstm_scan_backward.launches) == (f0 + 1, b0 + 1)
    assert not any(t.requires_grad for t in final.values())
    plain = [t.detach() for t in leaves]
    h_ref, _, saved = ops.slstm_scan_reference(*plain[:4], plain[4], state, with_saved=True)
    ref = ops.slstm_scan_backward_reference(plain[4], state, h_ref, saved, dh_out)
    _assert_grads_close(got, ref, ("dxz", "dxi", "dxf", "dxo", "drec"), torch.float32, 1e-4)


def test_slstm_kernels_in_row_groups(cuda):
    """35 rows at xlstm-1.3b's heads: several clusters of 16 blocks a head,
    forward and backward against the plain versions, second calls
    bit-equal."""
    from repro_torch.kernels.slstm_scan import ops
    B, S, H, dh = 35, 48, 4, 512
    plan = ops.card_plan(B, H, dh, torch.device("cuda"))
    assert plan.blocks == 16 and plan.groups >= 2 and plan.rows * plan.groups >= B
    x, rec, state = _slstm_inputs(cuda, B, S, H, dh, nonzero=True)
    h, final, saved = ops._launch(*x, rec, state, with_saved=True)
    h2, _, _ = ops._launch(*x, rec, state, with_saved=True)
    h_ref, final_ref, saved_ref = ops.slstm_scan_reference(*x, rec, state, with_saved=True)
    torch.cuda.synchronize()
    assert torch.equal(h, h2)
    _slstm_close(h, h_ref, "h")
    for k in "hcnm":
        _slstm_close(final[k], final_ref[k], k)
    for name, g, r in zip(saved._fields, saved, saved_ref):
        _slstm_close(g, r, name)
    dh_out = _randn(cuda, B, S, H, dh, dtype=torch.float32)
    got = ops.slstm_scan_backward(rec, state, h_ref, saved_ref, dh_out)
    again = ops.slstm_scan_backward(rec, state, h_ref, saved_ref, dh_out)
    ref = ops.slstm_scan_backward_reference(rec, state, h_ref, saved_ref, dh_out)
    torch.cuda.synchronize()
    _assert_grads_close(got, ref, ("dxz", "dxi", "dxf", "dxo", "drec"), torch.float32, 1e-4)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_slstm_plan_is_resident_and_the_wrapper_rejects(cuda):
    """Each plan's block takes the shared bytes ops.py counts, and the card
    runs at least one of its clusters at once, forward and backward."""
    from repro_torch.kernels.slstm_scan import ops
    for B, H, dh in ((4, 4, 512), (1, 4, 512), (35, 4, 512), (8, 4, 16), (2, 2, 128)):
        plan = ops.card_plan(B, H, dh, torch.device("cuda"))
        C, P, Bc, _ = plan
        for forward, floats in ((True, ops.forward_smem_floats), (False, ops.backward_smem_floats)):
            smem, clusters = ops.residency(plan, dh, forward)
            assert smem == 4 * floats(Bc, dh, C, P) <= ops.SMEM_LIMIT
            assert clusters >= 1, (B, H, dh, forward)
    x, rec, state = _slstm_inputs(cuda, 2, 8, 4, 16)
    with pytest.raises(ValueError):
        ops.slstm_scan(x[0].double(), *x[1:], rec, state)
    with pytest.raises(ValueError):
        ops.slstm_scan(*x[:3], x[3].transpose(0, 1).contiguous().transpose(0, 1), rec, state)
    x, rec, state = _slstm_inputs(cuda, 2, 8, 1, 1024)
    with pytest.raises(ValueError):                    # a head too wide for 16 blocks
        ops.slstm_scan(*x, rec, state)
