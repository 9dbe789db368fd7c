"""Port parity: repro_torch flash_attention (plain version, CPU tensors) vs the
JAX package's flash attention at impl="interpret" (the Pallas kernel run by
the interpreter) and impl="ref", and vs the model's chunked attention.

float32 throughout; tolerance 2e-5, the JAX package's own kernel tolerance
(tests/test_kernels.py): the sums run in a different order on each side.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.models.attention import chunked_causal_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
TOL = 2e-5

SWEEP = [  # tests/test_kernels.py flash sweep
    (2, 256, 4, 2, 128, 0),
    (1, 512, 4, 4, 128, 0),
    (2, 256, 8, 2, 128, 128),
    (1, 256, 2, 1, 128, 64),      # MQA + window
]


def _inputs(B, S, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, S, K, hd), dtype=np.float32),
            rng.standard_normal((B, S, K, hd), dtype=np.float32))


def _port(q, k, v, **kw):
    return ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw).numpy()


def _maxerr(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


@pytest.mark.parametrize("impl", ["interpret", "ref"])
@pytest.mark.parametrize("B,S,H,K,hd,win", SWEEP)
def test_flash_plain_matches_jax_kernel(B, S, H, K, hd, win, impl):
    q, k, v = _inputs(B, S, H, K, hd)
    before = ops.flash_attention.launches
    out = _port(q, k, v, window=win)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    impl=impl, window=win, block_q=128, block_k=128)
    assert out.shape == (B, S, H, hd) and out.dtype == np.float32
    assert _maxerr(out, ref) < TOL
    assert ops.flash_attention.launches == before   # CPU tensors never launch


@pytest.mark.parametrize("B,S,H,K,hd,win", SWEEP)
def test_flash_plain_matches_model_chunked_attention(B, S, H, K, hd, win):
    q, k, v = _inputs(B, S, H, K, hd, seed=1)
    ref = chunked_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.arange(S), window=win)
    assert _maxerr(_port(q, k, v, window=win), ref) < TOL


@pytest.mark.parametrize("S,causal,win", [(200, True, 0), (500, True, 96),
                                          (130, False, 0)])
def test_flash_plain_ragged_and_noncausal_match_jax_ref(S, causal, win):
    q, k, v = _inputs(1, S, 4, 2, 128, seed=2)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    impl="ref", causal=causal, window=win)
    assert _maxerr(_port(q, k, v, causal=causal, window=win), ref) < TOL


@pytest.mark.parametrize("S,win", [(200, 0), (200, 64)])
def test_flash_plain_head_dim_256_group_10_matches_jax_ref(S, win):
    """recurrentgemma-2b's heads: 10 query heads over 1 kv head, head_dim 256."""
    q, k, v = _inputs(2, S, 10, 1, 256, seed=3)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    impl="ref", window=win)
    assert _maxerr(_port(q, k, v, window=win), ref) < TOL


@pytest.mark.parametrize("impl", ["interpret", "ref"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("B,S,H,K,win", [(8, 8, 4, 2, 0), (8, 8, 4, 1, 16),
                                         (2, 256, 4, 2, 64)])
def test_flash_plain_small_head_dims_match_jax_kernel(B, S, H, K, win, hd, impl):
    """head_dim 16 (every reduced config: qwen2-7b's and recurrentgemma-2b's
    prefill at the launcher's defaults) and 64 (musicgen-large)."""
    q, k, v = _inputs(B, S, H, K, hd, seed=4)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl=impl,
                    window=win, block_q=128, block_k=128)
    assert _maxerr(_port(q, k, v, window=win), ref) < TOL


def test_flash_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 2, 128))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :8], v[:, :8])
    with pytest.raises(ValueError):
        ops.flash_attention(q[:, :, :3], k, v)          # 3 heads over 2 kv heads
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.double(), v)


# The bf16 kernel's tensor maps are planned in Python (ops.tensor_map_plan):
# the byte strides, box and alignment checks run here on CPU tensors.

def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("shape,rows,strides", [
    ((4, 512, 28, 128), 64, (256, 7168, 3670016)),      # qwen2-7b q
    ((4, 512, 4, 128), 64, (256, 1024, 524288)),         # its k / v
    ((4, 512, 10, 256), 64, (512, 5120, 2621440)),       # recurrentgemma-2b q
    ((4, 512, 1, 256), 32, (512, 512, 262144)),          # its k / v, one head; 32-row box
])
def test_tensor_map_plan_of_contiguous_tensors(shape, rows, strides):
    B, S, heads, hd = shape
    plan = ops.tensor_map_plan(_bf16(*shape), rows)
    assert plan.dims == (hd, heads, S, B)
    assert plan.strides == strides
    assert plan.box == (ops.BOX_COLS, 1, rows, 1) and ops.BOX_COLS * 2 == 128
    assert plan.values() == (hd, heads, S, B, *strides, 64, 1, rows, 1)


def test_tensor_map_plan_of_slices_of_a_fused_qkv():
    B, S, H, K, hd = 2, 300, 28, 4, 128
    fused = _bf16(B, S, H + 2 * K, hd)
    row = (H + 2 * K) * hd * 2
    for t, heads in ((fused[:, :, :H], H), (fused[:, :, H:H + K], K),
                     (fused[:, :, H + K:], K)):
        plan = ops.tensor_map_plan(t, 64)
        assert plan.dims == (hd, heads, S, B)
        assert plan.strides == (hd * 2, row, S * row)


def test_tensor_map_plan_gives_size_one_dims_their_contiguous_stride():
    t = torch.zeros(64 * 256 + 8, dtype=torch.bfloat16).as_strided(
        (1, 64, 1, 256), (3, 256, 5, 1))       # strides of size-1 dims are free
    plan = ops.tensor_map_plan(t, 32)
    assert plan.strides == (512, 512, 64 * 512)


def test_tensor_map_plan_rejects_what_tma_cannot_take():
    B, S, H, hd = 1, 64, 4, 128
    n = B * S * H * hd
    cases = {
        "16-byte aligned base": _bf16(n + 8)[1:n + 1].view(B, S, H, hd),
        "multiples of 16": _bf16(B, S, H * hd + 1)[..., :H * hd].unflatten(-1, (H, hd)),
        "contiguous head dim": _bf16(B, S, H, 2 * hd)[..., ::2],
        "bfloat16": torch.zeros(B, S, H, hd),
        "multiple of 64": _bf16(B, S, H, 96),
    }
    for why, t in cases.items():
        with pytest.raises(ValueError, match=why):
            ops.tensor_map_plan(t, 64)
    with pytest.raises(ValueError, match="box rows"):
        ops.tensor_map_plan(_bf16(B, S, H, hd), 512)


def test_tile_configs_name_instances_of_the_kernel_source():
    """The wrapper's tile sizes are the source's, each head dim has an
    instance in both dtypes (bf16 on the tensor cores where it is in
    ``TC_HEAD_DIMS``), and a K/V tile is a whole number of wgmma k16 steps."""
    source = (Path(ops.__file__).parent / "csrc" / "flash_attention.cu").read_text()
    assert f"constexpr int BM = {ops.BLOCK_Q};" in source
    assert f"constexpr int BK = {ops.BLOCK_K};" in source
    assert f"constexpr int PLAN = {len(ops.tensor_map_plan(_bf16(1, 64, 1, 128), 64).values())};" \
        in source
    for hd in ops.TC_HEAD_DIMS:
        assert f"launch_tc<{hd}>(" in source
    for hd in ops.HEAD_DIMS:                 # float32 on the CUDA-core kernel
        assert f"FLASH_CC(float, {hd});" in source
    for hd in sorted(set(ops.HEAD_DIMS) - set(ops.TC_HEAD_DIMS)):
        assert f"FLASH_CC(__nv_bfloat16, {hd});" in source
    assert ops.BLOCK_K % 16 == 0 and ops.BLOCK_Q == 64


def test_flash_bf16_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(1, 100, 4, 2, 128))
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, window=32)
    assert out.dtype == torch.bfloat16 and ops.flash_attention.launches == before
    want = ops.flash_attention_reference(q, k, v, window=32)
    assert torch.equal(out, want)


def test_bf16_kernel_args_pack_the_three_plans_and_out_strides():
    B, S, H, K, hd = 2, 300, 8, 2, 128
    fused = _bf16(B, S, H + 2 * K, hd)
    q, k, v = fused[:, :, :H], fused[:, :, H:H + K], fused[:, :, H + K:]
    out = _bf16(B, S, H, hd)
    args = list(ops.bf16_kernel_args(q, k, v, out))
    assert args == [*ops.tensor_map_plan(q, ops.BLOCK_Q).values(),
                    *ops.tensor_map_plan(k, ops.BLOCK_K).values(),
                    *ops.tensor_map_plan(v, ops.BLOCK_K).values(), *out.stride()[:3]]


def test_bf16_kernel_args_are_cached_per_layout_and_check_each_base():
    """A second call with the same shapes and strides reuses the packed plans,
    but a base that is not 16-byte aligned still raises."""
    B, S, H, K, hd = 1, 64, 4, 2, 128
    q, k, v, out = _bf16(B, S, H, hd), _bf16(B, S, K, hd), _bf16(B, S, K, hd), _bf16(B, S, H, hd)
    first = ops.bf16_kernel_args(q, k, v, out)
    q2, k2, v2 = _bf16(B, S, H, hd), _bf16(B, S, K, hd), _bf16(B, S, K, hd)
    assert ops.bf16_kernel_args(q2, k2, v2, out) is first
    n = B * S * K * hd
    shifted = _bf16(n + 8)[1:n + 1].view(B, S, K, hd)        # same shape and strides
    for args in ((shifted, k, v, out), (q, shifted, v, out), (q, k, shifted, out)):
        with pytest.raises(ValueError, match="16-byte aligned base"):
            ops.bf16_kernel_args(*args)
    with pytest.raises(ValueError, match="multiples of 16"):
        odd = _bf16(B, S, K * hd + 1)[..., :K * hd].unflatten(-1, (K, hd))
        ops.bf16_kernel_args(q, odd, v, out)


# The backward's choice of kernels and its tensor maps are planned in Python
# (ops.backward_instance, ops.backward_kernel_args): checked here on CPU
# tensors, before anything launches.

@pytest.mark.parametrize("dtype,hd,family", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"), (torch.bfloat16, 256, "tc"),
    (torch.bfloat16, 16, "cc"), (torch.float32, 16, "cc"), (torch.float32, 64, "cc"),
    (torch.float32, 128, "cc"), (torch.float32, 256, "cc"),
])
def test_backward_instance_by_dtype_and_head_dim(dtype, hd, family):
    """bf16 at the tensor-core head dims takes the wgmma kernels; float32
    (TF32 would break its tolerance) and bf16 at head_dim 16 the CUDA-core
    ones, as the forward chooses."""
    assert ops.backward_instance(dtype, hd) == family
    assert (family == "tc") == (dtype == torch.bfloat16 and hd in ops.TC_HEAD_DIMS)


@pytest.mark.parametrize("B,S,H,K,hd", [
    (1, 3072, 10, 1, 256),        # recurrentgemma-2b's training shape
    (4, 512, 28, 4, 128),         # qwen2-7b's heads
    (2, 40, 4, 1, 64),            # S below a tile
])
def test_backward_kernel_args_pack_four_plans_of_64_row_boxes(B, S, H, K, hd):
    q, do = _bf16(B, S, H, hd), _bf16(B, S, H, hd)
    k, v = _bf16(B, S, K, hd), _bf16(B, S, K, hd)
    args = list(ops.backward_kernel_args(q, k, v, do))
    assert len(args) == 4 * len(ops.tensor_map_plan(q, 64).values()) == 44
    want = [ops.tensor_map_plan(t, ops.BWD_BLOCK).values() for t in (q, k, v, do)]
    assert args == [x for plan in want for x in plan]
    assert want[0] == (hd, H, S, B, 2 * hd, 2 * hd * H, 2 * hd * H * S, 64, 1, 64, 1)
    assert want[1][:4] == (hd, K, S, B) and want[1][9] == ops.BWD_BLOCK == 64
    assert want[3] == want[0]


def test_backward_kernel_args_reject_what_tma_cannot_take():
    """A base that is not 16-byte aligned in any of q, k, v or dO raises
    ValueError (the wrapper plans before it allocates or launches), as do a
    head dim that is not a multiple of 64 and a float32 tensor."""
    B, S, H, K, hd = 1, 64, 4, 2, 128
    q, do, k, v = _bf16(B, S, H, hd), _bf16(B, S, H, hd), _bf16(B, S, K, hd), _bf16(B, S, K, hd)
    ops.backward_kernel_args(q, k, v, do)
    shifted_q = _bf16(B * S * H * hd + 8)[1:B * S * H * hd + 1].view(B, S, H, hd)
    shifted_kv = _bf16(B * S * K * hd + 8)[1:B * S * K * hd + 1].view(B, S, K, hd)
    for args in ((shifted_q, k, v, do), (q, shifted_kv, v, do), (q, k, shifted_kv, do),
                 (q, k, v, shifted_q)):
        with pytest.raises(ValueError, match="16-byte aligned base"):
            ops.backward_kernel_args(*args)
    with pytest.raises(ValueError, match="multiple of 64"):
        ops.backward_kernel_args(*(_bf16(B, S, n, 96) for n in (H, K, K, H)))
    with pytest.raises(ValueError, match="bfloat16"):
        ops.backward_kernel_args(*(torch.zeros(B, S, n, hd) for n in (H, K, K, H)))


def test_backward_grids_and_instances_name_the_kernel_source():
    """The wrapper's tile sizes and grids are the source's: every kernel
    ``backward_grids`` names is defined there, the tensor-core entry has an
    instance at each of ``TC_HEAD_DIMS``, the CUDA-core entry float32 at
    every head dim and bf16 only at the others."""
    source = (Path(ops.__file__).parent / "csrc" / "flash_attention_bwd.cu").read_text()
    assert f"constexpr int TC_BM = {ops.BWD_BLOCK};" in source
    assert f"constexpr int TC_BN = {ops.BWD_BLOCK};" in source
    assert f"constexpr int REDUCE_THREADS = {ops.BWD_REDUCE_THREADS};" in source
    dq_rows, kv_rows = ops.BWD_CC_ROWS
    assert f"constexpr int DQ_BQ = {dq_rows};" in source
    assert f"constexpr int KV_BK = {kv_rows};" in source
    for dtype, hd in ((torch.bfloat16, 256), (torch.float32, 16)):
        for name in ops.backward_grids(dtype, 1, 100, 4, 2, hd):
            assert f"{name}_kernel(" in source, name
    for hd in ops.TC_HEAD_DIMS:
        assert f"if (hd == {hd}) FLASH_BWD_TC({hd});" in source
        assert f"FLASH_BWD(__nv_bfloat16, {hd});" not in source
    for hd in ops.HEAD_DIMS:
        assert f"FLASH_BWD(float, {hd});" in source
    for hd in sorted(set(ops.HEAD_DIMS) - set(ops.TC_HEAD_DIMS)):
        assert f"FLASH_BWD(__nv_bfloat16, {hd});" in source


@pytest.mark.parametrize("S,tiles", [(3072, 48), (512, 8), (300, 5), (40, 1)])
def test_backward_grids_fill_the_card_at_one_kv_head(S, tiles):
    """The tensor-core dK/dV grid splits each group's query heads over
    blocks: one block per (64-key tile, query head), so recurrentgemma-2b's
    [1, 3072, 10, 1, 256] gets 480 blocks for 132 SMs where one per kv head
    would give 48; the partials' sum takes 4 columns a thread."""
    B, H, K, hd = 1, 10, 1, 256
    grids = ops.backward_grids(torch.bfloat16, B, S, H, K, hd)
    assert grids == {"flash_bwd_tc_dq": tiles * B * H, "flash_bwd_tc_dkdv": tiles * B * H,
                     "flash_bwd_reduce": -(-(B * S * K * hd // 4) // 256)}
    assert ops.backward_grids(torch.float32, B, S, H, K, hd) == {
        "flash_bwd_dq": -(-S // 32) * B * H, "flash_bwd_dkdv": -(-S // 16) * B * K}


def test_flash_backward_bf16_cpu_tensors_take_the_plain_formulas():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(1, 100, 4, 2, 128))
    out, lse = ops.flash_attention_reference(q, k, v, window=32, return_lse=True)
    do = torch.ones_like(out)
    before = ops.flash_attention_backward.launches
    got = ops.flash_attention_backward(q, k, v, out, do, lse, window=32)
    want = ops.flash_attention_backward_reference(q, k, v, out, do, lse, window=32)
    assert ops.flash_attention_backward.launches == before
    assert all(torch.equal(g, w) and g.dtype == torch.bfloat16 for g, w in zip(got, want))
