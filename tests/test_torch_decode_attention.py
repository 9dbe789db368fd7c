"""Port parity: repro_torch decode_attention (plain version, CPU tensors) vs the
JAX package's decode attention at impl="interpret" and impl="ref".

float32; tolerance 2e-5, the JAX package's own kernel tolerance
(tests/test_kernels.py): the sums run in a different order on each side.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import decode_attention as jax_decode  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
TOL = 2e-5


def _inputs(B, H, K, hd, L, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, hd), dtype=np.float32),
            rng.standard_normal((B, L, K, hd), dtype=np.float32),
            rng.standard_normal((B, L, K, hd), dtype=np.float32))


def _check(q, ck, cv, sp, cur, win, impl):
    before = ops.decode_attention.launches
    out = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                               torch.from_numpy(cv), torch.from_numpy(sp),
                               cur, window=win).numpy()
    kw = {"block_k": 256} if impl == "interpret" else {}
    ref = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                jnp.asarray(sp), cur, window=win, impl=impl, **kw))
    assert out.shape == q.shape and out.dtype == np.float32
    assert float(np.max(np.abs(out - ref))) < TOL
    assert ops.decode_attention.launches == before   # CPU tensors never launch


@pytest.mark.parametrize("impl", ["interpret", "ref"])
@pytest.mark.parametrize("B,H,K,hd,L,win,fill", [  # tests/test_kernels.py sweep
    (2, 8, 2, 128, 1024, 0, 1024),
    (2, 8, 4, 128, 1024, 0, 700),       # partially-filled cache
    (1, 4, 1, 128, 512, 256, 512),      # MQA ring window
    (1, 2, 2, 128, 512, 0, 512),
])
def test_decode_plain_matches_jax_kernel(B, H, K, hd, L, win, fill, impl):
    q, ck, cv = _inputs(B, H, K, hd, L)
    sp = np.where(np.arange(L) < fill, np.arange(L), -1).astype(np.int32)
    _check(q, ck, cv, sp, fill - 1, win, impl)


@pytest.mark.parametrize("impl", ["interpret", "ref"])
def test_decode_plain_wrapped_ring_cache(impl):
    """A 256-slot ring after 700 tokens: slot s holds the newest p = s mod 256."""
    L, cur, win = 256, 699, 256
    q, ck, cv = _inputs(2, 8, 2, 128, L, seed=1)
    sp = np.array([max(p for p in range(cur + 1) if p % L == s)
                   for s in range(L)], np.int32)
    _check(q, ck, cv, sp, cur, win, impl)


@pytest.mark.parametrize("win,fill", [(0, 300), (128, 300)])
def test_decode_plain_head_dim_256_group_10_matches_jax_ref(win, fill):
    """recurrentgemma-2b's heads: 10 query heads over 1 kv head, head_dim 256;
    with a window smaller than the filled slots."""
    L = 320
    q, ck, cv = _inputs(2, 10, 1, 256, L, seed=2)
    sp = np.where(np.arange(L) < fill, np.arange(L), -1).astype(np.int32)
    _check(q, ck, cv, sp, fill - 1, win, "ref")


@pytest.mark.parametrize("impl", ["interpret", "ref"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("B,H,K,L,win,fill", [(8, 4, 2, 16, 0, 9), (8, 4, 1, 16, 16, 16),
                                              (2, 8, 2, 256, 64, 256)])
def test_decode_plain_small_head_dims_match_jax_kernel(B, H, K, L, win, fill, hd, impl):
    """head_dim 16 (reduced qwen2-7b's and recurrentgemma-2b's decode at the
    launcher's defaults) and 64."""
    q, ck, cv = _inputs(B, H, K, hd, L, seed=5)
    sp = np.where(np.arange(L) < fill, np.arange(L), -1).astype(np.int32)
    _check(q, ck, cv, sp, fill - 1, win, impl)


def test_decode_wrapper_rejects_bad_inputs():
    q, ck, cv = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 128, 32))
    sp = torch.arange(32, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.decode_attention(q, ck, cv, sp[:16], 31)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, :3], ck, cv, sp, 31)


# The card's kernel splits the L slots of each (batch, kv head) over the
# blocks of a cluster and merges the per-split (m, l, acc) inside the launch.
# Its arithmetic, rehearsed here in plain PyTorch (used by these tests only):

NEG_INF = -1e30


def _split_decode(q, ck, cv, sp, cur, window, splits):
    """Per-split online-softmax partials (m, l, acc) over slots [r * slots,
    (r + 1) * slots), a masked slot at logit -1e30, merged as the cluster
    merges them: w_r = e^{m_r - M} / sum_r l_r e^{m_r - M}."""
    B, H, hd = q.shape
    L, K = ck.shape[1], ck.shape[2]
    G = H // K
    slots = -(-L // splits)
    qg = q.double().reshape(B, K, G, hd)
    valid = (sp >= 0) & (sp <= cur)
    if window > 0:
        valid &= sp > cur - window
    ms, ls, accs = [], [], []
    for r in range(splits):
        lo, hi = min(L, r * slots), min(L, (r + 1) * slots)
        s = torch.einsum("bkgd,blkd->bkgl", qg, ck[:, lo:hi].double()) / np.sqrt(hd)
        s = torch.where(valid[lo:hi], s, torch.full_like(s, NEG_INF))
        m = s.amax(-1) if hi > lo else torch.full((B, K, G), NEG_INF, dtype=torch.float64)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgl,blkd->bkgd", p, cv[:, lo:hi].double()))
    M = torch.stack(ms).amax(0)
    f = [torch.exp(m - M) for m in ms]
    den = sum(l_ * f_ for l_, f_ in zip(ls, f)).clamp_min(1e-30)
    out = sum(a * (f_ / den)[..., None] for a, f_ in zip(accs, f))
    return out.reshape(B, H, hd).float()


def _ring(L, cur):
    """Slot s of an L-slot ring after cur + 1 tokens holds the newest p = s mod L."""
    return np.array([max((p for p in range(cur + 1) if p % L == s), default=-1)
                     for s in range(L)], np.int32)


SPLIT_CASES = {  # name: (B, H, K, hd, L, slot_pos, cur, window)
    "partial fill: later splits hold no valid slot": (
        2, 8, 2, 128, 256, np.where(np.arange(256) < 40, np.arange(256), -1), 39, 0),
    "no valid slot at all (empty cache)": (
        1, 4, 1, 128, 64, np.full(64, -1), 10, 0),
    "no valid slot at all (window past every slot)": (
        1, 4, 2, 128, 64, np.arange(64), 200, 16),
    "window inside the filled slots": (
        2, 8, 2, 128, 256, np.arange(256), 255, 64),
    "wrapped ring with a window": (2, 8, 2, 128, 256, _ring(256, 699), 699, 100),
    "L smaller than the splits": (1, 4, 1, 128, 5, np.arange(5), 4, 0),
    "head_dim 256, group 10": (1, 10, 1, 256, 64, np.arange(64), 40, 16),
}


@pytest.mark.parametrize("splits", [1, 3, 8, 16])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_decode_matches_jax_kernel(case, splits):
    """The split-and-combine arithmetic against the Pallas kernel run by the
    interpreter (one kv block of 64 or 5 slots at a time, its own online
    softmax over blocks), float32 at the JAX tolerance."""
    B, H, K, hd, L, sp, cur, win = SPLIT_CASES[case]
    sp = np.asarray(sp, np.int32)
    q, ck, cv = _inputs(B, H, K, hd, L, seed=L + splits)
    got = _split_decode(*(torch.from_numpy(a) for a in (q, ck, cv, sp)), cur, win, splits)
    ref = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                jnp.asarray(sp), cur, window=win, impl="interpret",
                                block_k=min(64, L)))
    assert float(np.max(np.abs(got.numpy() - ref))) < TOL
    plain = ops.decode_attention(*(torch.from_numpy(a) for a in (q, ck, cv, sp)), cur,
                                 window=win).numpy()
    assert float(np.max(np.abs(plain - ref))) < TOL


def test_plain_decode_with_no_valid_slot_averages_v():
    """With every slot masked, each logit is -1e30 and v is averaged over
    all L slots, as in the JAX kernel (the split cases above hold both)."""
    q, ck, cv = _inputs(1, 4, 1, 128, 48, seed=3)
    sp = np.full(48, -1, np.int32)
    got = ops.decode_attention(*(torch.from_numpy(a) for a in (q, ck, cv, sp)), 5).numpy()
    assert np.allclose(got, np.broadcast_to(cv.mean(axis=1), got.shape), atol=TOL)


@pytest.mark.parametrize("B,K,G,L,hd", [
    (4, 4, 7, 544, 128),            # qwen2-7b decode
    (4, 1, 10, 544, 256),           # recurrentgemma-2b decode
    (1, 1, 16, 5, 256), (2, 8, 4, 4096, 128), (64, 8, 4, 4096, 128), (3, 1, 7, 100, 128),
    (1, 32, 1, 300, 128), (4, 1, 10, 2048, 256),
    (8, 1, 10, 544, 256),           # recurrentgemma-2b at --max-batch 8
    (16, 1, 9, 544, 256), (1, 1, 8, 544, 128),
])
def test_split_plan_fills_the_card_and_covers_every_slot_once(B, K, G, L, hd):
    plan = ops.split_plan(B, K, G, L, hd)
    assert 1 <= plan.splits <= ops.MAX_SPLITS and plan.splits & (plan.splits - 1) == 0
    assert plan.blocks(B, K) >= 64
    covered = []                                  # the kernel's slot ranges
    for r in range(plan.splits):
        lo, hi = min(L, r * plan.slots), min(L, (r + 1) * plan.slots)
        covered += range(lo, hi)
    assert covered == list(range(L))
    gc = -(-G // plan.head_blocks)                # the kernel's heads per block
    heads = [hb * gc + g for hb in range(plan.head_blocks) for g in range(gc)
             if hb * gc + g < G]
    assert heads == list(range(G)) and (plan.head_blocks - 1) * gc < G
    assert gc <= ops.MAX_BLOCK_HEADS


def test_split_plan_at_the_serving_shapes():
    assert ops.split_plan(4, 4, 7, 544, 128) == ops.SplitPlan(1, 8, 68)
    assert ops.split_plan(4, 4, 7, 544, 128).blocks(4, 4) == 128
    rg = ops.split_plan(4, 1, 10, 544, 256)       # two head blocks x 8 splits
    assert rg == ops.SplitPlan(2, 8, 68) and rg.blocks(4, 1) == 64
    with pytest.raises(ValueError):
        ops.split_plan(1, 1, 17, 64, 128)
    with pytest.raises(ValueError):
        ops.split_plan(1, 1, 4, 64, 96)
    # the launcher's defaults: reduced qwen2-7b (4 heads over 2) and
    # recurrentgemma-2b (4 over 1, window 16), batch 8, 16 slots, head_dim 16
    assert ops.split_plan(8, 2, 2, 16, 16) == ops.SplitPlan(1, 8, 2)
    assert ops.split_plan(8, 1, 4, 16, 16) == ops.SplitPlan(1, 8, 2)


def test_split_limits_name_the_kernel_source():
    from pathlib import Path
    source = (Path(ops.__file__).parent / "csrc" / "decode_attention.cu").read_text()
    assert f"constexpr int MAX_SPLITS = {ops.MAX_SPLITS};" in source
    assert f"constexpr int MAX_HEADS = {ops.MAX_BLOCK_HEADS};" in source
    assert "cudaLaunchAttributeClusterDimension" in source
    assert "NonPortableClusterSize" not in source      # clusters of at most 8
    assert "st.shared::cluster" in source             # partials pushed to their owners


def test_phase_build_names_the_kernel_phases():
    """The diagnostic build's phase names follow the kernel's ``enum Phase``,
    and the phase clocks exist only under its define."""
    import re
    from pathlib import Path
    from repro_torch.kernels.decode_attention import phases
    source = (Path(ops.__file__).parent / "csrc" / "decode_attention.cu").read_text()
    enum = re.search(r"enum Phase \{([^}]*)\}", source).group(1)
    names = [n.strip().lower() for n in enum.split(",")]
    assert names == [*phases.PHASES, "n_phases"]
    assert source.count("#ifdef REPRO_DECODE_PHASES") == 2
    assert set(phases.SHAPES) == {"qwen2-7b", "recurrentgemma-2b"}
    for B, H, K, L, hd, _ in phases.SHAPES.values():
        assert ops.split_plan(B, K, H // K, L, hd).blocks(B, K) >= 64
