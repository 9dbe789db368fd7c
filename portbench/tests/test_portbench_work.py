"""The frozen work formulas, the kernel files' calls and the model FLOPs
against counts worked by hand at small shapes."""
import pytest

from portbench.core import peaks, registry, work
from portbench.core.run import Call


def test_work_formulas_by_hand():
    assert work.visible_pairs(4) == 10 and work.visible_pairs(6, 2) == 3 + 4 * 2
    # flash forward, B1 S2 H1 K1 hd2: 4 * hd * 3 pairs; q,k,v,o of 2x2 bf16 = 4 * 4 * 2 bytes
    assert work.flash_forward(1, 2, 1, 1, 2) == (24, 32)
    assert work.flash_forward(1, 2, 1, 1, 2, lse=True) == (24, 32 + 8)
    assert work.flash_backward(1, 2, 1, 1, 2) == (60, 2 * (3 * 4 + 2 * 4) + 8 + 2 * (4 + 8))
    # mLSTM, one chunk of 2, dqk 1, dv 1: pairs 3 -> 2*3*3 + 4*2 + 4*2 = 34
    assert work.mlstm(1, 2, 1, 1, 1, 2)[0] == 34
    assert work.mlstm(1, 2, 1, 1, 1, 2)[1] == 2 * 2 * 4 + 4 * 2 * 2 + 4 * 3
    # sLSTM, B1 S1 H1 dh1: 4 + 2 + 17 operations
    assert work.slstm(1, 1, 1, 1)[0] == 23
    assert work.chunk_size(2048, 256) == 256 and work.chunk_size(2053, 256) == 1
    assert peaks.bound_s(989e12, 0, "bf16") == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12, "fp32") == pytest.approx(1.0)


def test_kernel_files_count_their_calls():
    k = registry.kernels()
    model = registry.cell(registry.benchmark(), "xlstm-train-2k").model
    step = Call("train", 4, 2048, remat=True)
    assert len(k["mlstm_fwd"].calls(model, step)) == 42 * 2
    assert len(k["mlstm_bwd"].calls(model, step)) == 42
    assert len(k["slstm_fwd"].calls(model, step)) == 6 * 2
    assert len(k["slstm_bwd"].calls(model, step)) == 6
    assert k["flash_fwd"].calls(model, step) == []
    assert len(k["slstm_fwd"].calls(model, Call("decode", 4, 600))) == 6
    assert k["mlstm_fwd"].calls(model, Call("decode", 4, 600)) == []
    # PERF.md's sLSTM bound at [4, 512, 4, 512]: 0.1293 ms
    f, b = k["slstm_fwd"].calls(model, Call("prefill", 4, 512))[0]
    assert peaks.bound_s(f, b, "fp32") * 1e3 == pytest.approx(0.1293, abs=5e-4)
    mg = registry.cell(registry.benchmark(), "musicgen-train-30s").model
    assert len(k["flash_fwd"].calls(mg, Call("train", 5, 1500, remat=True))) == 96
    assert len(k["flash_bwd"].calls(mg, Call("train", 5, 1500, remat=True))) == 48


def test_model_flops_by_hand():
    from portbench.reference import transformer, xlstm
    cfg = dict(registry.cell(registry.benchmark(), "musicgen-train-30s").model,
               num_layers=1, d_model=4, num_heads=2, num_kv_heads=2, head_dim=2, d_ff=8,
               vocab_size=3, num_codebooks=2)
    n = 4 * 4 * 4 + 3 * 4 * 8 + 4 * 6          # q k v o, the MLP, the head
    assert transformer.matmul_weights(cfg) == n
    assert transformer.model_flops(cfg, "prefill", 1, 3) == 2 * n * 3 + 4 * 2 * 2 * 6
    assert transformer.model_flops(cfg, "train", 1, 3) == 3 * (2 * n * 3 + 4 * 2 * 2 * 6)
    assert transformer.model_flops(cfg, "decode", 2, 5) == 2 * n * 2 + 4 * 2 * 2 * 2 * 5
    full = registry.cell(registry.benchmark(), "xlstm-train-2k").model
    n = xlstm.matmul_weights(full)
    assert n == 2_867_888_464 - 50304 * 2048 - sum(
        p for p in (48 * 2 * 2048, 42 * (4 * 4096 + 4096 + 4 * 1024 + 8), 6 * (4 * 512 + 4 * 2048),
                    2 * 2048))
    per_token = xlstm.model_flops(full, "prefill", 1, 2048) / 2048
    assert 2 * n < per_token < 2 * n * 1.2
