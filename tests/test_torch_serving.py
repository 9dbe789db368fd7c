"""Port parity: the port's ServingPool vs the JAX ServingPool on the same
reduced weights and prompts (float32, CPU): the greedy tokens must be
identical. Also the port's serve CLI on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.runtime.serving_pool import ServingPool as JaxPool  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime.serving_pool import ServingPool as TorchPool  # noqa: E402
from repro_torch.serving.batching import ContinuousBatcher, Request  # noqa: E402

from test_torch_model import configs, jax_params  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-7b", "xlstm-1.3b",
                                  "recurrentgemma-2b"])
def test_serving_pool_tokens_match_jax(arch):
    jcfg, tcfg = configs(arch)
    params = jax_params(jcfg, seed=7)
    jpool = JaxPool(jcfg, params)
    jpool.scale_to(jax.devices()[:1])
    tpool = TorchPool(tcfg, params_from_jax(params, tcfg, device="cpu"))
    tpool.scale_to(["cpu"])
    rng = np.random.default_rng(11)
    for B, S, max_new in ((2, 9, 5), (3, 6, 3)):
        prompt = rng.integers(0, jcfg.vocab_size, (B, S), dtype=np.int32)
        want = jpool.submit(prompt, max_new)
        got = tpool.submit(prompt, max_new)
        assert got.shape == (B, max_new)
        np.testing.assert_array_equal(got, np.asarray(want))
    assert all(r.outstanding == 0 for r in tpool.replicas)


def test_batcher_round_through_port_pool_matches_jax():
    """Mixed prompt lengths: the copied batcher left-pads with token 0."""
    jcfg, tcfg = configs("qwen2-7b")
    params = jax_params(jcfg, seed=8)
    jpool = JaxPool(jcfg, params)
    jpool.scale_to(jax.devices()[:1])
    tpool = TorchPool(tcfg, params_from_jax(params, tcfg, device="cpu"))
    tpool.scale_to(["cpu"])
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 256, n, dtype=np.int32) for n in (5, 9, 7)]
    done = []
    for pool in (jpool, tpool):
        b = ContinuousBatcher(max_batch=4)
        for i, p in enumerate(prompts):
            b.submit(Request(i, p, 4))
        b.run_round(b.next_round(), pool.submit)
        done.append([r.done for r in b.completed])
    for want, got in zip(*done):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_serve_cli_serves_xlstm_on_cpu():
    report = serve.run(["--device", "cpu", "--arch", "xlstm-1.3b", "--requests", "3",
                        "--max-batch", "2", "--prompt-len", "5", "--max-new", "4"])
    assert report["cfg"].block_pattern[-1] == "slstm" and report["rounds"] == 2
    assert all(len(r.done) == 4 and (0 <= r.done).all()
               and (r.done < report["cfg"].vocab_size).all()
               for r in report["completed"])


def test_serve_cli_serves_recurrentgemma_on_cpu():
    report = serve.run(["--device", "cpu", "--arch", "recurrentgemma-2b",
                        "--requests", "3", "--max-batch", "2", "--prompt-len", "20",
                        "--max-new", "4"])
    cfg = report["cfg"]
    assert cfg.tie_embeddings and 20 > cfg.window_size and report["rounds"] == 2
    assert report["pool"].model.head is None
    assert all(len(r.done) == 4 and (0 <= r.done).all() and (r.done < cfg.vocab_size).all()
               for r in report["completed"])


def test_serve_cli_on_cpu(capsys):
    argv = ["--device", "cpu", "--requests", "5", "--max-batch", "2",
            "--prompt-len", "6", "--max-new", "3"]
    assert serve.main(argv) == 0
    assert "served 5 requests / 15 tokens" in capsys.readouterr().out
    report = serve.run(argv)
    assert report["rounds"] == 3
    assert all(len(r.done) == 3 and (0 <= r.done).all()
               and (r.done < report["cfg"].vocab_size).all()
               for r in report["completed"])


def test_batching_copy_matches_jax_package():
    """The port's copy of repro.serving.batching schedules and prices alike."""
    from repro.serving import batching as JB
    from repro_torch.serving import batching as TB
    rng = np.random.default_rng(13)
    lens = rng.integers(1, 200, 12)
    news = rng.integers(1, 130, 12)
    jb, tb = JB.ContinuousBatcher(max_batch=3), TB.ContinuousBatcher(max_batch=3)
    for i, (n, m) in enumerate(zip(lens, news)):
        jb.submit(JB.Request(i, np.zeros(n, np.int32), int(m)))
        tb.submit(TB.Request(i, np.zeros(n, np.int32), int(m)))
    jm, tm = JB.ServiceTimeModel(), TB.ServiceTimeModel()
    while jb.queue:
        jr, tr = jb.next_round(), tb.next_round()
        assert [r.req_id for r in jr] == [r.req_id for r in tr]
        assert jb.estimate_round_time(jr, jm) == tb.estimate_round_time(tr, tm)
    assert not tb.queue
    np.testing.assert_array_equal(jm.service_times(lens, news, 2),
                                  tm.service_times(lens, news, 2))
    assert jm.replica_throughput_rps(64, 32) == tm.replica_throughput_rps(64, 32)


def test_desired_replicas_follows_80_percent_rule():
    _, tcfg = configs("qwen2-7b")
    pool = TorchPool(tcfg, None, capacity_tokens_per_replica=100.0)
    assert pool.desired_replicas(81.0) == 2
    assert pool.desired_replicas(80.0) == 1
