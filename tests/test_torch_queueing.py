"""The port's request-queue simulator against the JAX package's, on the CPU.

The exact numpy paths are copies, so they must agree bit for bit. The
batched core -- here the plain PyTorch version of the ``queue_core`` kernel
-- is held to the JAX batched core on the same jobs (equal counts;
percentiles and max within 1e-6 relative, the two means within 1e-5: both
are float32, only the sums' order differs) and to the float64 oracle under
the golden tolerance of ``tests/test_queueing_equivalence.py``. The inputs
are carried across by seed: both packages draw the same numpy traces.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.types import SLOConfig as JaxSLO  # noqa: E402
from repro.serving.batching import ServiceTimeModel as JaxModel  # noqa: E402
from repro.workloads import arrivals as jax_arrivals  # noqa: E402
from repro.workloads import queueing as jq  # noqa: E402
from repro_torch.core.types import SLOConfig  # noqa: E402
from repro_torch.serving.batching import ServiceTimeModel  # noqa: E402
from repro_torch.workloads import arrivals, queueing as tq  # noqa: E402
from test_queueing_equivalence import assert_golden, random_capacity  # noqa: E402

MODEL, SLO = ServiceTimeModel(), SLOConfig(latency_target_s=30.0)
JAX_MODEL, JAX_SLO = JaxModel(), JaxSLO(latency_target_s=30.0)
KINDS = ("poisson", "mmpp", "diurnal", "flash_crowd")


def _traces(kind, rate, horizon, seed, n=None):
    """The same trace from both packages (asserted equal), cut to n requests."""
    pt = arrivals.make_trace(kind, rate, horizon, seed)
    jt = jax_arrivals.make_trace(kind, rate, horizon, seed)
    for f in ("t", "prompt_tokens", "decode_tokens"):
        assert np.array_equal(getattr(pt, f), getattr(jt, f))
    if n is not None:
        pt = arrivals.RequestTrace(pt.t[:n], pt.prompt_tokens[:n], pt.decode_tokens[:n], kind)
        jt = jax_arrivals.RequestTrace(jt.t[:n], jt.prompt_tokens[:n], jt.decode_tokens[:n],
                                       kind)
    return pt, jt


def _jobs(specs):
    """(kind, rate, horizon, seed, n, events, job horizon) -> the port's and
    the JAX package's QueueJobs on the same traces."""
    port, ref = [], []
    for kind, rate, horizon, seed, n, ev, hz in specs:
        pt, jt = _traces(kind, rate, horizon, seed, n)
        port.append(tq.QueueJob(pt, ev, MODEL, SLO, hz))
        ref.append(jq.QueueJob(jt, ev, JAX_MODEL, JAX_SLO, hz))
    return port, ref


def _random_specs(seed, n_jobs=6, horizon=900.0):
    """Piecewise jobs as ``_pw_jobs`` of the JAX tests draws them, every
    third one constant instead (a flash crowd at a tenth of the rate: its
    spikes multiply the requests)."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n_jobs):
        rate = float(rng.uniform(0.4, 3.0)) * (0.1 if KINDS[i % 4] == "flash_crowd" else 1.0)
        if i % 3 == 2:
            ev = [(0.0, int(rng.integers(0, 8)))]
        else:
            ev = random_capacity(rng, horizon)
            if len(ev) == 1:
                ev.append((horizon / 2, int(rng.integers(0, 10))))
        specs.append((KINDS[i % 4], rate, horizon, seed + i, None, ev, horizon))
    return specs


STEPS12 = [(50.0 * i, (i * 5) % 13) for i in range(12)]          # e_pad 16, k_pad 48
WIDE = [(0.0, 120), (900.0, 6), (1800.0, 0), (2100.0, 90), (3600.0, 2), (4500.0, 72),
        (6000.0, 0), (6300.0, 100)]                                # k_pad 480, closed past 6200
EDGES = {
    "capacity 0 throughout": ("poisson", 1.0, 600.0, 0, None, [(0.0, 0)], 600.0),
    "k = 0 intervals": ("poisson", 1.0, 600.0, 0, None,
                        [(0.0, 0), (300.0, 1), (450.0, 0), (500.0, 2)], 550.0),
    "outage window": ("poisson", 1.0, 600.0, 0, None,
                      [(0.0, 2), (200.0, 0), (400.0, 2)], 600.0),
    "drop mid-queue": ("poisson", 1.0, 600.0, 0, None, [(0.0, 5), (100.0, 1)], 600.0),
    "cutoff at the edge": ("poisson", 1.0, 600.0, 0, None, [(0.0, 1), (590.0, 8)], 595.0),
    "horizon half the trace": ("mmpp", 1.5, 600.0, 3, None, [(0.0, 1), (200.0, 3)], 300.0),
    "horizon None": ("mmpp", 1.5, 600.0, 3, None, [(0.0, 1), (200.0, 3)], None),
    "constant, horizon half the trace": ("poisson", 2.0, 600.0, 4, None, [(0.0, 1)], 300.0),
    "constant 0": ("poisson", 1.0, 600.0, 0, None, [(0.0, 0)], 600.0),
    "constant, horizon None": ("diurnal", 2.0, 600.0, 5, None, [(0.0, 2)], None),
    "one request": ("poisson", 1.0, 600.0, 1, 1, [(0.0, 1), (5.0, 2)], 600.0),
    "one request, constant": ("poisson", 1.0, 600.0, 1, 1, [(0.0, 1)], 600.0),
    "n 256": ("mmpp", 2.0, 1800.0, 256, 256, [(0.0, 1), (600.0, 2), (900.0, 0)], 1800.0),
    "n 257": ("mmpp", 2.0, 1800.0, 257, 257, [(0.0, 1), (600.0, 2), (900.0, 0)], 1800.0),
    "n 384": ("mmpp", 2.0, 1800.0, 384, 384, [(0.0, 1), (600.0, 2), (900.0, 0)], 1800.0),
    "n 257, constant": ("mmpp", 2.0, 1800.0, 257, 257, [(0.0, 2)], 1800.0),
    "e_pad 16, k_pad 48": ("poisson", 1.0, 600.0, 6, None, STEPS12, 600.0),
    "k_pad 48": ("poisson", 3.0, 600.0, 7, None, [(0.0, 12), (300.0, 2)], 600.0),
    "constant k 200": ("poisson", 3.0, 600.0, 7, None, [(0.0, 50)], None),
    "over 64 slots, over 8192 requests": ("mmpp", 2.2, 7200.0, 900, None, WIDE, 6200.0),
}


def _close(a, b, rtol):
    return (np.isinf(a) and np.isinf(b) and a == b) or np.isclose(a, b, rtol=rtol, atol=0)


def assert_matches_jax_batched(m, ref, ctx=""):
    """The plain batched core vs the JAX batched core on the same job."""
    assert (m.n_requests, m.n_served, m.unserved) == (ref.n_requests, ref.n_served,
                                                      ref.unserved), ctx
    assert m.violation_rate == ref.violation_rate and m.slo_met == ref.slo_met, ctx
    for f, rtol in (("p50_s", 1e-6), ("p95_s", 1e-6), ("p99_s", 1e-6), ("max_s", 1e-6),
                    ("mean_s", 1e-5), ("mean_wait_s", 1e-5)):
        assert _close(getattr(m, f), getattr(ref, f), rtol), (ctx, f, getattr(m, f),
                                                             getattr(ref, f))


def _oracle(job):
    return tq.simulate_queue_reference(job.trace, job.capacity_events, job.model, job.slo,
                                       horizon=job.horizon)


# ------------------------------------------------------------- exact paths


@pytest.mark.parametrize("seed", range(6))
def test_exact_paths_match_jax_package_on_random_piecewise(seed):
    rng = np.random.default_rng(seed)
    kind = KINDS[seed % len(KINDS)]
    pt, jt = _traces(kind, float(rng.uniform(0.3, 4.0)), 3600.0, seed)
    for _ in range(4):
        ev = random_capacity(rng, 3600.0)
        for hz in (3600.0, 1800.0, None):
            for impl in ("auto", "event", "reference"):
                got = tq.simulate_queue(pt, ev, MODEL, SLO, horizon=hz, impl=impl)
                want = jq.simulate_queue(jt, ev, JAX_MODEL, JAX_SLO, horizon=hz, impl=impl)
                assert got.as_dict() == want.as_dict(), (impl, ev[:3], hz)


@pytest.mark.parametrize("seed", range(4))
def test_exact_paths_match_jax_package_on_constant_capacity(seed):
    rng = np.random.default_rng(100 + seed)
    pt, jt = _traces(KINDS[seed % len(KINDS)], float(rng.uniform(0.5, 3.0)), 3600.0, seed)
    for nodes in (0, 1, int(rng.integers(2, 8)), 500):
        ev = [(0.0, nodes)]
        for impl in ("auto", "reference") + (("fast",) if nodes else ()):
            before = tq.snapshot_counters()
            got = tq.simulate_queue(pt, ev, MODEL, SLO, horizon=3600.0, impl=impl)
            used = {k for k, v in tq.counters_delta(before).items()
                    if v and k not in ("calls", "requests", "seconds")}
            before = jq.snapshot_counters()
            want = jq.simulate_queue(jt, ev, JAX_MODEL, JAX_SLO, horizon=3600.0, impl=impl)
            want_used = {k for k, v in jq.counters_delta(before).items()
                         if v and k not in ("calls", "requests", "seconds")}
            assert got.as_dict() == want.as_dict() and used == want_used, (impl, nodes)


def test_analytic_helpers_and_capacity_steps_match():
    assert tq.sakasegawa_wait(1.5, 5.0, 0.4, 12) == jq.sakasegawa_wait(1.5, 5.0, 0.4, 12)
    assert tq.predicted_percentile_latency(1.5, 5.0, 0.4, 20.0, 12) == \
        jq.predicted_percentile_latency(1.5, 5.0, 0.4, 20.0, 12)
    ev = [(5.0, 2), (0.0, 1), (5.0, 3), (9.0, 0)]
    for a, b in zip(tq.capacity_steps(ev, 4), jq.capacity_steps(ev, 4)):
        assert np.array_equal(a, b) and a.dtype == b.dtype


# ---------------------------------------------------- batched (plain core)


@pytest.mark.parametrize("seed", range(3))
def test_plain_batched_core_matches_jax_batched_core(seed):
    port, ref = _jobs(_random_specs(seed))
    tags = []
    got = tq.simulate_queue_batch(port, stats_out=tags, device="cpu")
    want = jq.simulate_queue_batch(ref)
    assert tags == ["torch_batched"] * len(port)
    assert {k[0] for k in tq.plan_queue_buckets(port)} == {"const", "pw"}
    assert tq.plan_queue_buckets(port) == jq.plan_queue_buckets(ref)
    for job, m, r in zip(port, got, want):
        assert_matches_jax_batched(m, r, job.capacity_events[:3])


@pytest.mark.parametrize("seed", range(3))
def test_plain_batched_core_matches_float64_oracle(seed):
    port, _ = _jobs(_random_specs(10 + seed))
    for job, m in zip(port, tq.simulate_queue_batch(port, device="cpu")):
        assert_golden(m, _oracle(job), job.capacity_events[:3])


@pytest.mark.parametrize("case", sorted(EDGES))
def test_plain_batched_core_edges(case):
    port, ref = _jobs([EDGES[case]])
    (m,) = tq.simulate_queue_batch(port, device="cpu")
    (r,) = jq.simulate_queue_batch(ref)
    assert_matches_jax_batched(m, r, case)
    assert_golden(m, _oracle(port[0]), case)
    if case in ("capacity 0 throughout", "constant 0"):
        assert m.unserved == m.n_requests and m.violation_rate == 1.0 and not m.slo_met


def test_edge_cases_reach_the_shapes_they_name():
    """The edges' buckets: n at both sides of 256 and at 384, more than 8
    intervals, more than 32 slots; more than 64 slots and 8192 requests."""
    from repro_torch.workloads.queueing import _plan, bucket_inputs
    port, _ = _jobs([EDGES[c] for c in ("n 256", "n 257", "n 384", "e_pad 16, k_pad 48")])
    buckets, caps = _plan(port)
    assert sorted(buckets) == [("pw", 256), ("pw", 384), ("pw", 768)]
    assert buckets[("pw", 384)] == [1, 2]
    kind, t, *_, cap_t, cap_k, hi_t, k_pad = bucket_inputs(port, ("pw", 768), [3], caps)
    assert cap_t.shape == (1, 16) and k_pad == 48 and t.dtype == np.float32
    wide, _ = _jobs([EDGES["over 64 slots, over 8192 requests"]])
    buckets, caps = _plan(wide)
    ((key, rows),) = buckets.items()
    assert key[0] == "pw" and key[1] > 8192 and bucket_inputs(wide, key, rows, caps)[-1] > 64


def test_empty_trace_is_handled_on_the_host():
    pt, jt = _traces("poisson", 1.0, 600.0, 0)
    empty = arrivals.RequestTrace(pt.t[:0], pt.prompt_tokens[:0], pt.decode_tokens[:0])
    jobs = [tq.QueueJob(empty, [(0.0, 4)], MODEL, SLO), tq.QueueJob(pt, [(0.0, 4)], MODEL, SLO)]
    tags = []
    got = tq.simulate_queue_batch(jobs, stats_out=tags, device="cpu")
    assert tags == ["numpy", "torch_batched"] and tq.plan_queue_buckets(jobs) == {
        ("const", 768): [1]}
    assert got[0].n_requests == 0 and got[0].slo_met
    jempty = jax_arrivals.RequestTrace(jt.t[:0], jt.prompt_tokens[:0], jt.decode_tokens[:0])
    assert got[0].as_dict() == jq.simulate_queue_batch(
        [jq.QueueJob(jempty, [(0.0, 4)], JAX_MODEL, JAX_SLO)])[0].as_dict()


def test_plain_batched_core_is_composition_independent():
    """A job's metrics are the same bits alone and co-batched (its bucket's
    k_pad and e_pad then differ)."""
    port, _ = _jobs(_random_specs(42, n_jobs=6) + [EDGES["k_pad 48"], EDGES["one request"]])
    grouped = tq.simulate_queue_batch(port, device="cpu")
    for job, m in zip(port, grouped):
        assert tq.simulate_queue_batch([job], device="cpu")[0] == m


def test_numpy_backend_is_exact_and_counted():
    port, _ = _jobs(_random_specs(7, n_jobs=3))
    before = tq.snapshot_counters()
    tags = []
    got = tq.simulate_queue_many([j.trace for j in port], [j.capacity_events for j in port],
                                 MODEL, SLO, horizon=900.0, backend="numpy")
    tq.simulate_queue_batch(port, stats_out=tags, device="cpu")
    d = tq.counters_delta(before)
    assert all(m == _oracle(j) for j, m in zip(port, got))
    assert tags == ["torch_batched"] * 3 and d["torch_batched"] == 3
    assert d["calls"] == 6 and d["requests"] == 2 * sum(len(j.trace) for j in port)


def test_batched_core_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    port, _ = _jobs([EDGES["one request"]])
    with pytest.raises(RuntimeError):
        tq.simulate_queue_batch(port)
    with pytest.raises(RuntimeError):
        tq.simulate_queue_batch(port, device="cuda")
    with pytest.raises(ValueError):
        tq.simulate_queue_batch(port, backend="jax", device="cpu")
    with pytest.raises(ValueError):
        tq.simulate_queue_batch(port, backend="torch", device="cpu")
    assert tq.simulate_queue_batch(port, backend="numpy")[0] == _oracle(port[0])


def test_plain_core_wrapper_dispatches_on_the_device_and_checks_shapes():
    from repro_torch.kernels.queue_core import ops, queue_core_reference
    port, _ = _jobs([EDGES["drop mid-queue"], EDGES["k = 0 intervals"]])
    buckets, caps = tq._plan(port)
    kind, *arrays, k_pad = tq.bucket_inputs(port, ("pw", 768), [0, 1], caps)
    tensors = [torch.from_numpy(a) for a in arrays]
    before = ops.queue_flush.launches
    out = ops.queue_core(kind, *tensors, k_pad)
    assert ops.queue_flush.launches == before                 # no kernel on the CPU
    assert torch.equal(out, queue_core_reference(kind, *tensors, k_pad))
    assert out.shape == (2, 8) and out.dtype == torch.float32
    with pytest.raises(ValueError):
        ops.queue_core("nope", *tensors, k_pad)
    with pytest.raises(ValueError):
        ops.queue_core(kind, tensors[0][:, :5], *tensors[1:], k_pad)
    with pytest.raises(ValueError):
        ops.queue_core(kind, *tensors[:5], tensors[5][:, :1], *tensors[6:], k_pad)
    wide = tensors[6].clone()
    wide[0, 0] = k_pad + 1                                     # a job with more slots than k_pad
    with pytest.raises(ValueError, match="k_pad"):
        ops.queue_core(kind, *tensors[:6], wide, tensors[7], k_pad)
