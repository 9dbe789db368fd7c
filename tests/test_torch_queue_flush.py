"""The queue core's flat flush (one launch a flush) on the CPU.

``queue_flush_reference`` -- the plain version of ``queue_flush``, which
takes every job of a flush as ragged flat tables -- is held job by job, bit
for bit, to the bucket form's plain version on each job alone, and through
``simulate_queue_batch`` to the JAX package's ``_kw_batched_core`` /
``_pw_batched_core`` at ``tests/test_torch_queueing.py``'s tolerance, on
mixed sets: constant and piecewise jobs, ragged n, 1 to 40 capacity
intervals, 0 to 600 slots, closed intervals, a horizon inside the trace and
the heap drain. The kernel's interval-cursor rule (``ref.window_start``,
``ref.advance_cursor``) is held to the ``amin`` over all intervals, bit for
bit, on random ascending capacity tables (seeded, and by hypothesis where it
is installed), and on ``chip_smoke.py``'s jobs of 33 to 100 intervals, where
the rule run on each job's own slot vector gives the plain version's starts
and is shown to move the cursor and search past the window. The host rejects
interval starts that descend or begin below 0.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
    HAS_HYPOTHESIS = True
except ImportError:
    HAS_HYPOTHESIS = False

from repro.workloads import queueing as jq  # noqa: E402
from repro_torch.kernels.queue_core import ops  # noqa: E402
from repro_torch.kernels.queue_core.ref import (advance_cursor,  # noqa: E402
                                                queue_core_reference,
                                                queue_flush_reference, window_start)
from repro_torch.workloads import queueing as tq  # noqa: E402
from test_queueing_equivalence import assert_golden  # noqa: E402
from test_torch_queueing import (JAX_MODEL, JAX_SLO, KINDS, _jobs,  # noqa: E402
                                 assert_matches_jax_batched)

F32_INF = np.float32(np.inf)


def _mixed_specs(seed, horizon=600.0):
    """Eight jobs: piecewise ones with 1 to 40 intervals and levels of 0 to
    150 nodes (4 slots each: up to 600), constant ones at 0 to 150 nodes,
    traces cut to ragged lengths, job horizons at the trace's end, inside it
    and None; plus a schedule that closes before its horizon (the heap
    drain) and one at 150 nodes (600 slots)."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(6):
        kind = KINDS[i % 4]
        rate = float(rng.uniform(0.5, 3.0)) * (0.1 if kind == "flash_crowd" else 1.0)
        n = None if i % 2 else int(rng.integers(1, 400))
        hz = (horizon, horizon / 2, None)[i % 3]
        if i % 3 == 2:
            ev = [(0.0, int(rng.integers(0, 151)))]
        else:
            ev = [(0.0, int(rng.integers(0, 151)))]
            ev += [(float(rng.uniform(0.0, horizon)), int(rng.integers(0, 151)))
                   for _ in range(39 if i == 0 else int(rng.integers(0, 40)))]
        specs.append((kind, rate, horizon, 10 * seed + i, n, ev, hz))
    specs.append(("poisson", 2.0, horizon, 10 * seed + 7, None,
                  [(0.0, 3), (150.0, 1), (300.0, 0)], 450.0))              # the drain
    specs.append(("mmpp", 2.0, horizon, 10 * seed + 8, 300,
                  [(0.0, 150), (200.0, 2), (400.0, 150)], horizon))        # 600 slots
    return specs


def _flat(port):
    caps = tq._job_caps(port)
    rows = [i for i, c in enumerate(caps) if c is not None]
    buf, spans, k_max = tq.flush_inputs(port, rows, caps)
    return caps, rows, tq.flush_tensors(buf, spans), k_max


@pytest.mark.parametrize("seed", range(3))
def test_flush_reference_equals_the_bucket_form_job_by_job(seed):
    port, _ = _jobs(_mixed_specs(seed))
    caps, rows, args, k_max = _flat(port)
    kinds = args[0].tolist()
    assert set(kinds) == {0, 1} and k_max == 600
    assert max(len(caps[i][0]) for i in rows) == 40
    got = queue_flush_reference(*args)
    assert got.shape == (len(rows), 8) and got.dtype == torch.float32
    for r, i in enumerate(rows):
        key = ("pw" if kinds[r] else "const", len(port[i].trace))
        kind, *arrays, k_pad = tq.bucket_inputs(port, key, [i], caps)
        want = queue_core_reference(kind, *(torch.from_numpy(a) for a in arrays), k_pad)
        assert torch.equal(got[r], want[0]), (i, got[r], want[0])


@pytest.mark.parametrize("seed", range(3))
def test_flush_matches_jax_batched_core_and_oracle_on_mixed_sets(seed):
    port, ref = _jobs(_mixed_specs(seed))
    tags = []
    got = tq.simulate_queue_batch(port, stats_out=tags, device="cpu")
    want = jq.simulate_queue_batch(ref)
    assert tags == ["torch_batched"] * len(port)
    for job, m, r in zip(port, got, want):
        assert_matches_jax_batched(m, r, job.capacity_events[:3])
        assert_golden(m, tq.simulate_queue_reference(job.trace, job.capacity_events,
                                                     job.model, job.slo,
                                                     horizon=job.horizon),
                      job.capacity_events[:3])
    drained = got[-2]
    assert drained.unserved > 0 and drained.n_served > 0


def test_flush_reference_takes_n_valid_within_padded_rows():
    """The bucket form's packing (rows of n_pad, n_valid each) gives the
    rows of the bucket-form plain version."""
    port, _ = _jobs(_mixed_specs(5)[:4])
    buckets, caps = tq._plan(port)
    for key, rows in sorted(buckets.items()):
        kind, t, s, nv, hz, st_, ct, ck, hi, k_pad = (
            torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in tq.bucket_inputs(port, key, rows, caps))
        B, n_pad = t.shape
        E = ct.shape[1]
        idx = torch.arange(B + 1, dtype=torch.int32)
        got = queue_flush_reference(torch.full((B,), ("const", "pw").index(kind)),
                                    t.reshape(-1), s.reshape(-1), idx * n_pad,
                                    ct.reshape(-1), ck.reshape(-1), hi.reshape(-1), idx * E,
                                    hz, st_, n_valid=nv)
        want = queue_core_reference(kind, t, s, nv, hz, st_, ct, ck, hi, k_pad)
        assert torch.equal(got[:, [0, 1, 2, 3, 5, 7]], want[:, [0, 1, 2, 3, 5, 7]]), key
        assert torch.allclose(got[:, [4, 6]], want[:, [4, 6]], rtol=1e-6, atol=0), key


def test_flush_inputs_lay_out_one_buffer():
    port, _ = _jobs(_mixed_specs(1))
    caps, rows, args, k_max = _flat(port)
    buf, spans, _ = tq.flush_inputs(port, rows, caps)
    assert buf.dtype == torch.int32 and buf.dim() == 1
    assert [name for name, _ in tq.FLUSH_FIELDS] == list(spans)
    at = 0
    for a, n in spans.values():
        assert a == at
        at += n
    assert at == buf.numel()
    kind, t, s, req_off, cap_t, cap_k, hi_t, cap_off, horizon, slo = args
    assert t.dtype == torch.float32 and cap_k.dtype == torch.int32
    assert req_off.tolist() == [0, *np.cumsum([len(port[i].trace) for i in rows])]
    for r, i in enumerate(rows):
        ct, ck = caps[i]
        a, b = cap_off[r].item(), cap_off[r + 1].item()
        assert np.array_equal(cap_t[a:b].numpy(), ct.astype(np.float32))
        assert np.array_equal(cap_k[a:b].numpy(), ck)
        assert hi_t[b - 1].item() == np.inf and np.array_equal(hi_t[a:b - 1].numpy(),
                                                               ct[1:].astype(np.float32))
        assert kind[r].item() == int(len(ct) > 1)
        a, b = req_off[r].item(), req_off[r + 1].item()
        assert np.array_equal(t[a:b].numpy(), port[i].trace.t.astype(np.float32))
    assert k_max == max(int(caps[i][1].max() if len(caps[i][0]) > 1 else caps[i][1][0])
                        for i in rows)


def test_host_rejects_interval_starts_that_descend_or_begin_below_0():
    port, _ = _jobs(_mixed_specs(2)[:2])
    caps = tq._job_caps(port)
    ct, ck = caps[0]
    assert len(ct) > 2
    bad = list(caps)
    bad[0] = (ct[[0, 2, 1, *range(3, len(ct))]], ck)
    with pytest.raises(ValueError, match="ascend from 0"):
        tq.flush_inputs(port, [0, 1], bad)
    bad[0] = (ct - 1.0, ck)
    with pytest.raises(ValueError, match="ascend from 0"):
        tq.flush_inputs(port, [0, 1], bad)
    _, _, args, k_max = _flat(port)
    cap_t = args[4].clone()
    cap_t[1], cap_t[2] = args[4][2], args[4][1]
    with pytest.raises(ValueError, match="ascend from 0"):
        ops.queue_flush(*args[:4], cap_t, *args[5:], k_max)
    with pytest.raises(ValueError, match="ascend from 0"):
        ops.queue_flush(*args[:4], args[4] - 1.0, *args[5:], k_max)


def test_flush_wrapper_dispatches_on_the_device_and_checks_inputs():
    port, _ = _jobs(_mixed_specs(3))
    _, _, args, k_max = _flat(port)
    before = ops.queue_flush.launches
    out = ops.queue_flush(*args, k_max)
    assert ops.queue_flush.launches == before                   # no kernel on the CPU
    assert torch.equal(out, queue_flush_reference(*args))
    kind, t, s, req_off, cap_t, cap_k, hi_t, cap_off, horizon, slo = args
    with pytest.raises(ValueError, match="k_max"):
        ops.queue_flush(*args, k_max - 1)
    with pytest.raises(ValueError):
        ops.queue_flush(*args, 0)
    with pytest.raises(ValueError):
        ops.queue_flush(kind, t, s[:-1], *args[3:], k_max)
    with pytest.raises(ValueError):
        ops.queue_flush(kind, t, s, req_off[:-1], *args[4:], k_max)
    with pytest.raises(ValueError):
        ops.queue_flush(kind, t, s, req_off, cap_t, cap_k[:-1], *args[6:], k_max)
    with pytest.raises(ValueError, match="kind"):
        ops.queue_flush(kind + 2, *args[1:], k_max)
    with pytest.raises(ValueError, match="out of range"):
        ops.queue_flush(kind, t, s, req_off + 1, *args[4:], k_max)
    empty = cap_off.clone()
    empty[1] = empty[0]
    with pytest.raises(ValueError, match="interval"):
        ops.queue_flush(*args[:7], empty, horizon, slo, k_max)


@pytest.mark.parametrize("k,regs", [(1, 1), (32, 1), (33, 2), (64, 2), (65, 4), (128, 4),
                                    (129, 8), (256, 8), (257, 16), (512, 16), (513, 0),
                                    (600, 0)])
def test_slot_register_tiers(k, regs):
    assert ops.slot_registers(k) == regs
    assert ops.INSTANCES[regs] in ops.queue_flush.instance_launches


# ------------------------------------------------------ interval cursor rule


def _check_cursor_rule(seed, E, width, steps=120):
    """Random ascending capacity tables (ties where starts are rounded),
    closed intervals, arrival times in and out of order and random slot
    thresholds: the windowed search with its cursor gives the ``amin`` of
    ``ref._pw_scan``'s candidates over all intervals, bit for bit."""
    rng = np.random.default_rng(seed)
    cap_t = np.sort(rng.uniform(0.0, 1000.0, E)).astype(np.float32)
    if seed % 2:
        cap_t = np.round(cap_t / 50.0).astype(np.float32) * np.float32(50.0)
    cap_t[0] = 0.0
    hi_t = np.append(cap_t[1:], F32_INF).astype(np.float32)
    closed = rng.random(E) < 0.3
    t = rng.uniform(0.0, 1100.0, steps).astype(np.float32)
    if seed % 3:
        t.sort()
    horizon = np.float32(1050.0)
    prev, wb = np.float32(0.0), 0
    for t_i in t:
        thresh = np.where(closed, F32_INF,
                          rng.uniform(0.0, 1200.0, E).astype(np.float32) *
                          (rng.random(E) < 0.8)).astype(np.float32)
        s0 = np.maximum(t_i, prev)
        got = window_start(s0, cap_t, thresh, hi_t, wb, width)
        lo = np.maximum(np.maximum(cap_t, thresh), s0)
        want = np.where(lo < hi_t, lo, F32_INF).min()
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes(), (t_i, wb)
        if got < horizon:
            prev = got
        new_wb = advance_cursor(prev, hi_t, wb, width)
        assert new_wb >= wb and np.all(hi_t[:new_wb] <= prev)
        wb = new_wb


@pytest.mark.parametrize("width", [32, 4])
@pytest.mark.parametrize("seed,E", [(0, 1), (1, 7), (2, 31), (3, 32), (4, 33), (5, 64),
                                    (6, 100)])
def test_cursor_rule_is_the_amin_over_all_intervals(seed, E, width):
    _check_cursor_rule(seed, E, width)


if not HAS_HYPOTHESIS:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_cursor_rule_property():
        pass
else:
    @given(seed=st.integers(0, 2 ** 31 - 1), E=st.integers(1, 100),
           width=st.sampled_from([4, 32]))
    @settings(max_examples=40, deadline=None)
    def test_cursor_rule_property(seed, E, width):
        _check_cursor_rule(seed, E, width, steps=60)


# ---------------------------------------- jobs with more intervals than a warp


@pytest.fixture(scope="module")
def many_interval_jobs():
    """``chip_smoke.many_interval_jobs``: the jobs that run the kernel's
    cursor and later windows on the card."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_sets", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.many_interval_jobs()


def _cursor_replay(t, s, cap_t, cap_k, hi_t, horizon):
    """One piecewise job through the kernel's search in numpy: its sorted
    slot vector, each interval's threshold free[K - k_e], ``window_start``
    from the cursor and ``advance_cursor`` after each request. Returns the
    starts (inf where unserved) and how often the cursor moved, a later
    window was searched and the drain zeroed a slot."""
    E, K = len(cap_t), max(int(cap_k.max()), 1)
    g, closed = np.clip(K - cap_k, 0, K - 1), cap_k <= 0
    free, prev, wb = np.zeros(K, np.float32), np.float32(0.0), 0
    starts, moves, later, drains = [], 0, 0, 0
    for t_i, s_i in zip(t, s):
        s0 = np.maximum(t_i, prev)
        thresh = np.where(closed, F32_INF, free[g]).astype(np.float32)
        a = np.maximum(cap_t, thresh)
        cand = np.where((s0 < hi_t) & (a < hi_t), a, F32_INF)
        later += int(wb + 32 < E and cand[wb:wb + 32].min() > cap_t[wb + 32])
        start = window_start(s0, cap_t, thresh, hi_t, wb)
        if start < horizon:
            fin = np.float32(start + s_i)
            pos = int((free[1:] < fin).sum())
            free = np.concatenate([free[1:pos + 1], [fin], free[pos + 1:]]).astype(np.float32)
            prev = start
        elif s0 < horizon:
            drains += int((free < horizon).any())
            free[free < horizon] = 0.0
        starts.append(start if start < horizon else F32_INF)
        new_wb = advance_cursor(prev, hi_t, wb)
        moves += int(new_wb > wb)
        wb = new_wb
    return np.asarray(starts, np.float32), moves, later, drains


@pytest.mark.parametrize("job", range(4))
def test_many_interval_jobs_run_the_cursor_as_the_plain_version(many_interval_jobs, job):
    """The rule the kernel runs for a job of more than 32 intervals, on the
    job's own tables, gives ``ref._pw_scan``'s starts bit for bit; the set
    moves the cursor in every job, searches past the window in the 64- and
    100-interval ones and drains slots."""
    from repro_torch.kernels.queue_core import ref
    jobs = many_interval_jobs
    caps, rows, args, k_max = _flat(jobs)
    kind, t, s, req_off, cap_t, cap_k, hi_t, cap_off, horizon, slo = args
    assert rows == list(range(4)) and kind.tolist() == [1] * 4 and k_max == 32
    a, b = req_off[job].item(), req_off[job + 1].item()
    c, d = cap_off[job].item(), cap_off[job + 1].item()
    E = d - c
    assert E == (33, 40, 64, 100)[job]
    tables = [x[c:d] for x in (cap_t, cap_k, hi_t)]
    got, moves, later, drains = _cursor_replay(t[a:b].numpy(), s[a:b].numpy(),
                                               *(x.numpy() for x in tables),
                                               np.float32(horizon[job].item()))
    want = torch.cat(ref._pw_scan(t[None, a:b], s[None, a:b], *(x[None] for x in tables),
                                  horizon[job:job + 1], k_max), dim=1)[0].numpy()
    assert got.tobytes() == want.tobytes()
    assert moves > 0 and drains > 0
    assert later > 0 or E < 64
    assert int(cap_k[c:d].le(0).sum()) > 0                      # closed intervals


def test_many_interval_jobs_match_jax_batched_core_and_oracle(many_interval_jobs):
    """The same jobs through ``simulate_queue_batch`` on the CPU (the flat
    plain version) against the JAX batched core and the float64 oracle, as
    ``chip_smoke.py`` holds the card's rows."""
    from repro.workloads import RequestTrace as JaxTrace
    port = many_interval_jobs
    ref = [jq.QueueJob(JaxTrace(j.trace.t, j.trace.prompt_tokens, j.trace.decode_tokens,
                                j.trace.kind), j.capacity_events, JAX_MODEL, JAX_SLO,
                       j.horizon) for j in port]
    tags = []
    got = tq.simulate_queue_batch(port, stats_out=tags, device="cpu")
    assert tags == ["torch_batched"] * len(port)
    for job, m, r in zip(port, got, jq.simulate_queue_batch(ref)):
        assert_matches_jax_batched(m, r, len(job.capacity_events))
        assert_golden(m, tq.simulate_queue_reference(job.trace, job.capacity_events,
                                                     job.model, job.slo,
                                                     horizon=job.horizon),
                      len(job.capacity_events))
