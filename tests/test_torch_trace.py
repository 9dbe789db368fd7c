"""The port's trace tools against the JAX package's, on the CPU.

``repro_torch.core.replay`` and ``repro_torch.trace`` are copies of
``repro.core.replay`` and ``repro.trace``. On the golden ``mix_tiny`` traces,
on tampered copies of them and on the pinned two-tenant trace of
``tests/test_replay.py``, the port's replay results and bisection reports
equal the JAX package's, and its CLI gives the same exit code, the same
standard output and the same Perfetto bytes for every subcommand.
"""
import dataclasses
import itertools
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro import trace as jax_trace  # noqa: E402
from repro.core import replay as jax_replay  # noqa: E402
from repro_torch import trace as port_trace  # noqa: E402
from repro_torch.core import replay as port_replay  # noqa: E402
from repro_torch.core.telemetry import load_events  # noqa: E402
from test_telemetry import paper_two_tenant_trace  # noqa: E402

GOLDEN = Path(__file__).resolve().parents[1] / "goldens" / "mix_tiny_traces"
NAMES = sorted(p.name for p in GOLDEN.glob("*.trace.jsonl"))
TAMPER = ("dropped_decision", "forged_grant", "claim_arithmetic")


def _golden(name):
    return load_events(str(GOLDEN / name))


def _policy(name):
    return _golden(name)[0]["policy"]


def _paper_events():
    tr = paper_two_tenant_trace()
    return [tr.header()] + tr.events


def _tamper(events, kind):
    """The three tamperings of ``tests/test_replay.py``: a dropped release,
    an idle grant of one node more, a claim that grants one node more."""
    events = [dict(e) for e in events]
    if kind == "dropped_decision":
        return [e for e in events if e["type"] != "release"]
    key = {"forged_grant": ("idle_grant", "nodes"),
           "claim_arithmetic": ("claim", "granted")}[kind]
    ev = next(e for e in events if e["type"] == key[0])
    ev[key[1]] += 1
    return events


def _write(path, events):
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
    return str(path)


def _both(argv, capsys):
    """(exit code, stdout, stderr) of the JAX CLI and of the port's."""
    out = []
    for main in (jax_trace.main, port_trace.main):
        capsys.readouterr()
        rc = main(list(argv))
        got = capsys.readouterr()
        out.append((rc, got.out, got.err))
    return out


def test_goldens_cover_every_engine():
    assert len(NAMES) == 7
    assert len({_policy(n) for n in NAMES}) == 7


# ------------------------------------------------------------- replay

@pytest.mark.parametrize("name", NAMES)
def test_replay_of_a_golden_equals_jax(name):
    events = _golden(name)
    got, want = port_replay.replay_events(events), jax_replay.replay_events(events)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.ok and want.ok, (got.problems[:3], want.problems[:3])
    assert got.books() == want.books()
    assert got.checkpoints == 24


@pytest.mark.parametrize("kind", TAMPER)
@pytest.mark.parametrize("source", ["paper_two_tenant"] + NAMES)
def test_replay_of_a_tampered_trace_equals_jax(source, kind):
    events = _paper_events() if source == "paper_two_tenant" else _golden(source)
    assert port_replay.replay_events(events).ok
    bad = _tamper(events, kind)
    got, want = port_replay.replay_events(bad), jax_replay.replay_events(bad)
    assert not got.ok
    assert got.problems == want.problems
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if kind == "claim_arithmetic":
        assert any("claim arithmetic" in p for p in got.problems)


def test_decision_stream_and_normalize_equal_jax():
    for name in NAMES:
        events = _golden(name)
        got, want = port_replay.decision_stream(events), jax_replay.decision_stream(events)
        assert got == want
        assert [port_replay.normalize_decision(e) for _, e in got] == \
            [jax_replay.normalize_decision(e) for _, e in want]
    assert port_replay.DECISION_TYPES == jax_replay.DECISION_TYPES


# ------------------------------------------------------------- bisect

@pytest.mark.parametrize("a,b", list(itertools.product(NAMES, NAMES)))
def test_bisect_of_two_goldens_equals_jax(a, b):
    ea, eb = _golden(a), _golden(b)
    got = port_replay.bisect_traces(ea, eb)
    assert got == jax_replay.bisect_traces(ea, eb)
    # proportional_share, demand_capped and slo_headroom take the same
    # decisions on mix_tiny: only the engine labels differ
    same = [port_replay.normalize_decision(e) for _, e in port_replay.decision_stream(ea)] == \
        [port_replay.normalize_decision(e) for _, e in port_replay.decision_stream(eb)]
    assert (got is None) == same
    assert same or a != b
    if got is not None:
        assert got["common_decisions"] == got["decision_index"]


@pytest.mark.parametrize("name", NAMES + ["paper_two_tenant"])
def test_bisect_against_a_prefix_reports_exhaustion_as_jax(name):
    events = _paper_events() if name == "paper_two_tenant" else _golden(name)
    stream = port_replay.decision_stream(events)
    prefix = events[:stream[len(stream) // 2][0]]
    got = port_replay.bisect_traces(events, prefix)
    assert got == jax_replay.bisect_traces(events, prefix)
    assert got["b"]["exhausted"] and not got["a"]["exhausted"]


# ----------------------------------------------------------------- CLI

@pytest.mark.parametrize("json_flag", [False, True])
@pytest.mark.parametrize("cmd", ["summarize", "causality", "validate", "replay"])
@pytest.mark.parametrize("name", NAMES)
def test_cli_on_a_golden_equals_jax(name, cmd, json_flag, capsys):
    argv = [cmd, str(GOLDEN / name)]
    if cmd == "causality":
        argv += ["--tenant", "ws-0"]
    argv += ["--json"] if json_flag else []
    (rc, out, err), port = _both(argv, capsys)
    assert port == (rc, out, err)
    assert rc == 0 and out


@pytest.mark.parametrize("name", NAMES)
def test_cli_perfetto_writes_the_same_bytes(name, tmp_path, capsys):
    path = tmp_path / "cell.perfetto.json"
    argv = ["perfetto", str(GOLDEN / name), "--out", str(path)]
    capsys.readouterr()
    assert jax_trace.main(argv) == 0
    want_out, want = capsys.readouterr().out, path.read_bytes()
    path.unlink()
    assert port_trace.main(argv) == 0
    assert capsys.readouterr().out == want_out
    assert path.read_bytes() == want
    assert json.loads(want)["traceEvents"]


@pytest.mark.parametrize("json_flag", [False, True])
@pytest.mark.parametrize("cmd", ["diff", "bisect"])
@pytest.mark.parametrize("a,b", [(NAMES[0], NAMES[1]), (NAMES[4], NAMES[6]),
                                 (NAMES[2], NAMES[2])])
def test_cli_on_two_goldens_equals_jax(a, b, cmd, json_flag, capsys):
    argv = [cmd, str(GOLDEN / a), str(GOLDEN / b)] + (["--json"] if json_flag else [])
    (rc, out, err), port = _both(argv, capsys)
    assert port == (rc, out, err)
    assert rc == (1 if cmd == "bisect" and a != b else 0)


@pytest.mark.parametrize("json_flag", [False, True])
def test_cli_regress_goldens_against_themselves(json_flag, capsys):
    argv = ["regress", str(GOLDEN), str(GOLDEN)] + (["--json"] if json_flag else [])
    (rc, out, err), port = _both(argv, capsys)
    assert port == (rc, out, err) and rc == 0


LOOSE = ["--reclaim-p99-s", "1e9", "--reclaim-n", "1000000", "--slo-count", "1000000",
         "--slo-p99-duration-s", "1e9", "--spend", "1e9", "--faults", "1000000",
         "--unrecovered", "1000000"]


@pytest.mark.parametrize("json_flag", [False, True])
@pytest.mark.parametrize("loose", [False, True])
def test_cli_regress_flags_engine_drift_as_jax(loose, json_flag, tmp_path, capsys):
    """One cell's trace replaced by another engine's under the same cell
    identity: zero thresholds breach, loosened thresholds pass."""
    fresh = tmp_path / "fresh"
    fresh.mkdir()
    for name in NAMES:
        (fresh / name).write_bytes((GOLDEN / name).read_bytes())
    victim, other = NAMES[0], NAMES[4]
    assert _policy(victim) != _policy(other)
    events = _golden(other)
    events[0] = dict(events[0], cell_id=_golden(victim)[0]["cell_id"])
    _write(fresh / victim, events)
    argv = ["regress", str(GOLDEN), str(fresh)] + (LOOSE if loose else []) + \
        (["--json"] if json_flag else [])
    (rc, out, err), port = _both(argv, capsys)
    assert port == (rc, out, err)
    assert rc == (0 if loose else 1)


@pytest.mark.parametrize("json_flag", [False, True])
def test_cli_regress_with_a_missing_cell_as_jax(json_flag, tmp_path, capsys):
    fresh = tmp_path / "fresh"
    fresh.mkdir()
    (fresh / NAMES[3]).write_bytes((GOLDEN / NAMES[3]).read_bytes())
    flag = ["--json"] if json_flag else []
    (rc, out, err), port = _both(["regress", str(GOLDEN), str(fresh)] + flag, capsys)
    assert port == (rc, out, err) and rc == 1
    (rc, out, err), port = _both(["regress", str(fresh), str(GOLDEN)] + flag, capsys)
    assert port == (rc, out, err) and rc == 0


@pytest.mark.parametrize("json_flag", [False, True])
@pytest.mark.parametrize("cmd,drop", [("validate", "claim"), ("replay", "claim"),
                                      ("replay", "release")])
def test_cli_on_a_tampered_trace_exits_1_as_jax(cmd, drop, json_flag, tmp_path, capsys):
    bad = [e for e in _golden(NAMES[1]) if e["type"] != drop]
    path = _write(tmp_path / "bad.trace.jsonl", bad)
    (rc, out, err), port = _both([cmd, path] + (["--json"] if json_flag else []), capsys)
    assert port == (rc, out, err) and rc == 1


def test_cli_prog_names_the_port(capsys):
    with pytest.raises(SystemExit):
        port_trace.main(["--help"])
    assert capsys.readouterr().out.startswith("usage: python -m repro_torch.trace")
    assert port_trace.RegressThresholds() == port_trace.RegressThresholds(
        **dataclasses.asdict(jax_trace.RegressThresholds()))
