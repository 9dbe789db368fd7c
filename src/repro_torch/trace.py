"""Trace analyzer CLI for control-plane telemetry (core/telemetry.py).

    python -m repro_torch.trace summarize CELL.trace.jsonl
    python -m repro_torch.trace diff A.trace.jsonl B.trace.jsonl
    python -m repro_torch.trace causality CELL.trace.jsonl --tenant ws-0
    python -m repro_torch.trace validate CELL.trace.jsonl
    python -m repro_torch.trace replay CELL.trace.jsonl
    python -m repro_torch.trace bisect A.trace.jsonl B.trace.jsonl
    python -m repro_torch.trace regress goldens/mix_tiny_traces NEW_TRACE_DIR
    python -m repro_torch.trace perfetto CELL.trace.jsonl --out cell.perfetto.json

``summarize`` prints per-tenant reclaim-latency and SLO-violation-duration
distributions, spend attribution and the fault ledger (failures/repairs
by cause, suppressions, drain deliveries); ``diff`` compares two summaries
(e.g. the same cell under two engines) including fault-ledger and
never-recovered deltas; ``causality`` walks every forced claim's
``claim -> reclaim plan -> drains -> SLO recovery`` chain;
``validate`` schema-checks the trace and verifies causal-chain integrity
— including every ``node_fail -> node_repair`` pairing and every
``reclaim_step -> drain_complete`` delivery — (non-zero exit on any
problem — CI gates on it); ``replay`` reconstructs the run's decision
sequence from the trace and re-applies it against fresh count books,
verifying every ``metrics`` checkpoint (core/replay.py) — non-zero exit
proves the trace is NOT a complete causal record; ``bisect`` walks two
traces of the same scenario under different engines and localizes the
first divergent decision (sim-time, tenant, planned vs taken step);
``regress`` pairs every golden cell trace with its counterpart in a new
trace dir and gates on drift thresholds (reclaim p99, SLO episode
count/duration, spend, fault ledger, never-recovered claims — all
default 0: same-seed traces are deterministic), non-zero exit on breach
— the CI regression gate; ``perfetto`` exports Chrome trace-event JSON
loadable in https://ui.perfetto.dev or chrome://tracing. All subcommands
take ``--json`` for machine output.

The port's own copy of ``repro.trace`` with the same logic, over the port's
``core/replay.py`` and ``core/telemetry.py``: host code that reads JSONL and
prints text, so it has no ``--device``. Its exit codes, standard output and
Perfetto files equal the JAX package's CLI on the same traces.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from repro_torch.core.replay import bisect_traces, replay_events
from repro_torch.core.telemetry import (causality_report,
                                        check_causal_chains,
                                        diff_summaries, load_events,
                                        summarize_events, to_perfetto,
                                        validate_events)


def _fmt_dist(d: dict) -> str:
    return (f"n={d['n']} p50={d['p50']:.1f}s p99={d['p99']:.1f}s "
            f"max={d['max']:.1f}s")


def _print_summary(s: dict) -> None:
    print(f"events: {s['events']}")
    for t, n in s["by_type"].items():
        print(f"  {t:<16} {n}")
    rl = s["reclaim_latency_s"]
    print(f"reclaim latency (overall): {_fmt_dist(rl['overall'])}")
    for name, d in rl["by_tenant"].items():
        print(f"  {name:<16} {_fmt_dist(d)}")
    for name, n in rl["unrecovered"].items():
        print(f"  {name:<16} {n} claim(s) never recovered")
    if s["slo_violations"]:
        print("slo violations:")
        for name, v in s["slo_violations"].items():
            print(f"  {name:<16} count={v['count']} open={v['open']} "
                  f"{_fmt_dist(v['duration_s'])}")
    if s["spend"]:
        print("spend attribution:")
        for name, d in s["spend"].items():
            print(f"  {name:<16} idle={d.get('idle', 0.0):.2f} "
                  f"reclaim={d.get('reclaim', 0.0):.2f}")
    if s["auction"]["clearings"]:
        print(f"auction clearings: {s['auction']['clearings']} "
              f"price {_fmt_dist(s['auction']['clearing_price'])}")
    f = s.get("faults", {})
    if f.get("failures") or f.get("suppressed"):
        by_cause = " ".join(f"{c}={n}" for c, n in
                            sorted(f.get("by_cause", {}).items()))
        print(f"faults: failures={f['failures']} repairs={f['repairs']} "
              f"unrepaired={f['unrepaired']} suppressed={f['suppressed']} "
              f"({by_cause})")
        if f.get("drain_completes"):
            print(f"  drains: {f['drain_completes']} window(s), "
                  f"{f['drained_nodes']} node(s) delivered after drain")


def _cmd_summarize(args) -> int:
    s = summarize_events(load_events(args.trace))
    if args.json:
        json.dump(s, sys.stdout, indent=1)
        print()
    else:
        _print_summary(s)
    return 0


def _cmd_diff(args) -> int:
    d = diff_summaries(summarize_events(load_events(args.a)),
                       summarize_events(load_events(args.b)))
    if args.json:
        json.dump(d, sys.stdout, indent=1)
        print()
        return 0
    print(f"events: {d['events']['a']} -> {d['events']['b']} "
          f"({d['events']['delta']:+d})")
    for t, v in d["by_type"].items():
        if v["delta"]:
            print(f"  {t:<16} {v['a']} -> {v['b']} ({v['delta']:+d})")
    rl = d["reclaim_latency_s"]
    print(f"reclaim latency: n={rl['n']['a']}->{rl['n']['b']}  " + "  ".join(
        f"{k}={rl[k]['a']:.1f}->{rl[k]['b']:.1f}"
        for k in ("p50", "p99", "max")))
    for name, v in d["slo_violations"].items():
        print(f"  slo {name}: count {v['count']['a']}->{v['count']['b']} "
              f"p99_dur {v['p99_duration_s']['a']:.1f}s->"
              f"{v['p99_duration_s']['b']:.1f}s")
    for name, v in d["spend"].items():
        print(f"  spend {name}: idle {v['idle']['a']:.1f}->"
              f"{v['idle']['b']:.1f} reclaim {v['reclaim']['a']:.1f}->"
              f"{v['reclaim']['b']:.1f}")
    for name, v in d["unrecovered"].items():
        if v["a"] or v["b"]:
            print(f"  unrecovered {name}: {v['a']}->{v['b']} "
                  f"({v['delta']:+d})")
    f = d["faults"]
    if any(f[k]["a"] or f[k]["b"] for k in f if k != "by_cause"):
        print("faults: " + "  ".join(
            f"{k}={f[k]['a']}->{f[k]['b']}"
            for k in ("failures", "repairs", "unrepaired", "suppressed",
                      "drain_completes", "drained_nodes")))
        for c, v in f["by_cause"].items():
            if v["delta"]:
                print(f"  cause {c}: {v['a']}->{v['b']} ({v['delta']:+d})")
    return 0


def _cmd_causality(args) -> int:
    rep = causality_report(load_events(args.trace), tenant=args.tenant)
    if args.json:
        json.dump(rep, sys.stdout, indent=1)
        print()
        return 0 if not rep["broken_chains"] else 1
    who = args.tenant or "all tenants"
    print(f"forced-reclaim claims ({who}): {rep['forced_claims']}")
    for c in rep["chains"]:
        print(f"[t={c['ts']:.1f}s] {c['tenant']} requested {c['requested']} "
              f"(free={c['from_free']}, granted={c['granted']}, "
              f"short={c['short']}) engine={c['engine']}")
        print(f"    plan: {c['planned_victims']}")
        for dr in c["drains"]:
            print(f"    drain {dr['victim']}: released {dr['released']}, "
                  f"claimant got {dr['granted']}")
        ep = c.get("shortfall_episode")
        if ep is not None:
            if ep["recovered"]:
                print(f"    shortfall episode: recovered after "
                      f"{ep['duration_s']:.1f}s")
            else:
                print("    shortfall episode: NEVER recovered")
    if rep["broken_chains"]:
        print(f"BROKEN causal chains: {len(rep['broken_chains'])}")
        for p in rep["broken_chains"][:10]:
            print(f"  {p}")
        return 1
    print("causal chains intact")
    return 0


def _cmd_validate(args) -> int:
    events = load_events(args.trace)
    problems = validate_events(events) + check_causal_chains(events)
    if args.json:
        json.dump({"events": len(events), "problems": problems},
                  sys.stdout, indent=1)
        print()
    elif problems:
        for p in problems:
            print(p)
    else:
        print(f"ok: {len(events)} events, schema valid, "
              f"causal chains intact")
    return 1 if problems else 0


def _cmd_replay(args) -> int:
    res = replay_events(load_events(args.trace))
    if args.json:
        json.dump({"events": res.events, "decisions": res.decisions,
                   "checkpoints": res.checkpoints, "books": res.books(),
                   "problems": res.problems}, sys.stdout, indent=1)
        print()
        return 0 if res.ok else 1
    if res.problems:
        print(f"REPLAY DIVERGED: {len(res.problems)} problem(s)")
        for p in res.problems[:20]:
            print(f"  {p}")
        return 1
    b = res.books()
    print(f"ok: replayed {res.decisions} decision(s) from {res.events} "
          f"event(s); {res.checkpoints} checkpoint(s) matched the live "
          f"run's count books exactly")
    print(f"final books: total={b['total']} free={b['free']} "
          f"draining={b['draining']}")
    for name, n in b["alloc"].items():
        extra = ""
        if b["spend"].get(name):
            extra = f" spend={b['spend'][name]:.2f}"
        print(f"  {name:<16} alloc={n}{extra}")
    return 0


def _cmd_bisect(args) -> int:
    rep = bisect_traces(load_events(args.a), load_events(args.b))
    if args.json:
        json.dump(rep or {"identical": True}, sys.stdout, indent=1)
        print()
        return 0 if rep is None else 1
    if rep is None:
        print("decision streams are behaviorally identical")
        return 0
    print(f"first divergent decision: #{rep['decision_index']} "
          f"({rep['common_decisions']} common decision(s) before it)")
    for label in ("a", "b"):
        s = rep[label]
        if s["exhausted"]:
            print(f"  {label}: trace ends (no decision #"
                  f"{rep['decision_index']})")
        else:
            print(f"  {label}: [t={s['ts']:.1f}s] {s['type']} "
                  f"tenant={s['tenant']}")
            print(f"     {json.dumps(s['event'], sort_keys=True)}")
    for label in ("plan_a", "plan_b"):
        plan = rep.get(label)
        if plan:
            steps = " ".join(f"{st['victim']}:{st['take']}"
                             for st in plan["steps"])
            print(f"  {label}: [t={plan['ts']:.1f}s] "
                  f"engine={plan['engine']} planned [{steps}]")
    if rep["context"]:
        print("  last common decisions:")
        for ev in rep["context"]:
            print(f"    [t={ev.get('ts', 0.0):.1f}s] {ev.get('type')} "
                  f"tenant={ev.get('tenant')}")
    return 1


# --------------------------------------------------------- regress gate


@dataclasses.dataclass(frozen=True)
class RegressThresholds:
    """Max tolerated |delta| per drift axis. All default to zero: a
    same-seed rerun emits a byte-identical trace (no wall clock in the
    control plane; queue metrics are post-hoc queue evaluations that never
    feed back into consolidation), so ANY drift is a behavior change."""
    reclaim_p99_s: float = 0.0
    reclaim_n: int = 0
    slo_count: int = 0
    slo_p99_duration_s: float = 0.0
    spend: float = 0.0
    faults: int = 0
    unrecovered: int = 0


def check_regression(diff: dict, thr: RegressThresholds) -> list:
    """Breaches in a ``diff_summaries`` output under ``thr`` (empty list
    == within tolerance)."""
    breaches = []

    def gate(axis, delta, limit):
        if abs(delta) > limit:
            breaches.append(f"{axis}: |{delta:+g}| > {limit:g}")

    rl = diff["reclaim_latency_s"]
    gate("reclaim_latency_s.n", rl["n"]["delta"], thr.reclaim_n)
    gate("reclaim_latency_s.p99", rl["p99"]["delta"], thr.reclaim_p99_s)
    for name, v in diff["slo_violations"].items():
        gate(f"slo_violations[{name}].count", v["count"]["delta"],
             thr.slo_count)
        gate(f"slo_violations[{name}].p99_duration_s",
             v["p99_duration_s"]["delta"], thr.slo_p99_duration_s)
    for name, v in diff["spend"].items():
        for kind in ("idle", "reclaim"):
            gate(f"spend[{name}].{kind}", v[kind]["delta"], thr.spend)
    for name, v in diff["unrecovered"].items():
        gate(f"unrecovered[{name}]", v["delta"], thr.unrecovered)
    for k, v in diff["faults"].items():
        if k == "by_cause":
            for c, cv in v.items():
                gate(f"faults.by_cause[{c}]", cv["delta"], thr.faults)
        else:
            gate(f"faults.{k}", v["delta"], thr.faults)
    return breaches


def _trace_cells(trace_dir: str) -> dict:
    """Map cell identity -> trace path for every ``*.trace.jsonl`` in a
    dir. Identity is the header's ``cell_id`` (human-readable, stable
    across the cell_key hash-schema) with the filename stem as
    fallback."""
    cells = {}
    for fn in sorted(os.listdir(trace_dir)):
        if not fn.endswith(".trace.jsonl"):
            continue
        path = os.path.join(trace_dir, fn)
        ident = fn[:-len(".trace.jsonl")]
        with open(path) as f:
            first = f.readline()
        if first:
            header = json.loads(first)
            ident = header.get("cell_id", ident)
        cells[ident] = path
    return cells


def _cmd_regress(args) -> int:
    thr = RegressThresholds(
        reclaim_p99_s=args.reclaim_p99_s, reclaim_n=args.reclaim_n,
        slo_count=args.slo_count,
        slo_p99_duration_s=args.slo_p99_duration_s, spend=args.spend,
        faults=args.faults, unrecovered=args.unrecovered)
    golden = _trace_cells(args.golden_dir)
    fresh = _trace_cells(args.new_dir)
    if not golden:
        print(f"no *.trace.jsonl files in golden dir {args.golden_dir}",
              file=sys.stderr)
        return 2
    report = {"cells": {}, "missing": [], "extra": [], "breaches": 0}
    for ident in sorted(set(golden) - set(fresh)):
        report["missing"].append(ident)
    for ident in sorted(set(fresh) - set(golden)):
        report["extra"].append(ident)
    for ident in sorted(set(golden) & set(fresh)):
        d = diff_summaries(summarize_events(load_events(golden[ident])),
                           summarize_events(load_events(fresh[ident])))
        breaches = check_regression(d, thr)
        report["cells"][ident] = {"breaches": breaches, "diff": d}
        report["breaches"] += len(breaches)
    failed = bool(report["missing"] or report["breaches"])
    if args.json:
        json.dump(report, sys.stdout, indent=1)
        print()
        return 1 if failed else 0
    for ident in report["missing"]:
        print(f"MISSING: golden cell '{ident}' has no counterpart in "
              f"{args.new_dir}")
    for ident in report["extra"]:
        print(f"note: new cell '{ident}' has no golden baseline "
              f"(not gated)")
    for ident, cell in report["cells"].items():
        if cell["breaches"]:
            print(f"DRIFT {ident}:")
            for br in cell["breaches"]:
                print(f"  {br}")
        else:
            print(f"ok {ident}")
    n = len(report["cells"])
    if failed:
        print(f"regress: FAIL — {report['breaches']} breach(es) across "
              f"{n} paired cell(s), {len(report['missing'])} missing")
        return 1
    print(f"regress: pass — {n} cell(s) within thresholds")
    return 0


def _cmd_perfetto(args) -> int:
    doc = to_perfetto(load_events(args.trace))
    with open(args.out, "w") as f:
        json.dump(doc, f)
    print(f"{len(doc['traceEvents'])} trace events -> {args.out} "
          f"(open in https://ui.perfetto.dev)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.trace",
        description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize", help="per-tenant latency/SLO/spend "
                                         "distributions")
    p.add_argument("trace")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_summarize)

    p = sub.add_parser("diff", help="compare two trace summaries")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_diff)

    p = sub.add_parser("causality", help="walk claim -> reclaim -> "
                                         "recovery chains")
    p.add_argument("trace")
    p.add_argument("--tenant", default=None)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_causality)

    p = sub.add_parser("validate", help="schema + causal-integrity check "
                                        "(non-zero exit on problems)")
    p.add_argument("trace")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_validate)

    p = sub.add_parser("replay", help="re-apply the decision sequence "
                                      "against count books (non-zero "
                                      "exit on divergence)")
    p.add_argument("trace")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_replay)

    p = sub.add_parser("bisect", help="first divergent decision between "
                                      "two traces of the same scenario")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_bisect)

    p = sub.add_parser("regress", help="gate a new trace dir against a "
                                       "golden baseline (non-zero exit "
                                       "on drift)")
    p.add_argument("golden_dir")
    p.add_argument("new_dir")
    p.add_argument("--json", action="store_true")
    t = RegressThresholds()
    p.add_argument("--reclaim-p99-s", type=float, default=t.reclaim_p99_s,
                   help="max |delta| in overall reclaim-latency p99 "
                        "seconds (default %(default)s)")
    p.add_argument("--reclaim-n", type=int, default=t.reclaim_n,
                   help="max |delta| in reclaim count")
    p.add_argument("--slo-count", type=int, default=t.slo_count,
                   help="max |delta| in per-tenant SLO episode count")
    p.add_argument("--slo-p99-duration-s", type=float,
                   default=t.slo_p99_duration_s,
                   help="max |delta| in SLO episode p99 duration seconds")
    p.add_argument("--spend", type=float, default=t.spend,
                   help="max |delta| in per-tenant spend attribution")
    p.add_argument("--faults", type=int, default=t.faults,
                   help="max |delta| in any fault-ledger counter")
    p.add_argument("--unrecovered", type=int, default=t.unrecovered,
                   help="max |delta| in never-recovered claim counts")
    p.set_defaults(fn=_cmd_regress)

    p = sub.add_parser("perfetto", help="export Chrome trace-event JSON")
    p.add_argument("trace")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=_cmd_perfetto)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
