"""Control-plane telemetry: causal decision traces + metric timeseries.

The consolidation stack's policy claims ("enough resources for the web
department", "HPC benefit improved") were previously asserted from
end-of-run aggregates; nothing could show *why* a reclaim fired, how long
an SLO shortfall lasted before the engine reacted, or which auction
clearing starved which tenant. This module is the measurement substrate:
a zero-dependency structured event bus (:class:`Tracer`) that the whole
control plane emits into —

  * every ``claim`` / ``release`` / ``idle_grant`` of the provision
    service, each applied ``ReclaimStep`` of a ``plan_reclaim`` plan,
    auction clearings and per-winner market debits, SLO shortfall
    episodes (violation -> recovery), node failures/repairs, and
    autoscaler decisions — as typed events stamped with **sim-time** and
    **causal span ids**, so a ``claim -> reclaim plan -> per-victim
    drains -> SLO recovery`` chain is one linked trace;
  * a per-interval metric timeseries (free pool, per-tenant alloc /
    demand / latency headroom / queue depth / market spend), emitted as
    ``metrics`` events on the same clock.

Design constraints (enforced by the ``policy_engine`` bench gate):

  * **off by default, ~0 overhead when off** — every emission site guards
    on ``tracer.enabled`` (one attribute load + branch); the shared
    :data:`NULL_TRACER` singleton is the disabled default everywhere;
  * **< 5 % overhead when on**, measured on a deployment-representative
    consolidation cell (request-level latency tenants, the configuration
    campaign cells run; true cost ~1-2 %). Events are small dicts
    appended to a list — no I/O, no formatting until ``to_jsonl``. The
    adversarial bound is the pure control-plane microbench (~17 us of
    sim work per event, nothing to amortize against) where full-detail
    tracing costs ~13 %; the bench records that number too;
  * **deterministic** — events carry only sim-time and control-plane
    state, never wall-clock, so same-seed runs emit identical traces
    (pinned by tests/test_telemetry.py);
  * **no silent caps** — the event buffer is bounded by ``max_events``
    and the header records ``dropped_events`` when it overflows.

Analysis helpers live here too (summaries, causality report, validation,
Perfetto/Chrome trace-event export); ``python -m repro_torch.trace`` is the
CLI over them. The campaign runner's ``--trace`` flag spools one JSONL trace
per cell and folds ``summarize_events`` output into the artifact.

The port's own copy of ``repro.core.telemetry`` with the same logic.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

TRACE_VERSION = 1
# event-buffer bound: a half-day 5-department bench run emits ~100k
# events; the cap only exists so a runaway loop cannot eat the host, and
# overflow is RECORDED (header.dropped_events), never silent
DEFAULT_MAX_EVENTS = 2_000_000
# metric-timeseries sampling period in sim-seconds (Tracer arg overrides);
# 300 s keeps multi-hour traces readable AND sampling cost inside the
# policy_engine bench's < 5 % overhead envelope
DEFAULT_METRIC_INTERVAL_S = 300.0

# required payload fields per event type (beyond the universal "type" and
# "ts"); the validator — and CI's trace schema check — enforce these
EVENT_SCHEMA: Dict[str, tuple] = {
    "trace_header": ("version",),
    "claim": ("tenant", "requested", "from_free", "deficit", "granted",
              "short", "span"),
    "reclaim_plan": ("tenant", "engine", "deficit", "steps", "span",
                     "parent"),
    "reclaim_step": ("tenant", "claimant", "asked", "released", "granted",
                     "parent"),
    "surplus_reflow": ("nodes", "parent"),
    "idle_grant": ("tenant", "nodes"),
    "auction_clear": ("price", "interval"),
    "debit": ("tenant", "nodes", "unit_price", "cost", "kind", "interval"),
    "release": ("tenant", "nodes"),
    "node_fail": ("owner", "span"),
    "node_repair": ("parent",),
    "node_state": ("node", "from", "to"),
    "fault_suppressed": ("reason",),
    "drain_complete": ("tenant", "nodes", "parent"),
    "slo_violation": ("tenant", "demand", "alloc", "shortfall", "span"),
    "slo_recovery": ("tenant", "duration_s", "parent"),
    "autoscale": ("tenant", "prev", "demand", "source"),
    "metrics": ("free", "tenants"),
}


class Tracer:
    """Structured control-plane event bus with causal span ids.

    One instance per run. The owner of the virtual clock (simulator /
    orchestrator) keeps ``now`` current; emitters (provision service,
    engines, market) just call :meth:`emit` — they never need to know the
    time. Span ids are plain monotonically increasing ints: an event that
    *opens* a causal context carries ``span``, events caused by it carry
    ``parent`` pointing back, so chains survive serialization with no
    object graph.
    """

    __slots__ = ("enabled", "events", "dropped_events", "max_events",
                 "now", "metric_interval_s", "last_claim_span", "meta",
                 "_next_span")

    def __init__(self, enabled: bool = True,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 metric_interval_s: float = DEFAULT_METRIC_INTERVAL_S,
                 meta: Optional[Dict] = None):
        self.enabled = enabled
        self.events: List[Dict] = []
        self.dropped_events = 0
        self.max_events = max_events
        self.now = 0.0
        self.metric_interval_s = metric_interval_s
        # tenant -> span of its most recent claim; SLO shortfall episodes
        # opened right after an under-granted claim parent to it, closing
        # the claim -> ... -> recovery causal chain
        self.last_claim_span: Dict[str, int] = {}
        self.meta: Dict = dict(meta or {})
        self._next_span = 0

    # ------------------------------------------------------------- core
    def new_span(self) -> int:
        self._next_span += 1
        return self._next_span

    def emit(self, type_: str, **fields) -> None:
        """Append one typed event stamped with the current sim-time.

        Callers pass ``span=`` / ``parent=`` / ``tenant=`` plus the
        type's payload fields. A full buffer drops the event and counts
        it (``dropped_events``) — capped traces are distinguishable from
        short ones. Hot path: the kwargs dict IS the stored event (one
        allocation per emit — the < 5 % bench gate rides on this)."""
        if not self.enabled:
            return
        events = self.events
        if len(events) >= self.max_events:
            self.dropped_events += 1
            return
        fields["type"] = type_
        fields["ts"] = self.now
        events.append(fields)

    def append(self, ev: Dict) -> None:
        """Hot-path emit: the caller hand-built the event dict (with its
        ``"type"``) — this just stamps ``ts`` and appends. ~2x cheaper
        than :meth:`emit` (no kwargs repacking); the instrumented claim
        path and the simulator's per-event sites use it so the bench
        gate's < 5 % envelope holds. Callers must already have checked
        ``enabled``."""
        events = self.events
        if len(events) < self.max_events:
            ev["ts"] = self.now
            events.append(ev)
        else:
            self.dropped_events += 1

    # ---------------------------------------------------- serialization
    def header(self) -> Dict:
        return {"type": "trace_header", "ts": 0.0,
                "version": TRACE_VERSION, "events": len(self.events),
                "dropped_events": self.dropped_events, **self.meta}

    def lines(self) -> List[str]:
        """Canonical JSONL lines (header first); the unit of the
        same-seed determinism guarantee."""
        out = [json.dumps(self.header(), sort_keys=True, default=float)]
        out.extend(json.dumps(ev, sort_keys=True, default=float)
                   for ev in self.events)
        return out

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for line in self.lines():
                f.write(line + "\n")


#: shared disabled tracer — the default everywhere tracing is optional.
#: ``emit`` on it is a no-op, and emission sites additionally guard on
#: ``tracer.enabled`` so the disabled path costs one branch.
NULL_TRACER = Tracer(enabled=False)


def load_events(path: str) -> List[Dict]:
    """Read a JSONL trace back (header line included, in position 0)."""
    events: List[Dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


# ---------------------------------------------------------------- analysis


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list (no numpy — this
    module stays dependency-free)."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return float(sorted_vals[k])


def _dist(vals: List[float]) -> Dict:
    vals = sorted(vals)
    return {
        "n": len(vals),
        "p50": percentile(vals, 50.0),
        "p99": percentile(vals, 99.0),
        "max": vals[-1] if vals else 0.0,
        "total": float(sum(vals)),
    }


def summarize_events(events: List[Dict]) -> Dict:
    """Compact per-run trace summary (the campaign artifact's
    ``trace_summary`` and the analyzer's ``summarize`` output).

    * ``reclaim_latency_s``: per claimant, the sim-time from each claim
      that triggered forced reclaim (``deficit > 0``) to the moment its
      shortfall cleared — 0 when the reclaim chain covered it
      synchronously, the linked SLO-recovery delay otherwise; claims
      whose shortfall never cleared are counted in ``unrecovered``
      (never silently dropped).
    * ``slo_violations``: per tenant, shortfall-episode count and
      duration distribution (open episodes counted separately).
    * ``spend``: per tenant, market debits attributed idle vs reclaim.
    """
    by_type: Dict[str, int] = {}
    claims_by_span: Dict[int, Dict] = {}
    recovery_by_parent: Dict[int, Dict] = {}
    violations: List[Dict] = []
    spend: Dict[str, Dict[str, float]] = {}
    clear_prices: List[float] = []
    fail_by_cause: Dict[str, int] = {}
    drained_nodes = 0
    for ev in events:
        t = ev.get("type")
        by_type[t] = by_type.get(t, 0) + 1
        if t == "claim":
            claims_by_span[ev["span"]] = ev
        elif t == "slo_violation":
            violations.append(ev)
        elif t == "slo_recovery":
            recovery_by_parent[ev["parent"]] = ev
        elif t == "debit":
            d = spend.setdefault(ev["tenant"], {"idle": 0.0, "reclaim": 0.0})
            d[ev["kind"]] = d.get(ev["kind"], 0.0) + float(ev["cost"])
        elif t == "auction_clear":
            clear_prices.append(float(ev["price"]))
        elif t == "node_fail":
            cause = str(ev.get("cause", "mtbf"))
            fail_by_cause[cause] = fail_by_cause.get(cause, 0) + 1
        elif t == "drain_complete":
            drained_nodes += int(ev.get("nodes", 0))

    # violation span -> the claim span it descends from (direct parent)
    viol_claim: Dict[int, Optional[int]] = {
        v["span"]: v.get("parent") for v in violations}

    reclaim_lat: Dict[str, List[float]] = {}
    unrecovered: Dict[str, int] = {}
    for span, c in claims_by_span.items():
        if c.get("deficit", 0) <= 0:
            continue                      # free-pool grant: no reclaim
        tenant = c["tenant"]
        if c.get("short", 0) == 0:
            reclaim_lat.setdefault(tenant, []).append(0.0)
            continue
        # under-granted: find the shortfall episode this claim opened and
        # its recovery; the episode's parent IS this claim's span
        lat = None
        for vspan, cspan in viol_claim.items():
            if cspan == span and vspan in recovery_by_parent:
                rec = recovery_by_parent[vspan]
                lat = float(rec["ts"]) - float(c["ts"])
                break
        if lat is None:
            unrecovered[tenant] = unrecovered.get(tenant, 0) + 1
        else:
            reclaim_lat.setdefault(tenant, []).append(lat)

    episodes: Dict[str, Dict] = {}
    for v in violations:
        e = episodes.setdefault(v["tenant"],
                                {"count": 0, "open": 0, "durations": []})
        e["count"] += 1
        rec = recovery_by_parent.get(v["span"])
        if rec is None:
            e["open"] += 1
        else:
            e["durations"].append(float(rec["duration_s"]))

    all_lat = sorted(x for v in reclaim_lat.values() for x in v)
    return {
        "events": len(events),
        "by_type": dict(sorted(by_type.items())),
        "reclaim_latency_s": {
            "overall": _dist(all_lat),
            "by_tenant": {k: _dist(v)
                          for k, v in sorted(reclaim_lat.items())},
            "unrecovered": dict(sorted(unrecovered.items())),
        },
        "slo_violations": {
            name: {"count": e["count"], "open": e["open"],
                   "duration_s": _dist(e["durations"])}
            for name, e in sorted(episodes.items())},
        "spend": {k: dict(v) for k, v in sorted(spend.items())},
        "auction": {"clearings": len(clear_prices),
                    "clearing_price": _dist(clear_prices)},
        "faults": {
            "failures": by_type.get("node_fail", 0),
            "repairs": by_type.get("node_repair", 0),
            "unrepaired": by_type.get("node_fail", 0)
            - by_type.get("node_repair", 0),
            "suppressed": by_type.get("fault_suppressed", 0),
            "by_cause": dict(sorted(fail_by_cause.items())),
            "drain_completes": by_type.get("drain_complete", 0),
            "drained_nodes": drained_nodes,
        },
    }


def validate_events(events: List[Dict]) -> List[str]:
    """Schema + referential-integrity check; returns a list of problems
    (empty = valid). Checked: known type, required fields present,
    numeric ``ts``, and every ``parent`` resolving to a ``span`` defined
    somewhere in the trace (two-pass: a claim's children legally appear
    before the claim event itself)."""
    problems: List[str] = []
    spans = {ev["span"] for ev in events if "span" in ev}
    for i, ev in enumerate(events):
        t = ev.get("type")
        if t not in EVENT_SCHEMA:
            problems.append(f"event {i}: unknown type {t!r}")
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"event {i} ({t}): missing/bad ts")
        for key in EVENT_SCHEMA[t]:
            if key not in ev:
                problems.append(f"event {i} ({t}): missing field {key!r}")
        parent = ev.get("parent")
        if parent is not None and parent not in spans:
            problems.append(
                f"event {i} ({t}): parent span {parent} never defined")
    return problems


def check_causal_chains(events: List[Dict]) -> List[str]:
    """Causal-integrity check for the reclaim and fault chains (empty =
    intact): every ``reclaim_plan`` parents to a ``claim`` span, every
    ``reclaim_step`` to a ``reclaim_plan`` span, every ``slo_recovery``
    to an ``slo_violation`` span, every ``node_repair`` to the
    ``node_fail`` that took the node down, and every ``drain_complete``
    to the ``reclaim_step`` whose drain window it closes."""
    kind_by_span: Dict[int, str] = {}
    for ev in events:
        if "span" in ev:
            kind_by_span[ev["span"]] = ev["type"]
    want_parent = {"reclaim_plan": "claim", "reclaim_step": "reclaim_plan",
                   "slo_recovery": "slo_violation",
                   "node_repair": "node_fail",
                   "drain_complete": "reclaim_step"}
    problems: List[str] = []
    for i, ev in enumerate(events):
        need = want_parent.get(ev.get("type"))
        if need is None:
            continue
        parent = ev.get("parent")
        got = kind_by_span.get(parent)
        if got != need:
            problems.append(
                f"event {i} ({ev['type']}): parent span {parent!r} is "
                f"{got!r}, expected a {need} span")
    return problems


def causality_report(events: List[Dict],
                     tenant: Optional[str] = None) -> Dict:
    """Per-tenant causality report: each forced-reclaim claim with its
    plan, applied drains, and the linked shortfall episode (if any)."""
    plans_by_parent: Dict[int, Dict] = {}
    steps_by_parent: Dict[int, List[Dict]] = {}
    viol_by_parent: Dict[int, Dict] = {}
    recovery_by_parent: Dict[int, Dict] = {}
    for ev in events:
        t = ev.get("type")
        if t == "reclaim_plan":
            plans_by_parent[ev["parent"]] = ev
        elif t == "reclaim_step":
            steps_by_parent.setdefault(ev["parent"], []).append(ev)
        elif t == "slo_violation" and ev.get("parent") is not None:
            viol_by_parent[ev["parent"]] = ev
        elif t == "slo_recovery":
            recovery_by_parent[ev["parent"]] = ev

    chains: List[Dict] = []
    for ev in events:
        if ev.get("type") != "claim" or ev.get("deficit", 0) <= 0:
            continue
        if tenant is not None and ev["tenant"] != tenant:
            continue
        span = ev["span"]
        plan = plans_by_parent.get(span)
        steps = steps_by_parent.get(plan["span"], []) if plan else []
        chain = {
            "ts": ev["ts"], "tenant": ev["tenant"], "span": span,
            "requested": ev["requested"], "from_free": ev["from_free"],
            "granted": ev["granted"], "short": ev["short"],
            "engine": plan["engine"] if plan else None,
            "planned_victims": [s["victim"] for s in plan["steps"]]
            if plan else [],
            "drains": [{"victim": s["tenant"], "released": s["released"],
                        "granted": s["granted"]} for s in steps],
        }
        viol = viol_by_parent.get(span)
        if viol is not None:
            rec = recovery_by_parent.get(viol["span"])
            chain["shortfall_episode"] = {
                "start": viol["ts"],
                "recovered": rec is not None,
                "duration_s": rec["duration_s"] if rec else None,
            }
        chains.append(chain)
    return {"tenant": tenant, "forced_claims": len(chains),
            "chains": chains,
            "broken_chains": check_causal_chains(events)}


def diff_summaries(a: Dict, b: Dict) -> Dict:
    """Structural diff of two ``summarize_events`` outputs (analyzer
    ``diff`` and the ``regress`` gate): event-count deltas per type,
    reclaim-latency and SLO-duration shifts per tenant, spend deltas,
    never-recovered claim counts, and the fault ledger
    (failures/repairs/suppressions/drain deliveries)."""
    def num_delta(x, y):
        return {"a": x, "b": y, "delta": (y or 0) - (x or 0)}

    types = sorted(set(a.get("by_type", {})) | set(b.get("by_type", {})))
    out: Dict = {
        "events": num_delta(a.get("events", 0), b.get("events", 0)),
        "by_type": {t: num_delta(a.get("by_type", {}).get(t, 0),
                                 b.get("by_type", {}).get(t, 0))
                    for t in types},
    }
    la = a.get("reclaim_latency_s", {}).get("overall", {})
    lb = b.get("reclaim_latency_s", {}).get("overall", {})
    out["reclaim_latency_s"] = {
        k: num_delta(la.get(k, 0.0), lb.get(k, 0.0))
        for k in ("n", "p50", "p99", "max")}
    va, vb = a.get("slo_violations", {}), b.get("slo_violations", {})
    out["slo_violations"] = {
        name: {"count": num_delta(va.get(name, {}).get("count", 0),
                                  vb.get(name, {}).get("count", 0)),
               "p99_duration_s": num_delta(
                   va.get(name, {}).get("duration_s", {}).get("p99", 0.0),
                   vb.get(name, {}).get("duration_s", {}).get("p99", 0.0))}
        for name in sorted(set(va) | set(vb))}
    sa, sb = a.get("spend", {}), b.get("spend", {})
    out["spend"] = {
        name: {k: num_delta(sa.get(name, {}).get(k, 0.0),
                            sb.get(name, {}).get(k, 0.0))
               for k in ("idle", "reclaim")}
        for name in sorted(set(sa) | set(sb))}
    ua = a.get("reclaim_latency_s", {}).get("unrecovered", {})
    ub = b.get("reclaim_latency_s", {}).get("unrecovered", {})
    out["unrecovered"] = {
        name: num_delta(ua.get(name, 0), ub.get(name, 0))
        for name in sorted(set(ua) | set(ub))}
    fa, fb = a.get("faults", {}), b.get("faults", {})
    out["faults"] = {
        k: num_delta(fa.get(k, 0), fb.get(k, 0))
        for k in ("failures", "repairs", "unrepaired", "suppressed",
                  "drain_completes", "drained_nodes")}
    causes = sorted(set(fa.get("by_cause", {})) | set(fb.get("by_cause", {})))
    out["faults"]["by_cause"] = {
        c: num_delta(fa.get("by_cause", {}).get(c, 0),
                     fb.get("by_cause", {}).get(c, 0))
        for c in causes}
    return out


# ------------------------------------------------------- Perfetto export


def to_perfetto(events: List[Dict]) -> Dict:
    """Chrome trace-event JSON (loadable in Perfetto / chrome://tracing).

    Mapping: one process (pid 1); one thread per tenant (tid by first
    appearance) plus tid 0 for cluster-level events. Shortfall episodes
    render as duration slices ("X"), everything else as instant events
    ("i"), and ``metrics`` events as counter tracks ("C": free pool and
    per-tenant alloc/demand). Sim seconds map to trace microseconds.
    """
    tids: Dict[str, int] = {}

    def tid(name: Optional[str]) -> int:
        if name is None:
            return 0
        if name not in tids:
            tids[name] = len(tids) + 1
        return tids[name]

    def us(ts: float) -> float:
        return float(ts) * 1e6

    out: List[Dict] = []
    open_viol: Dict[int, Dict] = {}
    last_ts = 0.0
    for ev in events:
        t = ev.get("type")
        ts = float(ev.get("ts", 0.0))
        last_ts = max(last_ts, ts)
        if t in ("trace_header",):
            continue
        if t == "metrics":
            out.append({"ph": "C", "name": "free_nodes", "pid": 1, "tid": 0,
                        "ts": us(ts), "args": {"free": ev["free"]}})
            for name, m in ev["tenants"].items():
                out.append({"ph": "C", "name": f"nodes/{name}", "pid": 1,
                            "tid": 0, "ts": us(ts),
                            "args": {"alloc": m["alloc"],
                                     "demand": m["demand"]}})
                if m.get("spend"):
                    out.append({"ph": "C", "name": f"spend/{name}",
                                "pid": 1, "tid": 0, "ts": us(ts),
                                "args": {"spend": m["spend"]}})
            continue
        if t == "slo_violation":
            open_viol[ev["span"]] = ev
            continue
        if t == "slo_recovery":
            viol = open_viol.pop(ev.get("parent"), None)
            start = float(viol["ts"]) if viol else ts - ev["duration_s"]
            out.append({"ph": "X", "name": "slo_shortfall", "pid": 1,
                        "tid": tid(ev.get("tenant")), "ts": us(start),
                        "dur": us(ts - start),
                        "args": {"shortfall": viol["shortfall"]
                                 if viol else None,
                                 "duration_s": ev["duration_s"]}})
            continue
        args = {k: v for k, v in ev.items() if k not in ("type", "ts")}
        out.append({"ph": "i", "s": "t", "name": t, "pid": 1,
                    "tid": tid(ev.get("tenant")), "ts": us(ts),
                    "args": args})
    # episodes still open at trace end: emit slices to the last timestamp
    for viol in open_viol.values():
        out.append({"ph": "X", "name": "slo_shortfall (open)", "pid": 1,
                    "tid": tid(viol.get("tenant")), "ts": us(viol["ts"]),
                    "dur": us(max(0.0, last_ts - float(viol["ts"]))),
                    "args": {"shortfall": viol["shortfall"]}})
    meta = [{"ph": "M", "name": "process_name", "pid": 1,
             "args": {"name": "phoenix-control-plane"}},
            {"ph": "M", "name": "thread_name", "pid": 1, "tid": 0,
             "args": {"name": "cluster"}}]
    meta.extend({"ph": "M", "name": "thread_name", "pid": 1, "tid": v,
                 "args": {"name": k}} for k, v in sorted(
                     tids.items(), key=lambda kv: kv[1]))
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}
