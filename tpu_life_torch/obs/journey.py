"""Fleet trace fusion and the flight-recorder doctor.

The write half of distributed tracing (docs/OBSERVABILITY.md
"Distributed tracing") leaves a **capture directory** behind: per-worker
scrape files (``<name>.jsonl`` — one JSON scrape record per line, drained
from each worker's ``GET /v1/debug/trace`` by the supervisor's monitor
tick), the control plane's own ``control.jsonl``, and any per-incarnation
``*.trace.json`` files a gracefully-exiting worker wrote.  This module is
the read half:

- :func:`merge_captures` fuses a capture directory into ONE
  Perfetto-loadable Chrome-trace JSON: every worker incarnation becomes
  its own process track (synthetic pid + ``process_name`` metadata),
  span timestamps are re-anchored from each tracer's ``wall_t0`` through
  the scrape's handshake-estimated clock offset onto the collector
  clock, and flight events become ``flight.<kind>`` instant markers —
  so a migrated session's journey reads as one contiguous ``trace_id``
  across two worker tracks (``tpu-life trace merge``).
- :func:`doctor` reconstructs one session's causal timeline from a
  merged capture and machine-checks it: submit → rounds on w0 →
  injection → kill → migration → rounds on w1 → done, with **typed
  findings** (migrations, kills, spills) and **anomalies** (overlapping
  execution intervals on two incarnations — double execution — an
  unbounded migration gap, a journey with no terminal event)
  (``tpu-life doctor``).

Everything here is pure file/JSON work — no jax, no numpy — safe on a
login node against captures copied off a fleet host, like ``obs.stats``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

from tpu_life_torch.obs import flight

#: Wall-time slack (seconds) tolerated when comparing intervals from two
#: processes: the handshake offset estimate is bounded by half the scrape
#: round-trip, so sub-50 ms "overlaps" are clock noise, not double
#: execution.
CLOCK_SLACK_S = 0.05

#: Default bound on the kill -> resumed-on-survivor gap before the doctor
#: flags it: generous against CPU-reference recovery times (~2 s) while
#: still catching a migration that silently stalled.
DEFAULT_MAX_GAP_S = 60.0

_TRACE_FILE_RE = re.compile(r"(?P<worker>.+?)g(?P<gen>\d+)$")


# ---------------------------------------------------------------------------
# capture loading
# ---------------------------------------------------------------------------
def load_captures(path) -> list[dict]:
    """Read every scrape record under a capture directory.

    ``*.jsonl`` files hold one scrape record per line (the supervisor's
    drains); ``*.trace.json`` files are whole written Tracer files (a
    graceful worker exit's undrained tail), converted into one pseudo
    scrape record each — worker/generation parsed from the file stem
    (``w0g3.trace.json``), offset 0 (same-host write).  A torn FINAL
    jsonl line (a killed writer) is tolerated; torn middle lines raise,
    like ``obs.stats``.
    """
    root = Path(path)
    if not root.is_dir():
        raise FileNotFoundError(f"capture directory {root} does not exist")
    records: list[dict] = []
    for f in sorted(root.glob("*.jsonl")):
        lines = f.read_text().splitlines()
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break  # torn final line: the writer was killed mid-append
                raise ValueError(f"{f}:{i + 1}: corrupt capture line") from None
            if isinstance(rec, dict):
                records.append(rec)
    for f in sorted(root.glob("*.trace.json")):
        try:
            doc = json.loads(f.read_text())
        except json.JSONDecodeError:
            continue  # a file torn by a mid-write kill: the scrapes have the rest
        other = doc.get("otherData") or {}
        if other.get("merged"):
            # a previous merge's own output (the CLI default lands in
            # this directory): not a capture source — re-merging it
            # would mint a phantom incarnation and double the file
            continue
        stem = f.name[: -len(".trace.json")]
        m = _TRACE_FILE_RE.fullmatch(stem)
        records.append(
            {
                "worker": m.group("worker") if m else stem,
                "generation": int(m.group("gen")) if m else 0,
                "pid": other.get("pid"),
                "run_id": other.get("run_id"),
                "wall_t0": other.get("wall_t0"),
                "offset_s": 0.0,
                "dropped": other.get("dropped", 0),
                "events": doc.get("traceEvents") or [],
                "flight": [],
            }
        )
    return records


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------
def merge_records(records: list[dict]) -> dict:
    """Fuse scrape records into one Perfetto-loadable Chrome-trace doc.

    Each ``(worker, generation)`` incarnation gets a synthetic pid and a
    ``process_name`` metadata event; every timestamp is re-anchored onto
    the collector clock (``wall_t0 - offset_s`` maps a tracer's ts=0 to
    collector epoch) and then rebased so the merged timeline starts at 0.
    """
    # incarnation -> synthetic pid (stable: sorted by first appearance,
    # control first so the routing track leads the view)
    incarnations: dict[tuple, dict] = {}
    for rec in records:
        key = (str(rec.get("worker", "?")), int(rec.get("generation", 0)))
        info = incarnations.setdefault(
            key, {"pid": None, "run_id": rec.get("run_id"), "dropped": 0.0}
        )
        # the tracer's dropped counter is CUMULATIVE and repeated on
        # every scrape record — the incarnation's true loss is the
        # newest (max) value, never the sum across scrapes
        info["dropped"] = max(info["dropped"], float(rec.get("dropped") or 0))
        if info["run_id"] is None:
            info["run_id"] = rec.get("run_id")
    order = sorted(incarnations, key=lambda k: (k[0] != "control", k))
    for i, key in enumerate(order, start=1):
        incarnations[key]["pid"] = i

    out_events: list[dict] = []
    t_min: float | None = None

    def epoch_us(rec: dict, ev_ts_us: float) -> float | None:
        wall_t0 = rec.get("wall_t0")
        if wall_t0 is None:
            return None
        return (float(wall_t0) - float(rec.get("offset_s") or 0.0)) * 1e6 + ev_ts_us

    staged: list[tuple[float, dict]] = []
    for rec in records:
        key = (str(rec.get("worker", "?")), int(rec.get("generation", 0)))
        pid = incarnations[key]["pid"]
        for ev in rec.get("events") or []:
            if not isinstance(ev, dict) or "ts" not in ev:
                continue
            t = epoch_us(rec, float(ev["ts"]))
            if t is None:
                continue  # a span with no wall anchor cannot be placed
            e = dict(ev)
            e["pid"] = pid
            if "dur" in e:
                e["dur"] = float(e["dur"])
            staged.append((t, e))
            t_min = t if t_min is None else min(t_min, t)
        for ev in rec.get("flight") or []:
            if not isinstance(ev, dict) or "t" not in ev:
                continue
            t = (float(ev["t"]) - float(rec.get("offset_s") or 0.0)) * 1e6
            staged.append((t, flight.as_instant(ev, pid=pid, ts=t)))
            t_min = t if t_min is None else min(t_min, t)
    t0 = t_min or 0.0
    for t, e in sorted(staged, key=lambda x: x[0]):
        e["ts"] = t - t0
        out_events.append(e)
    meta_events = []
    workers_meta = {}
    for (worker, gen), info in incarnations.items():
        label = f"{worker} g{gen}" if worker != "control" else "control"
        meta_events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": info["pid"],
                "args": {"name": label},
            }
        )
        workers_meta[str(info["pid"])] = {
            "worker": worker,
            "generation": gen,
            "run_id": info["run_id"],
            "dropped": info["dropped"],
        }
    return {
        "traceEvents": meta_events + out_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "merged": True,
            "t0_epoch_s": t0 / 1e6,
            "workers": workers_meta,
        },
    }


def merge_captures(path) -> dict:
    """``load_captures`` + ``merge_records`` for a capture directory."""
    return merge_records(load_captures(path))


# ---------------------------------------------------------------------------
# the doctor
# ---------------------------------------------------------------------------
def _incarnation_of(doc: dict, pid) -> tuple[str, int]:
    meta = (doc.get("otherData") or {}).get("workers") or {}
    info = meta.get(str(pid)) or {}
    return str(info.get("worker", f"pid{pid}")), int(info.get("generation", 0))


def resolve_trace_id(doc: dict, sid: str) -> str | None:
    """Find the trace id a session id belongs to: the router's
    ``flight.route.submit`` pin event for a fleet sid, else any event
    stamped with both this sid and a trace id (a worker-local sid)."""
    fallback = None
    for ev in doc.get("traceEvents", []):
        args = ev.get("args")
        if not isinstance(args, dict):
            continue
        tid = args.get("trace_id")
        if not tid:
            continue
        if ev.get("name") == "flight.route.submit" and args.get("sid") == sid:
            return tid
        if fallback is None and sid in (
            args.get("sid"),
            args.get("worker_sid"),
            ev.get("id"),
        ):
            fallback = tid
    return fallback


def doctor(
    doc: dict,
    *,
    sid: str | None = None,
    trace_id: str | None = None,
    max_gap_s: float = DEFAULT_MAX_GAP_S,
) -> dict:
    """Reconstruct (and machine-check) one session's cross-process
    journey from a merged capture.

    Returns a report dict: ``ok`` (no anomalies), the ordered
    ``journey`` event list, typed ``findings`` (informational:
    migrations, worker exits, spill recovery points), and ``anomalies``
    (invariant violations: ``double_execution`` — two incarnations
    executing the sid at overlapping wall times beyond clock slack,
    ``migration_gap_exceeded``, ``no_terminal``, ``unknown_sid``).
    """
    report: dict = {
        "sid": sid,
        "trace_id": trace_id,
        "journey": [],
        "findings": [],
        "anomalies": [],
        "incarnations": [],
        "outcome": None,
    }
    if trace_id is None:
        if sid is None:
            raise ValueError("doctor needs a --sid or a --trace-id")
        trace_id = resolve_trace_id(doc, sid)
        if trace_id is None:
            report["anomalies"].append(
                {
                    "kind": "unknown_sid",
                    "detail": f"no event in the capture names sid {sid!r}",
                }
            )
            report["ok"] = False
            return report
        report["trace_id"] = trace_id

    events = [
        ev
        for ev in doc.get("traceEvents", [])
        if isinstance(ev.get("args"), dict)
        and ev["args"].get("trace_id") == trace_id
        and "ts" in ev
    ]
    events.sort(key=lambda e: float(e["ts"]))
    incs = []  # insertion-ordered (worker, gen) of the journey
    for ev in events:
        key = _incarnation_of(doc, ev.get("pid"))
        if key not in incs:
            incs.append(key)
    # kill markers of the incarnations this journey touched: they carry
    # no trace_id (the death is about the process), so they join by
    # incarnation — the left edge of a migration gap.  A local worker's
    # death is flight.worker.exit; a wire-registered worker has no
    # process to reap, so its death marker is flight.lease.expired.
    exits: dict[tuple[str, int], float] = {}
    for ev in doc.get("traceEvents", []):
        args = ev.get("args")
        if ev.get("name") not in (
            "flight.worker.exit", "flight.lease.expired"
        ) or not isinstance(args, dict):
            continue
        key = (str(args.get("worker")), int(args.get("generation", 0)))
        if key in incs and "ts" in ev:
            exits[key] = float(ev["ts"])

    def entry(ev, key):
        worker, gen = key
        return {
            "t_s": round(float(ev["ts"]) / 1e6, 6),
            "worker": worker,
            "generation": gen,
            "name": ev.get("name"),
            "ph": ev.get("ph"),
            "args": {
                k: v for k, v in ev["args"].items() if k != "trace_id"
            },
        }

    # per-incarnation execution intervals from the serve.exec async pairs
    intervals: dict[tuple, list[list]] = {}
    for ev in events:
        key = _incarnation_of(doc, ev.get("pid"))
        report["journey"].append(entry(ev, key))
        if ev.get("name") != "serve.exec":
            continue
        spans = intervals.setdefault(key, [])
        ts = float(ev["ts"])
        if ev.get("ph") == "b":
            spans.append([ts, None, None])
        elif ev.get("ph") == "e" and spans:
            for span in reversed(spans):
                if span[1] is None:
                    span[1] = ts
                    span[2] = ev["args"].get("outcome")
                    break
    # close open intervals at the incarnation's exit (SIGKILL: the end
    # event died with the worker) or its last observed journey event
    flat: list[tuple[float, float, tuple, str | None, bool]] = []
    for key, spans in intervals.items():
        last_seen = max(
            (float(e["ts"]) for e in events
             if _incarnation_of(doc, e.get("pid")) == key),
            default=0.0,
        )
        for begin, end, outcome in spans:
            open_ended = end is None
            if open_ended:
                end = exits.get(key, last_seen)
                end = max(end, begin)
            flat.append((begin, end, key, outcome, open_ended))
    flat.sort()
    report["incarnations"] = [
        {"worker": k[0], "generation": k[1]} for k in incs
    ]

    # -- invariants ---------------------------------------------------------
    slack_us = CLOCK_SLACK_S * 1e6
    for i in range(len(flat)):
        for j in range(i + 1, len(flat)):
            b1, e1, k1, _, _ = flat[i]
            b2, e2, k2, _, _ = flat[j]
            if k1 == k2:
                continue  # same process: salvage re-begins nest legally
            overlap = min(e1, e2) - max(b1, b2)
            if overlap > slack_us:
                report["anomalies"].append(
                    {
                        "kind": "double_execution",
                        "detail": (
                            f"{k1[0]} g{k1[1]} and {k2[0]} g{k2[1]} both "
                            f"executed this session for "
                            f"{overlap / 1e6:.3f}s of wall time"
                        ),
                        "overlap_s": overlap / 1e6,
                    }
                )
    # migration findings + gap bound: consecutive intervals on DIFFERENT
    # incarnations
    for a, b in zip(flat, flat[1:]):
        if a[2] == b[2]:
            continue
        gap_s = max(0.0, (b[0] - a[1]) / 1e6)
        finding = {
            "kind": "migration",
            "from": f"{a[2][0]} g{a[2][1]}",
            "to": f"{b[2][0]} g{b[2][1]}",
            "gap_s": round(gap_s, 3),
        }
        report["findings"].append(finding)
        if gap_s > max_gap_s:
            report["anomalies"].append(
                {
                    "kind": "migration_gap_exceeded",
                    "detail": (
                        f"{gap_s:.1f}s between the last event on "
                        f"{a[2][0]} g{a[2][1]} and resumption on "
                        f"{b[2][0]} g{b[2][1]} (bound {max_gap_s}s)"
                    ),
                    "gap_s": round(gap_s, 3),
                }
            )
    for key, ts in sorted(exits.items(), key=lambda kv: kv[1]):
        report["findings"].append(
            {
                "kind": "worker_exit",
                "worker": key[0],
                "generation": key[1],
                "t_s": round(ts / 1e6, 6),
            }
        )
    spills = [e for e in events if e.get("name") == "serve.session.spill"]
    if spills:
        report["findings"].append(
            {
                "kind": "spill",
                "count": len(spills),
                "last_step": spills[-1]["args"].get("step"),
            }
        )
    injections = [
        e for e in events if e.get("name") == "chaos.injection"
    ]
    for e in injections:
        report["findings"].append(
            {
                "kind": "injection",
                "point": e["args"].get("point"),
                "decision": e["args"].get("decision"),
                "t_s": round(float(e["ts"]) / 1e6, 6),
            }
        )
    # terminal outcome: the last exec end's outcome, or a flight.terminal
    outcome = None
    for ev in reversed(events):
        if ev.get("name") == "flight.terminal":
            outcome = ev["args"].get("outcome")
            break
        if ev.get("name") == "serve.exec" and ev.get("ph") == "e":
            outcome = ev["args"].get("outcome")
            break
    report["outcome"] = outcome
    if not events:
        report["anomalies"].append(
            {
                "kind": "unknown_sid",
                "detail": f"no events carry trace_id {trace_id!r}",
            }
        )
    elif outcome is None:
        report["anomalies"].append(
            {
                "kind": "no_terminal",
                "detail": "the journey never reached a terminal event "
                "(still in flight at capture time, or the terminal "
                "events were lost)",
            }
        )
    report["ok"] = not report["anomalies"]
    return report


def load_merged(path) -> dict:
    """A doctor input: a merged (or single-tracer) trace file, or a
    capture directory (merged in memory)."""
    p = Path(path)
    if p.is_dir():
        return merge_captures(p)
    doc = json.loads(p.read_text())
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{p} is not a Chrome-trace JSON document")
    if not (doc.get("otherData") or {}).get("merged"):
        # a single written tracer file: wrap it as a one-process capture
        # so the doctor's incarnation logic has a workers table
        other = doc.get("otherData") or {}
        pids = {
            ev.get("pid")
            for ev in doc.get("traceEvents", [])
            if isinstance(ev, dict) and "pid" in ev
        }
        doc.setdefault("otherData", other)["workers"] = {
            str(pid): {
                "worker": "local",
                "generation": 0,
                "run_id": other.get("run_id"),
                "dropped": other.get("dropped", 0),
            }
            for pid in pids
        }
    return doc


def render_report(report: dict) -> str:
    """The human doctor output: the journey as one line per event plus
    the findings/anomalies verdict."""
    lines = []
    lines.append(
        f"journey of sid={report.get('sid')} trace_id={report.get('trace_id')}"
    )
    for e in report["journey"]:
        args = e.get("args") or {}
        detail = " ".join(
            f"{k}={v}" for k, v in args.items() if v is not None
        )
        ph = e.get("ph")
        tag = {"b": "begin", "e": "end"}.get(ph, "")
        lines.append(
            f"  {e['t_s']:>10.3f}s  {e['worker']:>8} g{e['generation']}  "
            f"{e['name']} {tag} {detail}".rstrip()
        )
    for f in report["findings"]:
        lines.append(f"finding: {json.dumps(f, sort_keys=True)}")
    for a in report["anomalies"]:
        lines.append(f"ANOMALY: {json.dumps(a, sort_keys=True)}")
    lines.append(
        f"verdict: {'OK' if report.get('ok') else 'ANOMALOUS'} "
        f"(outcome={report.get('outcome')}, "
        f"{len(report['findings'])} finding(s), "
        f"{len(report['anomalies'])} anomaly(ies))"
    )
    return "\n".join(lines)
