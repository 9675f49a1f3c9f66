"""The read-back toolchain: metrics JSONL in, summary out.

The sink files the runtime writes (``run --metrics-file``, ``serve
--metrics-file``) were append-only artifacts nothing in the repo could
read back; ``tpu-life stats`` closes the loop.  It ingests one JSONL file
— any mix of per-chunk run records (``step`` / ``steps_per_sec``),
per-round serve records (``kind: "serve"``) and end-of-run registry
snapshots (``kind: "metric"``) — and reports the aggregates a human (or
``--json``, a machine) asks first: step and cell throughput, histogram
quantiles (p50/p95/p99), batch occupancy, admission rejection rate.

Quantiles prefer the precomputed ``p50/p95/p99`` fields a snapshot record
carries; a record without them (hand-written, older schema) falls back to
re-deriving from its bucket counts with the same interpolation rule as
:meth:`tpu_life_torch.obs.registry.Histogram.quantile`.
"""

from __future__ import annotations

import json
from pathlib import Path


def load_records(path: str) -> list[dict]:
    """Parse a metrics JSONL file (blank lines and ``#`` comments skipped);
    a malformed line raises with its line number — a truncated tail line
    from a killed run is the one exception, tolerated with a warning field
    left to the caller (it is the expected artifact of a mid-write kill)."""
    records: list[dict] = []
    lines = Path(path).read_text().splitlines()
    for lineno, line in enumerate(lines, 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError as e:
            if lineno == len(lines):
                break  # torn final line: a killed writer, not a bad file
            raise ValueError(f"{path}:{lineno}: bad metrics line: {e}") from e
    return records


def _quantile_from_buckets(rec: dict, q: float) -> float | None:
    """Re-derive a quantile from a snapshot record's bucket counts —
    the fallback when the precomputed field is absent."""
    count = rec.get("count", 0)
    if not count:
        return None
    finite = sorted(
        (float(b), c) for b, c in rec.get("buckets", {}).items() if b != "+Inf"
    )
    rank = q * count
    cum = 0
    lo = 0.0
    lo_clamp = rec.get("min", 0.0) or 0.0
    hi_clamp = rec.get("max")
    for hi, c in finite:
        if c:
            if cum + c >= rank:
                est = lo + (hi - lo) * (rank - cum) / c
                est = max(est, lo_clamp)
                return min(est, hi_clamp) if hi_clamp is not None else est
            cum += c
        lo = hi
    return hi_clamp


def hist_quantiles(rec: dict) -> dict:
    """{"p50", "p95", "p99"} of a histogram snapshot record."""
    out = {}
    for name, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
        v = rec.get(name)
        out[name] = v if v is not None else _quantile_from_buckets(rec, q)
    return out


def _labels_id(labels: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def _labels_from_id(labels_id: str) -> dict:
    """Invert :func:`_labels_id` — the tenant families carry two labels,
    so the single-label ``partition`` trick the older families use is
    not enough."""
    out: dict = {}
    for part in labels_id.split(","):
        if "=" in part:
            k, _, v = part.partition("=")
            out[k] = v
    return out


def _group_by_run(records: list[dict]) -> dict:
    """Records bucketed by ``run_id`` (insertion-ordered; None = unstamped)."""
    groups: dict = {}
    for r in records:
        groups.setdefault(r.get("run_id"), []).append(r)
    return groups


def _run_summary(chunks: list[dict]) -> dict:
    last = chunks[-1]
    rates = [r["steps_per_sec"] for r in chunks if r.get("steps_per_sec")]
    cell_rates = [
        r["cell_updates_per_sec"]
        for r in chunks
        if r.get("cell_updates_per_sec")
    ]
    return {
        "chunks": len(chunks),
        "final_step": last["step"],
        "elapsed_s": last.get("elapsed_s"),
        # the per-chunk steps_per_sec is cumulative (done / elapsed), so
        # the final record IS the whole-run average; max is the best
        # window the run ever sustained
        "steps_per_sec": last.get("steps_per_sec"),
        "steps_per_sec_max": max(rates) if rates else 0.0,
        "cell_updates_per_sec": last.get("cell_updates_per_sec"),
        "cell_updates_per_sec_max": max(cell_rates) if cell_rates else 0.0,
        "live_cells_final": last.get("live_cells"),
    }


def _serve_summary(rounds: list[dict]) -> dict:
    last = rounds[-1]
    occ = [r.get("batch_occupancy", 0.0) for r in rounds]
    out = {
        "rounds": len(rounds),
        "elapsed_s": last.get("elapsed_s"),
        "sessions_done": last.get("sessions_done"),
        "sessions_per_sec": last.get("sessions_per_sec"),
        "steps_advanced": sum(r.get("steps_advanced", 0) for r in rounds),
        "admitted": sum(r.get("admitted", 0) for r in rounds),
        "completed": sum(r.get("completed", 0) for r in rounds),
        "failed": sum(r.get("failed", 0) for r in rounds),
        "batch_occupancy_mean": sum(occ) / len(occ),
        "queue_depth_max": max(r.get("queue_depth", 0) for r in rounds),
    }
    # the pipelined-pump stamps — only when the sink carries
    # them, so summaries of pre-pipeline sinks are byte-stable
    if "pump" in last:
        out["pump"] = last["pump"]
    if any("device_idle_s" in r for r in rounds):
        idle = last.get("device_idle_s") or 0.0
        elapsed = last.get("elapsed_s") or 0.0
        out["device_idle_seconds"] = idle
        out["device_idle_fraction"] = idle / elapsed if elapsed > 0 else 0.0
    if any("pipeline_depth" in r for r in rounds):
        out["pipeline_depth_max"] = max(
            r.get("pipeline_depth", 0) for r in rounds
        )
    # the durability stamps — present only when the run spilled
    if any("snapshot_s" in r for r in rounds):
        # snapshot_s is cumulative like device_idle_s: the last record is
        # the run total; spilled_sessions is a gauge, so max is the peak
        # number of sessions resumable at once
        out["snapshot_seconds"] = last.get("snapshot_s") or 0.0
        out["spilled_sessions_max"] = max(
            r.get("spilled_sessions", 0) for r in rounds
        )
    # storage-path attribution: the slice of stepped work run
    # by bitplane-packed stochastic engines — only when the sink carries
    # the stamp, so pre-packed sinks summarize byte-stable
    if any("steps_advanced_packed" in r for r in rounds):
        packed = sum(r.get("steps_advanced_packed", 0) for r in rounds)
        out["steps_advanced_packed"] = packed
        total = out["steps_advanced"]
        out["packed_steps_fraction"] = packed / total if total else 0.0
    # the governor stamp: chunk faults masked by in-place
    # engine recovery — only when the sink carries it (newer runtimes)
    if any("engine_recoveries" in r for r in rounds):
        out["engine_recoveries"] = sum(
            r.get("engine_recoveries", 0) for r in rounds
        )
    # the stencil stamp: live matmul-path engines (a gauge —
    # the last record is the run's final view) and each CompileKey's
    # resolved counting path, union'd across the run's rounds — only
    # when the sink carries them, so older sinks summarize byte-stable
    if any("matmul_keys" in r for r in rounds):
        out["matmul_keys"] = last.get("matmul_keys", 0)
        stencil_keys: dict = {}
        for r in rounds:
            stencil_keys.update(r.get("stencil_keys") or {})
        out["stencil_keys"] = stencil_keys
    # the mega-board stamp: live mesh-placed sessions (a
    # gauge — the last record is the run's final view, max the peak
    # concurrent count) — only when the sink carries it, so mesh-less
    # sinks summarize byte-stable
    if any("mesh_sessions" in r for r in rounds):
        out["mesh_sessions"] = last.get("mesh_sessions", 0)
        out["mesh_sessions_max"] = max(
            r.get("mesh_sessions", 0) for r in rounds
        )
    # the live-session stamps: frames/gaps are cumulative
    # counters (max = the final reading, robust to a tail round that
    # dropped the gated stamp), watchers is a gauge (max = the peak) —
    # only when the sink carries them, so unstreamed runs stay byte-stable
    if any("stream_frames_total" in r for r in rounds):
        out["stream_frames_total"] = max(
            r.get("stream_frames_total", 0) for r in rounds
        )
        out["stream_frame_gaps_total"] = max(
            r.get("stream_frame_gaps_total", 0) for r in rounds
        )
        out["stream_watchers"] = max(
            r.get("stream_watchers", 0) for r in rounds
        )
    return out


def _merge_serve(per_run: dict) -> dict:
    """Combine per-run serve summaries into one fleet-level view: counts
    and rates sum (the workers ran concurrently), elapsed is the longest
    worker's wall clock, occupancy is the round-weighted mean."""
    summaries = list(per_run.values())
    total_rounds = sum(s["rounds"] for s in summaries)
    merged = {
        "rounds": total_rounds,
        "elapsed_s": max((s.get("elapsed_s") or 0.0) for s in summaries),
        "sessions_done": sum(s.get("sessions_done") or 0 for s in summaries),
        "sessions_per_sec": sum(
            s.get("sessions_per_sec") or 0.0 for s in summaries
        ),
        "steps_advanced": sum(s["steps_advanced"] for s in summaries),
        "admitted": sum(s["admitted"] for s in summaries),
        "completed": sum(s["completed"] for s in summaries),
        "failed": sum(s["failed"] for s in summaries),
        "batch_occupancy_mean": (
            sum(s["batch_occupancy_mean"] * s["rounds"] for s in summaries)
            / total_rounds
            if total_rounds
            else 0.0
        ),
        "queue_depth_max": max(s["queue_depth_max"] for s in summaries),
        "runs_merged": len(summaries),
    }
    # device-idle merges like the counts: seconds sum across workers, the
    # fraction renormalizes over their combined wall time (workers ran
    # concurrently, so per-worker fractions are what each chip wasted)
    idles = [
        s["device_idle_seconds"] for s in summaries
        if "device_idle_seconds" in s
    ]
    if idles:
        merged["device_idle_seconds"] = sum(idles)
        total_elapsed = sum(
            s.get("elapsed_s") or 0.0
            for s in summaries
            if "device_idle_seconds" in s
        )
        merged["device_idle_fraction"] = (
            sum(idles) / total_elapsed if total_elapsed > 0 else 0.0
        )
    depths = [
        s["pipeline_depth_max"] for s in summaries
        if "pipeline_depth_max" in s
    ]
    if depths:
        merged["pipeline_depth_max"] = max(depths)
    # durability merges like the idle metrics: spill seconds sum across
    # workers, the peak resumable-session gauge maxes
    snaps = [s["snapshot_seconds"] for s in summaries if "snapshot_seconds" in s]
    if snaps:
        merged["snapshot_seconds"] = sum(snaps)
        merged["spilled_sessions_max"] = max(
            s.get("spilled_sessions_max", 0) for s in summaries
        )
    # masked chunk faults sum like the counts they are
    recoveries = [
        s["engine_recoveries"] for s in summaries
        if "engine_recoveries" in s
    ]
    if recoveries:
        merged["engine_recoveries"] = sum(recoveries)
    # packed attribution sums like the step counts it slices
    packed = [
        s["steps_advanced_packed"] for s in summaries
        if "steps_advanced_packed" in s
    ]
    if packed:
        merged["steps_advanced_packed"] = sum(packed)
        merged["packed_steps_fraction"] = (
            sum(packed) / merged["steps_advanced"]
            if merged["steps_advanced"]
            else 0.0
        )
    # the stencil stamp merges like the fleet's live-engine view:
    # matmul-key gauges sum across concurrent workers, the per-key path
    # maps union (workers of one fleet resolve each key identically)
    matmul = [s["matmul_keys"] for s in summaries if "matmul_keys" in s]
    if matmul:
        merged["matmul_keys"] = sum(matmul)
        stencil_keys: dict = {}
        for s in summaries:
            stencil_keys.update(s.get("stencil_keys") or {})
        merged["stencil_keys"] = stencil_keys
    # mesh-session gauges sum like the fleet's other live-engine views
    # (concurrent workers each held that many mega-boards at once)
    mesh = [s["mesh_sessions"] for s in summaries if "mesh_sessions" in s]
    if mesh:
        merged["mesh_sessions"] = sum(mesh)
        merged["mesh_sessions_max"] = sum(
            s.get("mesh_sessions_max", 0) for s in summaries
        )
    # streaming merges like the counts: frames and gaps sum across the
    # fleet's workers, watcher peaks sum too (concurrent workers each
    # held that many watchers at once)
    frames = [
        s["stream_frames_total"] for s in summaries
        if "stream_frames_total" in s
    ]
    if frames:
        merged["stream_frames_total"] = sum(frames)
        merged["stream_frame_gaps_total"] = sum(
            s.get("stream_frame_gaps_total", 0) for s in summaries
        )
        merged["stream_watchers"] = sum(
            s.get("stream_watchers", 0) for s in summaries
        )
    return merged


def summarize(records: list[dict]) -> dict:
    """The summary dict behind both output modes of ``tpu-life stats``.

    Records from a single run keep the classic shape.  Records carrying
    *multiple* run_ids — a fleet's per-worker sinks read back together —
    are grouped by run_id: the ``serve`` section becomes the fleet-level
    merge (counts sum, occupancy is round-weighted) and ``runs`` carries
    each worker's own summary keyed by its run_id.
    """
    chunks = [r for r in records if "step" in r and "kind" not in r]
    rounds = [r for r in records if r.get("kind") == "serve"]
    metrics = [r for r in records if r.get("kind") == "metric"]

    summary: dict = {
        "records": len(records),
        "run_ids": sorted({r["run_id"] for r in records if r.get("run_id")}),
    }

    if chunks:
        groups = _group_by_run(chunks)
        if len(groups) == 1:
            summary["run"] = _run_summary(chunks)
        else:
            for rid, g in groups.items():
                summary.setdefault("runs", {}).setdefault(rid or "<none>", {})[
                    "run"
                ] = _run_summary(g)

    if rounds:
        groups = _group_by_run(rounds)
        per_run = {rid or "<none>": _serve_summary(g) for rid, g in groups.items()}
        if len(per_run) == 1:
            summary["serve"] = next(iter(per_run.values()))
        else:
            summary["serve"] = _merge_serve(per_run)
            for rid, s in per_run.items():
                summary.setdefault("runs", {}).setdefault(rid, {})["serve"] = s

    if metrics:
        summary["metrics"] = []
        counters = {}
        devices_by_worker: dict = {}
        budget_by_worker: dict = {}
        for rec in metrics:
            if rec["metric"] == "serve_memory_budget_bytes" and rec.get("value"):
                # same keying rule as serve_devices below: per sink (a
                # worker's file spans its restarts — per-run_id summing
                # would double-count dead generations), last snapshot wins
                budget_by_worker[
                    rec.get("_sink", rec.get("run_id"))
                ] = rec["value"]
            if rec["metric"] == "serve_devices" and rec.get("value"):
                # keyed by SINK when the loader stamped one (a fleet
                # worker's file spans its restarts, each generation a
                # fresh run_id — summing per run_id would double-count
                # the dead generations' chips), else by run_id; either
                # way the LAST snapshot per key wins (the live one)
                devices_by_worker[
                    rec.get("_sink", rec.get("run_id"))
                ] = rec["value"]
            entry = {
                "metric": rec["metric"],
                "type": rec["type"],
                "labels": rec.get("labels", {}),
            }
            if len(summary["run_ids"]) > 1 and rec.get("run_id"):
                # merged sinks: the same metric arrives once per worker —
                # keep them distinguishable in the report
                entry["run_id"] = rec["run_id"]
            if rec["type"] == "histogram":
                entry.update(
                    count=rec.get("count"),
                    sum=rec.get("sum"),
                    min=rec.get("min"),
                    max=rec.get("max"),
                    **hist_quantiles(rec),
                )
            else:
                entry["value"] = rec.get("value")
                # keyed per run_id too: two workers' identical counters
                # must SUM below, not overwrite each other
                counters[
                    (
                        rec["metric"],
                        _labels_id(rec.get("labels", {})),
                        rec.get("run_id"),
                    )
                ] = rec.get("value") or 0.0
            summary["metrics"].append(entry)
        # admission rejection rate: rejected / offered, when both counters
        # are present in the snapshot
        rejected = sum(
            v for (name, _, _), v in counters.items()
            if name == "serve_admission_rejections_total"
        )
        submitted = sum(
            v for (name, _, _), v in counters.items()
            if name == "serve_sessions_submitted_total"
        )
        if submitted or rejected:
            summary.setdefault("serve", {})["rejection_rate"] = (
                rejected / (submitted + rejected) if (submitted + rejected) else 0.0
            )
        # the governor families: in-place recoveries by ladder
        # outcome and typed admission rejections by reason — summed across
        # workers (fleet sinks), keyed by their one label
        for family, out_key in (
            ("serve_engine_recoveries_total", "engine_recoveries_by_outcome"),
            ("serve_admission_rejected_total", "admission_rejected_by_reason"),
            # the fan-out tier's typed sheds, by reason
            ("watcher_shed_total", "watcher_shed_by_reason"),
        ):
            by_label: dict = {}
            for (name, labels_id, _), v in counters.items():
                if name != family or not v:
                    continue
                label = labels_id.partition("=")[2] or "<none>"
                by_label[label] = by_label.get(label, 0.0) + v
            if by_label:
                summary.setdefault("serve", {})[out_key] = by_label
        # the tenant families: per-tenant live sessions (a
        # gauge — concurrent workers each held that many, so the fleet
        # sums) and typed sheds keyed (tenant, reason), summed across
        # workers; absent families leave older sinks byte-stable
        tenant_sessions: dict = {}
        tenant_sheds: dict = {}
        for (name, labels_id, _), v in counters.items():
            if not v:
                continue
            labels = _labels_from_id(labels_id)
            if name == "serve_tenant_sessions":
                t = labels.get("tenant", "<none>")
                tenant_sessions[t] = tenant_sessions.get(t, 0.0) + v
            elif name == "tenant_shed_total":
                key = (labels.get("tenant", "<none>"),
                       labels.get("reason", "<none>"))
                tenant_sheds[key] = tenant_sheds.get(key, 0.0) + v
        if tenant_sessions or tenant_sheds:
            tenants: dict = {}
            for t, v in tenant_sessions.items():
                tenants.setdefault(t, {})["sessions"] = v
            for (t, reason), v in tenant_sheds.items():
                tenants.setdefault(t, {}).setdefault("sheds", {})[reason] = v
            summary.setdefault("serve", {})["tenants"] = {
                t: tenants[t] for t in sorted(tenants)
            }
        if budget_by_worker:
            # fleet budget = sum of the workers' budgets (each governs
            # its own engines); a single sink reports its own value
            summary.setdefault("serve", {})["memory_budget_bytes"] = int(
                sum(budget_by_worker.values())
            )
        if devices_by_worker:
            # the fleet's aggregate device count: each worker snapshot
            # carries its own resolved serve_devices gauge, and the
            # workers ran concurrently, so the fleet owns the sum.
            # CAVEAT: the sum assumes DISJOINT device slices (placement
            # auto); sinks carry no placement record, so shared-env
            # workers (placement none) co-claiming one device set are
            # counted once each — the router's /healthz devices_total is
            # the authoritative number in that mode (docs/FLEET.md)
            summary.setdefault("serve", {})["devices_total"] = int(
                sum(devices_by_worker.values())
            )

    return summary


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1e5 or 0 < abs(v) < 1e-3:
            return f"{v:.3e}"
        return f"{v:.4g}"
    return str(v)


def render(summary: dict) -> str:
    """The human table (``--json`` bypasses this)."""
    lines: list[str] = []
    rid = summary.get("run_ids") or []
    lines.append(
        f"metrics summary — {summary['records']} records, "
        f"run_id {', '.join(rid) if rid else '<none>'}"
    )
    run = summary.get("run")
    if run:
        lines.append("run:")
        lines.append(
            f"  chunks={run['chunks']}  final_step={run['final_step']}  "
            f"elapsed_s={_fmt(run['elapsed_s'])}"
        )
        lines.append(
            f"  steps/s={_fmt(run['steps_per_sec'])} "
            f"(max {_fmt(run['steps_per_sec_max'])})  "
            f"cells/s={_fmt(run['cell_updates_per_sec'])} "
            f"(max {_fmt(run['cell_updates_per_sec_max'])})"
        )
    serve = summary.get("serve")
    if serve:
        lines.append("serve:")
        if "rounds" in serve:
            lines.append(
                f"  rounds={serve['rounds']}  done={_fmt(serve.get('sessions_done'))}  "
                f"sessions/s={_fmt(serve.get('sessions_per_sec'))}  "
                f"occupancy={_fmt(serve.get('batch_occupancy_mean'))}  "
                f"queue_depth_max={_fmt(serve.get('queue_depth_max'))}"
            )
        if "device_idle_seconds" in serve:
            pump = serve.get("pump")
            lines.append(
                f"  device_idle_s={_fmt(serve['device_idle_seconds'])}  "
                f"idle_fraction={_fmt(serve.get('device_idle_fraction'))}  "
                f"pipeline_depth_max={_fmt(serve.get('pipeline_depth_max'))}"
                + (f"  pump={pump}" if pump else "")
            )
        if "snapshot_seconds" in serve:
            lines.append(
                f"  snapshot_s={_fmt(serve['snapshot_seconds'])}  "
                f"spilled_sessions_max={_fmt(serve.get('spilled_sessions_max'))}"
            )
        if "matmul_keys" in serve:
            paths = serve.get("stencil_keys") or {}
            lines.append(
                f"  matmul_keys={_fmt(serve['matmul_keys'])}  "
                + " ".join(
                    f"{k}:{v}" for k, v in sorted(paths.items())
                )
            )
        if "mesh_sessions" in serve:
            lines.append(
                f"  mesh_sessions={_fmt(serve['mesh_sessions'])} "
                f"(max {_fmt(serve.get('mesh_sessions_max'))})"
            )
        if "steps_advanced_packed" in serve:
            lines.append(
                f"  packed_steps={_fmt(serve['steps_advanced_packed'])}  "
                f"packed_fraction={_fmt(serve.get('packed_steps_fraction'))}"
            )
        if "rejection_rate" in serve:
            lines.append(f"  rejection_rate={_fmt(serve['rejection_rate'])}")
        if "engine_recoveries" in serve or "engine_recoveries_by_outcome" in serve:
            by = serve.get("engine_recoveries_by_outcome") or {}
            detail = " ".join(f"{k}={_fmt(v)}" for k, v in sorted(by.items()))
            lines.append(
                f"  engine_recoveries={_fmt(serve.get('engine_recoveries', sum(by.values())))}"
                + (f"  ({detail})" if detail else "")
            )
        if "admission_rejected_by_reason" in serve:
            detail = " ".join(
                f"{k}={_fmt(v)}"
                for k, v in sorted(serve["admission_rejected_by_reason"].items())
            )
            lines.append(f"  admission_rejected: {detail}")
        if "stream_frames_total" in serve:
            lines.append(
                f"  stream_frames={_fmt(serve['stream_frames_total'])}  "
                f"frame_gaps={_fmt(serve.get('stream_frame_gaps_total'))}  "
                f"stream_watchers={_fmt(serve.get('stream_watchers'))}"
            )
        if "watcher_shed_by_reason" in serve:
            detail = " ".join(
                f"{k}={_fmt(v)}"
                for k, v in sorted(serve["watcher_shed_by_reason"].items())
            )
            lines.append(f"  watcher_shed: {detail}")
        if "tenants" in serve:
            for t, info in serve["tenants"].items():
                sheds = info.get("sheds") or {}
                detail = " ".join(
                    f"{k}={_fmt(v)}" for k, v in sorted(sheds.items())
                )
                lines.append(
                    f"  tenant {t}: sessions={_fmt(info.get('sessions', 0))}"
                    + (f"  shed: {detail}" if detail else "")
                )
        if "memory_budget_bytes" in serve:
            lines.append(
                f"  memory_budget_bytes={_fmt(serve['memory_budget_bytes'])}"
            )
        if "devices_total" in serve:
            lines.append(f"  devices_total={_fmt(serve['devices_total'])}")
    runs = summary.get("runs")
    if runs:
        lines.append("per run:")
        for rid, r in runs.items():
            s = r.get("serve")
            if s:
                lines.append(
                    f"  {rid}  rounds={s['rounds']}  "
                    f"done={_fmt(s.get('sessions_done'))}  "
                    f"sessions/s={_fmt(s.get('sessions_per_sec'))}  "
                    f"occupancy={_fmt(s.get('batch_occupancy_mean'))}"
                )
            rn = r.get("run")
            if rn:
                lines.append(
                    f"  {rid}  chunks={rn['chunks']}  "
                    f"final_step={rn['final_step']}  "
                    f"steps/s={_fmt(rn.get('steps_per_sec'))}"
                )
    mets = summary.get("metrics")
    if mets:
        lines.append("metrics:")
        name_w = max(len(m["metric"]) for m in mets)
        for m in mets:
            label = _labels_id(m["labels"])
            if m.get("run_id"):
                label = f"run_id={m['run_id']}" + (f",{label}" if label else "")
            tag = f"{m['metric']:<{name_w}}" + (f"  [{label}]" if label else "")
            if m["type"] == "histogram":
                lines.append(
                    f"  {tag}  count={_fmt(m['count'])}  p50={_fmt(m['p50'])}  "
                    f"p95={_fmt(m['p95'])}  p99={_fmt(m['p99'])}"
                )
            else:
                lines.append(f"  {tag}  {m['type']}={_fmt(m['value'])}")
    return "\n".join(lines)
