"""The operator console behind ``tpu-life top`` (docs/OBSERVABILITY.md
"top").

``top`` is a read-only client of surfaces the fleet already serves:
``GET /metrics`` (the router's merged Prometheus exposition, every
worker's samples tagged ``worker="<name>"``) and ``GET /healthz`` (whose
``slo`` section carries the supervisor's live burn gauges).  Each
refresh takes one scrape, diffs it against the previous one, and renders
per-worker throughput, queue depth, governor bytes vs budget,
packed/matmul fractions, stream watchers, and the SLO burn table with
breach highlighting.  ``--once --json`` emits the same view as one JSON
document — the scripting contract ROADMAP item 3's autoscaler will
consume (two samples one interval apart, so the rates are real).

Pointing ``top`` at a single ``serve`` gateway works too: its samples
carry no ``worker`` label and land on one ``local`` row.

Counter deltas here are client-side: a negative delta means the far end
restarted between scrapes (a new incarnation's counters start at zero),
so the new cumulative value IS the delta — the same new-series rule the
sampled rings apply per (worker, generation).

``tpu-life stats --watch`` borrows only :func:`refresh_loop` — the
single-shot stats output stays byte-identical when the flag is absent.

Stdlib only, no jax/numpy: a login-node terminal is the target.
"""

from __future__ import annotations

import json
import re
import sys
import time
import urllib.request

#: Default refresh cadence (seconds) — one scrape per paint.
DEFAULT_INTERVAL_S = 2.0

_ANSI_CLEAR = "\x1b[2J\x1b[H"
_ANSI_RED = "\x1b[31;1m"
_ANSI_DIM = "\x1b[2m"
_ANSI_RESET = "\x1b[0m"

_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return v.replace(r"\"", '"').replace(r"\n", "\n").replace(r"\\", "\\")


def parse_labels(labelpart: str) -> dict:
    """``k="v",...`` (exposition label syntax, escapes honoured) → dict."""
    return {m.group(1): _unescape(m.group(2)) for m in _LABEL_RE.finditer(labelpart)}


def parse_prom_text(text: str) -> dict:
    """One Prometheus text exposition → a structured snapshot.

    Returns ``{"t", "types": {family: kind}, "scalars": [(name, labels,
    value)], "hists": {key: {...}}}`` where histograms are reassembled
    from their ``_bucket``/``_sum``/``_count`` sample lines back into
    the cumulative-vector shape ``obs.timeseries`` uses (``le`` finite
    bounds, ``buckets`` cumulative with the +Inf slot last), keyed by
    ``name{labels-minus-le}``.  Unparseable lines are skipped — a
    console must keep painting through a half-written exposition."""
    types: dict[str, str] = {}
    scalars: list[tuple[str, dict, float]] = []
    hists: dict[str, dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) > 3:
                types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        if not head:
            continue
        try:
            val = float(value)
        except ValueError:
            continue
        brace = head.find("{")
        if brace >= 0 and head.endswith("}"):
            name, labels = head[:brace], parse_labels(head[brace + 1 : -1])
        else:
            name, labels = head, {}
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            stem = name[: -len(suffix)] if name.endswith(suffix) else None
            if stem is not None and types.get(stem) == "histogram":
                base = (stem, suffix)
                break
        if base is None:
            scalars.append((name, labels, val))
            continue
        stem, suffix = base
        le = labels.pop("le", None)
        key = _key(stem, labels)
        h = hists.setdefault(
            key,
            {"name": stem, "labels": labels, "le": [], "buckets": [],
             "count": 0, "sum": 0.0, "_inf": 0.0},
        )
        if suffix == "_bucket":
            if le == "+Inf":
                h["_inf"] = val
            elif le is not None:
                h["le"].append(float(le))
                h["buckets"].append(val)
        elif suffix == "_sum":
            h["sum"] = val
        else:
            h["count"] = int(val)
    for h in hists.values():
        h["buckets"].append(h.pop("_inf"))
    return {"t": time.time(), "types": types, "scalars": scalars, "hists": hists}


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return name + "{" + inner + "}"


# -- the view -------------------------------------------------------------
def _split_worker(labels: dict) -> tuple[str, dict]:
    rest = dict(labels)
    return rest.pop("worker", "local"), rest


def _delta(prev: float | None, cur: float) -> float:
    """Client-side counter delta; a reset (negative) reads as a fresh
    series — the new cumulative IS the windowed increment."""
    if prev is None or cur < prev:
        return cur
    return cur - prev


def build_view(prev: dict | None, cur: dict, healthz: dict | None = None) -> dict:
    """Two parsed scrapes (``prev`` may be None on the first paint) plus
    the router's healthz → the per-worker console rows and fleet totals.
    Pure data out: the ``--json`` document and the renderer's input."""
    dt = max(1e-9, cur["t"] - prev["t"]) if prev else None
    prev_scalars: dict[str, float] = {}
    if prev:
        for name, labels, val in prev["scalars"]:
            prev_scalars[_key(name, labels)] = val

    workers: dict[str, dict] = {}

    def row(worker: str) -> dict:
        return workers.setdefault(
            worker,
            {"steps_s": None, "rounds_s": None, "sessions_s": None,
             "queue": None, "occupancy": None, "watchers": None,
             "est_bytes": None, "budget_bytes": None,
             "steps": 0.0, "packed_steps": 0.0, "matmul_keys": None,
             "mesh": None, "frames_s": None, "gaps_s": None},
        )

    def rated(key: str, cur_val: float) -> float | None:
        if dt is None:
            return None
        return _delta(prev_scalars.get(key), cur_val) / dt

    # the tenants pane (docs/SERVING.md "Tenant QoS"): live sessions and
    # typed sheds per tenant label, summed across workers
    tenants: dict[str, dict] = {}

    def tenant_row(t: str) -> dict:
        return tenants.setdefault(
            t, {"sessions": None, "sheds_s": None, "sheds": 0.0}
        )

    for name, labels, val in cur["scalars"]:
        worker, rest = _split_worker(labels)
        kind = cur["types"].get(name)
        key = _key(name, labels)
        r = row(worker)
        if name == "serve_steps_total":
            r["steps"] += val
            rate = rated(key, val)
            if rate is not None:
                r["steps_s"] = (r["steps_s"] or 0.0) + rate
        elif name == "serve_packed_steps_total":
            r["packed_steps"] += val
        elif name == "serve_rounds_total":
            rate = rated(key, val)
            if rate is not None:
                r["rounds_s"] = (r["rounds_s"] or 0.0) + rate
        elif name == "serve_sessions_finished_total":
            rate = rated(key, val)
            if rate is not None:
                r["sessions_s"] = (r["sessions_s"] or 0.0) + rate
        elif name == "serve_queue_depth":
            r["queue"] = val
        elif name == "serve_batch_occupancy":
            r["occupancy"] = val
        elif name == "stream_watchers":
            r["watchers"] = (r["watchers"] or 0.0) + val
        elif name == "stream_frames_total":
            rate = rated(key, val)
            if rate is not None:
                r["frames_s"] = (r["frames_s"] or 0.0) + rate
        elif name == "stream_frame_gaps_total":
            rate = rated(key, val)
            if rate is not None:
                r["gaps_s"] = (r["gaps_s"] or 0.0) + rate
        elif name == "serve_estimated_bytes":
            r["est_bytes"] = (r["est_bytes"] or 0.0) + val
        elif name == "serve_memory_budget_bytes":
            r["budget_bytes"] = val
        elif name == "serve_matmul_keys":
            r["matmul_keys"] = val
        elif name == "serve_mesh_sessions":
            r["mesh"] = (r["mesh"] or 0.0) + val
        elif name == "serve_tenant_sessions":
            tr = tenant_row(rest.get("tenant", "<none>"))
            tr["sessions"] = (tr["sessions"] or 0.0) + val
        elif name == "tenant_shed_total":
            tr = tenant_row(rest.get("tenant", "<none>"))
            tr["sheds"] += val
            rate = rated(key, val)
            if rate is not None:
                tr["sheds_s"] = (tr["sheds_s"] or 0.0) + rate
        elif kind == "counter" and name.endswith("_total"):
            pass  # unrowed counters still merge into fleet totals below

    for r in workers.values():
        r["packed_frac"] = (r["packed_steps"] / r["steps"]) if r["steps"] else None
        del r["steps"], r["packed_steps"]

    def total(field):
        vals = [r[field] for r in workers.values() if r[field] is not None]
        return sum(vals) if vals else None

    view = {
        "t": cur["t"],
        "interval_s": dt,
        "workers": {k: workers[k] for k in sorted(workers)},
        "fleet": {
            "steps_s": total("steps_s"),
            "sessions_s": total("sessions_s"),
            "queue": total("queue"),
            "watchers": total("watchers"),
            "mesh": total("mesh"),
            "frames_s": total("frames_s"),
            "gaps_s": total("gaps_s"),
        },
        "slo": (healthz or {}).get("slo") or {},
        "states": (healthz or {}).get("workers") or {},
        "tenants": {k: tenants[k] for k in sorted(tenants)},
    }
    return view


# -- rendering ------------------------------------------------------------
def _fmt_num(v, unit: str = "") -> str:
    if v is None:
        return "-"
    if unit == "b":  # bytes, scaled
        for suf in ("B", "KiB", "MiB", "GiB"):
            if abs(v) < 1024 or suf == "GiB":
                return f"{v:.1f}{suf}" if suf != "B" else f"{int(v)}B"
            v /= 1024
    if abs(v) >= 1000:
        return f"{v:,.0f}"
    if isinstance(v, float) and not float(v).is_integer():
        return f"{v:.2f}"
    return str(int(v))


def render_view(view: dict, *, color: bool = True) -> str:
    red = _ANSI_RED if color else ""
    dim = _ANSI_DIM if color else ""
    rst = _ANSI_RESET if color else ""
    lines = []
    stamp = time.strftime("%H:%M:%S", time.localtime(view["t"]))
    iv = view.get("interval_s")
    lines.append(
        f"tpu-life top  {stamp}"
        + (f"  (rates over {iv:.1f}s)" if iv else f"  {dim}(first sample — rates next paint){rst}")
    )
    states = view.get("states") or {}
    if states:
        lines.append(
            "workers: "
            + "  ".join(f"{w}={s}" for w, s in sorted(states.items()))
        )
    cols = (
        ("worker", 8), ("steps/s", 10), ("sess/s", 7), ("queue", 6),
        ("occ", 5), ("watch", 6), ("frames/s", 9), ("gaps/s", 7),
        ("packed", 7), ("mm", 4), ("mesh", 5), ("mem", 14),
    )
    lines.append(" ".join(f"{h:>{w}}" for h, w in cols))
    rows = dict(view["workers"])
    fleet = view["fleet"]
    for worker, r in rows.items():
        mem = "-"
        if r["est_bytes"] is not None:
            mem = _fmt_num(r["est_bytes"], "b")
            if r["budget_bytes"]:
                mem += f"/{_fmt_num(r['budget_bytes'], 'b')}"
        packed = "-" if r["packed_frac"] is None else f"{r['packed_frac'] * 100:.0f}%"
        vals = (
            worker, _fmt_num(r["steps_s"]), _fmt_num(r["sessions_s"]),
            _fmt_num(r["queue"]), _fmt_num(r["occupancy"]),
            _fmt_num(r["watchers"]), _fmt_num(r["frames_s"]),
            _fmt_num(r["gaps_s"]), packed, _fmt_num(r["matmul_keys"]),
            _fmt_num(r["mesh"]), mem,
        )
        lines.append(" ".join(f"{str(v):>{w}}" for v, (_, w) in zip(vals, cols)))
    if len(rows) > 1:
        vals = (
            "TOTAL", _fmt_num(fleet["steps_s"]), _fmt_num(fleet["sessions_s"]),
            _fmt_num(fleet["queue"]), "-", _fmt_num(fleet["watchers"]),
            _fmt_num(fleet["frames_s"]), _fmt_num(fleet["gaps_s"]), "-", "-",
            _fmt_num(fleet["mesh"]), "-",
        )
        lines.append(" ".join(f"{str(v):>{w}}" for v, (_, w) in zip(vals, cols)))
    tenants = view.get("tenants") or {}
    if tenants:
        lines.append("")
        lines.append(f"{'tenant':>16} {'sessions':>9} {'sheds/s':>8} {'sheds':>8}")
        for t in sorted(tenants):
            tr = tenants[t]
            lines.append(
                f"{t:>16} {_fmt_num(tr.get('sessions')):>9} "
                f"{_fmt_num(tr.get('sheds_s')):>8} {_fmt_num(tr.get('sheds')):>8}"
            )
    slo = view.get("slo") or {}
    if slo:
        lines.append("")
        lines.append(f"{'slo':>16} {'kind':>9} {'objective':>10} "
                     f"{'burn 5m':>8} {'burn 1h':>8} {'observed':>10}")
        for name in sorted(slo):
            st = slo[name]
            burn_f = st.get("burn_fast")
            burn_s = st.get("burn_slow")
            obs = st.get("observed")
            line = (
                f"{name:>16} {st.get('kind', '?'):>9} "
                f"{_fmt_num(st.get('objective')):>10} "
                f"{_fmt_num(burn_f):>8} {_fmt_num(burn_s):>8} "
                f"{_fmt_num(obs):>10}"
            )
            if st.get("breaching"):
                line = f"{red}{line}  BREACH{rst}"
            lines.append(line)
    return "\n".join(lines)


# -- the client + loop ----------------------------------------------------
class TopClient:
    """Scrapes one base URL (fleet router or single gateway) and keeps
    the previous parse so every :meth:`view` has real rates."""

    def __init__(self, url: str, timeout: float = 3.0):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self._prev: dict | None = None

    def _get(self, path: str) -> bytes:
        with urllib.request.urlopen(self.url + path, timeout=self.timeout) as resp:
            return resp.read()

    def sample(self) -> dict:
        return parse_prom_text(self._get("/metrics").decode("utf-8", "replace"))

    def healthz(self) -> dict | None:
        try:
            doc = json.loads(self._get("/healthz"))
            return doc if isinstance(doc, dict) else None
        except Exception:
            return None  # a bare gateway has no /healthz — rows still paint

    def view(self) -> dict:
        cur = self.sample()
        v = build_view(self._prev, cur, self.healthz())
        self._prev = cur
        return v


def refresh_loop(
    paint,
    interval_s: float = DEFAULT_INTERVAL_S,
    *,
    once: bool = False,
    out=None,
    clear: bool = True,
    max_iterations: int | None = None,
) -> int:
    """The shared console loop (``top`` and ``stats --watch``): call
    ``paint()`` for a string, clear-and-draw, sleep, repeat until ^C.
    ``once`` paints a single frame with no clear (pipeline-friendly);
    ``max_iterations`` bounds the loop for tests.  Returns an exit code;
    a scrape error paints as a message, not a crash — a console must
    survive its fleet restarting."""
    out = sys.stdout if out is None else out
    n = 0
    while True:
        try:
            frame = paint()
        except KeyboardInterrupt:
            return 0
        except Exception as e:
            frame = f"[unreachable: {e}]"
        if clear and not once:
            out.write(_ANSI_CLEAR)
        out.write(frame + "\n")
        out.flush()
        n += 1
        if once or (max_iterations is not None and n >= max_iterations):
            return 0
        try:
            time.sleep(interval_s)
        except KeyboardInterrupt:
            return 0
