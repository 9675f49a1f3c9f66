"""The port's read-back tools held to the JAX package's on the same inputs:
``obs.journey`` (``trace merge``, ``doctor``), ``obs.slo`` (specs, the
burn-rate engine, ``doctor --slo``), ``fleet.autoscaler``'s
``doctor --scale`` report and ``obs.console`` (``top``).

The captures are synthetic but in the fleet's capture format (scrape
records per worker, the control plane's, a written ``*.trace.json`` tail);
``top`` reads a stub HTTP server.  Each scenario runs over both packages
and the two records must be equal, the CLI's bytes included.
"""

import importlib
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from tpu_life import cli as jcli
from tpu_life_torch import cli

MODULES = ["obs.journey", "obs.slo", "obs.console", "obs.flight", "obs.timeseries",
           "fleet.autoscaler"]


def _pkg(root):
    ns = SimpleNamespace(root=root)
    for name in MODULES:
        setattr(ns, name.split(".")[-1], importlib.import_module(f"{root}.{name}"))
    return ns


PORT, JAX = _pkg("tpu_life_torch"), _pkg("tpu_life")


def twin(scenario, *args):
    got, want = scenario(PORT, *args), scenario(JAX, *args)
    assert got == want
    return got


def _raises(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 — the record is the comparison
        return (type(e).__name__, str(e))


# -- a synthetic fleet capture ---------------------------------------------------
T0 = 1_792_000_000.0
TRACE = "73c98884596c48a2"


def _rec(worker, gen, pid, events=(), flight=(), wall_t0=T0, offset=-0.002, dropped=0):
    return {"worker": worker, "generation": gen, "pid": pid,
            "run_id": None if worker == "control" else f"run{worker}{gen}",
            "wall_t0": None if worker == "control" else wall_t0, "offset_s": offset,
            "scraped_at": T0 + 5.0, "dropped": dropped, "events": list(events),
            "flight": list(flight)}


def _exec(ph, sid, ts_s, pid, **args):
    return {"name": "serve.exec", "cat": "serve.exec", "ph": ph, "id": sid, "ts": ts_s * 1e6,
            "pid": pid, "tid": 1, "args": {"trace_id": TRACE, **args}}


def _spill(sid, ts_s, pid, step):
    return {"name": "serve.session.spill", "ph": "i", "s": "p", "ts": ts_s * 1e6, "pid": pid,
            "tid": 1, "args": {"sid": sid, "trace_id": TRACE, "step": step}}


def _scale(t, action, **kw):
    return {"t": T0 + t, "kind": f"scale.{action}", **kw}


def _write_capture(root, variant):
    """A migrated session's journey: submit on w0, spills, an injection,
    the SIGKILL, the resume on w1, done.  ``variant`` breaks it: a
    double execution, a long gap, no terminal."""
    root.mkdir(parents=True, exist_ok=True)
    gap = 90.0 if variant == "long_gap" else 0.2
    w0_end = 1.5 if variant == "double" else 0.9  # w0 still executing after w1 starts
    w0 = [_exec("b", "s000000", 0.01, 101, step=0)]
    w0 += [_spill("s000000", 0.1 * i, 101, 2 * i) for i in range(1, 9)]
    w0.append({"name": "chaos.injection", "ph": "i", "s": "p", "ts": 0.5e6, "pid": 101,
               "tid": 1, "args": {"point": "spill.write", "decision": "enospc"}})
    if variant == "double":
        w0.append(_exec("e", "s000000", w0_end, 101, outcome="cancelled", step=16))
    control = [
        {"t": T0 + 0.001, "kind": "route.submit", "sid": "w0g1-s000000", "worker_sid": "s000000",
         "trace_id": TRACE, "worker": "w0", "generation": 1},
        {"t": T0 + 1.0, "kind": "worker.exit", "worker": "w0", "generation": 1, "rc": -9,
         "draining": False, "recycling": False, "released": False},
        {"t": T0 + 1.0 + gap, "kind": "migrate.resumed", "sid": "w0g1-s000000",
         "trace_id": TRACE, "worker": "w1", "generation": 1, "worker_sid": "s000004"},
        {"t": T0 + 1.5 + gap, "kind": "slo.breach", "slo": "recovery-time",
         "slo_kind": "recovery", "window_s": 300.0, "observed": 1.2, "objective": 0.5,
         "burn": 2.4, "worker": "w0"},
        _scale(2.0, "up", reason="queue_depth", worker="w2", active=2, standby=1,
               depth_per_ready=6.5),
        _scale(3.0, "hold", reason="cooldown_up", active=3, standby=0, depth_per_ready=5.0),
        _scale(9.0, "down", reason="idle", worker="w2", active=3, standby=0, depth_per_ready=0.0),
    ]
    t1 = 1.0 + gap
    w1 = [_exec("b", "s000004", t1 + 0.01, 202, step=16)]
    w1 += [_spill("s000004", t1 + 0.05 * i, 202, 16 + i) for i in range(1, 5)]
    w1_flight = [{"t": T0 + t1, "kind": "admission", "sid": "s000004", "trace_id": TRACE,
                  "rule": "B3/S23", "steps": 84, "start_step": 16}]
    if variant != "no_terminal":
        w1.append(_exec("e", "s000004", t1 + 0.4, 202, outcome="done", step=100))
        w1_flight.append({"t": T0 + t1 + 0.4, "kind": "terminal", "sid": "s000004",
                          "trace_id": TRACE, "outcome": "done", "step": 100})
    (root / "control.jsonl").write_text(json.dumps(_rec("control", 0, 100, flight=control)) + "\n")
    w0_flight = [{"t": T0, "kind": "admission", "sid": "s000000", "trace_id": TRACE,
                  "rule": "B3/S23", "steps": 100, "start_step": 0}]
    lines = [json.dumps(_rec("w0", 1, 101, w0[:5], w0_flight)),
             json.dumps(_rec("w0", 1, 101, w0[5:], dropped=3)),
             '{"worker": "w0", "genera']  # a torn final line: the writer was killed
    (root / "w0.jsonl").write_text("\n".join(lines))
    (root / "w1.jsonl").write_text(json.dumps(_rec("w1", 1, 202, w1[:3], w1_flight)) + "\n")
    (root / "w1g1.trace.json").write_text(json.dumps(
        {"traceEvents": w1[3:], "otherData": {"pid": 202, "run_id": "runw11",
                                              "wall_t0": T0, "dropped": 0}}))
    return root


VARIANTS = ["clean", "double", "long_gap", "no_terminal"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_merged_captures_agree(variant, tmp_path):
    cap = _write_capture(tmp_path / "cap", variant)
    doc = twin(lambda M: json.dumps(M.journey.merge_captures(str(cap))))
    assert json.loads(doc)["otherData"]["workers"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("query", [dict(sid="w0g1-s000000"), dict(trace_id=TRACE),
                                   dict(sid="s000004"), dict(sid="w9g9-s000000"),
                                   dict(sid="w0g1-s000000", max_gap_s=10.0)])
def test_doctor_reports_agree(variant, query, tmp_path):
    cap = _write_capture(tmp_path / "cap", variant)

    def scenario(M):
        doc = M.journey.load_merged(str(cap))
        report = M.journey.doctor(doc, **query)
        return json.dumps(report, sort_keys=True), M.journey.render_report(report)

    report = json.loads(twin(scenario)[0])
    if variant == "clean" and "w9" not in query.get("sid", ""):
        assert report["ok"] and any(f["kind"] == "migration" for f in report["findings"])


@pytest.mark.parametrize("variant", ["clean", "long_gap"])
def test_slo_and_scale_postmortems_agree(variant, tmp_path):
    cap = _write_capture(tmp_path / "cap", variant)

    def scenario(M):
        doc = M.journey.load_merged(str(cap))
        slo_rep, scale_rep = M.slo.slo_report(doc), M.autoscaler.scale_report(doc)
        return (json.dumps(slo_rep, sort_keys=True), M.slo.render_slo_report(slo_rep),
                json.dumps(scale_rep, sort_keys=True), M.autoscaler.render_scale_report(scale_rep),
                json.dumps(M.slo.slo_report(doc, horizon_s=0.5), sort_keys=True))

    got = twin(scenario)
    assert json.loads(got[2])["counts"] == {"up": 1, "hold": 1, "down": 1}


def _run_cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("variant", VARIANTS)
def test_trace_merge_and_doctor_clis_agree(variant, tmp_path, capsys):
    cap = _write_capture(tmp_path / "cap", variant)
    outs = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        out = tmp_path / f"{name}.trace.json"
        rc, line, _ = _run_cli(main, ["trace", "merge", str(cap), "-o", str(out)], capsys)
        outs[name] = (rc, json.loads(line) | {"output": None}, out.read_bytes())
        docs = []
        for argv in (["doctor", str(cap), "--sid", "w0g1-s000000", "--json"],
                     ["doctor", str(out), "--trace-id", TRACE],
                     ["doctor", str(cap), "--slo", "--json"],
                     ["doctor", str(cap), "--scale"],
                     ["doctor", str(cap), "--slo", "--scale"],
                     ["doctor", str(cap)],
                     ["doctor", str(tmp_path / "absent"), "--sid", "x"]):
            docs.append(_run_cli(main, argv, capsys))
        outs[name] += (docs,)
    assert outs["port"] == outs["jax"]
    rc, line, merged, docs = outs["port"]
    assert rc == 0 and line["incarnations"] == 3
    assert [d[0] for d in docs] == [0 if variant == "clean" else 1,
                                    0 if variant == "clean" else 1, 0, 0, 2, 2, 2]
    assert json.loads(docs[0][1])["trace_id"] == TRACE


# -- SLO specs and the burn-rate engine -------------------------------------------
SLO_FILES = [
    ("slo.json", json.dumps({"slo": [
        {"name": "lat", "kind": "quantile", "metric": "m", "objective": 0.5},
        {"name": "err", "kind": "ratio", "bad": "b", "total": "t", "objective": 0.01,
         "burn_threshold": 2.0}]})),
    ("bare.json", json.dumps([{"name": "lat", "kind": "quantile", "metric": "m",
                               "objective": 0.5}])),
    ("slo.toml", '# objectives\n[[slo]]\nname = "lat"\nkind = "quantile"\n'
                 'metric = "serve_queue_wait_seconds"\nobjective = 0.25\nq = 0.95\n\n'
                 '[[slo]]\nname = "rec"\nkind = "recovery"\nobjective = 30\n'),
    ("slo.json", '{"slo": [{"name": "x"}]}'),
    ("slo.json", '{"slo": [{"name": "x", "kind": "recovery", "objective": 1, "zap": 3}]}'),
    ("slo.json", '{"slo": []}'),
    ("slo.json", '{"nope": []}'),
    ("slo.json", "not json"),
    # the reference defect the port copies (ROADMAP §C): on Python >= 3.11
    # tomllib parses first, so the error names the slo entry, not the line
    ("slo.toml", '[[slo]]\nname = "x"\n[other]\n'),
    ("slo.toml", 'name = "orphan"\n'),
]


@pytest.mark.parametrize("name,text", SLO_FILES)
def test_slo_specs_and_their_refusals_agree(name, text, tmp_path):
    f = tmp_path / name
    f.write_text(text)

    def scenario(M):
        got = _raises(M.slo.load_specs, str(f))
        if got[0] == "ok":
            import dataclasses

            return [dataclasses.asdict(s) for s in got[1]]
        return got

    twin(scenario)


def test_the_toml_line_error_names_the_entry_in_both_packages(tmp_path):
    # what the JAX suite's test_toml_subset_errors_point_at_the_line
    # expects (``slo.toml:3``) holds only without tomllib
    f = tmp_path / "slo.toml"
    f.write_text('[[slo]]\nname = "x"\n[other]\n')
    msgs = [_raises(M.slo.load_specs, str(f)) for M in (PORT, JAX)]
    assert msgs[0] == msgs[1] and msgs[0][0] == "ValueError"
    assert "slo.toml:3" not in msgs[0][1]


def _cumulative_hist(i, bad_per_s):
    """Snapshot ``i`` of a latency histogram: ``i`` fast observations,
    ``10 * bad_per_s * i`` slow ones, ``3 * i`` in between (cumulative
    buckets, the last the +Inf slot)."""
    fast, slow = i, int(10 * bad_per_s * i)
    cum = [fast, fast + 3 * i, fast + 3 * i + slow]
    return {"le": [0.1, 1.0, 10.0], "buckets": [*cum, cum[-1]], "count": cum[-1],
            "sum": 0.05 * fast + 0.5 * 3 * i + 5.0 * slow}


def _burn_scenario(M, bad_per_s, kind):
    M.flight.reset()
    store = M.timeseries.SeriesStore()
    snaps = []
    for i, t in enumerate(range(0, 1001, 100)):
        snaps.append({"seq": i, "t": float(t), "c": {"bad_total": bad_per_s * 100.0 * i,
                                                      "all_total": 1000.0 * i},
                      "h": {"lat_seconds": _cumulative_hist(i, bad_per_s)}})
    store.extend("w0", 1, snaps)
    if kind == "ratio":
        spec = M.slo.SloSpec(name="err", kind="ratio", bad="bad_total", total="all_total",
                             objective=0.01)
    elif kind == "quantile":
        spec = M.slo.SloSpec(name="lat", kind="quantile", metric="lat_seconds", objective=0.5,
                             q=0.99)
    else:
        spec = M.slo.SloSpec(name="rec", kind="recovery", objective=0.5)
    eng = M.slo.SloEngine([spec], store)
    out = [eng.evaluate(now=1000.0), eng.evaluate(now=1001.0)]
    eng.note_worker_exit("w1", 3, t=1000.0)
    eng.note_worker_ready("w1", 4, t=1000.4)
    eng.note_worker_exit("w0", 1, t=1002.0)
    out += [eng.evaluate(now=1003.0), eng.breaches_fired, eng.status()]
    out.append([{k: v for k, v in e.items() if k != "t"} for e in M.flight.snapshot()])
    M.flight.reset()
    return json.dumps(out, sort_keys=True, default=str)


@pytest.mark.parametrize("kind", ["ratio", "quantile", "recovery"])
@pytest.mark.parametrize("bad_per_s", [0.0, 0.05, 1.0])
def test_burn_rate_judgements_agree(kind, bad_per_s):
    twin(_burn_scenario, bad_per_s, kind)


def test_default_slo_specs_agree():
    import dataclasses

    twin(lambda M: [dataclasses.asdict(s) for s in M.slo.default_specs()])


# -- the console --------------------------------------------------------------------
PROM = """\
# HELP serve_steps_total steps
# TYPE serve_steps_total counter
serve_steps_total{worker="w0"} 100
serve_steps_total{worker="w1"} 40
# TYPE serve_packed_steps_total counter
serve_packed_steps_total{worker="w0"} 50
serve_packed_steps_total{worker="w1"} 0
# TYPE serve_rounds_total counter
serve_rounds_total{worker="w0"} 10
# TYPE serve_queue_depth gauge
serve_queue_depth{worker="w0"} 3
# TYPE serve_queue_wait_seconds histogram
serve_queue_wait_seconds_bucket{worker="w0",le="0.1"} 2
serve_queue_wait_seconds_bucket{worker="w0",le="1"} 5
serve_queue_wait_seconds_bucket{worker="w0",le="+Inf"} 6
serve_queue_wait_seconds_sum{worker="w0"} 9.5
serve_queue_wait_seconds_count{worker="w0"} 6
garbage line { here
serve_queue_depth{worker="w1",note="a \\"quoted\\" \\\\ value"} 1
"""
HEALTHZ = {"slo": {"rec": {"kind": "recovery", "objective": 30.0, "burn_fast": 3.0,
                           "burn_slow": 3.0, "observed": 90.0, "breaching": True},
                   "lat": {"kind": "quantile", "objective": 1.0, "burn_fast": 0.5,
                           "burn_slow": 0.2, "observed": 0.5, "breaching": False}},
           "workers": {"w0": "ready", "w1": "draining"}}


@pytest.mark.parametrize("later", ["140", "8", "100"])
@pytest.mark.parametrize("color", [True, False])
def test_console_views_agree(later, color):
    def scenario(M):
        C = M.console
        prev = C.parse_prom_text(PROM)
        prev["t"] = 100.0
        cur = C.parse_prom_text(PROM.replace('serve_steps_total{worker="w0"} 100',
                                             f'serve_steps_total{{worker="w0"}} {later}'))
        cur["t"] = 102.0
        first = C.build_view(None, prev)
        view = C.build_view(prev, cur, HEALTHZ)
        return (json.dumps(first, sort_keys=True), json.dumps(view, sort_keys=True),
                C.render_view(view, color=color), C.parse_labels('a="1",b="x\\"y"'))

    twin(scenario)


def _loop_scenario(M, script, kw):
    out = io.StringIO()
    frames = list(script)

    def paint():
        step = frames.pop(0)
        if isinstance(step, BaseException):
            raise step
        return step

    rc = M.console.refresh_loop(paint, 0.0, out=out, **kw)
    return rc, out.getvalue()


@pytest.mark.parametrize("script,kw", [
    ([OSError("fleet restarting"), "frame"], dict(clear=False, max_iterations=2)),
    (["only"], dict(once=True)),
    ([KeyboardInterrupt()], {}),
    (["a", "b", "c"], dict(max_iterations=3)),
])
def test_refresh_loops_agree(script, kw):
    twin(_loop_scenario, script, kw)


@pytest.fixture
def stub_router():
    """A router stand-in serving fixed /metrics and /healthz."""
    scrapes = {"n": 0}

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/metrics":
                # every reader samples twice: 100 steps, then 140
                scrapes["n"] += 1
                n = 140 if scrapes["n"] % 2 == 0 else 100
                body = PROM.replace('serve_steps_total{worker="w0"} 100',
                                    f'serve_steps_total{{worker="w0"}} {n}').encode()
                ctype = "text/plain"
            elif self.path == "/healthz":
                body, ctype = json.dumps(HEALTHZ).encode(), "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=5)


def test_top_once_json_against_a_stub_router_agrees(stub_router, capsys):
    views = []
    for main in (cli.main, jcli.main):
        rc, out, err = _run_cli(main, ["top", "--url", stub_router, "--once", "--json",
                                       "--interval", "0.05"], capsys)
        assert rc == 0, err
        view = json.loads(out)
        assert view["interval_s"] is not None  # two samples: the rates are real
        rate = view["workers"]["w0"].pop("steps_s")
        assert rate > 0  # a delta over the measured interval
        view["fleet"].pop("steps_s")
        views.append({k: v for k, v in view.items() if k not in ("t", "interval_s")})
    assert views[0] == views[1]
    assert set(views[0]["workers"]) == {"w0", "w1"} and views[0]["slo"]["rec"]["breaching"]


@pytest.mark.parametrize("argv", [["top", "--json"],
                                  ["top", "--url", "http://127.0.0.1:1", "--once", "--json"]])
def test_top_refusals_agree(argv, capsys):
    got = [_run_cli(main, argv, capsys) for main in (cli.main, jcli.main)]
    assert got[0][:2] == got[1][:2] == (2, "")
    assert got[0][2].startswith("top:") and got[1][2].startswith("top:")


def test_top_client_reads_the_stub_as_the_jax_client_does(stub_router):
    def scenario(M):
        client = M.console.TopClient(stub_router)
        first, second = client.view(), client.view()
        for v in (first, second):
            v.pop("t")
        second.pop("interval_s")
        second["workers"]["w0"].pop("steps_s")
        second["fleet"].pop("steps_s", None)
        return json.dumps([first, second], sort_keys=True)

    twin(scenario)
