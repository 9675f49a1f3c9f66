"""The port's gateway over localhost HTTP, held to the JAX package's.

Twin gateways answer one request script: the JAX package's over its
``numpy`` serve backend, and the port's over ``numpy`` and over ``cuda``
with ``device="cpu"`` (K1's batch mode's plain version).  Status codes,
error codes, ``Retry-After`` and response bodies must agree; the bodies are
compared with the fields of :data:`MASKED` taken out (correlation ids,
which each service mints), and every board byte for byte.  The cases are
those of ``tests/test_gateway_http.py``.  Each package's client also talks
to the other package's gateway.

Every gateway binds port 0 and is drained, waited for (with a timeout) and
closed at teardown; boards are small so each case takes a second or two.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from tpu_life.config import RunConfig as JRunConfig
from tpu_life.gateway import Gateway as JGateway
from tpu_life.gateway import GatewayConfig as JGatewayConfig
from tpu_life.gateway.client import GatewayClient as JClient
from tpu_life.gateway.client import GatewayError as JGatewayError
from tpu_life.models.patterns import random_board
from tpu_life.runtime import driver as jdriver
from tpu_life.serve import ServeConfig as JServeConfig
from tpu_life.serve import SimulationService as JService
from tpu_life_torch.gateway import Gateway, GatewayConfig
from tpu_life_torch.gateway.client import GatewayClient, GatewayError
from tpu_life_torch.serve import ServeConfig, SimulationService

#: the response fields each service mints for itself: masked before the
#: bodies are compared, and nothing else is
MASKED = ("run_id", "trace_id")
#: a timing: how far a running session got when a 409 answered, in the
#: message ("running (6/200000 steps)")
STEPS_DONE_IN_MESSAGE = re.compile(r"\((\d+)/(\d+) steps\)")
#: the port's serve backends held to the JAX package's ``numpy`` gateway
PORT_BACKENDS = ["numpy", "cuda"]
WAIT_S = 60.0


def _mask(body):
    if isinstance(body, dict):
        return {k: _mask(v) for k, v in body.items() if k not in MASKED}
    if isinstance(body, str):
        return STEPS_DONE_IN_MESSAGE.sub(r"(*/\2 steps)", body)
    return body


class Twin:
    """One gateway of either package, with its package's client classes."""

    def __init__(self, pkg, gw, client_cls, error_cls):
        self.pkg, self.gw = pkg, gw
        self.client_cls, self.error_cls = client_cls, error_cls
        self.url = f"http://127.0.0.1:{gw.port}"

    def client(self, **kw):
        kw.setdefault("retries", 0)
        return self.client_cls(self.url, **kw)


@pytest.fixture
def make_twins():
    """``make(port_backend, serve kwargs, gateway kwargs)`` -> (JAX twin,
    port twin); every gateway is drained and closed at teardown."""
    gateways = []

    def _make(port_backend, serve_kw, gw_kw=None):
        gw_kw = dict(gw_kw or {}, port=0)
        jsvc = JService(JServeConfig(backend="numpy", **serve_kw))
        jgw = JGateway(jsvc, JGatewayConfig(**gw_kw))
        extra = {"device": "cpu"} if port_backend == "cuda" else {}
        psvc = SimulationService(ServeConfig(backend=port_backend, **extra, **serve_kw))
        pgw = Gateway(psvc, GatewayConfig(**gw_kw))
        for gw in (jgw, pgw):
            gw.start()
            gateways.append(gw)
        return (Twin("jax", jgw, JClient, JGatewayError),
                Twin("port", pgw, GatewayClient, GatewayError))

    yield _make
    for gw in gateways:
        gw.begin_drain()
        gw.wait(timeout=WAIT_S)
        gw.close()


def _http(url, method, path, data=None, headers=None):
    """(status, Retry-After header, body) of one raw request."""
    req = urllib.request.Request(url + path, data=data, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.headers.get("Retry-After"), json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), json.loads(e.read() or b"{}")


def _outcome(twin, fn):
    """(status, code, has Retry-After) of a client call that may fail."""
    try:
        fn()
        return (200, None, False)
    except twin.error_cls as e:
        return (e.status, e.code, e.retry_after is not None)


def _jax_driver_board(tmp_path, board, steps, tag):
    from tpu_life.io.codec import write_board

    h, w = board.shape
    inp = tmp_path / f"in_{tag}.txt"
    write_board(inp, board)
    res = jdriver.run(JRunConfig(height=h, width=w, steps=steps, input_file=str(inp),
                                 output_file=str(tmp_path / f"out_{tag}.txt"),
                                 rule="conway", backend="numpy"))
    return res.board


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_twenty_staggered_sessions_byte_equal_driver(make_twins, tmp_path, port_backend):
    jt, pt = make_twins(port_backend, dict(capacity=8, chunk_steps=7, max_queue=64))
    boards = [random_board(24, 19, density=0.4, seed=200 + i) for i in range(20)]
    budgets = [1 + (7 * i) % 43 for i in range(20)]
    results, views = {}, {}
    for t in (jt, pt):
        c = t.client(retries=8)
        sids = [c.submit(board=b, rule="conway", steps=n) for b, n in zip(boards, budgets)]
        views[t.pkg] = [_mask(c.wait(s, timeout=WAIT_S)) for s in sids]
        results[t.pkg] = [c.result_board(s) for s in sids]
        metrics = c.metrics()
        assert ('gateway_requests_total{route="/v1/sessions",method="POST",status="201"} 20'
                in metrics)
    assert views["port"] == views["jax"]
    for i, (board, steps) in enumerate(zip(boards, budgets)):
        expect = _jax_driver_board(tmp_path, board, steps, i)
        assert results["jax"][i].tobytes() == expect.tobytes()
        assert results["port"][i].tobytes() == expect.tobytes()
    if port_backend == "cuda":
        # one key, one build of the device batch's chunk
        assert list(pt.gw.service.scheduler.compile_counts().values()) == [1]


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_ising_session_over_http_replays_exactly(make_twins, port_backend):
    jt, pt = make_twins(port_backend, dict(capacity=4, chunk_steps=3, max_queue=16))
    kw = dict(rule="ising", steps=7, size=12, seed=9, temperature=2.27)
    boards, views, bad = {}, {}, {}
    for t in (jt, pt):
        c = t.client(retries=8)
        sids = [c.submit(**kw), c.submit(**kw)]
        views[t.pkg] = [_mask(c.wait(s, timeout=WAIT_S)) for s in sids]
        a, b = (c.result_board(s) for s in sids)
        assert a.tobytes() == b.tobytes()
        boards[t.pkg] = a
        bad[t.pkg] = [_outcome(t, lambda k=k: t.client().submit(**k)) for k in (
            dict(rule="ising", steps=2, size=8),
            dict(rule="conway", steps=2, size=8, temperature=2.0),
            dict(rule="ising", steps=2, size=7, temperature=2.0),
        )]
    assert boards["port"].tobytes() == boards["jax"].tobytes()
    for view in views["port"]:
        assert view["state"] == "done" and view["seed"] == 9 and view["temperature"] == 2.27
    # the attribution stamp names the executor: the numpy oracle's int8
    # roll path in both packages, the bitplane path (32 lanes) of K6's
    # batch mode on the port's cuda backend
    if port_backend == "cuda":
        assert all(v.pop("packed") is True and v.pop("lanes") == 32 for v in views["port"])
        for v in views["jax"]:
            v.pop("packed", None), v.pop("lanes", None)
    assert views["port"] == views["jax"]
    assert bad["port"] == bad["jax"] == [(400, bad["jax"][0][1], False),
                                         (400, bad["jax"][1][1], False),
                                         (400, bad["jax"][2][1], False)]


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_rate_limit_is_429_with_retry_after(make_twins, port_backend):
    jt, pt = make_twins(port_backend, dict(capacity=2, chunk_steps=2),
                        dict(api_rate=0.5, api_burst=1.0))
    script = {}
    for t in (jt, pt):
        c = t.client()
        first = c.submit(size=8, steps=1)
        status, retry_after, body = _http(
            t.url, "POST", "/v1/sessions", data=json.dumps({"size": 8, "steps": 1}).encode())
        other = t.client(api_key="tenant-b").submit(size=8, steps=1)
        limited = [line for line in c.metrics().splitlines()
                   if line.startswith("gateway_rate_limited_total ")]
        script[t.pkg] = (first, status, retry_after, _mask(body), other, limited)
    assert script["port"] == script["jax"]
    assert script["port"][1] == 429 and script["port"][3]["error"]["code"] == "rate_limited"
    assert float(script["port"][2]) >= 1


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_load_shedding_rejects_before_enqueue(make_twins, port_backend):
    jt, pt = make_twins(port_backend, dict(capacity=1, chunk_steps=1),
                        dict(shed_high_water=2.0))
    script = {}
    for t in (jt, pt):
        svc = t.gw.service
        svc.registry.gauge("serve_queue_depth").set(5)
        before = svc._c_submitted.value
        status, retry_after, body = _http(
            t.url, "POST", "/v1/sessions", data=json.dumps({"size": 8, "steps": 1}).encode())
        script[t.pkg] = (status, retry_after, _mask(body), svc._c_submitted.value - before)
        svc.registry.gauge("serve_queue_depth").set(0)
    assert script["port"] == script["jax"]
    assert script["port"][0] == 503 and script["port"][3] == 0


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_readyz_flips_to_503_during_drain(make_twins, port_backend):
    jt, pt = make_twins(port_backend, dict(capacity=2, chunk_steps=1))
    script = {}
    for t in (jt, pt):
        c = t.client()
        ready = _mask(c.readyz())
        sid = c.submit(size=48, steps=300)  # long enough to straddle the drain
        t.gw.begin_drain()
        readyz = _http(t.url, "GET", "/readyz")
        submit = _http(t.url, "POST", "/v1/sessions",
                       data=json.dumps({"size": 8, "steps": 1}).encode())
        assert t.gw.wait(timeout=WAIT_S), "drain must terminate"
        view = t.gw.service.poll(sid)
        script[t.pkg] = (ready.get("ready"), readyz[0], readyz[1], _mask(readyz[2]),
                         submit[0], submit[1], _mask(submit[2]), view.state.value,
                         view.steps_done, view.result.tobytes())
    assert script["port"] == script["jax"]
    assert script["port"][1] == 503 and script["port"][7] == "done"


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_session_lifecycle_and_typed_errors(make_twins, port_backend):
    jt, pt = make_twins(port_backend, dict(capacity=2, chunk_steps=2))
    script = {}
    for t in (jt, pt):
        c = t.client()
        steps = [_http(t.url, "GET", "/v1/sessions/s999999")]
        sid = c.submit(size=32, steps=200_000)  # stays in flight for the test
        # both pumps admit it before its result is asked for (under load
        # one may still hold it queued: a race, not a difference)
        deadline = time.monotonic() + WAIT_S
        while c.poll(sid)["state"] == "queued" and time.monotonic() < deadline:
            time.sleep(0.01)
        steps.append(_http(t.url, "GET", f"/v1/sessions/{sid}/result"))
        steps.append(_http(t.url, "DELETE", f"/v1/sessions/{sid}"))
        steps.append(_http(t.url, "DELETE", f"/v1/sessions/{sid}"))
        poll = _http(t.url, "GET", f"/v1/sessions/{sid}")
        # steps_done depends on how far the pump got before the cancel
        steps.append((poll[0], poll[1], poll[2]["state"]))
        steps.append(_http(t.url, "GET", f"/v1/sessions/{sid}/result"))
        script[t.pkg] = [(s, ra, _mask(b) if isinstance(b, dict) else b) for s, ra, b in steps]
    assert script["port"] == script["jax"]
    assert [s[0] for s in script["port"]] == [404, 409, 200, 200, 200, 410]


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_http_hygiene_bad_bodies_and_routes(make_twins, port_backend):
    jt, pt = make_twins(port_backend, dict(capacity=1, chunk_steps=1), dict(max_body=512))
    bodies = [
        ("GET", "/nope", None),
        ("DELETE", "/healthz", None),
        ("POST", "/v1/sessions", b"{not json"),
        ("POST", "/v1/sessions", json.dumps({"board": ["0" * 600], "steps": 1}).encode()),
        ("POST", "/v1/sessions", json.dumps({"steps": 1}).encode()),
        ("POST", "/v1/sessions", json.dumps({"board": ["09"], "steps": 1}).encode()),
        ("POST", "/v1/sessions", json.dumps({"board": ["0110", "101"], "steps": 1}).encode()),
        ("POST", "/v1/sessions", json.dumps({"size": 8, "steps": -1}).encode()),
        ("POST", "/v1/sessions", json.dumps({"size": 8, "steps": 1, "rule": "bogus"}).encode()),
        ("POST", "/v1/sessions", json.dumps({"size": 4, "steps": 1, "rule": "bugs"}).encode()),
        ("GET", "/v1/debug/series?cursor=zap", None),
        ("GET", "/v1/sessions/s000000/stream?cursor=-1", None),
        ("PATCH", "/v1/sessions/s000000", None),
    ]
    script = {}
    for t in (jt, pt):
        got = [_http(t.url, m, p, data=d) for m, p, d in bodies]
        assert got[5][2]["run_id"] == t.gw.service.run_id
        _http(t.url, "GET", "/another/bogus/path")
        metrics = t.client().metrics()
        assert 'route="unmatched"' in metrics and "/another/bogus/path" not in metrics
        script[t.pkg] = [(s, ra, _mask(b)) for s, ra, b in got]
    assert script["port"] == script["jax"]
    assert [s[0] for s in script["port"]][:5] == [404, 405, 400, 413, 400]


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_pump_crash_is_not_a_clean_drain(make_twins, port_backend):
    jt, pt = make_twins(port_backend, dict(capacity=1, chunk_steps=1))
    script = {}
    for t in (jt, pt):
        def boom():
            raise RuntimeError("injected pump crash")

        t.gw.service.pump = boom
        created = _http(t.url, "POST", "/v1/sessions",
                        data=json.dumps({"size": 8, "steps": 5}).encode())
        assert t.gw.wait(timeout=WAIT_S), "a crash must still end the gateway"
        script[t.pkg] = (created[0], _mask(created[2]), str(t.gw.pump_error), t.gw.drained)
    assert script["port"] == script["jax"]
    assert script["port"][2] == "injected pump crash" and script["port"][3]


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_queue_full_maps_to_503_not_hang(make_twins, port_backend):
    jt, pt = make_twins(port_backend, dict(capacity=1, chunk_steps=1, max_queue=2),
                        dict(shed_high_water=0.0))
    refusals = {}
    for t in (jt, pt):
        c = t.client()
        admitted, seen = [], set()
        for _ in range(30):
            status, retry_after, body = _http(
                t.url, "POST", "/v1/sessions",
                data=json.dumps({"size": 16, "steps": 300_000}).encode())
            if status == 201:
                admitted.append(body["session"])
            else:
                seen.add((status, retry_after, body["error"]["code"]))
        # how many the slot and the queue took depends on the pump's timing;
        # the push-back and its shape must agree
        assert len(admitted) >= 2
        refusals[t.pkg] = seen
        for sid in admitted:
            c.cancel(sid)
    assert refusals["port"] == refusals["jax"] == {(503, "1", "queue_full")}


@pytest.mark.parametrize("port_backend", PORT_BACKENDS)
def test_each_client_talks_to_the_other_gateway(make_twins, port_backend):
    jt, pt = make_twins(port_backend, dict(capacity=4, chunk_steps=5))
    board = random_board(17, 23, density=0.35, seed=5)
    boards = []
    for gateway, client_cls in ((pt, JClient), (jt, GatewayClient)):
        c = client_cls(gateway.url, retries=4)
        sid = c.submit(board=board, rule="highlife", steps=13)
        assert c.wait(sid, timeout=WAIT_S)["state"] == "done"
        boards.append(c.result_board(sid))
        assert c.result(sid, fmt="rle")["rle"] == (
            GatewayClient(gateway.url).result(sid, fmt="rle")["rle"])
        seeded = c.submit(size=9, steps=4, seed=2, density=0.3)
        assert c.wait(seeded, timeout=WAIT_S)["state"] == "done"
        boards.append(c.result_board(seeded))
        assert c.healthz()["status"] == "ok" and c.readyz()["ready"] is True
    assert boards[0].tobytes() == boards[2].tobytes()
    assert boards[1].tobytes() == boards[3].tobytes()


def test_readyz_names_the_services_device(make_twins):
    # the port reports the device its engines run on: the CPU here
    jt, pt = make_twins("cuda", dict(capacity=1, chunk_steps=1))
    assert pt.gw.device_info(wait_s=10.0) == (1, "cpu")
    body = pt.client().readyz()
    assert (body["devices"], body["device_kind"]) == (1, "cpu")
    assert _mask(body) == {"ready": True, "draining": False, "devices": 1, "device_kind": "cpu"}


# -- the CLI: gateway, client and spill-store as processes --------------------
ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")


def _start(module, args, cwd, log):
    out = open(cwd / f"{log}.out", "w")
    proc = subprocess.Popen([sys.executable, "-m", module, *args], cwd=cwd, env=ENV,
                            stdout=out, stderr=subprocess.DEVNULL, text=True)
    return proc, cwd / f"{log}.out"


def _first_line(path, proc, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        text = path.read_text()
        if "\n" in text:
            return json.loads(text.splitlines()[0])
        assert proc.poll() is None, f"{path.name}: exited {proc.returncode}"
        time.sleep(0.05)
    raise AssertionError(f"no startup line in {path.name}")


def _stop(proc, path, timeout=60.0):
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=timeout)
    return rc, json.loads(path.read_text().strip().splitlines()[-1])


def test_gateway_cli_lines_match_the_jax_gateway(tmp_path):
    from tpu_life_torch.io.codec import write_board, write_config

    board = random_board(21, 30, density=0.4, seed=8)
    write_board(tmp_path / "data.txt", board)
    write_config(tmp_path / "grid_size_data.txt", 21, 30, 11)
    expect = _jax_driver_board(tmp_path, board, 11, "cli").tobytes()
    store, store_out = _start("tpu_life_torch", ["spill-store", "--root", "store", "--port", "0"],
                              tmp_path, "store")
    lines, procs = {}, [store]
    try:
        surl = _first_line(store_out, store)["url"]
        for pkg, args in (("tpu_life", ["--serve-backend", "numpy"]),
                          ("tpu_life_torch", ["--device", "cpu", "--spill-url", surl])):
            proc, out = _start(pkg, ["gateway", "--port", "0", "--chunk-steps", "4", *args],
                               tmp_path, pkg)
            procs.append(proc)
            startup = _first_line(out, proc)
            # the port's client against either gateway
            client = subprocess.run(
                [sys.executable, "-m", "tpu_life_torch", "client", "submit", "--url",
                 startup["url"], "--input-file", "data.txt", "--steps", "11", "--wait", "--output-file",
                 f"{pkg}.txt"],
                cwd=tmp_path, env=ENV, capture_output=True, text=True, timeout=120)
            assert client.returncode == 0, client.stderr
            assert json.loads(client.stdout)["state"] == "done"
            assert (tmp_path / f"{pkg}.txt").read_bytes() == (tmp_path / "out_cli.txt").read_bytes()
            lines[pkg] = (*_stop(proc, out), startup)
        assert _stop(store, store_out) == (0, {"mode": "spill-store", "stopped": True})
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    (jrc, jsum, jstart), (prc, psum, pstart) = lines["tpu_life"], lines["tpu_life_torch"]
    assert jrc == prc == 0 and expect
    assert set(pstart) == set(jstart) and pstart["device_kind"] == jstart["device_kind"] == "cpu"
    keys = ("mode", "capacity", "max_queue", "api_rate")
    assert {k: pstart[k] for k in keys} == {k: jstart[k] for k in keys}
    # the JAX CPU platform counts the host devices the test run forces; the
    # port's service runs on one CPU
    assert pstart["devices"] == 1
    assert (pstart["backend"], jstart["backend"]) == ("cuda", "numpy")
    assert set(psum) == set(jsum)
    assert (psum["sessions"], psum["done"], psum["failed"], psum["pump_error"]) == (
        jsum["sessions"], jsum["done"], jsum["failed"], jsum["pump_error"]) == (1, 1, 0, None)


@pytest.mark.parametrize("argv", [["--register", "FLEET"], ["--register", "FLEET", "--standby"],
                                  ["--standby"]])
def test_gateway_register_and_standby_join_a_port_fleet(argv, tmp_path, capsys):
    # a wire-registered worker joins a port control plane, keeps its lease
    # through heartbeats past the TTL and serves the fleet's sessions; a
    # --standby registration parks until recruited; --standby alone is
    # refused as the JAX gateway refuses it
    from tpu_life_torch import cli
    from tpu_life_torch.fleet import Fleet, FleetConfig, WorkerState
    from tpu_life_torch.models.rules import get_rule
    from tpu_life_torch.ops.reference import run_np

    if "FLEET" not in argv:
        assert cli.main(["gateway", "--port", "0", "--device", "cpu", *argv]) == 2
        assert "--standby needs --register" in capsys.readouterr().err
        return
    ttl = 1.5
    fleet = Fleet(FleetConfig(workers=0, port=0, lease_ttl_s=ttl, probe_interval_s=0.1,
                              log_dir=str(tmp_path / "logs")))
    fleet.start()
    url = f"http://127.0.0.1:{fleet.port}"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_life_torch", "gateway", "--port", "0", "--device", "cpu",
         *[url if a == "FLEET" else a for a in argv]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        startup = json.loads(proc.stdout.readline())
        parked = "--standby" in argv
        want = WorkerState.STANDBY if parked else WorkerState.READY
        sup = fleet.supervisor
        t_end = time.monotonic() + 30
        while not sup.workers or sup.workers[0].state is not want:
            assert time.monotonic() < t_end, sup.states()
            time.sleep(0.05)
        time.sleep(3 * ttl)  # three TTLs: only the heartbeats keep the lease
        w = sup.get("w0")
        assert w.state is want and w.remote and w.url == startup["url"]
        assert sup._c_lease_expired.value == 0
        if parked:
            assert sup.recruit() == "w0"
            while w.state is not WorkerState.READY:
                assert time.monotonic() < t_end + 3 * ttl, sup.states()
                time.sleep(0.05)
        client = GatewayClient(url, retries=6)
        board = random_board(16, 16, density=0.4, seed=12)
        sid = client.submit(board=board, rule="conway", steps=9)
        assert client.wait(sid, timeout=60)["state"] == "done" and sid.startswith("w0g1-")
        assert client.result_board(sid).tobytes() == run_np(board, get_rule("conway"), 9).tobytes()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        fleet.begin_drain()
        fleet.wait(timeout=10)
        fleet.close()
    assert proc.returncode == 0, err
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["registrar"] == {"registrations": 1, "fenced": 0, "worker": "w0",
                                    "generation": 1}
