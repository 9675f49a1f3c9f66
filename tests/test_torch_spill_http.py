"""The port's HTTP spill store and remote spill backend, held to the JAX
package's on the wire and through the fault matrix.

- The same session spilled through either package's store leaves the same
  object bytes (the manifest's trace id, which each service mints, is the
  one masked field).
- The port's ``HttpSpillBackend`` writes to the JAX store and the JAX
  backend to the port's; each package's ``read_remote_sessions`` reads what
  the other wrote.
- The fault matrix of ``tests/test_crosshost.py`` (the cases that need no
  fleet module), with the port's backend against both packages' stores:
  CRC rot, a torn upload, path traversal, a timeout that heals, a torn
  read, bounded retries of refusals and typed 503s, a reset never resent,
  ``make_spill_backend``'s choice and refusals, and an unreachable store
  that degrades the session and not the service.
- A rescue read with ``read_remote_sessions`` and resumed in a fresh port
  service with ``start_step`` equals the uninterrupted run.
"""

import http.client
import json
import socket
import threading
import urllib.error
import urllib.request
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from tpu_life.models.patterns import random_board
from tpu_life.serve import ServeConfig as JServeConfig
from tpu_life.serve import SimulationService as JService
from tpu_life.serve import spill_http as jspill_http
from tpu_life_torch import chaos
from tpu_life_torch.mc import run_np as mc_run_np
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops.reference import run_np
from tpu_life_torch.serve import ServeConfig, SimulationService
from tpu_life_torch.serve import spill_http
from tpu_life_torch.serve.spill import (
    KEEP_SNAPSHOTS,
    SpillBackend,
    SpillStore,
    make_spill_backend,
)
from tpu_life_torch.serve.spill_http import (
    HttpSpillBackend,
    delete_remote_namespace,
    list_remote_namespaces,
    read_remote_sessions,
    snap_name,
)

PKGS = {"port": spill_http, "jax": jspill_http}


@pytest.fixture(params=["port", "jax"])
def store(request, tmp_path):
    """Either package's store: the port's backend must work against both."""
    srv = PKGS[request.param].SpillHTTPServer(str(tmp_path / "store"))
    srv.start()
    yield srv
    srv.close()


def _save(backend, sid, board, step, rule="conway", steps_total=50):
    return backend.save(sid, board, step, rule=rule, steps_total=steps_total,
                        seed=None, temperature=None, timeout_s=None)


def _tree(root):
    """{relative path: bytes} of a store directory, the manifests with their
    trace id masked."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            raw = p.read_bytes()
            if p.name == "manifest.json":
                doc = json.loads(raw)
                doc.pop("trace_id", None)
                raw = json.dumps(doc, sort_keys=True).encode()
            out[str(p.relative_to(root))] = raw
    return out


# -- the same bytes on disk, and the wire both ways ---------------------------
@pytest.mark.parametrize("port_backend", ["numpy", "cuda"])
def test_a_spilled_session_leaves_the_same_object_bytes(tmp_path, port_backend):
    board = random_board(20, 14, density=0.4, seed=31)
    trees = {}
    for pkg in ("jax", "port"):
        srv = PKGS[pkg].SpillHTTPServer(str(tmp_path / pkg))
        srv.start()
        try:
            kw = dict(capacity=2, chunk_steps=3, pipeline=False, spill_url=srv.url,
                      spill_namespace="ns", spill_every=1)
            if pkg == "jax":
                svc = JService(JServeConfig(backend="numpy", **kw))
            else:
                extra = {"device": "cpu"} if port_backend == "cuda" else {}
                svc = SimulationService(ServeConfig(backend=port_backend, **extra, **kw))
            svc.submit(board, "highlife", 40)
            for _ in range(4):  # four rounds, each followed by a spill pass
                svc.pump()
            trees[pkg] = _tree(tmp_path / pkg)
            svc.close()
        finally:
            srv.close()
    assert trees["port"] == trees["jax"]
    assert any(name.startswith("ns/s000000/snap_") for name in trees["port"])


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("reader", ["port", "jax"])
def test_wire_compatibility_both_ways(store, writer, reader):
    be = PKGS[writer].HttpSpillBackend(store.url, "a-w0g1")
    b1 = random_board(8, 9, seed=1, density=0.4)
    b2 = random_board(8, 9, seed=2, density=0.4)
    assert _save(be, "s000001", b1, 4) is True
    assert _save(be, "s000001", b1, 4) is False  # newest-step rewrite: no-op
    assert _save(be, "s000002", b2, 6, rule="highlife", steps_total=9) is True
    be.mark_disabled("s000003")
    records, corrupt, disabled = PKGS[reader].read_remote_sessions(store.url, "a-w0g1")
    assert (corrupt, disabled) == ([], ["s000003"])
    got = {r.sid: (r.step, r.steps_total, r.rule, r.board.tobytes()) for r in records}
    assert got == {"s000001": (4, 50, "conway", b1.tobytes()),
                   "s000002": (6, 9, "highlife", b2.tobytes())}
    assert PKGS[reader].list_remote_namespaces(store.url) == ["a-w0g1"]


def test_retention_and_delete_match_the_jax_backend(store):
    be = HttpSpillBackend(store.url, "ns1")
    b = random_board(8, 8, seed=2)
    for step in (4, 6, 8, 10):
        _save(be, "s000001", b, step)
    bare = sorted(p.name for p in (store.root / "ns1" / "s000001").iterdir()
                  if p.name.startswith("snap_") and not p.name.endswith(".crc32"))
    assert bare == [snap_name(8), snap_name(10)] and KEEP_SNAPSHOTS == 2
    _save(be, "s000002", b, 2)
    be.delete("s000002")
    records, corrupt, disabled = read_remote_sessions(store.url, "ns1")
    assert [r.sid for r in records] == ["s000001"] and (corrupt, disabled) == ([], [])
    delete_remote_namespace(store.url, "ns1")
    assert list_remote_namespaces(store.url) == []


# -- the fault matrix ---------------------------------------------------------
def test_remote_crc_rot_demotes_then_types_corrupt(store):
    be = HttpSpillBackend(store.url, "ns2")
    b1 = random_board(8, 8, seed=3, density=0.4)
    b2 = random_board(8, 8, seed=4, density=0.4)
    _save(be, "s000009", b1, 4)
    _save(be, "s000009", b2, 8)
    d = store.root / "ns2" / "s000009"
    for step in (8, 4):
        raw = bytearray((d / snap_name(step)).read_bytes())
        raw[0] ^= 0x01  # storage rot under the newest snapshot, then its predecessor
        (d / snap_name(step)).write_bytes(bytes(raw))
        records, corrupt, _ = read_remote_sessions(store.url, "ns2")
        if step == 8:
            assert corrupt == [] and records[0].step == 4
            assert records[0].board.tobytes() == b1.tobytes()
    assert (records, corrupt) == ([], ["s000009"])


def test_remote_truncated_stored_body_demotes(store):
    be = HttpSpillBackend(store.url, "ns3")
    b1 = random_board(8, 8, seed=5, density=0.4)
    _save(be, "s000004", b1, 4)
    _save(be, "s000004", b1, 8)
    f = store.root / "ns3" / "s000004" / snap_name(8)
    f.write_bytes(f.read_bytes()[: max(1, f.stat().st_size // 2)])  # torn
    records, corrupt, _ = read_remote_sessions(store.url, "ns3")
    assert corrupt == [] and records[0].step == 4


def test_store_put_refuses_torn_upload_before_publishing(store):
    body = b"x" * 64
    for crc in (str((zlib.crc32(body) + 1) & 0xFFFFFFFF), None):
        req = urllib.request.Request(store.url + "/v1/spill/ns/s1/obj", data=body, method="PUT")
        if crc is not None:
            req.add_header("X-CRC32", crc)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 400
        if crc is not None:
            assert json.loads(ei.value.read())["error"]["code"] == "crc_mismatch"
    # refuse-BEFORE-publish: the store never holds witness-less bytes
    assert not (store.root / "ns" / "s1" / "obj").exists()


@pytest.mark.parametrize("path", ["/v1/spill/ns/../other", "/v1/spill/../x/y", "/v1/spill/ns/.hidden"])
def test_store_refuses_path_traversal(store, path):
    conn = http.client.HTTPConnection(store.host, store.port, timeout=5)
    conn.request("GET", path)
    assert conn.getresponse().status == 400
    conn.close()
    with pytest.raises(ValueError):
        HttpSpillBackend(store.url, "../escape")


@pytest.mark.chaos
def test_remote_timeout_surfaces_as_oserror_then_heals(store):
    chaos.arm(chaos.ChaosPlan(
        0, {"spill.remote.timeout": {"rate": 1.0, "mode": "timeout", "times": 1}}))
    try:
        be = HttpSpillBackend(store.url, "ns4", sleep=lambda s: None)
        b = random_board(8, 8, seed=6)
        with pytest.raises(OSError):
            _save(be, "s000001", b, 2)  # a timeout is ambiguous: no retry
        assert _save(be, "s000001", b, 2) is True  # times=1: healed
    finally:
        chaos.disarm()


@pytest.mark.chaos
def test_remote_torn_read_body_demotes_to_predecessor(store):
    be = HttpSpillBackend(store.url, "ns5")
    b1 = random_board(8, 8, seed=7, density=0.4)
    b2 = random_board(8, 8, seed=8, density=0.4)
    _save(be, "s000002", b1, 4)
    _save(be, "s000002", b2, 8)
    chaos.arm(chaos.ChaosPlan(
        0, {"spill.remote.torn_body": {"rate": 1.0, "mode": "torn", "times": 1}}))
    try:
        records, corrupt, _ = read_remote_sessions(store.url, "ns5")
    finally:
        chaos.disarm()
    assert corrupt == [] and records[0].step == 4
    assert records[0].board.tobytes() == b1.tobytes()


def _dead_url() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens: every connect is a definitive refusal
    return f"http://127.0.0.1:{port}"


def test_connection_refused_retries_bounded_then_oserror():
    naps = []
    be = HttpSpillBackend(_dead_url(), "ns", retries=3, backoff_s=0.01, max_backoff_s=0.02,
                          sleep=naps.append)
    with pytest.raises(OSError):
        _save(be, "s000001", random_board(8, 8, seed=9), 2)
    assert len(naps) == 3 and all(0 < n <= 0.02 for n in naps)


class ScriptedServer:
    """A misbehaving HTTP peer: each request consumes the next scripted
    behaviour (``503`` / ``503ra`` (Retry-After: 5) / ``500`` / ``reset`` /
    ``torn`` / ``ok``) — transport faults a healthy store never produces."""

    def __init__(self, script):
        self.script = list(script)
        self.requests = 0
        outer = self

        class _H(BaseHTTPRequestHandler):
            def _do(self):
                outer.requests += 1
                mode = outer.script.pop(0) if outer.script else "ok"
                if mode == "reset":
                    self.connection.close()  # mid-exchange: no status line
                    return
                n = int(self.headers.get("Content-Length") or 0)
                if n:
                    self.rfile.read(n)
                if mode in ("503", "503ra", "500"):
                    self.send_response(int(mode[:3]))
                    if mode == "503ra":
                        self.send_header("Retry-After", "5")
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                elif mode == "torn":
                    body = b'{"sids": {}}'
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(body) * 9))
                    self.end_headers()
                    self.wfile.write(body)  # short body, then close
                    self.connection.close()
                else:
                    self.send_response(200)
                    self.send_header("Content-Length", "2")
                    self.end_headers()
                    self.wfile.write(b"{}")

            do_GET = do_PUT = do_DELETE = _do

            def log_message(self, *a):
                pass

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), _H)
        self._srv.daemon_threads = True
        self.url = f"http://127.0.0.1:{self._srv.server_address[1]}"
        threading.Thread(target=self._srv.serve_forever, daemon=True).start()

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("script,saved,naps_want,requests", [
    (["503", "503", "ok", "ok"], True, "two paced", 4),
    (["503ra", "503", "ok", "ok"], True, "hint then curve", 4),
    (["500"], OSError, [], 1),
    (["reset"], OSError, [], 1),
    (["torn"], OSError, None, None),
])
def test_scripted_transport_faults_alike(pkg, script, saved, naps_want, requests):
    # the port's backend and the JAX backend meet each scripted fault alike
    srv = ScriptedServer(script)
    try:
        naps = []
        be = PKGS[pkg].HttpSpillBackend(srv.url, "ns", retries=3, backoff_s=0.01,
                                        max_backoff_s=0.02, sleep=naps.append)
        if saved is OSError:
            with pytest.raises(OSError):
                _save(be, "s000001", random_board(8, 8, seed=10), 2)
        else:
            assert _save(be, "s000001", random_board(8, 8, seed=10), 2) is saved
        if naps_want == "two paced":
            assert len(naps) == 2 and all(n <= 0.02 for n in naps)
        elif naps_want == "hint then curve":
            assert naps[0] == 5.0 and naps[1] <= 0.02  # the store's hint, verbatim
        elif naps_want is not None:
            assert naps == naps_want
        if requests is not None:
            assert srv.requests == requests
    finally:
        srv.close()


def test_torn_namespace_listing_is_oserror_on_the_read_path():
    srv = ScriptedServer(["torn"])
    try:
        with pytest.raises(OSError):
            read_remote_sessions(srv.url, "ns")
    finally:
        srv.close()


def test_garbled_crc_header_on_read_demotes_not_aborts():
    class _H(BaseHTTPRequestHandler):
        def do_GET(self):
            body = b"xx"
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-CRC32", "not-a-number")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), _H)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/x"
        assert spill_http._fetch_snapshot(url, 8, 8, timeout_s=2.0) is None
    finally:
        srv.shutdown()
        srv.server_close()


# -- the SpillBackend seam at the service -------------------------------------
def test_make_spill_backend_selects_and_rejects(tmp_path):
    assert isinstance(make_spill_backend(spill_dir=str(tmp_path / "x")), SpillStore)
    be = make_spill_backend(spill_url="http://127.0.0.1:1", namespace="n1")
    assert isinstance(be, HttpSpillBackend) and be.namespace == "n1"
    assert make_spill_backend(spill_url="http://127.0.0.1:1").namespace == "default"
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_spill_backend(spill_dir=str(tmp_path / "x"), spill_url="http://127.0.0.1:1")
    with pytest.raises(ValueError, match="local-directory feature"):
        make_spill_backend(spill_url="http://127.0.0.1:1", replicas=2)
    with pytest.raises(ValueError):
        SimulationService(ServeConfig(backend="numpy", spill_dir=str(tmp_path / "x"),
                                      spill_url="http://127.0.0.1:1"))


class _FailingBackend(SpillBackend):
    """Every write fails."""

    def __init__(self):
        self.disabled = []

    def save(self, sid, board, step, **kw):
        raise OSError("injected backend failure")

    def mark_disabled(self, sid):
        self.disabled.append(sid)

    def delete(self, sid):
        pass

    def spilled_count(self):
        return 0

    def spilled_sids(self):
        return []


def test_failing_backend_degrades_session_never_the_service(tmp_path):
    svc = SimulationService(ServeConfig(capacity=2, chunk_steps=4, backend="numpy",
                                        spill_dir=str(tmp_path / "unused"), spill_every=1))
    svc._spill = _FailingBackend()
    board = random_board(16, 16, seed=14, density=0.4)
    sid = svc.submit(board, "conway", 24)
    svc.drain()
    assert svc.store.result(sid).tobytes() == run_np(board, get_rule("conway"), 24).tobytes()
    assert svc._c_spill_errors.value >= 1 and svc._spill.disabled == [sid]


@pytest.mark.parametrize("port_backend", ["numpy", "cuda"])
def test_unreachable_remote_store_degrades_to_spill_disabled(port_backend):
    extra = {"device": "cpu"} if port_backend == "cuda" else {}
    svc = SimulationService(ServeConfig(capacity=2, chunk_steps=4, backend=port_backend,
                                        spill_url=_dead_url(), spill_namespace="ns",
                                        spill_every=1, **extra))
    svc._spill.retries = 0  # keep the refusal loop short
    board = random_board(16, 16, seed=15, density=0.4)
    sid = svc.submit(board, "conway", 24)
    svc.drain()
    assert svc.store.result(sid).tobytes() == run_np(board, get_rule("conway"), 24).tobytes()
    assert svc.store.get(sid).spill_disabled
    assert svc._c_spill_errors.value >= 1
    svc.close()


# -- a rescue read back and resumed ------------------------------------------
@pytest.mark.parametrize("port_backend,rule,temperature", [
    ("numpy", "conway", None),
    ("cuda", "conway", None),
    ("cuda", "brians_brain", None),
    ("cuda", "ising", 2.27),
    ("numpy", "ising", 2.27),
])
def test_rescue_resumed_in_a_fresh_service_equals_the_uninterrupted_run(
        store, port_backend, rule, temperature):
    extra = {"device": "cpu"} if port_backend == "cuda" else {}
    r = get_rule(rule)
    board = random_board(16, 12, density=0.45, seed=21, states=r.states)
    total = 30
    if temperature is None:
        oracle = run_np(board, r, total)
    else:
        oracle = mc_run_np(r, board, 5, total, temperature=temperature)
    svc = SimulationService(ServeConfig(capacity=2, chunk_steps=4, backend=port_backend,
                                        pipeline=False, spill_url=store.url,
                                        spill_namespace="victim", spill_every=1, **extra))
    svc.submit(board, rule, total, seed=5 if temperature else None, temperature=temperature)
    for _ in range(3):
        svc.pump()  # 12 steps, each round's spill pass published; then the "kill"
    records, corrupt, disabled = read_remote_sessions(store.url, "victim")
    assert (corrupt, disabled) == ([], []) and len(records) == 1
    rec = records[0]
    assert 0 < rec.step < total and rec.steps_total == total
    fresh = SimulationService(ServeConfig(capacity=2, chunk_steps=4, backend=port_backend,
                                          **extra))
    sid = fresh.submit(rec.board, rec.rule, rec.steps_total - rec.step, seed=rec.seed,
                       temperature=rec.temperature, start_step=rec.step)
    fresh.drain()
    assert fresh.store.result(sid).tobytes() == np.asarray(oracle, np.int8).tobytes()
    fresh.close()
