"""The port's fleet end to end on the CPU: real ``python -m tpu_life_torch
gateway`` workers behind the port's router.

Workers run ``--device cpu --serve-backend cuda``, so the plain versions
of K1's and K6's batch modes are on the tested path.  Every served and
every migrated board must be byte-equal to the port's ``run_np`` (held to
the JAX package's oracle by tests/test_torch_copies.py); the ``fleet``
CLI's lines carry the JAX ``fleet``'s keys; and with no card and no
``--device cpu`` the fleet fails in its workers' startup instead of
carrying on on the CPU.

Each test has a deadline of its own (SIGALRM), and every worker a test
started is killed at teardown, whatever the test's outcome.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from tpu_life_torch.fleet import Fleet, FleetConfig, WorkerState
from tpu_life_torch.gateway.client import GatewayClient
from tpu_life_torch.models.patterns import random_board
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops.reference import run_np

REPO_ROOT = Path(__file__).resolve().parents[1]
CPU_WORKER = ("--device", "cpu", "--serve-backend", "cuda")


def _reap(marker: str) -> None:
    """SIGKILL every process whose command line names ``marker`` (a
    test's tmp_path): workers live in sessions of their own, so a dead
    fleet CLI's process group does not reach them."""
    for pid_dir in Path("/proc").iterdir():
        if not pid_dir.name.isdigit() or int(pid_dir.name) == os.getpid():
            continue
        try:
            cmd = (pid_dir / "cmdline").read_bytes().replace(b"\0", b" ").decode()
        except OSError:
            continue
        if marker in cmd:
            try:
                os.kill(int(pid_dir.name), signal.SIGKILL)
            except OSError:
                pass


@pytest.fixture
def deadline():
    """``deadline(s)``: fail the test with TimeoutError after s seconds."""

    def on_alarm(signum, frame):
        raise TimeoutError("test deadline passed")

    prev = signal.signal(signal.SIGALRM, on_alarm)
    yield lambda seconds: signal.alarm(int(seconds))
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture
def make_fleet(tmp_path):
    """Start an N-worker port fleet on ephemeral ports; always drain, close
    and reap at teardown."""
    fleets = []

    def _make(workers=2, worker_args=(*CPU_WORKER, "--capacity", "4", "--chunk-steps", "4"),
              **cfg):
        fleet = Fleet(FleetConfig(workers=workers, port=0, worker_args=tuple(worker_args),
                                  log_dir=str(tmp_path / "logs"), probe_interval_s=0.1,
                                  backoff_base_s=0.2, healthy_after_s=2.0, **cfg))
        fleets.append(fleet)
        fleet.start()
        assert fleet.wait_ready(timeout=90, min_workers=workers), fleet.supervisor.states()
        return fleet, GatewayClient(f"http://127.0.0.1:{fleet.port}", retries=8)

    yield _make
    for fleet in fleets:
        fleet.begin_drain()
        fleet.wait(timeout=30)
        fleet.close()
    _reap(str(tmp_path))


def _compile_counts(metrics_text: str) -> dict:
    out: dict = {}
    for line in metrics_text.splitlines():
        if line.startswith("serve_engine_compile_count{"):
            labels, _, value = line.rpartition(" ")
            worker = labels.split('worker="', 1)[1].split('"', 1)[0]
            out.setdefault(worker, []).append(float(value))
    return out


def test_twenty_staggered_sessions_byte_equal_run_np(make_fleet, deadline):
    deadline(150)
    fleet, client = make_fleet(worker_args=(*CPU_WORKER, "--capacity", "8", "--chunk-steps", "7"))
    boards = [random_board(24, 19, density=0.4, seed=300 + i) for i in range(20)]
    budgets = [1 + (7 * i) % 43 for i in range(20)]
    sids = [client.submit(board=b, rule="conway", steps=n) for b, n in zip(boards, budgets)]
    for sid in sids:
        assert client.wait(sid, timeout=120)["state"] == "done"
    conway = get_rule("conway")
    for sid, board, steps in zip(sids, boards, budgets):
        assert client.result_board(sid).tobytes() == run_np(board, conway, steps).tobytes()
    by_worker: dict = {}
    for sid in sids:
        by_worker.setdefault(sid.split("g")[0], []).append(sid)
    assert set(by_worker) == {"w0", "w1"}
    assert all(len(v) >= 3 for v in by_worker.values()), by_worker
    # one build per compile key per worker: the cuda engine of K1's batch
    # mode (its plain version here)
    metrics = client.metrics()
    assert _compile_counts(metrics) == {"w0": [1.0], "w1": [1.0]}
    assert 'compile_key="B3/S23:24x19:cuda"' in metrics
    for w in ("w0", "w1"):
        n = sum(1 for s in sids if s.startswith(w + "g"))
        assert f'fleet_routed_total{{worker="{w}"}} {n}' in metrics


def test_sigkilled_worker_fails_isolated_rejoins_and_its_sessions_migrate_equal(
        make_fleet, tmp_path, deadline):
    deadline(180)
    fleet, client = make_fleet(
        worker_args=(*CPU_WORKER, "--capacity", "4", "--chunk-steps", "2"),
        spill_dir=str(tmp_path / "spill"), spill_every=1)
    conway, ising = get_rule("conway"), get_rule("ising")
    boards = [random_board(32, 32, density=0.45, seed=40 + i) for i in range(4)]
    sids = [client.submit(board=b, rule="conway", steps=4000) for b in boards]
    spin = random_board(16, 16, density=0.5, seed=9)
    isid = client.submit(board=spin, rule="ising", steps=600, seed=5, temperature=2.27)
    owner = {sid: client.poll(sid)["worker"] for sid in [*sids, isid]}
    victim_name = owner[sids[0]]
    # the victim has spilled progress before the kill
    t_end = time.monotonic() + 60
    while client.poll(sids[0])["steps_done"] < 40:
        assert time.monotonic() < t_end
        time.sleep(0.05)
    victim = fleet.supervisor.get(victim_name)
    gen0 = victim.generation
    os.kill(victim.proc.pid, signal.SIGKILL)
    # every session, the victim's included, ends done and equal to the
    # oracle: the victim's resumed from its spill on the survivor
    for sid, board in zip(sids, boards):
        view = client.wait(sid, timeout=150)
        assert view["state"] == "done", view
        assert client.result_board(sid).tobytes() == run_np(board, conway, 4000).tobytes()
    assert client.wait(isid, timeout=150)["state"] == "done"
    from tpu_life_torch.mc import run_np as mc_run_np

    want = mc_run_np(ising, spin, 5, 600, temperature=2.27)
    assert client.result_board(isid).tobytes() == want.tobytes()
    moved = [s for s in sids if owner[s] == victim_name]
    assert fleet.stats()["migrations"]["migrated"] >= len(moved)
    # the victim respawned (a fresh generation) and rejoined the rotation
    t_end = time.monotonic() + 60
    while not (victim.generation > gen0 and victim.state is WorkerState.READY):
        assert time.monotonic() < t_end, fleet.supervisor.states()
        time.sleep(0.1)
    hit = {client.wait(client.submit(size=8, steps=1, seed=i), timeout=60)["worker"]
           for i in range(6)}
    assert victim_name in hit, hit


def _fleet_cli(pkg: str, tmp_path: Path, extra: list[str], env_extra: dict | None = None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    env["PYTHONPATH"] = str(REPO_ROOT) + (os.pathsep + env["PYTHONPATH"]
                                          if env.get("PYTHONPATH") else "")
    return subprocess.Popen(
        [sys.executable, "-m", pkg, "fleet", "--workers", "2", "--port", "0",
         "--metrics-dir", str(tmp_path / pkg / "metrics"), "--log-dir", str(tmp_path / pkg / "logs"),
         "--spill-dir", str(tmp_path / pkg / "spill"), "--trace-dir", str(tmp_path / pkg / "trace"),
         "--probe-interval", "0.1", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True, cwd=REPO_ROOT)


def _serve_then_drain(proc, n_sessions: int):
    start = json.loads(proc.stdout.readline())
    t_end = time.monotonic() + 90
    while True:
        try:
            with urllib.request.urlopen(start["url"] + "/readyz", timeout=1) as r:
                if json.load(r)["workers_ready"] == 2:
                    break
        except OSError:
            pass
        assert time.monotonic() < t_end, "fleet never became ready"
        time.sleep(0.2)
    client = GatewayClient(start["url"], retries=6)
    boards = [random_board(16, 16, density=0.4, seed=i) for i in range(n_sessions)]
    sids = [client.submit(board=b, rule="conway", steps=8) for b in boards]
    results = []
    for sid in sids:
        assert client.wait(sid, timeout=60)["state"] == "done"
        results.append(client.result_board(sid))
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=90)
    return start, json.loads(out.strip().splitlines()[-1]), boards, results, err


def test_fleet_cli_sigterm_drains_to_exit_zero_with_the_jax_lines(tmp_path, deadline):
    deadline(200)
    procs = {"tpu_life_torch": _fleet_cli("tpu_life_torch", tmp_path, ["--device", "cpu"]),
             "tpu_life": _fleet_cli("tpu_life", tmp_path, ["--serve-backend", "numpy"])}
    got = {}
    try:
        for pkg, proc in procs.items():
            got[pkg] = _serve_then_drain(proc, 4)
            assert proc.returncode == 0, got[pkg][4]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        _reap(str(tmp_path))
    (pstart, psum, boards, results, _), (jstart, jsum, *_) = got["tpu_life_torch"], got["tpu_life"]
    assert set(pstart) == set(jstart) and pstart["backend"] == "cuda"
    assert set(psum) == set(jsum)
    assert psum["failed_workers"] == [] and sum(psum["routed"].values()) == 4.0
    conway = get_rule("conway")
    for board, res in zip(boards, results):
        assert res.tobytes() == run_np(board, conway, 8).tobytes()
    # the per-worker sinks merge keyed by run_id into one report
    from tpu_life_torch.obs import stats as obs_stats

    records = []
    for sink in sorted((tmp_path / "tpu_life_torch" / "metrics").glob("*.jsonl")):
        records.extend(obs_stats.load_records(str(sink)))
    merged = obs_stats.summarize(records)
    assert len(merged["run_ids"]) == 2 and merged["serve"]["sessions_done"] == 4
    # the trace captures are one format: each package's merge reads the
    # other's capture to the same document
    from tpu_life.obs import journey as jjourney
    from tpu_life_torch.obs import journey

    for pkg in ("tpu_life_torch", "tpu_life"):
        capture = str(tmp_path / pkg / "trace")
        doc = journey.merge_captures(capture)
        assert json.dumps(doc) == json.dumps(jjourney.merge_captures(capture))
        assert len(doc["otherData"]["workers"]) == 3  # the control plane and two workers


def test_heterogeneous_placement_spawns_each_worker_into_its_slice(make_fleet, deadline):
    # the CPU overlay: --device cpu and no visible card for every worker;
    # the planned counts (1, 4) are the startup view, and each worker's
    # report overrides them (a CPU worker has one device)
    deadline(120)
    fleet, client = make_fleet(worker_args=("--serve-backend", "cuda", "--capacity", "4"),
                               placement="auto", devices_per_worker=(1, 4),
                               placement_platform="cpu")
    sup = fleet.supervisor
    assert [w.env_overlay for w in sup.workers] == [{"CUDA_VISIBLE_DEVICES": ""}] * 2
    for w in sup.workers:
        argv = (Path("/proc") / str(w.proc.pid) / "cmdline").read_bytes().split(b"\0")
        assert argv[argv.index(b"--device") + 1] == b"cpu"
        env = (Path("/proc") / str(w.proc.pid) / "environ").read_bytes().split(b"\0")
        assert b"CUDA_VISIBLE_DEVICES=" in env
        with urllib.request.urlopen(w.url + "/readyz", timeout=5) as r:
            doc = json.loads(r.read())
        assert (doc["devices"], doc["device_kind"]) == (1, "cpu")
    assert sup.capacities() == {"w0": {"devices": 1, "device_kind": "cpu", "weight": 1.0},
                                "w1": {"devices": 1, "device_kind": "cpu", "weight": 1.0}}
    conway = get_rule("conway")
    for i in range(6):
        board = random_board(16, 16, density=0.4, seed=70 + i)
        sid = client.submit(board=board, rule="conway", steps=3)
        assert client.wait(sid, timeout=60)["state"] == "done"
        assert client.result_board(sid).tobytes() == run_np(board, conway, 3).tobytes()
    assert set(fleet.stats()["routed"]) == {"w0", "w1"}
    assert client.healthz()["devices_total"] == 2


def test_no_card_and_no_device_cpu_fails_in_the_workers_startup(tmp_path, deadline):
    # no fallback: with the card hidden, the workers' cuda engines refuse
    # the CPU, every breaker opens and the fleet exits 1 on its own
    deadline(120)
    proc = _fleet_cli("tpu_life_torch", tmp_path, ["--max-restarts", "0"],
                      env_extra={"CUDA_VISIBLE_DEVICES": ""})
    try:
        out, err = proc.communicate(timeout=100)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        _reap(str(tmp_path))
    assert proc.returncode == 1, (out, err)
    start, summary = (json.loads(line) for line in out.strip().splitlines()[-2:])
    assert start["backend"] == "cuda"
    assert summary["failed_workers"] == ["w0", "w1"] and summary["routed"] == {}
    logs = "".join(p.read_text() for p in (tmp_path / "tpu_life_torch" / "logs").glob("w*.log"))
    assert "--device cpu" in logs  # the typed refusal: CudaUnavailableError


# -- state carried across the packages: spills ---------------------------------
class _FakeWorker:
    def __init__(self, name, generation):
        self.name, self.generation, self.alive = name, generation, True


class _FakeSupervisor:
    def __init__(self, workers):
        self.workers = workers

    def ready_workers(self):
        return list(self.workers)


class _PassBalancer:
    def candidates(self, workers):
        return list(workers)

    def invalidate(self, worker):
        pass


def _service(pkg: str, **kw):
    import importlib

    serve = importlib.import_module(f"{pkg}.serve")
    backend = dict(backend="cuda", device="cpu") if pkg == "tpu_life_torch" else dict(
        backend="numpy")
    return serve.SimulationService(serve.ServeConfig(capacity=4, chunk_steps=4, pipeline=False,
                                                     **backend, **kw))


@pytest.mark.parametrize("spiller,rescuer", [("tpu_life", "tpu_life_torch"),
                                             ("tpu_life_torch", "tpu_life")])
def test_one_packages_spills_resume_through_the_others_migrator(spiller, rescuer, tmp_path):
    # the per-incarnation layout (worker_spill_dir), the spill files and
    # the resume request are shared byte for byte: a dead worker of one
    # package is rescued by the other's Migrator onto its service
    import importlib

    from tpu_life_torch.mc import run_np as mc_run_np

    S = {m: importlib.import_module(f"{spiller}.{m}") for m in ("fleet.migrate",)}
    R = {m: importlib.import_module(f"{rescuer}.{m}")
         for m in ("fleet.migrate", "fleet.registry", "gateway.protocol", "obs")}
    root = tmp_path / "spill"
    assert (S["fleet.migrate"].worker_spill_dir(root, "w0", 1)
            == R["fleet.migrate"].worker_spill_dir(root, "w0", 1))
    dead = _service(spiller, spill_dir=str(S["fleet.migrate"].worker_spill_dir(root, "w0", 1)),
                    spill_every=1)
    conway, ising = get_rule("conway"), get_rule("ising")
    work = [(random_board(32, 32, density=0.45, seed=80 + i), "conway", 300, {}) for i in range(3)]
    work.append((random_board(16, 16, density=0.5, seed=88), "ising", 120,
                 dict(seed=11, temperature=2.27)))
    sids = [dead.submit(b, rule, steps, **kw) for b, rule, steps, kw in work]
    for _ in range(5):
        dead.pump()  # a few spilled rounds; then the worker "dies"
    survivor = _service(rescuer)
    sessions = R["fleet.registry"].SessionRegistry()
    fsids = [sessions.pin("w0", 1, sid) for sid in sids]
    protocol = R["gateway.protocol"]
    resumed_at = []

    def forward(worker, method, path, *, body=None, api_key=None):
        spec = protocol.parse_submit(json.loads(body))
        resumed_at.append(spec.start_step)
        sid = survivor.submit(spec.board, spec.rule, spec.steps, seed=spec.seed,
                              temperature=spec.temperature, start_step=spec.start_step)
        return 201, None, {"session": sid}

    t = [0.0]
    mig = R["fleet.migrate"].Migrator(
        spill_root=str(root), supervisor=_FakeSupervisor([_FakeWorker("w1", 3)]),
        sessions=sessions, registry=R["obs"].MetricsRegistry(), balancer=_PassBalancer(),
        forward=forward, clock=lambda: t[0], sleep=lambda s: t.__setitem__(0, t[0] + s),
        timeout_s=5.0)
    mig._active[("w0", 1)] = mig.clock()
    mig._run("w0", 1)
    survivor.drain()
    assert len(resumed_at) == 4 and min(resumed_at) > 0  # from the spills, not from scratch
    for fsid, (board, rule, steps, kw) in zip(fsids, work):
        pin = sessions.resolve(fsid)
        assert (pin.worker, pin.generation) == ("w1", 3)
        got = survivor.result(pin.sid)
        want = (run_np(board, conway, steps) if rule == "conway"
                else mc_run_np(ising, board, kw["seed"], steps, temperature=kw["temperature"]))
        assert got.tobytes() == want.tobytes()
    assert not R["fleet.migrate"].worker_spill_dir(root, "w0", 1).exists()
    survivor.close()
    dead.close()
