"""The port's chaos drills held to the JAX package's.

- seed 7's default 2-worker drill end to end on the CPU (workers ``--device
  cpu --serve-backend cuda``: the plain versions of K1's and K6's batch
  modes): every invariant, the replay stamp, every item delivered;
- the drill's workload, oracles, plan and kill draws for seeds 0-7 equal
  the JAX drill's, in every mode;
- the cross-host control plane (leases, fencing, the worker-side
  ``Registrar``) on an injected clock and a scripted http callable, twin
  scenarios over both packages;
- the engines' salvage of a slot loaded while a chunk flies, the fault
  the ``cuda`` governor drill found (the JAX engine keeps it; ROADMAP §C);
- no fallback: with no card and no ``--device cpu`` the drill's workers
  fail at startup and the drill fails.

Tests that arm the port's ``chaos`` carry the ``chaos`` marker; the
autouse guard below holds every test of this file to the port's disarmed
path as ``tests/conftest.py`` holds the JAX package's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_life import chaos as jchaos
from tpu_life import obs as jobs
from tpu_life.chaos import drill as jdrill
from tpu_life.fleet import membership as jmembership
from tpu_life.fleet import supervisor as jsupervisor
from tpu_life_torch import chaos, obs
from tpu_life_torch.chaos import drill
from tpu_life_torch.fleet import membership, supervisor

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT = SimpleNamespace(chaos=chaos, drill=drill, obs=obs, membership=membership,
                       supervisor=supervisor)
JAX = SimpleNamespace(chaos=jchaos, drill=jdrill, obs=jobs, membership=jmembership,
                      supervisor=jsupervisor)


@pytest.fixture(autouse=True)
def _port_chaos_disarmed_guard(request):
    """Outside the tests marked ``chaos``, no injection of the port's plan
    may fire, and no test may leave a port plan armed."""
    before = chaos.injection_count()
    yield
    if request.node.get_closest_marker("chaos") is None:
        assert chaos.injection_count() == before, "a port injection fired unarmed"
    assert not chaos.armed(), "a port chaos plan is still armed after the test"


def twin(scenario, *args):
    got, want = scenario(PORT, *args), scenario(JAX, *args)
    assert got == want
    return got


# -- seed 7's drill end to end -------------------------------------------------
@pytest.mark.chaos
def test_two_worker_drill_masks_the_default_fault_mix(tmp_path):
    cfg = drill.DrillConfig(seed=7, workers=2, det_sessions=4, ising_sessions=1, steps=900,
                            kills=1, device="cpu", workdir=str(tmp_path), wait_timeout_s=150,
                            summary_file=str(tmp_path / "drill.jsonl"))
    assert cfg.backend == "cuda"
    summary = drill.run_drill(cfg)
    failed = {k: v["violations"] for k, v in summary["invariants"].items() if not v["ok"]}
    assert summary["ok"], failed
    assert set(summary["invariants"]) == {"all_terminal", "bit_identity", "legal_410",
                                          "no_lost_work", "recovery_bounded",
                                          "metrics_consistent"}
    assert summary["seed"] == 7 and summary["plan"]["points"] == drill.DEFAULT_POINTS
    digest = chaos.ChaosPlan(7, drill.DEFAULT_POINTS).digest()
    assert summary["plan_digest"] == digest == jchaos.ChaosPlan(7, jdrill.DEFAULT_POINTS).digest()
    real_kills = [k for k in summary["kills"] if k.get("recovery_s") is not None]
    assert real_kills and all(k["recovery_s"] <= cfg.recovery_bound_s for k in real_kills)
    for point in ("spill.write", "snapshot.corrupt", "router.submit.reset"):
        assert summary["injections"].get(point, 0) >= 1, summary["injections"]
    assert summary["delivered"] == summary["sessions"] == 5
    assert not chaos.armed()
    assert (tmp_path / "drill.jsonl").read_text().count("\n") == 1


# -- the workload, oracles, plan and kill draws --------------------------------
def _driller_scenario(M, seed, mode):
    cfg = M.drill.DrillConfig(seed=seed, workers=2, det_sessions=3, ising_sessions=1,
                              size=12, steps=60, lenia_sessions=1, surge_factor=2,
                              **({mode: True} if mode else {}))
    d = M.drill._Driller(cfg)
    items = [(i.tag, i.rule, i.board.tobytes(), i.steps, i.seed, i.temperature, i.oracle,
              json.dumps(i.edits), i.continuous, i.api_key, i.phase) for i in d.items]
    draws = [d._draw("drill.kill", k) for k in range(4)]
    return items, d.plan.spec(), d.plan.digest(), draws


@pytest.mark.parametrize("mode", [None, "governor", "stream", "surge"])
@pytest.mark.parametrize("seed", range(8))
def test_driller_items_plan_and_kill_draws_agree(seed, mode):
    # ising oracles through MCHostRunner, Conway through run_np, the stream
    # drill's through replay_edit_log (Lenia allclose): the same bytes
    twin(_driller_scenario, seed, mode)


def test_the_drill_defaults_to_the_card():
    # departure: the JAX drill defaults to numpy, a CPU fleet
    cfg, jcfg = drill.DrillConfig(), jdrill.DrillConfig()
    assert (cfg.backend, cfg.device, jcfg.backend) == ("cuda", None, "numpy")
    from tpu_life_torch.chaos.crosshost import CrossHostConfig, _shim

    xcfg = CrossHostConfig(device="cpu")
    assert xcfg.backend == "cuda" and _shim(xcfg, {}).device == "cpu"
    from tpu_life_torch import cli

    args = cli.build_parser().parse_args(["chaos"])
    assert (args.backend, args.device) == ("cuda", None)
    args = cli.build_parser().parse_args(["fleet"])
    assert (args.serve_backend, args.device) == ("cuda", None)


# -- the cross-host control plane ------------------------------------------------
class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _control(M, tmp_path):
    clock = FakeClock()
    cfg = M.supervisor.FleetConfig(workers=0, log_dir=str(tmp_path / f"logs-{id(M)}"),
                                   lease_ttl_s=10.0, spill_url="http://store.invalid:1",
                                   site="a-")
    s = M.supervisor.Supervisor(cfg, M.obs.MetricsRegistry(), spawn=lambda w: None,
                                probe=lambda w: "ready", clock=clock)
    return s, clock


def _api(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the record is the comparison
        return (type(e).__name__, getattr(e, "status", None), getattr(e, "code", None), str(e))


def _lease_scenario(M, tmp_path):
    s, clock = _control(M, tmp_path)
    exits = []
    s.on_worker_exit = lambda name, gen: exits.append((name, gen))
    out = [_api(s.register_worker, {"url": "http://127.0.0.1:9", "devices": "abc"}),
           _api(s.register_worker, {"mode": "gateway"}),
           _api(s.register_worker, {"mode": "gateway", "url": "http://127.0.0.1:9"})]
    s.tick()
    clock.t += 8
    out.append(_api(s.heartbeat, "w0", 1))
    clock.t += 8
    s.tick()
    out.append([w.name for w in s.ready_workers()])
    clock.t += 11
    s.tick()
    out += [list(exits), s.is_fenced("w0", 1), _api(s.heartbeat, "w0", 1)]
    out.append(_api(s.register_worker, {"url": "http://127.0.0.1:10", "worker": "w0"}))
    s.tick()
    out += [len(s.ready_workers()), _api(s.heartbeat, "w0", 2), _api(s.heartbeat, "w9", 1)]
    out.append(_api(s.register_worker, {"url": "http://127.0.0.1:11", "worker": "w1"}))
    out.append(_api(s.register_worker, {"url": "http://127.0.0.1:12", "worker": "../evil"}))
    out.append(_api(s.register_worker, {"url": "http://127.0.0.1:13", "worker": "w1"}))
    out.append(list(exits))
    s.begin_drain()
    out += [_api(s.heartbeat, "w1", 2), _api(s.heartbeat, "w0", 1),
            _api(s.register_worker, {"url": "http://127.0.0.1:14"}),
            s._c_lease_refused.value, s._c_lease_expired.value]
    return out


def test_leases_fences_and_reregistration_agree(tmp_path):
    twin(_lease_scenario, tmp_path)


def _injection_retention_scenario(M, tmp_path):
    s, _ = _control(M, tmp_path)
    s.register_worker({"url": "http://127.0.0.1:9"})
    w = s.get("w0")
    out = []
    with s._lock:
        s._record_injections_locked(w, {"spill.write|error": 3.0})
        s._record_injections_locked(w, {"spill.write|error": 2.0})
    out.append(s.injection_totals())
    with s._lock:
        w.generation += 1
        s._record_injections_locked(w, {"spill.write|error": 2.0})
    out.append(s.injection_totals())
    s.register_worker({"url": "http://127.0.0.1:9", "worker": "w0"})
    out.append(s.injection_totals())
    return out


def test_injection_retention_agrees(tmp_path):
    twin(_injection_retention_scenario, tmp_path)


def _scripted_http(script, seen, holder):
    """Answers from ``script`` ((status, body) or an exception to raise);
    once it runs out the registrar is stopped, so every loop ends."""

    def http(path, body):
        seen.append((path, body))
        if not script:
            holder[0]._stop.set()
            raise ConnectionError("script over")
        step = script.pop(0)
        if isinstance(step, Exception):
            raise step
        return step

    return http


REGISTRAR_SCRIPTS = {
    "register_beat_fence_reclaim": [
        (200, {"worker": "w0", "generation": 1, "lease_ttl_s": 0.3,
               "spill": {"namespace": "a-w0g1"}}),
        (200, {}),
        (410, {"error": {"code": "lease_expired"}}),
        (200, {"worker": "w0", "generation": 2, "lease_ttl_s": 0.3}),
    ],
    "refused_claim_registers_fresh": [
        (400, {"error": {"code": "bad_registration"}}),
        (200, {"worker": "w3", "generation": 1, "lease_ttl_s": 5.0}),
        (503, {"error": {"code": "draining"}}),
        (404, {"error": {"code": "unknown_worker"}}),
        (200, {"worker": "w3", "generation": 2, "lease_ttl_s": 5.0}),
    ],
    "transport_noise_backs_off": [
        ConnectionRefusedError("cp not up yet"),
        (500, {}),
        (200, {"worker": "w0", "generation": 1, "lease_ttl_s": 5.0}),
        OSError("reset"),
        (410, {"error": {"code": "lease_expired"}}),
        (200, {"worker": "w0", "generation": 2, "lease_ttl_s": 5.0}),
    ],
}


def _registrar_scenario(M, name, claim):
    import random

    random.seed(3)  # the backoff's jitter draws from the random module
    seen, grants, fences, naps, holder = [], [], [], [], []
    r = M.membership.Registrar(
        "http://cp", self_url="http://me:9", run_id="r1", on_grant=grants.append,
        on_fenced=fences.append, sleep=naps.append, standby=claim,
        device_info=lambda: (1, "cpu"),
        http=_scripted_http(list(REGISTRAR_SCRIPTS[name]), seen, holder),
        backoff_s=0.05, max_backoff_s=0.2)
    holder.append(r)
    if claim:
        r.worker, r.generation = "w0", 7
    out = []
    while not r._stop.is_set():
        grant = r._register_until_granted()
        out.append((r.worker, r.generation, r.registrations, grant))
        if grant is not None:
            r._heartbeat_until_fenced(grant)
            out.append((r.fenced_count, list(fences)))
    out += [seen, grants, len(naps), [0 < n <= 5.0 for n in naps]]
    return out


@pytest.mark.parametrize("name", sorted(REGISTRAR_SCRIPTS))
@pytest.mark.parametrize("claim", [False, True])
def test_registrar_on_scripted_http_agrees(name, claim):
    got = twin(_registrar_scenario, name, claim)
    assert any(g[3] is not None for g in got if isinstance(g, tuple) and len(g) == 4)


def test_the_cross_host_drill_refuses_kills_other_than_one(tmp_path):
    from tpu_life_torch.chaos.crosshost import CrossHostConfig, run_cross_host_drill

    with pytest.raises(chaos.ChaosError, match="exactly one adopter"):
        run_cross_host_drill(CrossHostConfig(kills=2, workdir=str(tmp_path)))


# -- the salvage of a slot loaded while a chunk flies ---------------------------
@pytest.mark.chaos
@pytest.mark.parametrize("rule_name", ["conway", "brians_brain:T", "ising"])
def test_a_slot_loaded_while_a_chunk_flies_salvages_its_own_board(rule_name):
    # the recovery ladder reloads every resident slot from salvage_slot
    # after a dispatch fault; a slot admitted behind the in-flight chunk
    # must come back as loaded (lag 0), not as the chunk's stale input
    from tpu_life_torch.models.rules import get_rule
    from tpu_life_torch.serve.engine import compile_key_for, make_engine

    rng = np.random.default_rng(5)
    b0, b1 = (rng.integers(0, 2, size=(16, 20), dtype=np.int8) for _ in range(2))
    rule = get_rule(rule_name)
    key = compile_key_for(rule, b0, "cuda")
    eng = make_engine(key, 2, 2, device=torch.device("cpu"))
    kw = dict(seed=3, temperature=2.27) if rule_name == "ising" else {}
    eng.load(0, b0, 10, **kw)
    eng.dispatch_chunk()
    eng.load(1, b1, 10, **kw)
    with chaos.armed_plan({"seed": 0, "points": {"engine.dispatch": {"mode": "fault"}}}):
        with pytest.raises(RuntimeError, match="injected device fault"):
            eng.dispatch_chunk()
    board, lag = eng.salvage_slot(1)
    assert lag == 0 and board.tobytes() == b1.tobytes()
    board, lag = eng.salvage_slot(0)
    assert lag == 2  # the in-flight chunk's steps: its input, as before


@pytest.mark.chaos
def test_the_jax_device_engine_salvages_the_stale_input_there():
    # the reference defect the port's engine does not copy (ROADMAP §C)
    from tpu_life.models.rules import get_rule
    from tpu_life.serve.engine import VmapEngine, compile_key_for

    rng = np.random.default_rng(5)
    b0, b1 = (rng.integers(0, 2, size=(16, 20), dtype=np.int8) for _ in range(2))
    eng = VmapEngine(compile_key_for(get_rule("conway"), b0, "jax"), 2, 2)
    eng.load(0, b0, 10)
    eng.dispatch_chunk()
    eng.load(1, b1, 10)
    with jchaos.armed_plan({"seed": 0, "points": {"engine.dispatch": {"mode": "fault"}}}):
        with pytest.raises(RuntimeError, match="injected device fault"):
            eng.dispatch_chunk()
    board, lag = eng.salvage_slot(1)
    assert lag == 0 and board.tobytes() != b1.tobytes()


# -- no fallback -------------------------------------------------------------------
def test_no_card_and_no_device_cpu_fails_the_drill_at_worker_startup(tmp_path):
    # the card hidden: every worker refuses the CPU typed and its breaker
    # opens; the drill cannot get a ready fleet and fails.  The wait for
    # readiness ends once every worker's log holds its refusal and every
    # breaker is open (however slowly the workers import torch), within a
    # limit of its own below the subprocess's
    code = (
        "import json, time\n"
        "from pathlib import Path\n"
        "import tpu_life_torch.fleet as F\n"
        "def wait_ready(self, timeout=60.0, min_workers=1):\n"
        "    deadline = time.monotonic() + 150.0\n"
        "    while time.monotonic() < deadline:\n"
        "        if len(self.supervisor.ready_workers()) >= min_workers:\n"
        "            return True\n"
        "        states = self.supervisor.states()\n"
        f"        logs = [Path({str(tmp_path / 'logs')!r}) / f'{{w}}.log' for w in states]\n"
        "        if all(v == 'failed' for v in states.values()) and all(\n"
        "                p.exists() and 'no CUDA device is available' in p.read_text()\n"
        "                for p in logs):\n"
        "            return False\n"
        "        time.sleep(0.2)\n"
        "    return False\n"
        "F.Fleet.wait_ready = wait_ready\n"
        "from tpu_life_torch.chaos.drill import DrillConfig, run_drill\n"
        "try:\n"
        f"    run_drill(DrillConfig(seed=7, det_sessions=1, ising_sessions=0, "
        f"workdir={str(tmp_path)!r}))\n"
        "except RuntimeError as e:\n"
        "    print(json.dumps({'error': str(e)}))\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO_ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=tmp_path, timeout=240)
    assert proc.returncode == 0, proc.stderr
    err = json.loads(proc.stdout.strip().splitlines()[-1])["error"]
    assert err.startswith("fleet never became ready") and "failed" in err
    logs = "".join(p.read_text() for p in (tmp_path / "logs").glob("w*.log"))
    assert "--device cpu" in logs and '"mode": "gateway"' not in logs
