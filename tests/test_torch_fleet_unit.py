"""The port's fleet units held to the JAX package's on the same scripted
inputs: the session registry, the balancer, placement, the router's
Prometheus merge, the supervisor's restart and breaker logic, the fan-out
hub's bookkeeping, the autoscaler's decisions and report, and the typed
errors.

Each scenario takes a namespace of one package's modules, runs on
injected clocks, fakes and scripted callables, and returns what it
observed; a test runs it once over ``tpu_life_torch`` and once over
``tpu_life`` and asserts the two records are equal.  No subprocess and no
socket here: tests/test_torch_fleet_http.py runs real port workers.
"""

import importlib
import json
from types import SimpleNamespace

import pytest

MODULES = ["obs", "fleet.balancer", "fleet.registry", "fleet.router", "fleet.supervisor",
           "fleet.placement", "fleet.autoscaler", "fleet.errors", "fleet.fanout",
           "obs.flight", "obs.timeseries"]


def _pkg(root: str) -> SimpleNamespace:
    ns = SimpleNamespace(root=root)
    for name in MODULES:
        setattr(ns, name.split(".")[-1], importlib.import_module(f"{root}.{name}"))
    return ns


PORT, JAX = _pkg("tpu_life_torch"), _pkg("tpu_life")


def twin(scenario, *args):
    """Run ``scenario`` over both packages; the port's record must equal
    the JAX package's."""
    got, want = scenario(PORT, *args), scenario(JAX, *args)
    assert got == want
    return got


def _raises(fn, *args, **kwargs):
    """The type name and message of what ``fn`` raises, or its value."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 — the record is the comparison
        return (type(e).__name__, str(e))


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class FakeWorker:
    def __init__(self, name, generation=1, devices=1):
        self.name = name
        self.generation = generation
        self.devices = devices


class FakeProc:
    def __init__(self, pid=1000, rc=None):
        self.pid = pid
        self.rc = rc
        self.killed = False
        self.terminated = False

    def poll(self):
        return self.rc

    def wait(self, timeout=None):
        return self.rc

    def terminate(self):
        self.terminated = True
        self.rc = 0

    def kill(self):
        self.killed = True
        self.rc = -9

    def die(self, rc=1):
        self.rc = rc


# -- registry and fleet sids ---------------------------------------------------
def _registry_scenario(M, max_pins):
    reg = M.registry.SessionRegistry(max_pins=max_pins)
    out = []
    sids = [reg.pin(f"w{i % 3}", 1 + i // 3, f"s{i:06d}") for i in range(7)]
    out.append(sids)
    reg.repin(sids[0], "w2", 5, "s000099")
    for fsid in [*sids, "s000000", "bogus", "w12g4-s000009", "w0g0-s1"]:
        pin = reg.resolve(fsid)
        out.append(None if pin is None else (pin.worker, pin.generation, pin.sid))
    reg.forget(sids[1])
    out.append(len(reg))
    for fsid in ("w3g2-s000007", "x1g1-s000000", "w1g-s0", "w1g2-"):
        pin = M.registry.parse_fleet_sid(fsid)
        out.append(None if pin is None else (pin.worker, pin.generation, pin.sid))
    out.append(M.registry.fleet_sid("w7", 12, "s000123"))
    return out


@pytest.mark.parametrize("max_pins", [1, 2, 5, 100])
def test_registry_pins_sids_and_evictions_agree(max_pins):
    twin(_registry_scenario, max_pins)


# -- the balancer ----------------------------------------------------------------
def _balancer_scenario(M, depths0, weights):
    clock = FakeClock()
    depths = dict(depths0)
    calls = []

    def fetch(w):
        calls.append((w.name, w.generation))
        d = depths[w.name]
        if d is None:
            raise ConnectionRefusedError("dead")
        return d

    workers = [FakeWorker(f"w{i}", devices=k) for i, k in enumerate(weights)]
    bal = M.balancer.LeastDepthBalancer(fetch, ttl_s=0.5, clock=clock)
    out = []
    for step in range(12):
        out.append([w.name for w in bal.candidates(workers)])
        out.append(len(calls))
        if step % 3 == 2:
            clock.t += 1.0
            for name in depths:
                if depths[name] is not None:
                    depths[name] = (depths[name] * 7 + step) % 5
        if step == 6:
            workers[0].generation += 1  # a restart: readings must not carry over
    out.append([bal.depth(w) for w in workers])
    out.append(sorted(bal._cache))
    return out


@pytest.mark.parametrize("depths,weights", [
    ({"w0": 5.0, "w1": 1.0}, (1, 1)),
    ({"w0": 0.0, "w1": 0.0}, (1, 1)),
    ({"w0": None, "w1": 2.0}, (1, 1)),
    ({"w0": 0.0, "w1": 0.0, "w2": 0.0}, (1, 4, 2)),
    ({"w0": 3.0, "w1": 3.0}, (4, 1)),
])
def test_balancer_picks_agree(depths, weights):
    twin(_balancer_scenario, depths, weights)


def _weighted_spread_scenario(M, weights, n):
    bal = M.balancer.LeastDepthBalancer(lambda w: 0.0, ttl_s=0.0, clock=FakeClock())
    workers = [FakeWorker(f"w{i}", devices=k) for i, k in enumerate(weights)]
    return [bal.candidates(workers)[0].name for _ in range(n)]


@pytest.mark.parametrize("weights", [(1, 4), (2, 2), (1, 2, 3), (8, 1)])
def test_weighted_spread_agrees(weights):
    picks = twin(_weighted_spread_scenario, weights, 40)
    assert len(set(picks)) == len(weights)


@pytest.mark.parametrize("text,name", [
    ("# TYPE serve_queue_depth gauge\nserve_queue_depth_other 9\nserve_queue_depth 3\n",
     "serve_queue_depth"),
    ("serve_queue_depth 3\n", "missing_metric"),
    ('serve_queue_depth{worker="w0"} 2\nserve_queue_depth 1.5e1\n', "serve_queue_depth"),
])
def test_prom_value_agrees(text, name):
    twin(lambda M: M.balancer.prom_value(text, name))


# -- the router's merged /metrics ---------------------------------------------
def _merge_scenario(M, depths):
    def registry_text(depth, requests):
        reg = M.obs.MetricsRegistry()
        reg.gauge("serve_queue_depth", "queue").set(depth)
        c = reg.counter("gw_requests_total", "reqs", labels=("route",))
        c.labels(route="/v1/sessions").inc(requests)
        reg.histogram("lat_seconds", "latency").observe(0.002 * depth)
        return reg.prom_text()

    fleet_reg = M.obs.MetricsRegistry()
    fleet_reg.counter("fleet_retry_total", "retries").inc(2)
    texts = [(None, fleet_reg.prom_text())]
    texts += [(f"w{i}", registry_text(d, 5 + i)) for i, d in enumerate(depths)]
    return M.router.merge_prom_texts(texts)


@pytest.mark.parametrize("depths", [(), (1,), (1, 4), (0, 2, 7)])
def test_merge_prom_texts_agrees(depths):
    merged = twin(_merge_scenario, depths)
    assert "fleet_retry_total 2" in merged


# -- typed errors --------------------------------------------------------------
ERRORS = [
    ("worker_lost", ("w1", "w1g2-s000003")),
    ("worker_lost", ("w1", "w1g2-s000003", "migration_failed")),
    ("migrating", ("w0g1-s000001",)),
    ("migrating", ("w0g1-s000001", 2.5)),
    ("fleet_unavailable", (3,)),
    ("no_ready_workers", (2,)),
    ("upstream_error", ("w0", "boom")),
    ("unknown_session", ("w9g9-s000000",)),
    ("lease_expired", ("w2", 7)),
    ("draining", ("w3",)),
    ("peer_unreachable", ("http://127.0.0.1:1", "refused")),
    ("unknown_worker", ("w5",)),
    ("bad_registration", ("url missing",)),
]


@pytest.mark.parametrize("name,args", ERRORS)
def test_typed_errors_agree(name, args):
    def scenario(M):
        e = getattr(M.errors, name)(*args)
        return (type(e).__name__, e.status, e.code, e.message, e.retry_after,
                json.dumps(e.body(), sort_keys=True) if hasattr(e, "body") else None)

    twin(scenario)


# -- placement -------------------------------------------------------------------
@pytest.mark.parametrize("spec,workers", [(None, 3), ("4", 3), ("1,4", 2), ("1,2,3", 2),
                                          ("0", 2), ("lots", 2), ("2,-1", 2)])
def test_parse_devices_per_worker_agrees(spec, workers):
    twin(lambda M: _raises(M.placement.parse_devices_per_worker, spec, workers))


@pytest.mark.parametrize("workers,counts,total", [
    (4, None, 10), (2, (1, 2), 8), (3, None, 3), (1, (4,), 4),
    (2, (4, 4), 4), (5, None, 4), (0, None, 4), (2, (1,), 4),
])
def test_cuda_slices_agree_with_the_jax_gpu_plan(workers, counts, total):
    # the arithmetic and the refusals are JAX's; only the overlay differs
    # (test_cuda_overlay_* below)
    def scenario(M):
        got = _raises(M.placement.plan_placements, workers, platform="gpu",
                      devices_per_worker=counts, total_devices=total)
        if got[0] != "ok":
            return got
        return [(p.worker, p.devices, p.kind, p.device_ids, p.env["CUDA_VISIBLE_DEVICES"])
                for p in got[1]]

    twin(scenario)


def test_cpu_plans_count_alike():
    def scenario(M):
        plans = M.placement.plan_placements(3, platform="cpu", devices_per_worker=(1, 4, 2))
        return [(p.worker, p.devices, p.kind, p.device_ids) for p in plans]

    assert twin(scenario) == [("w0", 1, "cpu", None), ("w1", 4, "cpu", None),
                              ("w2", 2, "cpu", None)]


def test_cuda_overlay_is_the_visible_devices_and_the_device_flag():
    # departure: the port's workers take their device from --device; no
    # JAX_PLATFORMS, no XLA flag
    plans = PORT.placement.plan_placements(4, platform="cuda", total_devices=10)
    assert [p.env for p in plans] == [{"CUDA_VISIBLE_DEVICES": "0,1,2"},
                                     {"CUDA_VISIBLE_DEVICES": "3,4,5"},
                                     {"CUDA_VISIBLE_DEVICES": "6,7"},
                                     {"CUDA_VISIBLE_DEVICES": "8,9"}]
    assert all(p.args == ("--device", "cuda") for p in plans)
    gpu = PORT.placement.plan_placements(2, platform="gpu", total_devices=2)
    assert [(p.kind, p.env, p.args) for p in gpu] == [
        ("gpu", {"CUDA_VISIBLE_DEVICES": "0"}, ("--device", "cuda")),
        ("gpu", {"CUDA_VISIBLE_DEVICES": "1"}, ("--device", "cuda"))]


def test_cpu_overlay_hides_the_cards_and_asks_for_the_cpu():
    plans = PORT.placement.plan_placements(2, platform="cpu", devices_per_worker=(1, 4))
    assert [(p.env, p.args) for p in plans] == [
        ({"CUDA_VISIBLE_DEVICES": ""}, ("--device", "cpu"))] * 2
    env = {"CUDA_VISIBLE_DEVICES": "0,1", "XLA_FLAGS": "--xla_foo", "PATH": "/bin"}
    PORT.placement.apply_env_overlay(env, plans[0].env)
    assert env == {"CUDA_VISIBLE_DEVICES": "", "XLA_FLAGS": "--xla_foo", "PATH": "/bin"}
    before = dict(env)
    assert PORT.placement.apply_env_overlay(env, {}) == before


def test_placement_refusals_name_the_ports_platforms():
    # the oversubscription refusal is JAX's word for word; the platform
    # names and the count hint are the port's
    P = PORT.placement
    with pytest.raises(P.PlacementError, match=r"unknown placement platform 'tpu' "
                       r"\(expected cpu, cuda, or gpu\)"):
        P.plan_placements(2, platform="tpu", total_devices=2)
    with pytest.raises(P.PlacementError, match="torch-free and cannot count the host's cards"):
        P.plan_placements(2, platform="cuda")
    msgs = [_raises(M.placement.plan_placements, 2, platform="gpu", devices_per_worker=(4, 4),
                    total_devices=4) for M in (PORT, JAX)]
    assert msgs[0] == msgs[1] and "oversubscribes the host" in msgs[0][1]


# -- the supervisor on fakes ---------------------------------------------------
def _make_sup(M, tmp_path, **cfg_kw):
    clock = FakeClock()
    procs, answers, spawned = {}, {}, {}

    def spawn(w):
        spawned.setdefault(w.name, []).append(dict(w.env_overlay))
        procs[w.name] = w.proc = FakeProc(pid=1000 + w.generation,
                                          rc=1 if w.name in cfg_kw.get("_born_dead", ()) else None)
        w.url = f"http://fake/{w.name}/g{w.generation}"
        answers.setdefault(w.name, "ready")

    kw = dict(workers=2, log_dir=str(tmp_path / f"logs-{M.root}"), backoff_base_s=1.0,
              backoff_max_s=8.0, breaker_threshold=3, healthy_after_s=10.0, unready_threshold=3)
    kw.update({k: v for k, v in cfg_kw.items() if not k.startswith("_")})
    s = M.supervisor.Supervisor(M.supervisor.FleetConfig(**kw), M.obs.MetricsRegistry(),
                                spawn=spawn, probe=lambda w: answers.get(w.name, "unreachable"),
                                clock=clock)
    with s._lock:
        for w in s.workers:
            s._spawn_worker(w, first=True)
    s.tick()
    return s, clock, procs, answers, spawned


def _snap(s):
    return [(w.name, w.state.value, w.generation, w.failures, round(w.restart_at, 6),
             w.devices, w.device_kind) for w in s.workers] + [s.restarts(), s.finished()]


def _crash_loop_scenario(M, tmp_path):
    s, clock, procs, answers, _ = _make_sup(M, tmp_path)
    out = [_snap(s)]
    for _ in range(12):
        w = s.workers[0]
        if w.proc is not None and w.proc.poll() is None:
            procs["w0"].die(rc=1)
        clock.t += 9.0
        s.tick()
        out.append(_snap(s))
    out.append([s._g_workers.labels(state=st.value).value for st in M.supervisor.WorkerState])
    return out


def _backoff_scenario(M, tmp_path):
    s, clock, procs, answers, _ = _make_sup(M, tmp_path)
    out = [_snap(s)]
    script = [(100.0, "die"), (100.0, None), (101.5, None), (101.5, None), (102.0, "die"),
              (103.0, None), (104.0, None), (104.5, None), (130.0, None)]
    for t, action in script:
        clock.t = t
        if action == "die":
            procs["w0"].die(rc=1)
        s.tick()
        out.append(_snap(s))
    return out


def _unready_and_drain_scenario(M, tmp_path):
    s, clock, procs, answers, _ = _make_sup(M, tmp_path)
    out = []
    answers["w0"] = "unreachable"
    for _ in range(s.config.unready_threshold):
        s.tick()
        out.append((_snap(s), procs["w0"].killed))
    clock.t += 100.0
    s.tick()
    answers["w1"] = "draining"
    s.tick()
    out.append(_snap(s))
    out.append([w.name for w in s.ready_workers()])
    s.begin_drain()
    out.append((procs["w0"].terminated, procs["w1"].terminated))
    clock.t += 1000.0
    s.tick()
    out.append((_snap(s), s.drained()))
    return out


def _placed_scenario(M, tmp_path):
    s, clock, procs, answers, spawned = _make_sup(
        M, tmp_path, placement="auto", devices_per_worker=(1, 4), placement_platform="cpu",
        breaker_threshold=5, _born_dead=("w1",))
    out = [_snap(s), s.capacities(), [len(v) for v in spawned.values()]]
    clock.t += 1000.0
    s.tick()
    out.append(_snap(s))
    procs["w0"].die(rc=1)
    clock.t += 1.0
    s.tick()
    clock.t += 5.0
    s.tick()
    out.append(_snap(s))
    out.append(spawned["w0"][0] == spawned["w0"][-1])
    out.append(M.supervisor.worker_weight(s.workers[0]))
    return out


@pytest.mark.parametrize("scenario", [_crash_loop_scenario, _backoff_scenario,
                                      _unready_and_drain_scenario, _placed_scenario],
                         ids=lambda f: f.__name__.strip("_"))
def test_supervisor_decisions_agree(scenario, tmp_path):
    twin(scenario, tmp_path)


def test_placed_supervisor_spawns_with_the_ports_overlay(tmp_path):
    s, clock, procs, answers, spawned = _make_sup(
        PORT, tmp_path, placement="auto", devices_per_worker=(1, 4), placement_platform="cpu")
    assert spawned == {"w0": [{"CUDA_VISIBLE_DEVICES": ""}], "w1": [{"CUDA_VISIBLE_DEVICES": ""}]}
    assert [w.placement_args for w in s.workers] == [("--device", "cpu")] * 2
    argv = s.worker_argv(s.workers[1])
    assert argv[-2:] == ["--device", "cpu"]


@pytest.mark.parametrize("kw", [
    dict(placement="auto", devices_per_worker=(4, 4), placement_platform="gpu", total_devices=4),
    dict(placement="sideways"),
])
def test_invalid_placements_fail_at_construction_alike(kw, tmp_path):
    def scenario(M):
        spawns = []
        got = _raises(M.supervisor.Supervisor,
                      M.supervisor.FleetConfig(workers=2, log_dir=str(tmp_path / M.root), **kw),
                      M.obs.MetricsRegistry(), spawn=spawns.append, probe=lambda w: "ready")
        return got[0], got[1], spawns

    twin(scenario)


# -- the fan-out hub -------------------------------------------------------------
def _key(seq, step=0):
    return {"type": "key", "seq": seq, "step": step, "h": 4, "w": 4,
            "rle": "x = 4, y = 4\n4b$4b$4b$4b!", "executor": "t", "crc": 0}


def _fanout_scenario(M, lives, cursor, max_reconnects):
    """``lives``: per upstream open, (first seq, frame count, how it ends:
    "end", "kill" or "refuse")."""
    calls = []

    def upstream(fsid, at):
        calls.append(at)
        if len(calls) > len(lives):
            raise ConnectionError("no route to worker")
        first, n, how = lives[len(calls) - 1]

        def life():
            if how == "refuse":
                raise ConnectionError("refused")
            yield _key(first, step=2 * first)
            for i in range(1, n):
                yield {"type": "delta", "seq": first + i, "step": 2 * (first + i),
                       "mask": "", "crc": 0}
            if how == "kill":
                raise ConnectionError("worker SIGKILLed mid-stream")
            yield {"type": "end", "seq": first + n, "state": "done"}
        return life()

    hub = M.fanout.FanoutHub(open_upstream=upstream, sleep=lambda s: None,
                             max_reconnects=max_reconnects)
    frames = list(hub.watch("w0g1-s000000", cursor=cursor))
    hub.close()
    return calls, [(f["type"], f["seq"], f.get("step"), f.get("state")) for f in frames]


@pytest.mark.parametrize("lives,cursor,max_reconnects", [
    ([(0, 9, "end")], 0, 8),
    ([(0, 5, "kill"), (18, 2, "end")], 0, 8),
    ([(0, 3, "kill"), (0, 1, "refuse"), (7, 4, "end")], 0, 8),
    ([], 0, 2),
    ([(0, 12, "end")], 4, 8),
])
def test_fanout_streams_agree(lives, cursor, max_reconnects):
    twin(_fanout_scenario, lives, cursor, max_reconnects)


def test_fanout_buffer_bound_refused_alike():
    twin(lambda M: _raises(M.fanout.FanoutHub, open_upstream=lambda f, c: iter(()),
                           buffer_frames=1))


# -- the autoscaler --------------------------------------------------------------
SIGNAL_SCRIPT = [
    dict(depth=10.0), dict(depth=10.0), dict(queue_age_s=6.0), dict(reject_rate=1.0),
    dict(mem_fraction=0.9), dict(breaching=True), dict(active=0, ready=0), dict(),
    dict(), dict(depth=4.0), dict(), dict(), dict(), dict(standby=0, depth=99.0),
    dict(active=4, depth=99.0), dict(), dict(active=1), dict(breaching=True), dict(),
]


def _decide_scenario(M, cfg_kw, dt):
    base = dict(active=2, standby=2, ready=2, depth=0.0, queue_age_s=0.0,
                reject_rate=0.0, mem_fraction=None, breaching=False)
    cfg = M.autoscaler.AutoscaleConfig(**cfg_kw)
    st = M.autoscaler.ControlState()
    out = []
    for i, kw in enumerate(SIGNAL_SCRIPT):
        sig = M.autoscaler.Signals(**{**base, **kw})
        d = M.autoscaler.decide(sig, st, cfg, now=i * dt)
        if d.action == "up":
            st.last_up_at = i * dt
        elif d.action == "down":
            st.last_down_at = i * dt
        out.append((d.action, d.reason, json.dumps(d.signals, sort_keys=True),
                    st.low_since, st.last_up_at))
    return out


@pytest.mark.parametrize("cfg_kw", [
    dict(min_workers=1, depth_high=4.0, depth_low=0.5, cooldown_up_s=5.0, cooldown_down_s=30.0,
         idle_grace_s=10.0),
    dict(min_workers=1, max_workers=4, cooldown_up_s=0.0, cooldown_down_s=0.0, idle_grace_s=0.5),
    dict(min_workers=2, scale_on_burn=False, idle_grace_s=1.0, cooldown_down_s=2.0),
])
@pytest.mark.parametrize("dt", [0.5, 3.0, 20.0])
def test_scale_decisions_agree(cfg_kw, dt):
    twin(_decide_scenario, cfg_kw, dt)


@pytest.mark.parametrize("bad", [dict(min_workers=-1), dict(min_workers=4, max_workers=2),
                                 dict(max_workers=0), dict(depth_low=4.0, depth_high=4.0),
                                 dict(depth_low=5.0, depth_high=4.0), dict(window_s=0),
                                 dict(idle_grace_s=-1), dict(cooldown_up_s=-0.1)])
def test_degenerate_scale_policies_are_refused_alike(bad):
    got = twin(lambda M: _raises(M.autoscaler.AutoscaleConfig, **bad))
    assert got[0] == "ValueError"


class _FakeScaleSup:
    def __init__(self, M, recruit_script):
        self.series_store = M.timeseries.SeriesStore()
        self._script = list(recruit_script)
        self.released = []

        class _Slo:
            def status(self):
                return {}

        self.slo_engine = _Slo()

    def scale_counts(self):
        return (0, 2)

    def ready_workers(self):
        return []

    def recruit(self):
        return self._script.pop(0)

    def release(self, name):
        self.released.append(name)
        return True


def _live_loop_scenario(M, script):
    M.flight.drain()
    sup = _FakeScaleSup(M, script)
    auto = M.autoscaler.Autoscaler(M.autoscaler.AutoscaleConfig(cooldown_up_s=300.0), sup)
    out = []
    for t in (0.0, 0.1, 0.2, 0.3):
        if not sup._script:
            break
        d = auto.evaluate(now=t)
        out.append((d.action, d.reason, d.worker, auto.state.last_up_at, auto.decisions))
    out.append([(e["kind"], e.get("reason")) for e in M.flight.drain()
                if e["kind"].startswith("scale.")])
    return out


@pytest.mark.parametrize("script", [[None, "w3"], [None, None, None], ["w2", "w3"]])
def test_live_scale_loop_agrees(script):
    twin(_live_loop_scenario, script)


def _ev(ts_us, action, **args):
    return {"name": f"flight.scale.{action}", "ts": ts_us, "args": args}


SCALE_DOCS = [
    {"traceEvents": []},
    {"traceEvents": [
        _ev(3_000_000, "down", reason="idle", worker="w3", active=3, standby=0,
            depth_per_ready=0.0),
        _ev(1_000_000, "up", reason="queue_depth", worker="w3", active=2, standby=1,
            depth_per_ready=6.5),
        _ev(2_000_000, "hold", reason="cooldown_up", active=3, standby=0, depth_per_ready=5.0),
        {"name": "flight.slo.breach", "ts": 0, "args": {}},
    ]},
    {"traceEvents": [_ev(5, "hold", reason="recruit_failed", active=1, standby=2)]},
]


@pytest.mark.parametrize("doc", SCALE_DOCS)
def test_scale_reports_agree(doc):
    def scenario(M):
        report = M.autoscaler.scale_report(json.loads(json.dumps(doc)))
        return report, M.autoscaler.render_scale_report(report)

    twin(scenario)
