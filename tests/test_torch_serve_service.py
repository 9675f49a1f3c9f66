"""The port's ``SimulationService`` against the JAX package's, on the CPU.

The same request stream goes through both services — the port's ``cuda``
engines on ``device="cpu"`` (K1's batch mode's plain version, K2's slot
loop and the plain-op route) against the JAX ``jax`` backend, the port's
``sharded`` slot loop against the JAX numpy oracle, and the numpy oracles
against each other — and they must agree on result boards
and session states, per-round admitted and retired counts under both
pumps, backpressure, deadlines under an injected clock, cancel and
``edit_cells``, spill files (byte for byte) and resume from them, the
governor's ``InsufficientMemory`` verdicts under the backend mapping, the
mesh tier's placement and result, the OOM ladder through the chaos seam
``engine.oom`` (the first OOM halves the chunk, the second demotes the key
to its host twin; a FATAL error never takes the ladder), the refusal of what this slice does not
serve yet, and of stochastic keys on ``sharded`` (the stochastic tier's
own cases are ``test_torch_mc_serve.py``'s).
Boards come from ``np.random.default_rng``.
"""

import json

import numpy as np
import pytest

from tpu_life import chaos as jchaos
from tpu_life import serve as jserve
from tpu_life.models import lenia as jlenia
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops.reference import run_np as jrun_np
from tpu_life_torch import chaos, serve
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.serve import engine

#: the port's serve backend beside the JAX package's, under the mapping
PAIRS = [("cuda", "jax"), ("sharded", "numpy"), ("numpy", "numpy")]


class FakeClock:
    """A clock the test moves: deadlines never sleep."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def services(backend, jbackend, *, clock=None, **cfg):
    base = dict(capacity=2, chunk_steps=4, max_queue=8, run_id="r0")
    base.update(cfg)
    kw = {"clock": clock} if clock is not None else {}
    port = serve.SimulationService(serve.ServeConfig(backend=backend, device="cpu", **base), **kw)
    jax = jserve.SimulationService(jserve.ServeConfig(backend=jbackend, **base), **kw)
    return port, jax


def boards(n, shape=(12, 14), seed=0, states=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, states, shape).astype(np.int8) for _ in range(n)]


def round_counts(st):
    """A round's admitted and retired counts and what it left resident."""
    return (st.admitted, st.completed, st.failed, st.evicted, st.steps_advanced, st.occupancy,
            st.slots, st.queue_depth)


def view_fields(v):
    return (v.state.value, v.steps, v.steps_done, v.error is None)


@pytest.mark.parametrize("backend,jbackend", PAIRS)
@pytest.mark.parametrize("pipeline", [True, False])
def test_request_stream_rounds_and_results_agree(backend, jbackend, pipeline):
    port, jax = services(backend, jbackend, pipeline=pipeline, capacity=3)
    reqs = [(b, rule, n) for b, rule, n in zip(
        boards(5, seed=1) + boards(3, seed=2, states=3),
        ["conway"] * 3 + ["highlife"] * 2 + ["brians_brain"] * 3,
        [9, 0, 4, 13, 7, 5, 12, 3])]
    sids = [], []
    rounds = [], []
    for i, (b, rule, n) in enumerate(reqs):
        for svc, out in zip((port, jax), sids):
            out.append(svc.submit(b, rule, n))
        if i % 3 == 2:  # staggered: pump between submissions
            for svc, rs in zip((port, jax), rounds):
                rs.append(round_counts(svc.pump()))
    while not (port.idle() and jax.idle()):
        for svc, rs in zip((port, jax), rounds):
            rs.append(round_counts(svc.pump()))
        assert len(rounds[0]) < 200
    assert rounds[0] == rounds[1]
    for sp, sj, (b, rule, n) in zip(*sids, reqs):
        assert view_fields(port.poll(sp)) == view_fields(jax.poll(sj))
        np.testing.assert_array_equal(port.result(sp), jax.result(sj))
        np.testing.assert_array_equal(port.result(sp), jrun_np(b, jget_rule(rule), n))
    ps, js = port.stats(), jax.stats()
    for k in ("done", "failed", "rounds", "pump", "batch_occupancy_mean", "rejections"):
        assert ps[k] == js[k], k
    assert set(ps) == set(js)
    assert len(port.scheduler.compile_counts()) == 3
    port.close()
    jax.close()


@pytest.mark.parametrize("backend,jbackend", PAIRS)
def test_backpressure_agrees(backend, jbackend):
    port, jax = services(backend, jbackend, max_queue=2, capacity=1)
    b = boards(1)[0]
    for svc, err in ((port, serve.QueueFull), (jax, jserve.QueueFull)):
        svc.submit(b, "conway", 10)
        svc.submit(b, "conway", 10)
        with pytest.raises(err):
            svc.submit(b, "conway", 10)
        assert len(svc.store) == 2 and len(svc.scheduler.queue) == 2
        svc.pump()
        svc.submit(b, "conway", 3)  # the queue took one into the batch
        svc.drain()
        assert svc.stats()["done"] == 3


@pytest.mark.parametrize("backend,jbackend", PAIRS)
def test_deadlines_under_an_injected_clock_agree(backend, jbackend):
    clk = FakeClock()
    port, jax = services(backend, jbackend, clock=clk, capacity=1, chunk_steps=2)
    b = boards(1, seed=3)[0]
    ids = []
    for svc in (port, jax):
        ids.append((svc.submit(b, "conway", 10_000, timeout_s=10.0),
                    svc.submit(b, "conway", 4),
                    svc.submit(b, "conway", 1000, timeout_s=5.0)))
        svc.pump()
    clk.t = 11.0
    for svc in (port, jax):
        svc.drain()
    for (hp, wp, qp), (hj, wj, qj) in [tuple(ids)]:
        for sp, sj in ((hp, hj), (wp, wj), (qp, qj)):
            vp, vj = port.poll(sp), jax.poll(sj)
            assert (vp.state.value, vp.steps_done) == (vj.state.value, vj.steps_done)
        assert "SessionTimeout" in port.poll(hp).error
        np.testing.assert_array_equal(port.result(wp), jax.result(wj))
        with pytest.raises(serve.SessionFailed):
            port.result(qp)


@pytest.mark.parametrize("backend,jbackend", PAIRS)
def test_cancel_and_edit_cells_agree(backend, jbackend):
    port, jax = services(backend, jbackend, capacity=2, chunk_steps=3)
    b1, b2, b3 = boards(3, seed=4)
    edits = [[1, 1, 1], [2, 3, 0], [5, 6, 1]]
    out = []
    for svc in (port, jax):
        keep = svc.submit(b1, "conway", 11)
        gone = svc.submit(b2, "conway", 50)
        queued = svc.submit(b3, "conway", 6)
        svc.pump()
        svc.edit_cells(keep, edits)
        assert svc.cancel(gone) is True
        assert svc.cancel(gone) is False
        svc.drain()
        out.append((svc.poll(keep), svc.poll(gone), svc.poll(queued), svc.result(keep),
                    svc.result(queued)))
    (kp, gp, qp, rp, rq), (kj, gj, qj, rj, rqj) = out
    assert view_fields(kp) == view_fields(kj) and view_fields(gp) == view_fields(gj)
    assert view_fields(qp) == view_fields(qj)
    np.testing.assert_array_equal(rp, rj)
    np.testing.assert_array_equal(rq, rqj)


@pytest.mark.parametrize("backend,jbackend", PAIRS)
@pytest.mark.parametrize("pipeline", [True, False])
def test_spill_files_byte_equal_and_resume(tmp_path, backend, jbackend, pipeline):
    from tpu_life.serve.spill import read_spill_sessions
    from tpu_life_torch.serve.spill import read_spill_sessions as port_read

    b = boards(1, seed=5, shape=(16, 20))[0]
    dirs = tmp_path / "port", tmp_path / "jax"
    port, jax = (serve.SimulationService(serve.ServeConfig(
        backend=backend, device="cpu", capacity=2, chunk_steps=4, run_id="r0", pipeline=pipeline,
        spill_dir=str(dirs[0]), spill_every=1)),
        jserve.SimulationService(jserve.ServeConfig(
            backend=jbackend, capacity=2, chunk_steps=4, run_id="r0", pipeline=pipeline,
            spill_dir=str(dirs[1]), spill_every=1)))
    for svc in (port, jax):
        svc.submit(b, "conway", 30)
        for _ in range(4):  # abandon mid-flight
            svc.pump()
    files = [sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file()) for d in dirs]
    assert files[0] == files[1] and files[0]
    for rel in files[0]:
        assert (dirs[0] / rel).read_bytes() == (dirs[1] / rel).read_bytes(), rel
    (rec,), corrupt, _ = port_read(dirs[0])
    assert corrupt == [] and 0 < rec.step < 30
    (jrec,), _, _ = read_spill_sessions(dirs[1])
    assert (rec.step, rec.rule, rec.remaining) == (jrec.step, jrec.rule, jrec.remaining)
    again = serve.SimulationService(serve.ServeConfig(backend=backend, device="cpu"))
    sid = again.submit(rec.board, rec.rule, rec.remaining, start_step=rec.step)
    again.drain()
    np.testing.assert_array_equal(again.result(sid), jrun_np(b, jget_rule("conway"), 30))
    assert (again.poll(sid).steps, again.poll(sid).steps_done) == (30, 30)


@pytest.mark.parametrize("backend,jbackend", PAIRS)
def test_insufficient_memory_verdicts_agree(backend, jbackend):
    from tpu_life.serve import governor as jgov
    from tpu_life_torch.serve import governor

    small, big = boards(1, shape=(16, 16))[0], boards(1, shape=(64, 64))[0]
    for rule, board in (("conway", small), ("highlife", big), ("lenia:mini", None)):
        pk = engine.compile_key_for(get_rule(rule), small if board is None else board, backend)
        jk = jserve.compile_key_for(jget_rule(rule), small if board is None else board, jbackend)
        assert governor.estimate_engine_bytes(pk, 4) == jgov.estimate_engine_bytes(jk, 4)
    budget = governor.estimate_engine_bytes(
        engine.compile_key_for(get_rule("conway"), small, backend), 2) + 100
    port, jax = services(backend, jbackend, memory_budget_bytes=budget)
    verdicts = []
    for svc, err in ((port, serve.InsufficientMemory), (jax, jserve.InsufficientMemory)):
        got = [svc.submit(small, "conway", 5)]
        for b in (small, big, boards(1, shape=(16, 16), seed=9)[0]):
            try:
                got.append(svc.submit(b, "highlife", 5))
            except err as e:
                got.append((e.transient, e.estimated_bytes, e.budget_bytes, e.mesh_eligible))
        verdicts.append([g if isinstance(g, tuple) else "ok" for g in got])
    assert verdicts[0] == verdicts[1]
    assert any(isinstance(v, tuple) for v in verdicts[0])


def test_mesh_tier_places_and_agrees():
    board = boards(1, shape=(40, 48), seed=6)[0]
    port, jax = services("cuda", "jax", mesh_devices=4, memory_budget_bytes=20_000, capacity=8,
                         chunk_steps=8)
    sids = [svc.submit(board, "conway", 21) for svc in (port, jax)]
    for svc in (port, jax):
        svc.drain()
    assert [k.backend for k in port.scheduler.engines] == ["mesh:2x2"]
    assert [k.backend for k in jax.scheduler.engines] == ["mesh:2x2"]
    np.testing.assert_array_equal(port.result(sids[0]), jax.result(sids[1]))
    np.testing.assert_array_equal(port.result(sids[0]), jrun_np(board, jget_rule("conway"), 21))


def _oom_services(pipeline):
    kw = dict(capacity=2, chunk_steps=4, pipeline=pipeline)
    return ((serve.SimulationService(serve.ServeConfig(backend="cuda", device="cpu", **kw)),
             chaos),
            (jserve.SimulationService(jserve.ServeConfig(backend="jax", **kw)), jchaos))


@pytest.mark.chaos
@pytest.mark.parametrize("rule", ["conway", "brians_brain", "conway:T"])
@pytest.mark.parametrize("pipeline", [True, False])
def test_oom_ladder_first_rung_halves_the_chunk(pipeline, rule):
    # one OOM: both packages rebuild the key's engine at half the chunk,
    # on the same executor family, and replay to the same board
    plan = {"seed": 1, "points": {"engine.oom": {"mode": "oom", "times": 1}}}
    b = boards(1, seed=7)[0]
    out = []
    for svc, mod in _oom_services(pipeline):
        with mod.armed_plan(plan):
            sid = svc.submit(b, rule, 12)
            svc.drain(max_rounds=120)
        v = svc.poll(sid)
        (eng,) = svc.scheduler.engines.values()
        assert eng.chunk_steps == 2 and type(eng).__name__ != "HostBatchEngine"
        out.append((v.state.value, v.degraded_reason, svc.result(sid).tobytes(),
                    svc.stats()["engine_recoveries"]))
        svc.close()
    assert out[0] == out[1]
    assert out[0][:2] == ("done", "oom_halved_chunk")
    assert out[0][2] == jrun_np(b, jget_rule(rule), 12).tobytes()


#: the rules of the host rung: K1's batch, K2's slot loop, the plain-op
#: batch, K6's and K7's batch modes and the float batch; (board, kwargs)
DEMOTED = {
    "brians_brain": (lambda: boards(1, seed=7, states=3)[0], {}),
    "conway:T": (lambda: boards(1, seed=7)[0], {}),
    "ising": (lambda: boards(1, shape=(12, 14), seed=7)[0], {"temperature": 2.0, "seed": 3}),
    "noisy:0.01/conway": (lambda: boards(1, seed=7)[0], {"seed": 3}),
    "lenia:orbium": (lambda: jlenia.seeded_board(32, 32, seed=1), {}),
}


def _second_oom_demotes_to_the_host(pipeline, rule):
    # both packages: the first OOM halves the chunk, the second demotes
    # the key to its bit-identical host twin, and the session finishes
    plan = {"seed": 1, "points": {"engine.oom": {"mode": "oom", "times": 2}}}
    make, kw = DEMOTED.get(rule, (lambda: boards(1, seed=7)[0], {}))
    b = make()
    out = []
    for svc, mod in _oom_services(pipeline):
        with mod.armed_plan(plan):
            sid = svc.submit(b, rule, 12, **kw)
            svc.drain(max_rounds=120)
        v = svc.poll(sid)
        (eng,) = svc.scheduler.engines.values()
        got = svc.result(sid)
        # a re-minted engine of the key stays demoted
        svc.scheduler.release_idle_engines()
        again = svc.submit(b, rule, 12, **kw)
        svc.drain(max_rounds=120)
        (minted,) = svc.scheduler.engines.values()
        assert type(minted) is type(eng)
        np.testing.assert_allclose(svc.result(again), got, atol=jlenia.FLOAT_ATOL, rtol=0)
        out.append(((v.state.value, v.degraded_reason, svc.stats()["engine_recoveries"],
                     type(eng).__name__, eng.chunk_steps), got))
        svc.close()
    (port, got), (jax, want) = out
    assert port == jax
    assert port[:3] == ("done", "oom_host_demoted", {"oom_halved_chunk": 1, "oom_host_demoted": 1})
    assert port[3] in ("HostBatchEngine", "MCHostEngine") and port[4] == 2
    if rule.startswith("lenia"):
        np.testing.assert_allclose(got, want, atol=jlenia.FLOAT_ATOL)
    else:
        assert got.tobytes() == want.tobytes()


@pytest.mark.chaos
@pytest.mark.parametrize("pipeline", [True, False])
def test_oom_ladder_through_the_chaos_seam(pipeline):
    _second_oom_demotes_to_the_host(pipeline, "conway")


@pytest.mark.chaos
@pytest.mark.parametrize("rule", sorted(DEMOTED))
@pytest.mark.parametrize("pipeline", [True, False])
def test_a_second_oom_demotes_the_key_to_its_host_twin(pipeline, rule):
    # the K2 slot loop, the plain-op batch, the stochastic and the float
    # batches, beside K1's batch above
    _second_oom_demotes_to_the_host(pipeline, rule)


def _raising(monkeypatch, exc, times):
    """``BatchEngine._run_chunk`` raises ``exc`` at its first ``times``
    calls (0: at every call)."""
    calls = []

    def run_chunk(self, boards):
        calls.append(1)
        if not times or len(calls) <= times:
            raise exc
        return run(self, boards)

    run = engine.BatchEngine._run_chunk
    monkeypatch.setattr(engine.BatchEngine, "_run_chunk", run_chunk)


def _cuda_on_cpu(pipeline):
    return serve.SimulationService(serve.ServeConfig(
        backend="cuda", device="cpu", capacity=2, chunk_steps=4, pipeline=pipeline))


@pytest.mark.chaos
@pytest.mark.parametrize("fatal", ["KernelBuildError", "CudaUnavailableError"])
@pytest.mark.parametrize("pipeline", [True, False])
def test_a_fatal_error_in_a_chunk_is_never_demoted(monkeypatch, pipeline, fatal):
    # a FATAL error that reads like an OOM (nvcc killed for memory) never
    # takes the ladder: it replays on the device engine until the budget
    # fails the key typed, and no host engine stands in for the kernel
    from tpu_life_torch.backends.base import CudaUnavailableError
    from tpu_life_torch.kernels._build import KernelBuildError

    cls = {"KernelBuildError": KernelBuildError, "CudaUnavailableError": CudaUnavailableError}
    _raising(monkeypatch, cls[fatal]("nvcc failed: out of memory"), 0)
    svc = _cuda_on_cpu(pipeline)
    sid = svc.submit(boards(1, seed=7)[0], "conway", 12)
    svc.drain(max_rounds=120)
    v = svc.poll(sid)
    assert v.state is serve.SessionState.FAILED and fatal in v.error
    assert v.degraded_reason is None and not svc.scheduler.demoted
    assert svc.stats()["engine_recoveries"] == {"replayed": 3, "budget_exhausted": 1}
    assert {type(e).__name__ for e in svc.scheduler.engines.values()} <= {"BatchEngine"}
    assert all(e.chunk_steps == 4 for e in svc.scheduler.engines.values())
    svc.close()


@pytest.mark.chaos
@pytest.mark.parametrize("pipeline", [True, False])
def test_a_non_oom_error_in_a_chunk_replays_on_the_device_engine(monkeypatch, pipeline):
    _raising(monkeypatch, RuntimeError("CUDA error: an illegal memory access was encountered"), 2)
    svc = _cuda_on_cpu(pipeline)
    b = boards(1, seed=7)[0]
    sid = svc.submit(b, "conway", 12)
    svc.drain(max_rounds=120)
    v = svc.poll(sid)
    assert v.state is serve.SessionState.DONE and v.degraded_reason is None
    assert svc.stats()["engine_recoveries"] == {"replayed": 2}
    (eng,) = svc.scheduler.engines.values()
    assert type(eng) is engine.BatchEngine and eng.chunk_steps == 4
    assert svc.result(sid).tobytes() == jrun_np(b, jget_rule("conway"), 12).tobytes()
    svc.close()


@pytest.mark.chaos
def test_a_demoted_key_reads_the_same_in_stats_prometheus_and_the_metrics_file(tmp_path):
    # the outcome names of the JAX service in stats(), the Prometheus
    # lines and the metrics file's stats summary
    from tpu_life.obs import stats as jstats
    from tpu_life_torch.obs import stats

    plan = {"seed": 1, "points": {"engine.oom": {"mode": "oom", "times": 2}}}
    got = []
    for (svc_cls, cfg_cls, mod, summarize), d in (
            ((serve.SimulationService, serve.ServeConfig, chaos, stats), tmp_path / "p"),
            ((jserve.SimulationService, jserve.ServeConfig, jchaos, jstats), tmp_path / "j")):
        d.mkdir()
        cfg = dict(backend="cuda" if mod is chaos else "jax", capacity=2, chunk_steps=4,
                   run_id="r0", metrics=True, metrics_file=str(d / "m.jsonl"),
                   prom_file=str(d / "p.prom"))
        if mod is chaos:
            cfg["device"] = "cpu"
        svc = svc_cls(cfg_cls(**cfg))
        with mod.armed_plan(plan):
            svc.submit(boards(1, seed=7)[0], "conway", 12)
            svc.drain(max_rounds=120)
        recoveries = svc.stats()["engine_recoveries"]
        svc.close()
        prom = sorted(line for line in (d / "p.prom").read_text().splitlines()
                      if line.startswith("serve_engine_recoveries_total"))
        summary = summarize.summarize(summarize.load_records(str(d / "m.jsonl")))
        got.append((recoveries, prom, summary["serve"]["engine_recoveries_by_outcome"]))
    assert got[0] == got[1]
    assert got[0][0] == {"oom_halved_chunk": 1, "oom_host_demoted": 1}
    assert any('outcome="oom_host_demoted"' in line for line in got[0][1])


@pytest.mark.chaos
def test_a_mesh_key_demotes_as_the_jax_package_does():
    # a mega-board key (mesh:2x2) walks the same ladder: halved, then its
    # host twin, the same board
    plan = {"seed": 1, "points": {"engine.oom": {"mode": "oom", "times": 2}}}
    port, jax = services("cuda", "jax", mesh_devices=4, memory_budget_bytes=20_000, capacity=8,
                         chunk_steps=8)
    board = boards(1, shape=(40, 48), seed=6)[0]
    out = []
    for svc, mod in ((port, chaos), (jax, jchaos)):
        with mod.armed_plan(plan):
            sid = svc.submit(board, "conway", 21)
            svc.drain(max_rounds=120)
        v = svc.poll(sid)
        ((key, eng),) = svc.scheduler.engines.items()
        out.append((key.backend, v.state.value, v.degraded_reason, type(eng).__name__,
                    eng.chunk_steps, svc.stats()["engine_recoveries"], svc.result(sid).tobytes()))
        svc.close()
    assert out[0] == out[1]
    assert out[0][:5] == ("mesh:2x2", "done", "oom_host_demoted", "HostBatchEngine", 4)
    assert out[0][6] == jrun_np(board, jget_rule("conway"), 21).tobytes()


def test_a_real_out_of_memory_error_walks_the_ladder():
    # torch.cuda.OutOfMemoryError's text is what is_oom reads
    from tpu_life_torch.runtime import recovery

    assert recovery.is_oom(RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"))


@pytest.mark.parametrize("spec,kw", [("ising", {"temperature": 2.0}),
                                     ("noisy:0.01/conway", {"seed": 3})])
def test_stochastic_keys_are_refused_before_anything_is_stored(spec, kw):
    # on sharded (no counter-based key schedule) refused typed at submit
    # and sweep, before anything is stored; on cuda served, equal to the
    # JAX service's session
    from tpu_life_torch import mc

    board = boards(1, shape=(8, 8))[0]
    port, _ = services("sharded", "numpy")
    with pytest.raises(mc.StochasticBackendError, match="key schedule"):
        port.submit(board, spec, 4, **kw)
    assert len(port.store) == 0 and not port.scheduler.engines
    with pytest.raises(mc.StochasticBackendError):
        port.sweep(board, "ising", 4, [1.0, 2.0])
    assert len(port.store) == 0
    port, jax = services("cuda", "jax")
    sids = [svc.submit(board, spec, 4, **kw) for svc in (port, jax)]
    for svc in (port, jax):
        svc.drain()
    np.testing.assert_array_equal(port.result(sids[0]), jax.result(sids[1]))
    assert port.poll(sids[0]).state is serve.SessionState.DONE


def test_what_waits_for_later_items_is_refused_at_construction():
    # the HTTP spill store and the host backends are ported: each constructs
    # (the host backends on a machine without a card too), as tuned does
    from tpu_life_torch.serve.spill_http import HttpSpillBackend

    svc = serve.SimulationService(serve.ServeConfig(backend="numpy", spill_url="http://localhost:1"))
    assert isinstance(svc._spill, HttpSpillBackend) and svc._spill.namespace == svc.run_id
    for name in ("stripes", "native"):
        assert serve.SimulationService(serve.ServeConfig(backend=name)).config.backend == name
    assert serve.SimulationService(serve.ServeConfig(backend="tuned", device="cpu"))
    with pytest.raises(ValueError, match="unknown serve backend"):
        serve.SimulationService(serve.ServeConfig(backend="jax"))


def test_exports_match_the_jax_package():
    assert serve.__all__ == jserve.__all__
    assert serve.ServeConfig().backend == "cuda" and jserve.ServeConfig().backend == "jax"
    port_fields = set(serve.ServeConfig.__dataclass_fields__)
    assert port_fields - set(jserve.ServeConfig.__dataclass_fields__) == {"device"}


def test_metrics_and_trace_sinks_carry_the_run(tmp_path):
    port, _ = services("cuda", "jax", metrics=True, metrics_file=str(tmp_path / "m.jsonl"),
                       trace_events=str(tmp_path / "t.json"), prom_file=str(tmp_path / "p.prom"))
    port.submit(boards(1)[0], "conway", 9)
    port.drain()
    port.close()
    recs = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert recs and all(r["run_id"] == "r0" for r in recs)
    trace = json.loads((tmp_path / "t.json").read_text())
    assert trace["otherData"]["run_id"] == "r0"
    names = {e["name"] for e in trace["traceEvents"]}
    assert "serve.compile" in names
    assert "serve_sessions_submitted_total" in (tmp_path / "p.prom").read_text()


@pytest.mark.parametrize("backend", ["cuda", "sharded"])
def test_no_card_is_the_tidy_error_of_run(backend, monkeypatch):
    # the device engines refuse to start on a machine without a card
    # unless the caller asks for the CPU; the numpy oracle needs none
    import torch

    from tpu_life_torch.backends.base import CudaUnavailableError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError, match="--device cpu"):
        serve.SimulationService(serve.ServeConfig(backend=backend))
    serve.SimulationService(serve.ServeConfig(backend=backend, device="cpu")).close()
    serve.SimulationService(serve.ServeConfig(backend="numpy")).close()


@pytest.mark.parametrize("backend", ["cuda", "sharded"])
def test_threads_hammer_submit_poll_against_a_pumping_service(backend):
    _hammer(backend, "conway")


def test_threads_hammer_the_k2_slot_loop():
    _hammer("cuda", "brians_brain")


def _hammer(backend, rule):
    # the gateway's topology: one thread pumps (settling outside the lock)
    # while more submitter threads than cores submit and poll; every
    # session is admitted and finished once, its result exact
    import os
    import sys
    import threading

    svc = serve.SimulationService(serve.ServeConfig(
        backend=backend, device="cpu", capacity=3, chunk_steps=3, max_queue=512))
    n_threads, per_thread = max(8, 2 * (os.cpu_count() or 1)), 4
    results, lock, errors = {}, threading.Lock(), []
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            if svc.idle():
                stop.wait(0.001)
            else:
                svc.pump()

    def submitter(tid):
        try:
            for i in range(per_thread):
                b = boards(1, shape=(10, 13), seed=1000 * tid + i)[0]
                n = 1 + (tid * per_thread + i) % 9
                sid = svc.submit(b, rule, n)
                with lock:
                    results[sid] = (b, n)
                assert svc.poll(sid).steps_done <= n
        except BaseException as e:  # surfaced after the join
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    pumper = threading.Thread(target=pump, daemon=True)
    try:
        pumper.start()
        threads = [threading.Thread(target=submitter, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert not errors, errors
        while not svc.idle():
            stop.wait(0.005)
    finally:
        stop.set()
        pumper.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not pumper.is_alive()
    assert len(results) == len(svc.store) == n_threads * per_thread
    jrule = jget_rule(rule)
    for sid, (b, n) in results.items():
        v = svc.poll(sid)
        assert v.state is serve.SessionState.DONE and v.steps_done == n
        np.testing.assert_array_equal(svc.result(sid), jrun_np(b, jrule, n))
    assert svc.stats()["done"] == n_threads * per_thread
    svc.close()


def test_device_info_reads_torch_cuda(monkeypatch):
    import torch

    from tpu_life_torch.serve import governor
    from tpu_life_torch.utils.platform import device_info

    assert device_info(device="cpu") == (1, "cpu")
    assert governor.resolve_budget(None, device="cpu") == governor.DEFAULT_BYTES_PER_DEVICE["cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_info() == (1, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert device_info() == (4, "cuda")
    assert governor.DEFAULT_BYTES_PER_DEVICE["cuda"] == 8 << 30
