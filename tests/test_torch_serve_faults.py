"""A chunk whose launches raise, on the port's device batch, on the CPU.

A launch can fail after the chunk issued some of its work: a plain op of
route ``ops`` that runs out of memory, or any CUDA error.  Under the
pipelined pump the chunk before it is still in flight then, and the
scheduler salvages every resident session from the engine and replays it
(``recover_engine``).  Here ``_run_chunk`` runs its launches and then
raises, at the second and third chunk, on every route of ``BatchEngine``
and its stochastic subclasses, with an OOM (which halves the chunk) and a
launch failure (which replays): every session must still end with the
numpy oracle's bytes (``run_np``, ``mc.run_np``), under both pumps.

The JAX package's ``VmapEngine`` moves its double buffer before it
launches, so its salvage there reads the in-flight chunk's output under
that chunk's lag: a reference defect the port does not copy, pinned below
beside the port's engine.  Boards come from ``np.random.default_rng``.
"""

import numpy as np
import pytest
import torch

from tpu_life import mc as jmc
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops.reference import run_np as jrun_np
from tpu_life_torch import serve
from tpu_life_torch.mc import engine as mc_engine
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.serve import engine

#: route -> (rule, submit kwargs, mc_packed, the engine class it builds)
ROUTES = {
    "k1_batch": ("conway", {}, True, engine.BatchEngine),
    "ops": ("conway:T", {}, True, engine.BatchEngine),
    "mc_packed": ("ising", {"temperature": 2.27}, True, mc_engine.MCPackedBatchEngine),
    "mc_roll": ("ising", {"temperature": 2.27}, False, mc_engine.MCBatchEngine),
    "mc_noisy": ("noisy:0.01/conway", {}, True, mc_engine.MCBatchEngine),
}
ERRORS = {
    "oom": "CUDA out of memory. Tried to allocate 2.00 GiB",
    "launch": "CUDA error: unspecified launch failure",
}
SHAPE, STEPS, CAPACITY, CHUNK = (16, 16), 24, 4, 4


def _faulting(monkeypatch, cls, at: int, message: str) -> list:
    """Make ``cls._run_chunk`` raise once, at its ``at``-th call, after it
    issued its launches; returns the list of the calls' route names."""
    run = cls._run_chunk
    calls = []

    def run_chunk(self, boards):
        out = run(self, boards)
        calls.append(self.route)
        if len(calls) == at:
            raise RuntimeError(message)
        return out

    monkeypatch.setattr(cls, "_run_chunk", run_chunk)
    return calls


def _oracle(rule, board, seed, kw):
    if rule.startswith(("ising", "noisy")):
        return jmc.run_np(jget_rule(rule), board, seed, STEPS, **kw)
    return jrun_np(board, jget_rule(rule), STEPS)


@pytest.mark.chaos
@pytest.mark.parametrize("at", [2, 3])
@pytest.mark.parametrize("error", sorted(ERRORS))
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("pipeline", [True, False])
def test_a_chunk_that_faults_mid_launch_replays_from_the_right_board(
        monkeypatch, pipeline, route, error, at):
    rule, kw, packed, cls = ROUTES[route]
    calls = _faulting(monkeypatch, cls, at, ERRORS[error])
    svc = serve.SimulationService(serve.ServeConfig(
        backend="cuda", device="cpu", capacity=CAPACITY, chunk_steps=CHUNK,
        pipeline=pipeline, mc_packed=packed))
    rng = np.random.default_rng(11)
    boards = [rng.integers(0, 2, SHAPE).astype(np.int8) for _ in range(3)]
    sids = [svc.submit(b, rule, STEPS, seed=i + 1, **kw) for i, b in enumerate(boards)]
    svc.drain(max_rounds=200)
    assert set(calls) == {route} and len(calls) > at
    outcome = "oom_halved_chunk" if error == "oom" else "replayed"
    assert svc.stats()["engine_recoveries"] == {outcome: 1}
    for i, (sid, b) in enumerate(zip(sids, boards)):
        assert svc.poll(sid).state is serve.SessionState.DONE
        np.testing.assert_array_equal(svc.result(sid), _oracle(rule, b, i + 1, kw))
    svc.close()


@pytest.mark.chaos
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_failed_launch_leaves_no_counter_or_budget_moved(monkeypatch, route):
    # the engine after a launch that raised, with no chunk in flight: the
    # batch, the budgets and (stochastic routes) the counters are those
    # of before the dispatch, and the next chunk runs from them
    rule, kw, packed, cls = ROUTES[route]
    key = engine.compile_key_for(get_rule(rule), np.zeros(SHAPE, np.int8), "cuda")
    eng = engine.make_engine(key, 2, CHUNK, mc_packed=packed, device=torch.device("cpu"))
    b = np.random.default_rng(3).integers(0, 2, SHAPE).astype(np.int8)
    eng.load(0, b, STEPS, seed=5, **kw)
    eng.advance_chunk()
    before = {name: getattr(eng, name).clone() for name in ("_rem_dev", "_counter")
              if hasattr(eng, name)}
    board = eng.fetch(0)
    _faulting(monkeypatch, cls, 1, ERRORS["launch"])
    with pytest.raises(RuntimeError, match="launch failure"):
        eng.dispatch_chunk()
    assert not eng.inflight and eng.remaining(0) == STEPS - CHUNK
    for name, t in before.items():
        assert torch.equal(getattr(eng, name), t), name
    assert eng.salvage_slot(0)[0].tobytes() == board.tobytes()
    monkeypatch.undo()
    while eng.remaining(0):
        eng.advance_chunk()
    assert eng.fetch(0).tobytes() == _oracle(rule, b, 5, kw).tobytes()


def _fail_second_chunk(monkeypatch, cls):
    """``cls``'s built chunk raises an OOM at its second call, after it ran."""
    build = cls._build_chunk
    calls = []

    def built(self):
        chunk = build(self)

        def run(*args):
            out = chunk(*args)
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError(ERRORS["oom"])
            return out

        return run

    monkeypatch.setattr(cls, "_build_chunk", built)


@pytest.mark.chaos
def test_the_jax_device_engine_salvages_a_faulted_chunk_under_the_wrong_lag(monkeypatch):
    # the reference defect the port's engine does not copy (ROADMAP §C):
    # chunk 2's launch raises while chunk 1 flies; the JAX engine has
    # already moved its double buffer to chunk 1's output, yet reports
    # chunk 1's steps as the lag, so a replay runs them twice
    from tpu_life.serve.engine import VmapEngine, compile_key_for

    b = np.random.default_rng(5).integers(0, 2, SHAPE).astype(np.int8)
    _fail_second_chunk(monkeypatch, VmapEngine)
    jeng = VmapEngine(compile_key_for(jget_rule("conway"), b, "jax"), 2, CHUNK)
    jeng.load(0, b, STEPS)
    jeng.dispatch_chunk()
    with pytest.raises(RuntimeError, match="out of memory"):
        jeng.dispatch_chunk()
    board, lag = jeng.salvage_slot(0)
    assert lag == CHUNK and board.tobytes() == jrun_np(b, jget_rule("conway"), CHUNK).tobytes()
    assert board.tobytes() != jrun_np(b, jget_rule("conway"), CHUNK - lag).tobytes()
    # the port's engine at the same fault: the board matches its lag
    key = engine.compile_key_for(get_rule("conway"), b, "cuda")
    eng = engine.make_engine(key, 2, CHUNK, device=torch.device("cpu"))
    _faulting(monkeypatch, engine.BatchEngine, 2, ERRORS["oom"])
    eng.load(0, b, STEPS)
    eng.dispatch_chunk()
    with pytest.raises(RuntimeError, match="out of memory"):
        eng.dispatch_chunk()
    board, lag = eng.salvage_slot(0)
    assert board.tobytes() == jrun_np(b, jget_rule("conway"), CHUNK - lag).tobytes()
