"""Stochastic sessions through the port's serving tier, held to the JAX
package's on the CPU.

The cases of the JAX package's ``tests/test_mc_serve.py`` that need no
gateway — a temperature sweep under one CompileKey built once, staggered
joins, the served run equal to the driver's run, noisy sessions, mixed
deterministic and stochastic batches, typed validation errors, failure
isolation and slot reuse — run on the port's ``SimulationService`` (the
``cuda`` engines on ``device="cpu"``, packed and ``--no-bitpack``, and
``numpy``) against the JAX service (``jax`` on the CPU) and
``tpu_life.mc.run_np``; then spill and resume at ``start_step``, the
``sharded`` and ``mesh:`` refusals with the JAX package's exception type,
and the port's engines in lockstep with the JAX engines (each chunk's
accounting, peeks and salvages and their lags while a chunk flies,
fetches).  Boards come from the seeded stream or ``np.random.default_rng``;
every comparison is exact.
"""

import numpy as np
import pytest
import torch

from tpu_life import mc as jmc
from tpu_life import serve as jserve
from tpu_life.mc import seeded_board
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.serve import engine as jengine
from tpu_life_torch import mc, serve
from tpu_life_torch.mc import engine as mc_engine
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.serve import engine

ISING = get_rule("ising")
JISING = jget_rule("ising")
TEMPS = [1.5, 1.8, 2.0, 2.2, 2.4, 2.6, 2.8, 3.0]
#: the port's executors: (serve backend, mc_packed) and the engine each builds
PORT = [("cuda", True), ("cuda", False), ("numpy", True)]
ENGINES = {("cuda", True): mc_engine.MCPackedBatchEngine, ("cuda", False): mc_engine.MCBatchEngine,
           ("numpy", True): mc_engine.MCHostEngine}


def _svc(backend="cuda", packed=True, **kw):
    kw.setdefault("capacity", 8)
    kw.setdefault("chunk_steps", 4)
    return serve.SimulationService(serve.ServeConfig(backend=backend, device="cpu",
                                                     mc_packed=packed, **kw))


def _jsvc(**kw):
    kw.setdefault("capacity", 8)
    kw.setdefault("chunk_steps", 4)
    return jserve.SimulationService(jserve.ServeConfig(backend="jax", **kw))


def _engine_types(svc):
    return {type(e) for e in svc.scheduler.engines.values()}


@pytest.mark.parametrize("backend,packed", PORT)
def test_temperature_sweep_one_compile_key(backend, packed):
    # 8 temperatures, one board and seed, ONE CompileKey built once, every
    # session equal to its own run_np and to the JAX service's session
    board = seeded_board(16, 12, seed=11)
    port, jax = _svc(backend, packed), _jsvc()
    sids = port.sweep(board, "ising", 10, TEMPS, seed=11)
    jsids = jax.sweep(board, "ising", 10, TEMPS, seed=11)
    port.drain()
    jax.drain()
    counts = port.scheduler.compile_counts()
    assert len(counts) == 1, "a temperature sweep must share one CompileKey"
    if backend == "cuda":
        assert list(counts.values()) == [1] == list(jax.scheduler.compile_counts().values())
    assert _engine_types(port) == {ENGINES[backend, packed]}
    for sid, jsid, t in zip(sids, jsids, TEMPS):
        view = port.poll(sid)
        assert view.state is serve.SessionState.DONE
        assert view.seed == 11 and view.temperature == t
        assert (view.packed, view.lanes) == (ENGINES[backend, packed].packed,
                                             ENGINES[backend, packed].lanes)
        oracle = jmc.run_np(JISING, board, 11, 10, temperature=t)
        np.testing.assert_array_equal(port.result(sid), oracle)
        np.testing.assert_array_equal(port.result(sid), jax.result(jsid))
    port.close()
    jax.close()


@pytest.mark.parametrize("backend,packed", PORT)
def test_staggered_joins_keep_bit_identity_and_one_compile(backend, packed):
    board = seeded_board(14, 14, seed=2)
    svc = _svc(backend, packed, capacity=4, chunk_steps=3)
    first = [svc.submit(board, ISING, 11, seed=s, temperature=2.2) for s in (1, 2)]
    svc.pump()
    svc.pump()
    later = [svc.submit(board, ISING, 5, seed=s, temperature=2.6) for s in (3, 4)]
    svc.drain()
    if backend == "cuda":
        assert list(svc.scheduler.compile_counts().values()) == [1]
    for sid, seed, steps, t in [(first[0], 1, 11, 2.2), (first[1], 2, 11, 2.2),
                                (later[0], 3, 5, 2.6), (later[1], 4, 5, 2.6)]:
        np.testing.assert_array_equal(svc.result(sid),
                                      jmc.run_np(JISING, board, seed, steps, temperature=t))
    svc.close()


@pytest.mark.parametrize("no_bitpack", [False, True])
def test_serve_equals_driver_run_same_seed(tmp_path, no_bitpack):
    # the two public fronts of the port agree: a served session equals the
    # driver's single run of the same (board, seed, temperature)
    from tpu_life_torch.config import RunConfig
    from tpu_life_torch.runtime.driver import run

    res = run(RunConfig(height=12, width=12, steps=8, rule="ising", temperature=2.4, seed=9,
                        backend="cuda", device="cpu", bitpack=not no_bitpack,
                        input_file=str(tmp_path / "absent.txt"),
                        config_file=str(tmp_path / "absent_cfg.txt"),
                        output_file=str(tmp_path / "out.txt")))
    svc = _svc("cuda", not no_bitpack)
    sid = svc.submit(seeded_board(12, 12, seed=9), "ising", 8, seed=9, temperature=2.4)
    svc.drain()
    np.testing.assert_array_equal(svc.result(sid), res.board)
    np.testing.assert_array_equal(svc.result(sid), jmc.run_np(JISING, seeded_board(12, 12, seed=9),
                                                              9, 8, temperature=2.4))
    svc.close()


@pytest.mark.parametrize("spec", ["noisy:0.1/conway", "noisy:0.02/highlife",
                                  "noisy:0.05/conway:T", "noisy:1/conway"])
@pytest.mark.parametrize("backend", ["cuda", "numpy"])
def test_noisy_rule_through_serve(spec, backend):
    rule = get_rule(spec)
    board = seeded_board(13, 17, seed=4)
    port, jax = _svc(backend), _jsvc()
    sids = [port.submit(board, rule, 6, seed=s) for s in (4, 5, 6)]
    jsids = [jax.submit(board, spec, 6, seed=s) for s in (4, 5, 6)]
    port.drain()
    jax.drain()
    if backend == "cuda":
        assert {e.route for e in port.scheduler.engines.values()} == {"mc_noisy"}
    for sid, jsid, s in zip(sids, jsids, (4, 5, 6)):
        np.testing.assert_array_equal(port.result(sid), jmc.run_np(jget_rule(spec), board, s, 6))
        np.testing.assert_array_equal(port.result(sid), jax.result(jsid))
    port.close()
    jax.close()


@pytest.mark.parametrize("backend,packed", PORT)
def test_mixed_deterministic_and_stochastic_batch(backend, packed):
    from tpu_life.ops.reference import run_np as det_run

    board = seeded_board(10, 10, seed=0)
    svc = _svc(backend, packed)
    det_sid = svc.submit(board, "conway", 7)
    mc_sid = svc.submit(board, ISING, 7, seed=1, temperature=2.0)
    svc.drain()
    np.testing.assert_array_equal(svc.result(det_sid), det_run(board, jget_rule("conway"), 7))
    np.testing.assert_array_equal(svc.result(mc_sid),
                                  jmc.run_np(JISING, board, 1, 7, temperature=2.0))
    assert len(svc.scheduler.compile_counts()) == 2
    svc.close()


def test_submit_validation_typed_errors():
    board = seeded_board(8, 8, seed=0)
    for svc in (_svc("cuda"), _jsvc()):
        with pytest.raises(ValueError, match="temperature"):
            svc.submit(board, "ising", 4)  # ising needs a temperature
        with pytest.raises(ValueError, match="temperature"):
            svc.submit(board, "conway", 4, temperature=2.0)
        with pytest.raises(ValueError, match="finite"):
            svc.submit(board, "ising", 4, temperature=float("nan"))
        with pytest.raises(ValueError, match="even lattice"):
            svc.submit(np.zeros((8, 7), np.int8), "ising", 4, temperature=2.0)
        assert len(svc.store) == 0
        svc.close()


@pytest.mark.parametrize("spec,kw", [("ising", {"temperature": 2.0}),
                                     ("noisy:0.01/conway", {"seed": 3})])
@pytest.mark.parametrize("backend", ["sharded", "mesh:2x2"])
def test_stochastic_keys_on_executors_without_the_key_schedule_are_refused_as_jax_does(
        spec, kw, backend):
    # typed at submit, before anything is stored, as the JAX package's
    # exception type; and at make_engine, for a key built directly
    board = seeded_board(8, 8, seed=0)
    port = serve.SimulationService(serve.ServeConfig(backend=backend, device="cpu"))
    jax = jserve.SimulationService(jserve.ServeConfig(backend=backend))
    errors = []
    for svc in (port, jax):
        with pytest.raises(ValueError, match="key schedule") as err:
            svc.submit(board, spec, 4, **kw)
        errors.append(err.value)
        assert len(svc.store) == 0 and not svc.scheduler.engines
        with pytest.raises(ValueError, match="key schedule"):
            svc.sweep(board, "ising", 4, [1.0, 2.0])
        svc.close()
    # the JAX package raises ValueError; the port its subclass, which `run`
    # and `serve` map to exit 2
    assert type(errors[1]) is ValueError and isinstance(errors[0], mc.StochasticBackendError)
    key = engine.compile_key_for(get_rule(spec), board, backend)
    with pytest.raises(mc.StochasticBackendError):
        engine.make_engine(key, 2, 4, device="cpu")


@pytest.mark.parametrize("backend,packed", PORT)
def test_per_slot_failure_isolation_keeps_streams_exact(backend, packed):
    board = seeded_board(10, 10, seed=7)
    svc = _svc(backend, packed, capacity=3, chunk_steps=2)
    ok1 = svc.submit(board, ISING, 8, seed=1, temperature=2.1)
    bad = svc.submit(board, ISING, 8, seed=2, temperature=2.1, fault_at=3)
    ok2 = svc.submit(board, ISING, 8, seed=3, temperature=2.1)
    svc.drain()
    assert svc.poll(bad).state is serve.SessionState.FAILED
    for sid, seed in ((ok1, 1), (ok2, 3)):
        np.testing.assert_array_equal(svc.result(sid),
                                      jmc.run_np(JISING, board, seed, 8, temperature=2.1))
    svc.close()


@pytest.mark.parametrize("backend,packed", PORT)
def test_slot_reuse_resets_stream_state(backend, packed):
    board = seeded_board(10, 10, seed=1)
    svc = _svc(backend, packed, capacity=1, chunk_steps=4)
    a = svc.submit(board, ISING, 4, seed=10, temperature=1.7)
    b = svc.submit(board, ISING, 6, seed=20, temperature=2.9)
    c = svc.submit(board, "noisy:0.1/conway", 5, seed=30)
    svc.drain()
    np.testing.assert_array_equal(svc.result(a), jmc.run_np(JISING, board, 10, 4, temperature=1.7))
    np.testing.assert_array_equal(svc.result(b), jmc.run_np(JISING, board, 20, 6, temperature=2.9))
    np.testing.assert_array_equal(svc.result(c),
                                  jmc.run_np(jget_rule("noisy:0.1/conway"), board, 30, 5))
    svc.close()


@pytest.mark.parametrize("start_step", [0, 7, 2**31 + 3])
@pytest.mark.parametrize("backend,packed", PORT)
def test_start_step_re_enters_the_stream(backend, packed, start_step):
    # a session resumed at start_step equals run_np from that step
    board = seeded_board(12, 16, seed=3)
    svc = _svc(backend, packed, capacity=2, chunk_steps=3)
    sid = svc.submit(board, ISING, 7, seed=5, temperature=2.27, start_step=start_step)
    svc.drain()
    view = svc.poll(sid)
    assert (view.steps, view.steps_done) == (start_step + 7, start_step + 7)
    np.testing.assert_array_equal(
        svc.result(sid), jmc.run_np(JISING, board, 5, 7, temperature=2.27, start_step=start_step))
    svc.close()


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("backend,packed", PORT)
def test_spill_files_byte_equal_and_resume_at_the_step(tmp_path, backend, packed, pipeline):
    # a stochastic session abandoned mid-flight spills the JAX service's
    # bytes; resumed in a fresh service at the spilled step it finishes
    # byte-equal to the uninterrupted session
    from tpu_life.serve.spill import read_spill_sessions
    from tpu_life_torch.serve.spill import read_spill_sessions as port_read

    board = seeded_board(16, 20, seed=5)
    dirs = tmp_path / "port", tmp_path / "jax"
    base = dict(capacity=2, chunk_steps=4, run_id="r0", pipeline=pipeline, spill_every=1)
    port = serve.SimulationService(serve.ServeConfig(
        backend=backend, device="cpu", mc_packed=packed, spill_dir=str(dirs[0]), **base))
    jbackend = "jax" if backend == "cuda" else "numpy"
    jax = jserve.SimulationService(jserve.ServeConfig(backend=jbackend, spill_dir=str(dirs[1]),
                                                      **base))
    for svc in (port, jax):
        svc.submit(board, "ising", 30, seed=8, temperature=2.27)
        for _ in range(4):  # abandon mid-flight
            svc.pump()
    files = [sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file()) for d in dirs]
    assert files[0] == files[1] and files[0]
    for rel in files[0]:
        assert (dirs[0] / rel).read_bytes() == (dirs[1] / rel).read_bytes(), rel
    (rec,), corrupt, _ = port_read(dirs[0])
    (jrec,), _, _ = read_spill_sessions(dirs[1])
    assert corrupt == [] and 0 < rec.step < 30
    assert (rec.step, rec.seed, rec.temperature, rec.remaining) == (
        jrec.step, jrec.seed, jrec.temperature, jrec.remaining)
    again = _svc(backend, packed)
    sid = again.submit(rec.board, rec.rule, rec.remaining, seed=rec.seed,
                       temperature=rec.temperature, start_step=rec.step)
    again.drain()
    np.testing.assert_array_equal(again.result(sid),
                                  jmc.run_np(JISING, board, 8, 30, temperature=2.27))
    assert (again.poll(sid).steps, again.poll(sid).steps_done) == (30, 30)
    again.close()


@pytest.mark.parametrize("spec,shape", [("ising", (16, 16)), ("ising", (64, 130)),
                                        ("noisy:0.01/conway", (64, 64))])
@pytest.mark.parametrize("backend,jbackend", [("cuda", "jax"), ("numpy", "numpy")])
@pytest.mark.parametrize("packed", [True, False])
def test_governor_estimates_of_stochastic_keys_equal_jax(spec, shape, backend, jbackend, packed):
    from tpu_life.serve import governor as jgov
    from tpu_life_torch.serve import governor

    board = np.zeros(shape, np.int8)
    key = engine.compile_key_for(get_rule(spec), board, backend)
    jkey = jengine.compile_key_for(jget_rule(spec), board, jbackend)
    for capacity in (1, 8):
        assert governor.estimate_engine_bytes(key, capacity, mc_packed=packed) == \
            jgov.estimate_engine_bytes(jkey, capacity, mc_packed=packed)


# -- the engines in lockstep with the JAX engines --------------------------------------


def mc_lockstep(port, jax, sessions):
    """Drive both engines through one schedule (``sessions``: (board,
    budget, seed, temperature, start_step)), admitting one session before
    each chunk; compare each chunk's accounting, the peeks and salvages of
    every resident slot and their lags while the chunk flies, and the
    fetch of every slot whose budget is spent.  Returns the finished
    boards by session."""
    pending = list(range(len(sessions)))
    resident: dict[int, int] = {}
    done: dict[int, np.ndarray] = {}
    rounds = 0
    while pending or resident:
        rounds += 1
        assert rounds < 200
        if pending:
            s_p, s_j = port.acquire(), jax.acquire()
            assert s_p == s_j
            if s_p is not None:
                i = pending.pop(0)
                board, budget, seed, temp, start = sessions[i]
                for eng in (port, jax):
                    eng.load(s_p, board, budget, seed=seed, temperature=temp, start_step=start)
                resident[s_p] = i
        assert port.dispatch_chunk() == jax.dispatch_chunk()
        for slot in sorted(resident):
            (pb, plag), (jb, jlag) = port.peek_slot(slot), jax.peek_slot(slot)
            assert plag == jlag and np.array_equal(pb, np.asarray(jb)), slot
            (sb, slag), (jsb, jslag) = port.salvage_slot(slot), jax.salvage_slot(slot)
            assert slag == jslag and np.array_equal(sb, np.asarray(jsb))
        assert port.collect_chunk() == jax.collect_chunk()
        for slot in sorted(resident):
            assert port.remaining(slot) == jax.remaining(slot)
            if port.remaining(slot) == 0:
                got = port.fetch(slot)
                np.testing.assert_array_equal(got, np.asarray(jax.fetch(slot)))
                done[resident.pop(slot)] = got
                port.release(slot)
                jax.release(slot)
    return done


@pytest.mark.parametrize("spec,packed,jcls", [
    ("ising", True, "MCPackedVmapEngine"), ("ising", False, "MCVmapEngine"),
    ("noisy:0.05/conway", True, "MCVmapEngine"), ("noisy:0.05/highlife", False, "MCVmapEngine")])
def test_device_engines_match_the_jax_vmap_engines(spec, packed, jcls):
    shape = (12, 34)
    key = engine.compile_key_for(get_rule(spec), np.zeros(shape, np.int8), "cuda")
    jkey = jengine.compile_key_for(jget_rule(spec), np.zeros(shape, np.int8), "jax")
    port = engine.make_engine(key, 3, 4, mc_packed=packed, device="cpu")
    jax = jengine.make_engine(jkey, 3, 4, mc_packed=packed)
    assert type(jax).__name__ == jcls and isinstance(port, engine.BatchEngine)
    assert port.packed == jax.packed and port.lanes == jax.lanes
    rng = np.random.default_rng(len(spec))
    temp = (lambda t: t) if spec == "ising" else (lambda t: None)
    sessions = [(rng.integers(0, 2, shape).astype(np.int8), budget, seed, temp(t), start)
                for budget, seed, t, start in [(0, 1, 2.0, 0), (5, 2, 0.0, 3), (9, -3, 2.27, 2**31),
                                               (4, 4, 10.0, 0), (1, 5, 1.5, 2**32 - 2),
                                               (12, 6, 2.6, 11)]]
    done = mc_lockstep(port, jax, sessions)
    for i, (board, budget, seed, t, start) in enumerate(sessions):
        np.testing.assert_array_equal(
            done[i], jmc.run_np(jget_rule(spec), board, seed, budget, temperature=t,
                                start_step=start))
    assert port.compile_count == jax.compile_count == 1
    assert port.device == torch.device("cpu")


@pytest.mark.parametrize("spec", ["ising", "noisy:0.05/conway"])
def test_host_engine_matches_the_jax_host_engine(spec):
    from tpu_life.mc import engine as jmc_engine

    shape = (10, 14)
    key = engine.compile_key_for(get_rule(spec), np.zeros(shape, np.int8), "numpy")
    jkey = jengine.compile_key_for(jget_rule(spec), np.zeros(shape, np.int8), "numpy")
    port, jax = engine.make_engine(key, 2, 3), jmc_engine.make_mc_engine(jkey, 2, 3)
    assert type(port) is mc_engine.MCHostEngine
    rng = np.random.default_rng(4)
    temp = 2.2 if spec == "ising" else None
    sessions = [(rng.integers(0, 2, shape).astype(np.int8), n, s, temp, start)
                for n, s, start in [(4, 1, 0), (7, 2, 5), (2, 3, 2**31 + 1)]]
    mc_lockstep(port, jax, sessions)


def test_wide_counter_shapes_follow_the_executor():
    # the packed device engine carries the wide cell index; the roll and
    # host engines refuse boards past 2^32 cells, as the JAX factory does
    # (refused before any board is allocated)
    shape = (1 << 17, 1 << 16)
    for backend, packed in (("cuda", False), ("numpy", True)):
        key = engine.CompileKey(rule=ISING, shape=shape, dtype="int8", backend=backend)
        with pytest.raises(ValueError, match="one-word PRNG cell index"):
            mc_engine.make_mc_engine(key, 1, 4, packed=packed, device="cpu")
