"""The port's serving engines against the JAX package's, on the CPU.

The same loads, budgets and staggered joins and leaves go through a port
engine and its JAX counterpart in lockstep (``BatchEngine`` routes
``k1_batch`` and ``ops`` and ``HostBatchEngine`` against ``VmapEngine``
and the JAX ``HostBatchEngine``; ``SlotLoopEngine`` over the ``cuda``
backend's K2 Runners against ``VmapEngine``, and over the sharded backend
against the JAX ``HostBatchEngine``; ``MeshEngine`` against the JAX
``MeshEngine``).  After every chunk they must agree on each chunk's
accounting, on ``fetch`` of every retiring slot bit for bit, on
``peek_slot`` and ``salvage_slot`` and their lags while a chunk flies, and
the batched engines build their chunk once over 20 staggered sessions.
Lenia boards are held ``allclose`` at ``FLOAT_ATOL``.  K1's batch mode's
plain version is held to ``tpu_life.ops.reference.run_np`` slot by slot.
Boards come from ``np.random.default_rng``.
"""

import numpy as np
import pytest
import torch

from tpu_life.models import lenia as jlenia
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops.reference import run_np as jrun_np
from tpu_life.serve import engine as jengine
from tpu_life.serve import mesh_engine as jmesh
from tpu_life_torch.kernels import packed_batch
from tpu_life_torch.models import lenia
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.serve import engine, mesh_engine

SHAPE = (24, 37)  # a partial last word, rows not a multiple of the tiles
CHUNK = 5


def _boards(spec: str, n: int, seed: int, shape=SHAPE) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    rule = get_rule(spec)
    if rule.continuous:
        return [lenia.seeded_board(*shape, seed=seed + i) for i in range(n)]
    return [rng.integers(0, rule.states, shape).astype(np.int8) for _ in range(n)]


def _keys(spec: str, backend: str, jbackend: str, shape=SHAPE):
    rule, jrule = get_rule(spec), jget_rule(spec)
    stencil = "matmul" if rule.continuous else "roll"
    board = np.zeros(shape, dtype=np.int8)
    return (engine.compile_key_for(rule, board, backend, stencil),
            jengine.compile_key_for(jrule, board, jbackend, stencil))


def _same(a: np.ndarray, b: np.ndarray, continuous: bool) -> bool:
    if continuous:
        return a.shape == b.shape and np.allclose(a, b, atol=lenia.FLOAT_ATOL, rtol=0)
    return a.dtype == b.dtype and np.array_equal(a, b)


def lockstep(port, jax, boards, budgets, *, continuous=False, roll_twice=False):
    """Drive both engines through one schedule: admit into free slots in
    order (a third of the sessions up front, then one more before each
    chunk), dispatch a chunk (two on a rolling pump when ``roll_twice``,
    then settle), compare peeks and salvages of every resident slot and
    their lags while the chunk flies, collect, then fetch, compare and
    release every slot whose budget is spent.  Returns the finished
    boards by session."""
    pending = list(range(len(boards)))
    resident: dict[int, int] = {}
    done: dict[int, np.ndarray] = {}

    def admit(limit):
        while pending and limit > 0:
            s_p, s_j = port.acquire(), jax.acquire()
            assert s_p == s_j
            if s_p is None:
                return
            i = pending.pop(0)
            port.load(s_p, boards[i], budgets[i])
            jax.load(s_j, boards[i], budgets[i])
            resident[s_p] = i
            limit -= 1

    admit(max(1, len(boards) // 3))
    rounds = 0
    while pending or resident:
        rounds += 1
        assert rounds < 500
        admit(1)
        adv = port.dispatch_chunk()
        assert adv == jax.dispatch_chunk()
        if roll_twice and port.ASYNC_ROLL and jax.ASYNC_ROLL:
            assert port.dispatch_chunk() == jax.dispatch_chunk()
            port.settle()
            jax.settle()
        for slot in sorted(resident):
            (pb, plag), (jb, jlag) = port.peek_slot(slot), jax.peek_slot(slot)
            assert plag == jlag, (slot, plag, jlag)
            assert _same(pb, np.asarray(jb), continuous), slot
            (sb, slag), (jsb, jslag) = port.salvage_slot(slot), jax.salvage_slot(slot)
            assert slag == jslag and _same(sb, np.asarray(jsb), continuous)
        assert port.collect_chunk() == jax.collect_chunk()
        for slot in sorted(resident):
            assert port.remaining(slot) == jax.remaining(slot)
            if port.remaining(slot) == 0:
                got, want = port.fetch(slot), np.asarray(jax.fetch(slot))
                assert _same(got, want, continuous), slot
                assert port.peek_slot(slot)[1] == 0
                done[resident.pop(slot)] = got
                port.release(slot)
                jax.release(slot)
        assert port.occupancy() == jax.occupancy()
    return done


#: (rule, serve backend, BatchEngine route): the routes ``cuda`` takes,
#: and route ops built directly on rules that ``cuda`` sends elsewhere
BATCH_CASES = [
    ("conway", "cuda", "k1_batch"),
    ("highlife", "cuda", "k1_batch"),
    ("R2,C2,S2..4,B2..3,NN", "cuda", "k1_batch"),
    ("R1,C0,S1..2,B1,NN", "cuda", "k1_batch"),
    ("conway:T", "cuda", "ops"),
    ("brians_brain", "cuda", "ops"),
    ("conway", "cuda", "ops"),
    ("bugs", "cuda", "ops"),
]


@pytest.mark.parametrize("spec,backend,route", BATCH_CASES, ids=lambda v: str(v))
def test_batch_engine_matches_vmap_engine(spec, backend, route):
    key, jkey = _keys(spec, backend, "jax", shape=(40, 41) if spec == "bugs" else SHAPE)
    port = engine.BatchEngine(key, 3, CHUNK, route=route, device=torch.device("cpu"))
    jax = jengine.VmapEngine(jkey, 3, CHUNK)
    boards = _boards(spec, 7, seed=len(spec), shape=key.shape)
    budgets = [0, 1, 4, 5, 6, 12, 17]
    done = lockstep(port, jax, boards, budgets, roll_twice=spec == "conway")
    rule = jget_rule(spec)
    for i, got in done.items():
        np.testing.assert_array_equal(got, jrun_np(boards[i], rule, budgets[i]))
    assert port.compile_count == jax.compile_count == 1


@pytest.mark.parametrize("spec", ["conway", "brians_brain", "R2,C2,S2..4,B2..3,NN"])
def test_host_batch_engine_matches_jax_host_engine(spec):
    key, jkey = _keys(spec, "numpy", "numpy")
    port, jax = engine.make_engine(key, 3, CHUNK), jengine.HostBatchEngine(jkey, 3, CHUNK)
    assert type(port) is engine.HostBatchEngine
    lockstep(port, jax, _boards(spec, 6, seed=3), [2, 0, 9, 5, 11, 7])


@pytest.mark.parametrize("spec", ["conway", "brians_brain"])
def test_slot_loop_engine_matches_jax_host_engine(spec):
    # the sharded backend per slot (4 row shards of the CPU) against the
    # JAX package's truth executor on the same schedule
    from tpu_life_torch.backends.base import get_backend

    key, jkey = _keys(spec, "sharded", "numpy")
    port = engine.SlotLoopEngine(
        key, 2, CHUNK, get_backend("sharded", rule=key.rule, device="cpu", num_devices=4)
    )
    jax = jengine.HostBatchEngine(jkey, 2, CHUNK)
    lockstep(port, jax, _boards(spec, 5, seed=4), [3, 12, 0, 7, 5])
    assert port.compile_count == 0


def test_make_engine_sends_sharded_keys_to_the_slot_loop():
    key, _ = _keys("conway", "sharded", "numpy")
    assert type(engine.make_engine(key, 2, CHUNK, device="cpu")) is engine.SlotLoopEngine


#: (rule, cuda route, engine): the executor a ``cuda`` key gets
CUDA_ROUTES = [
    ("conway", "k1_batch", engine.BatchEngine),
    ("highlife", "k1_batch", engine.BatchEngine),
    ("R2,C2,S2..4,B2..3,NN", "k1_batch", engine.BatchEngine),
    ("brians_brain", "k2_slots", engine.SlotLoopEngine),
    ("bugs", "k2_slots", engine.SlotLoopEngine),
    ("conway:T", "ops", engine.BatchEngine),
    ("R3,C2,S2..6,B3..4,NN", "ops", engine.BatchEngine),
    ("lenia:mini", "ops", engine.BatchEngine),
]


@pytest.mark.parametrize("spec,route,cls", CUDA_ROUTES, ids=lambda v: getattr(v, "__name__", str(v)))
def test_cuda_keys_take_their_kernel_route(spec, route, cls):
    key, _ = _keys(spec, "cuda", "jax")
    assert engine.cuda_route(key.rule) == route
    port = engine.make_engine(key, 2, CHUNK, device="cpu")
    assert type(port) is cls
    if cls is engine.BatchEngine:
        assert port.route == route
    else:  # one cuda-backend Runner per slot, each on K2's route
        slot = port.acquire()
        port.load(slot, _boards(spec, 1, seed=1)[0], 3)
        assert port._runners[slot].route == "k2"


@pytest.mark.parametrize("spec", ["brians_brain", "star_wars", "bugs", "bugs_decay"])
def test_k2_slot_loop_matches_vmap_engine(spec):
    # cuda's clamped Moore int8 keys that K1 does not take: one cuda
    # Runner per slot (K2's plain version on the CPU) against the JAX
    # package's device batch on the same schedule
    shape = (40, 41) if spec.startswith("bugs") else SHAPE
    key, jkey = _keys(spec, "cuda", "jax", shape=shape)
    port = engine.make_engine(key, 3, CHUNK, device="cpu")
    assert type(port) is engine.SlotLoopEngine
    jax = jengine.VmapEngine(jkey, 3, CHUNK)
    boards = _boards(spec, 6, seed=len(spec), shape=shape)
    budgets = [0, 2, 5, 6, 11, 17]
    done = lockstep(port, jax, boards, budgets)
    rule = jget_rule(spec)
    for i, got in done.items():
        np.testing.assert_array_equal(got, jrun_np(boards[i], rule, budgets[i]))
    assert port.compile_count == 0


def test_twenty_staggered_sessions_one_build():
    # capacity 8, 20 staggered sessions with uneven budgets: one build of
    # the chunk, on both packages' device batch
    key, jkey = _keys("conway", "cuda", "jax")
    port = engine.make_engine(key, 8, 7, device="cpu")
    jax = jengine.VmapEngine(jkey, 8, 7)
    budgets = [1 + (7 * i) % 43 for i in range(20)]
    lockstep(port, jax, _boards("conway", 20, seed=9), budgets)
    assert port.compile_count == jax.compile_count == 1


@pytest.mark.parametrize("backend", ["cuda", "numpy", "sharded"])
def test_lenia_batch_is_allclose_to_the_jax_engines(backend):
    jbackend = "jax" if backend == "cuda" else backend
    key, jkey = _keys("lenia:mini", backend, jbackend, shape=(32, 32))
    port = engine.make_engine(key, 2, 3, device="cpu")
    assert getattr(port, "route", "ops") == "ops"
    jax = jengine.make_engine(jkey, 2, 3)
    assert type(port).__name__ == ("BatchEngine" if backend == "cuda" else "HostBatchEngine")
    boards = _boards("lenia:mini", 4, seed=2, shape=(32, 32))
    done = lockstep(port, jax, boards, [8, 3, 0, 6], continuous=True)
    rule = jget_rule("lenia:mini")
    for i, got in done.items():
        want = jlenia.run_np(boards[i], rule, [8, 3, 0, 6][i])
        assert np.allclose(got, want, atol=lenia.FLOAT_ATOL, rtol=0)


def test_mesh_engine_matches_jax_mesh_engine():
    rule = get_rule("conway")
    board = _boards("conway", 1, seed=11, shape=(32, 40))[0]
    key = engine.compile_key_for(rule, board, mesh_engine.mesh_backend_name((2, 2)))
    jkey = jengine.compile_key_for(jget_rule("conway"), board, jmesh.mesh_backend_name((2, 2)))
    port = engine.make_engine(key, 8, CHUNK, device="cpu")
    jax = jmesh.MeshEngine(jkey, CHUNK)
    assert type(port) is mesh_engine.MeshEngine and port.capacity == 1
    done = lockstep(port, jax, [board], [13])
    np.testing.assert_array_equal(done[0], jrun_np(board, jget_rule("conway"), 13))
    assert port.compile_count == jax.compile_count == 1


def test_mesh_engine_tiles_re_enter_another_mesh():
    rule = get_rule("conway")
    board = _boards("conway", 1, seed=12, shape=(30, 44))[0]
    first = engine.make_engine(engine.compile_key_for(rule, board, "mesh:2x2"), 1, 4, device="cpu")
    slot = first.acquire()
    first.load(slot, board, 9)
    first.advance_chunk()
    tiles, lag = first.spill_tiles(slot)
    assert lag == 0 and len(tiles) == 4
    whole = np.zeros_like(board)
    for r0, c0, cells in tiles:
        whole[r0:r0 + cells.shape[0], c0:c0 + cells.shape[1]] = cells
    np.testing.assert_array_equal(whole, jrun_np(board, jget_rule("conway"), 4))
    second = engine.make_engine(engine.compile_key_for(rule, board, "mesh:4x1"), 1, 5, device="cpu")
    slot2 = second.acquire()
    second.load_tiles(slot2, lambda r0, r1, c0, c1: whole[r0:r1, c0:c1], 5, start_step=4)
    second.advance_chunk()
    np.testing.assert_array_equal(second.fetch(slot2), jrun_np(board, jget_rule("conway"), 9))


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7, 8, 16])
@pytest.mark.parametrize("shape", [(20, 30), (9, 64)])
def test_plan_mesh_shape_matches_jax(n, shape):
    for spec in ("conway", "conway:T", "bugs"):
        assert mesh_engine.plan_mesh_shape(n, shape, get_rule(spec)) == jmesh.plan_mesh_shape(
            n, shape, jget_rule(spec))


@pytest.mark.parametrize("spec,shape,k", [
    ("conway", (24, 37), 8), ("highlife", (15, 64), 3), ("R2,C2,S2..4,B2..3,NN", (20, 33), 16),
    ("R1,C0,S1..2,B1,NN", (13, 31), 5),
])
@pytest.mark.parametrize("offset", [0, 2])
def test_k1_batch_plain_matches_run_np_per_slot(spec, shape, k, offset):
    rng = np.random.default_rng(sum(shape) + k)
    boards = (rng.random((6, *shape)) < 0.4).astype(np.int8)
    budgets = [0, 1, k - 1, k, k + 1, 40]
    x = torch.from_numpy(np.stack([bitlife.pack_np(b).view(np.int32) for b in boards]))
    steps = torch.tensor(budgets, dtype=torch.int32)
    out = packed_batch.packed_batch_multi_step(x, steps, get_rule(spec), shape, k,
                                               out=torch.empty_like(x), offset=offset)
    rule = jget_rule(spec)
    for s, budget in enumerate(budgets):
        n = min(k, max(budget - offset, 0))
        got = bitlife.unpack_np(out[s].numpy().view(np.uint32), shape[1])
        np.testing.assert_array_equal(got, jrun_np(boards[s], rule, n))
    assert packed_batch.packed_batch_multi_step.launches == 0  # the CPU never launches


def test_k1_batch_refuses_what_k1_does_not_run():
    x = torch.zeros((2, 8, 1), dtype=torch.int32)
    steps = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="batch mode runs"):
        packed_batch.packed_batch_multi_step(x, steps, get_rule("brians_brain"), (8, 8), 4,
                                             out=torch.empty_like(x))
    with pytest.raises(ValueError, match="k must be"):
        packed_batch.packed_batch_multi_step(x, steps, get_rule("conway"), (8, 8), 33,
                                             out=torch.empty_like(x))
    with pytest.raises(ValueError, match="second buffer"):
        packed_batch.packed_batch_multi_step(x, steps, get_rule("conway"), (8, 8), 4, out=x)
    with pytest.raises(ValueError, match="shape"):
        packed_batch.packed_batch_multi_step(x, steps, get_rule("conway"), (8, 40), 4,
                                             out=torch.empty_like(x))


def test_batch_engine_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    # no silent fallback: without a card the device engines refuse to
    # build; on a CUDA device the k1_batch route calls the kernel's
    # wrapper, which launches or raises (chip_smoke.py phase 16)
    from tpu_life_torch.backends.base import CudaUnavailableError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    key, _ = _keys("conway", "cuda", "jax")
    with pytest.raises(CudaUnavailableError, match="--device cpu"):
        engine.make_engine(key, 2, 4)
    assert engine.make_engine(key, 2, 4, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("backend", ["tuned", "stripes", "native"])
def test_queued_backends_are_refused_by_name(backend, tmp_path, monkeypatch):
    # all three are ported: a key resolves to an engine, never a refusal;
    # the host backends loop one host Runner a slot, as the JAX package's do
    key, _ = _keys("conway", backend, "numpy")
    monkeypatch.setenv("TPU_LIFE_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    eng = engine.make_engine(key, 2, 4, device="cpu")
    assert eng.capacity == 2
    if backend != "tuned":
        assert type(eng) is engine.SlotLoopEngine and eng._backend.name == backend


@pytest.mark.parametrize("spec", ["ising", "noisy:0.01/conway"])
def test_stochastic_keys_are_refused(spec):
    # stochastic keys are refused only by the executors without the
    # counter-based key schedule (sharded, typed as the JAX package's);
    # cuda and numpy build the MC engines, which step a seeded session as
    # the JAX engines do
    from tpu_life.mc import run_np as jmc_run_np
    from tpu_life_torch import mc

    shape = (12, 14)
    board = _boards("conway", 1, seed=9, shape=shape)[0]
    temperature = 2.3 if spec == "ising" else None
    for backend, jbackend in (("cuda", "jax"), ("numpy", "numpy")):
        key, jkey = _keys(spec, backend, jbackend, shape=shape)
        port, jax = engine.make_engine(key, 2, 4, device="cpu"), jengine.make_engine(jkey, 2, 4)
        assert (port.packed, port.lanes) == (jax.packed, jax.lanes)
        for eng in (port, jax):
            slot = eng.acquire()
            eng.load(slot, board, 6, seed=17, temperature=temperature, start_step=3)
            eng.advance_chunk()
            eng.advance_chunk()
        want = jmc_run_np(jget_rule(spec), board, 17, 6, temperature=temperature, start_step=3)
        np.testing.assert_array_equal(port.fetch(0), np.asarray(jax.fetch(0)))
        np.testing.assert_array_equal(port.fetch(0), want)
    key, _ = _keys(spec, "sharded", "numpy", shape=shape)
    with pytest.raises(mc.StochasticBackendError, match="key schedule"):
        engine.make_engine(key, 2, 4, device="cpu")
