"""The port's host backends — ``native`` (the threaded C++ stepper of
``csrc/life.cpp``), ``stripes`` and ``mpi`` — held to the JAX package's
same backends and to the numpy oracle, on boards from numpy seeds.

``native`` and ``stripes`` (1-7 stripes) run life-like, Generations and
Larger-than-Life rules up to r = 5, ``stripes`` the torus too, on 1xN,
Nx1, ragged boards and boards shallower than the radius; ``native`` refuses
von Neumann and torus rules as the JAX package does; ``mpi`` runs on an
injected thread-backed communicator; ``run`` and ``serve`` through the
host backends give the bytes of ``python -m tpu_life run --backend
numpy``; the library is built from the port's own source into
``tpu_life_torch/_build/``, and ``TPU_LIFE_NATIVE=0`` is a typed refusal.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from tpu_life.backends.base import get_backend as jget_backend
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops.reference import run_np as jrun_np
from tpu_life_torch.backends.base import get_backend
from tpu_life_torch.cli import main
from tpu_life_torch.io.codec import read_board, write_board, write_config
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops import native_step

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "tpu_life_torch"

RULES = ["conway", "highlife", "day_and_night", "B36/S23", "brians_brain", "star_wars",
         "bugs", "R2,C2,S2..4,B3", "R3,C4,M1,S10..20,B9..12", "R5,C2,S34..58,B34..45"]
TORUS_RULES = ["conway:T", "brians_brain:T", "R2,C2,S2..4,B3:T"]
SHAPES = [(1, 17), (23, 1), (13, 29), (6, 40), (3, 3), (41, 8)]


def _board(shape, states, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, states, size=shape).astype(np.int8)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("spec", RULES)
def test_native_equals_the_jax_native_and_the_oracle(spec, shape):
    rule, jrule = get_rule(spec), jget_rule(spec)
    board = _board(shape, rule.states, seed=100 * RULES.index(spec) + SHAPES.index(shape))
    steps = 7
    want = jrun_np(board, jrule, steps)
    got = get_backend("native").run(board, rule, steps, chunk_steps=3)
    assert got.tobytes() == want.tobytes()
    assert jget_backend("native").run(board, jrule, steps).tobytes() == want.tobytes()


@pytest.mark.parametrize("stripes", range(1, 8))
@pytest.mark.parametrize("spec", RULES[::3] + TORUS_RULES)
@pytest.mark.parametrize("shape", [(1, 12), (17, 1), (19, 14), (4, 25)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_stripes_equal_the_jax_stripes_and_the_oracle(spec, stripes, shape):
    rule, jrule = get_rule(spec), jget_rule(spec)
    board = _board(shape, rule.states, seed=stripes * 101 + len(spec))
    steps = 5
    want = jrun_np(board, jrule, steps)
    if rule.boundary == "torus" and shape[0] < rule.radius:
        # a reference defect the port refuses: the JAX loop trims a torus
        # board shallower than the radius away (an empty board)
        assert jget_backend("stripes", num_devices=stripes).run(board, jrule, steps).size == 0
        with pytest.raises(ValueError, match="shallower than the rule radius"):
            get_backend("stripes", num_devices=stripes).run(board, rule, steps)
        return
    seen = []
    got = get_backend("stripes", num_devices=stripes).run(
        board, rule, steps, chunk_steps=2, callback=lambda done, get: seen.append(done))
    assert got.tobytes() == want.tobytes()
    assert seen == [2, 4, 5]
    jgot = jget_backend("stripes", num_devices=stripes).run(board, jrule, steps)
    assert jgot.tobytes() == want.tobytes()


@pytest.mark.parametrize("spec", ["R2,C2,S2..4,B3,NN", "conway:T", "R5,C2,S34..58,B34..45:T"])
def test_native_refuses_what_the_jax_native_refuses(spec):
    board = _board((12, 12), 2, seed=1)
    with pytest.raises(ValueError) as want:
        jget_backend("native").run(board, jget_rule(spec), 1)
    with pytest.raises(ValueError) as got:
        get_backend("native").run(board, get_rule(spec), 1)
    assert str(got.value) == str(want.value)


def test_zero_steps_returns_a_fresh_board():
    board = _board((9, 9), 2, seed=3)
    for name in ("native", "stripes"):
        out = get_backend(name).run(board, get_rule("conway"), 0)
        assert out.tobytes() == board.tobytes()
        out[0, 0] ^= 1  # the caller may write it: no alias of the input
        assert out[0, 0] != board[0, 0]


# -- mpi over an injected thread-backed communicator --------------------------
class _FakeWorld:
    """Shared state for an R-rank fake communicator over threads."""

    def __init__(self, size: int):
        import queue

        self.size = size
        self._queues: dict = {}
        self._lock = threading.Lock()
        self._barrier = threading.Barrier(size)
        self._slots: list = [None] * size
        self._queue_mod = queue

    def chan(self, src: int, dst: int, tag: int):
        with self._lock:
            return self._queues.setdefault((src, dst, tag), self._queue_mod.Queue())

    def exchange_all(self, rank: int, value):
        self._slots[rank] = value
        self._barrier.wait(timeout=60)
        vals = list(self._slots)
        self._barrier.wait(timeout=60)
        return vals


class _FakeComm:
    """The subset of the mpi4py communicator surface MpiBackend uses."""

    def __init__(self, world: _FakeWorld, rank: int):
        self.world, self.rank = world, rank

    def Get_rank(self) -> int:
        return self.rank

    def Get_size(self) -> int:
        return self.world.size

    def Sendrecv(self, sendbuf, dest, sendtag, recvbuf, source, recvtag):
        self.world.chan(self.rank, dest, sendtag).put(np.array(sendbuf, copy=True))
        recvbuf[...] = self.world.chan(source, self.rank, recvtag).get(timeout=60)

    def allgather(self, value):
        return self.world.exchange_all(self.rank, value)

    def gather(self, value, root=0):
        vals = self.world.exchange_all(self.rank, value)
        return vals if self.rank == root else None


def _run_mpi_ranks(board, rule, steps, size, **run_kwargs):
    from tpu_life_torch.backends.stripes_backend import MpiBackend

    world = _FakeWorld(size)
    results, errors = [None] * size, [None] * size

    def work(rank: int) -> None:
        try:
            results[rank] = MpiBackend(comm=_FakeComm(world, rank)).run(
                board, rule, steps, **run_kwargs)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors[rank] = e

    threads = [threading.Thread(target=work, args=(i,), name=f"rank{i}") for i in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for e in errors:
        if e is not None:
            raise e
    return results


@pytest.mark.parametrize("size", [1, 2, 3, 4])
@pytest.mark.parametrize("spec", ["conway", "R2,C2,S8..12,B7..8", "brians_brain:T", "conway:T"])
def test_mpi_on_fake_ranks_equals_the_oracle(spec, size):
    rule = get_rule(spec)
    board = _board((24, 19), rule.states, seed=size)
    want = jrun_np(board, jget_rule(spec), 6)
    calls = []

    def cb(done, get_board):
        calls.append((threading.current_thread().name, done))

    for out in _run_mpi_ranks(board, rule, 6, size, chunk_steps=4, callback=cb):
        assert out.tobytes() == want.tobytes()
    assert calls == [("rank0", 4), ("rank0", 6)]  # rank 0 is the one writer


def test_mpi_refuses_stripes_shallower_than_the_radius_as_jax_does():
    from tpu_life.backends.stripes_backend import MpiBackend as JMpiBackend
    from tpu_life_torch.backends.stripes_backend import MpiBackend

    board = _board((6, 10), 2, seed=4)
    msgs = []
    for cls, rule in ((MpiBackend, get_rule("R2,C2,S2..4,B3")),
                      (JMpiBackend, jget_rule("R2,C2,S2..4,B3"))):
        with pytest.raises(ValueError) as e:
            cls(comm=_FakeComm(_FakeWorld(4), 0)).run(board, rule, 1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_mpi_without_mpi4py_gives_the_jax_guidance(monkeypatch):
    # mpi4py made unimportable, whatever the machine ships
    monkeypatch.setitem(sys.modules, "mpi4py", None)
    with pytest.raises(ValueError) as want:
        jget_backend("mpi")
    with pytest.raises(ValueError) as got:
        get_backend("mpi")
    assert str(got.value) == str(want.value)
    assert "mpi4py" in str(got.value) and "--backend stripes" in str(got.value)


# -- the CLI: run and serve through the host backends -------------------------
def _workload(tmp_path, h=37, w=45, steps=21, seed=11):
    board = _board((h, w), 2, seed=seed)
    write_board(tmp_path / "data.txt", board)
    write_config(tmp_path / "grid_size_data.txt", h, w, steps)
    return board


def _jax_run(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "tpu_life", "run", "--backend", "numpy",
                           "--output-file", "jax.txt", *args],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("argv", [
    ["--backend", "native", "--device", "cpu"],
    ["--backend", "native"],
    ["--backend", "stripes", "--device", "cpu"],
    ["--backend", "stripes", "--num-devices", "7"],
    ["--backend", "native", "--rule", "bugs"],
    ["--backend", "stripes", "--num-devices", "3", "--rule", "brians_brain:T"],
])
def test_run_through_the_host_backends_writes_the_numpy_bytes(tmp_path, monkeypatch, argv):
    rule_args = argv[argv.index("--rule"):argv.index("--rule") + 2] if "--rule" in argv else []
    if "brians_brain:T" in argv or "bugs" in argv:
        # multi-state boards for the Generations / LtL rules
        states = 3 if "brians_brain:T" in argv else 2
        write_board(tmp_path / "data.txt", _board((37, 45), states, seed=12))
        write_config(tmp_path / "grid_size_data.txt", 37, 45, 21)
    else:
        _workload(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert main(["run", *argv, "--output-file", "port.txt"]) == 0
    assert (tmp_path / "port.txt").read_bytes() == _jax_run(tmp_path, *rule_args)


@pytest.mark.parametrize("backend", ["native", "stripes"])
def test_serve_through_the_host_backends_writes_the_numpy_bytes(tmp_path, monkeypatch, backend):
    board = _workload(tmp_path, h=20, w=26, steps=9)
    monkeypatch.chdir(tmp_path)
    budgets = (9, 14, 3)
    for steps in budgets:
        assert main(["submit", "--steps", str(steps), "--output-file", f"out_{steps}.txt"]) == 0
    assert main(["serve", "--serve-backend", backend, "--chunk-steps", "4"]) == 0
    for steps in budgets:
        want = jrun_np(board, jget_rule("conway"), steps)
        assert read_board(tmp_path / f"out_{steps}.txt", 20, 26).tobytes() == want.tobytes()


# -- the build: the port's own source, into the port's build directory --------
def test_the_stepper_builds_from_the_ports_source_only():
    from tpu_life_torch.kernels import _build

    assert native_step.SOURCE == PKG / "csrc" / "life.cpp"
    assert native_step.available()
    lib = native_step._lib()
    assert Path(lib._name).resolve().is_relative_to(_build.BUILD_ROOT.resolve())
    for path in (PKG / "ops" / "native_step.py", PKG / "backends" / "native_backend.py"):
        text = path.read_text()
        assert "NATIVE_DIR" not in text and "libtpulife_step" not in text


def test_native_off_is_a_typed_refusal(monkeypatch, tmp_path):
    monkeypatch.setenv("TPU_LIFE_NATIVE", "0")
    with pytest.raises(RuntimeError, match="TPU_LIFE_NATIVE=0"):
        get_backend("native")
    with pytest.raises(RuntimeError, match="TPU_LIFE_NATIVE=0"):
        native_step.run_native(_board((4, 4), 2, 0), get_rule("conway"), 1)
    _workload(tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="TPU_LIFE_NATIVE=0"):
        main(["run", "--backend", "native"])


def test_a_failed_build_raises_native_build_error(monkeypatch, tmp_path):
    from tpu_life_torch.utils import nativelib

    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nativelib._build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(nativelib.NativeBuildError, match="g\\+\\+ failed"):
        nativelib.build(bad)


@pytest.mark.parametrize("backend", ["stripes", "native"])
@pytest.mark.parametrize("spec,kw", [("conway", {}), ("brians_brain", {}), ("conway:T", {}),
                                     ("R2,C2,S2..4,B3,NN", {}), ("lenia:mini", {}),
                                     ("ising", {"temperature": 2.0})])
def test_the_service_on_a_host_backend_answers_as_the_jax_service(backend, spec, kw):
    # the same sessions through each package's service: the same bytes, or
    # a ValueError at submit in both (continuous and stochastic rules,
    # and native's clamped-Moore limit, whose words are the JAX package's)
    from tpu_life.serve import ServeConfig as JServeConfig
    from tpu_life.serve import SimulationService as JService
    from tpu_life_torch.serve import ServeConfig, SimulationService

    rule = get_rule(spec)
    board = (_board((18, 22), max(rule.states, 2), seed=9).astype(np.float32) / 2
             if rule.continuous else _board((18, 22), rule.states, seed=9))
    outcomes = []
    for svc in (SimulationService(ServeConfig(backend=backend, capacity=2, chunk_steps=3)),
                JService(JServeConfig(backend=backend, capacity=2, chunk_steps=3))):
        try:
            sid = svc.submit(board, spec, 7, **kw)
            svc.drain()
            outcomes.append(("done", svc.result(sid).tobytes()))
        except ValueError as e:
            outcomes.append(("refused", str(e) if "native backend" in str(e) else None))
        svc.close()
    assert outcomes[0] == outcomes[1]
