"""The banded-matmul counting path (``tpu_life_torch/ops/conv.py``, torch on
the CPU) against ``tpu_life.ops.conv`` (JAX on the CPU) and the numpy roll
oracle.  The factors and operators are the JAX package's arrays exactly;
integer counts are bit-identical on every rule and boundary; ``auto``
routes as the JAX package's ``resolve_stencil`` does once the port is
given JAX's crossover radius, and keeps integer rules on roll without
one.  Boards come from ``np.random.default_rng``."""

import gzip
import hashlib
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops import conv as jconv
from tpu_life.ops.reference import neighbor_counts_np
from tpu_life_torch import cli
from tpu_life_torch.backends.base import get_backend, make_runner
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops import conv, stencil
from tpu_life_torch.ops.reference import run_np

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
GOLDEN_SHA = "ea69597f6ada6271b4b182c592f36395652fee9cf2d28a2e17c80fb5eca79215"

KERNEL_SPECS = ["conway", "bugs", "R3,C2,M1,S1..5,B2,NN", "R2,C2,S1..3,B1,NN:T", "lenia:orbium",
                "lenia:mini", "lenia:R7,m0.2,s0.03,b1;0.5"]


def _board(shape, states=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, states, size=shape).astype(np.int8)


def _spec(radius, neighborhood, center, boundary):
    spec = f"R{radius},C2,M{int(center)},S1..2,B1{',NN' if neighborhood == 'vn' else ''}"
    return spec + (":T" if boundary == "torus" else "")


# -- factors and operators: the JAX package's arrays ---------------------------
@pytest.mark.parametrize("spec", KERNEL_SPECS)
def test_rule_kernel_and_factors_equal_jax(spec):
    kern = conv.rule_kernel(get_rule(spec))
    want = jconv.rule_kernel(jget_rule(spec))
    assert kern.dtype == np.float32 and np.array_equal(kern, want)
    got, ref = conv.kernel_factors(kern), jconv.kernel_factors(want)
    assert len(got) == len(ref)
    for (u, v), (ju, jv) in zip(got, ref):
        assert u.dtype == v.dtype == np.float32
        assert np.array_equal(u, ju) and np.array_equal(v, jv)


@pytest.mark.parametrize("spec", KERNEL_SPECS)
@pytest.mark.parametrize("boundary", ["clamped", "torus"])
def test_band_operators_equal_jax(spec, boundary):
    kern = conv.rule_kernel(get_rule(spec))
    got = conv.band_operators((29, 31), kern, boundary)
    want = jconv.band_operators((29, 31), kern, boundary)
    assert len(got) == len(want)
    for (a, b), (ja, jb) in zip(got, want):
        assert np.array_equal(a, ja) and np.array_equal(b, jb)


@pytest.mark.parametrize("n,r", [(1, 0), (5, 2), (7, 3), (11, 6)])
def test_band_matrix_overhang_equals_jax(n, r):
    # torus bands wider than the board alias and sum, as the JAX package's
    profile = np.random.default_rng(n).random(2 * r + 1).astype(np.float32)
    for boundary in ("clamped", "torus"):
        assert np.array_equal(conv.band_matrix(n, profile, boundary),
                              jconv.band_matrix(n, profile, boundary))


def test_kernel_factors_rejects_degenerate():
    with pytest.raises(ValueError, match="zeros"):
        conv.kernel_factors(np.zeros((3, 3)))
    with pytest.raises(ValueError, match="odd-sided"):
        conv.kernel_factors(np.ones((2, 4)))


def test_moore_box_with_center_is_rank_one():
    rule = get_rule("bugs")
    kern = conv.rule_kernel(rule).copy()
    kern[rule.radius, rule.radius] += 1.0
    assert len(conv.kernel_factors(kern)) == 1


# -- integer counts: bit for bit ---------------------------------------------
@pytest.mark.parametrize("radius", range(1, 8))
@pytest.mark.parametrize("neighborhood", ["moore", "vn"])
@pytest.mark.parametrize("center", [False, True], ids=["M0", "M1"])
@pytest.mark.parametrize("boundary", ["clamped", "torus"])
def test_counts_matmul_equals_jax_and_roll(radius, neighborhood, center, boundary):
    spec = _spec(radius, neighborhood, center, boundary)
    rule = get_rule(spec)
    board = _board((21, 33), seed=radius * 10 + center)
    got = conv.make_counts_matmul(rule, board.shape)(torch.from_numpy(board))
    assert got.dtype == torch.int32
    want = np.asarray(jconv.make_counts_matmul(jnp, jget_rule(spec), board.shape)(jnp.asarray(board)))
    roll = neighbor_counts_np(board, rule.radius, rule.include_center, rule.neighborhood, rule.boundary)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), roll)
    np.testing.assert_array_equal(conv.neighbor_counts_matmul_np(board, rule), roll)


@pytest.mark.parametrize("spec", ["brians_brain", "bugs_decay:T", "R3,C4,S2..8,B3..5,NN", "conway:T"])
def test_matmul_steps_equal_roll_oracle(spec):
    # Generations states, torus, diamonds: the int8 step counting by matmul
    rule = get_rule(spec)
    board = _board((19, 27), states=rule.states, seed=1)
    want = run_np(board, rule, 5)
    got = stencil.multi_step(torch.from_numpy(board), rule=rule, steps=5, stencil="matmul")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(run_np(board, rule, 5, stencil="matmul"), want)


@pytest.mark.parametrize("backend", ["torch", "numpy", "sharded"])
@pytest.mark.parametrize("spec", ["conway", "bugs", "bugs:T", "R2,C2,S2..4,B2..3,NN"])
def test_backends_matmul_pin_bit_identical(backend, spec):
    # --stencil matmul outranks the bit-sliced routes and runs on every
    # backend with a counting stencil; the cuda backend ignores it
    rule = get_rule(spec)
    board = _board((24, 32), seed=9)
    kwargs = {"numpy": {}, "torch": {"device": "cpu"},
              "sharded": {"device": "cpu", "mesh_shape": (2, 2)}}[backend]
    runner = make_runner(get_backend(backend, stencil="matmul", **kwargs), board, rule)
    if backend == "torch":
        assert (runner.route, runner.stencil, runner.x.dtype) == ("stencil", "matmul", torch.int8)
    runner.advance(3)
    runner.advance(2)
    np.testing.assert_array_equal(runner.fetch(), run_np(board, rule, 5))


def test_cuda_backend_ignores_the_stencil():
    runner = make_runner(get_backend("cuda", device="cpu", stencil="matmul"), _board((16, 40)),
                         get_rule("conway"))
    assert runner.route == "k1"


# -- routing -------------------------------------------------------------------
# the port's backends beside the JAX backends they stand for
PAIRS = [("torch", "jax"), ("numpy", "numpy"), ("cuda", "pallas"), ("sharded", "sharded")]


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("mode", conv.STENCIL_MODES)
@pytest.mark.parametrize("spec", ["conway", "R3,C2,S2..9,B3..5", "R4,C2,S2..9,B3..5", "bugs", "lenia:mini"])
def test_resolve_stencil_equals_jax(pair, mode, spec, monkeypatch):
    port, jax_name = pair
    rule = get_rule(spec)
    want = jconv.resolve_stencil(jget_rule(spec), mode, jax_name)
    # given JAX's crossover, the port routes as JAX does
    monkeypatch.setattr(conv, "CROSSOVER_RADIUS", jconv.CROSSOVER_RADIUS)
    assert conv.resolve_stencil(rule, mode, port) == want
    # without one (the default), auto keeps integer rules on roll
    monkeypatch.setattr(conv, "CROSSOVER_RADIUS", None)
    assert conv.resolve_stencil(rule, mode, port) == (
        "roll" if mode == "auto" and not rule.continuous else want)


def test_routing_constants_equal_jax(monkeypatch):
    # the crossover is read from the JAX package's variable; unset, the
    # port has none, where the JAX package defaults to 4
    import importlib
    import os

    env = os.environ.get("TPU_LIFE_STENCIL_CROSSOVER")
    assert conv.CROSSOVER_RADIUS == (int(env) if env else None)
    assert jconv.CROSSOVER_RADIUS == int(env or 4)
    monkeypatch.setenv("TPU_LIFE_STENCIL_CROSSOVER", "6")
    try:
        assert importlib.reload(conv).CROSSOVER_RADIUS == 6
    finally:
        monkeypatch.undo()
        importlib.reload(conv)
    assert conv.STENCIL_MODES == jconv.STENCIL_MODES
    with pytest.raises(ValueError, match="stencil must be one of"):
        conv.resolve_stencil(get_rule("conway"), "bogus")


@pytest.mark.parametrize("crossover", [None, 4], ids=["default", "r4"])
@pytest.mark.parametrize("spec,want", [("conway", "packed"), ("brians_brain", "roll"), ("bugs", "matmul"),
                                       ("bugs_decay:T", "matmul"), ("R3,C2,S2..9,B3..5", "roll")])
def test_torch_backend_auto_follows_the_crossover(spec, want, crossover, monkeypatch):
    monkeypatch.setattr(conv, "CROSSOVER_RADIUS", crossover)
    if crossover is None and want == "matmul":
        want = "roll"
    rule = get_rule(spec)
    runner = make_runner(get_backend("torch", device="cpu"), _board((24, 33), rule.states, 3), rule)
    assert (runner.route if want == "packed" else runner.stencil) == want


@pytest.mark.parametrize("crossover", [None, 4], ids=["default", "r4"])
def test_sharded_stencil_under_a_cuda_pin(crossover, monkeypatch):
    monkeypatch.setattr(conv, "CROSSOVER_RADIUS", crossover)
    bugs = get_rule("bugs")
    # auto keeps roll for integer rules wherever a kernel may run: the
    # kernels count with their own sums, whatever the crossover
    for local_kernel in ("cuda", "auto"):
        assert get_backend("sharded", device="cpu", num_devices=2, local_kernel=local_kernel,
                           stencil="auto").route(bugs) == "k4"
    # only the plain per-shard ops follow the crossover
    plain = get_backend("sharded", device="cpu", num_devices=2, local_kernel="torch", stencil="auto")
    assert plain._stencil(bugs) == ("roll" if crossover is None else "matmul")
    for rule in (bugs, get_rule("conway:T")):
        with pytest.raises(ValueError, match="cannot be combined with local_kernel='cuda'"):
            get_backend("sharded", device="cpu", num_devices=2, local_kernel="cuda",
                        stencil="matmul").route(rule)


# -- the CLI: the reference workload through the matmul counts -----------------
@pytest.fixture
def reference_dir(tmp_path):
    with gzip.open(FIXTURES / "reference_data.txt.gz", "rb") as f:
        (tmp_path / "data.txt").write_bytes(f.read())
    shutil.copy(FIXTURES / "reference_grid_size_data.txt", tmp_path / "grid_size_data.txt")
    return tmp_path


@pytest.mark.parametrize("args", [["--device", "cpu"], ["--backend", "torch", "--device", "cpu"],
                                  ["--backend", "numpy"],
                                  ["--backend", "sharded", "--device", "cpu", "--mesh-shape", "2,2"]],
                         ids=["auto", "torch", "numpy", "sharded-2x2"])
def test_run_stencil_matmul_writes_the_golden_bytes(reference_dir, args):
    files = ["--config-file", str(reference_dir / "grid_size_data.txt"),
             "--input-file", str(reference_dir / "data.txt"),
             "--output-file", str(reference_dir / "out.txt")]
    assert cli.main(["run", *files, "--stencil", "matmul", *args]) == 0
    raw = (reference_dir / "out.txt").read_bytes()
    assert hashlib.sha256(raw).hexdigest() == GOLDEN_SHA
