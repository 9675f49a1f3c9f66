"""The port's ``sharded`` backend on 2-D meshes and through kernel K4's
route, on the CPU (meshes of CPU shards), against the JAX package's
``ShardedBackend`` with the same ``mesh_shape`` — its XLA scan, and its
Pallas int8 kernel in interpret mode where that runs — and the numpy
oracle, byte for byte.  Mirrors the 2-D cases of ``tests/test_sharded.py``
(meshes 2x4, 4x2, 2x2, 1x8, packed and unpacked, deep halos, radius 2),
the int8-kernel cases of ``tests/test_sharded_pallas.py`` (``bugs`` on 1, 2
and 8 shards, multistate rules, a glider across a 2-D corner seam, M1,
remainders) and the 2-D torus cases of ``tests/test_torus.py``; then the
route each case takes, the ``cuda`` pin's errors, the halo copies of a
block and the runner contract on a grid of shards."""

import numpy as np
import pytest

from tpu_life.backends.sharded_backend import ShardedBackend as JaxShardedBackend
from tpu_life.models.patterns import GLIDER, place
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life_torch.backends.sharded_backend import ShardedBackend
from tpu_life_torch.kernels import sharded_int8
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops.reference import run_np
from tpu_life_torch.parallel import halo
from tpu_life_torch.parallel.mesh import make_mesh, make_mesh_2d

pallas = pytest.mark.requires_tpu_interpret  # the JAX Pallas path, as its own tests gate it


def _board(shape, seed, states=2):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, states, size=shape, dtype=np.int8)
    return b * rng.integers(0, 2, size=shape, dtype=np.int8) if states > 2 else b


def port(mesh_shape, **kw):
    return ShardedBackend(device="cpu", mesh_shape=mesh_shape, **kw)


def _check(board, spec, steps, mesh_shape, route=None, jax_kw=None, **kw):
    """The port under ``auto`` and ``torch`` against the JAX XLA scan on the
    same mesh shape and the oracle; returns the port's board."""
    rule = get_rule(spec)
    runner = port(mesh_shape, **kw).prepare(board, rule)
    if route is not None:
        assert runner.route == route
    runner.advance(steps)
    got = runner.fetch()
    want = run_np(board, rule, steps)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port(mesh_shape, local_kernel="torch", **kw).run(board, rule, steps), want)
    jkw = dict(kw, **(jax_kw or {}))
    jkw.setdefault("local_kernel", "xla")
    np.testing.assert_array_equal(
        JaxShardedBackend(mesh_shape=mesh_shape, **jkw).run(board, jget_rule(spec), steps), want)
    return got


# -- tests/test_sharded.py, 2-D meshes --------------------------------------


@pytest.mark.parametrize("bitpack", [True, False])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (2, 2), (1, 8)])
def test_2d_mesh_matches_the_jax_package(mesh_shape, bitpack):
    # 70 x 150 is uneven in both axes: padding rows and columns
    _check(_board((70, 150), seed=21), "conway", 9, mesh_shape,
           route="shard_ops" if bitpack else "k4", bitpack=bitpack)


@pytest.mark.parametrize("bitpack", [True, False])
@pytest.mark.parametrize("block_steps", [1, 3])
def test_2d_mesh_deep_halo(block_steps, bitpack):
    # deep halos in both axes: the corners ride the row-extended column
    # exchange
    _check(_board((64, 160), seed=22), "conway", 12, (2, 4), bitpack=bitpack, block_steps=block_steps)


@pytest.mark.parametrize("block_steps", [1, 2, 33, 40])
def test_2d_packed_wide_board(block_steps):
    # 520 cells are 17 words, 5 a column shard: halos of one or two words
    _check(_board((48, 520), seed=25), "conway", 40, (2, 4), route="shard_ops",
           block_steps=block_steps)


def test_2d_mesh_radius_2():
    _check(_board((48, 140), seed=23), "R2,C2,M0,S8..13,B10..12", 5, (2, 2), route="k4", block_steps=2)


# -- tests/test_sharded_pallas.py, the int8 kernel ------------------------------


@pytest.mark.parametrize("n", [1, 2, 8])
def test_bugs_on_row_meshes(n):
    board = _board((8 * n + 5, 150), seed=23)
    _check(board, "bugs", 5, (n, 1), route="k4", block_steps=2)


@pytest.mark.parametrize("n", [1, 2, 8])
@pallas
def test_bugs_on_row_meshes_against_the_tpu_kernel(n):
    board = _board((8 * n + 5, 150), seed=23)
    got = port((n, 1), block_steps=2).run(board, get_rule("bugs"), 5)
    want = JaxShardedBackend(num_devices=n, block_steps=2, local_kernel="pallas",
                             pallas_interpret=True).run(board, jget_rule("bugs"), 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
@pytest.mark.parametrize("spec", ["brians_brain", "bugs_decay", "star_wars"])
def test_multistate_rules(spec, mesh_shape):
    board = _board((40, 90), seed=29, states=get_rule(spec).states)
    _check(board, spec, 6, mesh_shape, route="k4", block_steps=2)


def test_unpacked_conway_equals_the_xla_scan():
    _check(_board((48, 70), seed=31), "conway", 6, (4, 1), route="k4", bitpack=False, block_steps=2)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4), (4, 2)])
def test_bugs_on_2d_meshes(mesh_shape):
    # radius-5 halos cross both kinds of seam
    board = _board((8 * mesh_shape[0] + 5, 150), seed=43)
    _check(board, "bugs", 5, mesh_shape, route="k4", block_steps=2)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4), (4, 2)])
@pallas
def test_bugs_on_2d_meshes_against_the_tpu_kernel(mesh_shape):
    board = _board((8 * mesh_shape[0] + 5, 150), seed=43)
    got = port(mesh_shape, block_steps=2).run(board, get_rule("bugs"), 5)
    want = JaxShardedBackend(mesh_shape=mesh_shape, block_steps=2, local_kernel="pallas",
                             pallas_interpret=True).run(board, jget_rule("bugs"), 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("local_kernel,bitpack,route", [("auto", False, "k4"), ("cuda", True, "k4"),
                                                         ("auto", True, "shard_ops")])
def test_glider_crosses_a_2d_corner_seam(local_kernel, bitpack, route):
    board = place(np.zeros((64, 64), dtype=np.int8), GLIDER, 26, 26)
    rule = get_rule("conway")
    runner = port((2, 2), block_steps=2, local_kernel=local_kernel, bitpack=bitpack).prepare(board, rule)
    assert runner.route == route
    runner.advance(24)
    got = runner.fetch()
    np.testing.assert_array_equal(got, run_np(board, rule, 24))
    assert got.sum() == 5  # still a glider, having crossed the corner of four shards


@pallas
def test_glider_on_2d_mesh_against_the_tpu_kernel():
    board = place(np.zeros((64, 64), dtype=np.int8), GLIDER, 26, 26)
    got = port((2, 2), block_steps=2, local_kernel="cuda").run(board, get_rule("conway"), 24)
    want = JaxShardedBackend(mesh_shape=(2, 2), block_steps=2, local_kernel="pallas",
                             pallas_interpret=True).run(board, jget_rule("conway"), 24)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
def test_include_center_variant(mesh_shape):
    _check(_board((40, 70), seed=59), "R2,C2,M1,S5..10,B5..8", 5, mesh_shape, route="k4", block_steps=2)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
def test_int8_remainder_blocks(mesh_shape):
    board = _board((40, 60), seed=37)
    rule = get_rule("brians_brain")
    runner = port(mesh_shape, block_steps=3).prepare(board, rule)
    for n in (7, 2, 0, 4):  # blocks of 3 and remainders of 1 and 2
        runner.advance(n)
    np.testing.assert_array_equal(runner.fetch(), run_np(board, rule, 13))


# -- tests/test_torus.py, the torus on 2-D meshes ------------------------------------


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4), (4, 2)])
def test_torus_2d_mesh_bit_identical(mesh_shape):
    _check(_board((32, 128), seed=sum(mesh_shape)), "conway:T", 10, mesh_shape, route="shard_ops")


def test_torus_2d_mesh_glider_circumnavigates():
    # 256 steps move a glider +64 rows and +64 columns: once round a 64x64
    # torus across row seams, word-column seams and both glued edges
    board = place(np.zeros((64, 64), dtype=np.int8), GLIDER, 30, 30)
    np.testing.assert_array_equal(port((2, 2)).run(board, get_rule("conway:T"), 256), board)


def test_torus_2d_mesh_deep_halo():
    _check(_board((24, 64), seed=61), "conway:T", 12, (2, 2), block_steps=4)


@pytest.mark.parametrize(
    "spec,shape,states,match",
    [("conway:T", (24, 24), 2, "divisible by 32"), ("conway:T", (24, 96), 2, "packed words divisible"),
     ("brians_brain:T", (24, 31), 3, "width \\(31\\) divisible by the column mesh"),
     ("conway:T", (25, 64), 2, "height \\(25\\) divisible")],
)
def test_torus_2d_mesh_constraint_errors(spec, shape, states, match):
    # any padding would sit inside a glued seam; both packages refuse
    board = _board(shape, seed=30, states=states)
    mesh_shape = (2, 2) if shape[1] != 96 else (2, 4)
    with pytest.raises(ValueError, match=match):
        port(mesh_shape).prepare(board, get_rule(spec))
    with pytest.raises(ValueError):
        JaxShardedBackend(mesh_shape=mesh_shape).run(board, jget_rule(spec), 1)


@pytest.mark.parametrize("spec,states", [("brians_brain:T", 3), ("R2,C2,S2..4,B2..3,NN:T", 2)],
                         ids=["generations", "ltl-diamond"])
def test_torus_2d_mesh_int8_rules(spec, states):
    _check(_board((24, 44), seed=62, states=states), spec, 8, (2, 2), route="shard_ops")


def test_torus_2d_mesh_of_one_row_wraps_its_own_rows():
    _check(_board((16, 96), seed=63), "highlife:T", 9, (1, 3), route="shard_ops", block_steps=2)


# -- routes, pins, copies and the runner on a grid --------------------------------


@pytest.mark.parametrize(
    "spec,bitpack,routes",
    [
        ("conway", True, {"auto": "shard_ops", "cuda": "k4", "torch": "shard_ops"}),
        ("conway", False, {"auto": "k4", "cuda": "k4", "torch": "shard_ops"}),
        ("brians_brain", True, {"auto": "k4", "cuda": "k4", "torch": "shard_ops"}),
        ("bugs", True, {"auto": "k4", "cuda": "k4", "torch": "shard_ops"}),
        ("R2,C2,S2..4,B2..3,NN", True, {"auto": "shard_ops", "cuda": "Moore boxes only", "torch": "shard_ops"}),
        ("R3,C2,S6..10,B6..8,NN", True, {"auto": "shard_ops", "cuda": "Moore boxes only", "torch": "shard_ops"}),
        ("conway:T", True, {"auto": "shard_ops", "cuda": "full-width stripes only", "torch": "shard_ops"}),
        ("brians_brain:T", True, {"auto": "shard_ops", "cuda": "full-width stripes only", "torch": "shard_ops"}),
    ],
)
def test_routes_on_a_2d_mesh(spec, bitpack, routes):
    # the JAX backend's _resolve_local_kernel and _use_bits: on a 2-D mesh
    # auto keeps the packed rules on plain ops, a cuda pin runs life-like
    # rules unpacked through K4, and K3 stays on row meshes
    for local_kernel, want in routes.items():
        backend = port((2, 2), bitpack=bitpack, local_kernel=local_kernel)
        if want in ("k4", "shard_ops"):
            assert backend.route(get_rule(spec)) == want
        else:
            with pytest.raises(ValueError, match=want):
                backend.route(get_rule(spec))


@pytest.mark.parametrize("spec,route", [("brians_brain", "k4"), ("conway", "k3"), ("conway:T", "k3_torus"),
                                        ("R2,C2,S2..4,B2..3,NN", "k3_diamond")])
def test_a_mesh_of_one_column_keeps_the_row_mesh_routes(spec, route):
    assert port((3, 1)).route(get_rule(spec)) == route
    assert port((3, 1)).n_cols == 1


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: ShardedBackend(device="cpu", mesh_shape=(2, 2), num_devices=3), r"\(2, 2\) \(4 devices\) contradicts"),
        (lambda: ShardedBackend(mesh=make_mesh(devices=["cpu"] * 4), mesh_shape=(2, 2)), "not both"),
        (lambda: ShardedBackend(device="cpu", mesh_shape=(0, 2)), "two positive ints"),
    ],
)
def test_mesh_shape_refusals(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def test_mesh_shape_equals_num_devices_when_they_agree():
    backend = ShardedBackend(device="cpu", mesh_shape=(2, 3), num_devices=6)
    assert backend.mesh.shape == {"rows": 2, "cols": 3} and backend.mesh.size == 6


@pytest.mark.parametrize(
    "spec,mesh_shape,k,steps,packed",
    [("brians_brain", (2, 2), 2, 6, False), ("conway", (2, 4), 3, 7, True), ("bugs", (3, 2), 1, 3, False)],
)
def test_copies_and_launches_per_block(spec, mesh_shape, k, steps, packed):
    # each block: one exchange of rows (2(R-1)C copies) and one of columns
    # (three copies a halo: 6R(C-1)); on CPU tensors K4's wrapper runs the
    # plain version and counts no launch
    rule = get_rule(spec)
    board = _board((40, 100), seed=7, states=rule.states)
    runner = port(mesh_shape, block_steps=k).prepare(board, rule)
    assert (runner.route == "k4") != packed
    halo.exchange_rows.copies = halo.exchange_cols.copies = 0
    before = sharded_int8.sharded_int8_block.launches
    runner.advance(steps)
    r, c = mesh_shape
    blocks = -(-steps // k)
    assert halo.exchange_rows.copies == 2 * (r - 1) * c * blocks
    assert halo.exchange_cols.copies == 6 * r * (c - 1) * blocks
    assert sharded_int8.sharded_int8_block.launches == before
    np.testing.assert_array_equal(runner.fetch(), run_np(board, rule, steps))


@pytest.mark.parametrize("bitpack", [True, False])
def test_runner_contract_on_a_grid(bitpack):
    board = _board((30, 70), seed=17)
    rule = get_rule("conway")
    runner = port((2, 3), block_steps=3, bitpack=bitpack).prepare(board, rule)
    # ceil(30 / 2) rows; ceil(70 / 3) = 24 cells, or ceil(3 words / 3) = 1 word
    assert [tuple(c.shape) for c in runner.chunks] == [(15, 1 if bitpack else 24)] * 6
    assert runner.grid == (2, 3)
    snap = runner.snapshot()
    runner.advance(4)
    runner.sync()
    np.testing.assert_array_equal(snap(), board)
    want = run_np(board, rule, 4)
    np.testing.assert_array_equal(runner.fetch(), want)
    assert runner.live_count() == int((want == 1).sum())
    assert tuple(runner.gather().shape) == ((30, 3) if bitpack else (30, 70))


def test_explicit_mesh_of_2d_shape():
    mesh = make_mesh_2d((2, 2), devices=["cpu"] * 4)
    board = _board((20, 30), seed=8, states=3)
    got = ShardedBackend(mesh=mesh, block_steps=2).run(board, get_rule("brians_brain"), 5)
    np.testing.assert_array_equal(got, run_np(board, get_rule("brians_brain"), 5))
