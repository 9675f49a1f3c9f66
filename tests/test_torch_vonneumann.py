"""Von Neumann (diamond) rules in the port, on the CPU: the gates, the
bit-sliced diamond in plain torch, kernel K1's diamond mode through its
plain version and its rule table, the int8 route of the other diamonds,
the routes the backends take and the CLI — each against the JAX package
(``tpu_life``) and the numpy oracle, bit for bit.  Mirrors
``tests/test_vonneumann.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_life import cli as jcli
from tpu_life.backends.jax_backend import JaxBackend
from tpu_life.backends.pallas_backend import PallasBackend
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops import bitlife as jbitlife
from tpu_life_torch import cli, interop
from tpu_life_torch.backends.base import get_backend, make_runner
from tpu_life_torch.backends.cuda_backend import CudaBackend
from tpu_life_torch.io.codec import write_board, write_config
from tpu_life_torch.kernels import packed_stripe as ps
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.ops.boolmin import membership_rule_sop
from tpu_life_torch.ops.reference import run_np

from test_torch_kernel import kernel_sop

VN_SPEC = "R2,C2,S2..4,B2..3,NN"
DIAMONDS = [VN_SPEC, "R1,C2,S2..3,B3,NN", "R2,C2,M1,S3..6,B3..5,NN"]
DIAMOND_IDS = ["r2", "r1", "m1-center"]
# the rules of tests/test_vonneumann.py's gate test, and the other families
GATE_SPECS = [
    *DIAMONDS, "R3,C2,S6..10,B6..8,NN", "R2,C3,S2..4,B2..3,NN", "R2,C2,S2..4,B2..3,NN:T",
    "conway", "conway:T", "brians_brain", "brians_brain:T", "bugs", "R1,C2,M1,S2..3,B3,NN",
]


def _board(shape, seed, states=2):
    return np.random.default_rng(seed).integers(0, states, size=shape, dtype=np.int8)


def _words_np(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


@pytest.mark.parametrize("spec", GATE_SPECS)
def test_gates_match_jax(spec):
    rule, jrule = get_rule(spec), jget_rule(spec)
    for gate in ("supports_family", "supports", "supports_torus", "supports_diamond"):
        assert getattr(bitlife, gate)(rule) == getattr(jbitlife, gate)(jrule), gate


def test_diamond_gate_bounds():
    for spec in DIAMONDS:
        assert bitlife.supports_diamond(get_rule(spec))
    for spec in ("R3,C2,S6..10,B6..8,NN", "R2,C3,S2..4,B2..3,NN", VN_SPEC + ":T", "conway"):
        assert not bitlife.supports_diamond(get_rule(spec))
        with pytest.raises(ValueError, match="von Neumann"):
            bitlife.make_packed_diamond_step(get_rule(spec))


@pytest.mark.parametrize("shape", [(24, 40), (33, 65), (17, 31)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("spec", DIAMONDS, ids=DIAMOND_IDS)
def test_packed_diamond_bit_identical(spec, shape):
    # r = 1, r = 2 and the M1 form (another count_max, another SOP layout)
    # at every width class, several steps
    h, w = shape
    b = _board(shape, seed=h + w)
    got = bitlife.multi_step_packed_diamond(
        interop.board_from_reference(b, shape), rule=get_rule(spec), steps=9, logical_shape=shape
    )
    want = jbitlife.multi_step_packed_diamond(
        jnp.asarray(jbitlife.pack_np(b)), rule=jget_rule(spec), steps=9, logical_shape=shape
    )
    np.testing.assert_array_equal(_words_np(got), np.asarray(want))
    np.testing.assert_array_equal(
        interop.board_to_reference(got, shape), run_np(b, get_rule(spec), 9)
    )


@pytest.mark.parametrize("width", range(1, 41))
def test_packed_diamond_every_width_1_to_40(width):
    # the shifts by 2 cross the word boundary differently at every layout
    # class: sub-word, the exact word, a word and a remainder
    shape = (12, width)
    b = _board(shape, seed=100 + width)
    rule = get_rule(VN_SPEC)
    got = interop.board_from_reference(b, shape)
    want = jnp.asarray(jbitlife.pack_np(b))
    step = bitlife.make_masked_packed_step(rule, shape)  # picks the diamond
    jstep = jbitlife.make_masked_packed_step(jget_rule(VN_SPEC), shape)
    for _ in range(3):
        got, want = step(got), jstep(want)
    np.testing.assert_array_equal(_words_np(got), np.asarray(want))
    np.testing.assert_array_equal(interop.board_to_reference(got, shape), run_np(b, rule, 3))


def test_unmasked_diamond_step_matches_jax():
    # births past a ragged right edge: the raw step, before the mask
    b = _board((20, 45), seed=9)
    got = bitlife.make_packed_diamond_step(get_rule(VN_SPEC))(interop.board_from_reference(b, b.shape))
    want = jbitlife.make_packed_diamond_step(jget_rule(VN_SPEC))(jnp.asarray(jbitlife.pack_np(b)))
    np.testing.assert_array_equal(_words_np(got), np.asarray(want))


@pytest.mark.parametrize("spec", DIAMONDS, ids=DIAMOND_IDS)
def test_kernel_wrapper_and_cuda_backend_match_pallas_interpret(spec):
    # the diamond mode of the TPU stripe kernel in interpret mode, on a
    # board tall enough for its stripes, against K1's plain version
    b = _board((512, 70), seed=53)
    rule = get_rule(spec)
    want = run_np(b, rule, 6)
    np.testing.assert_array_equal(
        PallasBackend(interpret=True, block_rows=128).run(b, jget_rule(spec), 6), want
    )
    before = (ps.packed_multi_step.launches, ps.packed_multi_step.diamond_launches)
    got = ps.packed_multi_step(interop.board_from_reference(b, b.shape), rule, b.shape, 6, block_steps=4)
    assert (ps.packed_multi_step.launches, ps.packed_multi_step.diamond_launches) == before
    np.testing.assert_array_equal(interop.board_to_reference(got, b.shape), want)
    np.testing.assert_array_equal(CudaBackend(device="cpu").run(b, rule, 6), want)


@pytest.mark.parametrize("block_steps", [1, 2, 8, 16, 32])
@pytest.mark.parametrize("spec", DIAMONDS, ids=DIAMOND_IDS)
def test_diamond_block_depths_with_a_remainder(spec, block_steps):
    # 2k + 1 steps: whole blocks and a remainder; 32 clamps to 16 at r = 2
    rule = get_rule(spec)
    k = ps.clamp_block_steps(rule, block_steps)
    assert k == min(block_steps, 32 // rule.radius)
    b = _board((150, 70), seed=block_steps)
    got = CudaBackend(device="cpu", block_steps=block_steps).run(b, rule, 2 * k + 1)
    np.testing.assert_array_equal(got, run_np(b, rule, 2 * k + 1))


@pytest.mark.parametrize(
    "spec", [*DIAMONDS, "R1,C2,M1,S2..3,B3,NN"], ids=[*DIAMOND_IDS, "r1-m1-center"]
)
def test_diamond_sop_table_is_the_rule(spec):
    # the kernel's rule table on every input it can see: count planes
    # b0..b3 as literals 0..3 and the cell as literal 4, whatever nplanes is
    rule = get_rule(spec)
    count_max = bitlife.diamond_count_max(rule)
    nplanes, sop = membership_rule_sop(rule.birth, rule.survive, count_max)
    assert nplanes == (3 if rule.radius == 1 else 4)
    table = ps.sop_table(rule)
    assert table.n_terms == len(sop)
    for cell in (0, 1):
        for count in range(count_max + 1):
            lits = [((count >> b) & 1) * 0xFFFFFFFF for b in range(4)] + [cell * 0xFFFFFFFF]
            out = 0
            for t in range(table.n_terms):
                term = 0xFFFFFFFF
                for i in range(5):
                    term &= (lits[i] ^ table.flip[t][i]) | table.loose[t][i]
                out |= term
            want = count in (rule.survive if cell else rule.birth)
            assert out == (0xFFFFFFFF if want else 0), (cell, count)
    if nplanes == 3:  # the plane the count never reaches is ignored
        assert all(table.loose[t][3] == 0xFFFFFFFF for t in range(table.n_terms))


@pytest.mark.parametrize(
    "spec,ops", [(VN_SPEC, 26), ("R1,C2,S2..3,B3,NN", 9), ("R2,C2,M1,S3..6,B3..5,NN", 27)]
)
def test_diamond_logic_ops_per_word_step(spec, ops):
    # r = 2: 4 shifts, the box add (2), 8 + 4 + 2 for the trees, b2 and b3,
    # and the SOP's literals // 2; r = 1: 2 shifts, two adds (4), b1, b2
    assert ps.logic_ops_per_word_step(get_rule(spec)) == ops


@pytest.mark.parametrize(
    "args,shape",
    [
        # (k, height, nwords, SMs, radius) -> (tile rows, rows a warp): a
        # diamond of radius 2 has twice the halo, 2 r k rows, so its tiles
        # are taller for the same k
        ((1, 16384, 512, 132, 2), (28, 8)),
        ((2, 16384, 512, 132, 2), (56, 8)),
        ((5, 16384, 512, 132, 2), (108, 8)),
        ((8, 16384, 512, 132, 2), (224, 8)),
        ((12, 16384, 512, 132, 2), (208, 8)),
        ((16, 16384, 512, 132, 2), (192, 8)),
        ((8, 4096, 512, 132, 2), (224, 8)),
        # a small board: four rows a warp and the tile that puts the fewest
        # warps on a scheduler
        ((8, 1500, 16, 132, 2), (12, 4)),
        ((16, 1500, 16, 132, 2), (12, 4)),
        ((1, 1500, 16, 132, 2), (12, 4)),
    ],
)
def test_tile_shape_scales_with_the_radius(args, shape):
    assert ps.tile_shape(*args) == shape


@pytest.mark.parametrize(
    "spec", [*DIAMONDS, "R1,C2,M1,S2..3,B3,NN", "R2,C2,S,B,NN", "R2,C2,S0..12,B0..12,NN"],
    ids=[*DIAMOND_IDS, "r1-m1-center", "r2-empty", "r2-full"],
)
def test_diamond_kernel_sop_is_the_rule(spec):
    # the data rule as the kernel evaluates it (terms 0 and 1 always, each
    # the AND over five literals of (lit ^ flip) | loose) on every count the
    # diamond reaches, one input a bit of the words
    rule = get_rule(spec)
    count_max = bitlife.diamond_count_max(rule)
    nplanes, sop = membership_rule_sop(rule.birth, rule.survive, count_max)
    table = ps.sop_table(rule)
    inputs = [(count, cell) for cell in (0, 1) for count in range(count_max + 1)]
    lits = [sum(((count >> b) & 1) << n for n, (count, _) in enumerate(inputs)) for b in range(nplanes)]
    lits += [0] * (4 - nplanes) + [sum(cell << n for n, (_, cell) in enumerate(inputs))]
    out = kernel_sop(table, lits)
    for n, (count, cell) in enumerate(inputs):
        want = count in (rule.survive if cell else rule.birth)
        assert want == any((count | cell << nplanes) & m == v for m, v in sop)
        assert (out >> n & 1) == want, (count, cell)


@pytest.mark.parametrize("shape", [(1, 1), (1, 40), (2, 5), (3, 33)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("spec", DIAMONDS, ids=DIAMOND_IDS)
def test_boards_shallower_than_the_radius_keep_their_shape(spec, shape):
    # a row shift past the board's height leaves an all-zero plane of the
    # board's height (it once grew the board by the shift)
    b = _board(shape, seed=7 * shape[0] + shape[1])
    rule = get_rule(spec)
    got = bitlife.multi_step_packed(
        interop.board_from_reference(b, shape), rule=rule, steps=3, logical_shape=shape
    )
    want = jbitlife.multi_step_packed_diamond(
        jnp.asarray(jbitlife.pack_np(b)), rule=jget_rule(spec), steps=3, logical_shape=shape
    )
    np.testing.assert_array_equal(_words_np(got), np.asarray(want))
    np.testing.assert_array_equal(interop.board_to_reference(got, shape), run_np(b, rule, 3))


def test_wrapper_refuses_what_neither_mode_runs():
    x = torch.zeros((8, 2), dtype=torch.int32)
    for spec in ("R3,C2,S6..10,B6..8,NN", "R1,C3,S1..2,B2,NN", VN_SPEC + ":T", "conway:T"):
        with pytest.raises(ValueError, match="von Neumann rules of radius <= 2"):
            ps.packed_multi_step(x, get_rule(spec), (8, 40), 1, block_steps=8)
    with pytest.raises(ValueError, match="block_steps"):
        ps.packed_multi_step(x, get_rule(VN_SPEC), (8, 40), 1, block_steps=33)


@pytest.mark.parametrize(
    "spec,states", [("R3,C2,S6..10,B6..8,NN", 2), ("R1,C3,S1..2,B2,NN", 3), (VN_SPEC, 2)],
    ids=["r3", "generations", "r2-no-bitpack"],
)
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_int8_von_neumann_route_matches_jax_and_oracle(backend, spec, states):
    b = _board((37, 41), seed=11, states=states)
    rule = get_rule(spec)
    bitpack = spec != VN_SPEC
    want = run_np(b, rule, 8)
    np.testing.assert_array_equal(JaxBackend(bitpack=bitpack).run(b, jget_rule(spec), 8), want)
    runner = make_runner(get_backend(backend, device="cpu", bitpack=bitpack), b, rule)
    assert runner.route == "stencil" and runner.x.dtype == torch.int8
    runner.advance(5)
    runner.advance(3)
    np.testing.assert_array_equal(runner.fetch(), want)
    assert runner.live_count() == int((want == 1).sum())
    assert not np.shares_memory(runner.x.numpy(), b)  # the runner's board is its own


@pytest.mark.parametrize(
    "spec,bitpack,cuda_route,torch_route",
    [
        ("conway", True, "k1", "packed"),
        (VN_SPEC, True, "k1_diamond", "packed_diamond"),
        ("R1,C2,S2..3,B3,NN", True, "k1_diamond", "packed_diamond"),
        ("R2,C2,M1,S3..6,B3..5,NN", True, "k1_diamond", "packed_diamond"),
        ("brians_brain", True, "k2", "stencil"),
        ("bugs", True, "k2", "stencil"),
        ("conway", False, "k2", "stencil"),
        ("conway:T", True, "packed_torus", "packed_torus"),
        ("R3,C2,S6..10,B6..8,NN", True, "stencil", "stencil"),
        ("R1,C3,S1..2,B2,NN", True, "stencil", "stencil"),
        (VN_SPEC + ":T", True, "stencil", "stencil"),
        ("brians_brain:T", True, "stencil", "stencil"),
        ("bugs:T", True, "stencil", "stencil"),
        (VN_SPEC, False, "stencil", "stencil"),
        ("conway:T", False, "stencil", "stencil"),
    ],
)
def test_routes(spec, bitpack, cuda_route, torch_route):
    # the table of the cuda backend's dispatch, and the torch backend's
    # order: packed where it can, bitpack=False respected
    rule = get_rule(spec)
    b = _board((24, 33), seed=88, states=rule.states)
    for backend, route in (("cuda", cuda_route), ("torch", torch_route)):
        runner = make_runner(get_backend(backend, device="cpu", bitpack=bitpack), b, rule)
        assert runner.route == route
        packed = route in ("k1", "k1_diamond", "packed", "packed_diamond", "packed_torus")
        assert runner.x.dtype == (torch.int32 if packed else torch.int8)
        runner.advance(4)
        np.testing.assert_array_equal(runner.fetch(), run_np(b, rule, 4))


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (5, 40)])
def test_tiny_diamond_board_stays_on_the_kernel_path(shape):
    # no small-board fallback for diamonds either
    b = _board(shape, seed=1)
    rule = get_rule("R1,C2,S2..3,B3,NN")
    runner = make_runner(CudaBackend(device="cpu"), b, rule)
    assert runner.route == "k1_diamond"
    runner.advance(5)
    np.testing.assert_array_equal(runner.fetch(), run_np(b, rule, 5))


@pytest.mark.parametrize(
    "rule,extra",
    [
        (VN_SPEC, []),
        ("R1,C2,S2..3,B3,NN", ["--block-steps", "3"]),
        ("R2,C2,M1,S3..6,B3..5,NN", ["--backend", "torch"]),
        ("R3,C2,S6..10,B6..8,NN", []),
        ("R1,C3,S1..2,B2,NN", []),
        (VN_SPEC, ["--no-bitpack"]),
    ],
)
def test_cli_bytes_equal_jax_numpy_backend(tmp_path, rule, extra):
    states = get_rule(rule).states
    write_board(tmp_path / "data.txt", _board((41, 53), seed=12, states=states))
    write_config(tmp_path / "grid_size_data.txt", 41, 53, 19)
    files = ["--config-file", str(tmp_path / "grid_size_data.txt"),
             "--input-file", str(tmp_path / "data.txt"), "--rule", rule]
    assert jcli.main(["run", *files, "--backend", "numpy",
                      "--output-file", str(tmp_path / "jax.txt")]) == 0
    assert cli.main(["run", *files, "--device", "cpu", *extra, "--sync-every", "7",
                     "--output-file", str(tmp_path / "port.txt")]) == 0
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
