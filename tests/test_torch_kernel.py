"""Kernel K1 (``kernels/packed_stripe.py``): its plain version against the
JAX Pallas kernel it replaces, run in interpret mode on the CPU as
``tests/test_pallas.py`` runs it; the wrapper's checks; the rule table
the CUDA source evaluates.  The CUDA kernel itself is held to the plain
version on the card by ``chip_smoke.py`` (this suite's conftest needs jax,
which the card's machine does not have)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_life.backends.pallas_backend import make_pallas_packed_multi_step
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops import bitlife as jbitlife
from tpu_life_torch import interop
from tpu_life_torch.kernels import packed_stripe as ps
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops.boolmin import rule_sop
from tpu_life_torch.ops.reference import run_np


def _ceil_to(x, m):
    return -(-x // m) * m


def pallas_reference(board, name, steps, k, block_rows):
    """``steps`` steps of the JAX Pallas stripe kernel (interpret mode) on
    a board framed as ``PallasBackend._prepare_packed`` frames it: ``fr``
    zero rows above and below, words padded to 128 lanes, height padded
    to whole stripes.  Returns the unframed uint32 words."""
    h, w = board.shape
    fr = _ceil_to(k, 8)
    packed = jbitlife.pack_np(board)
    wp = _ceil_to(packed.shape[1], 128)
    hp = fr + _ceil_to(h, block_rows) + fr
    host = np.zeros((hp, wp), dtype=np.uint32)
    host[fr : fr + h, : packed.shape[1]] = packed
    x = jnp.asarray(host)
    rule = jget_rule(name)
    blocks, rem = divmod(steps, k)
    for depth in [k] * blocks + ([rem] if rem else []):
        x = make_pallas_packed_multi_step(
            rule, (hp, wp), (h, w), fr, block_rows=block_rows, block_steps=depth,
            interpret=True,
        )(x)
    return np.asarray(x)[fr : fr + h, : packed.shape[1]]


@pytest.mark.parametrize(
    "name,shape,steps,k,block_rows",
    [
        ("conway", (70, 150), 9, 4, 16),  # 5 stripes, partial last word, remainder
        ("conway", (64, 64), 7, 3, 16),  # exact word multiple, remainder 1
        ("highlife", (40, 257), 3, 1, 16),  # one bit into a new word, k = 1
        ("day_and_night", (33, 96), 6, 4, 32),  # dense rule, all 32 bits of the last word
        ("seeds", (17, 260), 5, 4, 8),  # 3 stripes, a partial one
    ],
)
def test_plain_matches_pallas_interpret(name, shape, steps, k, block_rows):
    b = np.random.default_rng(sum(shape)).integers(0, 2, size=shape, dtype=np.int8)
    want = pallas_reference(b, name, steps, k, block_rows)
    x = interop.board_from_reference(b, shape)
    got = ps.packed_multi_step(x, get_rule(name), shape, steps, block_steps=k)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        interop.board_to_reference(got, shape), run_np(b, get_rule(name), steps)
    )


@pytest.mark.parametrize("name", ["conway", "highlife", "daynight", "seeds", "replicator", "reference_bug_compat"])
def test_sop_table_is_the_rule(name):
    # the kernel's data-driven rule, evaluated here on every input
    # (b0..b3 total planes, x centre) as single bits, equals rule_sop
    rule = get_rule(name)
    table = ps.sop_table(rule)
    sop = rule_sop(rule.birth, rule.survive)
    assert table.n_terms == len(sop)
    for i in range(32):
        lits = [((i >> b) & 1) * 0xFFFFFFFF for b in range(5)]
        out = 0
        for t in range(table.n_terms):
            term = 0xFFFFFFFF
            for b in range(5):
                term &= (lits[b] ^ table.flip[t][b]) | table.loose[t][b]
            out |= term
        want = any((i & mask) == value for mask, value in sop)
        assert out == (0xFFFFFFFF if want else 0), i


def test_wrapper_rejects_bad_inputs():
    rule = get_rule("conway")
    x = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        ps.packed_multi_step(x.to(torch.int64), rule, (4, 40), 1, block_steps=8)
    with pytest.raises(ValueError, match="shape"):
        ps.packed_multi_step(x, rule, (4, 70), 1, block_steps=8)
    with pytest.raises(ValueError, match="contiguous"):
        ps.packed_multi_step(
            torch.zeros((2, 4), dtype=torch.int32).t(), rule, (4, 40), 1, block_steps=8
        )
    with pytest.raises(ValueError, match="block_steps"):
        ps.packed_multi_step(x, rule, (4, 40), 1, block_steps=33)
    with pytest.raises(ValueError, match="block_steps"):
        ps.packed_multi_step(x, rule, (4, 40), 1, block_steps=0)
    with pytest.raises(ValueError, match="steps"):
        ps.packed_multi_step(x, rule, (4, 40), -1, block_steps=8)
    with pytest.raises(ValueError, match="life-like"):
        ps.packed_multi_step(x, get_rule("brians_brain"), (4, 40), 1, block_steps=8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ps.packed_multi_step(x.to("meta"), rule, (4, 40), 1, block_steps=8)


def test_cpu_tensor_takes_the_plain_version_without_launching():
    b = np.random.default_rng(0).integers(0, 2, size=(20, 50), dtype=np.int8)
    x = interop.board_from_reference(b, b.shape)
    before = ps.packed_multi_step.launches
    got = ps.packed_multi_step(x, get_rule("conway"), b.shape, 10, block_steps=4)
    assert ps.packed_multi_step.launches == before
    assert torch.equal(got, ps.packed_multi_step_plain(x, get_rule("conway"), b.shape, 10))


@pytest.mark.parametrize(
    "args,shape",
    [
        # tile_shape, the tiles of K1's diamond mode, K3, K5's small boards
        # and K1's batch mode on wide rows (the Moore mode has its own,
        # moore_tile_shape, tests/test_torch_k1_moore_design.py).
        # (k, height, nwords, SMs, radius) -> (tile rows, rows a warp): runs
        # of two halos (2 r k rows) give no more warps than the 4 * SMs warp
        # schedulers, so four rows a warp and the tile that puts the fewest
        # warps on a scheduler.  1500x500 (16 words, one strip), k = 8: 7
        # warps keep 28 rows, 12 of them output: 125 blocks, one an SM, two
        # warps a scheduler
        ((8, 1500, 16, 132, 1), (12, 4)),
        ((4, 1500, 16, 132, 1), (8, 4)),  # the reference run's remainder launch
        ((2, 1500, 16, 132, 1), (12, 4)),
        ((8, 375, 16, 132, 1), (4, 4)),  # a shard of 1500x500 on 4
        ((8, 1500, 16, 132, 2), (12, 4)),
        ((16, 1500, 16, 132, 2), (12, 4)),
        ((32, 1500, 16, 132, 1), (12, 4)),
        ((8, 300, 32, 132, 1), (8, 4)),  # 2 strips
        ((8, 2048, 64, 132, 1), (48, 4)),  # 3 strips x 128 runs of 16 rows = 384
        ((8, 31, 1, 132, 1), (4, 4)),
        ((8, 1, 1, 132, 1), (1, 4)),
    ],
)
def test_tile_shape_on_boards_that_leave_schedulers_idle(args, shape):
    k, height, nwords, n_sm, radius = args
    assert ps.tile_shape(*args) == shape
    rows, warp_rows = shape
    halo = 2 * radius * k
    assert -(-(rows + halo) // warp_rows) <= ps.TILE_WARPS  # the block holds the tile
    strips = -(-nwords // ps.STRIP_WORDS)
    assert strips * -(-height // halo) <= ps.SCHEDULERS_PER_SM * n_sm


@pytest.mark.parametrize(
    "args,rows",
    [
        # tile_shape (K3, the diamond mode, K1's batch mode on wide rows).
        # (k, height, nwords, SMs, radius) -> the tile's output rows at eight
        # rows a warp: the fewest warps of 4, 8, 16 and 32 (32 to 256 rows)
        # whose halo of 2 r k rows is at most a sixth of their rows, else 32.
        # 16384^2 (18 strips) on 132 SMs
        ((1, 16384, 512, 132, 1), 30),
        ((2, 16384, 512, 132, 1), 28),
        ((3, 16384, 512, 132, 1), 58),
        ((4, 16384, 512, 132, 1), 56),
        ((5, 16384, 512, 132, 1), 54),
        ((8, 16384, 512, 132, 1), 112),
        ((12, 16384, 512, 132, 1), 232),
        ((16, 16384, 512, 132, 1), 224),
        ((17, 16384, 512, 132, 1), 222),
        ((32, 16384, 512, 132, 1), 192),
        # 750 runs of two halos: too many to count as a small board
        ((1, 1500, 16, 132, 1), 30),
        # a 4096-row shard of 16384^2, as K3 runs it
        ((8, 4096, 512, 132, 1), 112),
        ((8, 5000, 63, 132, 1), 112),
        ((8, 16384, 200000, 132, 1), 112),
    ],
)
def test_tile_shape_on_larger_boards(args, rows):
    k, height, nwords, n_sm, radius = args
    assert ps.tile_shape(*args) == (rows, ps.LARGE_WARP_ROWS)
    halo = 2 * radius * k
    warps = -(-(rows + halo) // ps.LARGE_WARP_ROWS)
    assert warps in (4, 8, 16, 32) and (6 * halo <= warps * ps.LARGE_WARP_ROWS or warps == 32)


@pytest.mark.parametrize(
    "k,radius", [(k, radius) for radius in (1, 2) for k in range(1, ps.MAX_BLOCK_STEPS // radius + 1)]
)
def test_tile_shape_holds_every_depth(k, radius):
    # every depth the clamp allows (1-32; 1-16 at r = 2) gets a tile of at
    # least one output row whose block holds it, on small boards and large
    for height, nwords in ((1, 1), (1500, 16), (16384, 512)):
        rows, warp_rows = ps.tile_shape(k, height, nwords, 132, radius)
        assert 1 <= rows <= height and warp_rows in (ps.SMALL_WARP_ROWS, ps.LARGE_WARP_ROWS)
        assert -(-(rows + 2 * radius * k) // warp_rows) <= ps.TILE_WARPS


@pytest.mark.parametrize(
    "spec,compiled",
    [
        ("conway", True),
        ("life", True),
        ("B3/S23", True),  # Conway's rule under another name
        ("23/3", True),
        ("conway:T", True),
        ("highlife", False),
        ("daynight", False),
        ("seeds", False),
        ("life_without_death", False),
        ("reference_bug_compat", False),
        ("R1,C2,S2..3,B3,NN", False),
        ("R2,C2,S2..4,B2..3,NN", False),
        ("brians_brain", False),
    ],
)
def test_rule_dispatch_compiles_only_conway(spec, compiled):
    # the wrapper compares the minimized SOP with Conway's, not the name
    assert ps.compiled_rule(get_rule(spec)) is compiled


def test_every_other_life_like_rule_runs_as_data():
    from tpu_life_torch.models.rules import RULE_REGISTRY
    from tpu_life_torch.ops import bitlife

    for name, rule in RULE_REGISTRY.items():
        if bitlife.supports(rule) or bitlife.supports_torus(rule):
            assert ps.compiled_rule(rule) is (rule_sop(rule.birth, rule.survive) == ps.CONWAY_SOP), name
            assert ps.compiled_rule(rule) is (name in ("conway", "life")), name
        else:
            assert not ps.compiled_rule(rule), name


def kernel_sop(table, lits):
    """The data rule as the kernel evaluates it: terms 0 and 1 always (the
    table pads them), then the rest of the SOP's terms, each the AND over
    the five literals of (lit ^ flip) | loose."""
    out = 0
    for t in range(max(2, table.n_terms)):
        term = 0xFFFFFFFF
        for i in range(5):
            term &= (lits[i] ^ table.flip[t][i]) | table.loose[t][i]
        out |= term
    return out


@pytest.mark.parametrize("name", ["conway", "highlife", "daynight", "seeds", "replicator",
                                  "reference_bug_compat", "morley", "diamoeba", "maze", "B/S",
                                  "B012345678/S012345678", "B1357/S02468"])
def test_kernel_sop_is_the_rule(name):
    # every input a 3x3 total reaches (b0..b3 total planes, x centre: 0..8
    # around a dead cell, 1..9 with a live one),
    # each literal a word of all ones or all zeros, against rule_sop and the
    # rule's sets; then the same inputs bit-sliced in the bits of one word,
    # as the kernel sees them
    rule = get_rule(name)
    table = ps.sop_table(rule)
    sop = rule_sop(rule.birth, rule.survive)
    inputs = [total | x << 4 for x in (0, 1) for total in range(x, 9 + x)]
    for i in inputs:
        lits = [((i >> b) & 1) * 0xFFFFFFFF for b in range(5)]
        total, x = i & 15, i >> 4
        want = (total - 1 in rule.survive) if x else (total in rule.birth)
        assert want == any((i & mask) == value for mask, value in sop)
        assert kernel_sop(table, lits) == (0xFFFFFFFF if want else 0), i
    lits = [sum(((i >> b) & 1) << n for n, i in enumerate(inputs)) for b in range(5)]
    want = sum(any((i & mask) == value for mask, value in sop) << n for n, i in enumerate(inputs))
    assert kernel_sop(table, lits) & ((1 << len(inputs)) - 1) == want


def test_kernel_sop_of_short_sops_pads_the_terms_it_always_reads():
    # one term: term 1 repeats it; none: both hold b1 b2 b3, a total of 14
    # or 15, which no 3x3 total reaches
    seeds = ps.sop_table(get_rule("seeds"))
    assert seeds.n_terms == 1
    assert list(seeds.flip[1]) == list(seeds.flip[0]) and list(seeds.loose[1]) == list(seeds.loose[0])
    empty = ps.sop_table(get_rule("B/S"))
    assert empty.n_terms == 0
    for t in (0, 1):
        assert [empty.loose[t][i] == 0 for i in range(5)] == [False, True, True, True, False]
    for total in range(10):
        for x in (0, 1):
            lits = [((total >> b) & 1) * 0xFFFFFFFF for b in range(4)] + [x * 0xFFFFFFFF]
            assert kernel_sop(empty, lits) == 0


@pytest.mark.parametrize(
    "name,ops", [("conway", 15), ("highlife", 17), ("day_and_night", 19), ("seeds", 14)]
)
def test_logic_ops_per_word_step(name, ops):
    # conway: carry-save adds 2 + 4, shifts 4, planes b1 and b2, and its
    # 7-literal SOP (b0 b1 ~b2 | x ~b0 ~b1 b2) in 3 three-input instructions
    assert ps.logic_ops_per_word_step(get_rule(name)) == ops


def test_stripe_sweep_needs_the_card(monkeypatch):
    from tpu_life_torch.experiments import stripe_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        stripe_sweep.main([])


@pytest.mark.parametrize("name", ["conway", "highlife", "R2,C2,S2..4,B2..3,NN", "conway:T"])
def test_stripe_sweep_cases_hold_the_plain_version(monkeypatch, name):
    # the sweep's cases on CPU tensors (the wrappers' plain versions), with
    # the profiler's timing replaced: each case runs its launch and checks
    # it against the plain version without exiting
    from tpu_life_torch.experiments import stripe_sweep

    launched = []
    monkeypatch.setattr(stripe_sweep, "_device_ms", lambda launch, reps: launched.append(launch()) or 0.0)
    rng = np.random.default_rng(5)
    cpu = torch.device("cpu")
    if not name.endswith(":T"):
        assert stripe_sweep.k1_case(name, (40, 70), 3, rng, cpu) == 0.0
    assert stripe_sweep.k3_case(name, (40, 70), 4, 2, rng, cpu) == 0.0
    assert len(launched) == (1 if name.endswith(":T") else 2)
