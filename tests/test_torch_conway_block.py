"""Kernel K5's plain version against the JAX package's Conway block kernel
(``experiments/pallas_bench.py``: ``make_kernel`` with ``conway_pallas``'s
specs, in Pallas interpret mode on the CPU) and the numpy oracle, on
boards from ``np.random.default_rng``; every comparison is exact.  Also
the wrapper's domain, its CPU path, its tiles and launch split, a numpy
model of the kernel's int8 rows policy (``Int8Io`` in
``csrc/packed_stripe.cu``: bytes packed to bits as they load, unpacked as
they store) against ``bitlife.pack_np``, and the port's experiment
(``tpu_life_torch.experiments.block_bench``)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from experiments.pallas_bench import make_kernel
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops.reference import run_np as jrun_np
from tpu_life_torch.experiments import block_bench
from tpu_life_torch.kernels import conway_block as k5
from tpu_life_torch.kernels import packed_stripe as ps
from tpu_life_torch.ops import bitlife

# (n, bh, k): k < bh, k == bh (the edge blocks' halos reach the whole
# neighbouring block), a block and its halos filling the board (32, 16, 8)
CASES = [(32, 16, 8), (48, 16, 3), (64, 16, 4), (64, 16, 16), (96, 32, 8)]
H100_SMS = 132


def _jax_conway_block(n, bh, k):
    """``conway_pallas(n, bh, k)`` in interpret mode: its kernel, grid and
    specs, with the backend-neutral ``ANY`` memory space."""
    kernel, nb, ext = make_kernel(n, bh, k)
    return pl.pallas_call(
        kernel,
        grid=(nb,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((bh, n), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, n), jnp.int8),
        scratch_shapes=[pltpu.VMEM((ext, n), jnp.int8), pltpu.SemaphoreType.DMA(())],
        interpret=True,
    )


def _board(n, seed):
    return np.random.default_rng(seed).integers(0, 2, size=(n, n), dtype=np.int8)


def _plain(board, k):
    return k5.conway_block_plain(torch.from_numpy(board), k).numpy()


@pytest.mark.parametrize("n,bh,k", CASES)
def test_plain_equals_the_jax_kernel(n, bh, k):
    board = _board(n, seed=n * 31 + k)
    want = np.asarray(_jax_conway_block(n, bh, k)(board))
    np.testing.assert_array_equal(_plain(board, k), want)


@pytest.mark.parametrize("n,bh,k", CASES)
def test_plain_equals_run_np(n, bh, k):
    board = _board(n, seed=n * 17 + k)
    board[[0, -1], :] = 1  # live cells on all four edges
    board[:, [0, -1]] = 1
    np.testing.assert_array_equal(_plain(board, k), jrun_np(board, jget_rule("conway"), k))


@pytest.mark.parametrize(
    "shape,bh,k,match",
    [
        ((32, 16), 8, 4, "square"),
        ((48, 48), 20, 4, "divide"),
        ((48, 48), 0, 1, "divide"),
        ((48, 48), 16, 0, r"\[1, bh=16\]"),
        ((64, 64), 16, 17, r"\[1, bh=16\]"),  # the JAX kernel's wrong board
        ((32, 32), 16, 9, "exceed"),  # the JAX kernel does not trace
        ((16, 16), 16, 2, "exceed"),
    ],
)
def test_out_of_domain_raises(shape, bh, k, match):
    with pytest.raises(ValueError, match=match):
        k5.conway_block(torch.zeros(shape, dtype=torch.int8), bh, k)


def test_wrong_dtype_and_layout_raise():
    with pytest.raises(TypeError, match="int8"):
        k5.conway_block(torch.zeros((32, 32), dtype=torch.int32), 16, 4)
    with pytest.raises(ValueError, match="contiguous"):
        k5.conway_block(torch.zeros((32, 32), dtype=torch.int8).t()[:, :], 16, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k5.conway_block(torch.zeros((32, 32), dtype=torch.int8, device="meta"), 16, 4)


def test_cpu_wrapper_runs_the_plain_version_and_launches_nothing():
    board = torch.from_numpy(_board(64, seed=5))
    before = k5.conway_block.launches
    got = k5.conway_block(board, 16, 16)
    assert k5.conway_block.launches == before
    assert torch.equal(got, k5.conway_block_plain(board, 16))
    assert torch.equal(board, torch.from_numpy(_board(64, seed=5)))  # x left as it was


# the sides K5 runs at: odd (byte loads), 1000 (8-byte loads, a partial
# last word), the experiment's default and the full side
@pytest.mark.parametrize("n", [9, 1000, 8192, 16384])
def test_tile_pick_fits_one_block_at_every_depth(n):
    for k in range(1, k5.MAX_DEPTH + 1):
        rows, warp_rows = k5.tile_shape(n, k, H100_SMS)
        assert warp_rows in (ps.SMALL_WARP_ROWS, ps.LARGE_WARP_ROWS)
        assert 1 <= rows <= n
        assert -(-(rows + 2 * k) // warp_rows) <= ps.TILE_WARPS, (n, k)


# on a board that fills the card, the fewest rows (never under 16) whose
# halo of 2k rows is at most a quarter of them, 8 rows a warp from 32 rows
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32])
def test_tile_pick_on_a_full_board_keeps_the_halo_a_quarter_of_the_rows(k):
    for n in (8192, 16384):
        rows, warp_rows = k5.tile_shape(n, k, H100_SMS)
        assert rows + 2 * k == max(16, 8 * k)
        assert warp_rows == (ps.SMALL_WARP_ROWS if rows + 2 * k == 16 else ps.LARGE_WARP_ROWS)


@pytest.mark.parametrize(
    "k,want",
    [(1, [1]), (8, [8]), (32, [32]), (33, [32, 1]), (37, [32, 5]), (128, [32] * 4),
     (1024, [32] * 32)],
)
def test_launch_depths_split_past_max_depth(k, want):
    assert k5.MAX_DEPTH == 32
    assert k5.launch_depths(k) == want


def _int8io_constants():
    """The multipliers and mask of ``Int8Io``'s pack and unpack, read from
    the CUDA source."""
    src = ps.SOURCE.read_text()
    return {
        name: int(re.search(rf"constexpr uint32_t {name} = (0x[0-9A-Fa-f]+)u;", src).group(1), 16)
        for name in ("kPackMul", "kUnpackMul", "kByteOnes")
    }


def _pack4(w, c):
    return (int(w) * c["kPackMul"] & 0xFFFFFFFF) >> 24


def _unpack4(nib, c):
    return int(nib) * c["kUnpackMul"] & c["kByteOnes"] & 0xFFFFFFFF


def _load_row(row, vec, c):
    """``Int8Io::load`` over every word column of one int8 row: groups of
    ``vec`` bytes (4-byte words read little-endian, 4 bits each), group g's
    bits at ``vec * g``; single bytes at their own bit."""
    words = []
    for gw in range(-(-row.size // 32)):
        seg = row[32 * gw:32 * gw + 32]
        v = 0
        if vec == 1:
            for b, cell in enumerate(seg):
                v |= int(cell) << b
        else:
            for g in range(seg.size // vec):
                quads = np.ascontiguousarray(seg[vec * g:vec * (g + 1)]).view("<u4")
                bits = 0
                for i, w in enumerate(quads):
                    bits |= _pack4(w, c) << (4 * i)
                v |= bits << (vec * g)
        words.append(v)
    return np.array(words, dtype=np.uint32)


def _store_row(words, n, vec, c):
    """``Int8Io::store`` of every word column: the n bytes of the row."""
    out = np.zeros(n, dtype=np.int8)
    for gw, v in enumerate(int(w) for w in words):
        count = min(32, n - 32 * gw)
        if vec == 1:
            for b in range(count):
                out[32 * gw + b] = v >> b & 1
            continue
        for g in range(count // vec):
            h = v >> (vec * g)
            quads = [_unpack4(h >> (4 * i) & 0xF, c) for i in range(vec // 4)]
            at = 32 * gw + vec * g
            out[at:at + vec] = np.array(quads, dtype="<u4").view(np.int8)
    return out


def test_int8io_pack_and_unpack_round_trip_every_four_cell_pattern():
    c = _int8io_constants()
    for pattern in range(16):
        cells = np.array([pattern >> b & 1 for b in range(4)], dtype=np.int8)
        word = int(cells.view("<u4")[0])
        assert _pack4(word, c) == pattern
        assert _unpack4(pattern, c) == word


# n % 32 of 0, 1, 31, 8 and 4; every load width that divides n, as the
# boards' addresses allow
@pytest.mark.parametrize("n", [64, 65, 95, 1000, 996])
def test_int8io_rows_equal_pack_np(n):
    c = _int8io_constants()
    rows = np.random.default_rng(n).integers(0, 2, size=(6, n), dtype=np.int8)
    rows[0] = 1  # every cell live, the last partial word's top bits included
    want = bitlife.pack_np(rows)
    for vec in (v for v in (16, 8, 4, 1) if n % v == 0):
        for row, packed in zip(rows, want):
            words = _load_row(row, vec, c)
            np.testing.assert_array_equal(words, packed)
            np.testing.assert_array_equal(_store_row(words, n, vec, c), row)


def test_block_bench_on_the_cpu(capsys):
    assert block_bench.run(n=64, bh=16, k=4, outer=2, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "correct after 8 steps: True"
    assert out[1].startswith("n=64 bh=16 k=4: ") and out[1].endswith(" cells/s")


def test_block_bench_main_parses_key_value_arguments(capsys):
    assert block_bench.main(["n=48", "bh=16", "k=3", "outer=1", "device=cpu"]) == 0
    assert capsys.readouterr().out.startswith("correct after 6 steps: True")
    with pytest.raises(ValueError):
        block_bench.main(["n=64", "bh=16", "k=20", "device=cpu"])


def test_block_bench_exits_non_zero_on_a_wrong_board(monkeypatch, capsys):
    monkeypatch.setattr(block_bench, "conway_block", lambda x, bh, k, out=None: torch.zeros_like(x))
    assert block_bench.main(["n=32", "bh=16", "k=2", "device=cpu"]) == 1
    assert capsys.readouterr().out.startswith("correct after 4 steps: False")
