"""The port's 2-D meshes on the CPU: ``make_mesh_2d``, the block split and
gather of numpy boards at ragged sizes, the shards' least extent (a
radius, so every halo comes from the next shard), and the two-phase halo
exchange (rows, then the row-extended columns), every cell of each
shard's halo-extended chunk, corners included, checked against a padded
numpy board, clamped and on the torus; with the copies each exchange
makes.  The JAX package builds the same mesh (``tpu_life.parallel.mesh
.make_mesh_2d``) and the same exchange (``make_sharded_run_2d``)."""

import numpy as np
import pytest
import torch

from tpu_life.parallel.mesh import make_mesh_2d as jmake_mesh_2d
from tpu_life_torch import interop
from tpu_life_torch.parallel import halo, mesh


def test_make_mesh_2d_lays_devices_out_row_major():
    devices = [torch.device("cpu")] * 6
    m = mesh.make_mesh_2d((2, 3), devices=devices)
    assert m.shape == {mesh.ROW_AXIS: 2, mesh.COL_AXIS: 3} == {"rows": 2, "cols": 3}
    assert (m.n_rows, m.n_cols, m.size) == (2, 3, 6)
    assert m.devices == tuple(devices)
    # the JAX package's mesh of the same shape has the same axes and sizes
    j = jmake_mesh_2d((2, 3))
    assert dict(j.shape) == m.shape


def test_make_mesh_2d_takes_the_first_devices_and_never_wraps():
    assert mesh.make_mesh_2d((2, 2), devices=["cpu"] * 7).size == 4
    with pytest.raises(ValueError, match=r"mesh shape \(3, 3\) needs 9 devices, only 4"):
        mesh.make_mesh_2d((3, 3), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="two positive ints"):
        mesh.make_mesh_2d((0, 2), devices=["cpu"] * 4)


def test_make_mesh_2d_of_the_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = mesh.make_mesh_2d((2, 2))
    assert m.devices == tuple(torch.device("cuda", i) for i in range(4))
    with pytest.raises(ValueError, match="needs 8 devices, only 4"):
        mesh.make_mesh_2d((2, 4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mesh.make_mesh_2d((2, 2))


def test_a_mesh_must_fill_its_rows():
    with pytest.raises(ValueError, match="do not fill rows of 2 columns"):
        mesh.Mesh((torch.device("cpu"),) * 3, cols=2)
    assert mesh.make_mesh(devices=["cpu"] * 3).n_cols == 1


@pytest.mark.parametrize("extent,n,minimum,want", [(30, 4, 1, 8), (9, 4, 5, 5), (4, 4, 2, 2),
                                                    (100, 3, 5, 34), (1, 8, 1, 1)])
def test_shard_extent(extent, n, minimum, want):
    assert mesh.shard_extent(extent, n, minimum) == want


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (30, 70), (33, 129)])
@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (3, 1), (1, 4), (4, 3)])
@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_split_and_gather_blocks_round_trip(shape, grid, dtype):
    rng = np.random.default_rng(sum(shape) + sum(grid))
    b = rng.integers(-100, 100, size=shape).astype(dtype)
    block = (mesh.shard_extent(shape[0], grid[0]), mesh.shard_extent(shape[1], grid[1]))
    parts = mesh.split_blocks(b, grid, block)
    assert len(parts) == grid[0] * grid[1]
    assert all(p.shape == block and p.dtype == dtype for p in parts)
    np.testing.assert_array_equal(mesh.gather_blocks(parts, grid, shape), b)
    whole = mesh.gather_blocks(parts, grid, (grid[0] * block[0], grid[1] * block[1]))
    assert not whole[shape[0]:].any() and not whole[:, shape[1]:].any()  # padding is dead
    for s, p in enumerate(parts):  # row-major order
        i, j = divmod(s, grid[1])
        np.testing.assert_array_equal(p, whole[i * block[0]: (i + 1) * block[0],
                                               j * block[1]: (j + 1) * block[1]])


def test_split_blocks_refuses_blocks_that_miss_the_board():
    with pytest.raises(ValueError, match="do not cover"):
        mesh.split_blocks(np.zeros((10, 10), np.int8), (2, 2), (4, 5))


def test_split_rows_with_a_least_height():
    b = np.arange(9 * 3, dtype=np.int8).reshape(9, 3)
    parts = mesh.split_rows(b, 4, rows=mesh.shard_extent(9, 4, 5))  # bugs (r = 5) on 4 shards
    assert [p.shape for p in parts] == [(5, 3)] * 4
    np.testing.assert_array_equal(np.concatenate(parts)[:9], b)
    assert not np.concatenate(parts)[9:].any()
    shards = interop.shards_from_reference(b, (9, 3), 4, layout="cells")
    assert [tuple(s.shape) for s in shards] == [(3, 3)] * 4  # ceil(9 / 4) rows by default


def _padded_window(board, r0, r1, c0, c1, periodic):
    """Board cells [r0, r1) x [c0, c1): wrapped on a torus, zero past the
    board (the padded board's dead cells and the clamped edge) otherwise."""
    h, w = board.shape
    rows, cols = np.arange(r0, r1), np.arange(c0, c1)
    if periodic:
        return board[np.ix_(rows % h, cols % w)]
    out = np.zeros((r1 - r0, c1 - c0), board.dtype)
    ri, ci = (rows >= 0) & (rows < h), (cols >= 0) & (cols < w)
    out[np.ix_(ri, ci)] = board[np.ix_(rows[ri], cols[ci])]
    return out


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("grid", [(1, 2), (2, 2), (3, 2), (2, 4), (1, 1), (3, 1)])
@pytest.mark.parametrize("fr,fc", [(1, 1), (3, 2), (5, 5)])
def test_exchange_cols_fills_every_cell_and_corner(grid, fr, fc, periodic):
    r, c = grid
    hl, wl = 7, 6
    rng = np.random.default_rng(fr * 10 + fc + 100 * r + c)
    board = rng.integers(-(2**31), 2**31 - 1, size=(r * hl, c * wl)).astype(np.int32)
    if not periodic:  # dead padding rows and columns in the last shards
        board[-2:] = 0
        board[:, -3:] = 0
    chunks = [torch.from_numpy(p) for p in mesh.split_blocks(board, grid, (hl, wl))]
    halo.exchange_rows.copies = halo.exchange_cols.copies = 0
    tops, bots = halo.exchange_rows(chunks, fr, periodic=periodic, cols=c)
    lefts, rights = halo.exchange_cols(chunks, tops, bots, fc, cols=c, periodic=periodic)
    for s in range(r * c):
        i, j = divmod(s, c)
        ext = torch.cat([lefts[s], torch.cat([tops[s], chunks[s], bots[s]]), rights[s]], dim=1)
        want = _padded_window(board, i * hl - fr, (i + 1) * hl + fr, j * wl - fc, (j + 1) * wl + fc,
                              periodic)
        np.testing.assert_array_equal(ext.numpy(), want)
    row_copies = (2 * r * c if r > 1 else 0) if periodic else 2 * (r - 1) * c
    col_copies = 6 * r * c if periodic else 6 * r * (c - 1)
    assert (halo.exchange_rows.copies, halo.exchange_cols.copies) == (row_copies, col_copies)


def test_exchange_cols_reuses_buffers_and_keeps_the_clamped_ends_zero():
    chunks = [torch.full((4, 5), s + 1, dtype=torch.int8) for s in range(4)]
    rows = halo.halo_buffers(chunks, 2)
    cols = halo.col_buffers(chunks, 2, 3)
    for _ in range(2):
        tops, bots = halo.exchange_rows(chunks, 2, periodic=False, buffers=rows, cols=2)
        lefts, rights = halo.exchange_cols(chunks, tops, bots, 3, cols=2, periodic=False, buffers=cols)
        assert lefts is cols[0] and rights is cols[1]
        assert not lefts[0].any() and not lefts[2].any()  # the first mesh column's left edge
        assert not rights[1].any() and not rights[3].any()  # the last mesh column's right edge
    # shard 3 (bottom right): its left halo is shard 2's edge, whose top
    # halo came from shard 0: the corner rode the row exchange
    assert lefts[3].shape == (8, 3)
    assert (lefts[3][:2] == 1).all() and (lefts[3][2:6] == 3).all() and not lefts[3][6:].any()


def test_column_halo_wider_than_a_shard_raises():
    chunks = [torch.zeros((4, 2), dtype=torch.int8)] * 2
    tops, bots = halo.exchange_rows(chunks, 1, periodic=False, cols=2)
    with pytest.raises(ValueError, match="shard width 2"):
        halo.exchange_cols(chunks, tops, bots, 3, cols=2, periodic=False)


@pytest.mark.parametrize("packed,want", [(False, 12), (True, 1)])
def test_column_halo_width(packed, want):
    from tpu_life_torch.models.rules import get_rule

    rule = get_rule("R4,C2,S2..8,B3..5")
    assert halo.col_halo_width(rule, 3, packed) == want
    twin = halo.get_clamped_twin(get_rule("conway:T"))
    assert twin.boundary == "clamped" and twin.birth == get_rule("conway").birth
