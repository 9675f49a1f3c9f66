"""The port's row sharding on the CPU: the halo exchange (contents and
copy counts per block, the count that stands in for the JAX package's
collective census), the 1-D mesh, and the per-shard ops the exchange
feeds (masked steps at a shard's row and word offsets, the wrap-columns
step) against the JAX package's, bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.ops import bitlife as jbitlife
from tpu_life.ops import stencil as jstencil
from tpu_life_torch import interop
from tpu_life_torch.backends.base import get_backend
from tpu_life_torch.models.rules import NotPortedError, get_rule
from tpu_life_torch.ops import bitlife, stencil
from tpu_life_torch.ops.reference import run_np
from tpu_life_torch.parallel import halo, mesh


def _chunks(n, hl, w, seed, dtype=torch.int32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, size=(hl, w)).astype(np.int32)).to(dtype)
            for _ in range(n)]


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("fr", [1, 3, 7])
def test_exchange_rows_contents_and_copies(n, fr, periodic):
    chunks = _chunks(n, 7, 4, seed=n * 10 + fr)
    halo.exchange_rows.copies = 0
    tops, bots = halo.exchange_rows(chunks, fr, periodic=periodic)
    for i in range(n):
        if i > 0 or periodic:
            assert torch.equal(tops[i], chunks[i - 1][-fr:])
        else:
            assert not tops[i].any()  # the clamped first shard: the dead edge
        if i < n - 1 or periodic:
            assert torch.equal(bots[i], chunks[(i + 1) % n][:fr])
        else:
            assert not bots[i].any()  # the clamped last shard
        assert tops[i].shape == bots[i].shape == (fr, 4)
    want = (2 * n if n > 1 else 0) if periodic else 2 * (n - 1)
    assert halo.exchange_rows.copies == want


def test_exchange_reuses_buffers_and_keeps_the_clamped_ends_zero():
    chunks = _chunks(3, 5, 2, seed=1)
    buffers = halo.halo_buffers(chunks, 2)
    for _ in range(3):
        tops, bots = halo.exchange_rows(chunks, 2, periodic=False, buffers=buffers)
        assert tops is buffers[0] and bots is buffers[1]
        assert not tops[0].any() and not bots[-1].any()
        chunks = [c + 1 for c in chunks]
    assert torch.equal(tops[1], chunks[0][-2:] - 1)


def test_halo_deeper_than_a_shard_raises():
    with pytest.raises(ValueError, match="shard height"):
        halo.exchange_rows(_chunks(2, 3, 1, seed=2), 4, periodic=False)


def test_halo_depth_matches_jax():
    from tpu_life.parallel.halo import halo_depth as jhalo_depth

    for spec, k in (("conway", 8), ("bugs", 3), ("R2,C2,S2..4,B2..3,NN", 16)):
        assert halo.halo_depth(get_rule(spec), k) == jhalo_depth(jget_rule(spec), k)


@pytest.mark.parametrize(
    "spec,n,k,steps",
    [("conway", 4, 5, 20), ("conway:T", 4, 3, 7), ("conway:T", 1, 4, 9), ("brians_brain:T", 2, 2, 5)],
)
def test_copies_per_block_through_the_runner(spec, n, k, steps):
    # the census the JAX package takes of its collectives, as copies: each
    # block is one exchange, 2(n-1) copies clamped, 2n on a ring, none on
    # a one-shard ring
    rule = get_rule(spec)
    b = np.random.default_rng(3).integers(0, 2, size=(24, 40), dtype=np.int8)
    runner = get_backend("sharded", device="cpu", num_devices=n, block_steps=k).prepare(b, rule)
    halo.exchange_rows.copies = 0
    runner.advance(steps)
    blocks = -(-steps // k)
    per_block = (2 * n if n > 1 else 0) if rule.boundary == "torus" else 2 * (n - 1)
    assert halo.exchange_rows.copies == blocks * per_block
    np.testing.assert_array_equal(runner.fetch(), run_np(b, rule, steps))


def test_mesh_of_repeated_devices():
    m = mesh.make_mesh(devices=["cpu"] * 4)
    assert m.shape == {mesh.ROW_AXIS: 4} == {"rows": 4}
    assert m.devices == (torch.device("cpu"),) * 4
    assert mesh.make_mesh(2, devices=["cpu"] * 4).size == 2


def test_mesh_never_wraps_around(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.make_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.make_mesh(1).size == 1
    with pytest.raises(ValueError, match="requested 3 devices, only 2"):
        mesh.make_mesh(3)


def test_mesh_of_cards_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu --num-devices"):
        mesh.make_mesh()


@pytest.mark.parametrize(
    "call",
    [lambda: get_backend("sharded", device="cpu", mesh_shape=(2, 2), partition_mode="gspmd"),
     mesh.init_distributed],
)
def test_not_ported_mesh_entry_points_name_the_roadmap_item(call, monkeypatch):
    # gspmd stays refused and names its ROADMAP item (A6.2, with the
    # collective that settled it); init_distributed is ported (A6.3), and
    # with no job in the environment it is a no-op
    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    if call is mesh.init_distributed:
        assert call() is None and mesh.process_count() == 1
        return
    with pytest.raises(ValueError, match="ROADMAP A6") as e:
        call()
    assert not isinstance(e.value, NotPortedError) and "all_gather_into_tensor" in str(e.value)


def test_split_rows_pads_the_last_shard():
    b = np.arange(14, dtype=np.int8).reshape(7, 2)
    parts = mesh.split_rows(b, 3)
    assert [p.shape for p in parts] == [(3, 2)] * 3
    np.testing.assert_array_equal(np.concatenate(parts)[:7], b)
    assert not np.concatenate(parts)[7:].any()
    shards = interop.shards_from_reference(b, (7, 2), 3, layout="cells")
    assert all(torch.equal(s, torch.from_numpy(p)) for s, p in zip(shards, parts))


@pytest.mark.parametrize(
    "row_offset,word_offset", [(0, 0), (-3, 0), (5, 0), (17, 0), (-2, -1), (4, 1), (0, 2)]
)
@pytest.mark.parametrize("spec", ["conway", "R2,C2,S2..4,B2..3,NN"])
def test_masked_packed_step_offsets_match_jax(spec, row_offset, word_offset):
    # a shard's extended chunk: its row 0 above, inside or below the board,
    # its word 0 left of or inside it (JAX's signature, the guard for
    # negative rows and words included)
    logical = (20, 70)
    rng = np.random.default_rng(100 + row_offset * 7 + word_offset)
    words = rng.integers(0, 2**32, size=(12, 3), dtype=np.uint32)
    got = bitlife.make_masked_packed_step(get_rule(spec), logical)(
        torch.from_numpy(words.view(np.int32)), row_offset, word_offset)
    want = jbitlife.make_masked_packed_step(jget_rule(spec), logical)(
        jnp.asarray(words), row_offset, word_offset)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("row_offset", [-4, 0, 9])
@pytest.mark.parametrize("spec", ["brians_brain", "bugs", "R3,C2,S6..10,B6..8,NN"])
def test_masked_step_row_offset_matches_jax(spec, row_offset):
    rule = get_rule(spec)
    rng = np.random.default_rng(row_offset + 50)
    b = (rng.integers(0, rule.states, size=(16, 23)) * rng.integers(0, 2, size=(16, 23))).astype(np.int8)
    got = stencil.make_masked_step(rule, (14, 21))(torch.from_numpy(b), row_offset)
    want = jstencil.make_masked_step(jget_rule(spec), (14, 21))(jnp.asarray(b), row_offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("spec", ["brians_brain:T", "R2,C2,S2..4,B2..3,NN:T", "bugs:T", "conway:T"])
def test_wrap_cols_step_matches_jax(spec):
    rule = get_rule(spec)
    rng = np.random.default_rng(len(spec))
    b = (rng.integers(0, rule.states, size=(19, 25)) * rng.integers(0, 2, size=(19, 25))).astype(np.int8)
    got = stencil.make_wrap_cols_step(rule)(torch.from_numpy(b))
    want = jstencil.make_wrap_cols_step(jget_rule(spec))(jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("spec", ["conway", "highlife", "R2,C2,S2..4,B2..3,NN"])
def test_shard_block_equals_the_whole_board_step(spec, packed):
    # one block of one shard == the same steps of the whole board, on the
    # shard's rows (the halos carry what the shard needs)
    rule = get_rule(spec)
    b = np.random.default_rng(9).integers(0, 2, size=(30, 45), dtype=np.int8)
    k, hl, i = 3, 10, 1
    fr = halo.halo_depth(rule, k)
    x = interop.board_from_reference(b, b.shape, layout="words" if packed else "cells")
    zero = torch.zeros((fr, x.shape[1]), dtype=x.dtype)
    ext = torch.cat([zero, x, zero])
    top, chunk, bot = ext[i * hl: i * hl + fr], x[i * hl: (i + 1) * hl], ext[(i + 1) * hl + fr: (i + 1) * hl + 2 * fr]
    out = halo.make_shard_block(rule, b.shape, k, packed=packed)(top, chunk, bot, i * hl - fr)
    whole = run_np(b, rule, k)[i * hl: (i + 1) * hl]
    got = interop.board_to_reference(out, (hl, 45)) if packed else out.numpy()
    np.testing.assert_array_equal(got, whole)
