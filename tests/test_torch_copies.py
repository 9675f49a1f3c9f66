"""The port's copies of JAX-package modules equal their originals:
rule parsing and registry, SOP synthesis, the byte codec, pack/unpack and
the numpy oracle.  Inputs come from ``np.random.default_rng``; every
comparison is exact."""

import dataclasses
import inspect

import numpy as np
import pytest

from tpu_life.io import codec as jcodec
from tpu_life.models import rules as jrules
from tpu_life.ops import bitlife as jbitlife
from tpu_life.ops import boolmin as jboolmin
from tpu_life.ops import common as jcommon
from tpu_life.ops import reference as jref
from tpu_life_torch import interop
from tpu_life_torch.io import codec
from tpu_life_torch.models import rules
from tpu_life_torch.ops import bitlife, boolmin, common, reference

NOT_PORTED = {"ising", "lenia"}
FIELDS = [f.name for f in dataclasses.fields(rules.Rule)]


def _fields(rule):
    return {f: getattr(rule, f) for f in FIELDS}


def test_registry_holds_every_deterministic_rule():
    assert set(rules.RULE_REGISTRY) == set(jrules.RULE_REGISTRY) - NOT_PORTED


@pytest.mark.parametrize("name", sorted(set(jrules.RULE_REGISTRY) - NOT_PORTED))
def test_registry_rule_fields_and_tables(name):
    want = jrules.RULE_REGISTRY[name]
    got = rules.parse_rule(name)
    assert _fields(got) == _fields(want)
    np.testing.assert_array_equal(got.transition_table, want.transition_table)
    assert interop.rule_from_fields(**_fields(want)) == got


SPECS = [
    "B3/S23", "b36/s23", "B2/S/C3", "23/3", "345/2/4", "B/S2",
    "R5,C2,S34..58,B34..45", "R2,C3,M1,S8..12,B7..8", "R2,C2,S2..4,B3,NN",
    "R1,C0,S2..3,B3", "conway:T", "B36/S23:T", "R2,C2,S1,B1,NN:t",
    "Day-and-Night", " highlife ",
]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parses_alike(spec):
    want, got = jrules.parse_rule(spec), rules.parse_rule(spec)
    assert _fields(got) == _fields(want)
    np.testing.assert_array_equal(got.transition_table, want.transition_table)


@pytest.mark.parametrize(
    "spec", ["B3/Sx", "R2,C2,S1,B1,5", "conway:T5x5", "R2,C2,S1,B1,NX", "R0,C2,S1,B1", "B9/S"]
)
def test_bad_spec_fails_alike(spec):
    with pytest.raises(ValueError):
        jrules.parse_rule(spec)
    with pytest.raises(ValueError):
        rules.parse_rule(spec)


@pytest.mark.parametrize("spec", ["ising", "ising:T", "noisy:0.01/conway", "lenia", "lenia:orbium"])
def test_unported_tiers_raise_typed_error(spec):
    with pytest.raises(rules.NotPortedError, match="not yet ported"):
        rules.parse_rule(spec)


def test_geometry_check_alike():
    bugs = rules.parse_rule("bugs")
    with pytest.raises(rules.GeometryError):
        rules.validate_rule_geometry(bugs, (10, 40))
    with pytest.raises(jrules.GeometryError):
        jrules.validate_rule_geometry(jrules.parse_rule("bugs"), (10, 40))
    rules.validate_rule_geometry(bugs, (11, 11))
    rules.validate_rule_geometry(rules.parse_rule("conway"), (1, 1))


# radius-1 rules: their counts fit the 4 total planes of the packed paths
@pytest.mark.parametrize(
    "name", sorted(k for k, r in rules.RULE_REGISTRY.items() if r.max_count <= 15)
)
def test_rule_sop_copy(name):
    r = rules.RULE_REGISTRY[name]
    assert boolmin.rule_sop(r.birth, r.survive) == jboolmin.rule_sop(r.birth, r.survive)
    assert boolmin.membership_rule_sop(
        r.birth, r.survive, r.max_count
    ) == jboolmin.membership_rule_sop(r.birth, r.survive, r.max_count)


@pytest.mark.parametrize("spec", ["R1,C2,S1,B1,NN", "R2,C2,S2..4,B3,NN", "R2,C2,M1,S1..6,B2,NN"])
def test_membership_sop_copy_diamonds(spec):
    r = rules.parse_rule(spec)
    assert boolmin.membership_rule_sop(
        r.birth, r.survive, r.max_count
    ) == jboolmin.membership_rule_sop(r.birth, r.survive, r.max_count)


@pytest.mark.parametrize("shape,states", [((1, 1), 2), ((7, 33), 2), ((20, 64), 10), ((3, 100), 4)])
def test_codec_bytes_both_ways(shape, states):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    board = rng.integers(0, states, size=shape, dtype=np.int8)
    raw = codec.encode_board(board)
    assert raw == jcodec.encode_board(board)
    np.testing.assert_array_equal(jcodec.decode_board(raw, *shape), board)
    np.testing.assert_array_equal(codec.decode_board(jcodec.encode_board(board), *shape), board)


@pytest.mark.parametrize(
    "raw,match",
    [(b"01\n10", "byte length"), (b"01x10\n", "not terminated"), (b"0a\n10\n", "outside")],
)
def test_codec_rejects_alike(raw, match):
    with pytest.raises(ValueError, match=match):
        codec.decode_board(raw, 2, 2)
    with pytest.raises(ValueError, match=match):
        jcodec.decode_board(raw, 2, 2)


def test_config_round_trip(tmp_path):
    codec.write_config(tmp_path / "a.txt", 1500, 500, 100)
    jcodec.write_config(tmp_path / "b.txt", 1500, 500, 100)
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()
    assert codec.read_config(tmp_path / "b.txt") == (1500, 500, 100)
    (tmp_path / "bad.txt").write_text("3 4")
    with pytest.raises(ValueError):
        codec.read_config(tmp_path / "bad.txt")


@pytest.mark.parametrize("w", [1, 31, 32, 33, 64, 100])
def test_pack_unpack_copy(w):
    rng = np.random.default_rng(w)
    board = rng.integers(0, 3, size=(9, w), dtype=np.int8)  # state 2 packs dead
    packed = bitlife.pack_np(board)
    np.testing.assert_array_equal(packed, jbitlife.pack_np(board))
    np.testing.assert_array_equal(bitlife.unpack_np(packed, w), jbitlife.unpack_np(packed, w))
    np.testing.assert_array_equal(bitlife.unpack_np(packed, w), (board == 1).astype(np.int8))


@pytest.mark.parametrize(
    "spec,shape,steps",
    [
        ("conway", (30, 41), 6),
        ("day_and_night", (17, 64), 5),
        ("brians_brain", (25, 30), 6),  # Generations
        ("star_wars", (12, 19), 4),
        ("R2,C2,S3..5,B3..4", (20, 22), 4),  # Larger-than-Life
        ("R2,C2,S2..4,B3,NN", (16, 18), 4),  # von Neumann diamond
        ("highlife:T", (15, 37), 5),  # torus
        ("bugs", (24, 24), 2),
    ],
)
def test_run_np_copy(spec, shape, steps):
    rng = np.random.default_rng(sum(shape))
    jr, r = jrules.parse_rule(spec), rules.parse_rule(spec)
    board = (
        rng.integers(0, r.states, size=shape, dtype=np.int8)
        * rng.integers(0, 2, size=shape, dtype=np.int8)
    )
    np.testing.assert_array_equal(reference.run_np(board, r, steps), jref.run_np(board, jr, steps))


def test_common_is_a_verbatim_copy():
    assert inspect.getsource(common) == inspect.getsource(jcommon)


@pytest.mark.parametrize("seed", range(6))
def test_contiguous_ranges_copy(seed):
    rng = np.random.default_rng(seed)
    values = {int(v) for v in rng.integers(0, 60, size=int(rng.integers(0, 25)))}
    assert common.contiguous_ranges(values) == jcommon.contiguous_ranges(values)
    assert common.contiguous_ranges(frozenset()) == []


# -- the seeded-board, RLE and pattern copies -----------------------------------


@pytest.mark.parametrize("name", ["parse_rle", "emit_rle"])
def test_rle_is_a_verbatim_copy(name):
    from tpu_life.io import rle as jrle
    from tpu_life_torch.io import rle

    assert inspect.getsource(getattr(rle, name)) == inspect.getsource(getattr(jrle, name))


@pytest.mark.parametrize("name", ["place", "empty", "random_board", "_p"])
def test_patterns_functions_are_verbatim_copies(name):
    from tpu_life.models import patterns as jpatterns
    from tpu_life_torch.models import patterns

    assert inspect.getsource(getattr(patterns, name)) == inspect.getsource(getattr(jpatterns, name))


@pytest.mark.parametrize("shape,states,seed", [((1, 1), 2, 0), ((31, 33), 2, 7), ((40, 20), 3, 1), ((9, 70), 10, 5)])
def test_random_board_copy(shape, states, seed):
    from tpu_life.models import patterns as jpatterns
    from tpu_life_torch.models import patterns

    np.testing.assert_array_equal(
        patterns.random_board(*shape, 0.4, states=states, seed=seed),
        jpatterns.random_board(*shape, 0.4, states=states, seed=seed),
    )


@pytest.mark.parametrize("shape,states,seed", [((1, 1), 2, 0), ((31, 33), 2, 7), ((40, 20), 3, -1), ((9, 70), 10, 2**40)])
def test_prng_seeded_board_copy(shape, states, seed):
    from tpu_life.mc import prng as jprng
    from tpu_life_torch.mc import prng

    np.testing.assert_array_equal(
        prng.seeded_board(*shape, 0.45, states=states, seed=seed),
        jprng.seeded_board(*shape, 0.45, states=states, seed=seed),
    )


def test_prng_constants_copy():
    from tpu_life.mc import prng as jprng
    from tpu_life_torch.mc import prng

    names = ["SUB_EVEN", "SUB_ODD", "SUB_NOISE", "SUB_BOARD", "NSUB", "MAX_NARROW_CELLS",
             "WIDE_KEY_TAG", "_ROT_A", "_ROT_B"]
    assert {n: getattr(prng, n) for n in names} == {n: getattr(jprng, n) for n in names}
