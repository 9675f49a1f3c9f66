"""The port's copies of JAX-package modules equal their originals:
rule parsing and registry, SOP synthesis, the byte codec, pack/unpack and
the numpy oracle.  Inputs come from ``np.random.default_rng``; every
comparison is exact."""

import dataclasses
import inspect

import numpy as np
import pytest

from tpu_life import mc as jmc
from tpu_life.io import codec as jcodec
from tpu_life.mc import ising as jising
from tpu_life.mc import packed as jpacked
from tpu_life.models import rules as jrules
from tpu_life.ops import bitlife as jbitlife
from tpu_life.ops import boolmin as jboolmin
from tpu_life.ops import common as jcommon
from tpu_life.ops import reference as jref
from tpu_life_torch import interop, mc
from tpu_life_torch.io import codec
from tpu_life_torch.mc import ising, packed
from tpu_life_torch.models import rules
from tpu_life_torch.ops import bitlife, boolmin, common, reference

FIELDS = [f.name for f in dataclasses.fields(rules.Rule)]


def _fields(rule):
    return {f: getattr(rule, f) for f in FIELDS}


def test_registry_holds_every_deterministic_rule():
    # every rule of the JAX registry, the stochastic ``ising`` included
    assert set(rules.RULE_REGISTRY) == set(jrules.RULE_REGISTRY)


@pytest.mark.parametrize("name", sorted(jrules.RULE_REGISTRY))
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


@pytest.mark.parametrize("spec", ["ising", "ising:T", "noisy:0.01/conway", "noisy:0.05/B36/S23:T", "Ising"])
def test_unported_tiers_raise_typed_error(spec):
    # the stochastic tier, once refused here as not yet ported, parses as
    # the JAX package parses it: the same class, fields and flip probability
    want, got = jrules.parse_rule(spec), rules.parse_rule(spec)
    assert type(got).__name__ == type(want).__name__ and got.stochastic
    assert _fields(got) == _fields(want)
    assert getattr(got, "flip_p", None) == getattr(want, "flip_p", None)
    assert interop.rule_from_fields(**_fields(want)) == got


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


# -- the run driver's instruments: obs, metrics, checkpoint, recovery, tuned ----


def _source(obj) -> str:
    return inspect.getsource(obj)


REGISTRY_NAMES = ["Counter", "Gauge", "Histogram", "Family", "MetricsRegistry", "_fmt", "_escape",
                  "_prom_labels"]


@pytest.mark.parametrize("name", REGISTRY_NAMES)
def test_registry_is_a_verbatim_copy(name):
    from tpu_life.obs import registry as jregistry
    from tpu_life_torch.obs import registry

    assert _source(getattr(registry, name)) == _source(getattr(jregistry, name))


def test_registry_constants_and_exports_copy():
    from tpu_life.obs import registry as jregistry
    from tpu_life_torch.obs import registry

    for name in ("DEFAULT_BUCKETS", "MAX_SERIES", "OVERFLOW"):
        assert getattr(registry, name) == getattr(jregistry, name)


@pytest.mark.parametrize("seed", range(4))
def test_registry_outputs_equal_on_seeded_observations(seed):
    from tpu_life.obs import registry as jregistry
    from tpu_life_torch.obs import registry

    rng = np.random.default_rng(seed)
    values = rng.exponential(0.05, size=int(rng.integers(1, 200)))
    labels = [str(v) for v in rng.integers(0, 80, size=len(values))]  # past the series cap
    out = []
    for mod in (registry, jregistry):
        reg = mod.MetricsRegistry()
        h = reg.histogram("wait_seconds", "help", labels=("rule",))
        c = reg.counter("jobs_total", 'a "quoted" help')
        g = reg.gauge("depth")
        for v, lab in zip(values, labels):
            h.labels(rule=lab).observe(v)
            c.inc(v)
            g.set(v)
        out.append((reg.snapshot(run_id="r"), reg.prom_text(),
                    [h.labels(rule=labels[0]).quantile(q) for q in (0.0, 0.3, 0.5, 0.99, 1.0)]))
    assert out[0] == out[1]


TRACER_METHODS = ["__init__", "now", "_ts", "_emit", "span", "complete", "instant", "write"]
TRACE_FUNCTIONS = ["new_run_id", "ensure_parent", "span_count", "reset_span_count", "active_tracer",
                   "start_tracing", "stop_tracing", "span", "complete", "instant", "now"]


@pytest.mark.parametrize("name", TRACER_METHODS)
def test_tracer_methods_are_verbatim_copies(name):
    from tpu_life.obs import trace as jtrace
    from tpu_life_torch.obs import trace

    assert _source(getattr(trace.Tracer, name)) == _source(getattr(jtrace.Tracer, name))


@pytest.mark.parametrize("name", TRACE_FUNCTIONS)
def test_trace_functions_are_verbatim_copies(name):
    from tpu_life.obs import trace as jtrace
    from tpu_life_torch.obs import trace

    assert _source(getattr(trace, name)) == _source(getattr(jtrace, name))


def test_trace_schema_copy():
    from tpu_life.obs import trace as jtrace
    from tpu_life_torch.obs import trace

    assert trace.TELEMETRY_SCHEMA == jtrace.TELEMETRY_SCHEMA
    assert trace.DEFAULT_MAX_EVENTS == jtrace.DEFAULT_MAX_EVENTS


def test_trace_files_equal_on_the_same_calls(tmp_path):
    # the same emitter calls write the same document, clocks and ids aside
    import json

    from tpu_life.obs import trace as jtrace
    from tpu_life_torch.obs import trace

    docs = []
    for name, mod in (("port", trace), ("jax", jtrace)):
        t = mod.Tracer(str(tmp_path / name / "t.json"), run_id="abc123abc123", max_events=5)
        with t.span("outer", phase="demo"):
            with t.span("inner"):
                t.instant("marker", note=1)
            t.complete("chunk", 0.001, 0.002, step=4)
        doc = json.loads(open(t.write()).read())
        for e in doc["traceEvents"]:
            e.pop("ts"), e.pop("tid"), e.pop("pid")
        docs.append((doc["traceEvents"], doc["otherData"]["run_id"], doc["otherData"]["dropped"]))
    assert docs[0] == docs[1] and docs[0][2] == 1  # six events through a ring of five


@pytest.mark.parametrize("name", ["MetricsRecorder", "configure_logging", "dump_board"])
def test_metrics_is_a_verbatim_copy(name):
    from tpu_life.runtime import metrics as jmetrics
    from tpu_life_torch.runtime import metrics

    assert _source(getattr(metrics, name)) == _source(getattr(jmetrics, name))


@pytest.mark.parametrize("shape", [(1, 1), (5, 64), (64, 64), (65, 3)])
def test_dump_board_copy(shape):
    from tpu_life.runtime import metrics as jmetrics
    from tpu_life_torch.runtime import metrics

    board = np.random.default_rng(sum(shape)).integers(0, 4, size=shape, dtype=np.int8)
    assert metrics.dump_board(board) == jmetrics.dump_board(board)


CHECKPOINT_NAMES = ["atomic_publish", "snapshot_path", "crc_path", "write_crc_sidecar", "write_sidecar",
                    "save_snapshot", "list_snapshots", "latest_snapshot", "snapshot_intact",
                    "prune_snapshots", "resolve_resume", "load_resume"]


@pytest.mark.parametrize("name", CHECKPOINT_NAMES)
def test_checkpoint_is_a_verbatim_copy(name):
    from tpu_life.runtime import checkpoint as jckpt
    from tpu_life_torch.runtime import checkpoint as ckpt

    assert _source(getattr(ckpt, name)) == _source(getattr(jckpt, name))
    assert ckpt._SNAP_RE.pattern == jckpt._SNAP_RE.pattern


@pytest.mark.parametrize("shape,states", [((1, 1), 2), ((9, 70), 3), ((40, 20), 10)])
def test_checkpoint_round_trip_across_packages(tmp_path, shape, states):
    from tpu_life.runtime import checkpoint as jckpt
    from tpu_life_torch.runtime import checkpoint as ckpt

    board = np.random.default_rng(states).integers(0, states, size=shape, dtype=np.int8)
    ckpt.save_snapshot(tmp_path / "p", 17, board, rule="r")
    jckpt.save_snapshot(tmp_path / "j", 17, board, rule="r")
    for f in ("board_000000017.txt", "board_000000017.json", "board_000000017.crc"):
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
    for loader, d in ((ckpt.load_resume, "j"), (jckpt.load_resume, "p")):
        got, step = loader(tmp_path / d, *shape)
        assert step == 17
        np.testing.assert_array_equal(got, board)


def test_recovery_copy():
    from tpu_life.runtime import recovery as jrecovery
    from tpu_life_torch.runtime import recovery

    assert _source(recovery.FaultingRunner) == _source(jrecovery.FaultingRunner)
    assert recovery._OOM_MARKERS == jrecovery._OOM_MARKERS
    for msg in ("RESOURCE_EXHAUSTED: x", "CUDA out of memory.", "device lost", ""):
        assert recovery.is_oom(RuntimeError(msg)) == jrecovery.is_oom(RuntimeError(msg))


def test_tuned_record_copy():
    from tpu_life.autotune import space as jspace
    from tpu_life_torch.autotune import space

    assert _source(space.tuned_record) == _source(jspace.tuned_record)
    assert [(f.name, f.default) for f in dataclasses.fields(space.TunedConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jspace.TunedConfig)]
    assert space.TunedConfig("cuda", 4).to_dict() == jspace.TunedConfig("cuda", 4).to_dict()


@pytest.mark.parametrize(
    "module,names",
    [
        ("obs.trace", TRACE_FUNCTIONS),
        ("runtime.checkpoint", CHECKPOINT_NAMES),
        ("runtime.metrics", ["configure_logging", "dump_board", "MetricsRecorder"]),
        ("runtime.recovery", ["is_oom", "unwrap", "FaultingRunner"]),
        ("runtime.profiling", ["maybe_profile"]),
        ("utils.timing", ["delta_seconds_per_step", "paired_delta_seconds_per_step"]),
        ("backends.base", ["measure_throughput", "measure_parity_interleaved"]),
        ("autotune.space", ["tuned_record", "TunedConfig"]),
    ],
)
def test_public_signatures_equal(module, names):
    import importlib

    port = importlib.import_module(f"tpu_life_torch.{module}")
    jax = importlib.import_module(f"tpu_life.{module}")
    for name in names:
        assert inspect.signature(getattr(port, name)) == inspect.signature(getattr(jax, name)), name


def test_run_config_has_the_jax_instrument_fields_and_defaults():
    from tpu_life.config import RunConfig as JRunConfig
    from tpu_life_torch.config import RunConfig

    names = ["snapshot_every", "snapshot_dir", "keep_snapshots", "resume", "max_restarts", "fault_at",
             "fault_count", "restart_wait_s", "profile", "trace_events", "verbose", "metrics",
             "metrics_file"]
    port, jax = RunConfig(), JRunConfig()
    assert {n: getattr(port, n) for n in names} == {n: getattr(jax, n) for n in names}


# -- the banded-matmul and continuous-tier copies ---------------------------------

CONV_NAMES = ["validate_stencil", "rule_kernel", "kernel_factors", "band_matrix", "band_operators"]


@pytest.mark.parametrize("name", CONV_NAMES)
def test_conv_is_a_verbatim_copy(name):
    from tpu_life.ops import conv as jconv
    from tpu_life_torch.ops import conv

    assert _source(getattr(conv, name)) == _source(getattr(jconv, name))


def test_conv_constants_copy():
    from tpu_life.ops import conv as jconv
    from tpu_life_torch.ops import conv

    for name in ("STENCIL_MODES", "_SVD_RTOL"):
        assert getattr(conv, name) == getattr(jconv, name)
    # the crossover reads the same variable, but is unset by default on the
    # port (ops.conv.CROSSOVER_RADIUS), where JAX's defaults to 4
    if conv.CROSSOVER_RADIUS is not None:
        assert conv.CROSSOVER_RADIUS == jconv.CROSSOVER_RADIUS


@pytest.mark.parametrize("name", ["LeniaRule", "parse_lenia", "validate_board"])
def test_lenia_is_a_verbatim_copy(name):
    from tpu_life.models import lenia as jlenia
    from tpu_life_torch.models import lenia

    assert _source(getattr(lenia, name)) == _source(getattr(jlenia, name))


def test_lenia_constants_copy():
    from tpu_life.models import lenia as jlenia
    from tpu_life_torch.models import lenia

    assert lenia.PRESETS == jlenia.PRESETS
    assert lenia._FIELD_RE.pattern == jlenia._FIELD_RE.pattern
    assert lenia.FLOAT_ATOL == jlenia.FLOAT_ATOL
    for preset in lenia.PRESETS:
        spec = f"lenia:{preset}"
        assert rules.parse_rule(spec).kernel.tobytes() == jrules.parse_rule(spec).kernel.tobytes()


@pytest.mark.parametrize("shape,density,seed", [((1, 1), 0.5, 0), ((31, 33), 0.45, 7), ((9, 70), 0.0, 2**40)])
def test_lenia_seeded_board_copy(shape, density, seed):
    from tpu_life.models import lenia as jlenia
    from tpu_life_torch.models import lenia

    assert lenia.seeded_board(*shape, density, seed=seed).tobytes() == jlenia.seeded_board(
        *shape, density, seed=seed).tobytes()


@pytest.mark.parametrize("stencil", ["roll", "matmul"])
@pytest.mark.parametrize("spec,shape,steps", [("lenia:mini", (24, 24), 3), ("lenia:orbium", (30, 28), 2),
                                              ("lenia:R3,m0.12,s0.05,b1;0.5", (17, 19), 4)])
def test_lenia_step_np_run_np_copy(spec, shape, steps, stencil):
    from tpu_life.models import lenia as jlenia
    from tpu_life_torch.models import lenia

    board = lenia.seeded_board(*shape, seed=sum(shape))
    r, jr = rules.parse_rule(spec), jrules.parse_rule(spec)
    assert lenia.step_np(board, r, stencil).tobytes() == jlenia.step_np(board, jr, stencil).tobytes()
    assert lenia.run_np(board, r, steps, stencil).tobytes() == jlenia.run_np(board, jr, steps, stencil).tobytes()
    # the oracle's own entry point routes the continuous tier alike
    assert reference.run_np(board, r, steps, stencil).tobytes() == jref.run_np(
        board, jr, steps, stencil).tobytes()


@pytest.mark.parametrize("spec", ["conway", "brians_brain:T", "bugs", "R2,C2,M1,S1..6,B2,NN"])
def test_run_np_matmul_copy(spec):
    rng = np.random.default_rng(len(spec))
    r, jr = rules.parse_rule(spec), jrules.parse_rule(spec)
    board = rng.integers(0, r.states, size=(23, 26), dtype=np.int8)
    np.testing.assert_array_equal(reference.run_np(board, r, 4, "matmul"), jref.run_np(board, jr, 4, "matmul"))


@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (11, 7)])
def test_float_codec_copy(shape):
    board = np.random.default_rng(shape[0]).random(shape).astype(np.float32)
    raw = codec.encode_board(board)
    assert raw == jcodec.encode_board(board) and len(raw) == 4 * shape[0] * shape[1]
    assert codec.decode_board(raw, *shape).tobytes() == jcodec.decode_board(raw, *shape).tobytes()


# -- the per-shard board I/O: io.sharded, minus the native fast paths ------------

IO_SHARDED = ["stripe_bounds", "read_stripe", "read_block", "write_block", "write_stripe"]


def _without_native(fn) -> str:
    """``fn``'s syntax tree without its docstring and without the JAX
    module's native fast paths (``nat = codec._native()``, the ``if nat``
    branches and the import of ``codec`` that serves them)."""
    import ast
    import textwrap

    def native(node) -> bool:
        return any(isinstance(n, ast.Name) and n.id == "nat" for n in ast.walk(node))

    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    func = tree.body[0]
    body = func.body[1:] if isinstance(func.body[0], ast.Expr) else func.body
    func.body = [
        n for n in body
        if not (isinstance(n, (ast.Assign, ast.If)) and native(n))
        and not (isinstance(n, ast.ImportFrom) and n.module in ("tpu_life.io", "tpu_life_torch.io"))
    ]
    return ast.dump(tree)


@pytest.mark.parametrize("name", IO_SHARDED)
def test_io_sharded_is_a_copy_without_the_native_paths(name):
    from tpu_life.io import sharded as jsharded
    from tpu_life_torch.io import sharded

    assert _without_native(getattr(sharded, name)) == _without_native(getattr(jsharded, name))


@pytest.mark.parametrize("name", IO_SHARDED)
def test_io_sharded_native_paths_are_the_jax_modules(name):
    # with the native codec ported, the whole function is the JAX one: its
    # native branches included, the package's name aside
    import ast
    import textwrap

    from tpu_life.io import sharded as jsharded
    from tpu_life_torch.io import sharded

    def dump(fn) -> str:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        func = tree.body[0]
        if isinstance(func.body[0], ast.Expr):
            func.body = func.body[1:]
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "tpu_life_torch.io":
                node.module = "tpu_life.io"
        return ast.dump(tree)

    assert dump(getattr(sharded, name)) == dump(getattr(jsharded, name))


@pytest.mark.parametrize("seed", range(3))
def test_io_sharded_bytes_and_errors_equal_jax(tmp_path, monkeypatch, seed):
    # the same blocks read and the same files written, block by block in a
    # random order, and the same errors: the JAX module on its Python path
    from tpu_life.io import codec as jcodec_mod
    from tpu_life.io import sharded as jsharded
    from tpu_life_torch.io import sharded

    monkeypatch.setattr(jcodec_mod, "_native", lambda: None)
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(5, 40)), int(rng.integers(5, 70))
    board = rng.integers(0, 10, (h, w)).astype(np.int8)
    codec.write_board(tmp_path / "b.txt", board)
    assert sharded.stripe_bounds(h, 4) == jsharded.stripe_bounds(h, 4)
    for _ in range(10):
        r0, c0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        nr, nc = int(rng.integers(1, h - r0 + 1)), int(rng.integers(1, w - c0 + 1))
        got = sharded.read_block(tmp_path / "b.txt", r0, nr, c0, nc, w)
        np.testing.assert_array_equal(got, jsharded.read_block(tmp_path / "b.txt", r0, nr, c0, nc, w))
        np.testing.assert_array_equal(got, board[r0:r0 + nr, c0:c0 + nc])
    rows = sharded.stripe_bounds(h, 3)
    cols = [(0, w // 3), (w // 3, w)]
    order = rng.permutation(len(rows) * len(cols))
    for mod, out in ((sharded, "p.txt"), (jsharded, "j.txt")):
        for k in order:
            (r0, r1), (c0, c1) = rows[k // 2], cols[k % 2]
            mod.write_block(tmp_path / out, r0, c0, board[r0:r1, c0:c1], total_rows=h, total_cols=w)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes() == codec.encode_board(board)
    for call in (lambda m: m.read_block(tmp_path / "b.txt", h - 1, 2, 0, 3, w),
                 lambda m: m.read_block(tmp_path / "b.txt", 0, 2, w - 1, 3, w),
                 lambda m: m.write_block(tmp_path / "x.txt", h - 1, 0, board[:2, :3], total_rows=h,
                                         total_cols=w),
                 lambda m: m.write_block(tmp_path / "x.txt", 0, w - 1, board[:2, :3], total_rows=h,
                                         total_cols=w),
                 lambda m: m.write_stripe(tmp_path / "x.txt", -1, board[:2], total_rows=h),
                 lambda m: m.stripe_bounds(h, 0)):
        errors = []
        for mod in (sharded, jsharded):
            with pytest.raises(ValueError) as e:
                call(mod)
            errors.append(str(e.value))
        assert errors[0] == errors[1]


# -- the stochastic tier's copies (tpu_life/mc) ---------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.1, 1.0, 2.27, 10.0, 1e12])
def test_acceptance_thresholds_copy(temperature):
    got, want = ising.acceptance_thresholds(temperature), jising.acceptance_thresholds(temperature)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 1), (3, 31), (4, 32), (5, 33), (7, 100), (2, 64)])
def test_pack_unpack_column_mask_and_live_count_copies(shape):
    board = np.random.default_rng(shape[1]).integers(0, 2, size=shape, dtype=np.int8)
    x = packed.pack_board(board)
    np.testing.assert_array_equal(x, jpacked.pack_board(board))
    np.testing.assert_array_equal(x, jbitlife.pack_np(board))  # the shared layout
    np.testing.assert_array_equal(packed.unpack_board(x, shape[1]), jpacked.unpack_board(x, shape[1]))
    np.testing.assert_array_equal(packed.column_mask(shape[1]), jpacked.column_mask(shape[1]))
    assert packed.live_count(x) == jpacked.live_count(x) == int(board.sum())
    assert packed.packed_width(shape[1]) == jpacked.packed_width(shape[1])


@pytest.mark.parametrize("origin", [0, 2**32 - 50, 2**33])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("shape", [(4, 30), (6, 64), (8, 66)])
def test_parity_draw_coords_and_hshifts_copies(shape, parity, origin):
    h, w = shape
    got, want = packed._parity_draw_coords(h, w, parity, origin), jpacked._parity_draw_coords(
        h, w, parity, origin)
    for g, wnt in zip(got, want):
        if wnt is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, wnt)
    x = packed.pack_board(np.random.default_rng(w).integers(0, 2, size=shape, dtype=np.int8))
    for g, wnt in zip(packed._make_torus_hshifts(np, w), jpacked._make_torus_hshifts(np, w)):
        np.testing.assert_array_equal(g(x), wnt(x))
    bits = np.random.default_rng(h).integers(0, 2, size=(h, packed.packed_width(w) * 16)).astype(bool)
    row_off = ((np.arange(h) + parity) & 1).astype(np.uint32)
    np.testing.assert_array_equal(
        packed._spread_to_lanes(np, bits, h, packed.packed_width(w), row_off),
        jpacked._spread_to_lanes(np, bits, h, packed.packed_width(w), row_off))


def _refusal(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize(
    "spec,temperature", [("ising", None), ("ising", -2.0), ("ising", float("nan")),
                         ("conway", 1.0), ("noisy:0.1/conway", 0.5)])
def test_validate_params_messages_copy(spec, temperature):
    assert _refusal(lambda: mc.validate_params(rules.parse_rule(spec), temperature)) == _refusal(
        lambda: jmc.validate_params(jrules.parse_rule(spec), temperature))


@pytest.mark.parametrize("shape,wide", [((9, 8), False), ((8, 9), True), ((2**16, 2**16 + 2), False)])
def test_validate_board_shape_messages_copy(shape, wide):
    assert _refusal(lambda: mc.validate_board_shape(rules.parse_rule("ising"), shape,
                                                    wide_counter=wide)) == _refusal(
        lambda: jmc.validate_board_shape(jrules.parse_rule("ising"), shape, wide_counter=wide))
    # deterministic rules pass any shape; noisy rules any parity
    mc.validate_board_shape(rules.parse_rule("conway"), (9, 9))
    mc.validate_board_shape(rules.parse_rule("noisy:0.1/conway"), (9, 9))


def test_key_schedule_refusal_names_the_backend_as_jax_does():
    got = _refusal(lambda: mc.require_key_schedule(rules.parse_rule("ising"), "sharded"))
    want = _refusal(lambda: jmc.require_key_schedule(jrules.parse_rule("ising"), "sharded"))
    # the supported executors differ by name (cuda, torch, numpy against
    # jax, numpy); the rest of the message is the JAX package's
    tail = "(the counter-based per-cell key schedule is not implemented for 'sharded')"
    assert tail in got and tail in want
    assert got.split(tail)[1] == want.split(tail)[1]
    mc.ensure_backend_supported(rules.parse_rule("ising"), "auto")
    mc.ensure_backend_supported(rules.parse_rule("conway"), "sharded")


@pytest.mark.parametrize("spec,temperature", [("ising", 2.27), ("ising", 0.0),
                                              ("noisy:0.05/conway", None), ("noisy:1/conway:T", None)])
def test_numpy_oracles_copy(spec, temperature):
    board = np.random.default_rng(3).integers(0, 2, size=(12, 36), dtype=np.int8)
    rule, jrule = rules.parse_rule(spec), jrules.parse_rule(spec)
    np.testing.assert_array_equal(
        mc.run_np(rule, board, 9, 6, temperature=temperature, start_step=3),
        jmc.run_np(jrule, board, 9, 6, temperature=temperature, start_step=3))
    np.testing.assert_array_equal(
        mc.step_np(rule, board, 9, 4, temperature=temperature),
        jmc.step_np(jrule, board, 9, 4, temperature=temperature))
    if spec == "ising":
        np.testing.assert_array_equal(
            packed.run_packed_np(rule, board, 9, 6, temperature=temperature, start_step=3),
            jpacked.run_packed_np(jrule, board, 9, 6, temperature=temperature, start_step=3))


# -- the serving tier: errors, sessions, qos, stream, flight, time series,
# chaos and the governor's arithmetic ---------------------------------------


def _as_jax(src: str) -> str:
    """A port source read under the JAX package's module names."""
    return src.replace("tpu_life_torch", "tpu_life")


SERVING_COPIES = ["tpu_life.serve.errors", "tpu_life.serve.sessions", "tpu_life.serve.qos",
                  "tpu_life.serve.stream", "tpu_life.obs.flight", "tpu_life.obs.timeseries"]


def _body(mod) -> str:
    """A module's source after its docstring."""
    src = _source(mod)
    return src[src.index('"""\n\nfrom __future__') + 3:]


@pytest.mark.parametrize("name", [*SERVING_COPIES, "tpu_life.obs.trace"])
def test_serving_modules_are_copies_but_their_docstrings(name):
    import importlib

    jmod = importlib.import_module(name)
    port = importlib.import_module(name.replace("tpu_life", "tpu_life_torch", 1))
    assert _as_jax(_body(port)) == _body(jmod)


CHAOS_NAMES = ["ChaosError", "Fault", "Decision", "arm", "disarm", "armed", "active_plan",
               "armed_plan", "maybe_arm_from_env", "injection_count", "counts", "bind_registry",
               "_record", "decide", "record_fire", "delay", "skew", "corrupt",
               "partitioned", "crash"]
CHAOS_PLAN_METHODS = ["__init__", "from_spec", "spec", "digest", "_decide", "decide",
                      "decide_pair", "_preview", "preview_pair", "preview"]


@pytest.mark.parametrize("name", CHAOS_NAMES)
def test_chaos_functions_are_verbatim_copies(name):
    from tpu_life import chaos as jchaos
    from tpu_life_torch import chaos

    assert _as_jax(_source(getattr(chaos, name))) == _source(getattr(jchaos, name))


@pytest.mark.parametrize("name", CHAOS_PLAN_METHODS)
def test_chaos_plan_methods_are_verbatim_copies(name):
    from tpu_life import chaos as jchaos
    from tpu_life_torch import chaos

    assert _as_jax(_source(getattr(chaos.ChaosPlan, name))) == _source(
        getattr(jchaos.ChaosPlan, name))


@pytest.mark.parametrize("seed", range(3))
def test_chaos_schedules_equal_on_the_same_plan(seed):
    # _hit calls the port's threefry (no xp argument): the same draws
    from tpu_life import chaos as jchaos
    from tpu_life_torch import chaos

    spec = {"seed": seed, "points": {"engine.dispatch": {"rate": 0.3, "mode": "fault"},
                                     "spill.write": {"rate": 0.7, "mode": "enospc", "times": 3}}}
    plans = chaos.ChaosPlan.from_spec(spec), jchaos.ChaosPlan.from_spec(spec)
    for point in ("engine.dispatch", "spill.write"):
        assert plans[0].preview(point, 200) == plans[1].preview(point, 200)
    assert plans[0].digest() == plans[1].digest()


@pytest.mark.chaos
@pytest.mark.parametrize("point,mode,marker", [("engine.dispatch", "fault", "injected device fault"),
                                               ("engine.oom", "oom", "RESOURCE_EXHAUSTED")])
def test_chaos_inject_raises_alike(point, mode, marker):
    # inject's one comment differs (the port names no XLA): its raises agree
    from tpu_life import chaos as jchaos
    from tpu_life_torch import chaos
    from tpu_life_torch.runtime import recovery

    msgs = []
    for mod in (chaos, jchaos):
        with mod.armed_plan({"seed": 0, "points": {point: {"mode": mode}}}):
            with pytest.raises(RuntimeError, match=marker) as err:
                mod.inject(point)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert recovery.is_oom(RuntimeError(msgs[0])) == (mode == "oom")


def test_governor_constants_and_mesh_arithmetic_copy():
    from tpu_life.serve import governor as jgov
    from tpu_life_torch.serve import governor

    port_kinds = {k: v for k, v in jgov.DEFAULT_BYTES_PER_DEVICE.items() if k in
                  ("gpu", "cuda", "cpu", "host")}
    assert governor.DEFAULT_BYTES_PER_DEVICE == port_kinds
    assert governor.MESH_COPIES == jgov.MESH_COPIES
    for name in ("estimate_mesh_bytes", "estimate_mesh_shard_bytes", "mesh_min_devices",
                 "check_admission", "reserved_bytes"):
        assert _as_jax(_source(getattr(governor, name))) == _source(getattr(jgov, name)), name


@pytest.mark.parametrize("spec", ["conway", "brians_brain", "bugs", "lenia:mini",
                                  "R2,C2,S2..4,B2..3,NN", "star_wars", "conway:T"])
@pytest.mark.parametrize("shape", [(16, 16), (100, 37), (4096, 4096)])
@pytest.mark.parametrize("backend,jbackend", [("cuda", "jax"), ("numpy", "numpy"),
                                              ("sharded", "sharded"), ("mesh:2x2", "mesh:2x2")])
def test_governor_estimates_equal_under_the_backend_mapping(spec, shape, backend, jbackend):
    # a cuda key's JAX counterpart follows its route: the device batch
    # (jax) or, for the K2 slot loop, the pallas backend's slot loop
    from tpu_life.models.rules import get_rule as jget_rule
    from tpu_life.serve import engine as jengine
    from tpu_life.serve import governor as jgov
    from tpu_life_torch.models.rules import get_rule
    from tpu_life_torch.serve import engine, governor

    if backend == "cuda" and engine.cuda_route(get_rule(spec)) == "k2_slots":
        jbackend = "pallas"
    board = np.zeros(shape, dtype=np.int8)
    key = engine.compile_key_for(get_rule(spec), board, backend)
    jkey = jengine.compile_key_for(jget_rule(spec), board, jbackend)
    for capacity in (1, 8):
        assert governor.estimate_engine_bytes(key, capacity) == jgov.estimate_engine_bytes(
            jkey, capacity)
    if backend.startswith("mesh"):
        assert governor.estimate_mesh_shard_bytes(key, (2, 2)) == jgov.estimate_mesh_shard_bytes(
            jkey, (2, 2))


def test_the_native_codec_source_is_a_byte_copy():
    # the port builds its own codec from its own copy; native/ is never read
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    port = root / "tpu_life_torch" / "csrc" / "codec.cpp"
    assert port.read_bytes() == (root / "native" / "codec.cpp").read_bytes()


# -- the front door: stats, version, the gateway, the HTTP spill store and
# the host backends ------------------------------------------------------------
FRONT_DOOR_COPIES = ["tpu_life.obs.stats", "tpu_life.gateway.errors", "tpu_life.gateway.limits",
                     "tpu_life.serve.spill_http", "tpu_life.version"]


@pytest.mark.parametrize("name", FRONT_DOOR_COPIES)
def test_front_door_modules_are_verbatim_copies(name):
    # the copies drop the JAX comments' tags naming the original's work
    # items ("(XXXXX n)"), the one edit
    import importlib
    import re

    jmod = importlib.import_module(name)
    port = importlib.import_module(name.replace("tpu_life", "tpu_life_torch", 1))
    assert _as_jax(_source(port)) == re.sub(r" \([A-Z]{5} \d+\)", "", _source(jmod))


def test_version_copy():
    from tpu_life import version as jversion
    from tpu_life_torch import version

    assert version.__version__ == jversion.__version__


def test_the_native_stepper_source_is_a_byte_copy():
    # the port builds its own stepper from its own copy; native/ is never read
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    port = root / "tpu_life_torch" / "csrc" / "life.cpp"
    assert port.read_bytes() == (root / "native" / "life.cpp").read_bytes()


def test_the_gateway_client_is_a_copy_but_its_docstring():
    from tpu_life.gateway import client as jclient
    from tpu_life_torch.gateway import client

    assert _as_jax(_body(client)) == _body(jclient)


#: protocol's functions are verbatim; its module imports load the rule
#: registry, the stochastic checks and the seeded board lazily
PROTOCOL_NAMES = ["SubmitSpec", "_require_int", "parse_trace_id", "_check_rule_geometry",
                  "parse_board", "parse_resume_board", "_parse_edit_log_field", "parse_submit",
                  "render_view", "render_result", "decode_result"]


@pytest.mark.parametrize("name", PROTOCOL_NAMES)
def test_gateway_protocol_functions_are_verbatim_copies(name):
    from tpu_life.gateway import protocol as jprotocol
    from tpu_life_torch.gateway import protocol

    assert _as_jax(_source(getattr(protocol, name))) == _source(getattr(jprotocol, name))
    assert (protocol.MAX_CELLS, protocol.MAX_BODY) == (jprotocol.MAX_CELLS, jprotocol.MAX_BODY)


#: the server's classes and methods are verbatim but the device probe,
#: which asks for the service's own device
SERVER_NAMES = ["GatewayConfig", "_GatewayHTTPServer", "JsonHandler", "_Handler", "_monotonic"]
GATEWAY_METHODS = ["__init__", "start", "begin_drain", "wait", "close",
                   "install_signal_handlers", "_pump_loop", "device_info", "wake", "drained"]


@pytest.mark.parametrize("name", SERVER_NAMES)
def test_gateway_server_is_a_verbatim_copy(name):
    from tpu_life.gateway import server as jserver
    from tpu_life_torch.gateway import server

    assert _as_jax(_source(getattr(server, name))) == _source(getattr(jserver, name))


@pytest.mark.parametrize("name", GATEWAY_METHODS)
def test_gateway_methods_are_verbatim_copies(name):
    from tpu_life.gateway import server as jserver
    from tpu_life_torch.gateway import server

    def get(cls):
        obj = cls.__dict__[name]
        return obj.fget if isinstance(obj, property) else obj

    assert _as_jax(_source(get(server.Gateway))) == _source(get(jserver.Gateway))


def test_gateway_exports_copy():
    from tpu_life import gateway as jgateway
    from tpu_life_torch import gateway

    assert gateway.__all__ == jgateway.__all__
    from tpu_life.gateway import server as jserver
    from tpu_life_torch.gateway import server

    for name in ("ROUTE_SESSIONS", "ROUTE_SESSION", "ROUTE_RESULT", "ROUTE_STREAM",
                 "ROUTE_CELLS", "ROUTE_TRACE", "ROUTE_SERIES"):
        assert getattr(server, name) == getattr(jserver, name)


@pytest.mark.parametrize("name", ["_exchange_halos", "_update_stripe", "StripesBackend.__init__",
                                  "MpiBackend.__init__"])
def test_stripes_backend_is_a_copy(name):
    # StripesBackend.run adds one refusal (a torus shallower than the
    # radius, which the JAX loop trims to an empty board) and MpiBackend.run
    # differs in one comment; tests/test_torch_host_backends.py holds both
    # runs to the JAX package's on the same boards
    from tpu_life.backends import stripes_backend as jstripes
    from tpu_life_torch.backends import stripes_backend as stripes

    def get(mod):
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    assert _as_jax(_source(get(stripes))) == _source(get(jstripes))


def test_native_backend_run_and_step_wrap_cols_are_copies():
    from tpu_life.backends import native_backend as jnative
    from tpu_life.ops import reference as jref
    from tpu_life_torch.backends import native_backend
    from tpu_life_torch.ops import reference as ref

    assert _source(native_backend.NativeBackend.run) == _source(jnative.NativeBackend.run)
    assert _source(ref.step_np_wrap_cols) == _source(jref.step_np_wrap_cols)


# -- the fleet, the chaos drills and the console tools ---------------------------
def _jax_text(src: str) -> str:
    """A JAX source as the port copies it: without the tags naming the
    original's work items ("PR n ", "(XXXXX n)")."""
    import re

    return re.sub(r" \([A-Z]{5} \d+\)", "", re.sub(r"PR \d+ ", "", src))


#: whole modules copied verbatim (imports renamed, tags dropped)
FLEET_COPIES = ["fleet.errors", "fleet.registry", "fleet.balancer", "fleet.fanout",
                "fleet.membership", "fleet.autoscaler", "fleet.router", "fleet.migrate",
                "fleet", "obs.journey", "obs.slo", "obs.console"]


@pytest.mark.parametrize("name", FLEET_COPIES)
def test_fleet_and_obs_tools_are_verbatim_copies(name):
    import importlib

    jmod = importlib.import_module(f"tpu_life.{name}")
    port = importlib.import_module(f"tpu_life_torch.{name}")
    assert _as_jax(_source(port)) == _jax_text(_source(jmod))


def _members(mod) -> dict[str, str]:
    """Every function and class a module defines, and every method of its
    classes, by qualified name -> source."""
    out = {}
    for name, obj in vars(mod).items():
        if getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isfunction(obj):
            out[name] = _source(obj)
        elif inspect.isclass(obj):
            out[name] = _source(obj)
            for attr, member in vars(obj).items():
                fn = member.fget if isinstance(member, property) else member
                fn = getattr(fn, "__func__", fn)
                # dataclass-made methods have no source of their own
                if inspect.isfunction(fn) and fn.__code__.co_filename == mod.__file__:
                    out[f"{name}.{attr}"] = _source(fn)
    return out


#: the modules with recorded departures, and exactly the members that
#: depart (each pinned by a test of its own in test_torch_fleet_unit.py,
#: test_torch_chaos_drill.py or test_torch_fleet_http.py); every other
#: member is a verbatim copy
DEPARTURES = {
    # overlays: CUDA_VISIBLE_DEVICES and --device, no JAX_PLATFORMS/XLA flag
    "fleet.placement": {"Placement", "plan_placements", "apply_env_overlay"},
    # the placement's gateway flags ride every spawn's argv
    "fleet.supervisor": {"FleetConfig", "Worker", "Supervisor", "Supervisor.__init__",
                         "Supervisor.worker_argv"},
    # the card by default (backend cuda, a device field); numpy-only Threefry
    "chaos.drill": {"DrillConfig", "run_drill", "_Driller", "_Driller._draw"},
    "chaos.crosshost": {"CrossHostConfig", "run_cross_host_drill", "_shim"},
}


@pytest.mark.parametrize("name", sorted(DEPARTURES))
def test_fleet_copies_depart_only_where_recorded(name):
    import importlib

    jm = _members(importlib.import_module(f"tpu_life.{name}"))
    pm = _members(importlib.import_module(f"tpu_life_torch.{name}"))
    assert set(pm) == set(jm)
    differ = {n for n in pm if _as_jax(pm[n]) != _jax_text(jm[n])}
    assert differ == DEPARTURES[name]


def test_the_fleet_worker_argv_starts_the_ports_gateway(tmp_path):
    import sys

    from tpu_life_torch import obs
    from tpu_life_torch.fleet.supervisor import FleetConfig, Supervisor

    s = Supervisor(FleetConfig(workers=1, log_dir=str(tmp_path), worker_args=("--capacity", "2"),
                               spill_dir=str(tmp_path / "sp"), trace_dir=str(tmp_path / "tr")),
                   obs.MetricsRegistry(), spawn=lambda w: None, probe=lambda w: "ready")
    argv = s.worker_argv(s.workers[0])
    assert argv[:8] == [sys.executable, "-m", "tpu_life_torch", "gateway", "--host",
                        "127.0.0.1", "--port", "0"]
    assert argv[8:10] == ["--capacity", "2"]
    assert argv[argv.index("--spill-dir") + 1] == str(tmp_path / "sp" / "w0g0")
    assert argv[-1] == str(tmp_path / "tr" / "w0g0.trace.json")


def test_the_default_spawn_puts_the_ports_checkout_first(tmp_path, monkeypatch):
    import subprocess
    from pathlib import Path

    from tpu_life_torch import obs
    from tpu_life_torch.fleet import supervisor as sup

    seen = {}

    def popen(argv, **kw):
        seen.update(argv=argv, env=kw["env"], new_session=kw["start_new_session"])
        return type("Proc", (), {"pid": 4242})()

    monkeypatch.setattr(subprocess, "Popen", popen)
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    s = sup.Supervisor(sup.FleetConfig(workers=1, log_dir=str(tmp_path), placement="auto",
                                       placement_platform="cuda", total_devices=1),
                       obs.MetricsRegistry(), probe=lambda w: "ready")
    s._default_spawn(s.workers[0])
    root = Path(seen["env"]["PYTHONPATH"].split(":")[0])
    assert (root / "tpu_life_torch" / "fleet" / "supervisor.py").is_file()
    assert seen["env"]["PYTHONPATH"].endswith(":/elsewhere")
    assert seen["env"]["CUDA_VISIBLE_DEVICES"] == "0"
    assert seen["argv"][2:4] == ["tpu_life_torch", "gateway"]
    assert seen["argv"][-2:] == ["--device", "cuda"] and seen["new_session"]
