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

NOT_PORTED = {"ising"}
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


@pytest.mark.parametrize("spec", ["ising", "ising:T", "noisy:0.01/conway", "noisy:0.05/B36/S23:T", "Ising"])
def test_unported_tiers_raise_typed_error(spec):
    with pytest.raises(rules.NotPortedError, match="not yet ported") as e:
        rules.parse_rule(spec)
    # the message names only what is still unported
    assert "stochastic tier (ising, noisy:)" in str(e.value) and "lenia" not in str(e.value)


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
