"""The port's autotuner (``tpu_life_torch.autotune``) held to the JAX
package's (``tests/test_autotune.py``'s cases that apply), through
``interop.tune_dict_from_jax`` for the names that differ: keys, candidate
lists, the cost model's formula, the cache, the measured search, the read
path's never-measure guarantee, and ``tune`` / ``run --backend tuned`` /
``bench --backend tuned`` / ``serve --serve-backend tuned`` on the CPU.
Boards come from ``np.random.default_rng``; every run is held to bytes.
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading

import numpy as np
import pytest
import torch

from tpu_life import autotune as jautotune
from tpu_life import cli as jcli
from tpu_life.autotune import cache as jcache
from tpu_life.autotune import cost_model as jcost_model
from tpu_life.autotune import space as jspace
from tpu_life.models import rules as jrules
from tpu_life.ops import conv as jconv
from tpu_life_torch import autotune, cli, interop
from tpu_life_torch.autotune import cache, cost_model, runner, space
from tpu_life_torch.autotune.space import TuneKey, TunedConfig
from tpu_life_torch.config import RunConfig
from tpu_life_torch.io.codec import read_board, write_board, write_config
from tpu_life_torch.kernels._build import KernelBuildError
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops import conv
from tpu_life_torch.ops.reference import run_np
from tpu_life_torch.runtime import driver
from tpu_life_torch.utils.nativelib import NativeBuildError


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    """Isolated caches for both packages (each has its own variable)."""
    monkeypatch.setenv(jcache.ENV_VAR, str(tmp_path / "jax_autotune.json"))
    p = tmp_path / "autotune.json"
    monkeypatch.setenv(cache.ENV_VAR, str(p))
    return p


@pytest.fixture(autouse=True)
def _no_stale_log_handler():
    """The CLI's configure_logging binds a handler to the stderr of the
    test that first calls it (capsys's); drop what a test added, so no later
    test writes through a handler whose stream is closed."""
    from tpu_life_torch.runtime.metrics import log

    before = list(log.handlers)
    yield
    log.handlers[:] = before


@pytest.fixture(autouse=True)
def _reset_probe():
    autotune.reset_trial_count()
    jautotune.reset_trial_count()
    yield
    autotune.reset_trial_count()
    jautotune.reset_trial_count()


def make_key(**kw) -> TuneKey:
    base = dict(device_kind="cpu", device_count=8, rule_name="B3/S23", radius=1, states=2,
                neighborhood="moore", boundary="clamped", shape_bucket=(4096, 4096),
                bitpack_ok=True)
    base.update(kw)
    return TuneKey(**base)


def port_config(jcfg, jkey=None) -> TunedConfig:
    stochastic = jkey is not None and jkey.stochastic
    return TunedConfig.from_dict(interop.tune_dict_from_jax(jcfg.to_dict(),
                                                            stochastic=stochastic))


def port_key(jkey) -> TuneKey:
    d = interop.tune_dict_from_jax(jkey.to_dict())
    d["shape_bucket"] = tuple(d["shape_bucket"])
    return TuneKey(**d)


SPECS = sorted(jrules.RULE_REGISTRY) + [
    "conway:T", "R2,C2,S2..4,B3,NN", "R1,C2,S1,B1,NN", "R3,C2,S2..9,B3..5,NN",
    "R2,C2,S1,B1,NN:T", "brians_brain:T", "noisy:0.01/conway", "lenia:orbium", "lenia:mini",
]


# --- key / space -------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(1, 1), (128, 128), (129, 64), (1500, 500), (4096, 4097),
                                 (16384, 16384)])
def test_shape_bucket_equals_jax(h, w):
    assert space.shape_bucket(h, w) == jspace.shape_bucket(h, w)
    assert space.MIN_BUCKET == jspace.MIN_BUCKET
    assert space.BLOCK_STEPS_GRID == jspace.BLOCK_STEPS_GRID


def test_shape_bucket_rejects_empty_boards():
    for mod in (space, jspace):
        with pytest.raises(ValueError, match="positive"):
            mod.shape_bucket(0, 5)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("kinds", [("cpu", "cpu"), ("cuda", "tpu")], ids=["cpu", "cuda"])
def test_tune_key_id_equals_jax_for_every_rule(spec, kinds):
    kind, jkind = kinds
    rule, jrule = get_rule(spec), jrules.get_rule(spec)
    got = space.tune_key_for(rule, (1500, 700), device_kind=kind, device_count=4)
    want = jspace.tune_key_for(jrule, (1500, 700), device_kind=jkind, device_count=4)
    assert got == port_key(want)
    if kind == "cpu":
        assert got.id() == want.id()
    else:
        assert got.id() == want.id().replace("tpux4", "cudax4", 1)


def test_tune_key_for_takes_the_runs_device(monkeypatch):
    rule = get_rule("conway")
    assert space.tune_key_for(rule, (64, 64), device="cpu").device_kind == "cpu"
    assert space.tune_key_for(rule, (64, 64), device="cpu").device_count == 1
    from tpu_life_torch.backends.base import CudaUnavailableError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(CudaUnavailableError, match="--device cpu"):
            space.tune_key_for(rule, (64, 64), device=device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    key = space.tune_key_for(rule, (64, 64))
    assert (key.device_kind, key.device_count) == ("cuda", 2)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("kinds", [("cpu", "cpu"), ("cuda", "tpu")], ids=["cpu", "cuda"])
@pytest.mark.parametrize("count", [1, 4, 3])
def test_enumerate_candidates_equal_jax(spec, kinds, count):
    kind, jkind = kinds
    rule, jrule = get_rule(spec), jrules.get_rule(spec)
    shape = (1500, 700)  # 1500 rows divide 1 and 4 shards, not 3: the torus case
    key = space.tune_key_for(rule, shape, device_kind=kind, device_count=count)
    jkey = jspace.tune_key_for(jrule, shape, device_kind=jkind, device_count=count)
    got = space.enumerate_candidates(key, shape=shape)
    want = jspace.enumerate_candidates(jkey, shape=shape)
    assert got == [port_config(c, jkey) for c in want]
    assert space.default_backend_set(kind) == tuple(
        interop.BACKEND_FROM_JAX.get(b, b) for b in jspace.default_backend_set(jkind))


def test_torus_rows_must_divide_the_mesh():
    key = make_key(boundary="torus", device_count=3, shape_bucket=(128, 128))
    assert not any(c.backend == "sharded"
                   for c in space.enumerate_candidates(key, shape=(100, 100)))
    assert any(c.backend == "sharded" for c in space.enumerate_candidates(key, shape=(99, 99)))
    with pytest.raises(ValueError, match="unknown backend"):
        space.enumerate_candidates(key, backend_set=("jax",))
    with pytest.raises(ValueError, match="no feasible candidates"):
        space.enumerate_candidates(key, backend_set=("cuda",), shape=(100, 100))


def test_tuned_config_round_trip_and_kwargs():
    cfg = TunedConfig("sharded", 8, "cuda", True, 0)
    assert TunedConfig.from_dict(cfg.to_dict()) == cfg
    kw = cfg.backend_kwargs()
    assert kw["block_steps"] == 8 and kw["local_kernel"] == "cuda"
    assert "block_steps" not in TunedConfig("torch").backend_kwargs()
    assert TunedConfig("torch", stencil="matmul").backend_kwargs()["stencil"] == "matmul"
    for c in (cfg, TunedConfig("torch", stencil="roll")):
        j = jspace.TunedConfig(**{**c.to_dict(), "backend": "jax"})
        assert c.describe().split(" ", 1)[1] == j.describe().split(" ", 1)[1]


def test_interop_maps_a_jax_cache_entry(tmp_path):
    jkey = jspace.tune_key_for(jrules.get_rule("conway"), (64, 64), device_kind="tpu",
                               device_count=1)
    jentry = jcache.put(jkey, jspace.TunedConfig("sharded", 16, "pallas"), source="measured",
                        path=tmp_path / "j.json")
    key = port_key(jkey)
    assert key.device_kind == "cuda"
    assert TunedConfig.from_dict(interop.tune_dict_from_jax(jentry["config"])) == TunedConfig(
        "sharded", 16, "cuda")
    assert interop.tune_dict_from_jax({"backend": "pallas", "local_kernel": "xla"}) == {
        "backend": "cuda", "local_kernel": "torch"}
    assert interop.tune_dict_from_jax({"backend": "numpy"}) == {"backend": "numpy"}
    assert interop.tune_dict_from_jax({"backend": "jax"}, stochastic=True) == {"backend": "cuda"}


# --- cost model --------------------------------------------------------------

# CUDA_FACTOR is the port's own term (K1 and K2 against plain ops); JAX
# has none, which is a factor of 1.0
JAX_CONSTANTS = dict(COMPUTE=0.837, TRAFFIC=0.795, FRINGE=0.008, HALO_TAX=0.02,
                     CUDA_FACTOR=1.0, KERNEL_FACTOR=0.97, MATMUL_WIDE=0.85,
                     MATMUL_NARROW=1.5)


@pytest.fixture
def jax_constants(monkeypatch):
    """The JAX model's constants (and its crossover radius) patched into
    the port's model: the formula is then the JAX one."""
    assert (jcost_model.COMPUTE, jcost_model.TRAFFIC, jcost_model.FRINGE) == (
        JAX_CONSTANTS["COMPUTE"], JAX_CONSTANTS["TRAFFIC"], JAX_CONSTANTS["FRINGE"])
    for name, value in JAX_CONSTANTS.items():
        monkeypatch.setattr(cost_model, name, value)
    monkeypatch.setattr(conv, "CROSSOVER_RADIUS", jconv.CROSSOVER_RADIUS)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("kinds", [("cpu", "cpu"), ("cuda", "tpu")], ids=["cpu", "cuda"])
@pytest.mark.parametrize("count", [1, 8])
def test_estimate_cost_equals_jax_under_jax_constants(spec, kinds, count, jax_constants):
    kind, jkind = kinds
    rule, jrule = get_rule(spec), jrules.get_rule(spec)
    key = space.tune_key_for(rule, (4096, 4096), device_kind=kind, device_count=count)
    jkey = jspace.tune_key_for(jrule, (4096, 4096), device_kind=jkind, device_count=count)
    backends = ("jax", "sharded", "pallas", "numpy")
    jcands = jspace.enumerate_candidates(jkey, backend_set=backends, shape=(4096, 4096))
    cands = [port_config(c, jkey) for c in jcands]
    assert [cost_model.estimate_cost(key, c) for c in cands] == [
        jcost_model.estimate_cost(jkey, c) for c in jcands]
    assert cost_model.choose(key, cands) == port_config(jcost_model.choose(jkey, jcands), jkey)


def test_effective_block_steps_are_the_ports_defaults():
    from tpu_life_torch.backends.cuda_backend import DEFAULT_BLOCK_STEPS

    assert cost_model.effective_block_steps(TunedConfig("torch", 16)) == 1
    assert cost_model.effective_block_steps(TunedConfig("cuda")) == DEFAULT_BLOCK_STEPS
    assert cost_model.effective_block_steps(TunedConfig("sharded")) == DEFAULT_BLOCK_STEPS
    assert cost_model.effective_block_steps(TunedConfig("sharded", 0, "cuda")) == 1


def test_without_a_crossover_only_continuous_keys_count_as_wide(monkeypatch):
    monkeypatch.setattr(cost_model, "COMPUTE", 1.0)
    monkeypatch.setattr(conv, "CROSSOVER_RADIUS", None)
    monkeypatch.setattr(cost_model, "MATMUL_WIDE", 0.5)
    monkeypatch.setattr(cost_model, "MATMUL_NARROW", 3.0)
    roll, mm = TunedConfig("torch", None, "auto", False, 0, "roll"), TunedConfig(
        "torch", None, "auto", False, 0, "matmul")
    r5 = make_key(radius=5, bitpack_ok=False)
    ratio = cost_model.estimate_cost(r5, mm) / cost_model.estimate_cost(r5, roll)
    assert ratio == pytest.approx(3.0)
    cc = make_key(radius=13, bitpack_ok=False, continuous=True)
    ratio = cost_model.estimate_cost(cc, mm) / cost_model.estimate_cost(cc, roll)
    assert ratio == pytest.approx(0.5)
    monkeypatch.setattr(conv, "CROSSOVER_RADIUS", 4)
    ratio = cost_model.estimate_cost(r5, mm) / cost_model.estimate_cost(r5, roll)
    assert ratio == pytest.approx(0.5)


def test_the_constants_are_the_fit_of_their_measured_inputs():
    # no constant comes from a TPU: each is the fit of the card's table
    # that cost_model.py records beside it (experiments/tune_fit.py)
    from tpu_life_torch.experiments.tune_fit import fit

    got = fit(cost_model.FIT_INPUTS_CUDA, cost_model.FIT_INPUTS_SHARDED_CUDA,
              cost_model.FIT_INPUTS_SHARDED_TORCH, cost_model.FIT_INPUTS_STENCIL)
    for name in ("COMPUTE", "TRAFFIC", "FRINGE", "CUDA_FACTOR", "KERNEL_FACTOR",
                 "MATMUL_WIDE", "MATMUL_NARROW"):
        assert getattr(cost_model, name) == pytest.approx(got[name], rel=1e-3, abs=1e-6), name
    assert cost_model.HALO_TAX == 0.0
    for name, value in JAX_CONSTANTS.items():
        if name != "HALO_TAX":
            assert getattr(cost_model, name) != value, name


def test_fit_recovers_known_constants_and_drops_negative_terms():
    from tpu_life_torch.experiments.tune_fit import fit

    def series(c, t, f):
        return {k: (c + t / k + f * k) * 2e-5 for k in space.BLOCK_STEPS_GRID}

    cuda = series(0.6, 0.9, 0.01)
    got = fit(cuda, {k: 1.2 * v for k, v in cuda.items()}, {k: 40 * v for k, v in cuda.items()},
              {"wide": (1.0, 4.0), "narrow": (5.0, 1.0)})
    lo = min(cuda.values()) / 2e-5
    assert got["COMPUTE"] == pytest.approx(0.6 / lo)
    assert got["TRAFFIC"] == pytest.approx(0.9 / lo)
    assert got["FRINGE"] == pytest.approx(0.01 / lo)
    assert got["CUDA_FACTOR"] == pytest.approx(0.025)
    assert got["KERNEL_FACTOR"] == pytest.approx(0.03)
    assert (got["MATMUL_WIDE"], got["MATMUL_NARROW"], got["dropped"]) == (0.25, 5.0, [])
    falling = {k: (0.5 + 1.0 / k - 0.001 * k) for k in space.BLOCK_STEPS_GRID}
    got = fit(falling, falling, falling, {"wide": (1.0, 1.0), "narrow": (1.0, 1.0)})
    assert got["dropped"] == ["FRINGE"] and got["FRINGE"] == 0.0 and got["TRAFFIC"] > 0


@pytest.mark.parametrize("spec,bitpack", [
    ("conway", True),                     # packed clamped Moore: K1 or K3
    ("conway:T", True),                   # packed torus: K1
    ("R2,C2,S2..4,B2..3,NN", True),       # K1's diamond mode
    ("brians_brain", True),               # Generations: K2
    ("bugs", True),                       # Larger than Life: K2
    ("conway", False),                    # --no-bitpack: K2
], ids=["moore", "torus", "diamond", "generations", "ltl", "no_bitpack"])
@pytest.mark.parametrize("count", [1, 4])
def test_cost_model_picks_a_kernel_on_the_card_for_every_family_a_kernel_covers(
        spec, bitpack, count):
    # with the card's constants a miss never falls to plain ops where a
    # hand-written kernel runs the key
    key = space.tune_key_for(get_rule(spec), (4096, 4096), device_kind="cuda",
                             device_count=count)
    if not bitpack:
        key = dataclasses.replace(key, bitpack_ok=False)
    cands = space.enumerate_candidates(key, shape=(4096, 4096))
    pick = cost_model.choose(key, cands)
    assert pick.backend == "cuda" or (pick.backend, pick.local_kernel) == ("sharded", "cuda"), (
        pick.describe())
    if count == 1:
        assert pick.backend == "cuda", pick.describe()  # K1 beats K3 at equal k on one card


def test_cost_model_prefers_packed_and_never_numpy():
    key = make_key()
    packed = TunedConfig("torch", None, "auto", True)
    unpacked = TunedConfig("torch", None, "auto", False)
    assert cost_model.estimate_cost(key, packed) < cost_model.estimate_cost(key, unpacked)
    assert cost_model.choose(key, [TunedConfig("numpy", None, "auto", False), packed]) == packed
    with pytest.raises(ValueError, match="at least one"):
        cost_model.choose(key, [])


# --- cache -------------------------------------------------------------------


def test_cache_round_trip(cache_file):
    key = make_key()
    cfg = TunedConfig("sharded", 8, "torch", True, 0)
    assert cache.get(key) is None
    cache.put(key, cfg, source="measured", seconds_per_step=1e-3, trials=3)
    entry = cache.get(key)
    assert TunedConfig.from_dict(entry["config"]) == cfg
    assert entry["source"] == "measured" and entry["seconds_per_step"] == 1e-3
    assert entry["key"]["rule_name"] == "B3/S23" and entry["trials"] == 3
    raw = json.loads(cache_file.read_text())
    assert raw["schema"] == cache.SCHEMA_VERSION == jcache.SCHEMA_VERSION
    assert key.id() in raw["entries"]


def test_cache_atomic_write_leaves_no_temp_files(cache_file):
    for k in (1, 4, 8):
        cache.put(make_key(radius=k), TunedConfig("torch"), source="measured")
    siblings = sorted(p.name for p in cache_file.parent.iterdir() if "autotune.json" in p.name)
    assert siblings == ["autotune.json", "autotune.json.lock"]
    assert len(cache.load()) == 3


def test_cache_schema_version_invalidates_wholesale(cache_file):
    cache.put(make_key(), TunedConfig("torch"), source="measured")
    raw = json.loads(cache_file.read_text())
    raw["schema"] = cache.SCHEMA_VERSION + 1
    cache_file.write_text(json.dumps(raw))
    assert cache.load() == {} and cache.get(make_key()) is None


def test_cache_corrupt_file_and_malformed_entries_degrade(cache_file):
    cache_file.write_text("{not json")
    assert cache.load() == {}
    good = make_key()
    cache.put(good, TunedConfig("torch"), source="measured")
    raw = json.loads(cache_file.read_text())
    raw["entries"]["bad"] = {"config": {"no_backend": 1}}
    raw["entries"]["worse"] = "nope"
    cache_file.write_text(json.dumps(raw))
    assert set(cache.load()) == {good.id()}


def test_cache_invalidate(cache_file):
    a, b = make_key(radius=1), make_key(radius=2)
    cache.put(a, TunedConfig("torch"), source="measured")
    cache.put(b, TunedConfig("torch"), source="measured")
    assert cache.invalidate(a) == 1 and cache.invalidate(a) == 0
    assert set(cache.load()) == {b.id()}
    assert cache.invalidate() == 1 and cache.load() == {}


def test_the_cache_file_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    monkeypatch.delenv(jcache.ENV_VAR, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert cache.cache_path() == tmp_path / "xdg" / "tpu_life_torch" / "autotune.json"
    assert cache.cache_path() != jcache.cache_path()
    assert cache.ENV_VAR == "TPU_LIFE_TORCH_AUTOTUNE_CACHE" != jcache.ENV_VAR
    monkeypatch.setenv(jcache.ENV_VAR, str(tmp_path / "jax.json"))
    assert cache.cache_path() != tmp_path / "jax.json"  # the JAX variable is not read
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path / "env.json"))
    assert cache.cache_path() == tmp_path / "env.json"
    assert cache.cache_path(tmp_path / "x.json") == tmp_path / "x.json"


def test_equal_cpu_key_ids_never_share_a_pick(cache_file):
    # the two packages' CPU keys have equal ids; each reads its own file
    rule, jrule = get_rule("conway"), jrules.get_rule("conway")
    key = space.tune_key_for(rule, (64, 64), device="cpu")
    jkey = jspace.tune_key_for(jrule, (64, 64), device_kind="cpu", device_count=1)
    assert key.id() == jkey.id()
    jcache.put(jkey, jspace.TunedConfig("jax"), source="measured")
    assert cache.get(key) is None
    assert autotune.resolve(key)[1] == "cost_model"


# --- trials / winner selection ----------------------------------------------


def test_deterministic_winner_under_fake_timings(cache_file):
    key = make_key(shape_bucket=(128, 128))
    rule = get_rule("conway")
    cands = space.enumerate_candidates(key, backend_set=("torch", "sharded"))
    timing = {c: 5e-3 for c in cands}
    winner = next(c for c in cands if c.backend == "sharded" and c.block_steps == 8)
    timing[winner] = 1e-3
    res = autotune.tune(key, rule, shape=(32, 32), backend_set=("torch", "sharded"),
                        measure=lambda cfg, board, r: timing[cfg])
    assert res.best == winner and res.source == "measured"
    res2 = autotune.tune(key, rule, shape=(32, 32), backend_set=("torch", "sharded"),
                         measure=lambda cfg, board, r: 2e-3)
    assert res2.best == cands[0]
    got, source = autotune.resolve(key)
    assert source == "cache" and got == cands[0]


def test_per_candidate_failure_isolation(cache_file):
    key = make_key(shape_bucket=(128, 128))
    rule = get_rule("conway")

    def measure(cfg, board, r):
        if cfg.backend == "sharded":
            raise RuntimeError("mesh exploded")
        return 1e-3

    res = autotune.tune(key, rule, shape=(32, 32), backend_set=("torch", "sharded"),
                        measure=measure)
    infeasible = [r for r in res.results if not r.ok]
    assert infeasible and all("mesh exploded" in r.error for r in infeasible)
    assert res.best.backend == "torch"

    def all_fail(cfg, board, r):
        raise RuntimeError("no device")

    with pytest.raises(RuntimeError, match="every candidate failed"):
        autotune.tune(key, rule, shape=(32, 32), backend_set=("torch",), measure=all_fail)


@pytest.mark.parametrize("error", [KernelBuildError("nvcc failed on x.cu"),
                                   NativeBuildError("g++ not found")],
                         ids=["kernel", "native"])
def test_a_build_error_propagates_and_is_never_infeasible(cache_file, error):
    key = make_key(shape_bucket=(128, 128))

    def measure(cfg, board, r):
        if cfg.backend == "sharded":
            raise error
        return 1e-3

    with pytest.raises(type(error), match=re.escape(str(error))):
        autotune.tune(key, get_rule("conway"), shape=(32, 32),
                      backend_set=("torch", "sharded"), measure=measure)
    assert not cache_file.exists()


def test_measured_trials_increment_the_probe(cache_file):
    key = autotune.tune_key_for(get_rule("conway"), (64, 64), device="cpu")
    res = autotune.tune(key, "conway", shape=(64, 64), backend_set=("torch",), trials=2,
                        steps=2, warmup_steps=1)
    assert res.source == "measured"
    assert autotune.trial_count() >= 2
    assert res.cache_file == str(cache.cache_path())
    assert all(len(r.samples) == 2 for r in res.results)


def test_each_trial_runs_in_a_span(cache_file, tmp_path):
    from tpu_life_torch import obs

    tracer = obs.start_tracing(str(tmp_path / "t.json"), run_id="r")
    try:
        autotune.tune(make_key(shape_bucket=(128, 128)), "conway", shape=(32, 32),
                      backend_set=("torch",), measure=lambda *a: 1e-3)
    finally:
        obs.stop_tracing(tracer)
    events = json.loads((tmp_path / "t.json").read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = [e for e in events if e.get("name") == "autotune.trial" and e.get("ph") == "B"]
    assert len(spans) == 2
    assert spans[0]["args"]["candidate"] == TunedConfig("torch").describe()


def test_trial_defaults_and_workload():
    assert runner.default_trial_steps("cpu") == jautotune.runner.default_trial_steps("cpu")
    assert runner.default_trial_steps("cuda") == runner.TRIAL_STEPS_CUDA
    assert runner.trial_device(make_key()) == "cpu"
    assert runner.trial_device(make_key(device_kind="cuda")) is None
    for spec in ("conway", "brians_brain"):
        key = space.tune_key_for(get_rule(spec), (40, 30), device="cpu")
        jkey = jspace.tune_key_for(jrules.get_rule(spec), (40, 30), device_kind="cpu",
                                   device_count=1)
        np.testing.assert_array_equal(runner.make_trial_board(key, (40, 30)),
                                      jautotune.runner.make_trial_board(jkey, (40, 30)))
    assert runner._trial_runner_kwargs(get_rule("ising")) == (
        jautotune.runner._trial_runner_kwargs(jrules.get_rule("ising")))
    assert runner._trial_runner_kwargs(get_rule("conway")) == {}


# --- resolve: the read path --------------------------------------------------


def test_resolve_miss_uses_cost_model_and_never_measures(cache_file):
    cfg, source = autotune.resolve(make_key(), shape=(4096, 4096))
    assert source == "cost_model" and cfg.backend in ("torch", "sharded")
    assert autotune.trial_count() == 0
    assert not cache_file.exists()


def test_resolve_backend_kwargs_explicit_pins_win(cache_file):
    rule = get_rule("conway")
    key = autotune.tune_key_for(rule, (64, 64), device="cpu")
    cache.put(key, TunedConfig("sharded", 32, "cuda"), source="measured")
    kwargs = {"bitpack": True, "local_kernel": "torch"}
    backend_name, tuned, source = autotune.resolve_backend_kwargs(rule, (64, 64), kwargs,
                                                                  device="cpu")
    assert (backend_name, source) == ("sharded", "cache")
    assert kwargs["local_kernel"] == "torch" and kwargs["block_steps"] == 32
    assert autotune.trial_count() == 0


def test_resolve_modes(cache_file):
    key = make_key()
    cached = TunedConfig("sharded", 16, "torch", True, 0)
    cache.put(key, cached, source="measured")
    assert autotune.resolve(key) == (cached, "cache")
    assert autotune.resolve(key, mode="off")[1] == "cost_model"
    assert autotune.resolve(key, mode="measure") == (cached, "cache")
    with pytest.raises(ValueError, match="tune_mode"):
        autotune.resolve(key, mode="always")
    assert autotune.TUNE_MODES == jautotune.TUNE_MODES


# --- serve integration: resolve, never measure -------------------------------


@pytest.mark.parametrize("pick", [None, TunedConfig("numpy"), TunedConfig("torch"),
                                  TunedConfig("cuda", 4), TunedConfig("sharded", 4, "torch")],
                         ids=["cold", "numpy", "torch", "cuda", "sharded"])
def test_serve_tuned_backend_resolves_without_measuring(cache_file, pick):
    from tpu_life_torch.serve import ServeConfig, SessionState, SimulationService

    board = np.random.default_rng(7).integers(0, 2, size=(48, 64), dtype=np.int8)
    if pick is not None:
        key = autotune.tune_key_for(get_rule("conway"), (48, 64), device="cpu")
        cache.put(key, pick, source="measured")
    svc = SimulationService(ServeConfig(backend="tuned", capacity=2, chunk_steps=8,
                                        device="cpu"))
    sids = [svc.submit(board, "conway", n) for n in (12, 5, 9)]
    svc.drain()
    for sid, n in zip(sids, (12, 5, 9)):
        view = svc.poll(sid)
        assert view.state is SessionState.DONE
        np.testing.assert_array_equal(view.result, run_np(board, get_rule("conway"), n))
    assert autotune.trial_count() == 0
    assert not cache_file.exists() or pick is not None


def test_serve_tuned_continuous_and_stochastic_keys(cache_file):
    from tpu_life_torch import mc
    from tpu_life_torch.models import lenia
    from tpu_life_torch.serve import ServeConfig, SimulationService

    rule = get_rule("lenia:mini")
    board = lenia.seeded_board(40, 40, seed=2)
    svc = SimulationService(ServeConfig(backend="tuned", capacity=2, chunk_steps=4,
                                        device="cpu"))
    sid = svc.submit(board, rule, 6)
    svc.drain()
    np.testing.assert_allclose(svc.poll(sid).result, lenia.run_np(board, rule, 6), atol=1e-4)
    # the stochastic gate sees `tuned` as the JAX gate does: refused typed
    with pytest.raises(mc.StochasticBackendError):
        svc.submit(np.zeros((8, 8), np.int8), "ising", 2, temperature=2.0)
    assert autotune.trial_count() == 0


def test_serve_cli_tuned_no_longer_exits_2(cache_file, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    board = np.random.default_rng(4).integers(0, 2, size=(33, 40), dtype=np.int8)
    write_board("a.txt", board)
    write_config("g.txt", 33, 40, 9)
    assert cli.main(["submit", "--input-file", "a.txt", "--config-file", "g.txt"]) == 0
    capsys.readouterr()
    assert cli.main(["serve", "--serve-backend", "tuned", "--device", "cpu",
                     "--output-dir", "out"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (summary["sessions"], summary["done"], summary["failed"]) == (1, 1, 0)
    (res,) = (tmp_path / "out").iterdir()
    np.testing.assert_array_equal(read_board(res, 33, 40), run_np(board, get_rule("conway"), 9))
    assert autotune.trial_count() == 0


# --- driver / CLI: tune offline, run from cache ------------------------------


def _workload(tmp_path, shape=(64, 64), steps=4, seed=3, states=2):
    board = np.random.default_rng(seed).integers(0, states, size=shape, dtype=np.int8)
    write_board(tmp_path / "data.txt", board)
    write_config(tmp_path / "grid_size_data.txt", *shape, steps)
    return board


def test_cli_tune_then_run_resolves_from_cache(cache_file, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["tune", "--device", "cpu", "--size", "64", "--trials", "2", "--steps",
                     "2", "--warmup-steps", "1"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["source"] == "measured" and summary["cache_file"] == str(cache_file)
    assert autotune.trial_count() > 0
    _workload(tmp_path)
    autotune.reset_trial_count()
    assert cli.main(["run", "--backend", "tuned", "--device", "cpu",
                     "--output-file", "port.txt"]) == 0
    assert autotune.trial_count() == 0
    assert jcli.main(["run", "--backend", "numpy", "--output-file", "jax.txt"]) == 0
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def test_tune_dry_run_prints_the_jax_summary_keys(cache_file, capsys):
    assert cli.main(["tune", "--device", "cpu", "--size", "256", "--dry-run"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    got = json.loads(lines[-1])
    assert jcli.main(["tune", "--platform", "cpu", "--size", "256", "--dry-run"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    # the keys differ only in the device count (the JAX tests' fake CPU mesh)
    assert got["key"].split("|", 1)[1] == want["key"].split("|", 1)[1]
    assert (got["source"], got["cache_file"]) == ("cost_model", None)
    assert got["candidates"] == want["candidates"] == len(lines) - 2
    assert not cache_file.exists() and autotune.trial_count() == 0


def test_driver_tune_mode_measure_populates_cache(cache_file, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _workload(tmp_path, steps=3)
    monkeypatch.setattr(runner, "default_trial_steps", lambda kind: (2, 1))
    result = driver.run(RunConfig(backend="tuned", tune_mode="measure", device="cpu"))
    assert result.steps_run == 3 and autotune.trial_count() > 0
    key = autotune.tune_key_for(get_rule("conway"), (64, 64), device="cpu")
    assert cache.get(key) is not None
    autotune.reset_trial_count()
    result2 = driver.run(RunConfig(backend="tuned", output_file="out2.txt", device="cpu"))
    assert autotune.trial_count() == 0
    np.testing.assert_array_equal(result.board, result2.board)


@pytest.mark.parametrize("pins,want_route", [
    (dict(block_steps=2), "k3"),
    (dict(local_kernel="torch"), "shard_ops"),
    (dict(bitpack=False), "k4"),
])
def test_driver_explicit_flags_beat_the_cache(cache_file, tmp_path, monkeypatch, pins,
                                              want_route):
    monkeypatch.chdir(tmp_path)
    board = _workload(tmp_path, shape=(40, 56), steps=4, seed=5)
    key = autotune.tune_key_for(get_rule("conway"), (40, 56), device="cpu")
    cache.put(key, TunedConfig("sharded", 32, "cuda"), source="measured")
    result = driver.run(RunConfig(backend="tuned", output_file=None, device="cpu", **pins))
    assert (result.backend, result.route) == ("sharded", want_route)
    assert autotune.trial_count() == 0
    np.testing.assert_array_equal(result.board, run_np(board, get_rule("conway"), 4))


def test_driver_tuned_sync_every_and_stencil_apply_when_unset(cache_file, tmp_path,
                                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    board = _workload(tmp_path, shape=(30, 30), steps=7, seed=6)
    rule = get_rule("bugs")
    key = autotune.tune_key_for(rule, (30, 30), device="cpu")
    cache.put(key, TunedConfig("torch", None, "auto", False, 3, "matmul"), source="measured")
    result = driver.run(RunConfig(backend="tuned", rule="bugs", output_file=None,
                                  device="cpu", metrics=True))
    assert [m["step"] for m in result.metrics] == [3, 6, 7]
    np.testing.assert_array_equal(result.board, run_np(board, rule, 7))
    result = driver.run(RunConfig(backend="tuned", rule="bugs", output_file=None,
                                  device="cpu", metrics=True, sync_every=5))
    assert [m["step"] for m in result.metrics] == [5, 7]


def test_driver_tuned_refuses_a_mesh_shape_on_a_non_sharded_pick(cache_file, tmp_path,
                                                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    _workload(tmp_path)
    key = autotune.tune_key_for(get_rule("conway"), (64, 64), device="cpu")
    cache.put(key, TunedConfig("torch"), source="measured")
    with pytest.raises(ValueError, match="--mesh-shape requires the sharded backend"):
        driver.run(RunConfig(backend="tuned", device="cpu", mesh_shape=(2, 2)))
    cache.put(key, TunedConfig("sharded", 4, "torch"), source="measured")
    assert driver.run(RunConfig(backend="tuned", device="cpu", mesh_shape=(2, 2),
                                output_file=None)).backend == "sharded"


def test_run_config_rejects_bad_tune_mode(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _workload(tmp_path, shape=(8, 8), steps=1)
    with pytest.raises(ValueError, match="tune_mode"):
        driver.run(RunConfig(backend="tuned", tune_mode="sometimes", device="cpu"))
    with pytest.raises(ValueError, match="tune_mode"):
        driver.run(RunConfig(backend="numpy", tune_mode="sometimes"))
    with pytest.raises(SystemExit) as e:
        cli.main(["run", "--backend", "tuned", "--tune-mode", "sometimes", "--device", "cpu"])
    assert e.value.code == 2
    assert "invalid choice: 'sometimes'" in capsys.readouterr().err
    assert RunConfig().tune_mode == "cache"


def test_tuned_run_of_a_stochastic_rule_is_refused_as_jax_refuses_it(cache_file, tmp_path,
                                                                      monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _workload(tmp_path, shape=(16, 16), steps=2)
    args = ["run", "--backend", "tuned", "--rule", "ising", "--temperature", "2.0"]
    assert cli.main([*args, "--device", "cpu"]) == 2
    assert "needs the cuda, torch or numpy backend" in capsys.readouterr().err
    # the JAX gate raises a ValueError of the same words (its executor names)
    with pytest.raises(ValueError, match="counter-based per-cell key schedule"):
        jcli.main(args)


# --- bench --backend tuned ---------------------------------------------------


@pytest.mark.parametrize("cached", [False, True], ids=["cost_model", "cache"])
def test_bench_tuned_record_carries_tuned_and_its_source(cache_file, capsys, monkeypatch,
                                                         cached):
    from tpu_life.backends import base as jbase
    from tpu_life_torch.backends import base

    monkeypatch.setattr(base, "measure_throughput", lambda *a, **k: (1.0, 1))
    monkeypatch.setattr(jbase, "measure_throughput", lambda *a, **k: (1.0, 1))
    if cached:
        key = autotune.tune_key_for(get_rule("conway"), (40, 40), device="cpu")
        cache.put(key, TunedConfig("sharded", 4, "torch"), source="measured")
        jkey = jspace.tune_key_for(jrules.get_rule("conway"), (40, 40))
        jcache.put(jkey, jspace.TunedConfig("sharded", 4, "xla"), source="measured")
    flags = ["bench", "--backend", "tuned", "--size", "40", "--steps", "4", "--base-steps", "2"]
    assert cli.main([*flags, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.main(flags) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) and set(got["tuned"]) == set(want["tuned"])
    assert got["tuned_source"] == want["tuned_source"] == ("cache" if cached else "cost_model")
    if cached:
        assert got["tuned"] == port_config(jspace.TunedConfig.from_dict(want["tuned"])).to_dict()
        assert got["backend"] == "sharded"
    assert autotune.trial_count() == 0


# --- the device probe --------------------------------------------------------


@pytest.fixture
def hanging_card(monkeypatch):
    release = threading.Event()

    def hang():
        release.wait(30)
        return False

    monkeypatch.setattr(torch.cuda, "is_available", hang)
    monkeypatch.setenv("TPU_LIFE_DEVICE_TIMEOUT_S", "0.2")
    yield
    release.set()


def test_a_hanging_query_raises_timeout(hanging_card):
    from tpu_life_torch.utils.platform import devices_with_watchdog

    with pytest.raises(TimeoutError, match="--device cpu"):
        devices_with_watchdog()


@pytest.mark.parametrize("argv", [
    ["run"], ["bench"], ["tune", "--dry-run"], ["serve"],
    ["sweep", "--size", "8", "--steps", "1", "--temps", "2.0"],
], ids=["run", "bench", "tune", "serve", "sweep"])
def test_the_cli_exits_2_when_the_query_hangs(hanging_card, argv, capsys, tmp_path,
                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert "CUDA device query hung" in err and "TPU plugin" not in err


def test_device_cpu_skips_the_probe(hanging_card, cache_file, capsys):
    assert cli.main(["tune", "--device", "cpu", "--size", "64", "--dry-run"]) == 0
    capsys.readouterr()


def test_the_probe_never_turns_a_card_run_into_a_cpu_run(monkeypatch, tmp_path):
    from tpu_life_torch.backends.base import CudaUnavailableError
    from tpu_life_torch.utils.platform import devices_with_watchdog

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert devices_with_watchdog() == 0
    monkeypatch.chdir(tmp_path)
    _workload(tmp_path, shape=(8, 8), steps=1)
    with pytest.raises(CudaUnavailableError, match="--device cpu"):
        cli.main(["run"])
    assert not (tmp_path / "output.txt").exists()


def test_public_signatures_follow_the_jax_package():
    import inspect

    for name in ("resolve", "tune"):
        assert inspect.signature(getattr(autotune, name)) == inspect.signature(
            getattr(jautotune, name)), name
    for mod, jmod, names in ((cache, jcache, ["cache_path", "load", "get", "put", "invalidate"]),
                             (runner, jautotune.runner, ["run_trials", "best_result"]),
                             (cost_model, jcost_model, ["estimate_cost", "choose"])):
        for name in names:
            assert inspect.signature(getattr(mod, name)) == inspect.signature(
                getattr(jmod, name)), name
    assert [f.name for f in dataclasses.fields(TuneKey)] == [
        f.name for f in dataclasses.fields(jspace.TuneKey)]
    assert [f.name for f in dataclasses.fields(autotune.TuneResult)] == [
        f.name for f in dataclasses.fields(jautotune.TuneResult)]
