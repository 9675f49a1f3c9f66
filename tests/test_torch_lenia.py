"""The continuous (Lenia) tier of the port (``tpu_life_torch/models/lenia.py``)
against ``tpu_life.models.lenia`` on the CPU: the spec grammar, the kernel
to the bit, the known-answer vectors (``tests/fixtures/lenia_kat.json``),
the torch roll and matmul steps (``allclose`` at ``FLOAT_ATOL`` to the JAX
steps and the numpy oracle), the numpy executor (byte-equal to the JAX
package's ``run_np``), the float codec, snapshots and ``--resume`` across
the two packages, the typed rejections, ``auto``'s routing, the CLI, the
sharded torus and ``bench``.  Boards come from the seeded stream or
``np.random.default_rng``."""

import base64
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_life import cli as jcli
from tpu_life.io import codec as jcodec
from tpu_life.models import lenia as jlenia
from tpu_life.models.rules import get_rule as jget_rule
from tpu_life.runtime import checkpoint as jckpt
from tpu_life_torch import cli, interop
from tpu_life_torch.backends.base import CudaUnavailableError, get_backend, make_runner
from tpu_life_torch.config import RunConfig
from tpu_life_torch.io import codec
from tpu_life_torch.models import lenia
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.runtime import checkpoint as ckpt
from tpu_life_torch.runtime import driver

FIXTURES = Path(__file__).parent / "fixtures"
ATOL = lenia.FLOAT_ATOL
SPECS = ["lenia", "lenia:orbium", "lenia:mini", "lenia:R5,m0.2,s0.03,dt0.2,b1;0.7", "lenia:mini:T",
         "lenia:T", "lenia:R3,m0.12,s0.05"]


def _kat_cases():
    with open(FIXTURES / "lenia_kat.json") as f:
        return json.load(f)["cases"]


def _kat_boards(case):
    h, w = case["height"], case["width"]
    board = codec.decode_board(base64.b64decode(case["board_b64"]), h, w)
    expected = codec.decode_board(base64.b64decode(case["expected_b64"]), h, w)
    return board, expected


def _fields(rule):
    return {f: getattr(rule, f) for f in ("name", "radius", "mu", "sigma", "dt", "peaks", "boundary",
                                          "birth", "survive", "states", "include_center",
                                          "neighborhood")}


# -- the spec grammar ------------------------------------------------------------
@pytest.mark.parametrize("spec", SPECS)
def test_specs_parse_alike(spec):
    got, want = get_rule(spec), jget_rule(spec)
    assert isinstance(got, lenia.LeniaRule)
    assert _fields(got) == _fields(want)
    assert got.continuous and not got.stochastic and got.board_dtype == "float32"
    assert hash(got) == hash(get_rule(spec))


@pytest.mark.parametrize(
    "spec",
    ["lenia:nope", "lenia:R0", "lenia:R5,m2", "lenia:R5,s0", "lenia:R5,dt0", "lenia:R5,q3",
     "lenia:R5,R6", "lenia:m0.1", "lenia:R5,b0;0"],
)
def test_malformed_specs_fail_alike(spec):
    with pytest.raises(ValueError):
        jget_rule(spec)
    with pytest.raises(ValueError):
        get_rule(spec)


def test_presets_and_registry_equal_jax():
    assert lenia.PRESETS == jlenia.PRESETS
    assert lenia.FLOAT_ATOL == jlenia.FLOAT_ATOL
    assert get_rule("lenia") == get_rule("lenia:orbium") == get_rule("lenia:T")
    assert not get_rule("conway").continuous and get_rule("conway").board_dtype == "int8"


@pytest.mark.parametrize("spec", SPECS)
def test_kernel_equals_jax_to_the_bit(spec):
    got, want = get_rule(spec).kernel, jget_rule(spec).kernel
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


def test_kernel_is_a_normalized_ring():
    k = get_rule("lenia:mini").kernel
    assert k.shape == (9, 9) and abs(float(k.sum()) - 1.0) < 1e-6
    assert k[4, 4] == 0.0 and (k >= 0).all()


# -- the known-answer vectors ----------------------------------------------------
@pytest.mark.parametrize("case", _kat_cases(), ids=lambda c: f"{c['rule']}@{c['steps']}")
def test_numpy_oracle_matches_kat(case):
    rule = get_rule(case["rule"])
    board, expected = _kat_boards(case)
    staged = lenia.seeded_board(case["height"], case["width"], case["density"], seed=case["seed"])
    assert staged.tobytes() == board.tobytes()
    assert lenia.run_np(board, rule, case["steps"]).tobytes() == expected.tobytes()


@pytest.mark.parametrize("stencil", ["roll", "matmul"])
@pytest.mark.parametrize("case", _kat_cases(), ids=lambda c: f"{c['rule']}@{c['steps']}")
def test_torch_paths_allclose_to_kat(case, stencil):
    rule = get_rule(case["rule"])
    board, expected = _kat_boards(case)
    runner = lenia.LeniaDeviceRunner(board, rule, stencil=stencil, device="cpu")
    runner.advance(case["steps"])
    assert runner.x.dtype == torch.float32
    assert np.allclose(runner.fetch(), expected, atol=ATOL)


@pytest.mark.parametrize("stencil", ["roll", "matmul"])
@pytest.mark.parametrize("spec,boundary", [("lenia:mini", "torus"), ("lenia:mini", "clamped"),
                                           ("lenia:R5,m0.2,s0.03,dt0.2,b1;0.7", "torus")])
def test_torch_step_allclose_to_jax_step(spec, boundary, stencil):
    from dataclasses import replace

    rule = replace(get_rule(spec), boundary=boundary)
    jrule = replace(jget_rule(spec), boundary=boundary)
    board = lenia.seeded_board(23, 30, 0.4, seed=5)
    step = lenia.make_lenia_step(rule, board.shape, stencil)
    jstep = jlenia.make_lenia_step(jnp, jrule, board.shape, stencil)
    x, jx = torch.from_numpy(board), jnp.asarray(board)
    for _ in range(6):
        x, jx = step(x), jstep(jx)
    assert np.allclose(x.numpy(), np.asarray(jx), atol=ATOL)
    assert np.allclose(x.numpy(), jlenia.run_np(board, jrule, 6), atol=ATOL)


@pytest.mark.parametrize("stencil", ["roll", "matmul"])
@pytest.mark.parametrize("boundary", ["torus", "clamped"])
def test_numpy_executor_byte_equal_to_jax(stencil, boundary):
    from dataclasses import replace

    rule = replace(get_rule("lenia:mini"), boundary=boundary)
    jrule = replace(jget_rule("lenia:mini"), boundary=boundary)
    board = lenia.seeded_board(26, 21, seed=8)
    want = jlenia.run_np(board, jrule, 7, stencil)
    assert lenia.run_np(board, rule, 7, stencil).tobytes() == want.tobytes()
    got = get_backend("numpy", stencil=stencil).run(board, rule, 7, chunk_steps=3)
    assert got.tobytes() == want.tobytes()


def test_np_matmul_allclose_to_roll():
    case = _kat_cases()[1]
    rule = get_rule(case["rule"])
    board, _ = _kat_boards(case)
    roll = lenia.run_np(board, rule, case["steps"])
    assert np.allclose(lenia.run_np(board, rule, case["steps"], stencil="matmul"), roll, atol=ATOL)


@pytest.mark.parametrize("shape,density,seed", [((1, 1), 0.5, 0), ((11, 7), 0.3, 9), ((40, 64), 1.0, -3)])
def test_seeded_board_equals_jax(shape, density, seed):
    got = lenia.seeded_board(*shape, density, seed=seed)
    assert got.dtype == np.float32
    assert got.tobytes() == jlenia.seeded_board(*shape, density, seed=seed).tobytes()


# -- the float codec and snapshots -----------------------------------------------
def test_float_codec_round_trip_and_bytes_equal_jax():
    b = lenia.seeded_board(11, 7, seed=9)
    buf = codec.encode_board(b)
    assert len(buf) == 11 * 7 * 4 and buf == jcodec.encode_board(b)
    back = codec.decode_board(buf, 11, 7)
    assert back.dtype == np.float32 and np.array_equal(back, b)
    assert len(codec.encode_board(np.zeros((3, 4), np.int8))) == 3 * 5


def test_float_codec_rejects_nan():
    buf = np.full((2, 2), np.nan, "<f4").tobytes()
    with pytest.raises(ValueError, match="NaN"):
        codec.decode_board(buf, 2, 2)


def test_float_snapshots_byte_equal_across_packages(tmp_path):
    b = lenia.seeded_board(10, 12, seed=1)
    p = ckpt.save_snapshot(tmp_path / "p", 5, b, rule="lenia:mini")
    jckpt.save_snapshot(tmp_path / "j", 5, b, rule="lenia:mini")
    for f in ("board_000000005.txt", "board_000000005.json", "board_000000005.crc"):
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
    assert ckpt.snapshot_intact(p, 10, 12)
    got, step = ckpt.load_resume(tmp_path / "j", 10, 12)
    assert step == 5 and got.tobytes() == b.tobytes()


# -- typed rejection and routing ------------------------------------------------
def test_backends_without_a_float_path_raise():
    rule = get_rule("lenia:mini")
    b = lenia.seeded_board(16, 16)
    for make in (lambda: make_runner(get_backend("cuda", device="cpu"), b, rule),
                 lambda: get_backend("cuda", device="cpu").prepare(b, rule),
                 lambda: get_backend("cuda", device="cpu").run(b, rule, 2)):
        with pytest.raises(ValueError, match="float path"):
            make()


def test_board_validation_typed():
    rule = get_rule("lenia:mini")
    for board, match in ((np.full((8, 8), 1.5, np.float32), r"\[0, 1\]"),
                         (np.full((8, 8), np.nan, np.float32), "finite"),
                         (np.zeros(8, np.float32), "2-D")):
        with pytest.raises(ValueError, match=match):
            lenia.validate_board(board, rule)
        with pytest.raises(ValueError, match=match):
            jlenia.validate_board(board, jget_rule("lenia:mini"))
    out = lenia.validate_board(np.eye(8, dtype=np.int8), rule)
    assert out.dtype == np.float32 and out[0, 0] == 1.0


def test_auto_routes_continuous_rules_to_torch(monkeypatch):
    rule = get_rule("lenia:mini")
    assert get_backend("auto", rule=rule, device="cpu").name == "torch"
    assert get_backend("auto", rule=get_rule("conway"), device="cpu").name == "cuda"
    # the card is the default: no card and no --device cpu raises, never falls back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError):
        get_backend("auto", rule=rule)


@pytest.mark.parametrize("mode,want", [("auto", "matmul"), ("roll", "roll"), ("matmul", "matmul")])
def test_torch_backend_resolves_the_stencil(mode, want):
    runner = make_runner(get_backend("torch", device="cpu", stencil=mode), lenia.seeded_board(12, 12),
                         get_rule("lenia:mini"))
    assert (runner.route, runner.stencil) == ("lenia", want)
    # numpy stays the roll oracle under auto: its runner's bytes are run_np's on that stencil
    b = lenia.seeded_board(12, 12)
    host = make_runner(get_backend("numpy", stencil=mode), b, get_rule("lenia:mini"))
    host.advance(3)
    want = lenia.run_np(b, get_rule("lenia:mini"), 3, "roll" if mode == "auto" else mode)
    assert host.fetch().tobytes() == want.tobytes()
    assert host.live_count() == int((want >= 0.5).sum())


def test_building_a_float_runner_turns_tf32_off():
    # the matmul path builds its conv (ops.conv.make_conv), which pins it
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lenia.LeniaDeviceRunner(lenia.seeded_board(12, 12), get_rule("lenia:mini"), stencil="matmul",
                                device="cpu")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default


def test_runner_snapshot_and_live_count():
    rule = get_rule("lenia:mini")
    b = lenia.seeded_board(20, 20, seed=2)
    runner = make_runner(get_backend("torch", device="cpu"), b, rule)
    runner.advance(2)
    snap = runner.snapshot()
    runner.advance(3)
    assert np.allclose(snap(), lenia.run_np(b, rule, 2), atol=ATOL)
    want = lenia.run_np(b, rule, 5)
    assert np.allclose(runner.fetch(), want, atol=ATOL)
    assert abs(runner.live_count() - int((want >= 0.5).sum())) <= 2


# -- the sharded torus -------------------------------------------------------------
@pytest.mark.parametrize("mesh", [{"num_devices": 2}, {"num_devices": 4}, {"mesh_shape": (2, 2)}],
                         ids=["2", "4", "2x2"])
@pytest.mark.parametrize("stencil", ["roll", "matmul"])
def test_sharded_allclose_to_one_device(mesh, stencil):
    rule = get_rule("lenia:mini")
    b = lenia.seeded_board(32, 36, seed=4)
    backend = get_backend("sharded", device="cpu", stencil=stencil, block_steps=3, **mesh)
    runner = make_runner(backend, b, rule)
    assert runner.route == "shard_ops" and runner.chunks[0].dtype == torch.float32
    runner.advance(4)
    runner.advance(3)
    one = lenia.LeniaDeviceRunner(b, rule, stencil=stencil, device="cpu")
    one.advance(7)
    assert np.allclose(runner.fetch(), one.fetch(), atol=ATOL)
    assert np.allclose(runner.fetch(), lenia.run_np(b, rule, 7), atol=ATOL)


def test_sharded_refusals_name_their_reason():
    b = lenia.seeded_board(32, 32)
    with pytest.raises(ValueError, match="needs the torus boundary"):
        get_backend("sharded", device="cpu", num_devices=2).prepare(
            b, lenia.LeniaRule(name="lenia:c", radius=4, boundary="clamped"))
    with pytest.raises(ValueError, match="no kernel has a float path"):
        get_backend("sharded", device="cpu", num_devices=2, local_kernel="cuda").prepare(
            b, get_rule("lenia:mini"))
    with pytest.raises(ValueError, match="divisible"):
        get_backend("sharded", device="cpu", num_devices=3).prepare(b, get_rule("lenia:mini"))


# -- the CLI and the driver ----------------------------------------------------------
def _cli_lenia(tmp_path, main, out, *extra):
    return main(["run", "--rule", "lenia:mini", "--size", "64", "--steps", "10", "--seed", "1",
                 "--input-file", str(tmp_path / "absent.txt"), "--output-file", str(tmp_path / out),
                 *extra])


def test_cli_numpy_byte_equal_and_torch_allclose_to_jax(tmp_path):
    assert _cli_lenia(tmp_path, jcli.main, "jax.txt", "--backend", "numpy") == 0
    assert _cli_lenia(tmp_path, cli.main, "np.txt", "--backend", "numpy") == 0
    assert _cli_lenia(tmp_path, cli.main, "cpu.txt", "--device", "cpu") == 0
    want = (tmp_path / "jax.txt").read_bytes()
    assert len(want) == 64 * 64 * 4
    assert (tmp_path / "np.txt").read_bytes() == want
    got = codec.read_board(tmp_path / "cpu.txt", 64, 64)
    assert got.dtype == np.float32
    assert np.allclose(got, codec.read_board(tmp_path / "jax.txt", 64, 64), atol=ATOL)


def test_driver_auto_takes_torch_and_stamps_the_seed(tmp_path):
    res = driver.run(RunConfig(height=40, width=40, steps=6, rule="lenia:mini", seed=3, device="cpu",
                               input_file=str(tmp_path / "absent.txt"), output_file="",
                               metrics=True, sync_every=3))
    assert (res.backend, res.route, res.seed) == ("torch", "lenia", 3)
    want = lenia.run_np(lenia.seeded_board(40, 40, seed=3), get_rule("lenia:mini"), 6)
    assert res.board.dtype == np.float32 and np.allclose(res.board, want, atol=ATOL)
    assert [m["step"] for m in res.metrics] == [3, 6]


def test_cli_cuda_backend_refuses_lenia(tmp_path, capsys, monkeypatch):
    import sys

    monkeypatch.setattr(sys, "argv", ["tpu_life_torch", "run", "--backend", "cuda", "--device", "cpu",
                                      "--rule", "lenia:mini", "--size", "32", "--steps", "2",
                                      "--input-file", str(tmp_path / "absent.txt"),
                                      "--output-file", str(tmp_path / "o.txt")])
    assert cli.console_main() == 1
    err = [line for line in capsys.readouterr().err.splitlines() if "error" in line]
    assert len(err) == 1 and "float path" in err[0]
    assert not (tmp_path / "o.txt").exists()


def test_loaded_float_board_is_validated(tmp_path):
    bad = np.full((16, 16), 1.5, np.float32)
    codec.write_board(tmp_path / "data.txt", bad)
    codec.write_config(tmp_path / "grid.txt", 16, 16, 2)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        cli.main(["run", "--rule", "lenia:mini", "--device", "cpu", "--config-file",
                  str(tmp_path / "grid.txt"), "--input-file", str(tmp_path / "data.txt"),
                  "--output-file", str(tmp_path / "o.txt")])


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_resume_of_a_float_snapshot_crosses_the_packages(tmp_path, first, second):
    mains = {"jax": jcli.main, "port": cli.main}
    common = ["--rule", "lenia:mini", "--size", "40", "--steps", "12", "--seed", "6",
              "--backend", "numpy", "--input-file", str(tmp_path / "absent.txt")]
    assert mains["jax"](["run", *common, "--output-file", str(tmp_path / "full.txt")]) == 0
    snaps = tmp_path / "snaps"
    assert mains[first](["run", *common[:5], "8", *common[6:], "--snapshot-every", "4",
                         "--snapshot-dir", str(snaps), "--output-file", str(tmp_path / "eight.txt")]) == 0
    assert mains[second](["run", *common, "--resume", str(snaps),
                          "--output-file", str(tmp_path / "resumed.txt")]) == 0
    assert (tmp_path / "resumed.txt").read_bytes() == (tmp_path / "full.txt").read_bytes()


def test_bench_lenia_prints_a_torch_record(capsys):
    assert cli.main(["bench", "--rule", "lenia:mini", "--size", "32", "--steps", "6",
                     "--base-steps", "2", "--repeats", "1", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["backend"], rec["rule"], rec["platform"], rec["n_chips"]) == ("torch", "lenia:mini", "cpu", 1)
    assert rec["value"] > 0


# -- interop -------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["lenia:orbium", "lenia:R5,m0.2,s0.03,dt0.2,b1;0.7"])
def test_rule_crosses_as_spec_and_fields(spec):
    j = jget_rule(spec)
    got = interop.rule_from_fields(
        j.name, j.birth, j.survive, j.states, j.radius, j.neighborhood, j.boundary, j.include_center,
        mu=j.mu, sigma=j.sigma, dt=j.dt, peaks=j.peaks)
    assert got == get_rule(spec) and got.kernel.tobytes() == j.kernel.tobytes()
    # the spec string alone names the same rule
    assert interop.rule_from_fields(j.name, (), (), radius=j.radius, boundary="torus") == get_rule(spec)


def test_float_board_crosses_as_float32():
    b = lenia.seeded_board(9, 13, seed=2)
    x = interop.board_from_reference(b, (9, 13), layout="cells")
    assert x.dtype == torch.float32 and np.array_equal(interop.board_to_reference(x, (9, 13)), b)
    with pytest.raises(ValueError, match="crosses as cells"):
        interop.board_from_reference(b, (9, 13))
