"""``gen``, ``pattern`` and the RLE codec of the port against the JAX
package: ``python -m tpu_life_torch gen|pattern …`` writes the bytes and
prints the lines of ``python -m tpu_life gen|pattern …``, and the port's
``io.rle`` passes the cases of ``tests/test_rle.py``.  Boards come from
``np.random.default_rng``; every comparison is exact."""

import numpy as np
import pytest

from tpu_life import cli as jcli
from tpu_life.io import rle as jrle
from tpu_life_torch import cli
from tpu_life_torch.io.codec import read_board, write_board, write_config
from tpu_life_torch.io.rle import emit_rle, parse_rle
from tpu_life_torch.models import patterns
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops.reference import run_np

GLIDER_RLE = """\
#C This is a glider.
x = 3, y = 3, rule = B3/S23
bob$2bo$3o!
"""

LWSS_RLE = """\
x = 5, y = 4, rule = B3/S23
bo2bo$o4b$o3bo$4o!
"""


def _both(tmp_path, capsys, args, files=("data.txt", "grid_size_data.txt")):
    """Run ``args`` through both CLIs, each in its own directory; return
    (their stdout, their files' bytes) after checking that both agree."""
    out = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        rel = [a.replace("@", str(d) + "/") for a in args]
        assert main(rel) == 0
        stdout = capsys.readouterr().out.replace(str(d) + "/", "@")
        out[name] = (stdout, {f: (d / f).read_bytes() for f in files})
    assert out["port"] == out["jax"]
    return out["port"]


@pytest.mark.parametrize(
    "flags",
    [
        ["--height", "1500", "--width", "500", "--seed", "3"],
        ["--height", "37", "--width", "41", "--states", "3", "--seed", "5", "--steps", "12"],
        ["--height", "20", "--width", "64", "--states", "10", "--density", "0.3"],
        ["--height", "1", "--width", "1", "--density", "1.0"],
        ["--height", "9", "--width", "33", "--density", "0.0", "--seed", "4"],
    ],
    ids=["reference_shape", "states_3", "states_10", "one_cell", "empty"],
)
def test_gen_writes_the_jax_bytes(tmp_path, capsys, flags):
    args = ["gen", *flags, "--input-file", "@data.txt", "--config-file", "@grid_size_data.txt"]
    stdout, files = _both(tmp_path, capsys, args)
    assert stdout.startswith("wrote @data.txt (")
    h, w = int(flags[1]), int(flags[3])
    assert len(files["data.txt"]) == h * (w + 1)


def test_gen_refuses_a_negative_seed_alike(tmp_path):
    # numpy's Generator takes no negative seed, in either package
    for main in (jcli.main, cli.main):
        with pytest.raises(ValueError, match="non-negative"):
            main(["gen", "--height", "4", "--width", "4", "--seed", "-4",
                  "--input-file", str(tmp_path / "d.txt"), "--config-file", str(tmp_path / "g.txt")])
    assert not (tmp_path / "d.txt").exists()


def test_gen_then_run_equals_the_numpy_oracle(tmp_path):
    files = ["--input-file", str(tmp_path / "data.txt"),
             "--config-file", str(tmp_path / "grid_size_data.txt")]
    assert cli.main(["gen", "--height", "30", "--width", "45", "--states", "3",
                     "--steps", "7", "--seed", "2", *files]) == 0
    assert cli.main(["run", *files, "--rule", "brians_brain", "--device", "cpu",
                     "--output-file", str(tmp_path / "out.txt")]) == 0
    board = read_board(tmp_path / "data.txt", 30, 45)
    np.testing.assert_array_equal(
        read_board(tmp_path / "out.txt", 30, 45), run_np(board, get_rule("brians_brain"), 7)
    )


def test_pattern_list_prints_the_jax_lines(tmp_path, capsys):
    stdout, _ = _both(tmp_path, capsys, ["pattern", "list"], files=())
    assert "glider  3x3" in stdout.splitlines()
    assert "gosper_glider_gun  9x36" in stdout.splitlines()


@pytest.mark.parametrize(
    "flags",
    [
        ["--name", "glider"],
        ["--name", "gosper_glider_gun", "--height", "64", "--width", "80"],
        ["--name", "GLIDER", "--height", "12", "--width", "12", "--at", "2,3", "--steps", "4"],
        ["--name", "pulsar", "--height", "20", "--width", "15", "--at", "0,2"],
        ["--rle", "@g.rle"],
        ["--rle", "@g.rle", "--height", "10", "--width", "11", "--at", "7,8"],
        ["--rle", "@bb.rle", "--height", "16", "--width", "16", "--steps", "3"],
    ],
    ids=["named", "gun", "at", "pulsar_at", "rle", "rle_at", "rle_multistate"],
)
def test_pattern_import_writes_the_jax_bytes(tmp_path, capsys, flags):
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "g.rle").write_text(GLIDER_RLE)
        (tmp_path / name / "bb.rle").write_text("x = 4, y = 3, rule = B2/S/C3\n.AA.$A..A$.BB.!\n")
    args = ["pattern", "import", *flags, "--input-file", "@data.txt",
            "--config-file", "@grid_size_data.txt"]
    stdout, _ = _both(tmp_path, capsys, args)
    assert stdout.splitlines()[-1].startswith("wrote @data.txt (")


@pytest.mark.parametrize(
    "flags",
    [
        [],
        ["--rule", "B36/S23"],
        ["--rule", "brians_brain"],
        ["--rule", "not a rule"],
        ["--height", "8"],
    ],
    ids=["default_rule", "highlife", "multistate_rule", "unknown_rule", "partial_dims"],
)
def test_pattern_export_writes_the_jax_bytes(tmp_path, capsys, flags):
    board = np.zeros((8, 16), np.int8)
    board[1:4, 2:5] = patterns.GLIDER
    board[5, 10:13] = 2  # a dying Generations state
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        write_board(tmp_path / name / "data.txt", board)
        write_config(tmp_path / name / "grid_size_data.txt", 99 if "--height" in flags else 8, 16, 10)
    args = ["pattern", "export", *flags, "--input-file", "@data.txt",
            "--config-file", "@grid_size_data.txt", "--rle", "@out.rle"]
    _, files = _both(tmp_path, capsys, args, files=("out.rle",))
    back, _ = parse_rle(files["out.rle"].decode())
    np.testing.assert_array_equal(back, board)


def test_pattern_export_to_stdout_equals_jax(tmp_path, capsys):
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        write_board(tmp_path / name / "data.txt", patterns.place(patterns.empty(6, 7), patterns.TOAD, 2, 1))
        write_config(tmp_path / name / "grid_size_data.txt", 6, 7, 1)
    args = ["pattern", "export", "--input-file", "@data.txt", "--config-file", "@grid_size_data.txt"]
    stdout, _ = _both(tmp_path, capsys, args, files=())
    assert stdout.endswith("!\n")


@pytest.mark.parametrize(
    "flags,files",
    [
        (["--name", "glider", "--rle", "g.rle"], {"g.rle": GLIDER_RLE}),
        ([], {}),
        (["--name", "no_such_pattern"], {}),
        (["--name", "glider", "--at", "2;3"], {}),
        (["--name", "glider", "--height", "3", "--width", "3", "--at", "1,1"], {}),
        (["--rle", "k.rle"], {"k.rle": "x = 1, y = 1\nK!\n"}),  # state 11
    ],
    ids=["both", "neither", "unknown", "bad_at", "does_not_fit", "states_past_codec"],
)
def test_pattern_import_refuses_alike(tmp_path, monkeypatch, flags, files):
    monkeypatch.chdir(tmp_path)
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(["pattern", "import", *flags])
        assert e.value.code == 2
    assert not (tmp_path / "data.txt").exists()


def test_cli_pattern_import_evolve_export(tmp_path, monkeypatch):
    # import a glider, run 4 steps (the glider moves by (+1, +1)), export,
    # and the exported RLE parses back to the moved pattern
    monkeypatch.chdir(tmp_path)
    assert cli.main(["pattern", "import", "--name", "glider", "--height", "12",
                     "--width", "12", "--at", "2,3", "--steps", "4"]) == 0
    board = read_board("data.txt", 12, 12)
    np.testing.assert_array_equal(board, patterns.place(patterns.empty(12, 12), patterns.GLIDER, 2, 3))
    assert cli.main(["run", "--device", "cpu"]) == 0
    evolved = read_board("output.txt", 12, 12)
    np.testing.assert_array_equal(evolved, run_np(board, get_rule("conway"), 4))
    np.testing.assert_array_equal(evolved, patterns.place(patterns.empty(12, 12), patterns.GLIDER, 3, 4))
    assert cli.main(["pattern", "export", "--input-file", "output.txt", "--rle", "out.rle"]) == 0
    back, _ = parse_rle((tmp_path / "out.rle").read_text())
    np.testing.assert_array_equal(back, evolved)


# -- the cases of tests/test_rle.py on the port's codec ------------------------


def test_parse_canonical_glider():
    board, meta = parse_rle(GLIDER_RLE)
    np.testing.assert_array_equal(board, patterns.GLIDER)
    assert meta["rule"] == "B3/S23"
    assert meta["comments"] == ["C This is a glider."]


def test_parse_canonical_lwss():
    board, _ = parse_rle(LWSS_RLE)
    np.testing.assert_array_equal(board[::-1, ::-1], patterns.LWSS)


def test_parse_row_advance_counts_and_padding():
    board, _ = parse_rle("x = 4, y = 5\no3$2o!\n")
    expect = np.zeros((5, 4), np.int8)
    expect[0, 0] = 1
    expect[3, 0] = expect[3, 1] = 1
    np.testing.assert_array_equal(board, expect)


def test_parse_without_header_uses_bounding_box():
    board, meta = parse_rle("2o$bo!")
    np.testing.assert_array_equal(board, [[1, 1], [0, 1]])
    assert meta["rule"] is None


@pytest.mark.parametrize(
    "text,match",
    [("x = 2, y = 1\npA!", "unsupported RLE token"),
     ("x = 2, y = 1\n3o!", "exceeds its declared extent"),
     ("x = nope, y = 3\no!", "malformed RLE header")],
)
def test_parse_rejects_alike(text, match):
    with pytest.raises(ValueError, match=match) as got:
        parse_rle(text)
    with pytest.raises(ValueError) as want:
        jrle.parse_rle(text)
    assert str(got.value) == str(want.value)


def test_parse_multistate_alphabet():
    board, _ = parse_rle("x = 2, y = 2, rule = B2/S/C3\n.A$B.!")
    np.testing.assert_array_equal(board, [[0, 1], [2, 0]])


def test_headerless_body_starting_with_X_is_not_a_header():
    board, _ = parse_rle("X!")
    np.testing.assert_array_equal(board, [[24]])


def test_parse_header_keeps_comma_delimited_ltl_rule():
    _, meta = parse_rle("x = 3, y = 1, rule = R5,C2,S34..58,B34..45\n3o!\n")
    assert meta["rule"] == "R5,C2,S34..58,B34..45"


def test_zero_extent_round_trip():
    for shape in [(0, 3), (0, 0)]:
        back, _ = parse_rle(emit_rle(np.zeros(shape, np.int8)))
        assert back.shape == shape


@pytest.mark.parametrize(
    "h,w,density,states",
    [(1, 1, 1.0, 2), (7, 13, 0.4, 2), (40, 200, 0.5, 2), (17, 40, 0.6, 4), (5, 90, 0.9, 10)],
)
def test_emit_and_parse_equal_jax(h, w, density, states):
    rng = np.random.default_rng(h * w)
    alive = rng.random((h, w)) < density
    board = np.where(alive, rng.integers(1, states, size=(h, w)), 0).astype(np.int8)
    rule = "B3/S23" if states == 2 else f"B2/S/C{states}"
    text = emit_rle(board, rule=rule, states=states)
    assert text == jrle.emit_rle(board, rule=rule, states=states)
    back, meta = parse_rle(text)
    np.testing.assert_array_equal(back, board)
    want, want_meta = jrle.parse_rle(text)
    np.testing.assert_array_equal(back, want)
    assert meta == want_meta
    assert all(len(line) <= 70 for line in text.splitlines())


def test_emit_drops_trailing_dead_rows_and_collapses_blanks():
    board = np.zeros((6, 3), np.int8)
    board[0, 0] = 1
    board[3, 2] = 1
    text = emit_rle(board, rule=None, comments=("a", "b"))
    assert text == jrle.emit_rle(board, rule=None, comments=("a", "b"))
    assert text.splitlines()[-1] == "o3$2bo!"


def test_emit_rejects_states_beyond_alphabet():
    assert "B" in emit_rle(np.full((2, 2), 2, np.int8))
    with pytest.raises(ValueError, match="states up to 24"):
        emit_rle(np.full((2, 2), 25, np.int8))


def test_named_patterns_equal_jax():
    from tpu_life.models import patterns as jpatterns

    names = sorted(n for n in dir(jpatterns) if n.isupper() and isinstance(getattr(jpatterns, n), np.ndarray))
    assert names == sorted(
        n for n in dir(patterns) if n.isupper() and isinstance(getattr(patterns, n), np.ndarray)
    )
    for n in names:
        np.testing.assert_array_equal(getattr(patterns, n), getattr(jpatterns, n))
