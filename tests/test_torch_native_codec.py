"""The port's native board codec (``csrc/codec.cpp`` through ``io/native.py``)
held to the JAX package's codec and streamed I/O and to the port's own
numpy path, byte for byte, on both sides of ``_NATIVE_THRESHOLD`` cells.

Boards come from ``np.random.default_rng``; the native library is built
here with g++ at first use into ``tpu_life_torch/_build/``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpu_life.io import codec as jcodec
from tpu_life.io import sharded as jsharded
from tpu_life_torch.io import codec, native
from tpu_life_torch.io import sharded as io_sharded
from tpu_life_torch.kernels import _build
from tpu_life_torch.utils import nativelib

T = codec._NATIVE_THRESHOLD
# 1024^2 = 2^20 (at the threshold), 1500x700 above it, 2^20 - 1 below it
# (1023 x 1025) and 2^20 + 1 above it (17 x 61681)
SHAPES = [(1024, 1024), (1500, 700), (1023, 1025), (17, 61681)]


def _board(shape, states=10):
    return np.random.default_rng(shape[0] * 7 + shape[1]).integers(
        0, states, size=shape, dtype=np.int8
    )


@pytest.fixture
def spy(monkeypatch):
    """Counts the native entry points the port's codec reaches."""
    calls = []
    for name in ("decode_board", "encode_array", "read_stripe", "read_block",
                 "write_block", "write_stripe"):
        real = getattr(native, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(native, name, wrapped)
    return calls


def test_the_codec_builds_here_with_gxx():
    assert native.build() is True
    lib = nativelib.build(native.SOURCE)
    assert lib.parent.parent == _build.BUILD_ROOT and lib.name == "libcodec.so"
    assert native.SOURCE == _build.CSRC / "codec.cpp"


def test_thresholds_and_threads_are_the_jax_packages():
    assert T == jcodec._NATIVE_THRESHOLD == 1 << 20
    from tpu_life.utils import nativelib as jnativelib

    assert nativelib.default_threads() == jnativelib.default_threads()
    from tpu_life.io import native as jnative

    assert native._ERRORS == jnative._ERRORS


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_and_encode_equal_the_jax_codec_and_numpy(shape, spy, monkeypatch):
    board = _board(shape)
    raw = codec.encode_board(board)
    assert raw == jcodec.encode_board(board)
    for buf in (raw, bytearray(raw), memoryview(raw)):
        np.testing.assert_array_equal(codec.decode_board(buf, *shape), board)
    native_calls = list(spy)
    monkeypatch.setenv("TPU_LIFE_NATIVE", "0")
    assert codec.encode_board(board) == raw
    np.testing.assert_array_equal(codec.decode_board(raw, *shape), board)
    assert spy == native_calls  # the switch kept the native codec out
    big = shape[0] * shape[1] >= T
    assert native_calls == (["encode_array", "decode_board", "decode_board", "decode_board"]
                            if big else [])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_write_board_writes_the_encoded_bytes(shape, tmp_path):
    board = _board(shape)
    codec.write_board(tmp_path / "p.txt", board)
    jcodec.write_board(tmp_path / "j.txt", board)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    np.testing.assert_array_equal(codec.read_board(tmp_path / "p.txt", *shape), board)
    f = board.astype(np.float32) / 9
    codec.write_board(tmp_path / "f.bin", f)
    assert (tmp_path / "f.bin").read_bytes() == jcodec.encode_board(f)


def _malformed(shape, kind):
    raw = bytearray(codec.encode_board(_board(shape, 2)))
    w = shape[1]
    if kind == "bad byte":
        raw[5] = ord("a")
    elif kind == "missing newline":
        raw[(w + 1) * (shape[0] // 2) + w] = ord("0")
    else:
        del raw[-1]
    return bytes(raw)


@pytest.mark.parametrize("shape", [(1023, 1025), (1024, 1024), (17, 61681)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["bad byte", "missing newline", "wrong length"])
def test_malformed_buffers_raise_alike(shape, kind):
    raw = _malformed(shape, kind)
    with pytest.raises(ValueError) as want:
        jcodec.decode_board(raw, *shape)
    with pytest.raises(ValueError) as got:
        codec.decode_board(raw, *shape)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
    native_side = shape[0] * shape[1] >= T and kind != "wrong length"
    assert str(got.value).startswith("native decode failed") == native_side


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_streamed_reads_and_writes_equal_the_jax_module(shape, tmp_path, spy):
    h, w = shape
    board = _board(shape)
    path = tmp_path / "board.txt"
    codec.write_board(path, board)
    rows = h // 2 + 1
    np.testing.assert_array_equal(
        io_sharded.read_stripe(path, 0, h, w), jsharded.read_stripe(path, 0, h, w))
    np.testing.assert_array_equal(
        io_sharded.read_stripe(path, h - rows, rows, w), board[h - rows:])
    c0, nc = w // 3, w - w // 3
    np.testing.assert_array_equal(
        io_sharded.read_block(path, 0, h, c0, nc, w), jsharded.read_block(path, 0, h, c0, nc, w))
    # blocks written in two halves of columns and two halves of rows
    for mod, name in ((io_sharded, "p.txt"), (jsharded, "j.txt")):
        out = tmp_path / name
        mod.write_block(out, 0, 0, board[:, :c0], total_rows=h, total_cols=w)
        mod.write_block(out, 0, c0, board[:, c0:], total_rows=h, total_cols=w)
        out2 = tmp_path / ("s" + name)
        mod.write_stripe(out2, 0, board[:rows], total_rows=h)
        mod.write_stripe(out2, rows, board[rows:], total_rows=h)
    for name in ("p.txt", "sp.txt"):
        assert (tmp_path / name).read_bytes() == path.read_bytes()
    assert (tmp_path / "j.txt").read_bytes() == path.read_bytes()
    assert (tmp_path / "sj.txt").read_bytes() == path.read_bytes()
    # each call goes native exactly where its own block reaches the threshold
    sizes = [("encode_array", h * w), ("read_stripe", h * w), ("read_stripe", rows * w),
             ("read_block", h * nc), ("write_block", h * c0), ("write_block", h * nc),
             ("write_stripe", rows * w), ("write_stripe", (h - rows) * w)]
    assert spy == [name for name, cells in sizes if cells >= T]


def test_streamed_bytes_equal_on_the_numpy_path(tmp_path, monkeypatch):
    h, w = 1024, 1024
    board = _board((h, w))
    path = tmp_path / "board.txt"
    codec.write_board(path, board)
    want = io_sharded.read_block(path, 3, h - 3, 7, w - 7, w)
    monkeypatch.setenv("TPU_LIFE_NATIVE", "0")
    np.testing.assert_array_equal(io_sharded.read_block(path, 3, h - 3, 7, w - 7, w), want)
    io_sharded.write_block(tmp_path / "o.txt", 0, 0, board[:, :500], total_rows=h,
                           total_cols=w)
    monkeypatch.delenv("TPU_LIFE_NATIVE")
    io_sharded.write_block(tmp_path / "o.txt", 0, 500, board[:, 500:], total_rows=h,
                           total_cols=w)
    assert (tmp_path / "o.txt").read_bytes() == path.read_bytes()


def test_native_write_past_the_board_raises_as_python_does(tmp_path):
    board = _board((1024, 1024), 2)
    for mod in (io_sharded, jsharded):
        with pytest.raises(ValueError, match="outside board height"):
            mod.write_block(tmp_path / "x.txt", 1, 0, board, total_rows=1024, total_cols=1024)
    with pytest.raises(ValueError, match="native read_stripe failed: I/O error"):
        io_sharded.read_stripe(tmp_path / "absent.txt", 0, 1024, 1024)


def test_a_build_without_gxx_raises_never_a_silent_numpy_run(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    nativelib.library.cache_clear()
    try:
        board = _board((1024, 1024), 2)
        buf = jcodec.encode_board(board)
        with pytest.raises(nativelib.NativeBuildError, match="g\\+\\+ not found"):
            codec.decode_board(buf, 1024, 1024)
        with pytest.raises(nativelib.NativeBuildError):
            codec.encode_board(board)
        with pytest.raises(nativelib.NativeBuildError):
            native.build()
        # the one explicit switch onto the numpy codec
        monkeypatch.setenv("TPU_LIFE_NATIVE", "0")
        np.testing.assert_array_equal(codec.decode_board(buf, 1024, 1024), board)
        assert native.build() is False
        # below the threshold the numpy path never needs the library
        monkeypatch.delenv("TPU_LIFE_NATIVE")
        small = _board((8, 8), 2)
        assert codec.encode_board(small) == jcodec.encode_board(small)
    finally:
        nativelib.library.cache_clear()


def test_a_failed_compile_raises_with_the_compilers_message(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(nativelib.NativeBuildError, match="g\\+\\+ failed on broken.cpp"):
        nativelib.build(src)
    assert list((tmp_path / "build").rglob("*.so")) == []


def test_processes_building_at_once_publish_one_library(tmp_path):
    # the xdist workers may build the codec at the same moment: each writes
    # its own temporary file and publishes by an atomic rename
    code = (
        "import sys; from pathlib import Path\n"
        "from tpu_life_torch.kernels import _build\n"
        "from tpu_life_torch.utils import nativelib\n"
        f"_build.BUILD_ROOT = Path({str(tmp_path / 'build')!r})\n"
        "from tpu_life_torch.io import native\n"
        "lib = nativelib.library(native.SOURCE, native._INT_FUNCTIONS)\n"
        "import numpy as np\n"
        "b = np.ones((2, 3), np.int8)\n"
        "print(native.encode_array(b).tobytes() == b'111\\n111\\n')\n"
    )
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
                              cwd=root, env=env)
             for _ in range(4)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert outs == ["True"] * 4 and all(p.returncode == 0 for p in procs)
    libs = list((tmp_path / "build").rglob("*.so"))
    assert [p.name for p in libs] == ["libcodec.so"]
