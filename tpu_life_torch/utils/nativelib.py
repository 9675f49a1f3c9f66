"""Build and load the port's native host library: the board codec.

``tpu_life_torch/csrc/codec.cpp`` is host C++ (the threaded ASCII <-> int8
codec and the stripe and block file I/O), the one ``.cpp`` beside the
``.cu`` kernels of ``csrc/``.  :func:`build` compiles it with ``g++`` and
``native/Makefile``'s flags, once per source and flags, into
``tpu_life_torch/_build/<key>/lib<name>.so`` (git-ignored), and publishes
the library by an atomic rename, so processes that build it at the same
moment never load a torn file.  Nothing under ``native/`` is loaded.

``TPU_LIFE_NATIVE=0`` (the JAX package's switch, so one setting holds for
both) is the one way onto the numpy codec.  With the switch unset, a
missing compiler or a failed build raises :class:`NativeBuildError`; the
codec never falls back to numpy without a word.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from tpu_life_torch.kernels import _build

#: ``native/Makefile``'s CXXFLAGS but its ``-Wall``
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17")


class NativeBuildError(RuntimeError):
    """The native codec could not be built: no ``g++``, or it failed.
    Set ``TPU_LIFE_NATIVE=0`` to run the numpy codec instead."""


def disabled() -> bool:
    return os.environ.get("TPU_LIFE_NATIVE", "1") == "0"


def default_threads() -> int:
    return min(16, os.cpu_count() or 1)


def compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise NativeBuildError(
            "g++ not found: the native codec is built from "
            f"{_build.CSRC / 'codec.cpp'} at first use (TPU_LIFE_NATIVE=0 runs "
            "the numpy codec)"
        )
    return found


def build(source: Path) -> Path:
    """Compile ``source`` (once per source and flags) and return the
    library's path."""
    key = hashlib.sha256(source.read_bytes() + " ".join(CXX_FLAGS).encode())
    out_dir = _build.BUILD_ROOT / key.hexdigest()[:16]
    lib = out_dir / f"lib{source.stem}.so"
    if lib.exists():
        return lib
    cxx = compiler()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{source.stem}.{os.getpid()}.so"
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(source)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed on {source.name}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library(source: Path, int_functions: tuple[str, ...]) -> ctypes.CDLL:
    """The built library of ``source``, loaded once per process, each named
    entry point returning ``int``."""
    lib = ctypes.CDLL(str(build(source)))
    for fn in int_functions:
        getattr(lib, fn).restype = ctypes.c_int
    return lib
