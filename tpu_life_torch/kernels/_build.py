"""Build a kernel of ``tpu_life_torch/csrc`` into a library for ``ctypes``.

Every kernel source is CUDA C++ with a plain C interface.  :func:`build`
compiles one source with ``nvcc`` for ``sm_90a``, once per source and
flags, into ``tpu_life_torch/_build/<key>/lib<name>.so`` (git-ignored),
and keeps nvcc's ``-Xptxas -v`` report beside it in ``build.log``.  A
missing nvcc or a failed build raises :class:`KernelBuildError`; nothing
falls back, and the run driver never retries it.  Builds of
different sources may run at the same time (each writes its own
directory, and a finished library is published by an atomic rename).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_ROOT = PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "--split-compile=0",  # compile a source's kernels on all cores at once
)


class KernelBuildError(RuntimeError):
    """A kernel source could not be built: no nvcc, or nvcc failed.  A
    rebuild fails the same way, so the run driver's recovery loop raises
    it at once instead of spending restarts on it."""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise KernelBuildError(
            "nvcc not found: the port's CUDA kernels are built from "
            f"{CSRC} at first use and need the CUDA toolkit"
        )
    return found


def build(source: Path) -> Path:
    """Compile ``source`` (once per source and flags) and return the
    library's path."""
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / key.hexdigest()[:16]
    lib = out_dir / f"lib{source.stem}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{source.stem}.{os.getpid()}.so"
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True,
        text=True,
    )
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {source.name}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library(source: Path) -> ctypes.CDLL:
    """The built library of ``source``, loaded once per process."""
    return ctypes.CDLL(str(build(source)))
