"""ctypes binding to the port's native host stepper (``csrc/life.cpp``).

The JAX package's ``ops/native_step.py`` over the port's own byte copy of
``native/life.cpp``: a pthread-parallel sliding-window box-sum stencil
driven by the rule's transition LUT, the native CPU counterpart of the
reference's ``countNeighbours``/``updateGrid`` loop.  The library is built
with ``g++`` at first use by :mod:`tpu_life_torch.utils.nativelib` into
``tpu_life_torch/_build/``; nothing under ``native/`` is loaded.  A
library that does not build raises
:class:`~tpu_life_torch.utils.nativelib.NativeBuildError`, and
``TPU_LIFE_NATIVE=0`` turns the stepper off (the backend then refuses to
construct); there is no numpy fallback behind the name ``native``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpu_life_torch.kernels._build import CSRC
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.utils import nativelib

SOURCE = CSRC / "life.cpp"

_INT_FUNCTIONS = ("tl_run",)


def _lib() -> ctypes.CDLL:
    return nativelib.library(SOURCE, _INT_FUNCTIONS)


def available() -> bool:
    """False only when ``TPU_LIFE_NATIVE=0``; otherwise the library is
    built (or a ``NativeBuildError`` raised) here."""
    if nativelib.disabled():
        return False
    _lib()
    return True


def run_native(
    board: np.ndarray, rule: Rule, steps: int, *, threads: int | None = None
) -> np.ndarray:
    """Advance ``board`` ``steps`` generations on the native threaded stepper.

    Returns a new array; the input is not modified.
    """
    if nativelib.disabled():
        raise RuntimeError("native step library disabled by TPU_LIFE_NATIVE=0")
    if rule.neighborhood != "moore" or rule.boundary != "clamped":
        # the C stepper's sliding-window box sum is Moore-only and clamped;
        # erroring beats silently computing the wrong semantics
        raise ValueError(
            "native backend supports clamped Moore neighborhoods only; use "
            "--backend numpy/jax for von Neumann or torus rules"
        )
    out = np.array(board, dtype=np.int8, order="C")  # exactly one fresh copy
    h, w = out.shape
    lut = np.ascontiguousarray(rule.transition_table, dtype=np.int8)
    rc = _lib().tl_run(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_long(h),
        ctypes.c_long(w),
        lut.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int(rule.states),
        ctypes.c_int(rule.max_count),
        ctypes.c_int(rule.radius),
        ctypes.c_int(1 if rule.include_center else 0),
        ctypes.c_long(steps),
        ctypes.c_int(threads or nativelib.default_threads()),
    )
    if rc != 0:
        raise ValueError(f"native step failed: rc={rc}")
    return out
