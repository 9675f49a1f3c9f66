"""Neighbour counts and weighted correlations as banded matmuls.

The counterpart of ``tpu_life/ops/conv.py``:

    conv(X) = sum_i  A_i @ X @ B_i

where each ``A_i`` is a dense ``(h, h)`` band holding one rank-1 factor's
row profile and ``B_i`` a ``(w, w)`` band holding its column profile;
torus bands wrap, clamped bands truncate.  The operators are built once
per (shape, kernel, boundary) on the host by the numpy code copied from
the JAX package (``kernel_factors``, ``band_matrix``, ``band_operators``:
the same float64 SVD, the same exact per-row split of integer kernels, so
the same factors and the same rounding), and moved to the device once.
Each call is then ``2 * len(factors)`` ``torch.matmul`` calls.

For integer rules every factor entry is 0 or 1 and every partial sum a
small integer below 2**24, exact in float32 in any summation order: the
matmul counts are bit-identical to the shift-add (``roll``) counts of
``ops.stencil``.  Weighted (Lenia) kernels agree with the roll path up to
summation order.  Float32 matmuls run in full float32: :func:`make_conv`
turns TF32 off for them.

``resolve_stencil`` routes ``--stencil roll|matmul|auto`` per rule as the
JAX package's does (matmul for continuous rules; the ``numpy`` backend
stays on the roll oracle under ``auto``), with one departure: integer
rules take the matmul path under ``auto`` only at or above a crossover
radius a deployment sets (``CROSSOVER_RADIUS``); by default they keep
``roll``.

The ``*_np`` functions are the numpy versions the oracle runs
(``--backend numpy --stencil matmul``), with the JAX package's numpy
arithmetic.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu_life_torch.models.rules import Rule

#: The ``auto`` crossover: integer rules at or above this radius take the
#: matmul path.  The JAX package's 4 was fitted to a TPU's matrix units and
#: a CPU's BLAS; on an H100 the dense bands lose to the shift-adds at
#: radius 5 (bugs at 8192^2, PERF.md), and no crossover has been measured
#: there, so by default (``None``) integer rules keep ``roll``.  Set one per
#: deployment with ``TPU_LIFE_STENCIL_CROSSOVER`` or pin ``--stencil``.
_CROSSOVER_ENV = os.environ.get("TPU_LIFE_STENCIL_CROSSOVER")
CROSSOVER_RADIUS: int | None = int(_CROSSOVER_ENV) if _CROSSOVER_ENV else None

#: Executor stencil modes (the CLI grammar).
STENCIL_MODES = ("auto", "roll", "matmul")

#: Relative truncation threshold for the SVD factorization of weighted
#: kernels, and the reconstruction bound the factors must meet.
_SVD_RTOL = 1e-6


def validate_stencil(mode: str) -> str:
    if mode not in STENCIL_MODES:
        raise ValueError(
            f"stencil must be one of {'|'.join(STENCIL_MODES)}, got {mode!r}"
        )
    return mode


def resolve_stencil(rule: Rule, mode: str, backend: str = "torch") -> str:
    """The per-rule counting path: ``roll`` or ``matmul``.

    Explicit modes win.  ``auto`` applies the crossover model (matmul for
    continuous rules, and for integer rules with ``radius >=
    CROSSOVER_RADIUS`` where a crossover is set) except on the ``numpy``
    backend, the oracle the matmul path is held to, which stays on roll.
    Stochastic rules have no counting stencil and resolve to roll.
    """
    validate_stencil(mode)
    if getattr(rule, "stochastic", False):
        return "roll"
    if mode != "auto":
        return mode
    if backend == "numpy":
        return "roll"
    if getattr(rule, "continuous", False):
        return "matmul"
    if CROSSOVER_RADIUS is None or rule.radius < CROSSOVER_RADIUS:
        return "roll"
    return "matmul"


# -- kernels ----------------------------------------------------------------
def rule_kernel(rule: Rule) -> np.ndarray:
    """The rule's neighborhood as a float32 ``(2r+1, 2r+1)`` kernel.

    Continuous rules carry their own weighted kernel (``rule.kernel``,
    e.g. the Lenia ring); integer rules get the one-hot Moore box or
    von Neumann diamond, with the center zeroed unless
    ``include_center`` — matching ``neighbor_counts``'s subtraction, so
    the two paths count the identical neighborhood.
    """
    own = getattr(rule, "kernel", None)
    if own is not None:
        return np.asarray(own, np.float32)
    r = rule.radius
    k = 2 * r + 1
    if rule.neighborhood == "von_neumann":
        dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
        kern = (np.abs(dy) + np.abs(dx) <= r).astype(np.float32)
    else:
        kern = np.ones((k, k), np.float32)
    if not rule.include_center:
        kern[r, r] = 0.0
    return kern


def kernel_factors(kernel: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
    """Decompose ``kernel`` into rank-1 ``(u, v)`` pairs with
    ``kernel == sum_i outer(u_i, v_i)`` — verified, never assumed.

    One-hot kernels take exact structural decompositions (a separable
    box is one pair; anything else splits by rows, each row a one-hot
    shift times the row's weights).  Weighted kernels go through a
    float64 SVD truncated at machine precision, with the exact per-row
    split as the fallback when the spectrum does not compress below the
    row count.
    """
    kern = np.asarray(kernel, np.float64)
    if kern.ndim != 2 or kern.shape[0] != kern.shape[1] or kern.shape[0] % 2 != 1:
        raise ValueError(
            f"kernel must be odd-sided square, got shape {kern.shape}"
        )
    scale = float(np.abs(kern).max())
    if scale == 0.0:
        raise ValueError("kernel is all zeros")

    def rows() -> list[tuple[np.ndarray, np.ndarray]]:
        out = []
        for i in range(kern.shape[0]):
            if not np.any(kern[i]):
                continue
            u = np.zeros(kern.shape[0], np.float32)
            u[i] = 1.0
            out.append((u, kern[i].astype(np.float32)))
        return out

    # exact rank-1 (the Moore box, gaussian outer products): u from the
    # heaviest row's support, v the row itself — integer-exact when the
    # kernel is, unlike SVD's sqrt-scaled factors
    i0 = int(np.argmax(np.abs(kern).sum(axis=1)))
    v0 = kern[i0]
    piv = v0[int(np.argmax(np.abs(v0)))]
    if piv != 0.0:
        u0 = kern[:, int(np.argmax(np.abs(v0)))] / piv
        if np.array_equal(np.outer(u0, v0), kern):
            return [(u0.astype(np.float32), v0.astype(np.float32))]
    if np.array_equal(kern, np.rint(kern)):
        # integer kernels carry the bit-identity contract: SVD's
        # sqrt-scaled factors would trade it for a rounding budget —
        # the exact per-row split costs more matmuls, never exactness
        return rows()
    svd_u, svd_s, svd_vt = np.linalg.svd(kern)
    keep = int(np.sum(svd_s > _SVD_RTOL * svd_s[0]))
    if 0 < keep < kern.shape[0]:
        factors = [
            (
                (svd_u[:, i] * svd_s[i]).astype(np.float32),
                svd_vt[i].astype(np.float32),
            )
            for i in range(keep)
        ]
        recon = sum(
            np.outer(u.astype(np.float64), v.astype(np.float64))
            for u, v in factors
        )
        if np.abs(recon - kern).max() <= _SVD_RTOL * scale:
            return factors
    return rows()


def band_matrix(n: int, profile: np.ndarray, boundary: str) -> np.ndarray:
    """The ``(n, n)`` float32 band realizing one 1-D correlation pass:
    ``(M @ x)[i] = sum_d profile[d + r] * x[i + d]``.

    Torus bands wrap (offsets taken mod ``n``, weights of aliased
    offsets summing — the exact periodic correlation even when the
    kernel overhangs the board); clamped bands truncate at the edges
    (the zero-padding semantics of the roll path).
    """
    profile = np.asarray(profile, np.float32)
    r = (len(profile) - 1) // 2
    m = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    for d in range(-r, r + 1):
        w = profile[d + r]
        if w == 0.0:
            continue
        if boundary == "torus":
            m[idx, (idx + d) % n] += w
        else:
            src = idx + d
            ok = (src >= 0) & (src < n)
            m[idx[ok], src[ok]] += w
    return m


def band_operators(
    shape: tuple[int, int], kernel: np.ndarray, boundary: str
) -> list[tuple[np.ndarray, np.ndarray]]:
    """The static per-CompileKey operator pairs: ``(A_i, B_i)`` float32
    arrays with ``conv(X) = sum_i A_i @ X @ B_i``.

    ``A_i = band(h, u_i)`` applies the factor's row profile;
    ``B_i = band(w, v_i).T`` its column profile (the transpose turns
    the row-correlation band into the right-multiplying form).
    """
    h, w = int(shape[0]), int(shape[1])
    return [
        (band_matrix(h, u, boundary), band_matrix(w, v, boundary).T)
        for u, v in kernel_factors(kernel)
    ]


# -- torch ------------------------------------------------------------------
def make_conv(shape: tuple[int, int], kernel: np.ndarray, boundary: str):
    """``conv(x)``: the 2-D correlation of a float32 ``(h, w)`` tensor with
    ``kernel`` as banded matmuls on ``x``'s device.  The operators are
    built here, once, and moved to each device at its first call.

    The matmuls run in full float32: building a conv turns TF32 off for
    cuBLAS, process-wide.  TF32 keeps 10 mantissa bits, about 1e-3
    relative, which would break the float rules' ``allclose`` at 1e-4;
    the flag defaults off, but any ``set_float32_matmul_precision('high')``
    in the process turns it on.  No path of the port reaches cuDNN, whose
    flag is left alone."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 matmul precision "highest"
    host = [
        (torch.from_numpy(a), torch.from_numpy(np.ascontiguousarray(b)))
        for a, b in band_operators(shape, kernel, boundary)
    ]
    on_device: dict[torch.device, list] = {}

    def conv(x: torch.Tensor) -> torch.Tensor:
        ops = on_device.get(x.device)
        if ops is None:
            ops = on_device[x.device] = [(a.to(x.device), b.to(x.device)) for a, b in host]
        out = None
        for a, b in ops:
            t = torch.matmul(torch.matmul(a, x), b)
            out = t if out is None else out + t
        return out

    return conv


def _center_folded(rule: Rule) -> tuple[np.ndarray, bool]:
    """The rule's kernel for counting, with the centre folded in where the
    rule excludes it (the full Moore box is rank 1, the punctured box rank
    2), and whether the centre must be subtracted after."""
    kern = rule_kernel(rule)
    if not getattr(rule, "continuous", False) and not rule.include_center:
        kern = kern.copy()
        kern[rule.radius, rule.radius] += 1.0
        return kern, True
    return kern, False


def make_counts_matmul(rule: Rule, shape: tuple[int, int]):
    """``counts(board) -> int32`` live-neighbour counts of an int8 board by
    banded matmuls: the twin of ``stencil.neighbor_counts``, bit for bit.
    The correlation runs with the centre included and subtracts it after,
    as the JAX package's ``make_counts_matmul`` does."""
    kern, subtract_center = _center_folded(rule)
    conv = make_conv(shape, kern, rule.boundary)

    def counts(board: torch.Tensor) -> torch.Tensor:
        alive = (board == 1).to(torch.float32)
        c = conv(alive).to(torch.int32)
        if subtract_center:
            c = c - alive.to(torch.int32)
        return c

    return counts


# -- numpy (the oracle's matmul path) -----------------------------------------
def make_conv_np(shape: tuple[int, int], kernel: np.ndarray, boundary: str):
    """:func:`make_conv` on the host in numpy, with the JAX package's numpy
    arithmetic (``make_conv(np, ...)``)."""
    ops = band_operators(shape, kernel, boundary)

    def conv(x):
        out = None
        for a, b in ops:
            t = np.matmul(np.matmul(a, x), b)
            out = t if out is None else out + t
        return out

    return conv


def make_counts_matmul_np(rule: Rule, shape: tuple[int, int]):
    """:func:`make_counts_matmul` in numpy."""
    kern, subtract_center = _center_folded(rule)
    conv = make_conv_np(shape, kern, rule.boundary)

    def counts(board):
        alive = (board == 1).astype(np.float32)
        c = conv(alive).astype(np.int32)
        if subtract_center:
            c = c - alive.astype(np.int32)
        return c

    return counts


def neighbor_counts_matmul_np(board: np.ndarray, rule: Rule) -> np.ndarray:
    """One-shot numpy matmul counts (tests and oracles; the executors
    build :func:`make_counts_matmul_np` once per shape instead)."""
    return make_counts_matmul_np(rule, board.shape)(board)
