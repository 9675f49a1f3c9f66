"""Lenia: the continuous rule family (from ``tpu_life/models/lenia.py``).

Float32 boards in [0, 1], a radially symmetric weighted kernel ``K``, a
smooth growth function and a clipped Euler update::

    A' = clip(A + dt * G(K (*) A), 0, 1)
    G(u) = 2 * exp(-(u - mu)^2 / (2 sigma^2)) - 1

:class:`LeniaRule`, :data:`PRESETS`, :func:`parse_lenia`,
:func:`validate_board` and :func:`seeded_board` are copies of the JAX
package's (the kernel is the same float32 array to the bit).  The step
runs two ways:

- :func:`make_lenia_step`, torch on any device: the correlation through
  the banded matmuls of ``ops.conv`` (``matmul``) or as shifted, scaled
  adds (``roll``);
- :func:`make_lenia_step_np`, numpy, the oracle: the JAX package's numpy
  arithmetic, so :func:`run_np` is byte-equal to its ``run_np``.

The torch paths agree with the oracle to :data:`FLOAT_ATOL` only: float
summation order is the executor's own.  Continuous rules run on the
``torch`` (:class:`LeniaDeviceRunner`), ``numpy`` (its ``run`` over
:func:`make_lenia_step_np`) and ``sharded`` backends, each dispatching
them in its own ``prepare`` or ``run``; the ``cuda`` backend raises
(:func:`require_float_path`) rather than cast the board to int8.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from tpu_life_torch.models.rules import Rule, register_rule

#: Executors carrying the float32 board path; every other backend raises
#: :func:`require_float_path`'s error.
SUPPORTED_BACKENDS = ("torch", "numpy", "sharded")

#: allclose tolerance between float executors (the numpy oracle against
#: the torch roll and matmul paths), the JAX package's: per-step error is
#: summation-order-level (~1e-7) and the clipped update keeps it from
#: compounding past this over the known-answer runs' lengths.
FLOAT_ATOL = 1e-4


def require_float_path(rule: Rule, backend_name: str) -> None:
    """The hard gate: continuous rules only run on float executors.  A
    silent int8 cast would quantize the board to junk — worse than an
    error."""
    if backend_name not in SUPPORTED_BACKENDS:
        raise ValueError(
            f"continuous rule {rule.name!r} needs the torch, numpy or sharded "
            f"backend (float32 boards; {backend_name!r} has no float path) — a "
            f"quantized fallback would not be the rule you asked for"
        )


@dataclass(frozen=True)
class LeniaRule(Rule):
    """A Lenia world as a frozen, hashable rule value.

    The inherited ``birth``/``survive``/``states`` fields are unused
    (the transition is the growth function, not a count LUT); they keep
    their defaults so the rule hashes and serializes like any other.
    ``boundary`` defaults to the torus (the standard Lenia world) but
    the clamped variant is legal — the kernel truncates at the edges
    exactly like a clamped count stencil.
    """

    name: str = "lenia"
    radius: int = 13
    mu: float = 0.15  # growth-function center
    sigma: float = 0.017  # growth-function width
    dt: float = 0.1  # Euler step size
    peaks: tuple = (1.0,)  # ring (shell) amplitudes, center outward
    boundary: str = "torus"

    def __post_init__(self):
        super().__post_init__()
        if not (0.0 < float(self.mu) < 1.0):
            raise ValueError(f"lenia mu must be in (0, 1), got {self.mu}")
        if not (0.0 < float(self.sigma) < 1.0):
            raise ValueError(
                f"lenia sigma must be in (0, 1), got {self.sigma}"
            )
        if not (0.0 < float(self.dt) <= 1.0):
            raise ValueError(f"lenia dt must be in (0, 1], got {self.dt}")
        if not self.peaks or any(
            not (0.0 <= float(b) <= 1.0) for b in self.peaks
        ):
            raise ValueError(
                f"lenia ring amplitudes must be a non-empty tuple in "
                f"[0, 1], got {self.peaks!r}"
            )
        if max(float(b) for b in self.peaks) <= 0.0:
            raise ValueError("lenia needs at least one nonzero ring")

    @property
    def continuous(self) -> bool:
        return True

    @cached_property
    def kernel(self) -> np.ndarray:
        """The normalized float32 shell kernel, ``(2r+1, 2r+1)``."""
        r = self.radius
        dy, dx = np.mgrid[-r : r + 1, -r : r + 1].astype(np.float64)
        rho = np.sqrt(dy * dy + dx * dx) / r
        nb = len(self.peaks)
        srho = rho * nb
        shell = np.minimum(np.floor(srho), nb - 1)
        frac = srho - shell
        with np.errstate(divide="ignore", over="ignore"):
            core = np.where(
                (frac > 0.0) & (frac < 1.0),
                np.exp(4.0 - 1.0 / np.maximum(frac * (1.0 - frac), 1e-12)),
                0.0,
            )
        amp = np.asarray(self.peaks, np.float64)[shell.astype(np.int64)]
        k = np.where(rho < 1.0, amp * core, 0.0)
        total = k.sum()
        if total <= 0.0:
            raise ValueError(
                f"lenia kernel for {self.name!r} is degenerate (all-zero "
                f"after the shell construction)"
            )
        return (k / total).astype(np.float32)


def _taps(rule: LeniaRule) -> list[tuple[int, int, float]]:
    """The kernel's non-zero taps ``(dy, dx, weight)`` in row-major order:
    the roll path's shifted, scaled adds."""
    r = rule.radius
    kern = rule.kernel
    return [
        (dy, dx, float(kern[dy + r, dx + r]))
        for dy in range(-r, r + 1)
        for dx in range(-r, r + 1)
        if kern[dy + r, dx + r] != 0.0
    ]


# -- the step, torch ----------------------------------------------------------
def growth(u: torch.Tensor, rule: LeniaRule) -> torch.Tensor:
    """The smooth growth field ``G(u)`` in [-1, 1], in float32."""
    mu = float(np.float32(rule.mu))
    inv2s2 = float(np.float32(1.0 / (2.0 * float(rule.sigma) ** 2)))
    d = u - mu
    return 2.0 * torch.exp(-(d * d) * inv2s2) - 1.0


def _make_roll_conv(rule: LeniaRule):
    """The weighted roll path: the kernel's taps as shifted, scaled adds
    over the board padded by the radius (zeros, or the torus's periodic
    continuation).  O(nnz(K)) passes a step."""
    from tpu_life_torch.ops.stencil import pad_board

    r = rule.radius
    taps = _taps(rule)
    wrap = rule.boundary == "torus"

    def conv(a: torch.Tensor) -> torch.Tensor:
        h, w = a.shape
        padded = pad_board(a, r, wrap)
        out = None
        for dy, dx, wgt in taps:
            sl = padded[r + dy : r + dy + h, r + dx : r + dx + w] * wgt
            out = sl if out is None else out + sl
        return out

    return conv


def make_lenia_step(rule: LeniaRule, shape: tuple[int, int], stencil: str = "matmul"):
    """One Lenia step ``f32[h, w] -> f32[h, w]`` in torch ops.  ``matmul``
    builds the banded operators of ``shape`` once (``ops.conv.make_conv``),
    ``roll`` unrolls the kernel's taps."""
    if stencil == "matmul":
        from tpu_life_torch.ops.conv import make_conv

        conv = make_conv(shape, rule.kernel, rule.boundary)
    else:
        conv = _make_roll_conv(rule)
    dt = float(np.float32(rule.dt))

    def step(board: torch.Tensor) -> torch.Tensor:
        u = conv(board)
        return torch.clamp(board + dt * growth(u, rule), 0.0, 1.0)

    return step


# -- the step, numpy (the oracle) ----------------------------------------------
def growth_np(u: np.ndarray, rule: LeniaRule) -> np.ndarray:
    """:func:`growth` in numpy."""
    mu = np.float32(rule.mu)
    inv2s2 = np.float32(1.0 / (2.0 * float(rule.sigma) ** 2))
    d = u - mu
    return np.float32(2.0) * np.exp(-(d * d) * inv2s2) - np.float32(1.0)


def _make_roll_conv_np(rule: LeniaRule, shape: tuple[int, int]):
    h, w = int(shape[0]), int(shape[1])
    r = rule.radius
    taps = _taps(rule)
    mode = "wrap" if rule.boundary == "torus" else "constant"

    def conv(a):
        padded = np.pad(a, ((r, r), (r, r)), mode=mode)
        out = None
        for dy, dx, wgt in taps:
            sl = padded[r + dy : r + dy + h, r + dx : r + dx + w] * np.float32(wgt)
            out = sl if out is None else out + sl
        return out

    return conv


def make_lenia_step_np(rule: LeniaRule, shape: tuple[int, int], stencil: str = "roll"):
    """:func:`make_lenia_step` in numpy, the JAX package's numpy step."""
    if stencil == "matmul":
        from tpu_life_torch.ops.conv import make_conv_np

        conv = make_conv_np(shape, rule.kernel, rule.boundary)
    else:
        conv = _make_roll_conv_np(rule, shape)
    dt = float(rule.dt)

    def step(board):
        u = conv(board.astype(np.float32))
        a = board + np.float32(dt) * growth_np(u, rule)
        return np.clip(a, np.float32(0.0), np.float32(1.0)).astype(np.float32)

    return step


def step_np(
    board: np.ndarray, rule: LeniaRule, stencil: str = "roll"
) -> np.ndarray:
    """One ground-truth numpy step (roll by default — the KAT oracle)."""
    return make_lenia_step_np(rule, board.shape, stencil)(
        np.asarray(board, np.float32)
    )


def run_np(
    board: np.ndarray, rule: LeniaRule, steps: int, stencil: str = "roll"
) -> np.ndarray:
    """``steps`` oracle steps."""
    fn = make_lenia_step_np(rule, board.shape, stencil)
    board = np.asarray(board, np.float32)
    for _ in range(steps):
        board = fn(board)
    return board


def validate_board(board: np.ndarray, rule: LeniaRule) -> np.ndarray:
    """Submit-time float-board validation shared by every front: 2-D,
    finite, within [0, 1]; returns the float32 copy the engines step."""
    board = np.asarray(board)
    if board.ndim != 2:
        raise ValueError(f"board must be 2-D, got shape {board.shape}")
    b = board.astype(np.float32)
    if not np.isfinite(b).all():
        raise ValueError(
            f"continuous rule {rule.name!r} needs a finite board; found "
            f"NaN or Inf"
        )
    lo, hi = float(b.min(initial=0.0)), float(b.max(initial=0.0))
    if lo < 0.0 or hi > 1.0:
        raise ValueError(
            f"continuous rule {rule.name!r} needs board values in "
            f"[0, 1]; found {lo if lo < 0.0 else hi}"
        )
    return b


def seeded_board(
    height: int, width: int, density: float = 0.5, *, seed: int = 0
) -> np.ndarray:
    """A seeded float32 board from the counter-based stream: each cell
    alive with probability ``density`` carrying a uniform [0, 1)
    magnitude, dead (0.0) otherwise.  The JAX package's board for the same
    seed: ``mc.prng``'s ``SUB_BOARD`` substream, words at steps 0 and 1."""
    from tpu_life_torch.mc import prng

    if not 0.0 <= density <= 1.0:
        raise ValueError(f"density must be in [0, 1], got {density}")
    k0, k1 = prng.key_halves(seed)
    mask_u = prng.cell_uniforms((height, width), k0, k1, np.uint32(0), prng.SUB_BOARD)
    mag_u = prng.cell_uniforms((height, width), k0, k1, np.uint32(1), prng.SUB_BOARD)
    alive = (
        np.ones((height, width), bool)
        if density >= 1.0
        else mask_u < np.uint32(prng.threshold_u32(density))
    )
    mag = (mag_u.astype(np.float64) * (1.0 / 4294967296.0)).astype(np.float32)
    return np.where(alive, mag, np.float32(0.0)).astype(np.float32)


# -- runners --------------------------------------------------------------------
class LeniaDeviceRunner:
    """Runner over a float32 board on ``device``: ``advance`` loops the step
    with no host round-trip, each step binding a new board, so a
    snapshot's board is never written again."""

    route = "lenia"

    def __init__(self, board: np.ndarray, rule: LeniaRule, *, stencil: str = "matmul",
                 device: torch.device | str):
        board = validate_board(board, rule)
        self.x = torch.from_numpy(board).to(device, copy=True)
        self.stencil = stencil
        self._step = make_lenia_step(rule, board.shape, stencil)

    def advance(self, steps: int) -> None:
        x = self.x
        for _ in range(steps):
            x = self._step(x)
        self.x = x

    def sync(self) -> None:
        if self.x.is_cuda:
            torch.cuda.synchronize(self.x.device)
        self.x[:1, :1].cpu()

    def fetch(self) -> np.ndarray:
        return self.x.cpu().numpy()

    def snapshot(self):
        return lambda x=self.x: x.cpu().numpy()

    def live_count(self) -> int:
        return int((self.x >= 0.5).sum())


# -- the spec grammar -------------------------------------------------------
#: Named presets (docs/RULES.md).  ``orbium`` is the classic glider's
#: parameter point (R13, mu 0.15, sigma 0.017, dt 0.1, one ring);
#: ``mini`` is a cheap small-kernel world sized for tests and CI smoke.
PRESETS: dict[str, dict] = {
    "orbium": dict(radius=13, mu=0.15, sigma=0.017, dt=0.1, peaks=(1.0,)),
    "mini": dict(radius=4, mu=0.15, sigma=0.04, dt=0.25, peaks=(1.0,)),
}

_FIELD_RE = re.compile(r"^(dt|[RMSB])(.*)$", re.IGNORECASE)


def parse_lenia(spec: str) -> LeniaRule:
    """``lenia`` / ``lenia:<preset>`` / parametric
    ``lenia:R<r>,m<mu>,s<sigma>[,dt<dt>][,b<a1;a2;...>]`` (+ optional
    ``:T`` torus suffix — the default topology anyway) with typed
    errors for every malformation, mirroring :func:`parse_rule`.
    """
    raw = spec.strip()
    body = raw[len("lenia"):].lstrip(":").strip()
    boundary = "torus"
    m_t = re.search(r":\s*[tT]\s*$", body)
    if m_t is not None:
        body = body[: m_t.start()].strip()
    elif body.lower() == "t":
        # the bare 'lenia:T' form: the suffix with no body — the default
        # preset on its (already default) torus
        body = ""
    if not body:
        return LeniaRule(name="lenia:orbium", **PRESETS["orbium"])
    key = body.lower().replace("-", "_")
    if key in PRESETS:
        return LeniaRule(name=f"lenia:{key}", **PRESETS[key])
    if not body.startswith(("R", "r")):
        # not a preset and not parametric: reject loudly with the menu
        raise ValueError(
            f"unknown lenia spec {spec!r}: presets are "
            f"{sorted(PRESETS)}, or parametric "
            f"'lenia:R<r>,m<mu>,s<sigma>[,dt<dt>][,b<a1;a2;...>]'"
        )
    fields: dict[str, str] = {}
    for part in body.split(","):
        part = part.strip()
        m = _FIELD_RE.match(part)
        if not m:
            raise ValueError(f"bad lenia field {part!r} in {spec!r}")
        k, v = m.group(1), m.group(2)
        k = "R" if k.lower() == "r" else k.lower()
        if k in fields:
            raise ValueError(f"duplicate lenia field {k!r} in {spec!r}")
        fields[k] = v
    if "R" not in fields:
        raise ValueError(f"lenia spec {spec!r} needs a radius field R<r>")
    try:
        radius = int(fields["R"])
        mu = float(fields.get("m", "0.15"))
        sigma = float(fields.get("s", "0.017"))
        dt = float(fields.get("dt", "0.1"))
        peaks = tuple(
            float(b) for b in fields.get("b", "1").split(";") if b.strip()
        )
    except ValueError:
        raise ValueError(
            f"bad lenia parameter value in {spec!r} (fields: R=int, "
            f"m/s/dt=float, b=floats joined by ';')"
        ) from None
    return LeniaRule(
        name=raw,
        radius=radius,
        mu=mu,
        sigma=sigma,
        dt=dt,
        peaks=peaks,
        boundary=boundary,
    )


register_rule("lenia", parse_lenia("lenia"))
