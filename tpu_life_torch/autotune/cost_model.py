"""Analytic cost fallback: rank candidates without touching a device.

The read path (``autotune.resolve``) must never measure — serving latency
cannot pay tuning cost, and a cache miss on a fresh machine still needs an
answer.  The formula is the JAX package's
(``tpu_life/autotune/cost_model.py``), a relative cost per cell-update:

- **traffic** amortizes over the blocking depth ``k``: one board read and
  write per ``k``-step launch, ``TRAFFIC / k`` (x8 for unpacked int8
  boards against the bit-sliced layout);
- **recomputed fringe** grows with ``k``: each substep of a launch
  recomputes a halo ring ``radius`` deeper, ``FRINGE * radius * k``;

``cost(k) = COMPUTE + TRAFFIC/k + FRINGE * radius * k``, then the JAX
model's structural terms: a sharded candidate's cost divides by the mesh
plus ``HALO_TAX``; a ``cuda`` candidate (K1 or K2, whatever its
``local_kernel``) scales it by ``CUDA_FACTOR``, and a sharded one with the
local kernel (K3) by ``KERNEL_FACTOR``; an explicit matmul stencil by ``MATMUL_WIDE`` past the crossover (continuous
rules, and integer rules at or above ``ops.conv.CROSSOVER_RADIUS`` where
one is set) and ``MATMUL_NARROW`` below it.  Only the ordering is used.

No constant comes from a TPU.  Each is fitted from the H100's own measured
tune tables by ``tpu_life_torch/experiments/tune_fit.py`` (NVIDIA H100
80GB HBM3, 700.00 W power limit; PERF.md §6, PR 20):

- COMPUTE, TRAFFIC, FRINGE: a least-squares fit of ``cuda``'s measured
  s/step over ``BLOCK_STEPS_GRID`` at 16384^2 Conway (K1), divided by the
  series' minimum, so the cost at the best depth is about 1.  Inputs, s/step
  at k = 1, 4, 8, 16, 32: FIT_INPUTS_CUDA below.  A coefficient that fits
  negative would be dropped (held at 0) and the rest refitted; none did.
  Its largest residual is 0.055.
- CUDA_FACTOR: the median over k of ``cuda`` (K1) over ``sharded`` with
  ``local_kernel="torch"`` (plain ops) at equal k, on the same board.  JAX
  has no such term: its ``pallas`` candidates cost what the XLA scan does
  at equal k, which on the card would hand every key a kernel covers
  (diamond, Generations, LtL, unpacked) to plain ops on a cache miss.
- KERNEL_FACTOR: the median over k of ``sharded`` with
  ``local_kernel="cuda"`` (K3) over ``sharded`` with ``"torch"`` (plain
  ops) at equal k, on the same board: the kernel against the plain scan,
  as the JAX 0.97 compared the Pallas kernel with the XLA scan.
- MATMUL_WIDE, MATMUL_NARROW: ``torch`` with ``stencil="matmul"`` over
  ``"roll"``, measured on ``lenia:orbium`` at 2048^2 (continuous: wide) and
  on ``bugs`` at 8192^2 (radius 5; no crossover is set: narrow).
- HALO_TAX: dropped (0).  It prices a mesh of several devices, and a key
  of the card counts ``torch.cuda.device_count()`` cards: the measuring
  machine has one, so no run can fit it.

``UNPACKED_TRAFFIC_FACTOR`` (a ratio of bytes) and ``NUMPY_PENALTY`` (a
sentinel) are not measurements.
"""

from __future__ import annotations

from tpu_life_torch.autotune.space import TuneKey, TunedConfig

# the fit's inputs: measured s/step of each depth in BLOCK_STEPS_GRID at
# 16384^2 Conway (5 trials of 256 steps, median), and of matmul against
# roll on the stencil axis (3 trials of 8 steps); tune_fit.py, NVIDIA H100
# 80GB HBM3, 700.00 W (PERF.md §6, PR 20)
FIT_INPUTS_CUDA = {1: 3.2081195e-05, 4: 1.7011441e-05, 8: 1.5006379e-05,
                   16: 1.5691254e-05, 32: 1.5638375e-05}
FIT_INPUTS_SHARDED_CUDA = {1: 3.6956016e-05, 4: 1.8210328e-05, 8: 1.6124152e-05,
                           16: 1.5521184e-05, 32: 1.5877609e-05}
FIT_INPUTS_SHARDED_TORCH = {1: 1.7494795e-03, 4: 1.7284126e-03, 8: 1.7271887e-03,
                            16: 1.7263578e-03, 32: 1.7300283e-03}
FIT_INPUTS_STENCIL = {"wide": (8.4923178e-03, 1.7344607e-02),  # lenia:orbium 2048^2
                      "narrow": (4.4775064e-02, 7.8776350e-03)}  # bugs 8192^2

# relative per-cell-update cost = COMPUTE + TRAFFIC/k + FRINGE * radius * k
COMPUTE = 0.79415
TRAFFIC = 1.33176
FRINGE = 0.0070891

# unpacked int8 boards move 8x the bytes of the bit-sliced layout
# (32 cells a 32-bit word against one cell a byte)
UNPACKED_TRAFFIC_FACTOR = 8.0

# per-backend structural terms (see the module docstring)
HALO_TAX = 0.0  # dropped: one card, no mesh of several to fit it on
CUDA_FACTOR = 0.0090892
KERNEL_FACTOR = 0.0093355
MATMUL_WIDE = 0.48962
MATMUL_NARROW = 5.6838

# the truth executor: never a performance pick
NUMPY_PENALTY = 1000.0

# defaults a backend applies when block_steps is None (each backend's
# own: the torch executor steps once a pass, the kernels' launches and the
# sharded blocks run cuda_backend.DEFAULT_BLOCK_STEPS = 8)
_DEFAULT_K = {"torch": 1, "sharded": 8, "cuda": 8}


def effective_block_steps(cfg: TunedConfig) -> int:
    if cfg.backend == "torch" or cfg.backend == "numpy":
        return 1  # no deep-halo blocking: one pass over the board a step
    if cfg.block_steps is not None:
        return max(1, cfg.block_steps)
    if cfg.backend == "sharded" and cfg.local_kernel == "cuda":
        return 8  # K3's own depth
    return _DEFAULT_K.get(cfg.backend, 1)


def estimate_cost(key: TuneKey, cfg: TunedConfig) -> float:
    """Relative cost per cell-update of ``cfg`` in situation ``key``
    (lower is better; only the ordering is meaningful)."""
    if cfg.backend == "numpy":
        return NUMPY_PENALTY
    # a stochastic key's executor has no deep halo: a sweep is one pass of
    # the board, as the JAX model counts its stochastic executor
    k = 1 if key.stochastic else effective_block_steps(cfg)
    traffic = TRAFFIC
    if not (cfg.bitpack and key.bitpack_ok):
        traffic *= UNPACKED_TRAFFIC_FACTOR
    cost = COMPUTE + traffic / k + FRINGE * key.radius * k
    if cfg.backend == "sharded" and key.device_count > 1:
        cost = cost / key.device_count + HALO_TAX
    if cfg.backend == "cuda":
        cost *= CUDA_FACTOR  # the cuda backend runs its kernels at any local_kernel
    elif cfg.backend == "sharded" and cfg.local_kernel == "cuda":
        cost *= KERNEL_FACTOR
    if cfg.backend == "torch" and cfg.stencil != "auto":
        # the stencil axis: the analytic view of resolve_stencil's
        # crossover; with no crossover set (the port's default) only
        # continuous keys count as wide.  A measured trial overrides it.
        from tpu_life_torch.ops import conv

        crossover = conv.CROSSOVER_RADIUS
        wide = key.continuous or (crossover is not None and key.radius >= crossover)
        if cfg.stencil == "matmul":
            cost *= MATMUL_WIDE if wide else MATMUL_NARROW
    return cost


def choose(key: TuneKey, candidates: list[TunedConfig]) -> TunedConfig:
    """The cost model's pick: argmin cost, first-wins on exact ties so the
    choice is deterministic for a fixed candidate order."""
    if not candidates:
        raise ValueError("choose() needs at least one candidate")
    return min(candidates, key=lambda c: estimate_cost(key, c))
