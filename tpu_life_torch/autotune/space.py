"""The tuning space: what a tuned configuration is, and which ones are legal
(``tpu_life/autotune/space.py`` under the port's names).

- :class:`TuneKey` — the *situation*: device kind and count, rule
  structure (name, radius, states, neighborhood, boundary), the padded
  board-shape bucket and bit-slicing eligibility.  Two runs with equal
  keys want the same knobs, so the key is the unit of cache identity; its
  ``id()`` is the JAX key's string.
- :class:`TunedConfig` — the *decision*: backend, ``block_steps``,
  ``local_kernel``, ``bitpack``, ``sync_every``, ``stencil``.

The names map from the JAX package's as ``interop.tune_dict_from_jax``
does: device kind ``tpu`` -> ``cuda``; backend ``jax`` -> ``torch``,
``pallas`` -> ``cuda``; local kernel ``xla`` -> ``torch``, ``pallas`` ->
``cuda``.  :func:`enumerate_candidates` mirrors the JAX function branch by
branch, its ``on_tpu`` becoming ``device_kind == "cuda"``: the ``cuda``
backend (kernels K1 and K2) and ``sharded`` with ``local_kernel="cuda"``
(K3 on packed clamped Moore keys) only on the card, whose plain versions
on the CPU run at Python speed.  Stochastic keys tune the ``cuda``
executor (kernels K6 and K7), continuous keys the ``torch`` one (``auto``'s
pick for them), each on its own axis.  No candidate is added that the JAX
space lacks.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

from tpu_life_torch.models.rules import IsingRule, Rule

# block_steps grid: the JAX package's, so a measured sweep re-verifies the
# ramp and the cliff on the card instead of assuming them
BLOCK_STEPS_GRID = (1, 4, 8, 16, 32)

# shape buckets never go below 128 cells in either dimension: configs
# don't change meaningfully below it, and tiny boards would otherwise
# explode the cache with one entry per toy shape
MIN_BUCKET = 128


@dataclass(frozen=True)
class TuneKey:
    """Cache identity: everything the best config is allowed to depend on."""

    device_kind: str  # "cpu" or "cuda"
    device_count: int
    rule_name: str
    radius: int
    states: int
    neighborhood: str  # "moore" | "von_neumann"
    boundary: str  # "clamped" | "torus"
    shape_bucket: tuple[int, int]  # padded (h, w) bucket, power-of-two ceil
    bitpack_ok: bool  # bit-sliced path eligible for this rule family
    # stochastic rules tune the key-schedule executors, and "bitpack"
    # means the packed Metropolis engine; kept out of id() for
    # deterministic keys, as in the JAX key
    stochastic: bool = False
    # continuous (Lenia) rules tune the float executor's stencil axis
    continuous: bool = False

    def id(self) -> str:
        """Stable string form — the JSON cache's entry key."""
        h, w = self.shape_bucket
        return (
            f"{self.device_kind}x{self.device_count}"
            f"|{self.rule_name}|r{self.radius}s{self.states}"
            f"|{self.neighborhood}|{self.boundary}"
            f"|{h}x{w}|bp{int(self.bitpack_ok)}"
            + ("|mc" if self.stochastic else "")
            + ("|cc" if self.continuous else "")
        )

    def to_dict(self) -> dict:
        d = asdict(self)
        d["shape_bucket"] = list(self.shape_bucket)
        return d


@dataclass(frozen=True)
class TunedConfig:
    """The knob settings a run resolves to — a RunConfig fragment."""

    backend: str
    block_steps: int | None = None  # None keeps the backend's own default
    local_kernel: str = "auto"  # sharded backend only
    bitpack: bool = True
    sync_every: int = 0  # 0 = one fused run (never swept; host-sync cadence
    # belongs to snapshots/metrics, not throughput)
    # the neighborhood-counting path: "auto" (the crossover model applies),
    # "roll" or "matmul"; the torch executor honours it, the kernels carry
    # their own sums
    stencil: str = "auto"

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TunedConfig":
        return cls(
            backend=str(d["backend"]),
            block_steps=None if d.get("block_steps") is None else int(d["block_steps"]),
            local_kernel=str(d.get("local_kernel", "auto")),
            bitpack=bool(d.get("bitpack", True)),
            sync_every=int(d.get("sync_every", 0)),
            stencil=str(d.get("stencil", "auto")),
        )

    def backend_kwargs(self) -> dict:
        """kwargs for ``get_backend`` realizing this decision.  Backends
        tolerate unknown kwargs (``**_``), so the full set always passes."""
        kw: dict = {"bitpack": self.bitpack, "local_kernel": self.local_kernel}
        if self.block_steps is not None:
            kw["block_steps"] = self.block_steps
        if self.stencil != "auto":
            kw["stencil"] = self.stencil
        return kw

    def describe(self) -> str:
        k = "-" if self.block_steps is None else str(self.block_steps)
        return (
            f"{self.backend} k={k} local_kernel={self.local_kernel} "
            f"bitpack={int(self.bitpack)} sync_every={self.sync_every} "
            f"stencil={self.stencil}"
        )


def tuned_record(backend: str, kwargs: dict) -> dict:
    """The BENCH-record ``"tuned"`` payload: the knob set a ``get_backend``
    call site actually ran, in the TunedConfig schema — one source of
    truth for the bench/CLI perf records, so the record fields cannot
    drift from the cache schema."""
    return TunedConfig(
        backend=backend,
        block_steps=kwargs.get("block_steps"),
        local_kernel=kwargs.get("local_kernel") or "auto",
        bitpack=bool(kwargs.get("bitpack", True)),
        sync_every=int(kwargs.get("sync_every", 0)),
        stencil=kwargs.get("stencil") or "auto",
    ).to_dict()


def shape_bucket(height: int, width: int) -> tuple[int, int]:
    """Pad each dimension up to the next power of two (floor MIN_BUCKET).

    Boards inside one bucket share halo/traffic proportions closely enough
    that one tuned config serves them all; the bucket also bounds cache
    cardinality to ~log^2 of the shape space.
    """

    def up(n: int) -> int:
        b = MIN_BUCKET
        while b < n:
            b <<= 1
        return b

    if height < 1 or width < 1:
        raise ValueError(f"board shape must be positive, got {height}x{width}")
    return up(height), up(width)


def _bitpack_eligible(rule: Rule) -> bool:
    """Bit-sliced path eligibility from rule structure alone (mirrors
    ``bitlife.supports_family`` + the diamond/torus variants, and the
    stochastic tier's ``mc.packed_supports``)."""
    if getattr(rule, "continuous", False):
        return False  # float boards have no bitplane form
    if getattr(rule, "stochastic", False):
        # the packed Metropolis engine: ising only — noisy rules keep the
        # int8 roll composition
        return isinstance(rule, IsingRule)
    if rule.states != 2 or rule.include_center:
        return False
    if rule.neighborhood == "moore":
        return rule.radius == 1  # clamped and torus both run packed
    # von Neumann diamond: 4 count planes => radius <= 2, clamped only
    return rule.boundary == "clamped" and rule.radius <= 2


def tune_key_for(
    rule: Rule,
    shape: tuple[int, int],
    *,
    device=None,
    device_kind: str | None = None,
    device_count: int | None = None,
) -> TuneKey:
    """Build the key for tuning ``rule`` on a ``shape`` board on ``device``.

    A CUDA device (the default) gives ``("cuda", torch.cuda.device_count())``
    and raises ``CudaUnavailableError`` without a card; only
    ``device="cpu"`` gives ``("cpu", 1)``.  ``device_kind`` and
    ``device_count`` override the device, so tests and offline tooling can
    build keys for hardware they are not on.
    """
    if device_kind is None or device_count is None:
        from tpu_life_torch.backends.base import resolve_device

        dev = resolve_device(device)
        if dev.type == "cpu":
            kind, count = "cpu", 1
        else:
            import torch

            kind, count = "cuda", torch.cuda.device_count()
        device_kind = device_kind or kind
        device_count = device_count or count
    h, w = int(shape[0]), int(shape[1])
    return TuneKey(
        device_kind=str(device_kind),
        device_count=int(device_count),
        rule_name=rule.name,
        radius=rule.radius,
        states=rule.states,
        neighborhood=rule.neighborhood,
        boundary=rule.boundary,
        shape_bucket=shape_bucket(h, w),
        bitpack_ok=_bitpack_eligible(rule),
        stochastic=bool(getattr(rule, "stochastic", False)),
        continuous=bool(getattr(rule, "continuous", False)),
    )


def default_backend_set(device_kind: str) -> tuple[str, ...]:
    """Backends worth measuring on this device kind.  The ``cuda``
    backend's kernels run only on the card (their plain versions on the
    CPU are the correctness path, at Python speed); numpy is the truth
    executor, never a performance candidate."""
    if device_kind == "cuda":
        return ("torch", "sharded", "cuda")
    return ("torch", "sharded")


def enumerate_candidates(
    key: TuneKey,
    *,
    backend_set: tuple[str, ...] | list[str] | None = None,
    shape: tuple[int, int] | None = None,
) -> list[TunedConfig]:
    """The legal candidate list for ``key``, in deterministic order.

    Each backend contributes the knob combinations it actually honors:

    - ``torch``: no blocking knobs — one candidate (plus the unpacked int8
      variant when the rule is bitpack-eligible, so a measured sweep can
      re-verify the packed path wins rather than assume it), and at
      radius > 1 both stencils;
    - ``sharded``: ``block_steps`` grid x ``local_kernel`` (kernel K3 only
      on the card, for packed clamped Moore keys); torus rules drop out
      entirely when the exact ``shape`` rows don't divide the mesh;
    - ``cuda``: ``block_steps`` grid, on the card only.

    ``shape`` is the exact board shape when known — used only for
    feasibility checks that depend on exact (not bucketed) geometry.
    """
    backends = tuple(backend_set or default_backend_set(key.device_kind))
    on_card = key.device_kind == "cuda"
    if key.continuous:
        # continuous keys: only the float executor, on its stencil axis —
        # both offered so a measured sweep verifies the matmul win instead
        # of assuming it
        return [
            TunedConfig("torch", None, "auto", False, 0, "matmul"),
            TunedConfig("torch", None, "auto", False, 0, "roll"),
        ]
    if key.stochastic:
        # stochastic keys: the executor with the key schedule on the card
        # (K6 and K7), packed and roll when the rule is packed-eligible so
        # a measured sweep verifies the packed win instead of assuming it
        out = [TunedConfig("cuda", None, "auto", key.bitpack_ok, 0)]
        if key.bitpack_ok:
            out.append(TunedConfig("cuda", None, "auto", False, 0))
        return out
    out: list[TunedConfig] = []
    for backend in backends:
        if backend == "torch":
            out.append(TunedConfig("torch", None, "auto", key.bitpack_ok, 0))
            if key.bitpack_ok:
                out.append(TunedConfig("torch", None, "auto", False, 0))
            if key.radius > 1:
                # the stencil axis: at radius > 1 the banded-matmul counts
                # are a contender — offer both so the crossover is
                # measured, not guessed
                out.append(TunedConfig("torch", None, "auto", False, 0, "matmul"))
                out.append(TunedConfig("torch", None, "auto", False, 0, "roll"))
        elif backend == "sharded":
            if key.boundary == "torus":
                h = shape[0] if shape is not None else key.shape_bucket[0]
                if h % key.device_count != 0:
                    continue  # exact rows must divide the mesh — infeasible
            kernels = ["torch"]
            if (
                on_card
                and key.bitpack_ok
                and key.boundary == "clamped"
                and key.neighborhood == "moore"
            ):
                kernels.append("cuda")
            for kernel in kernels:
                for k in BLOCK_STEPS_GRID:
                    out.append(TunedConfig("sharded", k, kernel, key.bitpack_ok, 0))
        elif backend == "cuda":
            if not on_card:
                continue  # plain versions on the CPU: correctness path, not a candidate
            if key.boundary == "torus" and not key.bitpack_ok:
                continue  # no int8 torus kernel
            for k in BLOCK_STEPS_GRID:
                out.append(TunedConfig("cuda", k, "auto", key.bitpack_ok, 0))
        elif backend == "numpy":
            out.append(TunedConfig("numpy", None, "auto", False, 0))
        else:
            raise ValueError(f"unknown backend {backend!r} in backend_set")
    if not out:
        raise ValueError(f"no feasible candidates for {key.id()} with backends {backends}")
    return out
