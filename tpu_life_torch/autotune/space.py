"""The record of a tuned configuration (a trimmed copy of
``tpu_life/autotune/space.py``: :class:`TunedConfig` and
:func:`tuned_record`).

``bench`` stamps the knob set it ran into its record's ``tuned`` field in
the JAX package's schema, so the two packages' records carry the same
keys.  The rest of autotune (tune keys, candidates, the cost model, the
measured search and its cache) is not ported yet.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class TunedConfig:
    """The knob settings a run resolves to — a RunConfig fragment.  The
    JAX class's cache round trip (``from_dict``, ``backend_kwargs``,
    ``describe``) waits for the autotune port."""

    backend: str
    block_steps: int | None = None  # None keeps the backend's own default
    local_kernel: str = "auto"  # sharded backend only
    bitpack: bool = True
    sync_every: int = 0  # 0 = one fused run (never swept; host-sync cadence
    # belongs to snapshots/metrics, not throughput)
    # the JAX package's neighborhood-counting axis ("auto", "roll" or
    # "matmul"); the port counts by shift-adds only (matmul counting is
    # not ported yet)
    stencil: str = "auto"

    def to_dict(self) -> dict:
        return asdict(self)


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
