"""Per-worker device placement: disjoint device slices as spawn overlays.

The MPMD seam (docs/FLEET.md "Device placement"): every fleet worker is an
independent gateway process, so giving each one its OWN device subset
turns ``--workers N`` on a multi-card host from "N claimants fighting over
the same cards" into N single-owner programs behind the thin router.

The planner never touches torch (the fleet front tier stays torch-free): a
placement is an **overlay** the supervisor applies when spawning the
worker — environment variables plus the gateway flags that pick its
device — and the worker reports what it actually got back through its
startup line and ``/readyz`` (the capacity-feedback half,
``fleet.balancer``).

Overlay semantics by platform kind (the port's departure from the JAX
package, whose workers read ``JAX_PLATFORMS`` and XLA's host-device flag):

==========  ==================================================  =========
kind        overlay                                             disjoint?
==========  ==================================================  =========
``cpu``     ``--device cpu`` + ``CUDA_VISIBLE_DEVICES=`` (empty) synthetic
``cuda``    ``--device cuda`` + ``CUDA_VISIBLE_DEVICES=i,...``   real ids
``gpu``     the same as ``cuda``                                 real ids
==========  ==================================================  =========

A CPU-placed worker runs the plain PyTorch versions of the kernels on the
host and sees no card; its K "devices" are the plan's count only (the
port's ``mesh:RxC`` shards one device, and a CPU worker reports the one
device it has).  CUDA placement slices real integer device ids
``0..total_devices-1`` into disjoint contiguous runs, worker order; an
explicit per-worker request that oversubscribes the host is a
:class:`PlacementError` at PLAN time — before any process is spawned —
because respawning into the same bad env can never succeed (the
fail-fast contract ``fleet --max-restarts`` relies on).
"""

from __future__ import annotations

from dataclasses import dataclass

#: The visible-device variable every overlay sets: a worker's slice of
#: the cards, or none at all for a CPU-placed worker.
VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"

#: Platform kind -> the gateway's ``--device`` value for its workers.
_ACCEL_DEVICE = {
    "gpu": "cuda",
    "cuda": "cuda",
}


class PlacementError(ValueError):
    """A device-placement plan that can never come up healthy: wrong
    worker/device arithmetic, an oversubscribed host, or an unknown
    platform kind.  Raised at PLAN time (fleet construction) so the
    supervisor never burns its restart budget respawning a worker into
    an env that is deterministically broken."""


@dataclass(frozen=True)
class Placement:
    """One worker's planned slice: how many devices, which kind, which
    concrete ids (None for a CPU worker's planned count), and the env
    overlay and gateway flags that realize it in the spawned process."""

    worker: str
    devices: int
    kind: str
    device_ids: tuple[int, ...] | None
    env: dict
    args: tuple[str, ...] = ()


def parse_devices_per_worker(spec: str | None, workers: int) -> tuple[int, ...] | None:
    """``--devices-per-worker`` parser: ``"4"`` = 4 for every worker,
    ``"1,4"`` = per-worker counts (length must equal ``workers``)."""
    if spec is None:
        return None
    try:
        counts = tuple(int(part) for part in str(spec).split(","))
    except ValueError:
        raise PlacementError(
            f"--devices-per-worker must be an int or comma list, got {spec!r}"
        ) from None
    if any(c < 1 for c in counts):
        raise PlacementError(
            f"every per-worker device count must be >= 1, got {spec!r}"
        )
    if len(counts) == 1:
        return counts * workers
    if len(counts) != workers:
        raise PlacementError(
            f"--devices-per-worker lists {len(counts)} counts for "
            f"{workers} workers (give one count, or exactly one per worker)"
        )
    return counts


def plan_placements(
    workers: int,
    *,
    platform: str = "cpu",
    devices_per_worker: tuple[int, ...] | None = None,
    total_devices: int | None = None,
) -> list[Placement]:
    """Assign every worker a disjoint device subset; raises
    :class:`PlacementError` for any plan that cannot come up healthy.

    ``devices_per_worker`` is per-worker (already normalized — see
    :func:`parse_devices_per_worker`); None auto-splits.  CPU auto is one
    device each; accelerator auto splits ``total_devices``
    evenly with the remainder going to the first workers (so a 10-chip
    host under 4 workers plans 3/3/2/2 — no chip idles).  Explicit
    accelerator counts may undersubscribe (spare chips stay unassigned
    for other tenants) but never oversubscribe.
    """
    if workers < 1:
        raise PlacementError(f"workers must be >= 1, got {workers}")
    if devices_per_worker is not None and len(devices_per_worker) != workers:
        raise PlacementError(
            f"devices_per_worker has {len(devices_per_worker)} entries "
            f"for {workers} workers"
        )
    if platform == "cpu":
        counts = devices_per_worker or (1,) * workers
        return [
            Placement(
                worker=f"w{i}",
                devices=k,
                kind="cpu",
                device_ids=None,
                env={VISIBLE_DEVICES: ""},
                args=("--device", "cpu"),
            )
            for i, k in enumerate(counts)
        ]
    if platform not in _ACCEL_DEVICE:
        raise PlacementError(
            f"unknown placement platform {platform!r} "
            f"(expected cpu, cuda, or gpu)"
        )
    if total_devices is None or total_devices < 1:
        raise PlacementError(
            f"{platform} placement needs --total-devices (the fleet front "
            f"tier is torch-free and cannot count the host's cards itself)"
        )
    if devices_per_worker is None:
        base, extra = divmod(total_devices, workers)
        if base == 0:
            raise PlacementError(
                f"{workers} workers over {total_devices} {platform} "
                f"device(s): every worker needs at least one — use fewer "
                f"workers or --placement none"
            )
        counts = tuple(base + (1 if i < extra else 0) for i in range(workers))
    else:
        counts = devices_per_worker
        if sum(counts) > total_devices:
            raise PlacementError(
                f"devices_per_worker={counts} oversubscribes the host: "
                f"{sum(counts)} requested, {total_devices} available"
            )
    plans: list[Placement] = []
    cursor = 0
    for i, k in enumerate(counts):
        ids = tuple(range(cursor, cursor + k))
        cursor += k
        plans.append(
            Placement(
                worker=f"w{i}",
                devices=k,
                kind=platform,
                device_ids=ids,
                env={VISIBLE_DEVICES: ",".join(str(d) for d in ids)},
                args=("--device", _ACCEL_DEVICE[platform]),
            )
        )
    return plans


def apply_env_overlay(env: dict, overlay: dict) -> dict:
    """Merge a placement overlay into a spawn environment, in place.

    Every overlay var replaces the inherited value outright (a worker's
    visible-device set must be exactly its slice, not a merge with
    whatever the parent had).
    """
    env.update(overlay)
    return env
