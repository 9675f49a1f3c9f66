"""Admission-time memory governance: the serve tier's byte accountant.

The realistic first OOM in a multi-tenant batched service is not a slot
— it is a **CompileKey**: every new (rule, shape, dtype, backend) mints
a fresh engine holding a ``(capacity, h, w)`` board batch, its double
buffer (the device executors retain the in-flight chunk's input batch),
and the stochastic tier's per-slot carry words.  Nothing bounded that
sum: a client fanning out varied geometries would grow device memory
until the allocator raised out of memory mid-round and killed the whole
worker.  This module makes the footprint a *number checked at submit*:

- :func:`estimate_engine_bytes` — the per-CompileKey estimator, pure
  arithmetic over the engine layouts (``serve.engine`` /
  ``mc.engine``): board batch x double buffer on the device executors,
  the MC key/counter/threshold carries, and the bitplane-packed lane
  layout (uint32 words of 32 spins) when the key would take the packed
  engine;
- :func:`resolve_budget` — ``ServeConfig.memory_budget_bytes`` or, when
  unset, a per-device default derived from ``utils.platform.
  device_info()`` (memoized; the probe is bounded so a wedged
  accelerator degrades the default, never hangs construction);
- :func:`check_admission` — the submit-time verdict: an existing key
  admits for free (its slots are preallocated), a new key must fit next
  to every *reserved* key (live engines plus the keys of queued
  sessions), and the failure is the typed
  :class:`~tpu_life_torch.serve.errors.InsufficientMemory` — ``transient``
  when the key would fit alone (503 + Retry-After at the gateway),
  permanent when it can never fit (413).

The estimate is deliberately a **floor with the dominant terms only**
(boards dominate: the per-slot aux vectors are O(capacity) words).  It
exists to turn "the worker died mid-round" into "the request was
refused typed"; the in-place recovery ladder (``scheduler.
recover_engine``) catches whatever slips past the estimate.
"""

from __future__ import annotations

import os
import threading

from tpu_life_torch.serve.errors import InsufficientMemory

#: the serve backends of the card's engines (serve.engine.DEVICE_BATCH_BACKENDS)
DEVICE_BATCH_BACKENDS = ("cuda",)

#: Default budget per resolved device, by platform kind.  Deliberately
#: conservative for accelerators (the smallest deployed HBM of the
#: family) and generous-but-bounded for hosts; override with
#: ``ServeConfig.memory_budget_bytes`` (or the CLI flags) when the real
#: capacity is known.  ``<= 0`` disables accounting entirely.
GIB = 1 << 30
DEFAULT_BYTES_PER_DEVICE: dict[str, int] = {
    "gpu": 8 * GIB,
    "cuda": 8 * GIB,
    "cpu": 2 * GIB,
    "host": 2 * GIB,
}

#: Bound on the one-time device probe the default-budget path runs: a
#: wedged accelerator plugin must degrade the default (1 device, host
#: rate), never stall service construction toward a supervisor timeout.
BUDGET_PROBE_TIMEOUT_S = float(os.environ.get("TPU_LIFE_BUDGET_PROBE_S", 10.0))

_DEFAULT_LOCK = threading.Lock()
_DEFAULT_BUDGET: int | None = None
_DEFAULT_PER_DEVICE: int | None = None

#: Whole-board copies the mesh tier's halo-exchange scan keeps resident
#: per shard: the board itself plus its halo-extended working copy
#: (``parallel/halo.py`` pads ``radius x block_steps`` each side).
MESH_COPIES = 2


def estimate_engine_bytes(key, capacity: int, *, mc_packed: bool = True) -> int:
    """Estimated resident bytes of the engine ``key`` would mint.

    Pure arithmetic — no engine is built, no device touched — so the
    admission check costs nanoseconds.  Terms, matching the executor
    layouts in ``serve.engine`` / ``mc.engine``:

    - board batch: ``capacity x h x w`` int8, or ``capacity x h x
      packed_width(w)`` uint32 on the bitplane-packed stochastic path
      (32 spins per lane — 8x fewer bytes, the packed tier's whole
      point);
    - double buffer: the device batch (``BatchEngine``, the JAX
      package's ``jax``) retains the in-flight chunk's input batch
      (``_prev``), so the board term doubles there; slot loops (``cuda``'s
      K2 keys, the JAX package's ``pallas``) and host executors hold one
      copy.  The terms are the JAX package's, so admission verdicts equal
      its own under the backend mapping (a ``k1_batch`` engine holds less:
      packed words);
    - MC carries: per-slot key halves + absolute step counter (3 x
      uint32) and the uint32[5] acceptance table, plus the shared int32
      remaining vector.
    """
    if str(getattr(key, "backend", "")).startswith("mesh:"):
        # mega-board tier (serve/mesh_engine.py): capacity is pinned to
        # 1 — the board owns its slice — so the batched ``capacity``
        # multiplier never applies, whatever the scheduler's batch size
        return estimate_mesh_bytes(key)
    h, w = key.shape
    stochastic = bool(getattr(key.rule, "stochastic", False))
    packed = False
    if stochastic and key.backend in DEVICE_BATCH_BACKENDS and mc_packed:
        from tpu_life_torch.mc import packed_supports

        packed = packed_supports(key.rule)
    if packed:
        from tpu_life_torch.mc.packed import packed_width

        board_bytes = capacity * h * packed_width(w) * 4
    else:
        # element width from the key's dtype: 1 for int8 boards, 4 for
        # the continuous tier's float32 boards (docs/SERVING.md
        # estimator table)
        import numpy as _np

        itemsize = _np.dtype(getattr(key, "dtype", "int8")).itemsize
        board_bytes = capacity * h * w * itemsize
    copies = 2 if holds_double_buffer(key) else 1
    total = board_bytes * copies
    total += capacity * 4  # the remaining-steps vector (int32)
    if stochastic:
        total += capacity * 4 * 3  # k0 / k1 / absolute step counter
        total += capacity * 4 * 5  # the uint32[5] acceptance table
    return total


def holds_double_buffer(key) -> bool:
    """Whether ``key``'s engine is a device batch: a ``cuda`` key off the
    K2 slot loop (``serve.engine.cuda_route``)."""
    if key.backend not in DEVICE_BATCH_BACKENDS:
        return False
    if getattr(key.rule, "stochastic", False):
        return True  # the stochastic tier's device engines are batches
    from tpu_life_torch.serve.engine import cuda_route

    return cuda_route(key.rule) != "k2_slots"


def estimate_mesh_bytes(key) -> int:
    """Whole-slice footprint of the capacity-1 mesh engine ``key`` would
    mint (serve/mesh_engine.py): one board spread over the slice, times
    :data:`MESH_COPIES` for the halo-exchange working set, plus the
    single remaining-steps word.  The slice total is what admission
    charges against the worker budget; :func:`estimate_mesh_shard_bytes`
    breaks the same number into per-shard estimator rows."""
    import numpy as _np

    h, w = key.shape
    itemsize = _np.dtype(getattr(key, "dtype", "int8")).itemsize
    return h * w * itemsize * MESH_COPIES + 4


def estimate_mesh_shard_bytes(key, mesh_shape) -> dict[str, int]:
    """Per-shard estimator rows for a ``mesh_shape`` placement of
    ``key``: ``{"RxC-shard": bytes}`` — every shard is the same size
    (the backend pads to divisibility), a ceil-divided block plus its
    halo ring, :data:`MESH_COPIES` copies.  These are the
    ``serve_mesh_estimated_bytes{key,shard}`` gauge rows
    (docs/SERVING.md "Mega-board sessions")."""
    import numpy as _np

    h, w = key.shape
    rows, cols = int(mesh_shape[0]), int(mesh_shape[1])
    itemsize = _np.dtype(getattr(key, "dtype", "int8")).itemsize
    shard_h = -(-h // rows)
    shard_w = -(-w // cols)
    radius = max(1, int(getattr(key.rule, "radius", 1)))
    per = (shard_h * shard_w + 2 * radius * (shard_h + shard_w)) * itemsize
    per *= MESH_COPIES
    return {f"{r}x{c}": per for r in range(rows) for c in range(cols)}


def default_per_device_bytes() -> int:
    """Default memory per resolved device — the denominator of the
    mesh-eligibility hint when no slice is configured locally.  Memoized
    alongside :func:`default_budget` (same bounded probe)."""
    global _DEFAULT_PER_DEVICE
    with _DEFAULT_LOCK:
        if _DEFAULT_PER_DEVICE is None:
            from tpu_life_torch.utils.platform import device_info

            _, kind = device_info(timeout_s=BUDGET_PROBE_TIMEOUT_S)
            _DEFAULT_PER_DEVICE = DEFAULT_BYTES_PER_DEVICE.get(
                kind, DEFAULT_BYTES_PER_DEVICE["host"]
            )
        return _DEFAULT_PER_DEVICE


def mesh_min_devices(key, per_device_bytes: int) -> int:
    """Smallest mesh slice (device count) whose per-device share holds
    ``key``'s slice total — the machine-readable "minimum slice size" a
    never-fits 413 carries so clients and the router can target a
    mesh-capable fleet instead of giving up."""
    total = estimate_mesh_bytes(key)
    per_device_bytes = max(1, int(per_device_bytes))
    return max(2, -(-total // per_device_bytes))


def mesh_hint(key, budget: int | None, mesh_devices: int = 0):
    """``(mesh_eligible, min_devices)`` for a never-fits rejection.

    Eligible means "a mesh-capable fleet can run this": the rule has a
    sharded path (deterministic or continuous — the stochastic tier has
    no sharded Monte-Carlo executor) and the key is not already a mesh
    key (a mesh slice that still overflows its budget is hopeless, not
    resubmittable).  ``min_devices`` divides the slice total by the
    per-device share — the local slice's (``budget / mesh_devices``)
    when one is configured, the platform default otherwise.
    """
    if getattr(key.rule, "stochastic", False):
        return False, None
    if str(getattr(key, "backend", "")).startswith("mesh:"):
        return False, None
    if mesh_devices and budget:
        per_device = max(1, int(budget) // int(mesh_devices))
    else:
        per_device = default_per_device_bytes()
    return True, mesh_min_devices(key, per_device)


def default_budget() -> int:
    """The derived budget: ``devices x DEFAULT_BYTES_PER_DEVICE[kind]``,
    resolved once per process through the watchdogged device probe
    (``utils.platform.device_info``) and memoized — a wedged plugin
    costs one bounded wait, then every later service construction is
    free."""
    global _DEFAULT_BUDGET
    with _DEFAULT_LOCK:
        if _DEFAULT_BUDGET is None:
            from tpu_life_torch.utils.platform import device_info

            devices, kind = device_info(timeout_s=BUDGET_PROBE_TIMEOUT_S)
            per = DEFAULT_BYTES_PER_DEVICE.get(kind, DEFAULT_BYTES_PER_DEVICE["host"])
            _DEFAULT_BUDGET = max(1, devices) * per
        return _DEFAULT_BUDGET


def resolve_budget(configured: int | None, *, device=None) -> int | None:
    """``ServeConfig.memory_budget_bytes`` -> the effective budget.

    ``None`` derives the per-device default (one CPU's when the service
    runs on ``device`` cpu); ``<= 0`` is the explicit opt-out (accounting
    disabled, returned as None)."""
    if configured is None:
        if device is not None and str(device).startswith("cpu"):
            from tpu_life_torch.utils.platform import device_info

            devices, kind = device_info(device=device)
            return devices * DEFAULT_BYTES_PER_DEVICE[kind]
        return default_budget()
    configured = int(configured)
    return configured if configured > 0 else None


def check_admission(
    key,
    reserved: dict,
    budget: int | None,
    capacity: int,
    *,
    mc_packed: bool = True,
    mesh_devices: int = 0,
) -> None:
    """Raise :class:`InsufficientMemory` when admitting a session of
    ``key`` would overflow ``budget``.

    ``reserved`` maps every key already holding (or about to hold) an
    engine — live engines plus the distinct keys of queued sessions —
    to its estimated bytes.  A key already reserved admits for free:
    its batch is preallocated and a new session only occupies an
    existing slot.
    """
    if budget is None or key in reserved:
        return
    need = estimate_engine_bytes(key, capacity, mc_packed=mc_packed)
    if need > budget:
        eligible, min_dev = mesh_hint(key, budget, mesh_devices)
        raise InsufficientMemory(
            f"session's engine needs ~{need} bytes "
            f"(capacity {capacity}, shape {key.shape[0]}x{key.shape[1]}, "
            f"backend {key.backend}) but the memory budget is {budget} "
            f"bytes — it can never fit; shrink the board or raise "
            f"--memory-budget-bytes"
            + (
                f" (mesh-eligible: a slice of >= {min_dev} devices holds it)"
                if eligible
                else ""
            ),
            transient=False,
            estimated_bytes=need,
            budget_bytes=budget,
            mesh_eligible=eligible,
            min_devices=min_dev,
        )
    held = sum(reserved.values())
    if held + need > budget:
        raise InsufficientMemory(
            f"admitting this CompileKey needs ~{need} bytes but "
            f"{held} of the {budget}-byte budget is held by "
            f"{len(reserved)} resident key(s); retry after they drain "
            f"(or release_idle_engines)",
            transient=True,
            estimated_bytes=need,
            budget_bytes=budget,
        )


def reserved_bytes(
    engines: dict, queued_keys, capacity: int, *, mc_packed: bool = True
) -> dict:
    """The reserved-key map :func:`check_admission` consumes: every live
    engine's key plus every distinct CompileKey waiting in the queue
    (its engine will be minted at admit), each at its estimate."""
    out = {}
    for key in engines:
        out[key] = estimate_engine_bytes(key, capacity, mc_packed=mc_packed)
    for key in queued_keys:
        if key not in out:
            out[key] = estimate_engine_bytes(key, capacity, mc_packed=mc_packed)
    return out


def _reset_default_budget_for_tests() -> None:
    global _DEFAULT_BUDGET
    with _DEFAULT_LOCK:
        _DEFAULT_BUDGET = None
