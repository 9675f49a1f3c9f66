"""tpu_life_torch.serve.mesh_engine: the mega-board mesh engine tier (the
port of ``tpu_life/serve/mesh_engine.py``).

A :class:`MeshEngine` speaks the pump's ``dispatch_chunk`` /
``collect_chunk`` / ``settle`` contract (serve/engine.py) on top of the
port's sharded backend (backends/sharded_backend.py — halo exchange on
both mesh axes, kernels K3 and K4 per shard), so a session whose estimate
says "never fits" is *placed* on a reserved multi-device slice instead of
rejected, coexisting with batched small sessions on the remaining
capacity.  On one card the slice is ``R x C`` shards of that card: the
same halo copies and launches as ``R x C`` cards.

Key differences from the single-board-per-slot engines:

- **capacity is pinned to 1** — the mega-board owns its slice.
- **compute is deferred** like :class:`SlotLoopEngine`: ``dispatch``
  records intent, ``collect`` runs the halo-exchange blocks under a
  ``mesh.halo-exchange`` trace span.
- **durability is shard-wise**: :meth:`MeshEngine.spill_tiles` walks the
  runner's shards and yields one logical-cell tile per shard;
  :meth:`MeshEngine.load_tiles` re-enters a spilled tile set, each
  destination shard pulling its own cell rectangle, onto a possibly
  different mesh shape — the full board is never materialized on one host
  in either direction.
"""

from __future__ import annotations

import numpy as np

from tpu_life_torch import obs
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.serve.engine import EngineBase

__all__ = [
    "MeshEngine",
    "mesh_backend_name",
    "parse_mesh_backend",
    "plan_mesh_shape",
]


def mesh_backend_name(shape: tuple[int, int]) -> str:
    """The ``CompileKey.backend`` encoding of a mesh placement — e.g.
    ``"mesh:2x4"``.  Kept inside the key so engines (and the engine
    cache, and crash recovery) rebuild purely from the key."""
    r, c = shape
    return f"mesh:{int(r)}x{int(c)}"


def parse_mesh_backend(backend: str) -> tuple[int, int] | None:
    """``"mesh:RxC"`` -> ``(R, C)``; ``None`` for non-mesh backends."""
    if not str(backend).startswith("mesh:"):
        return None
    spec = str(backend)[len("mesh:") :]
    try:
        r_s, c_s = spec.split("x", 1)
        r, c = int(r_s), int(c_s)
    except ValueError:
        raise ValueError(f"malformed mesh backend {backend!r} (want mesh:RxC)")
    if r < 1 or c < 1 or r * c < 2:
        raise ValueError(f"mesh backend {backend!r} needs at least 2 devices")
    return (r, c)


def plan_mesh_shape(
    devices: int, shape: tuple[int, int], rule: Rule
) -> tuple[int, int] | None:
    """Deterministic mesh shape for ``devices`` chips over an ``h x w``
    board, or ``None`` when no legal factorization exists.

    Preference order: most-square factorization first (least halo
    perimeter per shard), rows-major on ties — the same instinct as the
    paper's stripe decomposition, generalized to 2-D.  A factorization
    is legal when every shard still spans at least one halo radius on
    each axis, and (torus boundary only) when the board divides exactly
    — the closed-ring scaffold cannot pad a wrapped axis.
    """
    h, w = int(shape[0]), int(shape[1])
    devices = int(devices)
    if devices < 2:
        return None
    cands = [(devices // c, c) for c in range(1, devices + 1) if devices % c == 0]
    cands.sort(key=lambda rc: (abs(rc[0] - rc[1]), -rc[0]))
    radius = max(1, int(getattr(rule, "radius", 1)))
    torus = getattr(rule, "boundary", "clamped") == "torus"
    for r, c in cands:
        if torus and (h % r or w % c):
            continue
        if h // r < radius or w // c < radius:
            continue
        return (r, c)
    return None


def slice_device(device, mesh_shape: tuple[int, int]):
    """The device every shard of a ``mesh_shape`` slice lies on: ``device``
    when the caller names one (the CPU, or one card), else None (one shard
    a card) when the machine has a card for each shard, else the current
    card, which then holds every shard."""
    if device is not None:
        return device
    import torch

    r, c = mesh_shape
    if torch.cuda.is_available() and torch.cuda.device_count() < r * c:
        return "cuda"
    return None


class MeshEngine(EngineBase):
    """A capacity-1 engine whose single board is sharded over a 2-D
    device mesh with halo exchange — the serving face of the
    paper's stripe decomposition.  Built entirely from its
    :class:`CompileKey` (backend ``mesh:RxC``), like every other engine,
    so crash recovery and the engine cache need no extra state."""

    def __init__(self, key, chunk_steps: int, *, device=None):
        from tpu_life_torch.backends.sharded_backend import ShardedBackend

        if getattr(key.rule, "stochastic", False):
            raise ValueError(
                f"rule {key.rule.name!r} is stochastic: the mesh tier has no "
                "sharded Monte-Carlo path; submit at single-chip scale"
            )
        mesh_shape = parse_mesh_backend(key.backend)
        if mesh_shape is None:
            raise ValueError(f"MeshEngine needs a mesh:RxC backend, got {key.backend!r}")
        super().__init__(key, 1, chunk_steps)
        self.mesh_shape = mesh_shape
        stencil = self.stencil or "roll"
        self._backend = ShardedBackend(
            mesh_shape=mesh_shape, stencil=stencil, device=slice_device(device, mesh_shape)
        )
        self._runners: dict[int, object] = {}

    # -- mesh identity ------------------------------------------------

    @property
    def devices(self) -> int:
        r, c = self.mesh_shape
        return r * c

    def _mesh_label(self) -> str:
        r, c = self.mesh_shape
        return f"{r}x{c}"

    # -- EngineBase hooks ---------------------------------------------

    def _load_slot(self, slot: int, board: np.ndarray, steps: int) -> None:
        self._runners[slot] = self._backend.prepare(board, self.key.rule)
        self.compile_count += 1

    def _clear_slot(self, slot: int) -> None:
        self._runners.pop(slot, None)

    def _dispatch_impl(self) -> None:
        # deferred, like SlotLoopEngine: the halo-exchange scan runs at
        # collect time so dispatch stays non-blocking for the pump
        pass

    def _collect_impl(self, advanced: dict[int, int]) -> None:
        for slot, steps in advanced.items():
            runner = self._runners.get(slot)
            if runner is None:
                continue
            with obs.span(
                "mesh.halo-exchange",
                mesh=self._mesh_label(),
                steps=int(steps),
                stencil=self.stencil or "roll",
            ):
                runner.advance(int(steps))
                runner.sync()

    def _peek_board(self, slot: int) -> np.ndarray:
        # a full-board gather: fine for result fetch / recovery salvage,
        # but the spill path goes through spill_tiles() instead
        return np.asarray(self._runners[slot].fetch())

    # -- shard-wise durability ----------------------------------------

    def spill_tiles(self, slot: int):
        """``(tiles, lag)`` where tiles is a list of ``(r0, c0, cells)``
        — one per addressable shard, padding stripped.  Never gathers
        the board: each host reads only its own shards' bytes."""
        if slot not in self._runners:
            raise KeyError(f"slot {slot} has no runner")
        lag = self._inflight.get(slot, 0)
        h, w = self.key.shape
        runner = self._runners[slot]
        tiles = list(
            self._backend.iter_runner_tiles(runner, h, w, self.key.rule)
        )
        return tiles, lag

    def load_tiles(self, slot: int, load_block, steps: int, *, start_step: int = 0) -> None:
        """The re-gather face of :meth:`spill_tiles`: occupy ``slot``
        from a rectangular block loader (``load_block(r0, r1, c0, c1)``)
        instead of a materialized board.  Each destination shard pulls
        its own rectangle — the tile set may have been written by a mesh
        of any other shape (arXiv 2112.01075)."""
        if slot in self._inflight or slot in self._lost:
            raise RuntimeError(f"slot {slot} is in flight; collect or salvage first")
        h, w = self.key.shape
        with obs.span(
            "mesh.regather",
            mesh=self._mesh_label(),
            height=int(h),
            width=int(w),
        ):
            self._runners[slot] = self._backend.prepare_from_blocks(
                load_block, h, w, self.key.rule
            )
        self.compile_count += 1
        self._remaining[slot] = int(steps)
