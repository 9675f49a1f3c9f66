"""The serve-tier spill store: crash-durable session state on disk (the
port of ``tpu_life/serve/spill.py``: the local store and its replicas,
whose files are byte-equal to the JAX package's; the remote HTTP store is
``serve/spill_http.py``).

Durable sessions (docs/SERVING.md "durability", docs/FLEET.md
"failover") rest on the runtime's crash-consistent snapshot contract
(``runtime.checkpoint``): a spilled session is a **board file in the
contract codec** — atomic publish, CRC32 sidecar, intact-check demotion —
plus a tiny JSON manifest carrying everything a *different* process
needs to resume the trajectory bit-exactly:

- the rule spec (``get_rule`` round-trips every registered name and
  parameterized ``noisy:`` spec),
- the absolute step budget and the PRNG ``seed`` / ising ``temperature``
  (the counter-based key schedule makes a mid-stream restart re-enter
  the exact stream — docs/STOCHASTIC.md),
- the remaining deadline budget at spill time (deadlines are
  monotonic-clock absolutes and do not survive a process boundary).

The snapshot's own sidecar records the **absolute completed step** the
board corresponds to, so ``steps remaining = steps_total - step`` and a
resumed deterministic rule (pure function of the board) or stochastic
rule (pure function of ``(seed, step, cell, substream)``) finishes
byte-identical to the uninterrupted run.

Layout: ``<root>/<sid>/board_<step>.txt`` (+ ``.json`` / ``.crc``
sidecars) and ``<root>/<sid>/manifest.json``.  Retention keeps the
newest two snapshots per session (``prune_snapshots``); retire / cancel
/ failure deletes the whole session directory — a spill outliving its
session is exactly the resurrection bug failover must not have.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from tpu_life_torch import chaos
from tpu_life_torch.io.codec import read_board
from tpu_life_torch.runtime.checkpoint import (
    atomic_publish,
    crc_path,
    list_snapshots,
    prune_snapshots,
    save_snapshot,
    snapshot_intact,
    snapshot_path,
)
from tpu_life_torch.runtime.metrics import log

#: Snapshots retained per session (newest N): one extra generation so a
#: crash mid-publish of the newest still leaves an intact predecessor.
KEEP_SNAPSHOTS = 2

MANIFEST = "manifest.json"

#: Marker published when spill is disabled for a session (a write failure
#: — ENOSPC, a dead disk).  The session keeps running WITHOUT durability;
#: the marker makes the degradation visible to the migration tier, which
#: answers the sid's post-death requests 410 ``spill_disabled`` instead
#: of the misleading ``never_snapshotted``.
DISABLED = "DISABLED.json"


class SpillBackend:
    """The pluggable durability seam (docs/FLEET.md "Cross-host
    topology"): where a worker's spilled sessions live.

    Two implementations ship: :class:`SpillStore` (a local directory —
    the default, and the only choice when the rescuing migrator shares a
    filesystem with the victim) and
    :class:`tpu_life_torch.serve.spill_http.HttpSpillBackend` (a remote HTTP
    object store any worker or supervisor can host, so migration works
    when the survivor is on another machine).  Both speak the same
    contract the service's spill pass relies on:

    - ``save`` publishes atomically with a CRC32 witness and returns
      False for a no-op rewrite of the newest spilled step;
    - any write failure raises :class:`OSError` — the service catches it
      in the unlocked settle window and degrades THAT session to
      spill-disabled (the pump never stalls, the worker never dies over
      durability);
    - ``mark_disabled`` / ``delete`` are best-effort terminal
      transitions; ``spilled_count`` / ``spilled_sids`` feed the gauges.
    """

    def save(
        self,
        sid: str,
        board: np.ndarray,
        step: int,
        *,
        rule: str,
        steps_total: int,
        seed: int | None,
        temperature: float | None,
        timeout_s: float | None,
        trace_id: str | None = None,
        edits: list | None = None,
        scheduled_edits: list | None = None,
        stream_seq: int = 0,
    ) -> bool:
        raise NotImplementedError

    def mark_disabled(self, sid: str) -> None:
        raise NotImplementedError

    def delete(self, sid: str) -> None:
        raise NotImplementedError

    def spilled_count(self) -> int:
        raise NotImplementedError

    def spilled_sids(self) -> list[str]:
        raise NotImplementedError

    #: Shard-wise spill capability (docs/SERVING.md "Mega-board
    #: sessions"): backends that can persist a mega-board session as
    #: per-shard tiles override :meth:`save_mesh` and flip this True.
    #: The service checks the flag before a mesh session's spill round —
    #: a backend without the tile contract (the remote HTTP store, for
    #: now) degrades that session to spill-disabled rather than
    #: gathering the full board just to ship it.
    SUPPORTS_MESH = False

    def save_mesh(
        self,
        sid: str,
        tiles,
        step: int,
        *,
        rule: str,
        steps_total: int,
        seed: int | None,
        temperature: float | None,
        timeout_s: float | None,
        height: int,
        width: int,
        mesh: tuple[int, int],
        trace_id: str | None = None,
        edits: list | None = None,
        scheduled_edits: list | None = None,
        stream_seq: int = 0,
    ) -> bool:
        raise NotImplementedError(
            "this spill backend has no shard-wise tile contract"
        )


def make_spill_backend(
    *,
    spill_dir: str | None = None,
    spill_url: str | None = None,
    namespace: str | None = None,
    replicas: int = 1,
) -> "SpillBackend":
    """The one place a serve config becomes a backend: a ``spill_url``
    selects the remote HTTP store (``namespace`` names this worker
    incarnation's slice of it), otherwise the local directory —
    replicated across ``replicas`` sub-stores when > 1
    (``--spill-replicas``).  Both stores at once is a typed config error
    — the session would be split across two stores and neither would
    hold a resumable whole."""
    if spill_url is not None and spill_dir is not None:
        raise ValueError(
            "spill_dir and spill_url are mutually exclusive — a session "
            "spilled half-local, half-remote could never be resumed whole"
        )
    if replicas < 1:
        raise ValueError(f"spill replicas must be >= 1, got {replicas}")
    if spill_url is not None:
        if replicas > 1:
            raise ValueError(
                "spill replication is a local-directory feature; the "
                "remote HTTP store owns its own durability"
            )
        from tpu_life_torch.serve.spill_http import HttpSpillBackend

        return HttpSpillBackend(spill_url, namespace or "default")
    if replicas > 1:
        return ReplicatedSpillBackend(spill_dir, replicas)
    return SpillStore(spill_dir)


@dataclass(frozen=True)
class SpillRecord:
    """One resumable session read back from a spill directory."""

    sid: str  # the spilling worker's own session id
    rule: str  # rule spec (round-trips through get_rule)
    board: np.ndarray  # board at ``step`` (int8, contract codec bytes)
    step: int  # absolute steps completed at the snapshot
    steps_total: int  # absolute step budget of the whole session
    seed: int | None
    temperature: float | None
    timeout_s: float | None  # deadline budget remaining at spill time
    height: int
    width: int
    #: distributed-trace context (docs/OBSERVABILITY.md): persisting it
    #: here is what lets a migrated resume CONTINUE the dead worker's
    #: trace instead of starting a fresh one — None for pre-trace spills
    trace_id: str | None = None
    #: the steered-session fields (docs/STREAMING.md): the applied edit
    #: log (steps <= ``step``; already baked into ``board`` — carried for
    #: provenance), the not-yet-applied tail the survivor must re-apply
    #: at exactly the recorded steps, and the stream-sequence floor a
    #: reconnected watcher's gapless numbering continues from.  None /
    #: None / 0 for never-steered, never-watched sessions (the manifest
    #: omits the keys entirely, keeping pre-stream manifests byte-stable).
    edits: list | None = None
    scheduled_edits: list | None = None
    stream_seq: int = 0

    @property
    def remaining(self) -> int:
        return max(0, self.steps_total - self.step)


def _tile_dirname(r0: int, c0: int) -> str:
    return f"tile_r{int(r0):09d}_c{int(c0):09d}"


@dataclass(frozen=True)
class MeshSpillRecord:
    """One resumable mega-board session read back from a tile-set spill
    (docs/SERVING.md "Mega-board sessions").

    Unlike :class:`SpillRecord` it carries **no board**: the tiles stay
    on disk and :meth:`block_loader` hands out a rectangular reader the
    resuming mesh feeds to ``MeshEngine.load_tiles`` — each destination
    shard pulls exactly its own cell rectangle (possibly on a different
    mesh shape than the one that spilled; arXiv 2112.01075), so the full
    board is never materialized on one host on either side.
    """

    sid: str
    rule: str
    step: int  # absolute steps completed at the chosen tile epoch
    steps_total: int
    seed: int | None
    temperature: float | None
    timeout_s: float | None
    height: int
    width: int
    mesh_shape: tuple[int, int]  # the SPILLING mesh's shape (provenance)
    tiles: tuple  # ((r0, c0, th, tw), ...) covering the board
    root: Path  # the session's spill directory (holds the tile dirs)
    trace_id: str | None = None
    scheduled_edits: list | None = None
    stream_seq: int = 0

    @property
    def remaining(self) -> int:
        return max(0, self.steps_total - self.step)

    def block_loader(self):
        """``load_block(r0, r1, c0, c1) -> cells`` over the tile set at
        this record's epoch.  Reads only the tiles the rectangle
        intersects, one at a time (single-tile cache) — the memory high
        water is one tile plus the requested block, never the board."""
        from tpu_life_torch.models.rules import get_rule

        continuous = bool(getattr(get_rule(self.rule), "continuous", False))
        dtype = np.float32 if continuous else np.int8
        step = self.step
        tiles = self.tiles
        root = self.root
        cache: dict = {}

        def load_block(r0: int, r1: int, c0: int, c1: int) -> np.ndarray:
            out = np.zeros((r1 - r0, c1 - c0), dtype=dtype)
            for tr0, tc0, th, tw in tiles:
                ir0, ir1 = max(r0, tr0), min(r1, tr0 + th)
                ic0, ic1 = max(c0, tc0), min(c1, tc0 + tw)
                if ir0 >= ir1 or ic0 >= ic1:
                    continue
                key = (tr0, tc0)
                if key not in cache:
                    cache.clear()  # one tile resident at a time
                    f = snapshot_path(root / _tile_dirname(tr0, tc0), step)
                    cache[key] = read_board(f, th, tw)
                tile = cache[key]
                out[ir0 - r0 : ir1 - r0, ic0 - c0 : ic1 - c0] = tile[
                    ir0 - tr0 : ir1 - tr0, ic0 - tc0 : ic1 - tc0
                ]
            return out

        return load_block


class SpillStore(SpillBackend):
    """Per-session spill directories under one root (one root per worker).

    Writes happen on the pump thread only; ``delete`` may be called from
    verb threads (cancel) — both ends are plain filesystem operations on
    disjoint per-session directories, and every publish is atomic, so no
    extra locking is needed beyond the service's own.
    """

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        # per-sid steps this store wrote (prune only ever touches its own
        # writes — the checkpoint retention contract)
        self._written: dict[str, list[int]] = {}
        # per-sid edit-log length at the last save: a same-step save with
        # a grown log must not dedup away (the queued-edit case)
        self._edit_counts: dict[str, int] = {}

    def save(
        self,
        sid: str,
        board: np.ndarray,
        step: int,
        *,
        rule: str,
        steps_total: int,
        seed: int | None,
        temperature: float | None,
        timeout_s: float | None,
        trace_id: str | None = None,
        edits: list | None = None,
        scheduled_edits: list | None = None,
        stream_seq: int = 0,
    ) -> bool:
        """Spill one session's state; returns False when ``step`` is
        already the newest spilled step (a queued or retire-lagged
        session — rewriting identical bytes would be pure churn).  A
        same-step save with a GROWN edit log still writes: a queued
        session steered before admission changed state the manifest must
        carry, even though its step did not move."""
        written = self._written.setdefault(sid, [])
        edit_count = len(edits or []) + len(scheduled_edits or [])
        if (
            written
            and written[-1] == step
            and self._edit_counts.get(sid, 0) == edit_count
        ):
            return False
        d = self.root / sid
        # chaos seam (docs/CHAOS.md): a disk-full / dead-disk write fails
        # HERE, inside the store, exactly where a real one would — the
        # service's spill pass catches the OSError, counts it, and
        # degrades the session to spill-disabled instead of dying
        chaos.inject("spill.write")
        save_snapshot(d, step, board, rule=rule)
        self._maybe_corrupt(d, step)
        manifest = {
            "sid": sid,
            "rule": rule,
            "steps_total": int(steps_total),
            "seed": seed,
            "temperature": temperature,
            "timeout_s": timeout_s,
            "trace_id": trace_id,
            "height": int(board.shape[0]),
            "width": int(board.shape[1]),
        }
        # the steered-session keys appear ONLY when set: a never-steered,
        # never-watched session's manifest stays byte-stable across PRs
        if edits:
            manifest["edits"] = edits
        if scheduled_edits:
            manifest["scheduled_edits"] = scheduled_edits
        if stream_seq:
            manifest["stream_seq"] = int(stream_seq)
        with atomic_publish(d / MANIFEST) as tmp:
            tmp.write_text(json.dumps(manifest))
        if not written or written[-1] != step:
            written.append(step)
        self._edit_counts[sid] = edit_count
        self._written[sid] = prune_snapshots(d, KEEP_SNAPSHOTS, written)
        return True

    SUPPORTS_MESH = True

    def save_mesh(
        self,
        sid: str,
        tiles,
        step: int,
        *,
        rule: str,
        steps_total: int,
        seed: int | None,
        temperature: float | None,
        timeout_s: float | None,
        height: int,
        width: int,
        mesh: tuple[int, int],
        trace_id: str | None = None,
        edits: list | None = None,
        scheduled_edits: list | None = None,
        stream_seq: int = 0,
    ) -> bool:
        """Shard-wise spill of one mega-board session: ``tiles`` is the
        ``(r0, c0, cells)`` walk from ``MeshEngine.spill_tiles`` — one
        tile per addressable shard, each published atomically into its
        own ``tile_rNNN_cNNN/`` directory with its own CRC32 sidecar,
        then the sharded manifest.  The publish order is the recovery
        contract: the manifest's tile table is only ever written after
        every tile of ``step`` landed, and ``read_mesh_sessions``
        demotes the WHOLE set to the predecessor epoch if any single
        tile of the newest fails its intact check — a resumed mesh
        session is never a mixed-epoch board."""
        written = self._written.setdefault(sid, [])
        edit_count = len(edits or []) + len(scheduled_edits or [])
        if (
            written
            and written[-1] == step
            and self._edit_counts.get(sid, 0) == edit_count
        ):
            return False
        d = self.root / sid
        tile_table = []
        for r0, c0, cells in tiles:
            td = d / _tile_dirname(r0, c0)
            # same chaos seams as the single-board path, fired per tile:
            # each host writes its own shards, so disk-full and disk-rot
            # strike tile-by-tile (docs/CHAOS.md)
            chaos.inject("spill.write")
            save_snapshot(td, step, cells, rule=rule)
            self._maybe_corrupt(td, step)
            tile_table.append(
                [int(r0), int(c0), int(cells.shape[0]), int(cells.shape[1])]
            )
        manifest = {
            "sid": sid,
            "rule": rule,
            "steps_total": int(steps_total),
            "seed": seed,
            "temperature": temperature,
            "timeout_s": timeout_s,
            "trace_id": trace_id,
            "height": int(height),
            "width": int(width),
            "mesh": {
                "shape": [int(mesh[0]), int(mesh[1])],
                "tiles": tile_table,
            },
        }
        if edits:
            manifest["edits"] = edits
        if scheduled_edits:
            manifest["scheduled_edits"] = scheduled_edits
        if stream_seq:
            manifest["stream_seq"] = int(stream_seq)
        with atomic_publish(d / MANIFEST) as tmp:
            tmp.write_text(json.dumps(manifest))
        if not written or written[-1] != step:
            written.append(step)
        self._edit_counts[sid] = edit_count
        pruned = written
        for r0, c0, _ in tiles:
            pruned = prune_snapshots(d / _tile_dirname(r0, c0), KEEP_SNAPSHOTS, written)
        self._written[sid] = pruned
        return True

    def adopt_mesh(self, sid: str, src: str | os.PathLike) -> Path | None:
        """Take ownership of a spilled tile set by renaming it into this
        store under ``sid`` (atomic on one filesystem) — the resume-time
        ownership transfer: the survivor's store now holds the tiles, so
        the victim-directory cleanup finds nothing to delete and the
        adopted session is durable from its first round (no fresh spill
        needed before the next crash).  Returns the adopted directory,
        or None when the rename cannot be done (cross-device, missing
        source) — the caller then reads the tiles in place."""
        dest = self.root / sid
        try:
            os.replace(os.fspath(src), dest)
        except OSError:
            return None
        # seed retention bookkeeping from the adopted tiles so later
        # save_mesh rounds prune the inherited epochs too
        steps: set[int] = set()
        for td in dest.iterdir():
            if td.is_dir() and td.name.startswith("tile_"):
                steps.update(step for step, _ in list_snapshots(td))
        self._written[sid] = sorted(steps)
        return dest

    def _maybe_corrupt(self, d: Path, step: int) -> None:
        """Chaos seam: bit-flip (or truncate) the just-published snapshot
        bytes — the disk-rot drill.  The CRC sidecar stays truthful to the
        ORIGINAL bytes, so the intact check must demote this snapshot to
        its predecessor instead of resuming garbage."""
        if not chaos.armed():
            return
        p = snapshot_path(d, step)
        data = p.read_bytes()
        mangled = chaos.corrupt("snapshot.corrupt", data)
        if mangled is not data:
            p.write_bytes(mangled)

    def mark_disabled(self, sid: str) -> None:
        """Degrade one session to spill-disabled (a write failure — the
        disk is full or dying): its snapshots are dropped — bytes we can
        no longer keep fresh must not masquerade as a recovery point —
        and a marker is published so a post-death migration answers the
        truthful 410 ``spill_disabled``.  Best-effort: on a disk this
        broken even the marker write may fail, which degrades the reason
        to ``never_snapshotted`` — still a truthful 410."""
        self._written.pop(sid, None)
        self._edit_counts.pop(sid, None)
        d = self.root / sid
        try:
            if d.exists():
                for step, f in list_snapshots(d):
                    f.unlink(missing_ok=True)
                    f.with_suffix(".json").unlink(missing_ok=True)
                    crc_path(f).unlink(missing_ok=True)
                (d / MANIFEST).unlink(missing_ok=True)
            d.mkdir(parents=True, exist_ok=True)
            with atomic_publish(d / DISABLED) as tmp:
                tmp.write_text(json.dumps({"sid": sid, "reason": "spill_error"}))
        except OSError:
            log.warning("spill: could not publish disabled marker for %s", sid)

    def delete(self, sid: str) -> None:
        """Drop a session's spill (terminal transition: done / failed /
        cancelled) — from here on the session must never resume."""
        self._edit_counts.pop(sid, None)
        if self._written.pop(sid, None) is not None or (self.root / sid).exists():
            shutil.rmtree(self.root / sid, ignore_errors=True)

    def spilled_count(self) -> int:
        return len(self._written)

    def spilled_sids(self) -> list[str]:
        return list(self._written)


#: Replica sub-directory prefix under a replicated spill root:
#: ``<root>/replica-0`` .. ``replica-N-1``, each a complete
#: :class:`SpillStore` layout of its own.
REPLICA_PREFIX = "replica-"


class ReplicatedSpillBackend(SpillBackend):
    """N-way replicated local spill: every write fans through N
    :class:`SpillStore` instances rooted at ``<root>/replica-i`` — same
    atomic publish, same CRC32 witness, N independent copies.

    The failure contract is majority-free reads-any: a write that lands
    on AT LEAST ONE replica is durable (a dead replica disk degrades
    redundancy, not the session), and only when EVERY replica refuses
    does the save raise — the service then degrades that session to
    spill-disabled exactly as with a single store.  The read side
    (:func:`read_spill_sessions` / :func:`read_mesh_sessions`) detects
    the replica layout under a worker's spill dir and merges per sid:
    the intact record with the highest step wins, a torn or bit-rotted
    replica silently demotes to its peers, and a sid is only ``corrupt``
    when NO replica yields a resumable record.  The migrator and the
    mesh resume path are unchanged — they keep calling the same readers
    on the same worker spill directory.
    """

    SUPPORTS_MESH = True

    def __init__(self, root: str | os.PathLike, replicas: int):
        if replicas < 2:
            raise ValueError(
                f"a replicated spill needs >= 2 replicas, got {replicas}"
            )
        self.root = Path(root)
        self.stores = [
            SpillStore(self.root / f"{REPLICA_PREFIX}{i}")
            for i in range(replicas)
        ]

    def _fan_save(self, op: str, sid: str, args, kw) -> bool:
        wrote = False
        errors: list[OSError] = []
        for s in self.stores:
            try:
                wrote = getattr(s, op)(sid, *args, **kw) or wrote
            except OSError as e:
                errors.append(e)
        if errors:
            if len(errors) == len(self.stores):
                # every copy refused: this IS a spill failure — the
                # caller degrades the session like a single-store error
                raise errors[0]
            log.warning(
                "spill: %d/%d replicas failed the %s for %s (%s) — "
                "redundancy degraded, session still durable",
                len(errors),
                len(self.stores),
                op,
                sid,
                errors[0],
            )
        return wrote

    def save(self, sid, board, step, **kw) -> bool:
        return self._fan_save("save", sid, (board, step), kw)

    def save_mesh(self, sid, tiles, step, **kw) -> bool:
        # tiles may be a generator (the mesh spill walk): materialize
        # once so every replica writes the same epoch
        return self._fan_save("save_mesh", sid, (list(tiles), step), kw)

    def mark_disabled(self, sid: str) -> None:
        for s in self.stores:
            s.mark_disabled(sid)

    def delete(self, sid: str) -> None:
        for s in self.stores:
            s.delete(sid)

    def spilled_count(self) -> int:
        return len(self.spilled_sids())

    def spilled_sids(self) -> list[str]:
        sids: set[str] = set()
        for s in self.stores:
            sids.update(s.spilled_sids())
        return sorted(sids)


def _replica_roots(rootp: Path) -> list[Path]:
    """The replica sub-stores under a replicated spill root (empty for a
    plain single-store layout), numerically ordered."""
    if not rootp.is_dir():
        return []
    reps = [
        p
        for p in rootp.iterdir()
        if p.is_dir()
        and p.name.startswith(REPLICA_PREFIX)
        and p.name[len(REPLICA_PREFIX):].isdigit()
    ]
    return sorted(reps, key=lambda p: int(p.name[len(REPLICA_PREFIX):]))


def _merge_replica_reads(outcomes):
    """Fold per-replica ``(records, corrupt, disabled)`` triples into one
    reads-any verdict per sid: best intact record (highest step) wins; a
    disabled marker anywhere wins over stale records (the worker dropped
    those bytes on purpose); ``corrupt`` only when no replica resumes."""
    best: dict[str, object] = {}
    corrupt_sids: set[str] = set()
    disabled_sids: set[str] = set()
    for records, corrupt, disabled in outcomes:
        for rec in records:
            prev = best.get(rec.sid)
            if prev is None or rec.step > prev.step:
                best[rec.sid] = rec
        corrupt_sids.update(corrupt)
        disabled_sids.update(disabled)
    merged = [best[sid] for sid in sorted(best) if sid not in disabled_sids]
    corrupt = sorted(
        s for s in corrupt_sids if s not in best and s not in disabled_sids
    )
    return merged, corrupt, sorted(disabled_sids)


def read_spill_sessions(
    root: str | os.PathLike,
) -> tuple[list[SpillRecord], list[str], list[str]]:
    """Read every resumable session under a (dead worker's) spill root.

    Returns ``(records, corrupt_sids, disabled_sids)``: a session whose
    manifest is unreadable or whose snapshots all fail the intact check
    (size + CRC) lands in ``corrupt_sids`` — the migration tier answers
    those with a typed 410 ``spill_corrupt`` instead of resuming
    garbage — and a session the worker degraded to spill-disabled (a
    write failure; the :data:`DISABLED` marker) lands in
    ``disabled_sids`` (410 ``spill_disabled``).  A corrupt *newest*
    snapshot with an intact predecessor demotes silently (the
    recovery-point moves back one spill interval — the same contract as
    directory resume).
    """
    rootp = Path(root)
    reps = _replica_roots(rootp)
    if reps:
        # a replicated layout (docs/FLEET.md): merge per-replica reads —
        # the migrator's call site is unchanged, reads-any happens here
        return _merge_replica_reads([read_spill_sessions(r) for r in reps])
    records: list[SpillRecord] = []
    corrupt: list[str] = []
    disabled: list[str] = []
    if not rootp.is_dir():
        return records, corrupt, disabled
    for d in sorted(p for p in rootp.iterdir() if p.is_dir()):
        sid = d.name
        if (d / DISABLED).exists():
            # ownership split with read_mesh_sessions so a dead worker's
            # scan never reports the same sid twice: tile sets belong to
            # the mesh reader, everything else (including a dir whose
            # manifest is unreadable) lands here
            if not _is_mesh_dir(d):
                disabled.append(sid)
            continue
        try:
            # chaos seam: a read failure on the rescue path — the whole
            # session must land in ``corrupt`` (never crash the migration
            # run, never delete bytes nobody decoded)
            chaos.inject("spill.read")
            meta = json.loads((d / MANIFEST).read_text())
            height = int(meta["height"])
            width = int(meta["width"])
            steps_total = int(meta["steps_total"])
            rule = str(meta["rule"])
        except (OSError, ValueError, KeyError, TypeError):
            log.warning("spill: %s has no readable manifest; corrupt", d)
            corrupt.append(sid)
            continue
        if "mesh" in meta:
            # a shard-wise tile set (docs/SERVING.md "Mega-board
            # sessions") — read_mesh_sessions owns those; classifying
            # the absent top-level board file as corrupt would be wrong
            continue
        chosen = None
        for step, f in list_snapshots(d):  # newest first
            if snapshot_intact(f, height, width):
                chosen = (step, f)
                break
            log.warning("spill: %s failed the intact check; demoting", f)
        if chosen is None:
            corrupt.append(sid)
            continue
        step, f = chosen
        try:
            board = read_board(f, height, width)
        except (OSError, ValueError):
            corrupt.append(sid)
            continue
        seed = meta.get("seed")
        temperature = meta.get("temperature")
        timeout_s = meta.get("timeout_s")
        trace_id = meta.get("trace_id")
        records.append(
            SpillRecord(
                sid=sid,
                rule=rule,
                board=board,
                step=step,
                steps_total=steps_total,
                seed=None if seed is None else int(seed),
                temperature=None if temperature is None else float(temperature),
                timeout_s=None if timeout_s is None else float(timeout_s),
                height=height,
                width=width,
                trace_id=None if trace_id is None else str(trace_id),
                edits=meta.get("edits"),
                scheduled_edits=meta.get("scheduled_edits"),
                stream_seq=int(meta.get("stream_seq", 0)),
            )
        )
    return records, corrupt, disabled


def _is_mesh_dir(d: Path) -> bool:
    """Whether the session dir's manifest marks a shard-wise tile set —
    the ownership test splitting disabled dirs between
    :func:`read_spill_sessions` and :func:`read_mesh_sessions`."""
    try:
        return "mesh" in json.loads((d / MANIFEST).read_text())
    except (OSError, ValueError, TypeError):
        return False


def read_mesh_sessions(
    root: str | os.PathLike,
) -> tuple[list[MeshSpillRecord], list[str], list[str]]:
    """Read every resumable mega-board (tile-set) session under a spill
    root — the shard-wise twin of :func:`read_spill_sessions`, same
    ``(records, corrupt_sids, disabled_sids)`` contract.

    Epoch choice is all-or-nothing per step: the newest step at which
    EVERY tile passes the intact check (size + CRC32) wins; one
    bit-flipped tile demotes the whole set to the predecessor epoch — a
    resumed mesh session is never a mixed-epoch board.  No tile bytes
    are read here: records carry a :meth:`MeshSpillRecord.block_loader`
    so the resuming mesh pulls rectangles tile-by-tile at admission.
    """
    rootp = Path(root)
    reps = _replica_roots(rootp)
    if reps:
        return _merge_replica_reads([read_mesh_sessions(r) for r in reps])
    if not rootp.is_dir():
        return [], [], []
    return _read_mesh_dirs(
        sorted(p for p in rootp.iterdir() if p.is_dir())
    )


def read_mesh_session_dir(d: str | os.PathLike) -> MeshSpillRecord:
    """Read ONE tile-set session directory (the ``resume_tiles_dir``
    pointer a mesh resume submission carries) — same demotion contract
    as :func:`read_mesh_sessions`, but a non-resumable set is a typed
    ValueError (the gateway's 400), because a caller naming a specific
    directory asked for exactly it."""
    dp = Path(d)
    records, corrupt, disabled = _read_mesh_dirs([dp])
    if disabled:
        raise ValueError(f"tile set at {dp} is spill-disabled; not resumable")
    if corrupt or not records:
        raise ValueError(
            f"no resumable tile set at {dp} (missing, corrupt, or not a "
            f"mesh spill)"
        )
    return records[0]


def _read_mesh_dirs(
    dirs,
) -> tuple[list[MeshSpillRecord], list[str], list[str]]:
    records: list[MeshSpillRecord] = []
    corrupt: list[str] = []
    disabled: list[str] = []
    for d in dirs:
        sid = d.name
        if (d / DISABLED).exists():
            # mirror of read_spill_sessions' ownership split: only claim
            # the dir when the manifest says it is a tile set
            if _is_mesh_dir(d):
                disabled.append(sid)
            continue
        try:
            chaos.inject("spill.read")
            meta = json.loads((d / MANIFEST).read_text())
            if "mesh" not in meta:
                continue  # a single-board spill; read_spill_sessions owns it
            height = int(meta["height"])
            width = int(meta["width"])
            steps_total = int(meta["steps_total"])
            rule = str(meta["rule"])
            mesh_shape = tuple(int(v) for v in meta["mesh"]["shape"])
            tiles = tuple(
                (int(r0), int(c0), int(th), int(tw))
                for r0, c0, th, tw in meta["mesh"]["tiles"]
            )
        except (OSError, ValueError, KeyError, TypeError):
            log.warning("spill: %s has no readable mesh manifest; corrupt", d)
            corrupt.append(sid)
            continue
        if not tiles:
            corrupt.append(sid)
            continue
        # candidate epochs: steps present in EVERY tile directory,
        # newest first (a step missing from any tile never qualifies)
        step_sets = []
        for r0, c0, _th, _tw in tiles:
            td = d / _tile_dirname(r0, c0)
            step_sets.append({step for step, _ in list_snapshots(td)})
        common = set.intersection(*step_sets) if step_sets else set()
        chosen = None
        for step in sorted(common, reverse=True):
            ok = True
            for r0, c0, th, tw in tiles:
                f = snapshot_path(d / _tile_dirname(r0, c0), step)
                if not snapshot_intact(f, th, tw):
                    log.warning(
                        "spill: %s failed the intact check; demoting the "
                        "whole tile set past epoch %d",
                        f,
                        step,
                    )
                    ok = False
                    break
            if ok:
                chosen = step
                break
        if chosen is None:
            corrupt.append(sid)
            continue
        seed = meta.get("seed")
        temperature = meta.get("temperature")
        timeout_s = meta.get("timeout_s")
        trace_id = meta.get("trace_id")
        records.append(
            MeshSpillRecord(
                sid=sid,
                rule=rule,
                step=chosen,
                steps_total=steps_total,
                seed=None if seed is None else int(seed),
                temperature=None if temperature is None else float(temperature),
                timeout_s=None if timeout_s is None else float(timeout_s),
                height=height,
                width=width,
                mesh_shape=(mesh_shape[0], mesh_shape[1]),
                tiles=tiles,
                root=d,
                trace_id=None if trace_id is None else str(trace_id),
                scheduled_edits=meta.get("scheduled_edits"),
                stream_seq=int(meta.get("stream_seq", 0)),
            )
        )
    return records, corrupt, disabled
