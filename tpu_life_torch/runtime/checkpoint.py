"""Checkpoint / resume (a copy of ``tpu_life/runtime/checkpoint.py``).

Snapshots *are* board files in the contract codec (output format ==
input format), plus a JSON sidecar recording step, rule and geometry and a
CRC32 sidecar of the board's bytes, so ``--resume`` works on any snapshot,
or on a bare ``output.txt``.  The files are the JAX package's, byte for
byte: a snapshot either package writes resumes in the other.
"""

from __future__ import annotations

import json
import logging
import os
import re
import zlib
from contextlib import contextmanager
from pathlib import Path

import numpy as np

from tpu_life_torch.io.codec import encode_board, read_board, write_board

_SNAP_RE = re.compile(r"^board_(\d+)\.txt$")

log = logging.getLogger("tpu_life_torch")


@contextmanager
def atomic_publish(p: Path):
    """Yield a tmp path to write; publish it onto ``p`` only on success.

    A crash mid-write must never leave a truncated ``p`` — resume paths
    trust these files — and must not litter orphan tmps either: on any
    failure the tmp is unlinked, on success ``os.replace`` lands the bytes
    atomically (POSIX rename).  The tmp name is per-writer (pid): two runs
    sharing a snapshot dir, or racing writers of the same step, must not
    interleave bytes into one tmp and publish a hybrid (ADVICE r4).
    """
    tmp = p.with_suffix(f".{os.getpid()}.tmp")
    try:
        yield tmp
        os.replace(tmp, p)
    finally:
        tmp.unlink(missing_ok=True)  # no-op after a successful replace


def snapshot_path(directory: str | os.PathLike, step: int) -> Path:
    return Path(directory) / f"board_{step:09d}.txt"


def crc_path(p: Path) -> Path:
    return p.with_suffix(".crc")


def write_crc_sidecar(p: Path, crc: int) -> None:
    """Publish the board file's CRC32 next to it (``board_N.crc``).

    The size check in :func:`snapshot_intact` only catches truncation; a
    bit-flipped but right-sized snapshot would resume garbage without
    this.  Written through the same atomic publish as the board, so a
    torn CRC file is impossible — a mismatching pair (crash between the
    two publishes) simply demotes the snapshot, which is the safe answer.
    """
    with atomic_publish(crc_path(p)) as tmp:
        tmp.write_text(f"{crc:08x}")


def write_sidecar(p: Path, step: int, rule: str, height: int, width: int) -> None:
    # published atomically: snapshot_intact() demotes a snapshot whose
    # sidecar is unparseable, so a torn sidecar must be impossible even
    # under racing writers (ADVICE r4)
    meta = {"step": step, "rule": rule, "height": height, "width": width}
    with atomic_publish(p.with_suffix(".json")) as tmp:
        tmp.write_text(json.dumps(meta))


def save_snapshot(
    directory: str | os.PathLike,
    step: int,
    board: np.ndarray,
    *,
    rule: str,
) -> Path:
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    p = snapshot_path(d, step)
    # the sidecar follows the board so it never describes bytes that
    # aren't fully there; the CRC is computed from this writer's OWN
    # in-memory encoding (write_board is exactly f.write(encode_board)),
    # not a read-back — no extra filesystem pass, and it can never
    # describe a hybrid of two racing writers' bytes
    with atomic_publish(p) as tmp:
        write_board(tmp, board)
        crc = zlib.crc32(encode_board(board))
    write_crc_sidecar(p, crc)
    write_sidecar(p, step, rule, int(board.shape[0]), int(board.shape[1]))
    return p


def list_snapshots(directory: str | os.PathLike) -> list[tuple[int, Path]]:
    """All snapshots in ``directory``, newest first."""
    d = Path(directory)
    if not d.is_dir():
        return []
    found = []
    for f in d.iterdir():
        m = _SNAP_RE.match(f.name)
        if m:
            found.append((int(m.group(1)), f))
    return sorted(found, reverse=True)


def latest_snapshot(directory: str | os.PathLike) -> tuple[int, Path] | None:
    snaps = list_snapshots(directory)
    return snaps[0] if snaps else None


def snapshot_intact(p: Path, height: int, width: int) -> bool:
    """True when the snapshot's byte size matches its geometry (from the
    sidecar when present, the caller's otherwise) — a file truncated by a
    crash mid-write fails this — AND, when a ``.crc`` sidecar exists, its
    CRC32 matches the file bytes, so a corrupt-but-right-sized snapshot
    (bit rot, a torn multi-writer publish) demotes to the previous
    snapshot instead of resuming garbage.  Single-process writes publish
    atomically (``atomic_publish``) so can't be truncated; multi-process
    collective snapshot writes can, which is why directory resume checks
    this.  Snapshots from writers that predate the CRC sidecar (or the
    streamed collective writer) fall back to the size check alone."""
    h, w = height, width
    sidecar = p.with_suffix(".json")
    if sidecar.exists():
        try:
            meta = json.loads(sidecar.read_text())
            h = int(meta.get("height", h))
            w = int(meta.get("width", w))
        except (ValueError, OSError):
            return False
    try:
        # the two contract encodings (io/codec.py): ASCII digit grid
        # (discrete boards) or raw little-endian float32 (the continuous
        # tier) — their lengths can never coincide, so either size is an
        # unambiguous intact witness for its geometry
        if p.stat().st_size not in (h * (w + 1), 4 * h * w):
            return False
    except OSError:
        return False
    crc_file = crc_path(p)
    if crc_file.exists():
        try:
            expect = int(crc_file.read_text().strip(), 16)
            return zlib.crc32(p.read_bytes()) == expect
        except (ValueError, OSError):
            return False
    return True


def prune_snapshots(
    directory: str | os.PathLike, keep: int, steps: list[int]
) -> list[int]:
    """Delete all but the newest ``keep`` of the given snapshot ``steps``;
    returns the steps that remain.

    Retention only ever touches the snapshots the caller names (the current
    run's own writes) — a stale higher-numbered snapshot left by some
    earlier run is neither trusted as "newest" nor deleted; it simply isn't
    this run's to manage.  ``keep <= 0`` prunes nothing.
    """
    if keep <= 0:
        return sorted(set(steps))
    ordered = sorted(set(steps))
    drop, kept = ordered[:-keep], ordered[-keep:]
    for step in drop:
        p = snapshot_path(directory, step)
        p.unlink(missing_ok=True)
        p.with_suffix(".json").unlink(missing_ok=True)
        crc_path(p).unlink(missing_ok=True)
    return kept


def resolve_resume(
    path: str | os.PathLike, height: int, width: int
) -> tuple[Path, int, int, int]:
    """Resolve a resume target to (board_file, completed_steps, height, width)
    without reading the board — so streaming loaders can pread stripes.

    ``path`` may be a snapshot (step recovered from its sidecar/filename), a
    snapshot *directory* (latest snapshot wins), or any contract-format board
    file (completed_steps = 0 unless a sidecar says otherwise).
    """
    p = Path(path)
    if p.is_dir():
        snaps = list_snapshots(p)
        if not snaps:
            raise FileNotFoundError(f"no snapshots in {p}")
        # prefer the newest INTACT snapshot: a job killed mid-collective-
        # write can leave the newest truncated, and resuming must fall
        # back to the one before it rather than wedge forever
        for step, f in snaps:
            if snapshot_intact(f, height, width):
                if (step, f) != snaps[0]:
                    log.warning(
                        "skipping truncated snapshot %s; resuming from %s",
                        snaps[0][1],
                        f,
                    )
                return f, step, height, width
        raise FileNotFoundError(f"no intact snapshots in {p}")
    step = 0
    sidecar = p.with_suffix(".json")
    if sidecar.exists():
        meta = json.loads(sidecar.read_text())
        step = int(meta.get("step", 0))
        height = int(meta.get("height", height))
        width = int(meta.get("width", width))
    else:
        m = _SNAP_RE.match(p.name)
        if m:
            step = int(m.group(1))
    return p, step, height, width


def load_resume(
    path: str | os.PathLike, height: int, width: int
) -> tuple[np.ndarray, int]:
    """Load a board to resume from; returns (board, completed_steps)."""
    p, step, height, width = resolve_resume(path, height, width)
    return read_board(p, height, width), step
