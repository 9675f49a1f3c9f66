"""Live session streams: per-round delta frames behind a bounded ring.

Everything before this module is batch-shaped — submit, poll, fetch one
final board.  The interactive tier (ROADMAP item 2: watch a board evolve,
poke it, share it with other watchers) needs a *streaming result
channel*, and the serving stack already produces its raw material for
free: the pipelined pump's retire phase holds every engine's newest
MATERIALIZED board (the double buffer — ``engine.peek_slot``), so a
per-round delta costs one host subtraction, never a device sync.

The pieces:

- **Frame codec** (:func:`make_keyframe` / :func:`make_delta` /
  :func:`apply_frame`): the wire grammar of docs/STREAMING.md.  A
  keyframe carries the whole board (RLE for int rules through the
  existing ``io/rle.py`` codec; base64 float32 for the continuous
  tier), stamped with the **producing executor and a content CRC** so a
  resumed stream asserts continuity typed instead of silently mixing
  anchors (the float-anchor limit, docs/RULES.md).  A delta
  carries a binary changed-cell mask (always the two-state ``b``/``o``
  RLE dialect) — for two-state rules the mask IS the XOR of the
  double-buffered boards; multi-state and float rules add the new
  values at the masked cells (``values_b64``).  Float deltas are
  **masked-threshold**: cells moving less than ``atol`` stay unmasked,
  and the producer diffs against its own *reconstruction* rather than
  the true board, so a client's board is always within ``atol`` of the
  truth and byte-identical to the producer's reconstruction (the delta
  CRC asserts exactly that).
- **StreamHub**: per-sid frame state behind one condition variable.
  ``produce`` appends under the hub lock (bounded ring — a slow reader
  can NEVER stall the pump; overflow drops the oldest frames and the
  reader resyncs through a typed ``frame_gap`` marker + keyframe);
  ``read`` blocks handler threads, never the pump.
- **Edit-log replay** (:func:`replay_edit_log`): the bit-reproducibility
  oracle for steered sessions — a solo run replaying the same edit log
  through the host-synchronous pump on the oracle executor, which the
  equivalence tests (and the stream chaos drill) byte-compare against
  the served session.

Frame grammar (one JSON object per frame; the wire is ndjson)::

    {"type":"key","seq":0,"step":0,"h":32,"w":32,"rle":"...",
     "executor":"jax:VmapEngine","crc":123456}          # int rules
    {"type":"key","seq":0,"step":0,"h":32,"w":32,"b64":"...",
     "dtype":"float32","executor":"numpy:HostBatchEngine","crc":...}
    {"type":"delta","seq":1,"step":16,"mask":"<rle>","crc":...}
    {"type":"delta","seq":2,"step":32,"mask":"<rle>",
     "values_b64":"...","crc":...}                       # multi-state/float
    {"type":"edit","seq":3,"step":32,"cells":[[r,c,v],...]}
    {"type":"frame_gap","seq":4,"dropped":7}
    {"type":"end","seq":5,"step":64,"state":"done"}

Sequence numbers are strictly consecutive per session — across worker
deaths too: the spill manifest carries ``stream_seq`` (frames produced
so far) and the survivor's hub fast-forwards to a reconnecting
watcher's cursor, serving a fresh keyframe there, so the client's
sequence is gapless under the same trace_id.  ``edit`` frames are
metadata (clients must NOT mutate their board on them — the next delta
already spans the edit); they exist so a watcher can mirror steering
and a postmortem can replay the log.
"""

from __future__ import annotations

import base64
import threading
import time
import zlib
from collections import deque

import numpy as np

from tpu_life_torch.io.rle import emit_rle, parse_rle

#: Default bound on frames retained per session — past it the oldest
#: frames drop (the reader resyncs typed through ``frame_gap``).
RING_FRAMES = 64

#: Emit a fresh keyframe every this many frames even without a gap, so a
#: late subscriber (or a drifted float reconstruction) resyncs cheaply.
KEY_EVERY = 32

#: The float delta threshold: cells moving less than this stay unmasked.
#: Matches the continuous tier's equivalence tolerance
#: (``models.lenia.FLOAT_ATOL``) so reconstruction error never exceeds
#: what the executors are allowed to disagree by anyway.
FLOAT_DELTA_ATOL = 1e-4

#: Bound on cells per PATCH — an edit is a poke, not a board upload.
MAX_EDIT_CELLS = 4096


class StreamProtocolError(ValueError):
    """A frame failed to decode or apply (CRC mismatch, bad grammar)."""


# -- the frame codec --------------------------------------------------------
def board_crc(board: np.ndarray) -> int:
    """The content CRC stamped on every board-bearing frame: crc32 of
    the canonical bytes (int8 for discrete boards, little-endian float32
    for continuous ones) — what a resumed stream asserts continuity on."""
    if np.issubdtype(board.dtype, np.floating):
        buf = np.ascontiguousarray(board, dtype="<f4").tobytes()
    else:
        buf = np.ascontiguousarray(board, dtype=np.int8).tobytes()
    return zlib.crc32(buf) & 0xFFFFFFFF


def make_keyframe(
    seq: int, step: int, board: np.ndarray, *, executor: str = ""
) -> dict:
    """A full-board frame: the resync anchor every delta chain hangs off.

    Stamped with the producing ``executor`` and the content CRC
    (docs/RULES.md "float anchors"): float frames are allclose-not-byte
    across executors, so a client splicing streams from two workers
    checks both stamps and resyncs from this keyframe instead of
    applying a foreign delta chain to a drifted board.
    """
    h, w = board.shape
    frame = {
        "type": "key",
        "seq": int(seq),
        "step": int(step),
        "h": int(h),
        "w": int(w),
        "executor": executor,
        "crc": board_crc(board),
    }
    if np.issubdtype(board.dtype, np.floating):
        frame["b64"] = base64.b64encode(
            np.ascontiguousarray(board, dtype="<f4").tobytes()
        ).decode("ascii")
        frame["dtype"] = "float32"
    else:
        states = max(2, int(board.max(initial=0)) + 1)
        frame["rle"] = emit_rle(board, states=states)
    return frame


def make_delta(
    seq: int,
    step: int,
    prev: np.ndarray,
    new: np.ndarray,
    *,
    atol: float = FLOAT_DELTA_ATOL,
) -> tuple[dict, np.ndarray]:
    """One per-round delta frame plus the reconstruction it produces.

    Returns ``(frame, recon)`` — the caller must keep ``recon`` (not
    ``new``) as the next diff base: for float boards the two differ (the
    masked-threshold cut), and diffing against the reconstruction is
    what bounds a client's drift at ``atol`` forever instead of letting
    sub-threshold residue accumulate.  For int boards ``recon is new``.

    The mask is ALWAYS the two-state ``b``/``o`` RLE dialect (a binary
    changed-cell grid fits it whatever the rule's state count).  For
    two-state int rules the mask alone reconstructs (flip the masked
    cells — it IS the XOR of the double-buffered boards); multi-state
    int and float rules carry the new values at the masked cells in
    row-major order (``values_b64``: int8, or little-endian float32).
    """
    frame: dict = {"type": "delta", "seq": int(seq), "step": int(step)}
    if np.issubdtype(new.dtype, np.floating):
        mask = np.abs(new.astype(np.float32) - prev.astype(np.float32)) > atol
        recon = np.array(prev, dtype=np.float32, copy=True)
        recon[mask] = np.asarray(new, dtype=np.float32)[mask]
        if mask.any():
            frame["values_b64"] = base64.b64encode(
                np.ascontiguousarray(recon[mask], dtype="<f4").tobytes()
            ).decode("ascii")
    else:
        mask = np.asarray(new) != np.asarray(prev)
        recon = np.ascontiguousarray(new, dtype=np.int8)
        two_state = (
            int(recon.max(initial=0)) <= 1
            and int(np.asarray(prev).max(initial=0)) <= 1
        )
        if mask.any() and not two_state:
            frame["values_b64"] = base64.b64encode(
                recon[mask].astype(np.int8).tobytes()
            ).decode("ascii")
    frame["mask"] = emit_rle(mask.astype(np.int8), states=2)
    frame["crc"] = board_crc(recon)
    return frame, recon


def apply_frame(board: np.ndarray | None, frame: dict) -> np.ndarray | None:
    """Client-side application: fold one frame into the running board.

    Returns the new board (``None`` after a ``frame_gap`` — the delta
    chain is broken; the caller waits for the next keyframe).  ``edit``
    and ``end`` frames are metadata and return ``board`` unchanged.
    Raises :class:`StreamProtocolError` on CRC mismatch, a delta with no
    base, or unparseable grammar — the typed signal to resync.
    """
    kind = frame.get("type")
    if kind == "key":
        h, w = int(frame["h"]), int(frame["w"])
        if "b64" in frame:
            buf = base64.b64decode(frame["b64"])
            new = np.frombuffer(buf, dtype="<f4")
            if new.size != h * w:
                raise StreamProtocolError(
                    f"keyframe b64 holds {new.size} cells, expected {h * w}"
                )
            new = new.reshape(h, w).astype(np.float32)
        else:
            new, _ = parse_rle(frame["rle"])
            if new.shape != (h, w):
                # RLE headers are authoritative but defensive: a torn
                # frame must fail typed, not reshape into junk
                raise StreamProtocolError(
                    f"keyframe RLE decoded to {new.shape}, expected {(h, w)}"
                )
        if board_crc(new) != frame.get("crc"):
            raise StreamProtocolError(
                f"keyframe seq {frame.get('seq')} CRC mismatch"
            )
        return new
    if kind == "delta":
        if board is None:
            raise StreamProtocolError(
                f"delta seq {frame.get('seq')} with no keyframe base"
            )
        mask_board, _ = parse_rle(frame["mask"])
        mask = np.zeros(board.shape, dtype=bool)
        mh, mw = mask_board.shape
        mask[:mh, :mw] = mask_board.astype(bool)
        n = int(mask.sum())
        new = np.array(board, copy=True)
        if "values_b64" in frame:
            buf = base64.b64decode(frame["values_b64"])
            if np.issubdtype(board.dtype, np.floating):
                vals = np.frombuffer(buf, dtype="<f4")
            else:
                vals = np.frombuffer(buf, dtype=np.int8)
            if vals.size != n:
                raise StreamProtocolError(
                    f"delta seq {frame.get('seq')} carries {vals.size} "
                    f"values for a {n}-cell mask"
                )
            new[mask] = vals
        elif n:
            # two-state flip: the mask IS the XOR
            new[mask] = 1 - new[mask]
        if board_crc(new) != frame.get("crc"):
            raise StreamProtocolError(
                f"delta seq {frame.get('seq')} CRC mismatch "
                f"(splice across executors? resync from a keyframe)"
            )
        return new
    if kind == "frame_gap":
        return None
    if kind in ("edit", "end", "shed", "stream_error"):
        return board
    raise StreamProtocolError(f"unknown frame type {kind!r}")


# -- edits ------------------------------------------------------------------
def validate_cells(cells, shape: tuple[int, int], rule) -> list:
    """A PATCH body's cell list -> canonical ``[(r, c, v), ...]``.

    Typed ``ValueError`` (the gateway's 400) on anything malformed:
    out-of-range coordinates, out-of-range states, floats on a discrete
    rule, NaN on the continuous tier, or an oversized mask.
    """
    if not isinstance(cells, list) or not cells:
        raise ValueError("'cells' must be a non-empty list of [row, col, value]")
    if len(cells) > MAX_EDIT_CELLS:
        raise ValueError(
            f"edit has {len(cells)} cells; the limit is {MAX_EDIT_CELLS}"
        )
    h, w = shape
    continuous = bool(getattr(rule, "continuous", False))
    states = rule.states
    out = []
    for i, cell in enumerate(cells):
        if not isinstance(cell, (list, tuple)) or len(cell) != 3:
            raise ValueError(f"cells[{i}] must be [row, col, value]")
        r, c, v = cell
        if isinstance(r, bool) or isinstance(c, bool) or not isinstance(r, int) or not isinstance(c, int):
            raise ValueError(f"cells[{i}] coordinates must be integers")
        if not (0 <= r < h and 0 <= c < w):
            raise ValueError(
                f"cells[{i}] = ({r}, {c}) is outside the {h}x{w} board"
            )
        if continuous:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"cells[{i}] value must be a number")
            v = float(v)
            if not np.isfinite(v) or not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"cells[{i}] value {v} must be a finite number in [0, 1]"
                )
        else:
            if isinstance(v, bool) or not isinstance(v, int):
                raise ValueError(
                    f"cells[{i}] value must be an integer state for rule "
                    f"{rule.name!r}"
                )
            if not 0 <= v < states:
                raise ValueError(
                    f"cells[{i}] value {v} is outside this rule's states "
                    f"0..{states - 1}"
                )
        out.append((int(r), int(c), v))
    return out


def apply_cells(board: np.ndarray, cells) -> None:
    """Write an edit's cells into ``board`` in place (already validated)."""
    for r, c, v in cells:
        board[r, c] = v


def parse_edit_log(raw) -> list:
    """A wire/manifest edit log -> canonical ``[(step, [(r,c,v),...]),...]``
    sorted by step.  Shape-validated only (values are re-validated
    against the rule at submit via :func:`validate_cells`)."""
    if not isinstance(raw, list):
        raise ValueError("'edits' must be a list of [step, cells] entries")
    out = []
    for i, entry in enumerate(raw):
        if not isinstance(entry, (list, tuple)) or len(entry) != 2:
            raise ValueError(f"edits[{i}] must be [step, cells]")
        step, cells = entry
        if isinstance(step, bool) or not isinstance(step, int) or step < 0:
            raise ValueError(f"edits[{i}] step must be an integer >= 0")
        out.append((int(step), cells))
    out.sort(key=lambda e: e[0])
    return out


def render_edit_log(edits) -> list:
    """Canonical edit log -> the JSON shape the manifest and resume wire
    carry: ``[[step, [[r, c, v], ...]], ...]``."""
    return [
        [int(step), [[r, c, v] for (r, c, v) in cells]]
        for step, cells in edits
    ]


def estimate_stream_bytes(
    shape: tuple[int, int], dtype: str, ring_frames: int = RING_FRAMES
) -> int:
    """Estimated resident bytes one session's delta ring can grow to —
    what the governor charges at subscribe (docs/SERVING.md "Resource
    governance").  Dominant terms: the reconstruction base board, one
    resident keyframe, and the ring's deltas (bounded by a conservative
    1/8 of board size each plus framing overhead)."""
    h, w = shape
    itemsize = np.dtype(dtype).itemsize
    board_bytes = h * w * itemsize
    return 2 * board_bytes + ring_frames * (board_bytes // 8 + 512)


# -- the hub ----------------------------------------------------------------
class _SessionStream:
    """One session's frame state: ring + cursors, owned by the hub lock."""

    __slots__ = (
        "frames",
        "base_seq",
        "next_seq",
        "last_board",
        "last_step",
        "need_key",
        "frames_since_key",
        "done",
        "watchers",
    )

    def __init__(self, start_seq: int = 0):
        self.frames: deque = deque()
        self.base_seq = int(start_seq)  # seq of frames[0]
        self.next_seq = int(start_seq)
        self.last_board: np.ndarray | None = None  # the reconstruction base
        self.last_step = -1
        self.need_key = True
        self.frames_since_key = 0
        self.done = False
        self.watchers = 0


class StreamHub:
    """Per-session delta rings between the pump and the watcher sockets.

    The pump (under the service lock) calls :meth:`produce` /
    :meth:`record_edit` / :meth:`finish` — bounded appends under the
    hub's own lock, so a slow or dead reader can never stall a round.
    Handler threads block in :meth:`read` on the hub condition; the hub
    never holds the service lock, the service never blocks on a socket.
    """

    def __init__(
        self,
        *,
        ring_frames: int = RING_FRAMES,
        key_every: int = KEY_EVERY,
        atol: float = FLOAT_DELTA_ATOL,
    ):
        if ring_frames < 2:
            raise ValueError(f"ring_frames must be >= 2, got {ring_frames}")
        self.ring_frames = ring_frames
        self.key_every = key_every
        self.atol = atol
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._streams: dict[str, _SessionStream] = {}
        # cumulative totals the service mirrors into its registry
        self.frames_total = 0
        self.gaps_total = 0

    # -- pump side (service lock held by the caller; hub lock here) --------
    def active(self) -> bool:
        """Cheap pump-side gate: any session has stream state at all."""
        return bool(self._streams)

    def wants(self, sid: str) -> bool:
        """Does this session need frames produced?  True while stream
        state exists and no terminal frame has been emitted — frames are
        produced lazily, only for sessions somebody subscribed to."""
        st = self._streams.get(sid)
        return st is not None and not st.done

    def ensure(self, sid: str, start_seq: int = 0) -> None:
        with self._cond:
            if sid not in self._streams:
                self._streams[sid] = _SessionStream(start_seq)

    def subscribe(self, sid: str, start_seq: int = 0) -> None:
        with self._cond:
            st = self._streams.get(sid)
            if st is None:
                st = self._streams[sid] = _SessionStream(start_seq)
            st.watchers += 1

    def unsubscribe(self, sid: str) -> bool:
        """Drop one watcher; True when the last one left and the ring
        state was discarded (frames are produced for watchers, not for
        archival — a later subscriber restarts from a fresh keyframe,
        and its cursor fast-forwards the sequence space to stay gapless).
        """
        with self._cond:
            st = self._streams.get(sid)
            if st is None:
                return True
            st.watchers = max(0, st.watchers - 1)
            if st.watchers == 0:
                del self._streams[sid]
                self._cond.notify_all()
                return True
            return False

    def watcher_count(self) -> int:
        with self._lock:
            return sum(st.watchers for st in self._streams.values())

    def produce(
        self, sid: str, board: np.ndarray, step: int, *, executor: str = ""
    ) -> dict | None:
        """Append one frame for ``sid`` if the board progressed.

        Called from the pump's locked retire tail with the newest
        materialized board (``engine.peek_slot`` — the double buffer, so
        this never waits on the in-flight chunk).  Emits a keyframe on
        first contact / after a gap / every ``key_every`` frames, a
        delta otherwise; a repeat step (lag did not advance) is a no-op.
        """
        with self._cond:
            st = self._streams.get(sid)
            if st is None or st.done:
                return None
            if step <= st.last_step and not st.need_key:
                return None
            if st.need_key or st.last_board is None or (
                self.key_every and st.frames_since_key >= self.key_every
            ):
                frame = make_keyframe(
                    st.next_seq, step, board, executor=executor
                )
                st.last_board = np.array(board, copy=True)
                st.need_key = False
                st.frames_since_key = 0
            else:
                frame, recon = make_delta(
                    st.next_seq, step, st.last_board, board, atol=self.atol
                )
                st.last_board = recon
                st.frames_since_key += 1
            st.last_step = int(step)
            self._append(st, frame)
            return frame

    def record_edit(self, sid: str, step: int, cells) -> None:
        """The in-band steering marker: metadata only (the next delta
        already spans the edit's effect — see the module docstring)."""
        with self._cond:
            st = self._streams.get(sid)
            if st is None or st.done:
                return
            frame = {
                "type": "edit",
                "seq": st.next_seq,
                "step": int(step),
                "cells": [[r, c, v] for (r, c, v) in cells],
            }
            self._append(st, frame)

    def finish(self, sid: str, state: str, step: int) -> None:
        """The terminal frame: every watcher's read drains to EOF."""
        with self._cond:
            st = self._streams.get(sid)
            if st is None or st.done:
                return
            frame = {
                "type": "end",
                "seq": st.next_seq,
                "step": int(step),
                "state": state,
            }
            self._append(st, frame)
            st.done = True

    def discard(self, sid: str) -> None:
        with self._cond:
            self._streams.pop(sid, None)
            self._cond.notify_all()

    def seq_snapshot(self, sid: str, default: int = 0) -> int:
        """Frames produced so far — what the spill manifest persists as
        ``stream_seq`` so a survivor continues the sequence space."""
        with self._lock:
            st = self._streams.get(sid)
            return st.next_seq if st is not None else default

    def _append(self, st: _SessionStream, frame: dict) -> None:
        # hub lock held.  Bounded ring: overflow drops the oldest frame
        # — the pump never blocks — and schedules a keyframe so readers
        # that fell past the ring start resync typed (frame_gap + key).
        st.frames.append(frame)
        st.next_seq += 1
        self.frames_total += 1
        while len(st.frames) > self.ring_frames:
            st.frames.popleft()
            st.base_seq += 1
            st.need_key = True
            self.gaps_total += 1
        self._cond.notify_all()

    # -- reader side (handler threads; only the hub lock) ------------------
    def read(
        self, sid: str, cursor: int, timeout: float | None = 0.25
    ) -> tuple[list, int, bool]:
        """Frames from ``cursor`` on: ``(frames, next_cursor, eof)``.

        Blocks up to ``timeout`` for new frames.  A cursor that fell
        behind the ring start gets one typed ``frame_gap`` marker and
        resumes at the next keyframe in the ring (one is always coming:
        overflow schedules it).  A cursor AHEAD of the sequence space —
        a watcher reconnecting across a failover with frames the dead
        worker produced but this one has not — fast-forwards the hub:
        the survivor's next frame is a keyframe at exactly that cursor,
        which is what keeps reconnected sequence numbers gapless.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                st = self._streams.get(sid)
                if st is None:
                    return [], cursor, True
                if cursor > st.next_seq and not st.done:
                    # failover fast-forward (see docstring).  Any frames
                    # this incarnation produced below the cursor are
                    # cleared so the ring invariant (frames[i].seq ==
                    # base_seq + i) holds for the jumped space; a
                    # concurrent slower reader resyncs typed (frame_gap
                    # + the keyframe this schedules).
                    st.frames.clear()
                    st.base_seq = cursor
                    st.next_seq = cursor
                    st.need_key = True
                out = self._collect(st, cursor)
                if out is not None:
                    frames, next_cursor = out
                    if frames or (st.done and next_cursor >= st.next_seq):
                        return frames, next_cursor, st.done and next_cursor >= st.next_seq
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return [], cursor, False
                    self._cond.wait(remaining)
                else:
                    self._cond.wait()

    def _collect(self, st: _SessionStream, cursor: int):
        """Hub lock held: the deliverable frames at ``cursor``, or None
        when the reader must keep waiting (behind the ring with no
        keyframe landed yet)."""
        if cursor >= st.base_seq:
            idx = cursor - st.base_seq
            frames = list(st.frames)[idx:] if idx < len(st.frames) else []
            return frames, cursor + len(frames)
        # behind the ring: resync at the first keyframe currently held
        for i, frame in enumerate(st.frames):
            if frame.get("type") == "key":
                seq = st.base_seq + i
                gap = {
                    "type": "frame_gap",
                    "seq": cursor,
                    "dropped": seq - cursor,
                }
                frames = [gap] + list(st.frames)[i:]
                return frames, st.base_seq + len(st.frames)
        if st.done:
            # never resyncable: everything from here out is undeliverable
            gap = {
                "type": "frame_gap",
                "seq": cursor,
                "dropped": st.next_seq - cursor,
            }
            return [gap], st.next_seq
        return None


# -- the replay oracle ------------------------------------------------------
def replay_edit_log(
    board: np.ndarray,
    rule,
    steps: int,
    edits,
    *,
    seed: int | None = None,
    temperature: float | None = None,
    start_step: int = 0,
    backend: str = "numpy",
    chunk_steps: int = 16,
) -> np.ndarray:
    """The steering bit-reproducibility oracle (docs/STREAMING.md).

    Runs ONE session through the host-synchronous pump on ``backend``
    (default: the numpy ground-truth executor), re-applying ``edits`` —
    canonical ``[(step, cells), ...]`` in ABSOLUTE step space — at
    exactly their recorded steps, and returns the final board.  The
    contract the tests and the stream chaos drill assert: a served
    session's bytes equal this replay's bytes (allclose at
    ``models.lenia.FLOAT_ATOL`` for the continuous tier), however many
    watchers, edits, pump shapes, or worker deaths the original saw.
    """
    from tpu_life_torch.serve.service import ServeConfig, SimulationService

    svc = SimulationService(
        ServeConfig(
            capacity=1,
            chunk_steps=chunk_steps,
            backend=backend,
            pipeline=False,
            memory_budget_bytes=0,
        )
    )
    try:
        sid = svc.submit(
            board,
            rule,
            steps,
            seed=seed,
            temperature=temperature,
            start_step=start_step,
            scheduled_edits=edits,
        )
        svc.drain(max_rounds=10 * (steps + chunk_steps + len(list(edits)) * 2) + 16)
        return svc.result(sid)
    finally:
        svc.close()
