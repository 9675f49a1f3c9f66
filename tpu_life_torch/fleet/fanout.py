"""The watcher fan-out tier: N watchers of one session, ONE upstream.

A popular session must not multiply load on the worker that computes it
(docs/STREAMING.md "Fan-out topology").  The router multiplexes: per
watched fleet sid it keeps exactly one upstream stream (a puller thread
consuming the worker's ndjson delta frames) feeding a bounded broadcast
buffer; every watcher is just a cursor into that buffer.  10 000
watchers of one sid cost the worker exactly what one watcher costs — the
multiplexer test proves it by counting upstream opens.

Backpressure is the router's problem, never the worker's: the buffer is
bounded, and when it overflows the SLOWEST watcher is shed typed (a
``{"type": "shed", "reason": "slow_reader"}`` frame, then the stream
ends; ``watcher_shed_total{reason}`` counts it) — one wedged client
cannot grow router memory or stall its peers.

Failover continuity rides the cursor: the upstream is opened with the
next sequence number the buffer needs, so when a worker dies mid-stream
and the migrator re-pins the sid to a survivor (which replays the delta
log from the spilled manifest), the puller's reconnect resumes at the
exact seq where the dead worker stopped — watchers observe a keyframe
re-sync with GAPLESS sequence numbers, same trace, no torn state.

``open_upstream`` is injectable (``(fsid, cursor) -> frame iterator``):
the router binds it to pin-resolution + a worker HTTP stream; tests bind
counting fakes, so the fan-out contract is provable without sockets.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from tpu_life_torch.runtime.metrics import log

#: Default broadcast-buffer bound, in frames, per watched sid.  Deltas
#: are small (run-length masks); 512 frames of slack absorbs a multi-
#: second stall before the slowest watcher is shed.
BUFFER_FRAMES = 512

#: The one shed reason this tier emits today; the label is open for a
#: future policy (e.g. an admission cap shedding newest-first).
SHED_SLOW_READER = "slow_reader"


class _Fan:
    """Per-sid broadcast state.  All fields are guarded by the hub lock;
    ``cond`` shares that lock so pullers wake watchers directly."""

    __slots__ = (
        "fsid",
        "frames",
        "start",
        "next_seq",
        "out_next",
        "watchers",
        "sheds",
        "cond",
        "done",
        "closed",
        "opens",
    )

    def __init__(self, fsid: str, cursor: int, lock: threading.Lock):
        self.fsid = fsid
        self.frames: deque = deque()
        self.start = 0  # ordinal of frames[0] since this fan was born
        self.next_seq = cursor  # upstream seq to request on (re)connect
        # the DENSE outgoing sequence (what watchers see): upstream seqs
        # may jump across a failover (frames the dead worker produced
        # but never delivered still consumed its numbering; the survivor
        # re-keys past them) — the fan renumbers every broadcast frame
        # so reconnected watcher seqs are gapless by construction
        self.out_next = cursor
        self.watchers: dict[int, int] = {}  # watcher id -> ordinal cursor
        self.sheds: set[int] = set()  # watchers marked for typed shed
        self.cond = threading.Condition(lock)
        self.done = False
        self.closed = False
        self.opens = 0  # upstream opens (reconnects included) — test seam

    @property
    def end(self) -> int:
        return self.start + len(self.frames)


class FanoutHub:
    """The subscription multiplexer (one per router).

    ``open_upstream(fsid, cursor)`` must return an iterator of frame
    dicts starting at sequence ``cursor`` and may raise on transport
    failure — the hub reconnects with the next cursor it needs, up to
    ``max_reconnects`` consecutive failures, then ends the fan with a
    synthetic ``{"type": "end", "state": "lost"}`` so watchers terminate
    typed instead of hanging.
    """

    def __init__(
        self,
        *,
        open_upstream,
        buffer_frames: int = BUFFER_FRAMES,
        registry=None,
        max_reconnects: int = 8,
        sleep=time.sleep,
    ):
        if buffer_frames < 2:
            raise ValueError(f"buffer_frames must be >= 2, got {buffer_frames}")
        self._open_upstream = open_upstream
        self.buffer_frames = buffer_frames
        self._max_reconnects = max_reconnects
        self._sleep = sleep
        self._lock = threading.Lock()
        self._fans: dict[str, _Fan] = {}
        self._ids = itertools.count(1)
        self.shed_total = 0
        self._c_shed = None
        self._g_watchers = None
        if registry is not None:
            self._c_shed = registry.counter(
                "watcher_shed_total",
                "stream watchers shed by the fan-out tier, by reason",
                labels=("reason",),
            )
            self._c_shed.labels(reason=SHED_SLOW_READER)
            self._g_watchers = registry.gauge(
                "fleet_stream_watchers",
                "live stream watchers across the fan-out tier",
            )

    # -- the watcher side --------------------------------------------------
    def watch(self, fsid: str, cursor: int = 0):
        """A generator of frame dicts for one watcher of ``fsid``.

        The FIRST watcher of a sid creates the fan and its puller (the
        one upstream); later watchers join the broadcast buffer at its
        most recent keyframe (or, when the buffer holds none, after a
        synthetic ``frame_gap`` so the client knows to wait for the next
        re-key).  Ends on the upstream's ``end`` frame, or early with a
        typed ``shed`` frame when this watcher is the slowest under
        overflow.
        """
        with self._lock:
            fan = self._fans.get(fsid)
            if fan is None:
                fan = _Fan(fsid, cursor, self._lock)
                self._fans[fsid] = fan
                t = threading.Thread(
                    target=self._pull,
                    args=(fan,),
                    name=f"fanout-{fsid}",
                    daemon=True,
                )
                t.start()
            wid = next(self._ids)
            pos, keywait = self._join_pos(fan, cursor)
            fan.watchers[wid] = pos
            self._set_watcher_gauge()
        try:
            if keywait:
                # the buffer holds no keyframe (overflow ate it): tell the
                # client to hold reconstruction until the next re-key
                yield {
                    "type": "frame_gap",
                    "seq": max(0, fan.out_next - 1),
                    "dropped": -1,
                }
            while True:
                with self._lock:
                    while (
                        wid not in fan.sheds
                        and pos >= fan.end
                        and not fan.done
                        and not fan.closed
                    ):
                        fan.cond.wait(0.25)
                    if wid in fan.sheds:
                        self.shed_total += 1
                        if self._c_shed is not None:
                            self._c_shed.labels(reason=SHED_SLOW_READER).inc()
                        shed = {
                            "type": "shed",
                            "reason": SHED_SLOW_READER,
                            # the oldest still-broadcastable outgoing seq
                            # — where a reconnecting client could resume
                            "seq": fan.out_next - len(fan.frames),
                        }
                        batch, ended = [shed], True
                    elif pos < fan.start:
                        # fell behind while outside the wait (mid-yield):
                        # same verdict, recorded the same way
                        fan.sheds.add(wid)
                        continue
                    else:
                        batch = list(
                            itertools.islice(
                                fan.frames, pos - fan.start, len(fan.frames)
                            )
                        )
                        pos = fan.end
                        fan.watchers[wid] = pos
                        ended = fan.done and pos >= fan.end
                        if fan.closed and not batch:
                            return
                # yield OUTSIDE the lock: a slow consumer blocks only its
                # own generator, never the puller or its peers
                for frame in batch:
                    if keywait and frame.get("type") == "delta":
                        continue  # unreconstructable until the next key
                    if frame.get("type") == "key":
                        keywait = False
                    yield frame
                if ended:
                    return
        finally:
            self._unsubscribe(fsid, wid)

    def watcher_count(self) -> int:
        with self._lock:
            return sum(len(f.watchers) for f in self._fans.values())

    def upstream_opens(self, fsid: str) -> int:
        """Upstream connections opened for ``fsid`` so far (test seam —
        the fan-out sublinearity proof counts these)."""
        with self._lock:
            fan = self._fans.get(fsid)
            return fan.opens if fan is not None else 0

    def close(self) -> None:
        """End every fan: watchers drain what is buffered and return;
        pullers notice ``closed`` at their next frame and exit."""
        with self._lock:
            for fan in self._fans.values():
                fan.closed = True
                fan.cond.notify_all()

    # -- internals ---------------------------------------------------------
    def _join_pos(self, fan: _Fan, cursor: int) -> tuple[int, bool]:
        """(ordinal to start at, keyframe-wait flag) for a new watcher.

        A reconnecting watcher whose outgoing-seq ``cursor`` still falls
        inside the buffer resumes exactly there — its own stream stays
        dense across its reconnect.  Otherwise: the latest buffered
        keyframe when one exists; the buffer head (frame 0 IS the
        worker's first keyframe) when nothing was ever dropped; else the
        tail, flagged to wait for a re-key."""
        out_base = fan.out_next - len(fan.frames)
        if cursor and out_base <= cursor <= fan.out_next:
            return fan.start + (cursor - out_base), False
        for i in range(len(fan.frames) - 1, -1, -1):
            if fan.frames[i].get("type") == "key":
                return fan.start + i, False
        if fan.start == 0:
            return 0, False
        return fan.end, True

    def _unsubscribe(self, fsid: str, wid: int) -> None:
        with self._lock:
            fan = self._fans.get(fsid)
            if fan is None:
                return
            fan.watchers.pop(wid, None)
            fan.sheds.discard(wid)
            if not fan.watchers:
                # last watcher gone: tear the fan down — the puller sees
                # ``closed`` and drops the upstream, releasing the
                # worker-side watcher-buffer governor charge with it
                fan.closed = True
                fan.cond.notify_all()
                self._fans.pop(fsid, None)
            self._set_watcher_gauge()

    def _set_watcher_gauge(self) -> None:
        if self._g_watchers is not None:
            self._g_watchers.set(
                float(sum(len(f.watchers) for f in self._fans.values()))
            )

    def _append(self, fan: _Fan, frame: dict) -> None:
        """Buffer one upstream frame (hub lock held): bound the buffer,
        mark the slowest watchers for typed shed on overflow, and
        renumber into the fan's dense outgoing sequence (the upstream
        seq only advances the reconnect cursor)."""
        if len(fan.frames) >= self.buffer_frames:
            fan.frames.popleft()
            fan.start += 1
            for wid, c in fan.watchers.items():
                if c < fan.start and wid not in fan.sheds:
                    fan.sheds.add(wid)
        seq = frame.get("seq")
        if isinstance(seq, int):
            fan.next_seq = seq + 1
        out = dict(frame)
        out["seq"] = fan.out_next
        fan.out_next += 1
        fan.frames.append(out)
        fan.cond.notify_all()

    def _pull(self, fan: _Fan) -> None:
        """The one upstream consumer for this fan.  Reconnects with the
        next needed cursor on transport failure — the failover-continuity
        path — and converts exhaustion into a typed terminal frame."""
        attempts = 0
        while True:
            with self._lock:
                if fan.done or fan.closed:
                    return
                cursor = fan.next_seq
                fan.opens += 1
            try:
                for frame in self._open_upstream(fan.fsid, cursor):
                    with self._lock:
                        if fan.closed:
                            return
                        self._append(fan, frame)
                        attempts = 0
                        if frame.get("type") == "end":
                            fan.done = True
                            fan.cond.notify_all()
                            return
                # iterator ended without an "end" frame: the stream tore
                # gracefully (worker drained / connection closed) — same
                # reconnect path as an exception
                raise ConnectionError("upstream stream ended without 'end'")
            except Exception as e:
                with self._lock:
                    if fan.done or fan.closed:
                        return
                attempts += 1
                if attempts > self._max_reconnects:
                    log.warning(
                        "fanout: %s upstream lost after %d attempts: %s",
                        fan.fsid,
                        attempts,
                        e,
                    )
                    with self._lock:
                        self._append(
                            fan,
                            {
                                "type": "end",
                                "seq": fan.next_seq,
                                "state": "lost",
                            },
                        )
                        fan.done = True
                        fan.cond.notify_all()
                    return
                log.debug(
                    "fanout: %s upstream dropped (%s); reconnect %d at seq %d",
                    fan.fsid,
                    e,
                    attempts,
                    fan.next_seq,
                )
                self._sleep(min(0.05 * (2**attempts), 1.0))


__all__ = ["BUFFER_FRAMES", "FanoutHub", "SHED_SLOW_READER"]
