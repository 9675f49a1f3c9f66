"""Stripe-decomposition CPU backend — the reference's rank structure, kept
honest (the port of ``tpu_life/backends/stripes_backend.py``: the same
classes, over the port's numpy oracle).

Mirrors the MPI program's shape (SURVEY.md §3): R "ranks", each owning a
block-row stripe plus one halo row per interior edge; per epoch every rank
updates its extended stripe locally and then exchanges edge rows with its
neighbors (the corrected form of Parallel_Life_MPI.cpp:104-145 — the
received halo is actually *stored*, unlike the reference's discarded-copy
bug at :111/:127).  Exists for three reasons:

- a structural cross-check that the decomposition/halo logic is
  shard-count-invariant on plain NumPy, independent of torch;
- the ``--backend mpi`` path: with ``mpi4py`` installed the same stripe
  update runs one-rank-per-process over real MPI (send/recv of edge rows);
- a teaching artifact: diffing this file against the sharded backend shows
  exactly what the device mesh and its halo copies replace.

Both are host executors, chosen only by name: ``auto`` and ``tuned`` never
pick them.

Unlike the reference, the remainder rows are balanced across stripes
(``stripe_bounds``) rather than dumped on the last rank
(Parallel_Life_MPI.cpp:76-78).
"""

from __future__ import annotations

import numpy as np

from tpu_life_torch.backends.base import ChunkCallback, chunk_sizes, register_backend
from tpu_life_torch.io.sharded import stripe_bounds
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops.reference import step_np, step_np_wrap_cols


def _exchange_halos(
    stripes: list[np.ndarray], r: int, torus: bool
) -> list[np.ndarray]:
    """Return stripes extended with up-to-r halo rows from their neighbors.

    Clamped: the first/last stripes get no top/bottom halo (the dead
    boundary).  Torus: every stripe gets both halos — the ring closes via
    the (i±1) mod n neighbors (the MPI_Cart periods=1 the reference's
    rank±1 topology never takes)."""
    n = len(stripes)
    out = []
    for i, s in enumerate(stripes):
        if torus:
            top = stripes[(i - 1) % n][-r:]
            bot = stripes[(i + 1) % n][:r]
        else:
            top = stripes[i - 1][-r:] if i > 0 else np.zeros((0, s.shape[1]), s.dtype)
            bot = stripes[i + 1][:r] if i < n - 1 else np.zeros((0, s.shape[1]), s.dtype)
        out.append(np.vstack([top, s, bot]))
    return out


def _update_stripe(ext: np.ndarray, rule: Rule, n_top: int, n_bot: int) -> np.ndarray:
    """One CA step on an extended stripe; returns the interior rows.

    Interior edges see true neighbor rows (the halos); global edges see
    the clamped dead boundary — or, for torus rules, wrap halos on the row
    axis and in-place column wrap (``step_np_wrap_cols``).
    """
    step = step_np_wrap_cols if rule.boundary == "torus" else step_np
    nxt = step(ext, rule)
    stop = nxt.shape[0] - n_bot if n_bot else nxt.shape[0]
    return nxt[n_top:stop]


@register_backend("stripes")
class StripesBackend:
    name = "stripes"

    def __init__(self, *, num_devices: int | None = None, **_):
        self.num_ranks = num_devices or 4

    def run(
        self,
        board: np.ndarray,
        rule: Rule,
        steps: int,
        *,
        chunk_steps: int = 0,
        callback: ChunkCallback | None = None,
    ) -> np.ndarray:
        board = np.asarray(board, np.int8)
        h, _ = board.shape
        if rule.boundary == "torus" and h < rule.radius:
            # one stripe cannot hold the r wrap rows its halos need: the
            # JAX package's loop trims the whole board away here, so refuse
            raise ValueError(
                f"a torus board of height {h} is shallower than the rule "
                f"radius {rule.radius}; the stripe halos cannot wrap it"
            )
        ranks = min(self.num_ranks, max(1, h // max(1, rule.radius)))
        bounds = stripe_bounds(h, ranks)
        stripes = [board[a:b].copy() for a, b in bounds]
        r = rule.radius
        torus = rule.boundary == "torus"
        done = 0
        for n in chunk_sizes(steps, chunk_steps):
            for _ in range(n):
                exts = _exchange_halos(stripes, r, torus)
                stripes = [
                    _update_stripe(
                        ext,
                        rule,
                        n_top=r if (torus or i > 0) else 0,
                        n_bot=r if (torus or i < ranks - 1) else 0,
                    )
                    for i, ext in enumerate(exts)
                ]
            done += n
            if callback is not None:
                out = np.vstack(stripes)
                callback(done, lambda out=out: out)
        return np.vstack(stripes)


@register_backend("mpi")
class MpiBackend:
    """Real-MPI variant: one stripe per rank via mpi4py (EXPERIMENTAL).

    The driver process is rank 0; this backend only functions under
    ``mpiexec`` with mpi4py installed — otherwise it raises with guidance.
    THREAD-SIMULATED ONLY: no machine this repo runs on ships mpi4py or
    an ``mpiexec`` launcher, so a real ``mpiexec -n`` run has never
    executed — the per-rank logic is exercised by
    ``tests/test_torch_host_backends.py`` through an injected in-process
    fake communicator (``comm=``) implementing the same ``Sendrecv`` /
    ``gather`` / ``allgather`` surface over threads.  Real cross-process
    message passing is covered by the two-process gloo run of
    ``tests/test_torch_distributed.py``.
    Halo traffic uses 1 byte/cell (the reference inflated halos 4x by
    sending MPI_INT, Parallel_Life_MPI.cpp:114-115; SURVEY.md §2.4).
    """

    name = "mpi"

    def __init__(self, *, comm=None, **_):
        if comm is None:
            try:
                from mpi4py import MPI
            except ImportError as e:
                raise ImportError(
                    "backend 'mpi' needs mpi4py (not installed in this image); "
                    "use --backend stripes for the single-process structural "
                    "equivalent"
                ) from e
            comm = MPI.COMM_WORLD
        self.comm = comm

    def run(
        self,
        board: np.ndarray,
        rule: Rule,
        steps: int,
        *,
        chunk_steps: int = 0,
        callback: ChunkCallback | None = None,
    ) -> np.ndarray:
        comm = self.comm
        rank, size = comm.Get_rank(), comm.Get_size()
        board = np.asarray(board, np.int8)
        torus = rule.boundary == "torus"
        h, w = board.shape
        bounds = stripe_bounds(h, size)
        if min(b - a for a, b in bounds) < rule.radius:
            # a stripe shorter than the radius makes the single-hop halo
            # exchange insufficient (true neighbors live two ranks away) —
            # refuse rather than silently diverge.  StripesBackend clamps
            # its rank count for the same reason; a fixed MPI world cannot.
            raise ValueError(
                f"board height {h} over {size} ranks gives a stripe "
                f"shorter than the rule radius {rule.radius}; use fewer "
                f"ranks"
            )
        a, b = bounds[rank]
        stripe = np.ascontiguousarray(board[a:b])
        r = rule.radius
        done = 0
        for n in chunk_sizes(steps, chunk_steps):
            for _ in range(n):
                top = np.zeros((r, w), np.int8)
                bot = np.zeros((r, w), np.int8)
                # paired exchanges; Sendrecv is deadlock-free by construction.
                # Torus closes the ring with (rank±1) mod size neighbors —
                # MPI_Cart periods=1, the option the reference's rank±1
                # topology never takes (Parallel_Life_MPI.cpp:105-123)
                if torus and size == 1:
                    top, bot = stripe[-r:].copy(), stripe[:r].copy()
                elif torus:
                    # two cyclic SHIFTS (the MPI_Cart_shift pattern): each
                    # call pairs its send with the recv satisfied by the
                    # SAME call on the neighbor, so the ring cannot deadlock
                    # — pairing send-up with recv-from-up instead would
                    # leave every rank waiting on a message its peer only
                    # posts in the next phase.  Constant phase tags (0/1)
                    # keep size == 2 (both phases talk to the same peer)
                    # unambiguous; MPI's in-order matching per (source,
                    # tag) handles successive steps, and per-step tags
                    # would overflow MPI_TAG_UB on long runs.
                    up, down = (rank - 1) % size, (rank + 1) % size
                    tag_up, tag_down = 0, 1
                    # shift up: my top rows become up's bottom halo; my
                    # bottom halo arrives from down (its top rows)
                    comm.Sendrecv(
                        np.ascontiguousarray(stripe[:r]),
                        dest=up, sendtag=tag_up,
                        recvbuf=bot, source=down, recvtag=tag_up,
                    )
                    # shift down: my bottom rows become down's top halo; my
                    # top halo arrives from up (its bottom rows)
                    comm.Sendrecv(
                        np.ascontiguousarray(stripe[-r:]),
                        dest=down, sendtag=tag_down,
                        recvbuf=top, source=up, recvtag=tag_down,
                    )
                else:
                    if rank > 0:
                        comm.Sendrecv(
                            np.ascontiguousarray(stripe[:r]), dest=rank - 1,
                            sendtag=0, recvbuf=top, source=rank - 1,
                            recvtag=0,
                        )
                    if rank < size - 1:
                        comm.Sendrecv(
                            np.ascontiguousarray(stripe[-r:]), dest=rank + 1,
                            sendtag=0, recvbuf=bot, source=rank + 1,
                            recvtag=0,
                        )
                if torus:
                    # every stripe carries both halos; column seam wraps in
                    # the substep, the fringe rows are trimmed
                    ext = np.vstack([top, stripe, bot])
                    stripe = step_np_wrap_cols(ext, rule)[r:-r]
                else:
                    # zero halos at the global edges *are* the clamped
                    # boundary, so updating the extended stripe and trimming
                    # r rows per side is exact for every rank
                    ext = np.vstack([top, stripe, bot]) if size > 1 else stripe
                    nxt = step_np(ext, rule)
                    stripe = nxt[r:-r] if size > 1 else nxt
                done += 1
            if callback is not None:
                # per-chunk side effects (snapshots, metrics) are rank-0
                # single-writer — gather to root only, instead of every rank
                # reconstructing the whole board (O(size) traffic, not
                # O(size^2))
                parts = comm.gather(stripe, root=0)
                if rank == 0:
                    full = np.vstack(parts)
                    callback(done, lambda full=full: full)
        # the Backend.run contract returns the board on every caller
        gathered = comm.allgather(stripe)
        return np.vstack(gathered)
