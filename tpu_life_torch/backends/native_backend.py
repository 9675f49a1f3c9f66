"""Native C++ threaded CPU backend (the port of
``tpu_life/backends/native_backend.py``).

The reference's compute path is native C++ (Parallel_Life_MPI.cpp:16-54);
this backend is its native CPU lineage — the pthread stripe-parallel LUT
stencil of ``csrc/life.cpp``, a byte copy of the JAX package's
``native/life.cpp`` — bit-identical to the numpy oracle on every clamped
Moore (board, rule, steps).  It is a host executor, chosen only by name:
``auto`` and ``tuned`` never pick it.  The library is built at first use;
a failed build raises ``NativeBuildError`` and ``TPU_LIFE_NATIVE=0``
refuses the backend, where the JAX package's refuses when no library is
found.
"""

from __future__ import annotations

import numpy as np

from tpu_life_torch.backends.base import ChunkCallback, chunk_sizes, register_backend
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops import native_step


@register_backend("native")
class NativeBackend:
    name = "native"

    def __init__(self, *, threads: int | None = None, **_):
        if not native_step.available():
            raise RuntimeError(
                "native backend unavailable: disabled by TPU_LIFE_NATIVE=0"
            )
        self.threads = threads

    def run(
        self,
        board: np.ndarray,
        rule: Rule,
        steps: int,
        *,
        chunk_steps: int = 0,
        callback: ChunkCallback | None = None,
    ) -> np.ndarray:
        # fresh array even for steps=0 — every backend returns a board the
        # caller may mutate without aliasing the input
        board = np.array(board, dtype=np.int8)
        done = 0
        for n in chunk_sizes(steps, chunk_steps):
            board = native_step.run_native(board, rule, n, threads=self.threads)
            done += n
            if callback is not None:
                b = board
                callback(done, lambda b=b: b)
        return board
