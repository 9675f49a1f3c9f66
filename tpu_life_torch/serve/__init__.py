"""tpu_life_torch.serve: the multi-tenant batched simulation service (the
port of ``tpu_life/serve``, with the JAX package's ``__all__``).

Many concurrent sessions — (board, rule, step budget) each — are packed
into fixed-capacity batches by compatible compile key and advanced a chunk
at a time, with continuous batching (sessions join and leave between
chunks; one build of the chunk per key), a bounded admission queue (typed
backpressure), per-request deadlines, and per-slot failure isolation.  On
the card a batch of the rules kernel K1 takes advances every slot in one
launch of K1's batch mode (serve/engine.py).

Quick start::

    from tpu_life_torch.serve import ServeConfig, SimulationService

    svc = SimulationService(ServeConfig(capacity=8))   # backend "cuda"
    sid = svc.submit(board, "conway", steps=100)
    svc.drain()
    final = svc.result(sid)

``python -m tpu_life_torch submit`` / ``serve`` are the CLI front-end.
"""

from tpu_life_torch.serve.engine import CompileKey, compile_key_for, make_engine
from tpu_life_torch.serve.errors import (
    Draining,
    InsufficientMemory,
    QueueFull,
    ServeError,
    SessionFailed,
    SessionTimeout,
    UnknownSession,
)
from tpu_life_torch.serve.scheduler import RoundStats, Scheduler
from tpu_life_torch.serve.service import ServeConfig, SimulationService
from tpu_life_torch.serve.sessions import Session, SessionState, SessionStore, SessionView

__all__ = [
    "CompileKey",
    "Draining",
    "InsufficientMemory",
    "QueueFull",
    "RoundStats",
    "Scheduler",
    "ServeConfig",
    "ServeError",
    "Session",
    "SessionFailed",
    "SessionState",
    "SessionStore",
    "SessionTimeout",
    "SessionView",
    "SimulationService",
    "UnknownSession",
    "compile_key_for",
    "make_engine",
]
