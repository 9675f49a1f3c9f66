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

The names below load on first use (PEP 562), so a process that imports
only a torch-free submodule (``serve.spill``, ``serve.spill_http``,
``serve.errors``) does not load torch with the service: the HTTP spill
store and the gateway client run beside a wedged card.
"""

import importlib

_HOMES = {
    "CompileKey": "engine",
    "compile_key_for": "engine",
    "make_engine": "engine",
    "Draining": "errors",
    "InsufficientMemory": "errors",
    "QueueFull": "errors",
    "ServeError": "errors",
    "SessionFailed": "errors",
    "SessionTimeout": "errors",
    "UnknownSession": "errors",
    "RoundStats": "scheduler",
    "Scheduler": "scheduler",
    "ServeConfig": "service",
    "SimulationService": "service",
    "Session": "sessions",
    "SessionState": "sessions",
    "SessionStore": "sessions",
    "SessionView": "sessions",
}

__all__ = sorted(_HOMES)


def __getattr__(name: str):
    if name not in _HOMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_HOMES[name]}"), name)
    globals()[name] = value
    return value
