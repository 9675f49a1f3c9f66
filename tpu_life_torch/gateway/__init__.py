"""tpu_life_torch.gateway: the HTTP front door in front of the serving core
(the port of ``tpu_life/gateway``, with the JAX package's ``__all__``).

``tpu_life_torch.serve`` made the repo an in-process inference stack; this
package gives it a network surface with the robustness a front door owes
the scheduler behind it: typed JSON errors, per-API-key token-bucket rate
limiting (429 + ``Retry-After``), queue-depth load shedding
(reject-before-enqueue), bounded request bodies, ``/healthz`` /
``/readyz`` / live ``/metrics``, and SIGTERM graceful drain — stop
admitting, finish in-flight sessions, flush telemetry, exit 0.

Dependency-free by design (stdlib ``http.server`` + threads): ONE
background pump thread owns all device work while handler threads call
the service's now-locked verbs, so the engine's one-compile-per-
CompileKey invariant holds under concurrent clients.

Quick start::

    from tpu_life_torch.gateway import Gateway, GatewayConfig
    from tpu_life_torch.serve import ServeConfig, SimulationService

    svc = SimulationService(ServeConfig(capacity=8))  # "cuda")
    gw = Gateway(svc, GatewayConfig(port=8000))
    gw.start()                      # listener + pump threads
    ...
    gw.begin_drain(); gw.wait(); gw.close()

    from tpu_life_torch.gateway.client import GatewayClient
    c = GatewayClient("http://127.0.0.1:8000")
    sid = c.submit(size=256, steps=64)      # seeded board, no file needed
    c.wait(sid)
    board = c.result_board(sid)

The wire API is the JAX package's (docs/GATEWAY.md); ``python -m
tpu_life_torch gateway`` / ``client`` / ``spill-store`` are the CLI
front-ends.  The client, the protocol and the server module import no
torch: a client runs beside a wedged card.
"""

from tpu_life_torch.gateway.errors import ApiError
from tpu_life_torch.gateway.limits import KeyedBuckets, LoadShedder, TokenBucket
from tpu_life_torch.gateway.protocol import (
    MAX_BODY,
    MAX_CELLS,
    SubmitSpec,
    parse_submit,
    render_result,
    render_view,
)
from tpu_life_torch.gateway.server import Gateway, GatewayConfig

__all__ = [
    "ApiError",
    "Gateway",
    "GatewayConfig",
    "KeyedBuckets",
    "LoadShedder",
    "MAX_BODY",
    "MAX_CELLS",
    "SubmitSpec",
    "TokenBucket",
    "parse_submit",
    "render_result",
    "render_view",
]
