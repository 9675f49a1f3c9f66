"""The gateway's JSON wire vocabulary: requests in, views and boards out
(the port of ``tpu_life/gateway/protocol.py``: the same functions).

Kept apart from the HTTP server so the contract is testable without a
socket and reusable by the client.  Never imports torch at import time —
parsing and rendering are pure host-side work (numpy + the contract codec
+ RLE).  The rule registry, the stochastic checks and the seeded board
load on a request's first parse (the thin wrappers below), so the client
imports this module without torch.

Submit request (``POST /v1/sessions``)::

    {"board": ["0110", "1001", ...],        # rows of digit strings, or
     "board": [[0,1,1,0], ...],             # nested int lists
     "rule": "conway", "steps": 64,
     "timeout_s": 5.0}                      # optional deadline

or seeded geometry instead of an inline board (the ``run --size``
shorthand over the wire — demos need no input file)::

    {"size": 256, "steps": 64}              # or "height" + "width"
    {"height": 128, "width": 96, "steps": 8, "seed": 7, "density": 0.4}

Stochastic sessions (docs/STOCHASTIC.md) add the per-session Monte-Carlo
fields — ``seed`` names the counter-based PRNG stream, ``temperature``
is the ising Metropolis scalar (required there, a typed 400 elsewhere)::

    {"size": 128, "steps": 200, "rule": "ising",
     "temperature": 2.27, "seed": 42}

Resume requests (docs/FLEET.md failover) stage a byte-exact prior state
instead of a fresh board: ``resume_b64`` is base64 of the contract-codec
board bytes (``io/codec.py`` — the spill/snapshot format), ``start_step``
the absolute steps that board has already completed, ``steps`` the
REMAINING budget.  Deterministic rules resume exactly because the board
is the whole state; stochastic rules because the counter-based key
schedule re-enters the stream at ``start_step``::

    {"resume_b64": "...", "height": 128, "width": 128,
     "rule": "ising", "steps": 120, "start_step": 80,
     "seed": 42, "temperature": 2.27}

Result payload (``GET /v1/sessions/{sid}/result?format=rle|raw``):
``rle`` is the ecosystem interchange text (``io/rle.py``); ``raw`` is
base64 of the byte-exact contract board format (``io/codec.py``) — the
format a client decodes back to the identical int8 array, which is what
the byte-equality acceptance test asserts.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

from tpu_life_torch.gateway.errors import ApiError, bad_request
from tpu_life_torch.io.codec import decode_board, encode_board
from tpu_life_torch.io.rle import emit_rle

if TYPE_CHECKING:
    from tpu_life_torch.serve.sessions import SessionView


def get_rule(spec):
    from tpu_life_torch.models.rules import get_rule

    return get_rule(spec)


def mc_validate_params(rule, temperature):
    from tpu_life_torch.mc import validate_params

    return validate_params(rule, temperature)


def mc_validate_board_shape(rule, shape):
    from tpu_life_torch.mc import validate_board_shape

    return validate_board_shape(rule, shape)


def seeded_board(*args, **kwargs):
    from tpu_life_torch.mc.prng import seeded_board

    return seeded_board(*args, **kwargs)

#: Hard cap on inline/seeded board cells — a front door must bound the
#: memory one request can demand before any engine sees it (16 Mcells is
#: a 4096^2 board: far beyond what an inline JSON board is for).
MAX_CELLS = 1 << 24

#: Default request-body bound (bytes) — pre-read admission control.
MAX_BODY = 8 << 20


@dataclass(frozen=True)
class SubmitSpec:
    """A validated submission, ready for ``SimulationService.submit``.

    ``seed``/``temperature`` are the stochastic-tier fields
    (docs/STOCHASTIC.md): the counter-based PRNG stream id and the
    per-session ising scalar.  ``seed`` is also set for seeded-geometry
    deterministic requests (it named the staged board).  ``start_step``
    is the failover-resume field: absolute steps the staged board has
    already completed (0 for fresh sessions).
    """

    board: np.ndarray
    rule: str
    steps: int
    timeout_s: float | None
    seed: int | None = None
    temperature: float | None = None
    start_step: int = 0
    #: distributed-trace context (docs/OBSERVABILITY.md "Distributed
    #: tracing"): a client- or router-supplied id for this session's
    #: cross-process journey; the ``X-Trace-Id`` header wins over the
    #: body field at the HTTP layer, and a malformed value is a typed 400
    trace_id: str | None = None
    #: steered-session resume fields (docs/STREAMING.md): ``edits`` is
    #: the APPLIED edit log (already baked into the staged board —
    #: provenance for replay), ``scheduled_edits`` the unapplied tail the
    #: service must re-apply, ``stream_seq`` the delta-stream sequence
    #: floor so a reconnected watcher's numbering stays gapless across
    #: failover.  Cell-level validation is the service's (shape- and
    #: rule-aware); here the shape of the log itself is the contract.
    edits: list | None = None
    scheduled_edits: list | None = None
    stream_seq: int = 0
    #: shard-wise mega-board resume (docs/SERVING.md "Mega-board
    #: sessions"): a shared-filesystem pointer to a spilled tile set —
    #: no board bytes ride the wire; the survivor re-gathers shard by
    #: shard at admission and ``board`` is a zeros placeholder carrying
    #: only the geometry.
    resume_tiles_dir: str | None = None


def _require_int(payload: dict, key: str, *, minimum: int = 0) -> int:
    v = payload.get(key)
    # bool is an int subclass; "steps": true must not parse as 1
    if isinstance(v, bool) or not isinstance(v, int):
        raise bad_request(
            "invalid_request", f"{key!r} must be an integer, got {v!r}"
        )
    if v < minimum:
        raise bad_request(
            "invalid_request", f"{key!r} must be >= {minimum}, got {v}"
        )
    return v


def parse_trace_id(raw) -> str | None:
    """Validate a wire trace id (body field or ``X-Trace-Id`` header):
    None passes through, anything else must match the bounded id shape
    (``obs.TRACE_ID_RE``) — a hostile value must not ride into every
    span, file name and flight event of the session's journey."""
    if raw is None:
        return None
    from tpu_life_torch import obs

    if not obs.valid_trace_id(raw):
        raise bad_request(
            "invalid_trace_id",
            "trace id must be 1-64 characters of [A-Za-z0-9._:-] "
            "starting alphanumeric",
        )
    return raw


def _check_rule_geometry(rule, shape) -> None:
    """Kernel-vs-board geometry as a typed 400 (docs/RULES.md): a
    Larger-than-Life or continuous kernel wider than the board rejects
    HERE — ``radius_too_large`` — never as a downstream shape error."""
    from tpu_life_torch.models.rules import GeometryError, validate_rule_geometry

    try:
        validate_rule_geometry(rule, shape)
    except GeometryError as e:
        raise bad_request("radius_too_large", str(e)) from None


def parse_board(raw, rule) -> np.ndarray:
    """Inline JSON board -> int8 (or, for continuous rules, float32)
    array, with typed 400s for every malformation.

    Discrete rules take digit-string rows or nested int lists; the
    continuous tier additionally accepts float cells (values in
    [0, 1]) — a digit-string row of 0s and 1s is legal there too.
    """
    continuous = bool(getattr(rule, "continuous", False))
    states = rule.states
    if not isinstance(raw, list) or not raw:
        raise bad_request(
            "invalid_board", "'board' must be a non-empty list of rows"
        )
    rows: list[list] = []
    width = None
    for i, row in enumerate(raw):
        if isinstance(row, str):
            # isascii() too: str.isdigit() admits Unicode digits ('¹', '٣')
            # that int() then rejects — a 500 instead of this typed 400
            if not (row.isascii() and row.isdigit()):
                raise bad_request(
                    "invalid_board",
                    f"board row {i} contains non-digit characters",
                )
            cells = [int(c) for c in row]
        elif isinstance(row, list):
            ok_types = (int, float) if continuous else (int,)
            if not all(
                isinstance(c, ok_types) and not isinstance(c, bool)
                for c in row
            ):
                raise bad_request(
                    "invalid_board",
                    f"board row {i} must hold only "
                    + ("numbers" if continuous else "integers"),
                )
            cells = row
        else:
            raise bad_request(
                "invalid_board",
                f"board row {i} must be a digit string or "
                + ("a number list" if continuous else "an int list"),
            )
        if not cells:
            raise bad_request("invalid_board", f"board row {i} is empty")
        if width is None:
            width = len(cells)
        elif len(cells) != width:
            raise bad_request(
                "invalid_board",
                f"board row {i} has {len(cells)} cells; row 0 has {width}",
            )
        rows.append(cells)
    if len(rows) * width > MAX_CELLS:
        raise bad_request(
            "board_too_large",
            f"board has {len(rows) * width} cells; the limit is {MAX_CELLS}",
        )
    if continuous:
        board = np.array(rows, dtype=np.float64)
        if not np.isfinite(board).all():
            raise bad_request(
                "invalid_board", "board contains NaN or Inf"
            )
        lo, hi = float(board.min()), float(board.max())
        if lo < 0.0 or hi > 1.0:
            raise bad_request(
                "invalid_board",
                f"board values must be in [0, 1] for continuous rule "
                f"{rule.name!r}; found {lo if lo < 0.0 else hi}",
            )
        return board.astype(np.float32)
    board = np.array(rows, dtype=np.int64)
    lo, hi = int(board.min()), int(board.max())
    if lo < 0 or hi >= states:
        raise bad_request(
            "invalid_board",
            f"board states must be 0..{states - 1} for this rule; "
            f"found {lo if lo < 0 else hi}",
        )
    return board.astype(np.int8)


def parse_resume_board(payload: dict, rule) -> np.ndarray:
    """``resume_b64`` + geometry -> the byte-exact board, with typed
    400s for malformed base64, geometry mismatch, or out-of-range
    states.  The bytes ARE the spill/snapshot contract format (the
    float32 encoding for continuous rules — ``io/codec.py``), so a
    resumed board is identical down to the byte to what the dead worker
    spilled."""
    continuous = bool(getattr(rule, "continuous", False))
    states = rule.states
    height = _require_int(payload, "height", minimum=1)
    width = _require_int(payload, "width", minimum=1)
    if height * width > MAX_CELLS:
        raise bad_request(
            "board_too_large",
            f"resume board has {height * width} cells; the limit is {MAX_CELLS}",
        )
    raw = payload["resume_b64"]
    if not isinstance(raw, str):
        raise bad_request("invalid_request", "'resume_b64' must be a string")
    try:
        buf = base64.b64decode(raw, validate=True)
    except (base64.binascii.Error, ValueError) as e:
        raise bad_request(
            "invalid_request", f"'resume_b64' is not valid base64: {e}"
        ) from None
    try:
        board = decode_board(buf, height, width)
    except ValueError as e:
        raise bad_request("invalid_board", str(e)) from None
    if continuous:
        if not np.issubdtype(board.dtype, np.floating):
            raise bad_request(
                "invalid_board",
                f"continuous rule {rule.name!r} resumes from the float32 "
                f"board encoding ({height * width * 4} bytes), got the "
                f"digit-grid encoding",
            )
        lo = float(board.min(initial=0.0))
        hi = float(board.max(initial=0.0))
        if lo < 0.0 or hi > 1.0:
            raise bad_request(
                "invalid_board",
                f"resume board values must be in [0, 1]; "
                f"found {lo if lo < 0.0 else hi}",
            )
        return board
    if np.issubdtype(board.dtype, np.floating):
        raise bad_request(
            "invalid_board",
            f"rule {rule.name!r} resumes from the digit-grid board "
            f"encoding, got the float32 encoding",
        )
    lo, hi = int(board.min(initial=0)), int(board.max(initial=0))
    if lo < 0 or hi >= states:
        raise bad_request(
            "invalid_board",
            f"resume board states must be 0..{states - 1} for this rule; "
            f"found {lo if lo < 0 else hi}",
        )
    return board


def _parse_edit_log_field(payload: dict, key: str) -> list | None:
    """Shape-check a wire edit log (``[[step, [[r, c, v], ...]], ...]``)
    as a typed 400; cell-level validation (bounds, states, the float
    range) is the service's, shape- and rule-aware, surfaced as 400 via
    the standard ValueError mapping."""
    raw = payload.get(key)
    if raw is None:
        return None
    if not isinstance(raw, list):
        raise bad_request(
            "invalid_request", f"{key!r} must be a list of [step, cells] pairs"
        )
    for i, entry in enumerate(raw):
        if (
            not isinstance(entry, (list, tuple))
            or len(entry) != 2
            or isinstance(entry[0], bool)
            or not isinstance(entry[0], int)
            or not isinstance(entry[1], list)
        ):
            raise bad_request(
                "invalid_request",
                f"{key!r} entry {i} must be a [step, cells] pair",
            )
    return raw


def parse_submit(payload) -> SubmitSpec:
    """Request JSON -> :class:`SubmitSpec`; raises :class:`ApiError` (400s)."""
    if not isinstance(payload, dict):
        raise bad_request("invalid_request", "request body must be a JSON object")
    rule_name = payload.get("rule", "conway")
    if not isinstance(rule_name, str):
        raise bad_request("invalid_request", "'rule' must be a string")
    try:
        rule = get_rule(rule_name)
    except (ValueError, KeyError) as e:
        raise bad_request("unknown_rule", str(e)) from None
    steps = _require_int(payload, "steps")
    timeout_s = payload.get("timeout_s")
    if timeout_s is not None:
        if isinstance(timeout_s, bool) or not isinstance(timeout_s, (int, float)):
            raise bad_request(
                "invalid_request", f"'timeout_s' must be a number, got {timeout_s!r}"
            )
        timeout_s = float(timeout_s)
    temperature = payload.get("temperature")
    if temperature is not None:
        if isinstance(temperature, bool) or not isinstance(
            temperature, (int, float)
        ):
            raise bad_request(
                "invalid_request",
                f"'temperature' must be a number, got {temperature!r}",
            )
        temperature = float(temperature)
    try:
        # the (rule, temperature) pairing contract (tpu_life_torch.mc): ising
        # needs one, nothing else takes one — typed 400, not a late 500
        mc_validate_params(rule, temperature)
    except ValueError as e:
        raise bad_request("invalid_request", str(e)) from None
    seed = (
        _require_int(payload, "seed", minimum=-(1 << 63))
        if "seed" in payload
        else None
    )
    start_step = (
        _require_int(payload, "start_step") if "start_step" in payload else 0
    )
    trace_id = parse_trace_id(payload.get("trace_id"))
    edits = _parse_edit_log_field(payload, "edits")
    scheduled_edits = _parse_edit_log_field(payload, "scheduled_edits")
    stream_seq = (
        _require_int(payload, "stream_seq") if "stream_seq" in payload else 0
    )

    if "resume_tiles_dir" in payload:
        # shard-wise mega-board resume (docs/SERVING.md "Mega-board
        # sessions"): a shared-filesystem pointer to a spilled tile set.
        # No board bytes on the wire — a mega-board would not fit a
        # request body, and must never be materialized on one host; the
        # placeholder carries only geometry, the service validates the
        # pointed-at manifest against it.
        tiles_dir = payload["resume_tiles_dir"]
        if not isinstance(tiles_dir, str) or not tiles_dir:
            raise bad_request(
                "invalid_request",
                "'resume_tiles_dir' must be a non-empty path string",
            )
        height = _require_int(payload, "height", minimum=1)
        width = _require_int(payload, "width", minimum=1)
        _check_rule_geometry(rule, (height, width))
        board = np.zeros((height, width), dtype=rule.board_dtype)
        return SubmitSpec(
            board=board,
            rule=rule_name,
            steps=steps,
            timeout_s=timeout_s,
            seed=seed,
            temperature=temperature,
            start_step=start_step,
            trace_id=trace_id,
            edits=edits,
            scheduled_edits=scheduled_edits,
            stream_seq=stream_seq,
            resume_tiles_dir=tiles_dir,
        )

    if "resume_b64" in payload:
        # failover resume: byte-exact contract-codec board + the absolute
        # stream position it corresponds to (docs/FLEET.md)
        board = parse_resume_board(payload, rule)
        _check_rule_geometry(rule, board.shape)
        return SubmitSpec(
            board=board,
            rule=rule_name,
            steps=steps,
            timeout_s=timeout_s,
            seed=seed,
            temperature=temperature,
            start_step=start_step,
            trace_id=trace_id,
            edits=edits,
            scheduled_edits=scheduled_edits,
            stream_seq=stream_seq,
        )

    if "board" in payload:
        board = parse_board(payload["board"], rule)
        _check_rule_geometry(rule, board.shape)
        return SubmitSpec(
            board=board,
            rule=rule_name,
            steps=steps,
            timeout_s=timeout_s,
            seed=seed,
            temperature=temperature,
            start_step=start_step,
            trace_id=trace_id,
            edits=edits,
            scheduled_edits=scheduled_edits,
            stream_seq=stream_seq,
        )

    # seeded geometry: the self-contained demo path (run --size over HTTP);
    # explicit height/width win over the square 'size' shorthand
    size = _require_int(payload, "size", minimum=1) if "size" in payload else None
    height = (
        _require_int(payload, "height", minimum=1) if "height" in payload else size
    )
    width = (
        _require_int(payload, "width", minimum=1) if "width" in payload else size
    )
    if height is None or width is None:
        raise bad_request(
            "invalid_request",
            "provide either 'board' (inline) or geometry "
            "('size', or 'height' + 'width') for a seeded board",
        )
    if height * width > MAX_CELLS:
        raise bad_request(
            "board_too_large",
            f"seeded board has {height * width} cells; the limit is {MAX_CELLS}",
        )
    try:
        # the stochastic lattice contract (tpu_life_torch.mc) checked BEFORE the
        # board is staged: odd ising dimensions (and, were MAX_CELLS ever
        # raised past it, the PRNG counter width) reject as a typed 400
        # instead of burning the staging work first.  The service's submit
        # re-validates with its executor's actual wide-counter capability.
        mc_validate_board_shape(rule, (height, width))
    except ValueError as e:
        raise bad_request("invalid_board", str(e)) from None
    _check_rule_geometry(rule, (height, width))
    density = payload.get("density", 0.5)
    if isinstance(density, bool) or not isinstance(density, (int, float)):
        raise bad_request("invalid_request", "'density' must be a number")
    if not 0.0 <= density <= 1.0:
        raise bad_request(
            "invalid_request", f"'density' must be in [0, 1], got {density}"
        )
    # counter-based staging (tpu_life_torch.mc.prng): the board a seed names is
    # identical on every host, so the echoed seed fully replays the run.
    # Continuous rules stage the float twin (models/lenia.seeded_board).
    staged_seed = 0 if seed is None else seed
    if getattr(rule, "continuous", False):
        from tpu_life_torch.models.lenia import seeded_board as lenia_seeded_board

        board = lenia_seeded_board(
            height, width, float(density), seed=staged_seed
        )
    else:
        board = seeded_board(
            height, width, float(density), states=rule.states, seed=staged_seed
        )
    return SubmitSpec(
        board=board,
        rule=rule_name,
        steps=steps,
        timeout_s=timeout_s,
        seed=staged_seed,
        temperature=temperature,
        start_step=start_step,
        trace_id=trace_id,
        edits=edits,
        scheduled_edits=scheduled_edits,
        stream_seq=stream_seq,
    )


# -- responses -------------------------------------------------------------
def render_view(view: SessionView) -> dict:
    """``poll`` response body (no board — results have their own route)."""
    out = {
        "session": view.sid,
        "state": view.state.value,
        "rule": view.rule,
        "steps": view.steps,
        "steps_done": view.steps_done,
        "progress": view.steps_done / view.steps if view.steps else 1.0,
        "finished": view.finished,
        "error": view.error,
    }
    # the replay record (docs/STOCHASTIC.md) — present only when the
    # session consumed the stochastic tier, so deterministic responses
    # keep their exact prior shape
    if view.seed is not None:
        out["seed"] = view.seed
    if view.temperature is not None:
        out["temperature"] = view.temperature
    # execution-path attribution (docs/OBSERVABILITY.md): stamped once a
    # stochastic session is admitted to an engine — True with a "lanes"
    # width on the bitplane-packed path, False on the int8 roll path
    if view.packed is not None:
        out["packed"] = view.packed
        if view.lanes is not None:
            out["lanes"] = view.lanes
    # the OOM fallback ladder's stamp (docs/SERVING.md "Resource
    # governance") — present only when the session's CompileKey degraded
    # to keep serving, so untouched sessions keep their exact prior shape
    if view.degraded_reason is not None:
        out["degraded_reason"] = view.degraded_reason
    # the distributed-trace id (docs/OBSERVABILITY.md): echoed whenever
    # the session carries one, so a client report names the exact trace
    if view.trace_id is not None:
        out["trace_id"] = view.trace_id
    # steering provenance (docs/STREAMING.md): the count of recorded
    # cell edits — present only when the session was steered, so
    # untouched sessions keep their exact prior response shape
    if view.edits:
        out["edits"] = view.edits
    # mega-board stamp (docs/SERVING.md "Mega-board sessions"): "RxC"
    # when the board runs sharded over a mesh slice — present only
    # there, so single-chip responses keep their exact prior shape
    if view.mesh is not None:
        out["mesh"] = view.mesh
    # tenant stamp (docs/SERVING.md "Tenant QoS"): the resolved tenant
    # this session was admitted under — present only when a QoS policy
    # resolved one, so policy-less responses keep their exact prior shape
    if view.tenant is not None:
        out["tenant"] = view.tenant
    return out


def render_result(board: np.ndarray, fmt: str, rule: str) -> dict:
    """Result payload in the requested encoding (``rle`` | ``raw``).

    Continuous-tier (float32) boards have no RLE form — ``raw`` is the
    byte-exact little-endian float32 contract encoding, stamped with a
    ``dtype`` field so clients (and ``decode_result``) know what the
    bytes are; asking a float board for ``rle`` is a typed 400.
    """
    h, w = board.shape
    out = {"format": fmt, "height": int(h), "width": int(w), "rule": rule}
    floating = np.issubdtype(board.dtype, np.floating)
    if fmt == "rle":
        if floating:
            raise bad_request(
                "invalid_format",
                "continuous (float32) boards have no RLE form; use "
                "format=raw",
            )
        states = max(2, int(board.max(initial=0)) + 1)
        try:
            states = get_rule(rule).states
        except (ValueError, KeyError):
            pass  # header follows board content for unregistered specs
        out["rle"] = emit_rle(board, rule=rule, states=states)
    elif fmt == "raw":
        out["b64"] = base64.b64encode(encode_board(board)).decode("ascii")
        if floating:
            out["dtype"] = "float32"
    else:
        raise bad_request(
            "invalid_format", f"format must be 'rle' or 'raw', got {fmt!r}"
        )
    return out


def decode_result(payload: dict) -> np.ndarray:
    """Client-side inverse of :func:`render_result` for ``raw`` payloads."""
    if payload.get("format") != "raw":
        raise ValueError(f"cannot decode format {payload.get('format')!r}")
    buf = base64.b64decode(payload["b64"])
    return decode_board(buf, int(payload["height"]), int(payload["width"]))


__all__ = [
    "ApiError",
    "MAX_BODY",
    "MAX_CELLS",
    "SubmitSpec",
    "decode_result",
    "parse_board",
    "parse_resume_board",
    "parse_trace_id",
    "parse_submit",
    "render_result",
    "render_view",
]
