"""The port's gateway wire vocabulary, held to the JAX package's.

The same inputs go through both packages' ``parse_submit``,
``parse_trace_id``, ``render_view``, ``render_result``, ``decode_result``,
the serve-error map and the admission valves: each gives the same dict
(boards byte for byte), or the same ``ApiError`` status, code and message.
Boards and payloads come from numpy seeds.
"""

import base64
import dataclasses

import numpy as np
import pytest

from tpu_life.gateway import errors as jerrors
from tpu_life.gateway import limits as jlimits
from tpu_life.gateway import protocol as jprotocol
from tpu_life.io.codec import encode_board
from tpu_life.serve import errors as jserve_errors
from tpu_life.serve import sessions as jsessions
from tpu_life_torch.gateway import errors, limits, protocol
from tpu_life_torch.serve import errors as serve_errors
from tpu_life_torch.serve import sessions

RNG = np.random.default_rng(20)


def _board(h, w, states=2):
    return RNG.integers(0, states, size=(h, w)).astype(np.int8)


def _rows(board):
    return ["".join(str(int(v)) for v in row) for row in board]


def _resume(board, **extra):
    h, w = board.shape
    return {"resume_b64": base64.b64encode(encode_board(board)).decode(), "height": h,
            "width": w, **extra}


VALID = [
    {"board": _rows(_board(5, 7)), "rule": "conway", "steps": 4},
    {"board": _board(3, 4).tolist(), "steps": 0, "timeout_s": 2},
    {"board": _rows(_board(6, 6, 3)), "rule": "brians_brain", "steps": 9},
    {"size": 16, "steps": 3, "seed": 9},
    {"size": 16, "height": 4, "steps": 3},
    {"height": 11, "width": 5, "steps": 8, "seed": 7, "density": 0.4},
    {"size": 12, "steps": 1, "rule": "brians_brain"},
    {"size": 12, "steps": 200, "rule": "ising", "temperature": 2.27, "seed": 42},
    {"size": 10, "steps": 5, "rule": "noisy:0.01/conway", "seed": 3},
    {"board": _rows(_board(4, 6)), "steps": 5, "rule": "ising", "temperature": 1.5, "seed": -1},
    {"size": 16, "steps": 2, "rule": "lenia:mini", "seed": 3},
    {"height": 20, "width": 24, "steps": 2, "rule": "lenia:mini", "seed": 5, "density": 0.3},
    {"size": 8, "steps": 1, "trace_id": "0123456789abcdef"},
    _resume(_board(9, 10), rule="highlife", steps=12, start_step=30),
    _resume(_board(8, 8), rule="ising", steps=7, start_step=80, seed=42, temperature=2.27),
    {"board": _rows(_board(6, 6)), "steps": 4,
     "edits": [[2, [[1, 1, 1]]]], "scheduled_edits": [[6, [[0, 0, 0]]]], "stream_seq": 5},
    {"size": 14, "steps": 2, "rule": "R2,C2,S2..4,B3,NN"},
    {"size": 14, "steps": 2, "rule": "conway:T"},
]

INVALID = [
    {"steps": 1},
    {"board": [], "steps": 1},
    {"board": ["01", "0"], "steps": 1},
    {"board": ["0x"], "steps": 1},
    {"board": ["0¹1"], "steps": 1},
    {"board": [[0, True]], "steps": 1},
    {"board": [7], "steps": 1},
    {"board": ["09"], "steps": 1},
    {"board": ["01"]},
    {"board": ["01"], "steps": -1},
    {"board": ["01"], "steps": True},
    {"board": ["01"], "steps": 1, "rule": "nope!"},
    {"board": ["01"], "steps": 1, "timeout_s": "x"},
    {"size": 9000, "steps": 1},
    {"size": 8, "steps": 1, "density": 1.5},
    {"size": 0, "steps": 1},
    ["not", "an", "object"],
    {"size": 8, "steps": 1, "rule": "ising"},
    {"size": 8, "steps": 1, "temperature": 2.0},
    {"size": 7, "steps": 1, "rule": "ising", "temperature": 2.0},
    {"size": 8, "steps": 1, "rule": "noisy:2/conway"},
    {"size": 4, "steps": 1, "rule": "bugs"},
    {"size": 8, "steps": 1, "trace_id": "not a trace id!"},
    {"size": 8, "steps": 1, "trace_id": 7},
    _resume(_board(4, 4), steps=2, start_step=-3),
    {"resume_b64": "!!!", "height": 2, "width": 2, "steps": 1},
    {"resume_b64": base64.b64encode(b"0101").decode(), "height": 3, "width": 3, "steps": 1},
    {"board": _rows(_board(3, 3)), "steps": 1, "edits": "x"},
    {"board": _rows(_board(3, 3)), "steps": 1, "stream_seq": -1},
    {"size": 16, "steps": 1, "rule": "lenia:mini", "density": "x"},
]


def _outcome(mod, fn, *args):
    try:
        return ("ok", fn(mod)(*args))
    except (errors.ApiError, jerrors.ApiError) as e:
        return ("error", e.status, e.code, str(e), e.retry_after, e.body())


def _spec(spec):
    out = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    board = out.pop("board")
    return out, board.dtype.str, board.shape, board.tobytes()


@pytest.mark.parametrize("payload", VALID, ids=lambda p: str(p)[:60])
def test_valid_submissions_parse_alike(payload):
    want = jprotocol.parse_submit(payload)
    got = protocol.parse_submit(payload)
    assert _spec(got) == _spec(want)


@pytest.mark.parametrize("payload", INVALID, ids=lambda p: str(p)[:60])
def test_malformed_submissions_fail_alike(payload):
    want = _outcome(jprotocol, lambda m: m.parse_submit, payload)
    got = _outcome(protocol, lambda m: m.parse_submit, payload)
    assert want[0] == "error" and got == want


@pytest.mark.parametrize("raw", [None, "0123456789abcdef", "ABCDEF0123456789", "abc", "",
                                 "g" * 16, "0" * 33, 12, "0" * 32])
def test_trace_ids_parse_alike(raw):
    want = _outcome(jprotocol, lambda m: m.parse_trace_id, raw)
    assert _outcome(protocol, lambda m: m.parse_trace_id, raw) == want


def _views(**kw):
    """The same view in each package's SessionView."""
    state = kw.pop("state")
    return (sessions.SessionView(state=sessions.SessionState(state), **kw),
            jsessions.SessionView(state=jsessions.SessionState(state), **kw))


@pytest.mark.parametrize("kw", [
    dict(sid="s000001", state="running", steps=10, steps_done=4, result=None, error=None,
         rule="conway"),
    dict(sid="s000002", state="done", steps=0, steps_done=0, result=None, error=None),
    dict(sid="s000003", state="failed", steps=8, steps_done=2, result=None, error="boom",
         rule="B3/S23", trace_id="0123456789abcdef"),
    dict(sid="s000004", state="done", steps=7, steps_done=7, result=None, error=None,
         rule="ising", seed=9, temperature=2.27, packed=True, lanes=32,
         degraded_reason="oom_halved_chunk", edits=2, mesh="2x2", tenant="gold"),
    dict(sid="s000005", state="queued", steps=7, steps_done=0, result=None, error=None,
         rule="ising", seed=9, temperature=2.27, packed=False),
])
def test_views_render_alike(kw):
    port, jax = _views(**kw)
    assert protocol.render_view(port) == jprotocol.render_view(jax)


@pytest.mark.parametrize("fmt", ["rle", "raw", "png"])
@pytest.mark.parametrize("rule,states,shape", [("conway", 2, (9, 11)), ("brians_brain", 3, (7, 5)),
                                              ("conway", 2, (1, 1))])
def test_results_render_and_decode_alike(fmt, rule, states, shape):
    board = _board(*shape, states)
    want = _outcome(jprotocol, lambda m: m.render_result, board, fmt, rule)
    got = _outcome(protocol, lambda m: m.render_result, board, fmt, rule)
    assert got == want
    if fmt == "raw":
        assert protocol.decode_result(got[1]).tobytes() == board.tobytes()
        assert jprotocol.decode_result(got[1]).tobytes() == board.tobytes()


def test_float_results_render_alike():
    board = RNG.random((6, 7)).astype(np.float32)
    for fmt in ("raw", "rle"):
        want = _outcome(jprotocol, lambda m: m.render_result, board, fmt, "lenia:mini")
        assert _outcome(protocol, lambda m: m.render_result, board, fmt, "lenia:mini") == want
    payload = protocol.render_result(board, "raw", "lenia:mini")
    assert protocol.decode_result(payload).tobytes() == jprotocol.decode_result(payload).tobytes()


def _mapped(mod, exc):
    try:
        e = mod.from_serve_error(exc)
    except Exception as raised:  # an unmapped error propagates
        return ("raised", type(raised).__name__, str(raised))
    return (e.status, e.code, str(e), e.retry_after, e.body())


@pytest.mark.parametrize("name,args,kwargs", [
    ("QueueFull", ("full",), {}), ("Draining", ("draining",), {}),
    ("UnknownSession", ("who",), {}), ("SessionFailed", ("dead",), {}),
    ("SessionTimeout", ("late",), {}),
    ("InsufficientMemory", ("too big",),
     dict(transient=True, estimated_bytes=10, budget_bytes=5)),
    ("InsufficientMemory", ("never fits",),
     dict(transient=False, estimated_bytes=10, budget_bytes=5)),
])
def test_serve_errors_map_alike(name, args, kwargs):
    want = _mapped(jerrors, getattr(jserve_errors, name)(*args, **kwargs))
    assert _mapped(errors, getattr(serve_errors, name)(*args, **kwargs)) == want


def test_value_and_geometry_errors_map_alike():
    from tpu_life.models.rules import GeometryError as JGeometryError
    from tpu_life_torch.models.rules import GeometryError

    for port_exc, jax_exc in ((ValueError("bad board"), ValueError("bad board")),
                              (GeometryError("radius 5 > 4"), JGeometryError("radius 5 > 4"))):
        got, want = errors.from_serve_error(port_exc), jerrors.from_serve_error(jax_exc)
        assert (got.status, got.code, got.body()) == (want.status, want.code, want.body())
    with pytest.raises(KeyError):
        errors.from_serve_error(KeyError("not a serve error"))


@pytest.mark.parametrize("fn,args", [
    ("bad_request", ("invalid_json", "no")), ("not_found", ("no route for /x",)),
    ("method_not_allowed", ("PUT", "/healthz")), ("payload_too_large", (600, 512)),
    ("rate_limited", (1.5,)), ("overloaded", (5.0, 2.0, 0.7)),
    ("fmt_retry_after", (0.2,)), ("fmt_retry_after", (2.5,)),
])
def test_error_constructors_alike(fn, args):
    got, want = getattr(errors, fn)(*args), getattr(jerrors, fn)(*args)
    if isinstance(want, jerrors.ApiError):
        got = (got.status, got.code, str(got), got.retry_after, got.body())
        want = (want.status, want.code, str(want), want.retry_after, want.body())
    assert got == want


@pytest.mark.parametrize("tenant", ["free", None])
def test_best_effort_shed_alike(tenant):
    got = errors.shed_best_effort(5.0, 2.0, 0.7, tenant=tenant)
    want = jerrors.shed_best_effort(5.0, 2.0, 0.7, tenant=tenant)
    assert (got.status, got.code, str(got), got.retry_after, got.body()) == (
        want.status, want.code, str(want), want.retry_after, want.body())


@pytest.mark.parametrize("attempt", range(6))
def test_backoff_delay_alike(attempt):
    import random

    got = errors.backoff_delay(attempt, base=0.2, cap=5.0, jitter=0.25, rng=random.Random(attempt))
    want = jerrors.backoff_delay(attempt, base=0.2, cap=5.0, jitter=0.25,
                                 rng=random.Random(attempt))
    assert got == want


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_admission_valves_alike():
    traces = []
    for mod in (limits, jlimits):
        clock = FakeClock()
        bucket = mod.TokenBucket(rate=2.0, burst=3.0, clock=clock)
        keyed = mod.KeyedBuckets(1.0, 2.0, clock=clock, max_keys=3)
        depth = {"v": 0.0}
        shed = mod.LoadShedder(lambda: depth["v"], high_water=2.0)
        trace = []
        for i in range(12):
            clock.t += 0.13 * (i % 4)
            depth["v"] = float(i % 5)
            trace.append((bucket.acquire(), keyed.acquire(f"k{i % 5}"), shed.check()))
        traces.append(trace)
    assert traces[0] == traces[1]
