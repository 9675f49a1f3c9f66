"""The remote spill store: the checkpoint contract ported to the wire.

Durability today rests on a local directory (``serve.spill``), which
quietly assumes the rescuer shares a filesystem with the victim.  This
module breaks that assumption with three pieces, keeping the SAME
crash-consistency contract — atomic publish, CRC32 witness, newest-2
retention, demote-to-predecessor on a failed intact check:

- :class:`SpillHTTPServer` — a small stdlib HTTP object store any worker
  or supervisor can host (``tpu-life spill-store``).  Objects live under
  ``<root>/<namespace>/<sid>/``; every PUT carries an ``X-CRC32`` header
  the server verifies against the received body BEFORE publishing (a
  torn upload can never be published as truth), and publishes atomically
  (tmp + rename) next to a CRC sidecar it replays on GET.
- :class:`HttpSpillBackend` — the worker-side
  :class:`~tpu_life_torch.serve.spill.SpillBackend`: per-operation timeouts,
  bounded jittered retry on REFUSALS only (connection refused, typed
  503 — the request was definitively not applied; a timeout or
  mid-exchange reset is never blindly re-sent even though PUTs are
  idempotent, matching the fleet's no-ambiguous-retry discipline), and
  any exhausted/ambiguous failure surfaces as :class:`OSError` so the
  service's existing graceful degradation (that session ->
  ``spill_disabled``, the pump never stalls) is what runs.
- :func:`read_remote_sessions` — the migration tier's read path: same
  triage as ``read_spill_sessions`` (corrupt / disabled / demote), with
  the CRC check re-run on the DOWNLOADED bytes, so a body torn on the
  wire demotes to the predecessor snapshot exactly like disk rot.

The failure matrix (docs/FLEET.md "Cross-host topology"):

====================  =======================================
fault                 outcome
====================  =======================================
connect refused       bounded jittered retry, then OSError
typed 503             bounded jittered retry, then OSError
timeout               OSError (write) / demote (read)
reset mid-body        OSError (write) / demote (read)
torn / short body     400 at the server (write) / demote (read)
CRC mismatch on read  demote to predecessor, else corrupt sid
other 4xx/5xx         OSError (write) / corrupt (read)
====================  =======================================

On the write side every OSError degrades ONE session to
``spill_disabled``; on the read side "corrupt" is the typed 410
``spill_corrupt`` and a missing namespace is simply zero records
(``never_snapshotted`` for its sids).
"""

from __future__ import annotations

import http.client
import json
import re
import shutil
import socket
import threading
import time
import urllib.error
import urllib.request
import zlib
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np

from tpu_life_torch import chaos
from tpu_life_torch.gateway.errors import ApiError, backoff_delay, parse_retry_after
from tpu_life_torch.io.codec import decode_board, encode_board
from tpu_life_torch.runtime.checkpoint import atomic_publish
from tpu_life_torch.runtime.metrics import log
from tpu_life_torch.serve.spill import (
    DISABLED,
    KEEP_SNAPSHOTS,
    MANIFEST,
    SpillBackend,
    SpillRecord,
)

#: URL prefix of the store API.
ROUTE_SPILL = "/v1/spill"

#: Namespace / sid / object names: one path segment, no traversal.  The
#: dots admit ``manifest.json`` / ``DISABLED.json``; ``..`` is refused.
_SAFE = re.compile(r"(?!\.\.?$)[A-Za-z0-9][A-Za-z0-9._-]*$")

_SNAP = re.compile(r"snap_(\d{9})$")


def snap_name(step: int) -> str:
    return f"snap_{int(step):09d}"


def _require_safe(*names: str) -> None:
    for n in names:
        if not _SAFE.match(n):
            raise ApiError(400, "bad_name", f"illegal path segment {n!r}")


# ---------------------------------------------------------------------------
# the server: a CRC-checked, atomically-published object store
# ---------------------------------------------------------------------------
class SpillHTTPServer:
    """Host a spill namespace tree over HTTP (stdlib only — the store is
    plumbing, and any fleet process can carry it)."""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0):
        # import here, not at module top: gateway.server is where the
        # shared JSON envelope plumbing lives
        from tpu_life_torch.gateway.server import JsonHandler

        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        outer = self

        class _Handler(JsonHandler):
            server_version = "tpu-life-spill/1"
            log_tag = "spill-store"

            def do_GET(self):  # noqa: N802
                outer._dispatch(self, "GET")

            def do_PUT(self):  # noqa: N802
                outer._dispatch(self, "PUT")

            def do_DELETE(self):  # noqa: N802
                outer._dispatch(self, "DELETE")

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._server.allow_reuse_address = True
        self.host, self.port = self._server.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="spill-store",
            daemon=True,
        )
        self._thread.start()
        log.info("spill-store: serving %s at %s", self.root, self.url)

    def close(self) -> None:
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()

    # -- dispatch -----------------------------------------------------------
    def _dispatch(self, h, method: str) -> None:
        try:
            self._route(h, method, h.path.rstrip("/"))
        except ApiError as e:
            try:
                h._send_json(e.status, e.body(), retry_after=e.retry_after)
            except (BrokenPipeError, ConnectionResetError):
                pass
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception:
            log.exception("spill-store: %s %s failed", method, h.path)
            try:
                h._send_json(
                    500,
                    {"error": {"code": "internal", "message": "internal error"}},
                )
            except (BrokenPipeError, ConnectionResetError):
                pass

    def _route(self, h, method: str, path: str) -> None:
        if path == "/healthz":
            h._send_json(200, {"status": "ok"})
            return
        if path == ROUTE_SPILL and method == "GET":
            # namespace listing — the control plane's orphan sweep
            spaces = sorted(
                p.name for p in self.root.iterdir() if p.is_dir()
            ) if self.root.is_dir() else []
            h._send_json(200, {"namespaces": spaces})
            return
        if not path.startswith(ROUTE_SPILL + "/"):
            raise ApiError(404, "not_found", f"no route for {path}")
        parts = path[len(ROUTE_SPILL) + 1 :].split("/")
        _require_safe(*parts)
        if len(parts) == 1:
            ns = self.root / parts[0]
            if method == "GET":
                h._send_json(200, self._listing(ns))
            elif method == "DELETE":
                shutil.rmtree(ns, ignore_errors=True)
                h._send_json(200, {"deleted": parts[0]})
            else:
                raise ApiError(405, "method_not_allowed", method)
            return
        if len(parts) == 2:
            d = self.root / parts[0] / parts[1]
            if method != "DELETE":
                raise ApiError(405, "method_not_allowed", method)
            shutil.rmtree(d, ignore_errors=True)
            h._send_json(200, {"deleted": f"{parts[0]}/{parts[1]}"})
            return
        if len(parts) != 3:
            raise ApiError(404, "not_found", path)
        obj = self.root / parts[0] / parts[1] / parts[2]
        if method == "PUT":
            self._put(h, obj)
        elif method == "GET":
            self._get(h, obj)
        elif method == "DELETE":
            obj.unlink(missing_ok=True)
            _crc_file(obj).unlink(missing_ok=True)
            h._send_json(200, {"deleted": parts[2]})
        else:
            raise ApiError(405, "method_not_allowed", method)

    def _listing(self, ns: Path) -> dict:
        """Per-sid snapshot steps + marker flags — everything the read
        path needs to triage without N round-trips per object."""
        sids: dict[str, dict] = {}
        if ns.is_dir():
            for d in sorted(p for p in ns.iterdir() if p.is_dir()):
                snaps = sorted(
                    int(m.group(1))
                    for f in d.iterdir()
                    if (m := _SNAP.match(f.name))
                )
                sids[d.name] = {
                    "snaps": snaps,
                    "manifest": (d / MANIFEST).exists(),
                    "disabled": (d / DISABLED).exists(),
                }
        return {"namespace": ns.name, "sids": sids}

    def _put(self, h, obj: Path) -> None:
        body = h._read_sized_body(64 * 1024 * 1024)
        crc = zlib.crc32(body) & 0xFFFFFFFF
        claimed = h.headers.get("X-CRC32")
        try:
            intact = claimed is not None and int(claimed) == crc
        except ValueError:
            intact = False  # a garbled witness is a torn upload, typed
        if not intact:
            # a torn/garbled upload: refuse BEFORE publishing — the store
            # must never hold bytes that disagree with their witness
            raise ApiError(
                400,
                "crc_mismatch",
                f"body crc32 {crc} != claimed {claimed!r}; upload torn?",
            )
        try:
            obj.parent.mkdir(parents=True, exist_ok=True)
            with atomic_publish(obj) as tmp:
                tmp.write_bytes(body)
            with atomic_publish(_crc_file(obj)) as tmp:
                tmp.write_text(str(crc))
        except (FileNotFoundError, FileExistsError):
            # a concurrent DELETE of the sid/namespace swept the dir out
            # from under the write (mark_disabled and the migrator's reap
            # both rmtree): the publish loses its tmp (ENOENT), or mkdir's
            # exist_ok re-check races the rmtree (EEXIST then not-a-dir).
            # The store no longer wants these bytes; typed, so the writer
            # degrades without a server stack trace
            raise ApiError(
                409, "deleted_concurrently", f"{obj.parent} was deleted mid-write"
            ) from None
        h._send_json(200, {"stored": obj.name, "crc32": crc})

    def _get(self, h, obj: Path) -> None:
        try:
            body = obj.read_bytes()
        except OSError:
            raise ApiError(404, "not_found", f"no object {obj.name}") from None
        try:
            crc = int(_crc_file(obj).read_text())
        except (OSError, ValueError):
            crc = zlib.crc32(body) & 0xFFFFFFFF
        h.send_response(200)
        h.send_header("Content-Type", "application/octet-stream")
        h.send_header("Content-Length", str(len(body)))
        h.send_header("X-CRC32", str(crc))
        h.end_headers()
        h.wfile.write(body)


def _crc_file(obj: Path) -> Path:
    return obj.with_name(obj.name + ".crc32")


# ---------------------------------------------------------------------------
# the worker-side backend
# ---------------------------------------------------------------------------
class HttpSpillBackend(SpillBackend):
    """Spill through a remote :class:`SpillHTTPServer`.

    Every operation is bounded by ``timeout_s``; refusals (connection
    refused, typed 503) retry up to ``retries`` times on the shared
    jittered-exponential curve; anything else — timeout, reset, 4xx/5xx —
    raises :class:`OSError`, which the service's spill pass translates
    into that one session's ``spill_disabled`` degradation.  All writes
    run in the pump's unlocked settle window, so a slow or dead store
    costs durability, never the service.

    ``namespace`` is this worker incarnation's slice of the store; a
    wire-registered worker rebinds it when the control plane grants a
    fresh ``(worker, generation)`` (:meth:`set_namespace`).
    """

    def __init__(
        self,
        base_url: str,
        namespace: str,
        *,
        timeout_s: float = 5.0,
        retries: int = 3,
        backoff_s: float = 0.1,
        max_backoff_s: float = 2.0,
        jitter: float = 0.25,
        rng=None,
        sleep=time.sleep,
    ):
        self.base_url = base_url.rstrip("/")
        if not _SAFE.match(namespace):
            raise ValueError(f"illegal spill namespace {namespace!r}")
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.jitter = jitter
        self.rng = rng
        self.sleep = sleep
        self._lock = threading.Lock()
        self._namespace = namespace
        self._written: dict[str, list[int]] = {}
        self._edit_counts: dict[str, int] = {}

    @property
    def namespace(self) -> str:
        with self._lock:
            return self._namespace

    def set_namespace(self, namespace: str) -> None:
        """Rebind to a fresh incarnation namespace (a wire-registered
        worker whose lease was re-granted under a new generation).  The
        write-tracking resets with it: the new namespace holds nothing,
        and the OLD one is the migrator's to read and reap — never ours
        to keep appending to."""
        if not _SAFE.match(namespace):
            raise ValueError(f"illegal spill namespace {namespace!r}")
        with self._lock:
            if namespace == self._namespace:
                return
            self._namespace = namespace
            self._written = {}
            self._edit_counts = {}
        log.info("spill: rebound to remote namespace %s", namespace)

    # -- transport ----------------------------------------------------------
    def _url(self, sid: str, obj: str | None = None, *, ns: str | None = None) -> str:
        # multi-request operations (save: snapshot PUT + manifest PUT +
        # prunes) must pass the SAME captured ``ns`` to every request — a
        # concurrent set_namespace (Registrar re-grant) between reads
        # would otherwise split one spill across two incarnations
        tail = f"/{obj}" if obj else ""
        return f"{self.base_url}{ROUTE_SPILL}/{ns or self.namespace}/{sid}{tail}"

    def _request(
        self,
        method: str,
        url: str,
        body: bytes | None = None,
        *,
        retry: bool = True,
    ) -> tuple[int, dict, bytes]:
        """One store operation -> (status, headers, body).  Chaos seams
        and the refusal-only retry loop live here; exhausted retries and
        every ambiguous transport failure raise OSError."""
        attempt = 0
        while True:
            hinted = None
            try:
                if chaos.decide("spill.remote.timeout") is not None:
                    chaos.record_fire("spill.remote.timeout", "timeout")
                    raise socket.timeout(
                        "chaos: injected remote-spill timeout"
                    )
                if chaos.partitioned("spill", self.base_url):
                    raise ConnectionRefusedError(
                        "chaos: net partition to spill store"
                    )
                req = urllib.request.Request(url, data=body, method=method)
                if body is not None:
                    req.add_header("Content-Type", "application/octet-stream")
                    req.add_header(
                        "X-CRC32", str(zlib.crc32(body) & 0xFFFFFFFF)
                    )
                with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                    return r.status, dict(r.headers), r.read()
            except urllib.error.HTTPError as e:
                if e.code == 503 and retry and attempt < self.retries:
                    # a typed refusal: nothing was applied — pace, retry.
                    # The store's explicit Retry-After wins un-jittered
                    # over the backoff curve (the shared doctrine); drain
                    # the error body so the connection isn't left
                    # half-read behind the retry
                    hinted = parse_retry_after(e.headers)
                    try:
                        e.read()
                    except (OSError, http.client.HTTPException):
                        pass
                else:
                    try:
                        return e.code, dict(e.headers), e.read()
                    except (OSError, http.client.HTTPException) as e2:
                        raise OSError(
                            f"spill store {method} {url}: error body torn: {e2}"
                        ) from None
            except http.client.HTTPException as e:
                # reset mid-body (IncompleteRead and kin): the bytes are
                # torn and the request's fate is ambiguous — never
                # re-sent, surfaced as the OSError the degradation path
                # catches (the docstring's "reset mid-body" row)
                raise OSError(f"spill store {method} {url}: {e}") from None
            except (urllib.error.URLError, ConnectionError, socket.timeout, TimeoutError) as e:
                reason = getattr(e, "reason", e)
                refused = isinstance(reason, ConnectionRefusedError) or isinstance(
                    e, ConnectionRefusedError
                )
                if not (refused and retry and attempt < self.retries):
                    # ambiguous (timeout, mid-exchange reset) or retries
                    # exhausted: surface as the OSError the degradation
                    # path catches
                    raise OSError(f"spill store {method} {url}: {e}") from None
            attempt += 1
            self.sleep(
                hinted
                if hinted is not None
                else backoff_delay(
                    attempt,
                    base=self.backoff_s,
                    cap=self.max_backoff_s,
                    jitter=self.jitter,
                    rng=self.rng,
                )
            )

    def _put(self, sid: str, obj: str, body: bytes, *, ns: str | None = None) -> None:
        status, _, raw = self._request("PUT", self._url(sid, obj, ns=ns), body)
        if status != 200:
            raise OSError(
                f"spill store refused PUT {ns or self.namespace}/{sid}/{obj}: "
                f"{status} {raw[:200]!r}"
            )

    # -- the SpillBackend contract ------------------------------------------
    def save(
        self,
        sid: str,
        board: np.ndarray,
        step: int,
        *,
        rule: str,
        steps_total: int,
        seed: int | None,
        temperature: float | None,
        timeout_s: float | None,
        trace_id: str | None = None,
        edits: list | None = None,
        scheduled_edits: list | None = None,
        stream_seq: int = 0,
    ) -> bool:
        edit_count = len(edits or []) + len(scheduled_edits or [])
        with self._lock:
            ns = self._namespace
            written = self._written.setdefault(sid, [])
            last_edits = self._edit_counts.get(sid, 0)
        # a same-step save with a GROWN edit log still writes (the
        # queued-edit case — the manifest changed, the step did not)
        if written and written[-1] == step and last_edits == edit_count:
            return False
        payload = encode_board(board)
        self._put(sid, snap_name(step), payload, ns=ns)
        manifest = {
            "sid": sid,
            "rule": rule,
            "steps_total": int(steps_total),
            "seed": seed,
            "temperature": temperature,
            "timeout_s": timeout_s,
            "trace_id": trace_id,
            "height": int(board.shape[0]),
            "width": int(board.shape[1]),
        }
        # steered-session keys only when set (byte-stable otherwise)
        if edits:
            manifest["edits"] = edits
        if scheduled_edits:
            manifest["scheduled_edits"] = scheduled_edits
        if stream_seq:
            manifest["stream_seq"] = int(stream_seq)
        self._put(sid, MANIFEST, json.dumps(manifest).encode(), ns=ns)
        with self._lock:
            self._edit_counts[sid] = edit_count
        if not written or written[-1] != step:
            written.append(step)
        # retention mirrors the local store (newest KEEP_SNAPSHOTS);
        # a failed prune is a leak, not a durability loss — best-effort
        while len(written) > KEEP_SNAPSHOTS:
            stale = written.pop(0)
            try:
                self._request(
                    "DELETE", self._url(sid, snap_name(stale), ns=ns), retry=False
                )
            except OSError:
                log.debug("spill: prune of %s step %d failed", sid, stale)
        return True

    def mark_disabled(self, sid: str) -> None:
        with self._lock:
            ns = self._namespace
            self._written.pop(sid, None)
            self._edit_counts.pop(sid, None)
        try:
            # drop the stale snapshots first (bytes we can no longer keep
            # fresh must not masquerade as a recovery point), then publish
            # the marker — both against the ONE captured namespace (a
            # Registrar re-grant between the two requests must not split
            # the disable across incarnations); on a store this
            # unreachable both may fail, which degrades the post-death
            # reason to never_snapshotted — still a truthful 410
            self._request("DELETE", self._url(sid, ns=ns), retry=False)
            body = json.dumps({"sid": sid, "reason": "spill_error"}).encode()
            self._put(sid, DISABLED, body, ns=ns)
        except OSError:
            log.warning("spill: could not publish remote disabled marker for %s", sid)

    def delete(self, sid: str) -> None:
        with self._lock:
            known = self._written.pop(sid, None) is not None
            self._edit_counts.pop(sid, None)
        if not known:
            return
        try:
            self._request("DELETE", self._url(sid), retry=False)
        except OSError:
            log.warning("spill: could not delete remote spill of %s", sid)

    def spilled_count(self) -> int:
        with self._lock:
            return len(self._written)

    def spilled_sids(self) -> list[str]:
        with self._lock:
            return list(self._written)


# ---------------------------------------------------------------------------
# the migration tier's read path
# ---------------------------------------------------------------------------
def _fetch(url: str, timeout_s: float) -> tuple[int, dict, bytes]:
    req = urllib.request.Request(url)
    try:
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()
    except http.client.HTTPException as e:
        # a body torn mid-read is an OSError to callers: the snapshot
        # fetch demotes, the listing read surfaces as a migration retry
        raise OSError(f"mid-exchange failure fetching {url}: {e}") from None


def read_remote_sessions(
    base_url: str, namespace: str, *, timeout_s: float = 10.0
) -> tuple[list[SpillRecord], list[str], list[str]]:
    """Read every resumable session in a dead worker's remote namespace —
    the wire twin of ``read_spill_sessions`` with identical triage:
    ``(records, corrupt_sids, disabled_sids)``, demoting a snapshot whose
    downloaded bytes fail the CRC/shape check to its predecessor.  A
    listing failure raises OSError (the migration run records nothing and
    leaves the bytes for a retry — never deletes what nobody decoded)."""
    base = base_url.rstrip("/")
    status, _, raw = _fetch(f"{base}{ROUTE_SPILL}/{namespace}", timeout_s)
    if status != 200:
        raise OSError(f"spill store listing {namespace}: {status}")
    try:
        listing = json.loads(raw)["sids"]
    except (json.JSONDecodeError, KeyError, TypeError) as e:
        raise OSError(f"spill store listing {namespace} unreadable: {e}") from None
    records: list[SpillRecord] = []
    corrupt: list[str] = []
    disabled: list[str] = []
    for sid in sorted(listing):
        info = listing[sid] or {}
        if info.get("disabled"):
            disabled.append(sid)
            continue
        try:
            st, _, mraw = _fetch(
                f"{base}{ROUTE_SPILL}/{namespace}/{sid}/{MANIFEST}", timeout_s
            )
            if st != 200:
                raise ValueError(f"manifest {st}")
            meta = json.loads(mraw)
            height = int(meta["height"])
            width = int(meta["width"])
            steps_total = int(meta["steps_total"])
            rule = str(meta["rule"])
        except (OSError, ValueError, KeyError, TypeError):
            log.warning("spill: remote %s/%s has no readable manifest", namespace, sid)
            corrupt.append(sid)
            continue
        chosen = None
        for step in sorted((int(s) for s in info.get("snaps", [])), reverse=True):
            board = _fetch_snapshot(
                f"{base}{ROUTE_SPILL}/{namespace}/{sid}/{snap_name(step)}",
                height,
                width,
                timeout_s,
            )
            if board is not None:
                chosen = (step, board)
                break
            log.warning(
                "spill: remote %s/%s snap %d failed the intact check; demoting",
                namespace,
                sid,
                step,
            )
        if chosen is None:
            corrupt.append(sid)
            continue
        step, board = chosen
        seed = meta.get("seed")
        temperature = meta.get("temperature")
        t_s = meta.get("timeout_s")
        trace_id = meta.get("trace_id")
        records.append(
            SpillRecord(
                sid=sid,
                rule=rule,
                board=board,
                step=step,
                steps_total=steps_total,
                seed=None if seed is None else int(seed),
                temperature=None if temperature is None else float(temperature),
                timeout_s=None if t_s is None else float(t_s),
                height=height,
                width=width,
                trace_id=None if trace_id is None else str(trace_id),
                edits=meta.get("edits"),
                scheduled_edits=meta.get("scheduled_edits"),
                stream_seq=int(meta.get("stream_seq", 0)),
            )
        )
    return records, corrupt, disabled


def _fetch_snapshot(
    url: str, height: int, width: int, timeout_s: float
) -> np.ndarray | None:
    """Download + verify one snapshot; None on ANY shortfall (HTTP error,
    torn body, CRC mismatch, bad decode) — the caller demotes."""
    try:
        status, headers, body = _fetch(url, timeout_s)
    except OSError:
        return None
    if status != 200:
        return None
    d = chaos.decide("spill.remote.torn_body")
    if d is not None:
        chaos.record_fire("spill.remote.torn_body", d.fault.mode)
        body = body[: max(1, len(body) // 2)]
    claimed = headers.get("X-CRC32")
    try:
        if claimed is None or int(claimed) != (zlib.crc32(body) & 0xFFFFFFFF):
            return None
    except ValueError:
        return None  # a garbled witness is a shortfall, not an abort
    try:
        return decode_board(body, height, width)
    except (ValueError, TypeError):
        return None


def delete_remote_namespace(
    base_url: str, namespace: str, *, timeout_s: float = 10.0
) -> None:
    """Best-effort post-rescue reap of a dead incarnation's namespace."""
    base = base_url.rstrip("/")
    try:
        req = urllib.request.Request(
            f"{base}{ROUTE_SPILL}/{namespace}", method="DELETE"
        )
        with urllib.request.urlopen(req, timeout=timeout_s):
            pass
    except (urllib.error.URLError, ConnectionError, socket.timeout, TimeoutError, OSError):
        log.warning("spill: could not reap remote namespace %s", namespace)


def list_remote_namespaces(
    base_url: str, *, timeout_s: float = 10.0
) -> list[str]:
    """All namespaces in the store (the control plane's orphan sweep)."""
    base = base_url.rstrip("/")
    status, _, raw = _fetch(f"{base}{ROUTE_SPILL}", timeout_s)
    if status != 200:
        raise OSError(f"spill store namespace listing: {status}")
    try:
        return list(json.loads(raw)["namespaces"])
    except (json.JSONDecodeError, KeyError, TypeError) as e:
        raise OSError(f"spill store namespace listing unreadable: {e}") from None
