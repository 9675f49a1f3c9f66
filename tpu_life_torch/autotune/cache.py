"""The persistent tuning DB: one JSON file of TuneKey -> TunedConfig
(``tpu_life/autotune/cache.py``, with the same schema).

The store is a single JSON file so it is inspectable, diffable, and
shippable:

- **location**: the port's own file, ``~/.cache/tpu_life_torch/autotune.json``
  (respects ``XDG_CACHE_HOME``), overridable via
  ``TPU_LIFE_TORCH_AUTOTUNE_CACHE`` — tests point it at a tmpdir.  It is
  never the JAX package's file: the two packages' CPU keys have equal ids
  (``cpux1|conway|…``) while their backend names differ (``torch``
  against ``jax``), so a shared file would hand one package the other's
  pick;
- **atomic writes**: serialize to a sibling temp file, ``os.replace`` into
  place — a reader never sees a torn file, a crashed writer leaves the old
  contents intact;
- **schema versioning**: the file carries ``schema``; a mismatch (older or
  newer writer) invalidates the whole file — tuned numbers measured under
  different key/config semantics must not leak forward.  Individually
  malformed entries are dropped on read for the same reason.

Corrupt or unreadable files degrade to an empty cache (the cost model
covers the miss); the cache is an accelerator, never a failure source.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from pathlib import Path

try:
    import fcntl
except ImportError:  # non-POSIX: degrade to best-effort (no lock)
    fcntl = None

from tpu_life_torch.autotune.space import TuneKey, TunedConfig

SCHEMA_VERSION = 1
ENV_VAR = "TPU_LIFE_TORCH_AUTOTUNE_CACHE"


def cache_path(path: str | os.PathLike | None = None) -> Path:
    """Resolve the cache file path: explicit arg > env var > XDG default."""
    if path is not None:
        return Path(path)
    env = os.environ.get(ENV_VAR)
    if env:
        return Path(env)
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return Path(base) / "tpu_life_torch" / "autotune.json"


def load(path: str | os.PathLike | None = None) -> dict:
    """The cache's entry dict (``key.id() -> entry``); {} on any problem.

    A wrong ``schema`` discards the file wholesale; an entry that does not
    round-trip through :class:`TunedConfig` is dropped individually.
    """
    p = cache_path(path)
    try:
        raw = json.loads(p.read_text())
    except (OSError, ValueError):
        return {}
    if not isinstance(raw, dict) or raw.get("schema") != SCHEMA_VERSION:
        return {}
    entries = raw.get("entries")
    if not isinstance(entries, dict):
        return {}
    good: dict = {}
    for kid, entry in entries.items():
        try:
            TunedConfig.from_dict(entry["config"])  # validates shape
            good[kid] = entry
        except (KeyError, TypeError, ValueError):
            continue  # stale/malformed entry: invalidated, not fatal
    return good


@contextlib.contextmanager
def _locked(path: str | os.PathLike | None):
    """Advisory exclusive lock (a ``.lock`` sibling) serializing the
    read-modify-write cycles of :func:`put` / :func:`invalidate`: the
    atomic replace prevents *torn* files but not *lost updates* — two
    concurrent tuners would otherwise each publish a full file holding
    only their own view, and the last writer silently drops the first
    writer's freshly measured entry.  Degrades to best-effort where
    locking is unavailable (non-POSIX, odd filesystems)."""
    p = cache_path(path)
    if fcntl is None:
        yield
        return
    try:
        p.parent.mkdir(parents=True, exist_ok=True)
        f = open(p.with_name(p.name + ".lock"), "w")
    except OSError:
        yield
        return
    try:
        with contextlib.suppress(OSError):
            fcntl.flock(f, fcntl.LOCK_EX)
        yield
    finally:
        f.close()  # releases the flock


def _write(entries: dict, path: str | os.PathLike | None = None) -> Path:
    """Atomically replace the cache file with ``entries``."""
    p = cache_path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    payload = json.dumps(
        {"schema": SCHEMA_VERSION, "entries": entries}, indent=1, sort_keys=True
    )
    fd, tmp = tempfile.mkstemp(
        prefix=p.name + ".", suffix=".tmp", dir=str(p.parent)
    )
    try:
        with os.fdopen(fd, "w") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return p


def get(key: TuneKey, path: str | os.PathLike | None = None) -> dict | None:
    """The cached entry for ``key``, or None on a miss."""
    return load(path).get(key.id())


def put(
    key: TuneKey,
    config: TunedConfig,
    *,
    source: str,
    seconds_per_step: float | None = None,
    trials: int | None = None,
    path: str | os.PathLike | None = None,
) -> dict:
    """Record ``config`` as the tuned decision for ``key`` (read-modify-
    write of the whole file, atomic publish); returns the entry written.

    ``source`` records provenance ("measured" / "cost_model") so a perf
    artifact resolved from this entry can say where its numbers came from.
    """
    entry = {
        "key": key.to_dict(),
        "config": config.to_dict(),
        "source": source,
        "seconds_per_step": seconds_per_step,
        "trials": trials,
        "tuned_at": time.time(),
    }
    with _locked(path):
        entries = load(path)
        entries[key.id()] = entry
        _write(entries, path)
    return entry


def invalidate(key: TuneKey | None = None, path: str | os.PathLike | None = None) -> int:
    """Drop one key's entry (or every entry when ``key`` is None);
    returns how many entries were removed."""
    with _locked(path):
        entries = load(path)
        if key is None:
            n = len(entries)
            entries = {}
        else:
            n = 1 if entries.pop(key.id(), None) is not None else 0
        _write(entries, path)
    return n
