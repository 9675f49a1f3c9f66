"""Multi-tenant QoS: declarative quotas, weighted fairness, shed tiers.

Before this module every ``X-API-Key`` was one anonymous token bucket
(gateway/limits.py) — tenancy gated *rate*, never *resources* or
*ordering*.  This is the missing policy layer (docs/SERVING.md "Tenant
QoS"):

- **Identity**: an API key resolves to a :class:`TenantSpec` — a named
  tenant with a service tier (``guaranteed`` / ``best_effort``), a DRR
  weight, and quota knobs.  Unknown keys collapse into the policy's
  single ``default`` tenant, so label cardinality in the registry stays
  bounded by the policy file, not by the client population; declared
  names that are themselves long secrets are hashed by
  :func:`tenant_label` into a short stable label for the same reason.
- **Quotas** (enforced by ``SimulationService.submit`` /
  ``stream_subscribe``): ``max_sessions`` bounds a tenant's concurrent
  live sessions, ``memory_fraction`` carves the tenant a slice of the
  governor's admission budget (charged per-session at the engine
  estimate over capacity), ``max_watchers`` bounds its live stream
  watcher buffers.  Every breach is the typed
  :class:`~tpu_life_torch.serve.errors.QuotaExceeded` — HTTP 429
  ``quota_exceeded`` — rejected before anything is stored.
- **Weighted fairness**: the scheduler's admission scan orders the
  queue by deficit-round-robin over tenants
  (:meth:`QosPolicy.admission_order`) so a hog tenant flooding the
  queue cannot starve the rest of batch slots: each tenant's share of
  admissions converges to its weight, per-tenant FIFO order is
  preserved, and a policy-less scheduler keeps the exact FIFO scan.
- **Shed tiers** (gateway): under queue pressure, best-effort tenants
  are shed at ``best_effort_water`` (a fraction of the high-water mark)
  with the typed 503 ``shed_best_effort`` + Retry-After — guaranteed
  tenants only meet the classic ``overloaded`` shed at the full mark,
  so overload degrades the free tier before any paying tenant feels it.

Pure policy + arithmetic: no HTTP, no jax/numpy — importable by the
gateway, the scheduler, tests, and the surge drill alike.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

#: The two service tiers.  ``guaranteed`` tenants are shed only by the
#: classic full-fleet valves; ``best_effort`` tenants are shed first.
TIERS = ("guaranteed", "best_effort")

#: Tenant label length past which :func:`tenant_label` hashes — keeps a
#: policy that names tenants by raw API key from minting secret-bearing
#: (and unbounded-length) label values in the shared registry.
MAX_LABEL_LEN = 32

#: The reserved tenant every unknown API key resolves to.
DEFAULT_TENANT = "default"


def tenant_label(name: str) -> str:
    """The bounded registry label for a tenant name: the name itself
    when short, else ``t-<sha256[:12]>`` — stable, short, and free of
    the secret material a key-derived name could carry."""
    if len(name) <= MAX_LABEL_LEN:
        return name
    return "t-" + hashlib.sha256(name.encode()).hexdigest()[:12]


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's declared policy (all quota fields optional)."""

    name: str
    tier: str = "best_effort"
    weight: int = 1  # DRR quantum: admissions per round relative to peers
    max_sessions: int | None = None  # concurrent live sessions
    memory_fraction: float | None = None  # slice of the governor budget
    max_watchers: int | None = None  # live stream watcher buffers
    api_keys: tuple[str, ...] = ()

    def __post_init__(self):
        if self.tier not in TIERS:
            raise ValueError(
                f"tenant {self.name!r}: tier must be one of {TIERS}, "
                f"got {self.tier!r}"
            )
        if self.weight < 1:
            raise ValueError(
                f"tenant {self.name!r}: weight must be >= 1, got {self.weight}"
            )
        if self.max_sessions is not None and self.max_sessions < 1:
            raise ValueError(
                f"tenant {self.name!r}: max_sessions must be >= 1, "
                f"got {self.max_sessions}"
            )
        if self.memory_fraction is not None and not (
            0.0 < self.memory_fraction <= 1.0
        ):
            raise ValueError(
                f"tenant {self.name!r}: memory_fraction must be in (0, 1], "
                f"got {self.memory_fraction}"
            )
        if self.max_watchers is not None and self.max_watchers < 0:
            raise ValueError(
                f"tenant {self.name!r}: max_watchers must be >= 0, "
                f"got {self.max_watchers}"
            )

    @property
    def guaranteed(self) -> bool:
        return self.tier == "guaranteed"

    @property
    def label(self) -> str:
        return tenant_label(self.name)


@dataclass
class QosPolicy:
    """The declarative per-tenant policy the whole stack consults.

    Construction is strict (typed ValueError on any malformed field) so
    a bad ``--qos`` file fails the worker at startup, never at the
    first submit.
    """

    tenants: dict[str, TenantSpec] = field(default_factory=dict)
    default: TenantSpec = field(
        default_factory=lambda: TenantSpec(name=DEFAULT_TENANT)
    )
    # best-effort tenants are shed at this fraction of the gateway's
    # high-water mark (the lower rung of the shed ladder)
    best_effort_water: float = 0.5

    def __post_init__(self):
        if not 0.0 < self.best_effort_water <= 1.0:
            raise ValueError(
                f"best_effort_water must be in (0, 1], "
                f"got {self.best_effort_water}"
            )
        self._by_key: dict[str, TenantSpec] = {}
        for spec in self.tenants.values():
            for key in spec.api_keys:
                prior = self._by_key.setdefault(key, spec)
                if prior is not spec:
                    raise ValueError(
                        f"api key {key!r} claimed by both tenant "
                        f"{prior.name!r} and {spec.name!r}"
                    )

    # -- identity ----------------------------------------------------------
    def resolve(self, api_key: str | None) -> TenantSpec:
        """The tenant an API key belongs to; unknown (or absent) keys
        collapse into the single ``default`` tenant — bounded label
        cardinality by construction."""
        if api_key is not None:
            spec = self._by_key.get(api_key)
            if spec is not None:
                return spec
        return self.default

    def spec(self, name: str) -> TenantSpec:
        if name == self.default.name:
            return self.default
        return self.tenants.get(name, self.default)

    def tenant_weight(self, name: str) -> int:
        return self.spec(name).weight

    def names(self) -> list[str]:
        out = list(self.tenants)
        if self.default.name not in self.tenants:
            out.append(self.default.name)
        return out

    # -- weighted-fair admission order -------------------------------------
    def admission_order(
        self, sessions: list, cursor: int = 0
    ) -> list:
        """Deficit-round-robin interleave of ``sessions`` by tenant.

        Pure function: per-tenant FIFO order is preserved, and each DRR
        pass grants every tenant ``weight`` admissions before wrapping —
        so when slots are scarce, admissions divide by weight instead of
        by queue share.  ``cursor`` rotates which tenant a pass starts
        at, so ties don't always break the same way.  Single-tenant (or
        empty) inputs come back unchanged.
        """
        buckets: dict[str, list] = {}
        for s in sessions:
            name = getattr(s, "tenant", None) or self.default.name
            buckets.setdefault(name, []).append(s)
        if len(buckets) <= 1:
            return list(sessions)
        names = sorted(buckets)
        start = cursor % len(names)
        names = names[start:] + names[:start]
        order: list = []
        deficit = dict.fromkeys(names, 0.0)
        remaining = sum(len(b) for b in buckets.values())
        while remaining:
            for name in names:
                bucket = buckets[name]
                if not bucket:
                    deficit[name] = 0.0  # no banking while idle
                    continue
                deficit[name] += self.tenant_weight(name)
                while bucket and deficit[name] >= 1.0:
                    order.append(bucket.pop(0))
                    deficit[name] -= 1.0
                    remaining -= 1
        return order

    # -- construction -------------------------------------------------------
    @classmethod
    def from_dict(cls, doc: dict) -> "QosPolicy":
        """Build from the declarative document shape::

            {"tenants": [{"name": ..., "tier": ..., "weight": ...,
                          "api_keys": [...], "max_sessions": ...,
                          "memory_fraction": ..., "max_watchers": ...}],
             "default": {"tier": ..., ...},
             "best_effort_water": 0.5}
        """
        if not isinstance(doc, dict):
            raise ValueError("qos policy must be a JSON object")
        unknown = sorted(set(doc) - {"tenants", "default", "best_effort_water"})
        if unknown:
            raise ValueError(
                f"qos policy: unknown top-level field(s) {', '.join(unknown)}"
            )
        tenants: dict[str, TenantSpec] = {}
        rows = doc.get("tenants", [])
        if not isinstance(rows, list):
            raise ValueError("'tenants' must be a list")
        for row in rows:
            spec = _parse_spec(row)
            if spec.name in tenants:
                raise ValueError(f"duplicate tenant {spec.name!r}")
            tenants[spec.name] = spec
        default = cls.__dataclass_fields__["default"].default_factory()
        if "default" in doc:
            row = dict(doc["default"])
            row.setdefault("name", DEFAULT_TENANT)
            row.pop("api_keys", None)  # default is the unknown-key sink
            default = _parse_spec(row)
        kwargs = {}
        if "best_effort_water" in doc:
            kwargs["best_effort_water"] = float(doc["best_effort_water"])
        return cls(tenants=tenants, default=default, **kwargs)

    @classmethod
    def load(cls, path: str) -> "QosPolicy":
        """Read a policy file (JSON).  Typed ValueError on bad shape, so
        a worker with a bad ``--qos`` file dies at startup with a
        message, never silently falls back to no policy."""
        with open(path, encoding="utf-8") as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}: not valid JSON: {e}") from None
        try:
            return cls.from_dict(doc)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None


_SPEC_FIELDS = frozenset(
    ("name", "api_keys", "tier", "weight", "max_sessions",
     "memory_fraction", "max_watchers")
)


def _parse_spec(row) -> TenantSpec:
    if not isinstance(row, dict):
        raise ValueError(f"tenant row must be an object, got {row!r}")
    name = row.get("name")
    if not isinstance(name, str) or not name:
        raise ValueError(f"tenant row needs a non-empty 'name': {row!r}")
    unknown = sorted(set(row) - _SPEC_FIELDS)
    if unknown:
        # a typo'd field ("keys" for "api_keys") must not silently yield
        # a tenant nobody can reach — the load contract is die-loud
        raise ValueError(
            f"tenant {name!r}: unknown field(s) {', '.join(unknown)} "
            f"(known: {', '.join(sorted(_SPEC_FIELDS))})"
        )
    keys = row.get("api_keys", [])
    if not isinstance(keys, list) or not all(isinstance(k, str) for k in keys):
        raise ValueError(f"tenant {name!r}: 'api_keys' must be a string list")
    kwargs: dict = {"name": name, "api_keys": tuple(keys)}
    if "tier" in row:
        kwargs["tier"] = row["tier"]
    if "weight" in row:
        kwargs["weight"] = int(row["weight"])
    if row.get("max_sessions") is not None:
        kwargs["max_sessions"] = int(row["max_sessions"])
    if row.get("memory_fraction") is not None:
        kwargs["memory_fraction"] = float(row["memory_fraction"])
    if row.get("max_watchers") is not None:
        kwargs["max_watchers"] = int(row["max_watchers"])
    return TenantSpec(**kwargs)


__all__ = [
    "DEFAULT_TENANT",
    "MAX_LABEL_LEN",
    "QosPolicy",
    "TIERS",
    "TenantSpec",
    "tenant_label",
]
