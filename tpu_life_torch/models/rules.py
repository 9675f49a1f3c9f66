"""Rules as data: the deterministic rule space of the JAX package.

A trimmed copy of ``tpu_life/models/rules.py``: the :class:`Rule` value,
its lookup tables, the spec parser and the registry of named rules, with
the same fields and the same parse results.  Life-like (``B3/S23``),
Generations (``B2/S/C3``), Larger-than-Life (``R5,C2,S34..58,B34..45``),
von Neumann (``NN``) and board-sized torus (``:T``) specs all parse.

Continuous (Lenia) specs parse into ``models.lenia.LeniaRule``.  The
stochastic tier (``ising``, ``noisy:<p>/<base>``) is not ported yet: its
specs raise a ``ValueError`` that says so, instead of parsing into a rule
nothing here can run.

Semantics (synchronous update; boundary per ``Rule.boundary``):

- ``count`` = number of *alive* (state == 1) cells in the rule's
  neighborhood (center excluded unless ``include_center``).
- dead (0):  -> 1 if ``count in birth`` else 0
- alive (1): -> 1 if ``count in survive`` else (2 if states > 2 else 0)
- dying (s >= 2, Generations only): -> s + 1, wrapping to 0 at ``states``
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np


@dataclass(frozen=True)
class Rule:
    name: str
    birth: frozenset = field(default_factory=frozenset)
    survive: frozenset = field(default_factory=frozenset)
    radius: int = 1
    states: int = 2
    include_center: bool = False  # LtL "M1" variants count the center cell
    # "moore" = the (2r+1)^2 box, "von_neumann" = the |dx|+|dy| <= r diamond
    neighborhood: str = "moore"
    # "clamped" = dead edges; "torus" = board-sized periodic wraparound
    boundary: str = "clamped"

    def __post_init__(self):
        if self.radius < 1:
            raise ValueError(f"radius must be >= 1, got {self.radius}")
        if not (2 <= self.states <= 10):
            # 10-state ceiling keeps the disk codec single-digit ('0'..'9').
            raise ValueError(f"states must be in [2, 10], got {self.states}")
        if self.neighborhood not in ("moore", "von_neumann"):
            raise ValueError(
                f"neighborhood must be 'moore' or 'von_neumann', "
                f"got {self.neighborhood!r}"
            )
        if self.boundary not in ("clamped", "torus"):
            raise ValueError(
                f"boundary must be 'clamped' or 'torus', got {self.boundary!r}"
            )
        mc = self.max_count
        for s in self.birth | self.survive:
            if not (0 <= s <= mc):
                raise ValueError(f"count {s} out of range [0, {mc}] for radius {self.radius}")

    @property
    def max_count(self) -> int:
        r = self.radius
        if self.neighborhood == "von_neumann":
            size = 2 * r * (r + 1) + 1  # the diamond, center included
        else:
            size = (2 * r + 1) ** 2
        return size - (0 if self.include_center else 1)

    @cached_property
    def tables(self) -> tuple[np.ndarray, np.ndarray]:
        """(birth_table, survive_table): int8[max_count + 1] 0/1 masks."""
        n = self.max_count + 1
        birth = np.zeros(n, dtype=np.int8)
        survive = np.zeros(n, dtype=np.int8)
        birth[sorted(self.birth)] = 1
        survive[sorted(self.survive)] = 1
        return birth, survive

    @cached_property
    def transition_table(self) -> np.ndarray:
        """Full LUT: int8[states, max_count + 1] -> next state.

        Row s, column c = next state of a cell in state s with c live
        neighbors.
        """
        birth, survive = self.tables
        n = self.max_count + 1
        t = np.zeros((self.states, n), dtype=np.int8)
        t[0] = birth  # dead -> birth mask
        if self.states == 2:
            t[1] = survive
        else:
            t[1] = np.where(survive == 1, 1, 2).astype(np.int8)
            for s in range(2, self.states):
                t[s] = (s + 1) % self.states
        return t

    @property
    def stochastic(self) -> bool:
        """True for Monte-Carlo rules; none is ported yet."""
        return False

    @property
    def continuous(self) -> bool:
        """True for continuous-state rules (``models.lenia``): float32
        boards in [0, 1], a weighted kernel and an Euler update instead of
        a transition table.  They run only on executors with a float path
        (torch / numpy / sharded)."""
        return False

    @property
    def board_dtype(self) -> str:
        """The board element dtype this rule steps: "int8" for every
        discrete rule, "float32" on the continuous tier."""
        return "float32" if self.continuous else "int8"

    def __str__(self) -> str:
        return self.name


class NotPortedError(ValueError):
    """A rule spec of a tier this package does not run yet (the stochastic
    ``ising`` / ``noisy:``), or an option of the sharded backend whose port
    is still queued; the message names the ROADMAP item."""


class GeometryError(ValueError):
    """A rule whose kernel cannot fit the board it was submitted with."""


def validate_rule_geometry(rule: Rule, shape: tuple[int, int]) -> None:
    """Reject a kernel larger than the board: ``2r + 1 > min(h, w)``.

    Radius-1 rules are exempt — thin boards (1xN stripes, 2x2 toys) are
    legal inputs with well-defined semantics.
    """
    r = int(rule.radius)
    if r <= 1:
        return
    h, w = int(shape[0]), int(shape[1])
    if 2 * r + 1 > min(h, w):
        raise GeometryError(
            f"rule {rule.name!r} has kernel diameter {2 * r + 1} "
            f"(radius {r}) but the board is only {h}x{w}; the kernel "
            f"must fit the board (2r+1 <= min(h, w)) — shrink the "
            f"radius or grow the board"
        )


def _expand_ranges(spec: str) -> frozenset:
    """Expand '34..58' / '2,3,5..7' style count specs into a set of ints."""
    out = set()
    if not spec:
        return frozenset(out)
    for part in spec.split(","):
        if ".." in part:
            lo, hi = part.split("..")
            out.update(range(int(lo), int(hi) + 1))
        elif part:
            out.add(int(part))
    return frozenset(out)


_BS_RE = re.compile(r"^B(?P<b>\d*)/S(?P<s>\d*)(?:/C(?P<c>\d+))?$", re.IGNORECASE)
_SB_RE = re.compile(r"^(?P<s>\d*)/(?P<b>\d*)(?:/(?P<c>\d+))?$")


def parse_rule(spec: str) -> Rule:
    """Parse a rule string into a :class:`Rule`.

    Accepted formats:
    - named rules from the registry: ``conway``, ``highlife``, ...
    - B/S (optionally Generations): ``B3/S23``, ``B36/S23``, ``B2/S/C3``
    - S/B classic: ``23/3``, ``345/2/4``
    - Larger-than-Life (Golly-style): ``R5,C2,M0,S34..58,B34..45[,NM|NN]``
    - any of the above + Golly's bounded-grid suffix ``:T`` for a
      board-sized torus: ``conway:T``, ``B3/S23:T``
    - continuous rules (``models.lenia``): ``lenia`` / ``lenia:<preset>`` /
      parametric ``lenia:R<r>,m<mu>,s<sigma>[,dt<dt>][,b<a1;a2;...>]``
    """
    spec = spec.strip()
    low = spec.lower()
    if low.startswith("noisy:") or low.split(":")[0] == "ising":
        raise NotPortedError(
            f"rule {spec!r} is not yet ported to tpu_life_torch: the "
            f"stochastic tier (ising, noisy:) is queued in ROADMAP.md (A8; "
            f"use `python -m tpu_life` for it)"
        )
    if low == "lenia" or low.startswith("lenia:"):
        # the continuous tier: lenia presets and the parametric spec own
        # their colon grammar
        from tpu_life_torch.models.lenia import parse_lenia

        return parse_lenia(spec)
    m_t = re.search(r":\s*[tT](.*)$", spec)
    if m_t is not None:
        dims = m_t.group(1).strip()
        if dims:
            raise ValueError(
                f"bounded-grid dimensions {dims!r} are unsupported: the "
                f"torus is board-sized (use plain ':T')"
            )
        base = parse_rule(spec[: m_t.start()])
        return dataclasses.replace(
            base, name=f"{base.name}:T", boundary="torus"
        )
    key = low.replace("-", "_").replace(" ", "_")
    if key in RULE_REGISTRY:
        return RULE_REGISTRY[key]

    if spec.upper().startswith("R") and "," in spec:
        fields = {}
        for part in spec.split(","):
            part = part.strip()
            m = re.match(r"^([A-Za-z])(.*)$", part)
            if not m:
                raise ValueError(f"bad LtL field {part!r} in rule {spec!r}")
            k, v = m.group(1).upper(), m.group(2)
            if k in ("S", "B"):
                fields[k] = fields.get(k, "") + ("," if k in fields else "") + v
            else:
                fields[k] = v
        radius = int(fields.get("R", 1))
        states = int(fields.get("C", "2") or "2")
        states = max(states, 2)  # Golly uses C0/C1 for plain 2-state
        nb_field = fields.get("N", "M").upper()
        if nb_field in ("M", ""):
            neighborhood = "moore"
        elif nb_field == "N":
            neighborhood = "von_neumann"
        else:
            raise ValueError(
                f"unsupported neighborhood N{nb_field} in rule {spec!r} "
                f"(NM = Moore and NN = von Neumann are supported)"
            )
        return Rule(
            name=spec,
            birth=_expand_ranges(fields.get("B", "")),
            survive=_expand_ranges(fields.get("S", "")),
            radius=radius,
            states=states,
            include_center=fields.get("M", "0") == "1",
            neighborhood=neighborhood,
        )

    m = _BS_RE.match(spec) or _SB_RE.match(spec)
    if not m:
        raise ValueError(f"unrecognized rule spec {spec!r}")
    birth = frozenset(int(c) for c in m.group("b"))
    survive = frozenset(int(c) for c in m.group("s"))
    states = int(m.group("c")) if m.group("c") else 2
    return Rule(name=spec, birth=birth, survive=survive, states=states)


RULE_REGISTRY: dict[str, Rule] = {}


def register_rule(key: str, rule: Rule) -> Rule:
    RULE_REGISTRY[key] = rule
    return rule


def get_rule(name_or_spec: str) -> Rule:
    return parse_rule(name_or_spec)


# --- standard library of rules (the JAX package's deterministic entries) -------
register_rule("conway", Rule("B3/S23", frozenset({3}), frozenset({2, 3})))
register_rule("life", RULE_REGISTRY["conway"])
register_rule("highlife", Rule("B36/S23", frozenset({3, 6}), frozenset({2, 3})))
register_rule(
    "daynight",
    Rule("B3678/S34678", frozenset({3, 6, 7, 8}), frozenset({3, 4, 6, 7, 8})),
)
register_rule("day_and_night", RULE_REGISTRY["daynight"])
register_rule("seeds", Rule("B2/S", frozenset({2}), frozenset()))
register_rule(
    "life_without_death",
    Rule("B3/S012345678", frozenset({3}), frozenset(range(9))),
)
register_rule(
    "morley", Rule("B368/S245", frozenset({3, 6, 8}), frozenset({2, 4, 5}))
)
register_rule(
    "anneal", Rule("B4678/S35678", frozenset({4, 6, 7, 8}), frozenset({3, 5, 6, 7, 8}))
)
register_rule("maze", Rule("B3/S12345", frozenset({3}), frozenset({1, 2, 3, 4, 5})))
register_rule(
    "coral", Rule("B3/S45678", frozenset({3}), frozenset({4, 5, 6, 7, 8}))
)
register_rule(
    "replicator",
    Rule("B1357/S1357", frozenset({1, 3, 5, 7}), frozenset({1, 3, 5, 7})),
)
register_rule(
    "two_by_two",
    Rule("B36/S125", frozenset({3, 6}), frozenset({1, 2, 5})),
)
register_rule("diamoeba", Rule("B35678/S5678", frozenset({3, 5, 6, 7, 8}), frozenset({5, 6, 7, 8})))
register_rule(
    "brians_brain", Rule("B2/S/C3", frozenset({2}), frozenset(), states=3)
)
register_rule(
    "star_wars",
    Rule("B2/S345/C4", frozenset({2}), frozenset({3, 4, 5}), states=4),
)
register_rule(
    "bugs",
    Rule(
        "R5,C2,S34..58,B34..45",
        birth=_expand_ranges("34..45"),
        survive=_expand_ranges("34..58"),
        radius=5,
        states=2,
    ),
)
register_rule(
    "bugs_decay",
    Rule(
        "R5,C3,S34..58,B34..45",
        birth=_expand_ranges("34..45"),
        survive=_expand_ranges("34..58"),
        radius=5,
        states=3,
    ),
)
# Continuous tier: models/lenia.py registers "lenia" (parse_lenia("lenia"),
# the orbium preset) when it is imported, so `info` lists it; the parse path
# resolves the lenia: prefix before the registry.
from tpu_life_torch.models import lenia as _lenia  # noqa: E402,F401
# The reference binary's *effective* rule as shipped (B/S2; SURVEY.md §2.2)
register_rule("reference_bug_compat", Rule("B/S2", frozenset(), frozenset({2})))
