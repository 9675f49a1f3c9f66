"""State carried between the JAX package and this one, as plain values.

The state of a run is a board and a rule.  These helpers take numpy arrays
and plain Python values only — never an object of the JAX package — so a
caller holding both packages (the tests) can hand the same state to each.
A continuous-tier board crosses as float32 numpy, a Lenia rule as its spec
string and its fields.  Files need no helper: both packages share the byte
codec, so one's ``output.txt`` is a valid input for the other.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_life_torch.backends.torch_backend import from_words
from tpu_life_torch.models.rules import Rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.parallel.mesh import split_rows


def board_from_reference(
    board: np.ndarray, logical_shape: tuple[int, int], layout: str = "words"
) -> torch.Tensor:
    """A JAX-package board — packed ``uint32[H, ceil(W/32)]`` words (the
    ``pack_np`` layout) or ``int8[H, W]`` states — as a CPU tensor of this
    package, in one of its two layouts:

    - ``"words"``: int32 words, the layout of kernel K1.  Only states 0
      and 1 pack into words, so an int8 board holding any other state
      raises ``ValueError`` instead of losing it;
    - ``"cells"``: the int8[H, W] board whole, the layout of kernel K2.

    A float32 board (the continuous tier) crosses whole, as float32 cells.
    """
    h, w = logical_shape
    board = np.asarray(board)
    if layout not in ("words", "cells"):
        raise ValueError(f"layout must be 'words' or 'cells', got {layout!r}")
    if board.dtype == np.float32:
        if layout != "cells" or board.shape != (h, w):
            raise ValueError(
                f"a float32 board of shape {board.shape} crosses as cells of shape {(h, w)}"
            )
        return torch.from_numpy(board.copy())
    if board.dtype == np.uint32:
        want = (h, bitlife.packed_width(w))
        if board.shape != want:
            raise ValueError(f"packed board has shape {board.shape}, want {want}")
        if layout == "cells":
            return torch.from_numpy(bitlife.unpack_np(board, w))
        words = np.ascontiguousarray(board)
    elif board.dtype == np.int8:
        if board.shape != (h, w):
            raise ValueError(f"board has shape {board.shape}, want {(h, w)}")
        if layout == "cells":
            return torch.from_numpy(board.copy())
        if board.size and (board.min() < 0 or board.max() > 1):
            raise ValueError(
                "an int8 board with states other than 0 and 1 does not pack into "
                "words (only state 1 is a set bit); use layout='cells'"
            )
        words = bitlife.pack_np(board)
    else:
        raise TypeError(f"board must be uint32 words or int8 states, got {board.dtype}")
    return torch.from_numpy(words.view(np.int32).copy())


def board_to_reference(x: torch.Tensor, logical_shape: tuple[int, int]) -> np.ndarray:
    """This package's board (any device) — int32 words, an int8 board or a
    float32 board — as an ``int8[H, W]`` (or ``float32[H, W]``) board."""
    if x.dtype in (torch.int8, torch.float32):
        if tuple(x.shape) != tuple(logical_shape):
            raise ValueError(f"board has shape {tuple(x.shape)}, want {tuple(logical_shape)}")
        return x.cpu().numpy().copy()
    return from_words(x, logical_shape[1])


def rule_from_fields(
    name: str,
    birth,
    survive,
    states: int = 2,
    radius: int = 1,
    neighborhood: str = "moore",
    boundary: str = "clamped",
    include_center: bool = False,
    *,
    mu: float | None = None,
    sigma: float | None = None,
    dt: float | None = None,
    peaks=None,
) -> Rule:
    """A :class:`Rule` from the field values of a JAX-package rule.  A
    Lenia rule crosses as its spec string (``name``) and its fields: a
    ``lenia`` name, or any of ``mu``/``sigma``/``dt``/``peaks``, gives a
    ``LeniaRule`` whose spec's values are overridden by the fields given.
    A stochastic rule crosses the same way: an ``ising`` or ``noisy:`` name
    gives the ``IsingRule`` or ``NoisyRule`` its spec parses to, with the
    fields given."""
    low = name.lower()
    if low.split(":")[0] == "ising" or low.startswith("noisy:"):
        from dataclasses import replace

        from tpu_life_torch.models.rules import parse_rule

        return replace(
            parse_rule(name), radius=int(radius), states=int(states),
            include_center=bool(include_center), neighborhood=neighborhood, boundary=boundary,
            birth=frozenset(int(c) for c in birth), survive=frozenset(int(c) for c in survive),
        )
    lenia_fields = {k: float(v) for k, v in (("mu", mu), ("sigma", sigma), ("dt", dt))
                    if v is not None}
    if peaks is not None:
        lenia_fields["peaks"] = tuple(float(b) for b in peaks)
    spec = name.lower() == "lenia" or name.lower().startswith("lenia:")
    if lenia_fields or spec:
        from dataclasses import replace

        from tpu_life_torch.models.lenia import LeniaRule, parse_lenia

        return replace(
            parse_lenia(name) if spec else LeniaRule(), name=name, radius=int(radius),
            boundary=boundary,
            states=int(states), include_center=bool(include_center),
            neighborhood=neighborhood, birth=frozenset(int(c) for c in birth),
            survive=frozenset(int(c) for c in survive), **lenia_fields,
        )
    return Rule(
        name=name,
        birth=frozenset(int(c) for c in birth),
        survive=frozenset(int(c) for c in survive),
        radius=int(radius),
        states=int(states),
        include_center=bool(include_center),
        neighborhood=neighborhood,
        boundary=boundary,
    )


def shards_from_reference(
    board: np.ndarray, logical_shape: tuple[int, int], n: int, layout: str = "words"
) -> list[torch.Tensor]:
    """A JAX-package board as the n row chunks the ``sharded`` backend
    holds on a mesh of n shards (``parallel.mesh.split_rows``: each
    ``ceil(H / n)`` rows, the last padded with dead rows), CPU tensors in
    the layout of :func:`board_from_reference`."""
    x = board_from_reference(board, logical_shape, layout)
    return [torch.from_numpy(part) for part in split_rows(x.numpy(), n)]


def mc_state_from_reference(
    board: np.ndarray,
    step: int,
    seed: int,
    temperature: float | None,
    layout: str = "words",
    *,
    width: int | None = None,
) -> dict:
    """A stochastic run's state as the JAX package holds it — its board
    (``int8[H, W]`` cells, or packed ``uint32[H, ceil(W/32)]`` words in the
    ``pack_np`` layout, ``width`` = W), its absolute step, seed and
    temperature — as this package's tensors and plain values: ``board`` a
    CPU tensor in ``layout`` (``"words"``, the layout of kernel K6;
    ``"cells"``, the int8 roll path's), ``step`` the absolute step a Runner
    resumes at, ``keys`` the seed's key halves ``(k0, k1)`` and
    ``thresholds`` the acceptance table as int32 bit patterns (zeros without
    a temperature, as the rules that ignore it carry)."""
    from tpu_life_torch.mc.ising import acceptance_thresholds
    from tpu_life_torch.mc.prng import key_halves

    board = np.asarray(board)
    if width is None:
        width = board.shape[1] if board.dtype != np.uint32 else board.shape[1] * bitlife.WORD
    table = (
        acceptance_thresholds(temperature)
        if temperature is not None
        else np.zeros(5, dtype=np.uint32)
    )
    return {
        "board": board_from_reference(board, (board.shape[0], int(width)), layout),
        "step": int(step),
        "keys": key_halves(seed),
        "thresholds": torch.from_numpy(table.view(np.int32).copy()),
    }


#: the JAX package's autotune names -> the port's (device kind, backend,
#: local kernel); names absent here are the same in both packages
DEVICE_KIND_FROM_JAX = {"tpu": "cuda"}
BACKEND_FROM_JAX = {"jax": "torch", "pallas": "cuda"}
LOCAL_KERNEL_FROM_JAX = {"xla": "torch", "pallas": "cuda"}


def tune_dict_from_jax(d: dict, *, stochastic: bool = False) -> dict:
    """A JAX ``TuneKey.to_dict()`` or ``TunedConfig.to_dict()`` (or a cache
    entry's ``"key"`` / ``"config"``) under the port's names: device kind
    ``tpu`` -> ``cuda``; backend ``jax`` -> ``torch``, ``pallas`` ->
    ``cuda``; local kernel ``xla`` -> ``torch``, ``pallas`` -> ``cuda``.
    A config of a stochastic key (``stochastic=True``) maps ``jax`` to
    ``cuda``, the port's executor of the key schedule (kernels K6 and K7).
    Every other field crosses unchanged, so ``TuneKey(**out)`` (with the
    shape bucket as a tuple) or ``TunedConfig.from_dict(out)`` rebuilds
    the port's value."""
    out = dict(d)
    if "device_kind" in out:
        out["device_kind"] = DEVICE_KIND_FROM_JAX.get(out["device_kind"], out["device_kind"])
    if "backend" in out:
        if stochastic and out["backend"] == "jax":
            out["backend"] = "cuda"
        else:
            out["backend"] = BACKEND_FROM_JAX.get(out["backend"], out["backend"])
    if "local_kernel" in out:
        out["local_kernel"] = LOCAL_KERNEL_FROM_JAX.get(out["local_kernel"], out["local_kernel"])
    return out
