"""The benchmark's inputs, made from ``--seed``: random boards of a stated
density, drawn on the device with a ``torch.Generator`` in a few large
calls.  The same seed on the same kind of device gives the same boards, and
both the program and the reference are handed them."""

from __future__ import annotations

import numpy as np
import torch

#: boards drawn in one call, so that the float draws stay under ~1 GiB
_BLOCK_CELLS = 1 << 28


def generator(seed: int, device: torch.device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed`` (any whole number) and an
    input ``stream`` of the run, so that two kinds of input never share
    draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def boards(seed: int, count: int, height: int, width: int, density: float,
           device: torch.device, stream: int = 0) -> torch.Tensor:
    """int8 [count, height, width] of cells alive with probability
    ``density``, on ``device``."""
    g = generator(seed, device, stream)
    out = torch.empty((count, height, width), dtype=torch.int8, device=device)
    per_call = max(1, _BLOCK_CELLS // (height * width))
    for i in range(0, count, per_call):
        n = min(per_call, count - i)
        draws = torch.rand((n, height, width), generator=g, device=device)
        out[i:i + n] = (draws < density).to(torch.int8)
    return out


def host_boards(seed: int, count: int, height: int, width: int, density: float,
                device: torch.device, stream: int = 0) -> list[np.ndarray]:
    """:func:`boards` copied to the host, one int8 array a board."""
    batch = boards(seed, count, height, width, density, device, stream).cpu().numpy()
    return list(batch)
