"""The ``sharded`` backend: a board split in row stripes over a 1-D mesh.

The counterpart of ``tpu_life/backends/sharded_backend.py``'s
``ShardedBackend`` (``_use_bits``, ``_resolve_local_kernel``,
``_blocked_runner``, ``_prepare_torus``, ``_prepare_impl``) on a
``parallel.mesh.Mesh``: shard i is its own tensor on mesh device i, and a
block of k steps is one halo exchange (``parallel.halo.exchange_rows``)
and one step of every shard.  An advance of n steps is ``n // k`` blocks
and one remainder block.  ``prepare`` routes in the JAX backend's order
and names the route in the runner (``runner.route``):

- ``k3``: clamped life-like rules, through kernel K3
  (``kernels.sharded_stripe``) on the packed words;
- ``k3_diamond``: clamped 2-state von Neumann rules of radius <= 2,
  through K3's diamond mode, the depth clamped to ``32 // r``;
- ``k3_torus``: life-like ``:T`` rules through K3's torus mode, on a
  closed ring; the board height must divide by the mesh size;
- ``shard_ops``: the plain per-shard ops (``parallel.halo``), for every
  rule when ``local_kernel='torch'``, and for the rules the JAX backend
  gives to its XLA scan under ``auto``: torus rules that are not
  life-like, and clamped von Neumann rules the diamond does not take.

The clamped rules the JAX backend gives to its sharded int8 kernel —
Generations, Larger-than-Life and ``bitpack=False`` — need kernel K4,
which is not ported yet: under ``auto`` and ``cuda`` they raise
``NotPortedError`` (ROADMAP B4); only ``local_kernel='torch'`` runs them.

Geometry is the GPU's own: shards of ``ceil(h / n)`` rows (the padding
rows of the last shard are pinned dead), unpadded ``pack_np`` words,
halos of ``r * k`` rows, and k the backend's default of 8 (as the ``cuda``
backend's), clamped so a halo fits in a shard (``r * k <= shard rows``)
and, for the kernel, so its one-word sideways halo covers the reach
(``r * k <= 32``).

``mesh`` is the shard devices in order.  Without one, ``device`` (say
``cpu`` or ``cuda:0``) puts ``num_devices`` shards on that one device,
and with neither every shard gets a card of its own.  On CUDA tensors K3
launches; on CPU tensors its wrapper runs the plain version, which is how
the CPU tests reach every route.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_life_torch.backends.base import (
    ChunkCallback,
    register_backend,
    resolve_device,
    run_with_runner,
)
from tpu_life_torch.backends.cuda_backend import DEFAULT_BLOCK_STEPS
from tpu_life_torch.backends.torch_backend import ShardedRunner, from_words
from tpu_life_torch.kernels import sharded_stripe
from tpu_life_torch.kernels.packed_stripe import MAX_BLOCK_STEPS, clamp_block_steps
from tpu_life_torch.models.rules import NotPortedError, Rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.ops.stencil import live_count_cells
from tpu_life_torch.parallel import halo
from tpu_life_torch.parallel.mesh import ROW_AXIS, Mesh, make_mesh, shard_height, split_rows

LOCAL_KERNELS = ("auto", "torch", "cuda")


@register_backend("sharded")
class ShardedBackend:
    name = "sharded"

    def __init__(
        self,
        *,
        num_devices: int | None = None,
        mesh: Mesh | None = None,
        device=None,
        block_steps: int | None = None,
        bitpack: bool = True,
        local_kernel: str = "auto",
        mesh_shape: tuple[int, int] | None = None,
        partition_mode: str = "shard_map",
        stencil: str = "roll",
        **_,
    ):
        if mesh_shape is not None:
            rows, cols = mesh_shape
            if cols > 1:
                raise NotPortedError(
                    f"the 2-D mesh_shape {tuple(mesh_shape)} is not yet ported to "
                    f"tpu_life_torch (ROADMAP A6: K4 on 1-D and 2-D meshes with "
                    f"make_mesh_2d); use a 1-D row mesh"
                )
            if num_devices is not None and num_devices != rows:
                raise ValueError(
                    f"mesh_shape {tuple(mesh_shape)} contradicts num_devices={num_devices}"
                )
            num_devices = rows
        if partition_mode == "gspmd":
            raise NotPortedError(
                "partition_mode='gspmd' is not yet ported to tpu_life_torch "
                "(ROADMAP A6: gspmd); the halo exchange is explicit"
            )
        if partition_mode != "shard_map":
            raise ValueError(f"unknown partition_mode {partition_mode!r}")
        if stencil != "roll":
            raise NotPortedError(
                f"stencil {stencil!r} is not yet ported to tpu_life_torch (ROADMAP "
                f"A7: matmul counting); only 'roll' (the shift-add count) runs here"
            )
        if local_kernel not in LOCAL_KERNELS:
            raise ValueError(f"local_kernel must be one of {LOCAL_KERNELS}, got {local_kernel!r}")
        self.local_kernel = local_kernel
        self.bitpack = bitpack
        self.block_steps = DEFAULT_BLOCK_STEPS if block_steps is None else block_steps
        if not 1 <= self.block_steps <= MAX_BLOCK_STEPS:
            raise ValueError(
                f"block_steps must be in [1, {MAX_BLOCK_STEPS}], got {self.block_steps}"
            )
        if mesh is not None:
            if num_devices is not None and num_devices != mesh.size:
                raise ValueError(f"a mesh of {mesh.size} contradicts num_devices={num_devices}")
            self.mesh = mesh
        elif device is not None:
            dev = resolve_device(device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            self.mesh = make_mesh(devices=[dev] * (num_devices or 1))
        else:
            resolve_device(None)  # no card: the same tidy error as every backend
            self.mesh = make_mesh(num_devices)
        self.n = self.mesh.shape[ROW_AXIS]

    def route(self, rule: Rule) -> str:
        """The per-shard executor of ``rule``, in the JAX backend's order;
        raises for the rules and options this slice does not run."""
        kernel = self.local_kernel != "torch"
        if rule.boundary == "torus":
            if self.bitpack and bitlife.supports_torus(rule):
                return "k3_torus" if kernel else "shard_ops"
            if self.local_kernel == "cuda":
                raise ValueError(
                    "local_kernel='cuda' on a torus needs the packed bitboard (a "
                    "life-like rule with bitpack); use local_kernel='torch'"
                )
            return "shard_ops"
        if not kernel:
            return "shard_ops"
        if self.bitpack and bitlife.supports(rule):
            return "k3"
        if self.bitpack and bitlife.supports_diamond(rule):
            return "k3_diamond"
        if rule.neighborhood == "moore":
            raise NotPortedError(
                f"rule {rule.name!r} with local_kernel={self.local_kernel!r} needs the "
                f"sharded int8 kernel K4, which is not yet ported to tpu_life_torch "
                f"(ROADMAP B4); local_kernel='torch' runs it by plain ops"
            )
        if self.local_kernel == "cuda":
            raise ValueError(
                "the sharded int8 kernel counts Moore boxes only; von Neumann rules "
                "the diamond does not take need local_kernel='torch'"
            )
        return "shard_ops"

    def _use_bits(self, rule: Rule) -> bool:
        """Whether the shards hold packed words: the rules with a
        bit-sliced step, unless ``bitpack`` is off."""
        if rule.boundary == "torus":
            return self.bitpack and bitlife.supports_torus(rule)
        return self.bitpack and (bitlife.supports(rule) or bitlife.supports_diamond(rule))

    def prepare(self, board: np.ndarray, rule: Rule) -> ShardedRunner:
        h, w = board.shape
        route = self.route(rule)
        torus = rule.boundary == "torus"
        if torus and h % self.n:
            raise ValueError(
                f"torus boundary needs the board height ({h}) divisible by the mesh "
                f"size ({self.n}) so no padding rows sit inside the glued seam"
            )
        sh = shard_height(h, self.n)
        k = min(self.block_steps, sh // rule.radius)
        if route != "shard_ops":
            k = clamp_block_steps(rule, k)
        if k < 1:
            raise ValueError(
                f"shards of {sh} rows are shallower than the radius {rule.radius} "
                f"of rule {rule.name!r}; use fewer devices"
            )
        packed = self._use_bits(rule)
        if packed:
            host = bitlife.pack_np(np.asarray(board, np.int8)).view(np.int32)
            to_np = lambda x: from_words(x, w)  # noqa: E731
            count_live = bitlife.live_count_packed
        else:
            host = np.asarray(board, np.int8)
            to_np = lambda x: x.cpu().numpy()  # noqa: E731
            count_live = live_count_cells
        chunks = [
            torch.from_numpy(part).to(dev, copy=True)
            for part, dev in zip(split_rows(host, self.n), self.mesh.devices)
        ]
        make_run = (
            self._shard_ops_run(rule, (h, w), packed, torus)
            if route == "shard_ops"
            else self._k3_run(rule, (h, w), chunks)
        )
        runs: dict[int, object] = {}

        def advance(chunks, n_steps: int):
            num_blocks, rem = divmod(n_steps, k)
            for depth, count in ((k, num_blocks), (rem, 1)):
                if depth and count:
                    if depth not in runs:
                        runs[depth] = make_run(depth)
                    chunks = runs[depth](chunks, count)
            return chunks

        return ShardedRunner(chunks, advance, to_np, count_live, route, h)

    def _shard_ops_run(self, rule, logical, packed: bool, torus: bool):
        make = halo.make_sharded_run_torus if torus else halo.make_sharded_run
        return lambda depth: make(rule, self.mesh, logical, block_steps=depth, packed=packed)

    def _k3_run(self, rule, logical, chunks):
        """Runs of kernel K3 blocks: each shard ping-pongs two buffers
        (the plain version on the CPU allocates its own results)."""
        spares = [torch.empty_like(c) if c.is_cuda else None for c in chunks]
        periodic = rule.boundary == "torus"

        def make_run(depth: int):
            fr = halo.halo_depth(rule, depth)
            buffers = halo.halo_buffers(chunks, fr)

            def block(i, top, chunk, bot, row0):
                out = sharded_stripe.sharded_stripe_block(
                    top, chunk, bot, row0, rule, logical, depth, out=spares[i]
                )
                if spares[i] is not None:
                    spares[i] = chunk
                return out

            return lambda chunks, count: halo.run_blocks(
                chunks, count, fr, block, periodic=periodic, buffers=buffers
            )

        return make_run

    def run(
        self,
        board: np.ndarray,
        rule: Rule,
        steps: int,
        *,
        chunk_steps: int = 0,
        callback: ChunkCallback | None = None,
    ) -> np.ndarray:
        return run_with_runner(
            self, board, rule, steps, chunk_steps=chunk_steps, callback=callback
        )
