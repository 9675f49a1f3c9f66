"""The ``sharded`` backend: a board split in blocks over a 1-D or 2-D mesh.

The counterpart of ``tpu_life/backends/sharded_backend.py``'s
``ShardedBackend`` (``_use_bits``, ``_resolve_local_kernel``,
``_blocked_runner``, ``_prepare_torus``, ``_prepare_torus_2d``,
``_prepare_impl``) on a ``parallel.mesh.Mesh``: shard (i, j) is its own
tensor on mesh device ``i * cols + j``, and a block of k steps is one halo
exchange (``parallel.halo.exchange_rows``, then on a mesh of columns
``exchange_cols``) and one step of every shard.  An advance of n steps is
``n // k`` blocks and one remainder block.  ``prepare`` routes in the JAX
backend's order and names the route in the runner (``runner.route``):

- ``k3``: clamped life-like rules on a 1-D row mesh, through kernel K3
  (``kernels.sharded_stripe``) on the packed words;
- ``k3_diamond``: clamped 2-state von Neumann rules of radius <= 2 on a
  1-D row mesh, through K3's diamond mode, the depth clamped to ``32 // r``;
- ``k3_torus``: life-like ``:T`` rules on a 1-D row mesh through K3's
  torus mode, on a closed ring; the board height must divide by the mesh
  size;
- ``k4``: every other clamped Moore rule — Generations, Larger-than-Life,
  and life-like rules with ``bitpack=False`` — through kernel K4
  (``kernels.sharded_int8``) on the int8 cells, on 1-D and 2-D meshes;
  under an explicit ``local_kernel='cuda'`` also the life-like rules of a
  2-D mesh, unpacked (K3 runs full-width stripes only);
- ``shard_ops``: the plain per-shard ops (``parallel.halo``), for every
  rule when ``local_kernel='torch'``, and for the rules the JAX backend
  gives to its XLA scan under ``auto``: life-like rules and diamonds on a
  2-D mesh (packed, with whole-word column halos), torus rules that are
  not life-like, clamped von Neumann rules the diamond does not take, and
  the 2-D torus (closed rings on both axes: packed where the width is a
  multiple of 32 and its words divide by the mesh's columns, int8 where
  the width divides by them; the height divides by its rows).  Continuous
  (Lenia) rules and rules whose count resolves to ``matmul`` take it too:
  on the torus the closed-ring 2-D scaffold on the float or int8 cells
  (also on a row mesh, its one column wrapping onto itself), each shard
  stepping the clamped twin of the rule by the resolved counting path
  with operators sized to its halo-extended chunk; clamped matmul rules
  the masked int8 step.

``stencil`` (``--stencil``) resolves per rule: ``auto`` follows the
crossover model (``ops.conv.resolve_stencil``) for continuous rules, and
for integer rules only under ``local_kernel='torch'``; otherwise integer
rules keep ``roll``, so a rule that has a kernel (K3, K4) keeps it.  An
explicit ``matmul`` with a ``local_kernel='cuda'`` pin raises, as the
kernels count with their own sums.  A clamped continuous rule
raises: its padding rows would need a masked float step.

Geometry is the GPU's own: clamped shards of ``ceil(h / R)`` rows and, on
a mesh of C > 1 columns, ``ceil(w / C)`` cells or ``ceil(ceil(w / 32) / C)``
words, at least a radius deep and wide (one word when packed) so each
halo comes from the next shard alone; the padding rows and columns of the
last shards are pinned dead.  Halos are ``r * k`` rows and ``r * k``
cells (``ceil(r * k / 32)`` words); k is the backend's default of 8 (as
the ``cuda`` backend's), or the ``block_steps`` asked for, clamped so a
halo fits in a shard (``r * k`` at most the shard's rows and, on a mesh
of columns, its cells) and to what the kernel takes: ``32 // r`` for K3,
K2's clamp for K4.

``mesh`` is the shard devices in order, or ``mesh_shape=(R, C)`` lays out
``R * C`` of them.  Without a mesh, ``device`` (say ``cpu`` or ``cuda:0``)
puts every shard on that one device, and with neither every shard gets a
card of its own.  On CUDA tensors K3 and K4 launch; on CPU tensors their
wrappers run the plain versions, which is how the CPU tests reach every
route.
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
from tpu_life_torch.kernels import int8_tiled, packed_stripe, sharded_int8, sharded_stripe
from tpu_life_torch.models.rules import NotPortedError, Rule
from tpu_life_torch.ops import bitlife
from tpu_life_torch.ops.conv import resolve_stencil, validate_stencil
from tpu_life_torch.ops.stencil import live_count_cells
from tpu_life_torch.parallel import halo
from tpu_life_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d, shard_extent, split_blocks

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
            mesh_shape = tuple(int(v) for v in mesh_shape)
            if len(mesh_shape) != 2 or min(mesh_shape) < 1:
                raise ValueError(f"mesh_shape must be two positive ints (R, C), got {mesh_shape}")
            rows, cols = mesh_shape
            if num_devices is not None and rows * cols != num_devices:
                raise ValueError(
                    f"mesh_shape {mesh_shape} ({rows * cols} devices) contradicts "
                    f"num_devices={num_devices}"
                )
            if mesh is not None:
                raise ValueError("pass either mesh or mesh_shape, not both")
        if partition_mode == "gspmd":
            raise NotPortedError(
                "partition_mode='gspmd' is not yet ported to tpu_life_torch "
                "(ROADMAP A6: gspmd); the halo exchange is explicit"
            )
        if partition_mode != "shard_map":
            raise ValueError(f"unknown partition_mode {partition_mode!r}")
        if local_kernel not in LOCAL_KERNELS:
            raise ValueError(f"local_kernel must be one of {LOCAL_KERNELS}, got {local_kernel!r}")
        self.stencil = validate_stencil(stencil)
        self.local_kernel = local_kernel
        self.bitpack = bitpack
        # as the JAX backend, any depth asked for runs: prepare clamps it
        self.block_steps = DEFAULT_BLOCK_STEPS if block_steps is None else max(1, block_steps)
        if mesh is not None:
            if num_devices is not None and num_devices != mesh.size:
                raise ValueError(f"a mesh of {mesh.size} contradicts num_devices={num_devices}")
            self.mesh = mesh
        else:
            devices = None
            if device is not None:
                dev = resolve_device(device)
                if dev.type == "cuda" and dev.index is None:
                    dev = torch.device("cuda", torch.cuda.current_device())
                n = mesh_shape[0] * mesh_shape[1] if mesh_shape else num_devices or 1
                devices = [dev] * n
            else:
                resolve_device(None)  # no card: the same tidy error as every backend
            if mesh_shape is not None and mesh_shape[1] > 1:
                self.mesh = make_mesh_2d(mesh_shape, devices=devices)
            else:
                self.mesh = make_mesh(mesh_shape[0] if mesh_shape else num_devices, devices=devices)
        self.n = self.mesh.n_rows
        self.n_cols = self.mesh.n_cols

    def _stencil(self, rule: Rule) -> str:
        """The rule's resolved counting path: explicit modes win, ``auto``
        follows the crossover model, except that integer rules keep
        ``roll`` unless ``local_kernel='torch'``: the kernels count with
        their own sums, and the dense bands must not take a kernel's place."""
        if (self.stencil == "auto" and self.local_kernel != "torch"
                and not getattr(rule, "continuous", False)):
            return "roll"
        return resolve_stencil(rule, self.stencil, self.name)

    def _closed_rings(self, rule: Rule) -> bool:
        """Whether a torus rule runs on the 2-D scaffold, closed rings on
        both axes: on a mesh of columns, and for continuous and matmul
        rules on any mesh (the 1-D torus's column wrap is an int8
        shift-add construction)."""
        return rule.boundary == "torus" and (
            self.n_cols > 1
            or getattr(rule, "continuous", False)
            or self._stencil(rule) == "matmul"
        )

    def route(self, rule: Rule) -> str:
        """The per-shard executor of ``rule``, in the JAX backend's order;
        raises for the options a kernel pin cannot honour."""
        kernel = self.local_kernel != "torch"
        if getattr(rule, "continuous", False):
            if rule.boundary != "torus":
                raise ValueError(
                    f"continuous rule {rule.name!r} on the sharded backend needs the "
                    f"torus boundary (exact shapes, no padding mask); the clamped float "
                    f"layout has no masked step"
                )
            if self.local_kernel == "cuda":
                raise ValueError(
                    "continuous rules run the plain float step on each shard; no "
                    "kernel has a float path (local_kernel 'auto' or 'torch')"
                )
            return "shard_ops"
        if self._stencil(rule) == "matmul":
            if self.local_kernel == "cuda":
                raise ValueError(
                    "stencil='matmul' runs the plain banded-matmul step; it cannot be "
                    "combined with local_kernel='cuda'"
                )
            return "shard_ops"
        if rule.boundary == "torus":
            if self.n_cols > 1:
                if self.local_kernel == "cuda":
                    raise ValueError(
                        "the CUDA torus kernel (K3's torus mode) runs full-width stripes "
                        "only; the torus on a 2-D mesh runs plain ops (local_kernel "
                        "'auto' or 'torch')"
                    )
                return "shard_ops"
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
        if self._use_bits(rule):
            if self.n_cols > 1:
                # K3 steps full-width stripes: under auto the packed plain
                # ops keep a 2-D mesh's life-like rules on 32x fewer bytes
                return "shard_ops"
            return "k3" if bitlife.supports(rule) else "k3_diamond"
        if rule.neighborhood == "moore":
            return "k4"
        if self.local_kernel == "cuda":
            raise ValueError(
                "the sharded int8 kernel counts Moore boxes only; von Neumann rules "
                "the diamond does not take need local_kernel='torch'"
            )
        return "shard_ops"

    def _use_bits(self, rule: Rule) -> bool:
        """Whether the shards hold packed words: the rules with a
        bit-sliced step, unless ``bitpack`` is off, a ``cuda`` pin on a
        2-D mesh asks for K4, which steps cells, or the rule is continuous
        or counts by matmul, which step cells too."""
        if getattr(rule, "continuous", False) or self._stencil(rule) == "matmul":
            return False
        if rule.boundary == "torus":
            return self.bitpack and bitlife.supports_torus(rule)
        if self.local_kernel == "cuda" and self.n_cols > 1:
            return False
        return self.bitpack and (bitlife.supports(rule) or bitlife.supports_diamond(rule))

    def _geometry(self, h: int, w: int, rule: Rule, packed: bool) -> tuple[int, int]:
        """(rows, words or cells) of every shard."""
        r, n_r, n_c = rule.radius, self.n, self.n_cols
        width = bitlife.packed_width(w) if packed else w
        if rule.boundary == "clamped":
            sh = shard_extent(h, n_r, r)
            return sh, shard_extent(width, n_c, 1 if packed else r) if n_c > 1 else width
        # the torus: exact shards, or padding would sit inside a glued seam
        if h % n_r:
            raise ValueError(
                f"torus boundary needs the board height ({h}) divisible by the mesh "
                f"size ({n_r}) so no padding rows sit inside the glued seam"
            )
        if n_c == 1:
            return h // n_r, width
        if packed and (w % bitlife.WORD or width % n_c):
            raise ValueError(
                f"2-D-mesh torus needs the width ({w}) divisible by {bitlife.WORD} and "
                f"its {width} packed words divisible by the column mesh ({n_c}): any "
                f"padding would sit inside the glued seam.  Use a 1-D (rows) mesh for "
                f"this board."
            )
        if not packed and w % n_c:
            raise ValueError(
                f"2-D-mesh torus needs the width ({w}) divisible by the column mesh "
                f"({n_c}): padding would sit inside the glued seam.  Use a 1-D (rows) "
                f"mesh for this board."
            )
        return h // n_r, width // n_c

    def prepare(self, board: np.ndarray, rule: Rule) -> ShardedRunner:
        h, w = board.shape
        route = self.route(rule)
        packed = self._use_bits(rule)
        sh, sw = self._geometry(h, w, rule, packed)
        r = rule.radius
        k = min(self.block_steps, sh // r)
        if self.n_cols > 1 or self._closed_rings(rule):
            k = min(k, sw * (bitlife.WORD if packed else 1) // r)
        if route.startswith("k3"):
            k = packed_stripe.clamp_block_steps(rule, k)
        elif route == "k4":
            k = int8_tiled.clamp_block_steps(rule, k)
        if k < 1:
            raise ValueError(
                f"torus shards of {sh} rows and {sw} {'words' if packed else 'cells'} are "
                f"smaller than the radius {r} of rule {rule.name!r}; use fewer devices"
            )
        if getattr(rule, "continuous", False):
            from tpu_life_torch.models.lenia import validate_board

            host = validate_board(board, rule)
            to_np = lambda x: x.cpu().numpy()  # noqa: E731
            count_live = lambda x: (x >= 0.5).sum()  # noqa: E731
        elif packed:
            host = bitlife.pack_np(np.asarray(board, np.int8)).view(np.int32)
            to_np = lambda x: from_words(x, w)  # noqa: E731
            count_live = bitlife.live_count_packed
        else:
            host = np.asarray(board, np.int8)
            to_np = lambda x: x.cpu().numpy()  # noqa: E731
            count_live = live_count_cells
        grid = (self.n, self.n_cols)
        chunks = [
            torch.from_numpy(part).to(dev)
            for part, dev in zip(split_blocks(host, grid, (sh, sw)), self.mesh.devices)
        ]
        if route == "shard_ops":
            make_run = self._shard_ops_run(rule, (h, w), packed)
        elif route == "k4":
            make_run = self._k4_run(rule, (h, w), chunks)
        else:
            make_run = self._k3_run(rule, (h, w), chunks)
        runs: dict[int, object] = {}

        def advance(chunks, n_steps: int):
            num_blocks, rem = divmod(n_steps, k)
            for depth, count in ((k, num_blocks), (rem, 1)):
                if depth and count:
                    if depth not in runs:
                        runs[depth] = make_run(depth)
                    chunks = runs[depth](chunks, count)
            return chunks

        return ShardedRunner(chunks, advance, to_np, count_live, route, grid, host.shape)

    def _shard_ops_run(self, rule, logical, packed: bool):
        stencil = self._stencil(rule)
        if rule.boundary == "clamped":
            return lambda depth: halo.make_sharded_run_2d(
                rule, self.mesh, logical, block_steps=depth, packed=packed, stencil=stencil
            )
        if self._closed_rings(rule):
            return lambda depth: halo.make_sharded_run_torus_2d(
                rule, self.mesh, logical, block_steps=depth, packed=packed, stencil=stencil
            )
        return lambda depth: halo.make_sharded_run_torus(
            rule, self.mesh, logical, block_steps=depth, packed=packed
        )

    def _kernel_run(self, chunks, launch, fr_of, fc_of, periodic: bool):
        """Runs of kernel blocks: ``launch(top, chunk, bot, row0, left,
        right, col0, depth, out)`` steps shard s into ``out``, its spare
        buffer; each shard ping-pongs two buffers (the plain versions on
        the CPU allocate their own results)."""
        spares = [torch.empty_like(c) if c.is_cuda else None for c in chunks]
        cols = self.n_cols

        def make_run(depth: int):
            fr, fc = fr_of(depth), fc_of(depth)
            buffers = halo.halo_buffers(chunks, fr)
            col_halos = halo.col_buffers(chunks, fr, fc) if fc else None

            def block(s, chunk, h, row0, col0):
                out = launch(h.top, chunk, h.bot, row0, h.left, h.right, col0, depth, spares[s])
                if spares[s] is not None:
                    spares[s] = chunk
                return out

            return lambda chunks, count: halo.run_blocks(
                chunks, count, fr, block, periodic=periodic, buffers=buffers, cols=cols,
                fc=fc, col_halos=col_halos,
            )

        return make_run

    def _k3_run(self, rule, logical, chunks):
        def launch(top, chunk, bot, row0, left, right, col0, depth, out):
            return sharded_stripe.sharded_stripe_block(
                top, chunk, bot, row0, rule, logical, depth, out=out
            )

        return self._kernel_run(
            chunks, launch, lambda d: halo.halo_depth(rule, d), lambda d: 0,
            periodic=rule.boundary == "torus",
        )

    def _k4_run(self, rule, logical, chunks):
        def launch(top, chunk, bot, row0, left, right, col0, depth, out):
            return sharded_int8.sharded_int8_block(
                top, chunk, bot, row0, rule, logical, depth,
                left=left, right=right, col0=col0, out=out,
            )

        depth_of = lambda d: halo.halo_depth(rule, d)  # noqa: E731
        return self._kernel_run(
            chunks, launch, depth_of, depth_of if self.n_cols > 1 else (lambda d: 0),
            periodic=False,
        )

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
