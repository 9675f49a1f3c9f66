"""Command-line interface: ``python -m tpu_life_torch``.

``run`` with no flags reproduces the reference contract, like
``python -m tpu_life run``: it reads ``grid_size_data.txt`` + ``data.txt``,
writes ``output.txt`` and prints ``Total time = <s>``.  With ``--size`` (or
``--height``/``--width``) and ``--steps`` and no input file it runs the
seeded random board of ``--seed``.  It runs on the card; ``--device cpu``
asks for the plain PyTorch version on the CPU.  Its snapshot, resume,
recovery, metrics, trace and profile flags are the JAX ``run``'s.
``--rule lenia[:preset|:R..,m..,s..]`` runs the continuous tier on float32
boards (``auto`` sends it to the ``torch`` backend); ``--stencil`` picks
the neighbour-counting path.  ``bench`` prints one JSON throughput record
with the JAX ``bench`` record's keys.  ``gen`` writes a random board and its config,
``pattern`` converts RLE patterns and named patterns to and from the
contract files, each with the bytes ``python -m tpu_life`` writes;
``info`` shows the torch build, the CUDA devices, backends and rules.
"""

from __future__ import annotations

import argparse
import sys

from tpu_life_torch.config import RunConfig

PROG = "tpu_life_torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG, description="cellular-automaton engine, PyTorch/CUDA port"
    )
    sub = p.add_subparsers(dest="command")
    r = sub.add_parser("run", help="run a simulation (default command)")
    r.add_argument("--config-file", default="grid_size_data.txt")
    r.add_argument("--input-file", default="data.txt")
    r.add_argument("--output-file", default="output.txt")
    r.add_argument("--size", type=int, default=None,
                   help="square board: shorthand for --height N --width N "
                   "(explicit --height/--width win); with --steps and no "
                   "input file, runs a seeded random board")
    r.add_argument("--height", type=int, default=None)
    r.add_argument("--width", type=int, default=None)
    r.add_argument("--steps", type=int, default=None)
    r.add_argument("--rule", default="conway",
                   help="name or B/S / LtL spec, or a continuous "
                   "lenia[:<preset>|:R..,m..,s..] spec (float32 boards)")
    r.add_argument(
        "--seed", type=int, default=0,
        help="counter-based PRNG seed: names the staged board of a seeded "
        "run (geometry and steps from flags, no input file); stamped into "
        "the run record so the run is replayable",
    )
    r.add_argument(
        "--bug-compat", action="store_true",
        help="replicate the reference binary's effective (buggy) B/S2 rule",
    )
    r.add_argument(
        "--backend", default="auto", choices=["auto", "cuda", "torch", "numpy", "sharded"],
        help="auto = cuda: the hand-written kernels for clamped Moore rules "
        "(life-like, Generations, Larger-than-Life) and clamped 2-state von "
        "Neumann rules of radius <= 2, plain PyTorch ops on the card for the "
        "other von Neumann rules and the torus (':T') rules; torch = plain "
        "PyTorch ops for every rule; numpy = the host oracle; sharded = the "
        "board in row stripes (--num-devices) or blocks (--mesh-shape) over a "
        "mesh of devices, kernel K3 per stripe for life-like and 2-state von "
        "Neumann (r <= 2) rules and kernel K4 per shard for the other clamped "
        "Moore rules",
    )
    r.add_argument(
        "--device", default=None,
        help="device of the cuda/torch backends (default: the card); "
        "'cpu' runs the plain PyTorch version on the CPU; for the sharded "
        "backend, the one device that holds every shard (default: one card "
        "per shard)",
    )
    r.add_argument(
        "--num-devices", type=int, default=None,
        help="shards of the sharded backend (default: one per visible card)",
    )
    r.add_argument(
        "--mesh-shape", default=None, metavar="R,C",
        help="2-D rows,cols device mesh for the sharded backend (block "
        "decomposition; halo traffic ~ shard perimeter); with --device, all "
        "R*C shards on that one device",
    )
    r.add_argument(
        "--local-kernel", default="auto", choices=["auto", "torch", "cuda"],
        help="per-shard stepper of the sharded backend: cuda = kernel K3 "
        "(packed rules on a row mesh) or K4 (every other clamped Moore rule, "
        "and on a 2-D mesh the life-like rules unpacked), torch = plain "
        "PyTorch ops; auto = K3 or K4 where they apply, plain ops for the "
        "torus on a 2-D mesh, the packed rules of a 2-D mesh and the von "
        "Neumann rules K3 does not take",
    )
    r.add_argument(
        "--block-steps", type=int, default=None,
        help="CA steps per kernel launch (default 8; clamped to 1..32 and to "
        "what the rule's radius and the shards allow)",
    )
    r.add_argument(
        "--stencil", default="auto", choices=["auto", "roll", "matmul"],
        help="neighbour-counting path of the torch, numpy and sharded backends: "
        "roll = shift-adds, matmul = banded matmuls (bit-identical for integer "
        "rules; the path of the continuous kernels), auto = matmul for "
        "continuous rules and roll for integer rules (matmul from the radius "
        "TPU_LIFE_STENCIL_CROSSOVER sets, on torch and on sharded under "
        "--local-kernel torch; the numpy oracle stays on roll); the cuda "
        "backend's kernels count with their own sums and ignore it",
    )
    r.add_argument(
        "--no-bitpack", dest="bitpack", action="store_false",
        help="run the rules that have a bit-sliced path (life-like, clamped "
        "or torus, and 2-state von Neumann of radius <= 2) on the int8 path "
        "instead: kernel K2 for clamped Moore rules, the int8 stencil ops "
        "for the rest; bit-identical",
    )
    r.add_argument("--sync-every", type=int, default=0,
                   help="steps per host sync chunk (0 = one run)")
    r.add_argument("--snapshot-every", type=int, default=0)
    r.add_argument("--snapshot-dir", default="snapshots")
    r.add_argument(
        "--keep-snapshots",
        type=int,
        default=0,
        metavar="N",
        help="retain only the newest N snapshots (0 = keep all)",
    )
    r.add_argument("--resume", default=None)
    r.add_argument(
        "--max-restarts",
        type=int,
        default=0,
        help="elastic recovery: on a recoverable device failure, rebuild the "
        "backend and resume from the newest snapshot (pair with "
        "--snapshot-every) at most this many times; 0 fails fast",
    )
    r.add_argument(
        "--fault-at",
        type=int,
        default=0,
        metavar="STEP",
        help="fault-injection drill: simulate a device failure the first "
        "time the run crosses STEP (exercises the --max-restarts path)",
    )
    r.add_argument(
        "--fault-count",
        type=int,
        default=1,
        help="how many times the --fault-at drill fires (recovery rewinds "
        "below the fault step, so it re-fires until spent)",
    )
    r.add_argument(
        "--restart-wait",
        type=float,
        default=0.0,
        metavar="SECONDS",
        help="wait this long before each recovery attempt (device losses "
        "take time to clear)",
    )
    r.add_argument("--profile", default=None, metavar="TRACE_DIR",
                   help="write a torch.profiler trace of the drive (Chrome "
                   "trace JSON) into TRACE_DIR")
    r.add_argument(
        "--trace-events",
        default=None,
        metavar="FILE",
        help="write Chrome trace-event JSON (Perfetto-loadable): host-phase "
        "spans — config-resolve, backend-build, staging, each host-sync "
        "chunk, snapshots, recovery, gather, output — stamped with the "
        "run's correlation id",
    )
    r.add_argument("--metrics", action="store_true")
    r.add_argument(
        "--metrics-file",
        default=None,
        metavar="JSONL",
        help="append each metrics record as a JSON line (implies --metrics)",
    )
    r.add_argument("--verbose", "-v", action="store_true")

    b = sub.add_parser(
        "bench",
        help="quick throughput measurement: cells/s/chip, one JSON line",
    )
    # the JAX package's bench flags and defaults; --device takes the place
    # of its --platform, and the sharded backend's mesh comes from
    # --num-devices / --mesh-shape (with --device, all shards on it)
    b.add_argument("--size", type=int, default=4096)
    b.add_argument("--steps", type=int, default=1000)
    b.add_argument("--base-steps", type=int, default=100)
    b.add_argument("--repeats", type=int, default=3)
    b.add_argument("--rule", default="conway")
    b.add_argument("--backend", default="auto")
    b.add_argument("--device", default=None,
                   help="the device to measure (default: the card); 'cpu' "
                   "measures the plain PyTorch version")
    b.add_argument("--block-steps", type=int, default=None)
    b.add_argument("--local-kernel", default=None,
                   help="sharded backend only (ignored elsewhere, and "
                   "recorded as null in the JSON)")
    b.add_argument("--num-devices", type=int, default=None,
                   help="shards of the sharded backend")
    b.add_argument("--mesh-shape", default=None, metavar="R,C",
                   help="2-D rows,cols mesh of the sharded backend")
    sub.add_parser("info", help="show torch, CUDA devices, backends and rules")

    pat = sub.add_parser(
        "pattern",
        help="RLE pattern interchange: import/export boards, stamp named "
        "patterns",
    )
    pat.add_argument(
        "action",
        choices=["import", "export", "list"],
        help="import: RLE/named pattern -> contract board+config; "
        "export: contract board -> RLE; list: named patterns",
    )
    pat.add_argument("--rle", default=None, metavar="FILE",
                     help="RLE file (import source / export destination; "
                     "export defaults to stdout)")
    pat.add_argument("--name", default=None,
                     help="named pattern to import (see `pattern list`)")
    pat.add_argument("--height", type=int, default=None)
    pat.add_argument("--width", type=int, default=None)
    pat.add_argument("--at", default=None, metavar="R,C",
                     help="top-left placement of the pattern (default: centered)")
    pat.add_argument("--input-file", default="data.txt")
    pat.add_argument("--config-file", default="grid_size_data.txt")
    pat.add_argument("--steps", type=int, default=100,
                     help="steps written to the config file on import")
    pat.add_argument("--rule", default="B3/S23",
                     help="rule string stamped into the exported RLE header "
                     "(record what the board was actually evolved under)")

    g = sub.add_parser("gen", help="generate a random board + config")
    g.add_argument("--height", type=int, required=True)
    g.add_argument("--width", type=int, required=True)
    g.add_argument("--steps", type=int, default=100)
    g.add_argument("--density", type=float, default=0.5)
    g.add_argument("--states", type=int, default=2)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--input-file", default="data.txt")
    g.add_argument("--config-file", default="grid_size_data.txt")
    return p


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    if not argv or argv[0].startswith("-"):
        argv = ["run", *argv]  # default command
    args = parser.parse_args(argv)
    if args.command == "info":
        return _info()
    if args.command == "pattern":
        return _pattern(parser, args)
    if args.command == "gen":
        return _gen(args)
    if args.command == "bench":
        return _bench(parser, args)
    mesh_shape = _parse_mesh_shape(parser, args.mesh_shape)
    cfg = RunConfig(
        height=args.height if args.height is not None else args.size,
        width=args.width if args.width is not None else args.size,
        steps=args.steps,
        config_file=args.config_file,
        input_file=args.input_file,
        output_file=args.output_file,
        rule=args.rule,
        bug_compat=args.bug_compat,
        seed=args.seed,
        backend=args.backend,
        device=args.device,
        num_devices=args.num_devices,
        mesh_shape=mesh_shape,
        local_kernel=args.local_kernel,
        block_steps=args.block_steps,
        bitpack=args.bitpack,
        stencil=args.stencil,
        sync_every=args.sync_every,
        snapshot_every=args.snapshot_every,
        snapshot_dir=args.snapshot_dir,
        keep_snapshots=args.keep_snapshots,
        resume=args.resume,
        max_restarts=args.max_restarts,
        fault_at=args.fault_at,
        fault_count=args.fault_count,
        restart_wait_s=args.restart_wait,
        profile=args.profile,
        trace_events=args.trace_events,
        metrics=args.metrics,
        metrics_file=args.metrics_file,
        verbose=args.verbose,
    )
    from tpu_life_torch.models.rules import GeometryError
    from tpu_life_torch.runtime.driver import run

    try:
        run(cfg)
    except GeometryError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 2
    return 0


def _parse_mesh_shape(parser, spec: str | None) -> tuple[int, int] | None:
    if spec is None:
        return None
    try:
        parts = tuple(int(v) for v in spec.split(","))
    except ValueError:
        parts = ()
    if len(parts) != 2 or min(parts) < 1:
        parser.error(f"--mesh-shape must be two positive ints 'R,C', got {spec!r}")
    return parts


def _bench(parser, args) -> int:
    """In-process delta-timing throughput measurement, one JSON line: the
    JAX package's ``bench`` (same board, method and record keys).  Two runs
    of the Runner of different step counts are timed and differenced to
    cancel the launch and readback latency."""
    import json

    import numpy as np

    from tpu_life_torch.autotune import tuned_record
    from tpu_life_torch.backends.base import get_backend, measure_throughput
    from tpu_life_torch.models.rules import get_rule

    if args.backend == "tuned":
        print(f"{PROG}: error: --backend tuned is not yet ported (ROADMAP A10: "
              "autotune); name a backend", file=sys.stderr)
        return 2
    # the divisor of the JAX record's vs_baseline (BASELINE.json's
    # cell-updates/sec/chip figure), kept so the two records mean the same
    target = 1e11
    rule = get_rule(args.rule)
    n = args.size
    rng = np.random.default_rng(0)
    board = rng.integers(0, 2, size=(n, n), dtype=np.int8)
    if rule.states > 2:
        board *= rng.integers(1, rule.states, size=(n, n), dtype=np.int8)

    kwargs = {}
    if args.block_steps is not None:
        kwargs["block_steps"] = args.block_steps
    if args.local_kernel is not None:
        # the record carries what the resolved backend applied (null = the
        # backend has no local-kernel concept)
        kwargs["local_kernel"] = args.local_kernel
    placement = {"device": args.device, "num_devices": args.num_devices,
                 "mesh_shape": _parse_mesh_shape(parser, args.mesh_shape)}
    # the rule hint sends `auto` to the float path for continuous rules,
    # whose runner casts this 0/1 board to float32
    backend = get_backend(args.backend, rule=rule, **kwargs, **placement)
    per_chip, n_chips = measure_throughput(
        backend, board, rule, args.steps, args.base_steps, args.repeats
    )
    mesh = getattr(backend, "mesh", None)
    device = mesh.devices[0] if mesh is not None else getattr(backend, "device", None)
    print(
        json.dumps(
            {
                "metric": "cell_updates_per_sec_per_chip",
                "value": per_chip,
                "unit": "cells/s/chip",
                "vs_baseline": per_chip / target,
                "rule": args.rule,
                "platform": device.type if device is not None else "cpu",
                "backend": backend.name,
                "local_kernel": getattr(backend, "local_kernel", None),
                "size": n,
                "steps": args.steps,
                "n_chips": n_chips,
                "tuned": tuned_record(backend.name, kwargs),
                "tuned_source": "flags",
            }
        )
    )
    return 0


def _info() -> int:
    import torch

    from tpu_life_torch.backends.base import BACKENDS, get_backend
    from tpu_life_torch.models.rules import RULE_REGISTRY

    get_backend("numpy")  # registers every backend
    print(f"torch {torch.__version__} (cuda {torch.version.cuda})")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"cuda devices: {n}")
    for i in range(n):
        print(f"  device {i}: {torch.cuda.get_device_name(i)}")
    print("backends:", ", ".join(sorted(BACKENDS)), "(auto = cuda; torch for lenia)")
    if n:
        mesh = ", ".join(f"cuda:{i}" for i in range(n))
        print(f"mesh devices (sharded backend, one shard each): {mesh}")
    else:
        print("mesh devices (sharded backend): none; --device cpu --num-devices N "
              "puts N shards on the CPU")
    print("rules:", ", ".join(sorted(RULE_REGISTRY)))
    print(
        "cuda, torch and numpy run every deterministic rule: cuda through "
        "the hand-written kernels K1 (life-like; 2-state NN of radius <= 2) "
        "and K2 (other clamped Moore rules) and through PyTorch ops on the "
        "card for the other NN and the ':T' rules; torch through PyTorch "
        "ops alone; sharded runs them in row stripes or blocks over a mesh "
        "(--mesh-shape R,C), route k3 (K3 per stripe) for life-like and "
        "2-state NN (r <= 2) rules on a row mesh, route k4 (K4 per shard) "
        "for Generations, LtL and --no-bitpack on any mesh, shard_ops (PyTorch "
        "ops per shard) for the rest; --stencil matmul counts by banded "
        "matmuls on torch, numpy and sharded; continuous rules "
        "lenia[:<preset>|:R..,m..,s..] (float32 boards) run on torch, numpy and "
        "sharded (torus); ising and noisy: are not ported yet"
    )
    return 0


def _pattern(parser, args) -> int:
    """RLE interchange (``io/rle.py``): published patterns drop into the
    contract codec and back out."""
    from pathlib import Path

    import numpy as np

    from tpu_life_torch.io import rle
    from tpu_life_torch.io.codec import read_board, read_config, write_board, write_config
    from tpu_life_torch.models import patterns

    named = {
        n.lower(): getattr(patterns, n)
        for n in dir(patterns)
        if n.isupper() and isinstance(getattr(patterns, n), np.ndarray)
    }
    if args.action == "list":
        for n in sorted(named):
            h, w = named[n].shape
            print(f"{n}  {h}x{w}")
        return 0

    if args.action == "export":
        height, width = args.height, args.width
        if height is None or width is None:
            ch, cw, _ = read_config(args.config_file)
            height = ch if height is None else height
            width = cw if width is None else width
        board = read_board(args.input_file, height, width)
        try:
            from tpu_life_torch.models.rules import get_rule

            states = get_rule(args.rule).states
        except (KeyError, ValueError):
            states = 2  # unknown rule string: dialect follows board content
        text = rle.emit_rle(board, rule=args.rule, states=states)
        if args.rle:
            Path(args.rle).write_text(text)
            print(f"wrote {args.rle} ({height}x{width})")
        else:
            print(text, end="")
        return 0

    # import
    if (args.rle is None) == (args.name is None):
        parser.error("pattern import needs exactly one of --rle / --name")
    if args.rle is not None:
        cells, meta = rle.parse_rle(Path(args.rle).read_text())
        if cells.max(initial=0) > 9:
            parser.error(
                "pattern uses states > 9, which don't fit the contract "
                "codec's digit encoding"
            )
        if meta.get("rule"):
            print(f"pattern rule: {meta['rule']} (pass via `run --rule`)")
    else:
        key = args.name.lower()
        if key not in named:
            parser.error(f"unknown pattern {args.name!r}; see `{PROG} pattern list`")
        cells = named[key]
    ph, pw = cells.shape
    height = args.height if args.height is not None else ph
    width = args.width if args.width is not None else pw
    if args.at is not None:
        try:
            top, left = (int(v) for v in args.at.split(","))
        except ValueError:
            parser.error(f"--at must be 'R,C', got {args.at!r}")
    else:
        top, left = (height - ph) // 2, (width - pw) // 2
    if top < 0 or left < 0 or top + ph > height or left + pw > width:
        parser.error(
            f"pattern {ph}x{pw} at ({top},{left}) does not fit a "
            f"{height}x{width} board"
        )
    board = patterns.place(patterns.empty(height, width), cells, top, left)
    write_board(args.input_file, board)
    write_config(args.config_file, height, width, args.steps)
    print(
        f"wrote {args.input_file} ({height}x{width}, pattern at "
        f"{top},{left}) and {args.config_file}"
    )
    return 0


def _gen(args) -> int:
    from tpu_life_torch.io.codec import write_board, write_config
    from tpu_life_torch.models.patterns import random_board

    board = random_board(
        args.height, args.width, args.density, states=args.states, seed=args.seed
    )
    write_board(args.input_file, board)
    write_config(args.config_file, args.height, args.width, args.steps)
    print(f"wrote {args.input_file} ({args.height}x{args.width}) and {args.config_file}")
    return 0


def console_main() -> int:
    """Process entry point: user-facing errors become one tidy stderr line
    + exit 1 instead of a traceback.  ``main`` itself keeps raising so
    library callers (and tests) see the real exceptions."""
    try:
        return main()
    except KeyboardInterrupt:
        print(f"{PROG}: interrupted", file=sys.stderr)
        return 130
    except (ValueError, RuntimeError, OSError) as e:
        # bad config/flags/rules, missing files, no card, rule tiers not
        # yet ported
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(console_main())
