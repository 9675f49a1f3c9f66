"""Command-line interface: ``python -m tpu_life_torch``.

``run`` with no flags reproduces the reference contract, like
``python -m tpu_life run``: it reads ``grid_size_data.txt`` + ``data.txt``,
writes ``output.txt`` and prints ``Total time = <s>``.  ``--stream-io``
reads and writes the board per shard on the sharded backend, and in a job
of several processes (the JAX package's ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``, or torchrun's variables) each
process runs its own shards.  With ``--size`` (or
``--height``/``--width``) and ``--steps`` and no input file it runs the
seeded random board of ``--seed``.  It runs on the card; ``--device cpu``
asks for the plain PyTorch version on the CPU.  Its snapshot, resume,
recovery, metrics, trace and profile flags are the JAX ``run``'s.
``--rule lenia[:preset|:R..,m..,s..]`` runs the continuous tier on float32
boards (``auto`` sends it to the ``torch`` backend); ``--stencil`` picks
the neighbour-counting path.  ``--rule ising --temperature T`` and
``--rule noisy:<p>/<base>`` run the stochastic tier, whose trajectory
``--seed`` names (kernels K6 and K7 on the card).  ``bench`` prints one
JSON throughput record with the JAX ``bench`` record's keys; ``bench
--mc`` prints ``bench.py --mc``'s record of Metropolis sweeps.  ``gen``
writes a random board and its config, ``pattern`` converts RLE patterns
and named patterns to and from the contract files, each with the bytes
``python -m tpu_life`` writes; ``info`` shows the torch build, the CUDA
devices, backends and rules.  ``submit`` appends a request line to a
spool and ``serve`` runs every request of a spool through the serving
tier (``tpu_life_torch.serve``), printing one summary JSON line: the JAX
``submit``/``serve`` with ``--device`` for ``--platform`` and the port's
serve backends (``cuda``, the default, ``numpy``, ``sharded``).  ``sweep``
fans a temperature grid into one ising session each through the same
tier and prints the JAX ``sweep``'s JSON record; its ``--serve-backend``
is ``cuda`` (the default: kernels K6 and K7's batch modes) or ``numpy``.
``tune`` measures the candidate configurations of a (device, rule, board
shape) key and persists the winner to the port's autotune cache; ``run
--backend tuned`` (with ``--tune-mode``), ``bench --backend tuned`` and
``serve --serve-backend tuned`` resolve through it.  ``run --backend
native|stripes|mpi`` and ``serve --serve-backend native|stripes`` step on
the host.  ``gateway`` puts the serving tier behind the JAX package's HTTP
API, ``client`` talks to a gateway, ``spill-store`` hosts the HTTP spill
store and ``stats`` summarizes metrics sinks.  ``fleet`` supervises N
gateway workers (on the card unless ``--device cpu``) behind a router with
failover and migration; ``chaos`` drives such a fleet through a seeded
fault drill; ``top`` is the fleet's live console, ``trace merge`` and
``doctor`` read its trace captures back.  ``client``, ``spill-store``,
``stats``, ``fleet``, ``top``, ``trace`` and ``doctor`` import no torch,
so they run beside a wedged card.  On the card, ``run``, ``bench``,
``tune``, ``serve``, ``sweep`` and ``gateway`` first probe it under a
watchdog (``utils.platform.devices_with_watchdog``) and exit 2 when the
query hangs.
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
                   help="name or B/S / LtL spec, a continuous "
                   "lenia[:<preset>|:R..,m..,s..] spec (float32 boards), or a "
                   "stochastic ising / noisy:<p>/<base> spec")
    r.add_argument(
        "--seed", type=int, default=0,
        help="counter-based PRNG seed: names the whole trajectory of a "
        "stochastic rule (ising / noisy:*) and the staged board of a seeded "
        "run (geometry and steps from flags, no input file); stamped into "
        "the run record so the run is replayable",
    )
    r.add_argument(
        "--temperature", type=float, default=None, metavar="T",
        help="Metropolis temperature for --rule ising (required there, "
        "invalid elsewhere); the Onsager critical point is T~2.269",
    )
    r.add_argument(
        "--bug-compat", action="store_true",
        help="replicate the reference binary's effective (buggy) B/S2 rule",
    )
    r.add_argument(
        "--backend", default="auto",
        choices=["auto", "tuned", "cuda", "torch", "numpy", "sharded", "native", "stripes", "mpi"],
        help="tuned = the backend and knobs the autotune cache holds for this "
        "device, rule and board shape (see `tune` and --tune-mode; a cache miss "
        "takes the cost model's pick); auto = cuda: the hand-written kernels "
        "for clamped Moore rules "
        "(life-like, Generations, Larger-than-Life) and clamped 2-state von "
        "Neumann rules of radius <= 2, plain PyTorch ops on the card for the "
        "other von Neumann rules and the torus (':T') rules, kernels K6 and K7 "
        "for the stochastic rules (sharded refuses them); torch = plain "
        "PyTorch ops for every rule; numpy = the host oracle; sharded = the "
        "board in row stripes (--num-devices) or blocks (--mesh-shape) over a "
        "mesh of devices, kernel K3 per stripe for life-like and 2-state von "
        "Neumann (r <= 2) rules and kernel K4 per shard for the other clamped "
        "Moore rules; native = the threaded C++ stepper of csrc/life.cpp on "
        "the host (clamped Moore rules; built with g++ at first use); stripes "
        "= the reference's rank structure in numpy on the host (--num-devices "
        "stripes, default 4); mpi = one stripe a rank over mpi4py",
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
        "--partition-mode", default="shard_map", choices=["shard_map", "gspmd"],
        help="sharded backend: shard_map = the explicit halo exchange; gspmd "
        "(the JAX package's compiler-derived exchange) is refused with exit "
        "2: a row-sharded DTensor step all-gathers the board every step",
    )
    r.add_argument(
        "--stream-io", action="store_true", default=None,
        help="per-shard streamed file I/O (sharded backend): each shard reads "
        "and writes its own bytes of the board files and snapshots, so the "
        "board is never whole on one host; on by default for boards of "
        "2^28 cells and more read from a file",
    )
    r.add_argument("--no-stream-io", dest="stream_io", action="store_false",
                   help="stage and write the board whole on the host")
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
    r.add_argument(
        "--tune-mode", default="cache", choices=["off", "cache", "measure"],
        help="autotune resolution for --backend tuned: off = analytic cost "
        "model only; cache = cache hit else cost model (never measures); "
        "measure = cache hit else run the measured search now and persist it",
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

    t = sub.add_parser(
        "tune",
        help="measured autotuning: search the (backend, block_steps, "
        "local_kernel, bitpack) space for this device + rule + board "
        "shape and persist the winner to the autotune cache",
    )
    t.add_argument("--size", type=int, default=4096,
                   help="square board edge for the trial workload")
    t.add_argument("--height", type=int, default=None,
                   help="trial board height (overrides --size)")
    t.add_argument("--width", type=int, default=None,
                   help="trial board width (overrides --size)")
    t.add_argument("--rule", default="conway")
    t.add_argument("--backend-set", default=None, metavar="B1,B2",
                   help="comma list of backends to search (default: "
                   "torch,sharded,cuda on the card; torch,sharded on the CPU)")
    t.add_argument("--trials", type=int, default=3,
                   help="timed repetitions per candidate (median wins)")
    t.add_argument("--steps", type=int, default=None,
                   help="steps per timed trial (default: by device kind)")
    t.add_argument("--warmup-steps", type=int, default=None,
                   help="untimed steps absorbing kernel builds per candidate")
    t.add_argument("--dry-run", action="store_true",
                   help="enumerate candidates and rank by the analytic "
                   "cost model only — no measurement, nothing persisted")
    t.add_argument("--cache-file", default=None, metavar="JSON",
                   help="autotune cache location (default "
                   "~/.cache/tpu_life_torch/autotune.json or "
                   "$TPU_LIFE_TORCH_AUTOTUNE_CACHE)")
    t.add_argument("--device", default=None,
                   help="the device to tune for (default: the card); 'cpu' "
                   "tunes the CPU's candidates")

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
    # bench.py's --mc capture: Metropolis sweep throughput through the
    # stochastic tier, with its flags and defaults
    b.add_argument("--mc", action="store_true",
                   help="stochastic-tier bench: checkerboard Metropolis sweeps "
                   "(emits mc_sweeps_per_sec + spin_updates_per_sec)")
    b.add_argument("--mc-size", type=int, default=4096, help="square lattice edge")
    b.add_argument("--mc-steps", type=int, default=400, help="sweeps per timed run")
    b.add_argument("--mc-base-steps", type=int, default=40,
                   help="sweeps in the baseline run of the delta pair")
    b.add_argument("--mc-sizes", default=None, metavar="N1,N2,N3",
                   help="lattice edges of the packed-vs-roll legs on the numpy "
                   "reference executor (default 256,512,1024)")
    b.add_argument("--mc-temperature", type=float, default=2.27,
                   help="Metropolis temperature (default ~ the Onsager critical point)")
    b.add_argument("--mc-seed", type=int, default=0)
    b.add_argument("--mc-rule", default="ising",
                   help="stochastic rule to measure (ising / noisy:<p>/<base>)")
    b.add_argument("--no-bitpack", dest="bitpack", action="store_false",
                   help="pin the int8 path instead of the bit-packed one "
                   "(with --mc, the roll path)")
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

    _add_serve_parsers(sub)
    _add_front_door_parsers(sub)
    _add_fleet_parsers(sub)

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
    # deterministic fault injection: arm once, at entry, from
    # TPU_LIFE_CHAOS when present — how a chaos drill arms the gateway
    # workers a fleet spawns (they inherit the exported spec)
    from tpu_life_torch import chaos

    try:
        chaos.maybe_arm_from_env()
    except chaos.ChaosError as e:
        print(f"{PROG}: bad {chaos.ENV_VAR}: {e}", file=sys.stderr)
        return 2
    # the torch-free commands first: they run beside a wedged card
    if args.command == "stats":
        return _stats(args)
    if args.command == "client":
        return _client(parser, args)
    if args.command == "spill-store":
        return _spill_store(args)
    if args.command == "trace":
        return _trace_merge(args)
    if args.command == "doctor":
        return _doctor(args)
    if args.command == "top":
        return _top(args)
    if args.command == "fleet":
        # the front tier is stdlib plumbing: only the worker processes
        # load torch and touch the card
        return _fleet(args)
    if args.command == "chaos":
        # the drill process holds the oracles; its workers own the card
        return _chaos_drill(args)
    if args.command == "info":
        return _info()
    if args.command == "pattern":
        return _pattern(parser, args)
    if args.command == "gen":
        return _gen(args)
    if args.command == "submit":
        return _submit(args)
    if _on_card(args):
        # prime the card's first query under a watchdog, so a wedged driver
        # ends in a message and exit 2 instead of a hang; never a fallback
        from tpu_life_torch.utils.platform import devices_with_watchdog

        try:
            devices_with_watchdog()
        except TimeoutError as e:
            print(f"{PROG}: {e}", file=sys.stderr)
            return 2
    if args.command == "tune":
        return _tune(args)
    if args.command == "bench":
        return _bench(parser, args)
    if args.command == "serve":
        return _serve(args)
    if args.command == "sweep":
        return _sweep(parser, args)
    if args.command == "gateway":
        return _gateway(args)
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
        temperature=args.temperature,
        backend=args.backend,
        device=args.device,
        num_devices=args.num_devices,
        mesh_shape=mesh_shape,
        local_kernel=args.local_kernel,
        partition_mode=args.partition_mode,
        block_steps=args.block_steps,
        tune_mode=args.tune_mode,
        bitpack=args.bitpack,
        stencil=args.stencil,
        sync_every=args.sync_every,
        stream_io=args.stream_io,
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
    from tpu_life_torch.backends.sharded_backend import PartitionModeRefused
    from tpu_life_torch.mc import StochasticBackendError
    from tpu_life_torch.models.rules import GeometryError
    from tpu_life_torch.runtime.driver import run

    try:
        run(cfg)
    except (GeometryError, PartitionModeRefused, StochasticBackendError) as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 2
    return 0


def _on_card(args) -> bool:
    """Whether a ``run``, ``bench``, ``tune``, ``serve`` or ``sweep`` will
    touch the card: not when it asks for the CPU or runs the numpy oracle."""
    import torch

    device = getattr(args, "device", None)
    if device is not None and torch.device(device).type == "cpu":
        return False
    backend = getattr(args, "serve_backend", None) or getattr(args, "backend", None)
    return backend not in ("numpy", "native", "stripes", "mpi")


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

    if args.mc:
        return _bench_mc(parser, args)
    # the divisor of the JAX record's vs_baseline (BASELINE.json's
    # cell-updates/sec/chip figure), kept so the two records mean the same
    target = 1e11
    rule = get_rule(args.rule)
    n = args.size
    rng = np.random.default_rng(0)
    board = rng.integers(0, 2, size=(n, n), dtype=np.int8)
    if rule.states > 2:
        board *= rng.integers(1, rule.states, size=(n, n), dtype=np.int8)

    # bitpack enters kwargs only on a --no-bitpack pin, so the record's
    # "tuned" carries it as bench.py's does
    kwargs = {}
    if not args.bitpack:
        kwargs["bitpack"] = False
    if args.block_steps is not None:
        kwargs["block_steps"] = args.block_steps
    if args.local_kernel is not None:
        # the record carries what the resolved backend applied (null = the
        # backend has no local-kernel concept)
        kwargs["local_kernel"] = args.local_kernel
    placement = {"device": args.device, "num_devices": args.num_devices,
                 "mesh_shape": _parse_mesh_shape(parser, args.mesh_shape)}
    backend_name = args.backend
    tuned_source = "flags"
    if backend_name == "tuned":
        # read-path resolution (cache hit or cost model — never measures);
        # knobs already pinned in kwargs by explicit flags win over the
        # cached ones (the shared merge rule, autotune.resolve_backend_kwargs)
        from tpu_life_torch import autotune

        backend_name, _, tuned_source = autotune.resolve_backend_kwargs(
            rule, (n, n), kwargs, device=args.device
        )
    # the rule hint sends `auto` to the float path for continuous rules,
    # whose runner casts this 0/1 board to float32
    backend = get_backend(backend_name, rule=rule, **kwargs, **placement)
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
                "tuned_source": tuned_source,
            }
        )
    )
    return 0


def _tune(args) -> int:
    """The offline tuning search (the JAX ``tune``): a table of trials, one
    JSON summary line last (machine-parseable like ``bench``), the winner
    persisted to the port's autotune cache.

    ``--dry-run`` ranks by the analytic cost model only — candidate
    enumeration and ordering are exercised, no device measurement happens
    and nothing is written.
    """
    import json

    from tpu_life_torch import autotune
    from tpu_life_torch.models.rules import get_rule

    rule = get_rule(args.rule)
    h = args.height if args.height is not None else args.size
    w = args.width if args.width is not None else args.size
    key = autotune.tune_key_for(rule, (h, w), device=args.device)
    backend_set = (
        tuple(s for s in args.backend_set.split(",") if s) if args.backend_set else None
    )

    unit = "cost" if args.dry_run else "s/step"
    print(f"# tune {key.id()}  trials={args.trials} ({unit})")

    def on_trial(i, total, res):
        if res.ok:
            cells = h * w / res.seconds_per_step
            val = f"{res.seconds_per_step:.3e}  ({cells:.3e} cells/s)"
        else:
            val = f"infeasible: {res.error}"
        print(f"  [{i + 1}/{total}] {res.config.describe():<55s} {val}", flush=True)

    result = autotune.tune(
        key,
        rule,
        shape=(h, w),
        backend_set=backend_set,
        trials=args.trials,
        steps=args.steps,
        warmup_steps=args.warmup_steps,
        dry_run=args.dry_run,
        cache_file=args.cache_file,
        on_trial=on_trial,
    )
    if args.dry_run:
        for i, res in enumerate(result.results):
            print(
                f"  [{i + 1}/{len(result.results)}] "
                f"{res.config.describe():<55s} cost={res.seconds_per_step:.3f}"
            )
    best = autotune.runner.best_result(result.results)
    print(
        json.dumps(
            {
                "mode": "tune",
                "key": key.id(),
                "best": result.best.to_dict(),
                "source": result.source,
                "candidates": len(result.results),
                "infeasible": sum(1 for r in result.results if not r.ok),
                "seconds_per_step": best.seconds_per_step
                if best is not None and not args.dry_run
                else None,
                "trials": args.trials,
                "cache_file": result.cache_file,
            }
        )
    )
    return 0


def _bench_mc(parser, args) -> int:
    """``bench --mc``: Metropolis sweeps per second through the stochastic
    tier, ``bench.py``'s ``run_mc_bench`` record.  The primary measurement
    runs on ``--backend`` (packed by default, ``--no-bitpack`` pins the roll
    path) by delta timing; the packed-vs-roll legs run on the numpy
    reference executor at ``--mc-sizes``, as ``bench.py`` runs them on
    every platform.  The board is the seeded board of ``--mc-seed``, drawn
    on the card when the backend is there."""
    import json

    from tpu_life_torch import mc, obs
    from tpu_life_torch.backends.base import get_backend, make_runner
    from tpu_life_torch.models.rules import IsingRule, get_rule
    from tpu_life_torch.utils.timing import delta_seconds_per_step

    try:
        rule = get_rule(args.mc_rule)
    except ValueError as e:
        parser.error(f"unknown rule: {e}")
    if not rule.stochastic:
        parser.error(f"--mc needs a stochastic rule, got {args.mc_rule!r}")
    temperature = args.mc_temperature if isinstance(rule, IsingRule) else None
    n = args.mc_size
    try:
        mc.validate_params(rule, temperature)
        mc.validate_board_shape(rule, (n, n))
    except ValueError as e:
        parser.error(str(e))
    backend = get_backend(args.backend, rule=rule, bitpack=args.bitpack, device=args.device)
    device = getattr(backend, "device", None)
    on_card = device is not None and device.type == "cuda"
    board = mc.seeded_board(n, n, seed=args.mc_seed, device=device if on_card else None)
    board = board.cpu().numpy() if on_card else board
    runner = make_runner(backend, board, rule, seed=args.mc_seed, temperature=temperature)
    per_sweep = delta_seconds_per_step(runner, args.mc_steps, args.mc_base_steps,
                                       repeats=args.repeats)

    # the packed-vs-roll legs on the numpy reference executor
    legs: list[dict] = []
    crossover = None
    speedups: dict[str, float] = {}
    if mc.packed_supports(rule):
        sizes = (
            tuple(int(s) for s in args.mc_sizes.split(","))
            if args.mc_sizes
            else (256, 512, 1024)
        )
        ref = get_backend("numpy")
        base_size = min(sizes)
        for size in sizes:
            leg_board = mc.seeded_board(size, size, seed=args.mc_seed)
            # scale sweeps down with area so every leg costs roughly what
            # the smallest one does; delta timing floors at 3-over-1
            scale = (base_size / size) ** 2
            steps = max(3, int(round(args.mc_steps * scale)))
            base_steps = max(1, steps // 6)
            by_path: dict[bool, float] = {}
            for packed in (False, True):
                leg_runner = make_runner(ref, leg_board, rule, seed=args.mc_seed,
                                         temperature=temperature, packed=packed)
                per = delta_seconds_per_step(leg_runner, steps, base_steps, repeats=args.repeats)
                by_path[packed] = size * size / per
                legs.append({
                    "size": size,
                    "packed": packed,
                    "lanes": getattr(leg_runner, "lanes", None),
                    "backend": "numpy",
                    "sweeps_per_sec": 1.0 / per,
                    "spin_updates_per_sec": by_path[packed],
                    "steps": steps,
                    "base_steps": base_steps,
                    "seed": args.mc_seed,
                    "temperature": temperature,
                })
            speedups[str(size)] = by_path[True] / by_path[False]
            if crossover is None and by_path[True] >= by_path[False]:
                crossover = size

    platform = device.type if device is not None else "cpu"
    print(json.dumps({
        "metric": "mc_sweeps_per_sec",
        "value": 1.0 / per_sweep,
        "unit": "sweeps/s",
        # one sweep proposes a flip at every site (two half-lattice
        # checkerboard updates), so spin-updates/s = cells * sweeps/s
        "spin_updates_per_sec": n * n / per_sweep,
        "rule": args.mc_rule,
        "temperature": temperature,
        "seed": args.mc_seed,
        "run_id": obs.new_run_id(),
        # the storage-path stamp: which executor produced the primary
        # number (packed runners carry packed=True, lanes=32)
        "packed": bool(getattr(runner, "packed", False)),
        "lanes": getattr(runner, "lanes", None),
        "route": getattr(runner, "route", backend.name),
        "platform": platform,
        "platform_actual": platform,
        "platform_pinned": args.device,
        "backend": backend.name,
        "size": n,
        "steps": args.mc_steps,
        "base_steps": args.mc_base_steps,
        "repeats": args.repeats,
        # the packed-vs-roll comparison (empty legs for non-packable
        # stochastic rules, e.g. noisy:*)
        "legs": legs,
        "packed_speedup": speedups,
        "crossover_size": crossover,
        "degraded": False,
    }))
    return 0


def _info() -> int:
    import torch

    from tpu_life_torch.backends.base import BACKENDS, get_backend
    from tpu_life_torch.models.rules import RULE_REGISTRY

    get_backend("numpy")  # registers the card and numpy backends
    from tpu_life_torch.backends import native_backend, stripes_backend  # noqa: F401  (the host ones)

    print(f"torch {torch.__version__} (cuda {torch.version.cuda})")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"cuda devices: {n}")
    for i in range(n):
        print(f"  device {i}: {torch.cuda.get_device_name(i)}")
    print("backends:", ", ".join(sorted(BACKENDS)),
          "(auto = cuda; torch for lenia; native, stripes and mpi step on the host)")
    if n:
        mesh = ", ".join(f"cuda:{i}" for i in range(n))
        print(f"mesh devices (sharded backend, one shard each): {mesh}")
    else:
        print("mesh devices (sharded backend): none; --device cpu --num-devices N "
              "puts N shards on the CPU")
    from tpu_life_torch.io import native as native_io
    from tpu_life_torch.utils.nativelib import NativeBuildError

    try:
        codec_state = "ok" if native_io.build() else "numpy (TPU_LIFE_NATIVE=0)"
    except NativeBuildError as e:
        codec_state = f"build failed ({str(e).splitlines()[0]})"
    print("native io codec:", codec_state)
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
        "sharded (torus); the stochastic rules ising (needs --temperature) and "
        "noisy:<p>/<base> run on cuda (kernels K6 and K7, K2 for noisy bases "
        "it steps), torch and numpy"
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


# -- submit / serve: the spool front-end of the serving tier ------------------

#: the port's serve backends, and the JAX package's that wait for later items
SERVE_BACKEND_CHOICES = ["cuda", "numpy", "sharded", "tuned", "stripes", "native"]


def _add_serve_parsers(sub) -> None:
    """``submit`` and ``serve`` with the JAX package's flags and defaults;
    ``--device`` takes the place of ``--platform``, and ``--serve-backend``
    takes the port's names."""
    srv = sub.add_parser(
        "serve",
        help="multi-tenant batched serving: run every request in a JSONL "
        "spool file through the continuous-batching service",
    )
    srv.add_argument("--requests", default="serve_requests.jsonl", metavar="JSONL",
                     help="request spool file (one JSON object per line; see `submit`)")
    srv.add_argument("--output-dir", default="serve_out",
                     help="where results land for requests without an output_file "
                     "(<output-dir>/<session-id>.txt, contract board format)")
    srv.add_argument("--capacity", type=int, default=8, help="batch slots per compile key")
    srv.add_argument("--chunk-steps", type=int, default=16,
                     help="device steps per scheduling round")
    srv.add_argument("--max-queue", type=int, default=64,
                     help="bounded admission queue (backpressure threshold)")
    srv.add_argument(
        "--serve-backend", default="cuda", choices=SERVE_BACKEND_CHOICES,
        help="engine executor: cuda = the card: K1's batch mode for the rules "
        "kernel K1 takes, one K2 Runner per slot for the other clamped Moore "
        "rules, and the device batch in plain ops for the rest; numpy = the "
        "host oracle; sharded = one sharded Runner per slot (K3/K4); tuned = "
        "per compile key, the backend the autotune cache holds (read path "
        "only: an untuned key takes the cost-model pick, never a "
        "measurement); stripes and native = one host Runner a slot of those "
        "backends (no card needed)",
    )
    srv.add_argument("--sync-pump", action="store_true",
                     help="run the host-synchronous scheduling round instead of the "
                     "default pipelined (double-buffered) pump")
    srv.add_argument("--no-bitpack", action="store_true",
                     help="serve ising on the int8 roll engine (K7's batch mode) "
                     "instead of the default packed one (K6's batch mode): "
                     "bit-identical, the packed path's oracle")
    srv.add_argument("--stencil", default="auto", choices=["auto", "roll", "matmul"],
                     help="neighbour-counting path of the plain-op engines: roll, "
                     "matmul, or auto (matmul for continuous rules; the numpy "
                     "oracle stays on roll)")
    srv.add_argument("--timeout", type=float, default=None, metavar="SECONDS",
                     help="default per-request deadline")
    srv.add_argument("--spill-dir", default=None, metavar="DIR",
                     help="durable sessions: spill every live session's board + "
                     "manifest here through the checkpoint contract")
    srv.add_argument("--spill-every", type=int, default=4, metavar="K",
                     help="rounds between spill passes")
    srv.add_argument("--metrics-file", default=None, metavar="JSONL",
                     help="append per-round serve metrics as JSON lines")
    srv.add_argument("--trace-events", default=None, metavar="FILE",
                     help="write Chrome trace-event JSON: round spans + per-session "
                     "queue-wait intervals, run_id-correlated with the metrics sink")
    srv.add_argument("--prom-file", default=None, metavar="FILE",
                     help="write a Prometheus text snapshot of the serve metrics "
                     "registry at shutdown")
    srv.add_argument("--memory-budget-bytes", type=int, default=None, metavar="BYTES",
                     help="admission memory budget for estimated engine footprints "
                     "(default: devices x per-kind default; 0 disables)")
    srv.add_argument("--engine-max-restarts", type=int, default=3, metavar="N",
                     help="in-place engine recoveries per compile key (rebuild and "
                     "replay; OOM: halve the chunk, then the host engine)")
    srv.add_argument("--settle-deadline", type=float, default=None, metavar="SECONDS",
                     help="wedge watchdog: a pipelined settle window still blocked "
                     "after this many seconds marks the service wedged")
    srv.add_argument("--mesh-devices", type=int, default=0, metavar="N",
                     help="mega-board tier: reserve an N-device slice (on one card, "
                     "N shards of it) for boards the governor would reject as "
                     "never-fits (0 = tier off; needs >= 2)")
    srv.add_argument("--device", default=None,
                     help="the device of the device engines (default: the card); "
                     "'cpu' runs their plain PyTorch versions")
    srv.add_argument("--profile", default=None, metavar="TRACE_DIR")
    srv.add_argument("--verbose", "-v", action="store_true")

    sm = sub.add_parser(
        "submit",
        help="append one simulation request to the serve spool file "
        "(board + rule + step budget)",
    )
    sm.add_argument("--requests", default="serve_requests.jsonl", metavar="JSONL")
    sm.add_argument("--input-file", default="data.txt")
    sm.add_argument("--config-file", default="grid_size_data.txt",
                    help="geometry fallback for unset --height/--width/--steps")
    sm.add_argument("--size", type=int, default=None,
                    help="square board: shorthand for --height N --width N "
                    "(explicit --height/--width win); with --steps and no "
                    "input file, queues a seeded random board")
    sm.add_argument("--height", type=int, default=None)
    sm.add_argument("--width", type=int, default=None)
    sm.add_argument("--steps", type=int, default=None)
    sm.add_argument("--seed", type=int, default=0,
                    help="seed for the no-input-file random board")
    sm.add_argument("--rule", default="conway")
    sm.add_argument("--temperature", type=float, default=None, metavar="T",
                    help="Metropolis temperature for --rule ising (rides the spool line)")
    sm.add_argument("--output-file", default=None,
                    help="where `serve` writes this request's result "
                    "(default: <output-dir>/<session-id>.txt)")
    sm.add_argument("--timeout", type=float, default=None, metavar="SECONDS")
    sm.add_argument("--id", default=None, help="client request tag echoed in the summary")

    sw = sub.add_parser(
        "sweep",
        help="temperature sweep: fan a temperature grid into one ising session "
        "per temperature through the continuous-batching service — mixed "
        "temperatures share ONE build of the batched chunk",
    )
    sw.add_argument("--size", type=int, default=None,
                    help="square lattice edge (or --height/--width)")
    sw.add_argument("--height", type=int, default=None)
    sw.add_argument("--width", type=int, default=None)
    sw.add_argument("--steps", type=int, required=True, help="Metropolis sweeps per session")
    sw.add_argument("--rule", default="ising", help="stochastic rule to sweep (ising)")
    sw.add_argument("--temps", default="1.5:3.0:8", metavar="SPEC",
                    help="temperature grid: comma list 'T1,T2,...' or range 'lo:hi:n' "
                    "(n points, endpoints included; default 1.5:3.0:8 brackets the "
                    "Onsager critical point T~2.269)")
    sw.add_argument("--seed", type=int, default=0,
                    help="counter-based PRNG seed shared by every session (the "
                    "temperature is the only thing that varies)")
    sw.add_argument("--density", type=float, default=0.5, help="seeded initial-board density")
    sw.add_argument("--serve-backend", default="cuda", choices=["cuda", "numpy"],
                    help="engine executor: cuda = the card (K6's batch mode; K7's "
                    "under --no-bitpack), numpy = the host oracle")
    sw.add_argument("--capacity", type=int, default=None,
                    help="batch slots (default: one per temperature, so the whole "
                    "grid runs as one batch)")
    sw.add_argument("--chunk-steps", type=int, default=16)
    sw.add_argument("--sync-pump", action="store_true",
                    help="host-synchronous rounds instead of the pipelined pump "
                    "(same semantics as `serve --sync-pump`)")
    sw.add_argument("--no-bitpack", action="store_true",
                    help="sweep on the int8 roll engine instead of the default "
                    "packed Metropolis path — bit-identical, the packed path's oracle")
    sw.add_argument("--stencil", default="auto", choices=["auto", "roll", "matmul"],
                    help="neighbour-counting path of the plain-op engines (stochastic "
                    "keys take none)")
    sw.add_argument("--memory-budget-bytes", type=int, default=None, metavar="BYTES",
                    help="admission memory budget for estimated engine footprints "
                    "(default: devices x per-kind default; 0 disables)")
    sw.add_argument("--engine-max-restarts", type=int, default=3, metavar="N",
                    help="in-place engine recoveries per compile key")
    sw.add_argument("--settle-deadline", type=float, default=None, metavar="SECONDS",
                    help="wedge watchdog of the pipelined settle window")
    sw.add_argument("--mesh-devices", type=int, default=0, metavar="N",
                    help="mega-board tier slice (stochastic sessions are never placed there)")
    sw.add_argument("--output-dir", default=None, metavar="DIR",
                    help="also write each final lattice to DIR/<session-id>.txt "
                    "(contract board format)")
    sw.add_argument("--metrics-file", default=None, metavar="JSONL",
                    help="append per-round serve metrics as JSON lines")
    sw.add_argument("--device", default=None,
                    help="the device of the device engines (default: the card); "
                    "'cpu' runs their plain PyTorch versions")
    sw.add_argument("--verbose", "-v", action="store_true")


def _submit(args) -> int:
    """Append one request line to the serve spool, the JAX ``submit``'s
    line.  Geometry falls back to the contract config file exactly like
    ``run``; fully flag-specified geometry with no input file queues a
    seeded random board."""
    import json
    from pathlib import Path

    height = args.height if args.height is not None else args.size
    width = args.width if args.width is not None else args.size
    if (
        height is not None
        and width is not None
        and args.steps is not None
        and not Path(args.input_file).exists()
    ):
        # a seeded request: the line carries no input_file; `serve` stages
        # the seed's board
        steps = args.steps
        req = {"height": height, "width": width, "steps": steps, "rule": args.rule,
               "seed": args.seed}
        source = f"seeded random board (seed {args.seed})"
    else:
        height, width, steps = RunConfig(
            height=height, width=width, steps=args.steps, config_file=args.config_file,
        ).resolved_geometry()
        req = {"input_file": args.input_file, "height": height, "width": width,
               "steps": steps, "rule": args.rule, "seed": args.seed}
        source = args.input_file
    if args.temperature is not None:
        req["temperature"] = args.temperature
    if args.output_file is not None:
        req["output_file"] = args.output_file
    if args.timeout is not None:
        req["timeout_s"] = args.timeout
    if args.id is not None:
        req["id"] = args.id
    p = Path(args.requests)
    if p.parent != Path("."):
        p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "a") as f:
        f.write(json.dumps(req) + "\n")
        f.flush()
    print(f"queued {source} ({height}x{width}, {steps} steps) -> {p}")
    return 0


def _read_spool(path: str) -> list[dict]:
    import json
    from pathlib import Path

    spool = Path(path)
    if not spool.exists():
        raise FileNotFoundError(
            f"request spool {path!r} not found; queue requests with `submit` first"
        )
    requests = []
    with open(spool) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                requests.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: bad request line: {e}") from e
    return requests


def _stage_request(req: dict, rule, device):
    """A request's board: its input file, or the seed's board, drawn on
    the card by kernel K7 where the service runs on one (the numpy board's
    bytes either way); a continuous rule stages the float board."""
    from tpu_life_torch.io.codec import read_board

    if "input_file" in req:
        return read_board(req["input_file"], req["height"], req["width"])
    seed = int(req.get("seed", 0))
    if rule.continuous:
        from tpu_life_torch.models.lenia import seeded_board as lenia_seeded_board

        return lenia_seeded_board(req["height"], req["width"], seed=seed)
    from tpu_life_torch.mc.prng import seeded_board

    if device is None:
        return seeded_board(req["height"], req["width"], states=rule.states, seed=seed)
    return seeded_board(req["height"], req["width"], states=rule.states, seed=seed,
                        device=device).cpu().numpy()


def _serve(args) -> int:
    """The serving loop: spool in, result boards + one summary JSON line
    out, with the JAX ``serve``'s keys.  Exit 0 when every session
    completed, 1 when any failed, 2 for a stochastic request on a backend
    without the counter-based key schedule (``sharded``, ``tuned``,
    ``stripes``, ``native``)."""
    import json
    from pathlib import Path

    from tpu_life_torch.io.codec import write_board
    from tpu_life_torch import mc
    from tpu_life_torch.models.rules import NotPortedError, get_rule
    from tpu_life_torch.runtime.metrics import configure_logging
    from tpu_life_torch.serve import (
        InsufficientMemory,
        QueueFull,
        ServeConfig,
        SessionState,
        SimulationService,
    )
    from tpu_life_torch.serve.engine import check_backend

    configure_logging(args.verbose)
    requests = _read_spool(args.requests)
    try:
        check_backend(args.serve_backend)
        for req in requests:
            rule = get_rule(req.get("rule", "conway"))
            if rule.stochastic:
                mc.require_key_schedule(rule, args.serve_backend)
    except (NotPortedError, mc.StochasticBackendError) as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 2
    svc = SimulationService(
        ServeConfig(
            capacity=args.capacity,
            chunk_steps=args.chunk_steps,
            max_queue=args.max_queue,
            backend=args.serve_backend,
            device=args.device,
            pipeline=not args.sync_pump,
            default_timeout_s=args.timeout,
            metrics=True,
            metrics_file=args.metrics_file,
            profile=args.profile,
            trace_events=args.trace_events,
            prom_file=args.prom_file,
            spill_dir=args.spill_dir,
            spill_every=args.spill_every,
            mc_packed=not args.no_bitpack,
            stencil=args.stencil,
            memory_budget_bytes=args.memory_budget_bytes,
            mesh_devices=args.mesh_devices,
            engine_max_restarts=args.engine_max_restarts,
            settle_deadline_s=args.settle_deadline,
        )
    )
    # seeded boards are drawn on the card when the engines run there
    stage_on = None
    if args.serve_backend not in ("numpy", "stripes", "native") and (
            args.device is None or args.device.startswith("cuda")):
        stage_on = args.device or "cuda"
    submitted: list[tuple[str, dict]] = []
    rejected: list[dict] = []
    try:
        for req in requests:
            board = _stage_request(req, get_rule(req.get("rule", "conway")), stage_on)
            sid = None
            while True:
                try:
                    sid = svc.submit(
                        board,
                        req.get("rule", "conway"),
                        int(req["steps"]),
                        timeout_s=req.get("timeout_s"),
                        seed=req.get("seed"),
                        temperature=req.get("temperature"),
                    )
                    break
                except QueueFull:
                    # a well-behaved client of its own service: pump until
                    # the bounded queue takes the next request
                    svc.pump()
                except InsufficientMemory as e:
                    rejected.append({"session": None, "id": req.get("id"), "state": "rejected",
                                     "error": f"{type(e).__name__}: {e}"})
                    break
            if sid is not None:
                submitted.append((sid, req))
        svc.drain()
    finally:
        # a failed serve still flushes its telemetry
        svc.close()

    out_dir = Path(args.output_dir)
    failures = list(rejected)
    written = 0
    for sid, req in submitted:
        view = svc.poll(sid)
        if view.state is SessionState.DONE:
            out = Path(req.get("output_file") or out_dir / f"{sid}.txt")
            out.parent.mkdir(parents=True, exist_ok=True)
            write_board(out, view.result)
            written += 1
        else:
            failures.append({"session": sid, "id": req.get("id"), "state": view.state.value,
                             "error": view.error})
    stats = svc.stats()
    print(
        json.dumps(
            {
                "mode": "serve",
                "run_id": stats["run_id"],
                "backend": args.serve_backend,
                "pump": stats["pump"],
                "device_idle_s": stats["device_idle_seconds"],
                "capacity": args.capacity,
                "chunk_steps": args.chunk_steps,
                "sessions": len(submitted),
                "done": stats["done"],
                "failed": stats["failed"],
                "written": written,
                "rounds": stats["rounds"],
                "elapsed_s": stats["elapsed_s"],
                "sessions_per_sec": stats["sessions_per_sec"],
                "batch_occupancy_mean": stats["batch_occupancy_mean"],
                "queue_wait_p50": stats["queue_wait_p50"],
                "queue_wait_p95": stats["queue_wait_p95"],
                "completion_p50": stats["completion_p50"],
                "rejections": stats["rejections"],
                "failures": failures,
            }
        )
    )
    return 0 if not failures else 1


def _parse_temps(parser, spec: str) -> list[float]:
    """'T1,T2,...' or 'lo:hi:n' -> temperature grid, loudly on malformation."""
    spec = spec.strip()
    try:
        if ":" in spec:
            lo_s, hi_s, n_s = spec.split(":")
            lo, hi, n = float(lo_s), float(hi_s), int(n_s)
            if n < 1:
                raise ValueError
            if n == 1:
                return [lo]
            return [lo + (hi - lo) * i / (n - 1) for i in range(n)]
        temps = [float(t) for t in spec.split(",") if t.strip()]
        if not temps:
            raise ValueError
        return temps
    except ValueError:
        parser.error(
            f"--temps must be 'T1,T2,...' or 'lo:hi:n', got {spec!r}"
        )


def _sweep(parser, args) -> int:
    """The temperature-sweep front (the JAX ``sweep``): N ising sessions —
    same seed, same board, one temperature each — through the
    continuous-batching service, magnetization per temperature out as one
    JSON line with the JAX record's keys.  The whole grid shares ONE
    CompileKey (temperature rides per slot), which the summary's
    ``compile_counts`` lets scripts assert.  Exit 0 when every session
    completed, 1 when any failed, 2 for a bad grid or lattice or a grid
    the memory budget cannot hold."""
    import json
    from pathlib import Path

    from tpu_life_torch import mc
    from tpu_life_torch.models.rules import get_rule, validate_rule_geometry
    from tpu_life_torch.runtime.metrics import configure_logging
    from tpu_life_torch.serve import (
        InsufficientMemory,
        QueueFull,
        ServeConfig,
        SessionState,
        SimulationService,
    )

    configure_logging(args.verbose)
    height = args.height if args.height is not None else args.size
    width = args.width if args.width is not None else args.size
    if height is None or width is None:
        parser.error("sweep needs --size (or --height/--width)")
    temps = _parse_temps(parser, args.temps)
    rule = get_rule(args.rule)
    try:
        # the lattice contract before the board is staged: odd ising
        # dimensions and the PRNG counter width's area cap exit 2 here (the
        # service re-checks at submit with the same capability)
        mc.validate_board_shape(
            rule, (height, width),
            wide_counter=mc.wide_counter_capable(rule, args.serve_backend,
                                                 bitpack=not args.no_bitpack),
        )
        validate_rule_geometry(rule, (height, width))
    except ValueError as e:
        parser.error(str(e))
    # the seeded board is drawn on the card when the engines run there
    stage_on = None
    if args.serve_backend != "numpy" and (args.device is None or args.device.startswith("cuda")):
        stage_on = args.device or "cuda"
    board = mc.seeded_board(height, width, args.density, states=rule.states, seed=args.seed,
                            device=stage_on)
    if stage_on is not None:
        board = board.cpu().numpy()
    capacity = args.capacity if args.capacity is not None else len(temps)
    svc = SimulationService(
        ServeConfig(
            capacity=capacity,
            chunk_steps=args.chunk_steps,
            max_queue=max(64, len(temps)),
            backend=args.serve_backend,
            device=args.device,
            pipeline=not args.sync_pump,
            metrics=bool(args.metrics_file),
            metrics_file=args.metrics_file,
            mc_packed=not args.no_bitpack,
            stencil=args.stencil,
            memory_budget_bytes=args.memory_budget_bytes,
            mesh_devices=args.mesh_devices,
            engine_max_restarts=args.engine_max_restarts,
            settle_deadline_s=args.settle_deadline,
        )
    )
    try:
        sids: list[str] = []
        for t in temps:
            while True:
                try:
                    sids.append(svc.submit(board, rule, args.steps, seed=args.seed,
                                           temperature=t))
                    break
                except QueueFull:
                    svc.pump()
                except InsufficientMemory as e:
                    # the whole grid shares one CompileKey: if it cannot fit
                    # the budget, no session of this sweep ever can — a typed
                    # refusal before any work runs (finally closes the service)
                    print(f"sweep: {e}", file=sys.stderr)
                    return 2
        svc.drain()
        # before close: close() releases idle engines, and compile_counts
        # lives on them
        stats = svc.stats()
    finally:
        svc.close()

    out_dir = Path(args.output_dir) if args.output_dir else None
    sessions = []
    failures = 0
    for sid, t in zip(sids, temps):
        view = svc.poll(sid)
        entry = {"session": sid, "temperature": t, "state": view.state.value,
                 "steps": view.steps_done}
        if view.state is SessionState.DONE:
            entry["magnetization"] = mc.ising.magnetization(view.result)
            if out_dir is not None:
                from tpu_life_torch.io.codec import write_board

                out_dir.mkdir(parents=True, exist_ok=True)
                write_board(out_dir / f"{sid}.txt", view.result)
        else:
            entry["error"] = view.error
            failures += 1
        sessions.append(entry)
    print(json.dumps({
        "mode": "sweep",
        "run_id": stats["run_id"],
        "rule": rule.name,
        "seed": args.seed,
        "height": height,
        "width": width,
        "steps": args.steps,
        "backend": args.serve_backend,
        "capacity": capacity,
        "sessions": sessions,
        "done": stats["done"],
        "failed": stats["failed"],
        "rounds": stats["rounds"],
        "elapsed_s": stats["elapsed_s"],
        "compile_counts": stats["compile_counts"],
    }))
    return 0 if not failures else 1


def _add_front_door_parsers(sub) -> None:
    """``gateway``, ``spill-store``, ``client`` and ``stats`` with the JAX
    package's flags, defaults, JSON lines and exit codes; the gateway's
    ``--device`` takes the place of ``--platform`` and its
    ``--serve-backend`` takes the port's names (default ``cuda``)."""
    gw = sub.add_parser(
        "gateway",
        help="HTTP front door over the batched simulation service: JSON "
        "API with rate limiting, load shedding and graceful drain",
    )
    gw.add_argument("--host", default="127.0.0.1")
    gw.add_argument("--port", type=int, default=8000,
                    help="listen port (0 = ephemeral; the bound port is "
                    "printed in the startup JSON line)")
    gw.add_argument("--capacity", type=int, default=8, help="batch slots per compile key")
    gw.add_argument("--chunk-steps", type=int, default=16,
                    help="device steps per scheduling round")
    gw.add_argument("--max-queue", type=int, default=64,
                    help="bounded admission queue (backpressure threshold)")
    gw.add_argument("--serve-backend", default="cuda", choices=SERVE_BACKEND_CHOICES,
                    help="engine executor (same semantics as `serve --serve-backend`)")
    gw.add_argument("--sync-pump", action="store_true",
                    help="host-synchronous rounds instead of the pipelined "
                    "pump (same semantics as `serve --sync-pump`)")
    gw.add_argument("--no-bitpack", action="store_true",
                    help="pin stochastic (ising) batches to the int8 roll "
                    "engines (same semantics as `serve --no-bitpack`)")
    gw.add_argument("--stencil", default="auto", choices=["auto", "roll", "matmul"],
                    help="neighbour-counting path of the plain-op engines")
    gw.add_argument("--timeout", type=float, default=None, metavar="SECONDS",
                    help="default per-request deadline")
    gw.add_argument("--spill-dir", default=None, metavar="DIR",
                    help="durable sessions: spill live sessions here so they "
                    "can be resumed after a kill")
    gw.add_argument("--spill-every", type=int, default=4, metavar="K",
                    help="rounds between spill passes")
    gw.add_argument("--spill-url", default=None, metavar="URL",
                    help="remote spill store: spill through this `spill-store` "
                    "HTTP store instead of a local directory, so a migrator "
                    "on another machine can read the rescue; mutually "
                    "exclusive with --spill-dir")
    gw.add_argument("--spill-namespace", default=None, metavar="NAME",
                    help="this worker incarnation's namespace in the remote "
                    "store (default: the run_id)")
    gw.add_argument("--register", default=None, metavar="URL",
                    help="wire registration with a fleet control plane: POST "
                    "the startup line to URL, keep a heartbeat-renewed lease, "
                    "spill under the namespace each grant names")
    gw.add_argument("--standby", action="store_true",
                    help="with --register: park in the control plane's "
                    "standby pool until its autoscaler recruits this worker")
    gw.add_argument("--qos", default=None, metavar="FILE",
                    help="tenant QoS policy: a JSON or TOML file of per-tenant "
                    "quotas, weights and tiers (X-API-Key names the tenant)")
    gw.add_argument("--spill-replicas", type=int, default=1, metavar="N",
                    help="replicated spill: fan every --spill-dir write "
                    "through N replica stores (local-directory spill only)")
    gw.add_argument("--memory-budget-bytes", type=int, default=None, metavar="BYTES",
                    help="admission memory budget for estimated engine footprints "
                    "(default: devices x per-kind default; 0 disables)")
    gw.add_argument("--engine-max-restarts", type=int, default=3, metavar="N",
                    help="in-place engine recoveries per compile key")
    gw.add_argument("--settle-deadline", type=float, default=None, metavar="SECONDS",
                    help="wedge watchdog: a pipelined settle window still blocked "
                    "after this many seconds makes /readyz answer 500")
    gw.add_argument("--mesh-devices", type=int, default=0, metavar="N",
                    help="mega-board tier slice (0 = tier off; needs >= 2)")
    gw.add_argument("--api-rate", type=float, default=0.0, metavar="TOKENS/S",
                    help="per-API-key token-bucket refill rate; 0 disables "
                    "rate limiting (the X-API-Key header names the key)")
    gw.add_argument("--api-burst", type=float, default=10.0,
                    help="token-bucket capacity (max burst per key)")
    gw.add_argument("--shed-high-water", type=float, default=None, metavar="DEPTH",
                    help="queue-depth load-shedding threshold (default: "
                    "80%% of --max-queue; 0 disables)")
    gw.add_argument("--max-body", type=int, default=None, metavar="BYTES",
                    help="request-body size bound (413 past it)")
    gw.add_argument("--metrics-file", default=None, metavar="JSONL",
                    help="append per-round serve metrics as JSON lines")
    gw.add_argument("--prom-file", default=None, metavar="FILE",
                    help="atomically rewrite a Prometheus text snapshot "
                    "every scheduling round")
    gw.add_argument("--trace-events", default=None, metavar="FILE",
                    help="write Chrome trace-event JSON for the serve rounds")
    gw.add_argument("--series-every", type=float, default=1.0, metavar="SECONDS",
                    help="metric time-series sampling cadence (GET "
                    "/v1/debug/series?cursor=); 0 disables the ring")
    gw.add_argument("--device", default=None,
                    help="the device of the device engines (default: the card); "
                    "'cpu' runs their plain PyTorch versions")
    gw.add_argument("--verbose", "-v", action="store_true")

    ss = sub.add_parser(
        "spill-store",
        help="host a remote spill store: a CRC-checked, atomically-published "
        "HTTP object store workers spill through and migrators read "
        "rescues from (torch-free)",
    )
    ss.add_argument("--root", required=True, metavar="DIR",
                    help="directory the store publishes namespaces under")
    ss.add_argument("--host", default="127.0.0.1")
    ss.add_argument("--port", type=int, default=0,
                    help="listen port (0 = ephemeral; the bound port is "
                    "printed in the startup JSON line)")
    ss.add_argument("--verbose", "-v", action="store_true")

    cl = sub.add_parser(
        "client",
        help="talk to a running gateway: submit boards, poll, fetch "
        "results, cancel (torch-free; retries 429/503 with backoff)",
    )
    cl.add_argument("action", choices=["submit", "poll", "result", "cancel", "health"])
    cl.add_argument("--url", default="http://127.0.0.1:8000", help="gateway base URL")
    cl.add_argument("--api-key", default=None,
                    help="sent as X-API-Key (the rate-limiting identity)")
    cl.add_argument("--session", default=None, metavar="SID",
                    help="session id for poll/result/cancel")
    cl.add_argument("--input-file", default=None, metavar="BOARD",
                    help="contract-format board to submit inline (geometry "
                    "from --height/--width or --config-file)")
    cl.add_argument("--config-file", default="grid_size_data.txt",
                    help="geometry fallback when --input-file is used "
                    "without explicit --height/--width/--steps")
    cl.add_argument("--size", type=int, default=None,
                    help="square seeded board: submit with no input file "
                    "at all (the server seeds it)")
    cl.add_argument("--height", type=int, default=None)
    cl.add_argument("--width", type=int, default=None)
    cl.add_argument("--steps", type=int, default=None)
    cl.add_argument("--rule", default="conway")
    cl.add_argument("--seed", type=int, default=None, help="seed for a server-seeded board")
    cl.add_argument("--density", type=float, default=None)
    cl.add_argument("--temperature", type=float, default=None, metavar="T",
                    help="Metropolis temperature for --rule ising")
    cl.add_argument("--timeout", type=float, default=None, metavar="SECONDS",
                    help="per-request deadline submitted with the session")
    cl.add_argument("--wait", action="store_true",
                    help="submit: block (polling) until the session is "
                    "terminal; with --output-file also fetch the result")
    cl.add_argument("--output-file", default=None,
                    help="result: write the board in contract format "
                    "(default: RLE to stdout)")
    cl.add_argument("--format", default="rle", choices=["rle", "raw"],
                    help="result payload encoding when printing")
    cl.add_argument("--retries", type=int, default=4,
                    help="retry budget for 429/503/unreachable responses")

    st = sub.add_parser(
        "stats",
        help="summarize a metrics JSONL file (run or serve): throughput "
        "aggregates, histogram quantiles, occupancy, rejection rate (torch-free)",
    )
    st.add_argument("metrics_file", metavar="JSONL", nargs="+",
                    help="sink(s) written by `run --metrics-file`, `serve "
                    "--metrics-file` or `gateway --metrics-file`; several "
                    "files merge keyed by run_id into one report")
    st.add_argument("--json", action="store_true",
                    help="emit the summary as one JSON object instead of the human table")
    st.add_argument("--watch", type=float, default=None, metavar="SECONDS",
                    help="re-read and re-render every N seconds (the `top` "
                    "refresh loop) until ^C")


def _stats(args) -> int:
    """The read-back half of the telemetry loop: ingest metrics JSONL
    sinks — run chunks, serve rounds, registry snapshot records in any
    mix — and report the aggregates, as the JAX ``stats`` does.  With
    ``--watch`` the same pass re-runs every N seconds on ``top``'s
    refresh loop (the sinks are append-only, so a re-read is the live
    view)."""
    import json

    from tpu_life_torch.obs import stats as obs_stats

    def summarize_once():
        records = []
        for i, path in enumerate(args.metrics_file):
            for rec in obs_stats.load_records(path):
                # sink provenance: one file = one worker across ALL its
                # restarts (each a fresh run_id)
                rec.setdefault("_sink", i)
                records.append(rec)
        summary = obs_stats.summarize(records)
        return json.dumps(summary) if args.json else obs_stats.render(summary)

    if args.watch is None:
        print(summarize_once())
        return 0
    from tpu_life_torch.obs import console

    return console.refresh_loop(summarize_once, args.watch)


def _spill_store(args) -> int:
    """Host the remote spill store until SIGTERM/SIGINT: one JSON line at
    startup (the bound URL), one at shutdown."""
    import json
    import signal
    import threading

    from tpu_life_torch.runtime.metrics import configure_logging
    from tpu_life_torch.serve.spill_http import SpillHTTPServer

    configure_logging(args.verbose)
    server = SpillHTTPServer(args.root, host=args.host, port=args.port)
    server.start()
    print(json.dumps({"mode": "spill-store", "url": server.url, "root": str(server.root)}),
          flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, frame: stop.set())
    stop.wait()
    server.close()
    print(json.dumps({"mode": "spill-store", "stopped": True}), flush=True)
    return 0


def _client(parser, args) -> int:
    """The CLI face of ``tpu_life_torch.gateway.client``: one JSON line per
    action, boards in contract format or RLE."""
    import json
    from pathlib import Path

    from tpu_life_torch.gateway.client import GatewayClient, GatewayError

    client = GatewayClient(args.url, api_key=args.api_key, retries=args.retries)

    def need_session() -> str:
        if args.session is None:
            parser.error(f"client {args.action} needs --session SID")
        return args.session

    try:
        if args.action == "health":
            print(json.dumps({"health": client.healthz(), "ready": _ready(client)}))
            return 0
        if args.action == "poll":
            print(json.dumps(client.poll(need_session())))
            return 0
        if args.action == "cancel":
            sid = need_session()
            print(json.dumps({"session": sid, "cancelled": client.cancel(sid)}))
            return 0
        if args.action == "result":
            return _client_result(args, client, need_session())
        if args.steps is None:
            parser.error("client submit needs --steps")
        kwargs: dict = dict(rule=args.rule, steps=args.steps, timeout_s=args.timeout)
        if args.temperature is not None:
            kwargs["temperature"] = args.temperature
        if args.seed is not None:
            # a stochastic rule's trajectory is named by (board, seed,
            # temperature), inline boards too
            kwargs["seed"] = args.seed
        if args.input_file is not None:
            from tpu_life_torch.io.codec import read_board

            height, width, _ = RunConfig(
                height=args.height if args.height is not None else args.size,
                width=args.width if args.width is not None else args.size,
                steps=args.steps,
                config_file=args.config_file,
            ).resolved_geometry()
            kwargs["board"] = read_board(args.input_file, height, width)
        else:
            if args.size is None and (args.height is None or args.width is None):
                parser.error(
                    "client submit needs --input-file, or --size (or "
                    "--height/--width) for a server-seeded board"
                )
            kwargs.update(size=args.size, height=args.height, width=args.width,
                          seed=args.seed, density=args.density)
        sid = client.submit(**kwargs)
        if not args.wait:
            print(json.dumps(client.poll(sid)))
            return 0
        view = client.wait(sid)
        print(json.dumps(view))
        if view["state"] != "done":
            return 1
        if args.output_file is not None:
            from tpu_life_torch.io.codec import write_board

            out = Path(args.output_file)
            out.parent.mkdir(parents=True, exist_ok=True)
            write_board(out, client.result_board(sid))
        return 0
    except GatewayError as e:
        print(json.dumps({"error": {"code": e.code, "message": e.message}, "status": e.status}))
        return 1


def _ready(client) -> bool:
    from tpu_life_torch.gateway.client import GatewayClient, GatewayError

    # readiness is a yes/no — probe with a zero-retry client so a draining
    # gateway answers False immediately instead of after the retry budget
    probe = GatewayClient(client.base_url, api_key=client.api_key, retries=0)
    try:
        probe.readyz()
        return True
    except GatewayError:
        return False


def _client_result(args, client, sid: str) -> int:
    import json
    from pathlib import Path

    from tpu_life_torch.io.codec import write_board

    if args.output_file is not None:
        board = client.result_board(sid)
        out = Path(args.output_file)
        out.parent.mkdir(parents=True, exist_ok=True)
        write_board(out, board)
        h, w = board.shape
        print(f"wrote {out} ({h}x{w})")
        return 0
    payload = client.result(sid, fmt=args.format)
    if args.format == "rle":
        print(payload["rle"], end="")
    else:
        print(json.dumps(payload))
    return 0


def _gateway(args) -> int:
    """The network front door: serve the HTTP API until SIGTERM/SIGINT,
    then drain gracefully — stop admitting, finish in-flight sessions,
    flush telemetry — and exit 0 (1 after a pump crash, 2 on a bad
    config).  One JSON line at startup (bound URL, run_id, the service's
    devices and their kind), one summary line after the drain: the JAX
    ``gateway``'s lines."""
    import json

    from tpu_life_torch import chaos
    from tpu_life_torch.gateway import Gateway, GatewayConfig
    from tpu_life_torch.gateway.protocol import MAX_BODY
    from tpu_life_torch.runtime.metrics import configure_logging, log
    from tpu_life_torch.serve import ServeConfig, SimulationService

    configure_logging(args.verbose)
    if args.standby and args.register is None:
        print(
            "gateway: --standby needs --register (the standby pool is a "
            "control-plane concept)",
            file=sys.stderr,
        )
        return 2
    qos = None
    if args.qos is not None:
        from tpu_life_torch.serve.qos import QosPolicy

        try:
            qos = QosPolicy.load(args.qos)
        except (OSError, ValueError) as e:
            # typed, before any socket or engine exists
            print(f"gateway: bad --qos: {e}", file=sys.stderr)
            return 2
    try:
        svc = SimulationService(
            ServeConfig(
                capacity=args.capacity,
                chunk_steps=args.chunk_steps,
                max_queue=args.max_queue,
                backend=args.serve_backend,
                device=args.device,
                pipeline=not args.sync_pump,
                default_timeout_s=args.timeout,
                metrics=True,
                metrics_file=args.metrics_file,
                trace_events=args.trace_events,
                prom_file=args.prom_file,
                spill_dir=args.spill_dir,
                spill_every=args.spill_every,
                spill_url=args.spill_url,
                spill_namespace=args.spill_namespace,
                spill_replicas=args.spill_replicas,
                qos=qos,
                mc_packed=not args.no_bitpack,
                stencil=args.stencil,
                memory_budget_bytes=args.memory_budget_bytes,
                mesh_devices=args.mesh_devices,
                engine_max_restarts=args.engine_max_restarts,
                settle_deadline_s=args.settle_deadline,
                series_every_s=args.series_every,
            )
        )
    except ValueError as e:
        # e.g. --spill-dir with --spill-url: typed, before any socket
        print(f"gateway: {e}", file=sys.stderr)
        return 2
    gw = Gateway(
        svc,
        GatewayConfig(
            host=args.host,
            port=args.port,
            api_rate=args.api_rate,
            api_burst=args.api_burst,
            shed_high_water=args.shed_high_water,
            max_body=args.max_body if args.max_body is not None else MAX_BODY,
            qos=qos,
        ),
    )
    gw.install_signal_handlers()
    gw.start()
    # chaos seam: a worker that is slow out of the gate delays its
    # startup line
    delay = chaos.delay("worker.start_delay")
    if delay > 0:
        import time

        time.sleep(delay)
    startup = {
        "mode": "gateway",
        "url": f"http://{gw.host}:{gw.port}",
        "run_id": svc.run_id,
        "backend": args.serve_backend,
        "capacity": args.capacity,
        "max_queue": args.max_queue,
        "api_rate": args.api_rate,
    }
    # the device probe runs on a background thread; wait a bounded beat
    # for it, so a slow card never holds the startup line back
    info = gw.device_info(wait_s=10.0)
    if info is not None:
        startup["devices"], startup["device_kind"] = info
    print(json.dumps(startup), flush=True)
    registrar = None
    if args.register is not None:
        # wire registration: the startup line above is the registration
        # body; the registrar keeps the lease renewed, rebinds the spill
        # namespace to each grant, and on a lease_expired fence drops the
        # local copies of re-homed sessions (finishing them would
        # double-execute) before re-registering for a fresh generation
        from tpu_life_torch.fleet.membership import Registrar

        def _on_grant(grant: dict) -> None:
            sp = grant.get("spill")
            if isinstance(sp, dict) and sp.get("namespace"):
                try:
                    svc.rebind_spill(str(sp["namespace"]))
                except ValueError as e:
                    log.warning("gateway: cannot rebind spill: %s", e)

        registrar = Registrar(
            args.register,
            self_url=startup["url"],
            run_id=svc.run_id,
            device_info=lambda: gw.device_info(wait_s=0.0),
            on_grant=_on_grant,
            on_fenced=lambda reason: svc.cancel_live(reason),
            standby=args.standby,
        )
        registrar.start()
    try:
        gw.wait()
    finally:
        if registrar is not None:
            registrar.stop()
        gw.close()
    stats = svc.stats()
    print(
        json.dumps(
            {
                "mode": "gateway",
                "run_id": stats["run_id"],
                "pump": stats["pump"],
                "device_idle_s": stats["device_idle_seconds"],
                # a pump crash is a failed serve even though the drain
                # shut everything down tidily — exit 1 below
                "pump_error": str(gw.pump_error) if gw.pump_error else None,
                "sessions": stats["sessions"],
                "done": stats["done"],
                "failed": stats["failed"],
                "cancelled": stats["cancelled"],
                "rejections": stats["rejections"],
                "rounds": stats["rounds"],
                "elapsed_s": stats["elapsed_s"],
                "sessions_per_sec": stats["sessions_per_sec"],
                "batch_occupancy_mean": stats["batch_occupancy_mean"],
                "queue_wait_p50": stats["queue_wait_p50"],
                "completion_p50": stats["completion_p50"],
                # wire membership evidence: how often this worker
                # registered and how often it was fenced
                **(
                    {
                        "registrar": {
                            "registrations": registrar.registrations,
                            "fenced": registrar.fenced_count,
                            "worker": registrar.worker,
                            "generation": registrar.generation,
                        }
                    }
                    if registrar is not None
                    else {}
                ),
            }
        ),
        flush=True,
    )
    return 1 if gw.pump_error else 0


def _device_is_cpu(device: str | None) -> bool:
    """Whether a ``--device`` value names the CPU, read without torch (the
    fleet front stays torch-free)."""
    return device is not None and device.split(":")[0] == "cpu"


def _add_fleet_parsers(sub) -> None:
    """``fleet``, ``chaos``, ``top``, ``trace merge`` and ``doctor`` with the
    JAX package's flags, defaults, JSON lines and exit codes.  ``fleet``'s
    ``--device`` takes the place of ``--platform`` and its
    ``--serve-backend`` takes the port's names (default ``cuda``, workers
    on the card); ``chaos`` defaults to ``--backend cuda`` (JAX: numpy)
    and takes ``--device``."""
    fl = sub.add_parser(
        "fleet",
        help="multi-worker front tier: supervise N gateway worker "
        "subprocesses and route session traffic across them by least "
        "queue depth, with health-checked failover (torch-free)",
    )
    fl.add_argument("--workers", type=int, default=2,
                    help="gateway worker subprocesses to supervise")
    fl.add_argument("--host", default="127.0.0.1")
    fl.add_argument("--port", type=int, default=8000,
                    help="router listen port (0 = ephemeral; the bound port is "
                    "printed in the startup JSON line; workers always bind "
                    "port 0 and are read back)")
    fl.add_argument("--capacity", type=int, default=8,
                    help="batch slots per compile key, per worker")
    fl.add_argument("--chunk-steps", type=int, default=16)
    fl.add_argument("--max-queue", type=int, default=64,
                    help="bounded admission queue per worker")
    fl.add_argument("--serve-backend", default="cuda", choices=SERVE_BACKEND_CHOICES,
                    help="engine executor for every worker (same semantics as "
                    "`gateway --serve-backend`)")
    fl.add_argument("--sync-pump", action="store_true",
                    help="workers run host-synchronous rounds instead of the "
                    "pipelined pump")
    fl.add_argument("--stencil", default="auto", choices=["auto", "roll", "matmul"],
                    help="neighbour-counting path of the workers' plain-op engines")
    fl.add_argument("--spill-dir", default=None, metavar="DIR",
                    help="durable sessions: workers spill live sessions under "
                    "per-generation subdirs here; on worker death the fleet "
                    "resumes the intact spills on a survivor under the same "
                    "session id")
    fl.add_argument("--spill-every", type=int, default=4, metavar="K",
                    help="rounds between worker spill passes")
    fl.add_argument("--spill-url", default=None, metavar="URL",
                    help="remote spill store: workers spill through this "
                    "`spill-store` under per-incarnation namespaces; mutually "
                    "exclusive with --spill-dir")
    fl.add_argument("--site", default="", metavar="PREFIX",
                    help="this control plane's namespace prefix in a shared "
                    "spill store (e.g. 'a-')")
    fl.add_argument("--peer", action="append", default=None, metavar="URL",
                    dest="peers",
                    help="peer control-plane router URL (repeatable): a rescue "
                    "every local survivor refuses is re-homed on a peer")
    fl.add_argument("--lease-ttl", type=float, default=15.0, metavar="SECONDS",
                    help="lease TTL for wire-registered workers (gateway --register)")
    fl.add_argument("--standby", type=int, default=0, metavar="N",
                    help="standby pool: N extra worker slots that stay parked "
                    "until the autoscaler (or a `gateway --standby`) fills them")
    fl.add_argument("--autoscale", action="store_true",
                    help="demand-driven autoscaling over the standby pool, every "
                    "decision a scale.* flight event `doctor --scale` replays")
    fl.add_argument("--scale-min", type=int, default=1, metavar="N",
                    help="autoscale floor of deployed workers")
    fl.add_argument("--scale-max", type=int, default=None, metavar="N",
                    help="autoscale ceiling (default: bounded by the pool)")
    fl.add_argument("--scale-up-depth", type=float, default=4.0, metavar="DEPTH",
                    help="mean queue depth per ready worker that scales up")
    fl.add_argument("--scale-down-depth", type=float, default=0.5, metavar="DEPTH",
                    help="mean queue depth per ready worker at or below which "
                    "the fleet counts as idle")
    fl.add_argument("--scale-idle-grace", type=float, default=10.0, metavar="SECONDS",
                    help="idle this long before any scale-down")
    fl.add_argument("--scale-cooldown-up", type=float, default=5.0, metavar="SECONDS",
                    help="minimum seconds between consecutive scale-ups")
    fl.add_argument("--scale-cooldown-down", type=float, default=30.0, metavar="SECONDS",
                    help="minimum seconds between a scale move and the next "
                    "scale-down")
    fl.add_argument("--qos", default=None, metavar="FILE",
                    help="tenant QoS policy file forwarded to every worker")
    fl.add_argument("--spill-replicas", type=int, default=1, metavar="N",
                    help="replicated spill for every worker; requires --spill-dir")
    fl.add_argument("--memory-budget-bytes", type=int, default=None, metavar="BYTES",
                    help="each worker's admission memory budget")
    fl.add_argument("--engine-max-restarts", type=int, default=3, metavar="N",
                    help="in-place engine recoveries per compile key, per worker")
    fl.add_argument("--settle-deadline", type=float, default=None, metavar="SECONDS",
                    help="each worker's wedge watchdog deadline")
    fl.add_argument("--mesh-devices", type=int, default=0, metavar="N",
                    help="each worker's mega-board tier slice (0 = off)")
    fl.add_argument("--timeout", type=float, default=None, metavar="SECONDS",
                    help="default per-request deadline (per worker)")
    fl.add_argument("--api-rate", type=float, default=0.0, metavar="TOKENS/S",
                    help="per-API-key token bucket, enforced per worker")
    fl.add_argument("--api-burst", type=float, default=10.0)
    fl.add_argument("--metrics-dir", default=None, metavar="DIR",
                    help="per-worker JSONL sinks at DIR/wN.jsonl")
    fl.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="fleet trace collection: per-worker capture files here; "
                    "fuse them with `trace merge DIR`, read a session's journey "
                    "with `doctor DIR --sid SID`")
    fl.add_argument("--series-every", type=float, default=1.0, metavar="SECONDS",
                    help="fleet series collection cadence (0 disables)")
    fl.add_argument("--slo", default=None, metavar="FILE", dest="slo_file",
                    help="declarative SLO specs (JSON or TOML; default: the "
                    "built-in specs)")
    fl.add_argument("--log-dir", default=None, metavar="DIR",
                    help="per-worker stdout+stderr logs at DIR/wN.log "
                    "(default: a fresh temp dir)")
    fl.add_argument("--restart-backoff", type=float, default=0.5, metavar="SECONDS",
                    help="base of the exponential restart backoff")
    fl.add_argument("--max-restarts", type=int, default=5, metavar="N",
                    help="restart a crash-looping worker at most this many times "
                    "(then its circuit breaker opens; 0 = fail fast)")
    fl.add_argument("--probe-interval", type=float, default=0.25, metavar="SECONDS",
                    help="health-check cadence (liveness + /readyz)")
    fl.add_argument("--device", default=None,
                    help="every worker's device (default: the card); 'cpu' runs "
                    "the plain PyTorch versions of the kernels")
    fl.add_argument("--placement", default="none", choices=["auto", "none"],
                    help="per-worker device placement: auto gives each worker a "
                    "disjoint slice of the cards (CUDA_VISIBLE_DEVICES and "
                    "--device); none keeps the shared spawning env")
    fl.add_argument("--devices-per-worker", default=None, metavar="K[,K...]",
                    help="devices per worker for --placement auto: one count, or "
                    "one count per worker")
    fl.add_argument("--total-devices", type=int, default=None, metavar="N",
                    help="how many cards the host has (cuda placement only: the "
                    "torch-free front cannot count them)")
    fl.add_argument("--verbose", "-v", action="store_true")

    ch = sub.add_parser(
        "chaos",
        help="seeded chaos drill: drive a real N-worker fleet under a "
        "deterministic fault schedule and machine-verify the "
        "failure-masking invariants",
    )
    ch.add_argument("--seed", type=int, default=0,
                    help="the chaos seed: the fault and kill schedules are a "
                    "pure function of it")
    ch.add_argument("--workers", type=int, default=2)
    ch.add_argument("--sessions", type=int, default=6,
                    help="deterministic (conway) sessions in the mix")
    ch.add_argument("--ising-sessions", type=int, default=2,
                    help="stochastic (ising) sessions in the mix")
    ch.add_argument("--size", type=int, default=20,
                    help="deterministic board edge (ising runs 16x16)")
    ch.add_argument("--steps", type=int, default=900,
                    help="base step budget; staggered downward per session")
    ch.add_argument("--kills", type=int, default=1,
                    help="drill-driven SIGKILLs of session-owning workers "
                    "(must be 1 with --cross-host)")
    ch.add_argument("--plan", default=None, metavar="JSON",
                    help="chaos point spec as JSON (default: the drill mix)")
    ch.add_argument("--backend", default="cuda", choices=["cuda", "numpy"],
                    help="worker engine executor: cuda = the card's kernels "
                    "(the default; JAX's drill defaults to numpy), numpy = "
                    "the host oracle")
    ch.add_argument("--device", default=None,
                    help="the workers' device (default: the card); 'cpu' runs "
                    "the plain PyTorch versions of the kernels")
    ch.add_argument("--capacity", type=int, default=4)
    ch.add_argument("--chunk-steps", type=int, default=2)
    ch.add_argument("--spill-every", type=int, default=1)
    ch.add_argument("--recovery-bound", type=float, default=60.0, metavar="SECONDS",
                    help="per-kill bound on fleet recovery to full ready strength")
    ch.add_argument("--wait-timeout", type=float, default=180.0, metavar="SECONDS",
                    help="per-session bound on reaching a terminal state")
    ch.add_argument("--workdir", default=None, metavar="DIR",
                    help="where spill/ and logs/ land (default: a fresh temp dir)")
    ch.add_argument("--governor", action="store_true",
                    help="the resource-governor drill: engine.oom + engine.wedge "
                    "armed, workers under the wedge watchdog")
    ch.add_argument("--settle-deadline", type=float, default=1.0, metavar="SECONDS",
                    help="worker wedge-watchdog deadline for --governor")
    ch.add_argument("--surge", action="store_true",
                    help="the autoscaling + tenant-QoS drill: a standby pool and "
                    "an autoscaler ride an admission burst")
    ch.add_argument("--surge-factor", type=int, default=10, metavar="N",
                    help="--surge only: burst size as a multiple of --sessions")
    ch.add_argument("--surge-standby", type=int, default=2, metavar="N",
                    help="--surge only: parked standby slots")
    ch.add_argument("--qos-p99-bound", type=float, default=5.0, metavar="SECONDS",
                    help="--surge only: bound on the guaranteed tenant's "
                    "admission-latency p99")
    ch.add_argument("--stream", action="store_true",
                    help="the live-session stream drill: mid-run edits and live "
                    "watchers through the SIGKILL")
    ch.add_argument("--lenia-sessions", type=int, default=1,
                    help="--stream only: continuous-tier (lenia) sessions")
    ch.add_argument("--watchers", type=int, default=2,
                    help="--stream only: live watchers per session")
    ch.add_argument("--cross-host", action="store_true",
                    help="the two-control-plane drill: two supervisors sharing "
                    "one remote spill store, a wire-registered worker")
    ch.add_argument("--lease-ttl", type=float, default=8.0, metavar="SECONDS",
                    help="cross-host drill: the registered worker's lease TTL")
    ch.add_argument("--summary-file", default=None, metavar="JSONL",
                    help="append the drill summary as one JSON line")
    ch.add_argument("--verbose", "-v", action="store_true")

    tp = sub.add_parser(
        "top",
        help="live fleet console over GET /metrics + /healthz: per-worker "
        "throughput, queue depth, governor bytes, SLO burn (torch-free)",
    )
    tp.add_argument("--url", default="http://127.0.0.1:8000",
                    help="fleet router (or single gateway) base URL")
    tp.add_argument("--interval", type=float, default=2.0, metavar="SECONDS",
                    help="refresh cadence")
    tp.add_argument("--once", action="store_true",
                    help="paint one frame and exit (two samples one interval "
                    "apart, so the rates are real)")
    tp.add_argument("--json", action="store_true",
                    help="with --once: emit the view as one JSON object")

    tr = sub.add_parser(
        "trace",
        help="distributed-trace tooling: fuse a fleet capture directory "
        "(`fleet --trace-dir`) into one Perfetto-loadable timeline (torch-free)",
    )
    tr_sub = tr.add_subparsers(dest="trace_command", required=True)
    trm = tr_sub.add_parser(
        "merge",
        help="merge per-worker capture files into one Chrome-trace JSON with "
        "per-worker process tracks and clock offsets applied",
    )
    trm.add_argument("capture_dir", metavar="DIR",
                     help="the `fleet --trace-dir` capture directory")
    trm.add_argument("-o", "--output", default=None, metavar="FILE",
                     help="merged trace path (default: DIR/merged.trace.json)")

    dr = sub.add_parser(
        "doctor",
        help="flight-recorder postmortem: one session's causal journey across "
        "workers from a trace capture, with typed findings (torch-free)",
    )
    dr.add_argument("capture", metavar="CAPTURE",
                    help="a capture directory (`fleet --trace-dir`), a merged "
                    "trace (`trace merge`), or a single written trace file")
    dr.add_argument("--sid", default=None,
                    help="the session id to reconstruct (a fleet sid like "
                    "w0g1-s000003, or a worker-local sid)")
    dr.add_argument("--trace-id", default=None,
                    help="reconstruct by trace id directly")
    dr.add_argument("--max-gap", type=float, default=None, metavar="SECONDS",
                    help="bound on the kill -> resumed-on-survivor gap "
                    "(default 60)")
    dr.add_argument("--json", action="store_true",
                    help="emit the journey report as one JSON object")
    dr.add_argument("--slo", action="store_true",
                    help="SLO postmortem: join every slo.breach to its cause; "
                    "needs no --sid")
    dr.add_argument("--scale", action="store_true",
                    help="autoscaling postmortem: replay the scale.* decisions; "
                    "needs no --sid")


def _trace_merge(args) -> int:
    """Fuse a fleet trace-capture directory into one Perfetto-loadable
    Chrome-trace JSON; prints one JSON line naming the output and its
    shape (events, incarnations, drops)."""
    import json
    from pathlib import Path

    from tpu_life_torch.obs import journey

    try:
        doc = journey.merge_captures(args.capture_dir)
    except (FileNotFoundError, ValueError) as e:
        print(f"trace merge: {e}", file=sys.stderr)
        return 2
    out = args.output or str(Path(args.capture_dir) / "merged.trace.json")
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f)
    workers = doc["otherData"]["workers"]
    print(
        json.dumps(
            {
                "mode": "trace-merge",
                "output": out,
                "events": len(doc["traceEvents"]),
                "incarnations": len(workers),
                "dropped": sum(w.get("dropped", 0) for w in workers.values()),
            }
        )
    )
    return 0


def _doctor(args) -> int:
    """The flight-recorder postmortem: exit 0 when the journey is
    anomaly-free, 1 when an invariant broke, 2 on usage or
    unreadable-capture errors; ``--slo`` and ``--scale`` replay the
    capture-wide breach and scaling postmortems (exit 0 when they ran)."""
    import json

    from tpu_life_torch.obs import journey

    if args.slo and args.scale:
        print("doctor: --slo and --scale are separate postmortems; "
              "pick one", file=sys.stderr)
        return 2
    if args.slo or args.scale:
        try:
            doc = journey.load_merged(args.capture)
        except (FileNotFoundError, ValueError, json.JSONDecodeError) as e:
            print(f"doctor: {e}", file=sys.stderr)
            return 2
        if args.slo:
            from tpu_life_torch.obs import slo as obs_slo

            report, render = obs_slo.slo_report(doc), obs_slo.render_slo_report
        else:
            from tpu_life_torch.fleet.autoscaler import render_scale_report, scale_report

            report, render = scale_report(doc), render_scale_report
        print(json.dumps(report) if args.json else render(report))
        # breaches and scale moves are findings, not failures
        return 0
    if args.sid is None and args.trace_id is None:
        print("doctor: pass --sid or --trace-id", file=sys.stderr)
        return 2
    try:
        doc = journey.load_merged(args.capture)
    except (FileNotFoundError, ValueError, json.JSONDecodeError) as e:
        print(f"doctor: {e}", file=sys.stderr)
        return 2
    kwargs = {}
    if args.max_gap is not None:
        kwargs["max_gap_s"] = args.max_gap
    report = journey.doctor(doc, sid=args.sid, trace_id=args.trace_id, **kwargs)
    print(json.dumps(report) if args.json else journey.render_report(report))
    return 0 if report["ok"] else 1


def _top(args) -> int:
    """The live operator console: scrape the router's merged /metrics +
    /healthz on a refresh loop; ``--once --json`` emits one view."""
    import json
    import time

    from tpu_life_torch.obs import console

    client = console.TopClient(args.url, timeout=max(1.0, args.interval))
    if args.once:
        # two samples one interval apart so the per-second rates are real
        # deltas, not the all-zero first frame
        try:
            client.view()
            time.sleep(min(args.interval, 2.0))
            view = client.view()
        except Exception as e:  # noqa: BLE001 — any scrape failure is exit 2
            print(f"top: {e}", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(view))
        else:
            print(console.render_view(view, color=sys.stdout.isatty()))
        return 0
    if args.json:
        print("top: --json requires --once", file=sys.stderr)
        return 2
    color = sys.stdout.isatty()
    return console.refresh_loop(lambda: console.render_view(client.view(), color=color),
                                args.interval)


def _fleet(args) -> int:
    """The horizontally scaled front tier: supervise N gateway workers
    (``python -m tpu_life_torch gateway``, on the card unless ``--device
    cpu``), route sessions across them, and drain the whole fleet on
    SIGTERM/SIGINT.  One JSON line at startup, one summary line after the
    drain: the JAX ``fleet``'s lines.  Exit 0 on a clean drain, 1 if any
    worker ended with its circuit breaker open (a worker whose kernels fail
    to build or launch dies typed and crash-loops into it), 2 on a bad
    config."""
    import json

    from tpu_life_torch.fleet import Fleet, FleetConfig, WorkerState
    from tpu_life_torch.fleet.placement import PlacementError, parse_devices_per_worker
    from tpu_life_torch.runtime.metrics import configure_logging

    configure_logging(args.verbose)
    worker_args = [
        "--capacity", str(args.capacity),
        "--chunk-steps", str(args.chunk_steps),
        "--max-queue", str(args.max_queue),
        "--serve-backend", args.serve_backend,
        "--api-rate", str(args.api_rate),
        "--api-burst", str(args.api_burst),
    ]
    if args.sync_pump:
        worker_args += ["--sync-pump"]
    if args.stencil != "auto":
        worker_args += ["--stencil", args.stencil]
    if args.memory_budget_bytes is not None:
        worker_args += ["--memory-budget-bytes", str(args.memory_budget_bytes)]
    if args.mesh_devices:
        worker_args += ["--mesh-devices", str(args.mesh_devices)]
    if args.engine_max_restarts != 3:
        worker_args += ["--engine-max-restarts", str(args.engine_max_restarts)]
    if args.settle_deadline is not None:
        worker_args += ["--settle-deadline", str(args.settle_deadline)]
    if args.timeout is not None:
        worker_args += ["--timeout", str(args.timeout)]
    if args.device is not None:
        worker_args += ["--device", args.device]
    if args.verbose:
        worker_args += ["--verbose"]
    # tenant QoS rides to every worker as the policy FILE (validated here
    # so a typo fails before spawn)
    if args.qos is not None:
        from tpu_life_torch.serve.qos import QosPolicy

        try:
            QosPolicy.load(args.qos)
        except (OSError, ValueError) as e:
            print(f"fleet: bad --qos: {e}", file=sys.stderr)
            return 2
        worker_args += ["--qos", args.qos]
    if args.spill_replicas != 1:
        if args.spill_dir is None:
            print(
                "fleet: --spill-replicas needs --spill-dir (replication "
                "is a local-directory spill feature)",
                file=sys.stderr,
            )
            return 2
        worker_args += ["--spill-replicas", str(args.spill_replicas)]
    if args.spill_dir is not None and args.spill_url is not None:
        print(
            "fleet: --spill-dir and --spill-url are mutually exclusive "
            "(a fleet spills locally OR through the remote store)",
            file=sys.stderr,
        )
        return 2
    try:
        if args.placement == "none" and (
            args.devices_per_worker is not None or args.total_devices is not None
        ):
            raise PlacementError(
                "--devices-per-worker/--total-devices have no effect "
                "without --placement auto — pass it explicitly (refusing "
                "to silently keep the shared spawning env)"
            )
        autoscale = None
        if args.autoscale:
            from tpu_life_torch.fleet.autoscaler import AutoscaleConfig

            autoscale = AutoscaleConfig(
                min_workers=args.scale_min,
                max_workers=args.scale_max,
                depth_high=args.scale_up_depth,
                depth_low=args.scale_down_depth,
                idle_grace_s=args.scale_idle_grace,
                cooldown_up_s=args.scale_cooldown_up,
                cooldown_down_s=args.scale_cooldown_down,
            )
        fleet = Fleet(
            FleetConfig(
                workers=args.workers,
                host=args.host,
                port=args.port,
                worker_args=tuple(worker_args),
                metrics_dir=args.metrics_dir,
                log_dir=args.log_dir,
                spill_dir=args.spill_dir,
                spill_every=args.spill_every,
                spill_url=args.spill_url,
                site=args.site,
                peers=tuple(args.peers or ()),
                lease_ttl_s=args.lease_ttl,
                trace_dir=args.trace_dir,
                series_every_s=args.series_every,
                slo_file=args.slo_file,
                standby=args.standby,
                autoscale=autoscale,
                probe_interval_s=args.probe_interval,
                backoff_base_s=args.restart_backoff,
                # the flag counts RESTARTS; the breaker counts consecutive
                # failures, of which the initial crash is the first
                breaker_threshold=args.max_restarts + 1,
                placement=args.placement,
                devices_per_worker=parse_devices_per_worker(
                    args.devices_per_worker, args.workers
                ),
                total_devices=args.total_devices,
                placement_platform="cpu" if _device_is_cpu(args.device) else "cuda",
            )
        )
    except PlacementError as e:
        # a plan that can never come up healthy fails fast and typed,
        # before any worker process exists
        print(json.dumps({"mode": "fleet",
                          "error": {"code": "placement_invalid", "message": str(e)}}),
              flush=True)
        print(f"fleet: placement error: {e}", file=sys.stderr)
        return 2
    except (ValueError, OSError) as e:
        # e.g. a malformed --site prefix or an unreadable --slo file
        print(f"fleet: {e}", file=sys.stderr)
        return 2
    fleet.install_signal_handlers()
    fleet.start()
    print(
        json.dumps(
            {
                "mode": "fleet",
                "url": f"http://{fleet.host}:{fleet.port}",
                "run_id": fleet.run_id,
                "workers": args.workers,
                "backend": args.serve_backend,
                "capacity": args.capacity,
                "max_queue": args.max_queue,
                "log_dir": str(fleet.supervisor.log_dir),
                "placement": args.placement,
                # planned devices per worker (workers overwrite with what
                # their torch init resolved)
                "devices": {w.name: w.devices for w in fleet.supervisor.workers},
            }
        ),
        flush=True,
    )
    try:
        fleet.wait()
    finally:
        fleet.close()
    stats = fleet.stats()
    failed = [name for name, state in stats["workers"].items()
              if state == WorkerState.FAILED.value]
    print(
        json.dumps(
            {
                "mode": "fleet",
                "run_id": stats["run_id"],
                "workers": stats["workers"],
                "generations": stats["generations"],
                "restarts": stats["restarts"],
                "routed": stats["routed"],
                "retries": stats["retries"],
                "sessions_pinned": stats["sessions_pinned"],
                "capacity": stats["capacity"],
                "devices_total": stats["devices_total"],
                **({"migrations": stats["migrations"]} if "migrations" in stats else {}),
                **({"scale": stats["scale"]} if "scale" in stats else {}),
                # a breaker-open worker is a failure even after a tidy drain
                "failed_workers": failed,
            }
        ),
        flush=True,
    )
    return 1 if failed else 0


def _chaos_drill(args) -> int:
    """The seeded chaos drill: a real fleet under a deterministic fault
    schedule, machine-verified invariants, one JSON summary line.  Exit 0
    only when every invariant held; on failure the summary (and a stderr
    line) carries the seed and plan digest that replay the run."""
    import json
    import tempfile

    from tpu_life_torch import chaos
    from tpu_life_torch.chaos.drill import DrillConfig, run_drill
    from tpu_life_torch.runtime.metrics import configure_logging

    configure_logging(args.verbose)
    points = None
    if args.plan is not None:
        try:
            points = json.loads(args.plan)
            if not isinstance(points, dict):
                raise ValueError("plan must be a JSON object of points")
            # validate NOW, typed — before any worker is spawned
            chaos.ChaosPlan(args.seed, points)
        except (ValueError, chaos.ChaosError) as e:
            print(f"chaos: bad --plan: {e}", file=sys.stderr)
            return 2
    if sum((args.governor, args.stream, args.surge)) > 1:
        print("chaos: --governor, --stream and --surge are separate drills; pick one",
              file=sys.stderr)
        return 2
    if args.cross_host:
        if args.governor or args.stream or args.surge:
            print("chaos: --governor/--stream/--surge and --cross-host are "
                  "separate drills; pick one", file=sys.stderr)
            return 2
        return _chaos_cross_host(args, points)
    cfg = DrillConfig(
        seed=args.seed,
        workers=args.workers,
        det_sessions=args.sessions,
        ising_sessions=args.ising_sessions,
        size=args.size,
        steps=args.steps,
        kills=args.kills,
        points=points,
        backend=args.backend,
        device=args.device,
        capacity=args.capacity,
        chunk_steps=args.chunk_steps,
        spill_every=args.spill_every,
        recovery_bound_s=args.recovery_bound,
        wait_timeout_s=args.wait_timeout,
        workdir=args.workdir or tempfile.mkdtemp(prefix="tpu-life-chaos-"),
        summary_file=args.summary_file,
        governor=args.governor,
        settle_deadline_s=args.settle_deadline,
        stream=args.stream,
        lenia_sessions=args.lenia_sessions,
        watchers_per_session=args.watchers,
        surge=args.surge,
        standby=args.surge_standby,
        surge_factor=args.surge_factor,
        qos_p99_bound_s=args.qos_p99_bound,
    )
    if cfg.surge:
        # the surge drill's faults are the scale seams, not SIGKILLs; its
        # session count is trickle + burst, both conway
        cfg.kills = 0
        cfg.ising_sessions = 0
    print(
        json.dumps(
            {
                "mode": "chaos",
                "governor": cfg.governor,
                "stream": cfg.stream,
                "surge": cfg.surge,
                "seed": cfg.seed,
                "workers": cfg.workers,
                "sessions": cfg.det_sessions
                + cfg.ising_sessions
                + (cfg.lenia_sessions if cfg.stream else 0)
                + (cfg.surge_factor * cfg.det_sessions if cfg.surge else 0),
                "kills": cfg.kills,
                "workdir": cfg.workdir,
            }
        ),
        flush=True,
    )
    summary = run_drill(cfg)
    print(json.dumps(summary), flush=True)
    if not summary["ok"]:
        flag = next((f for f, on in ((" --governor", cfg.governor), (" --stream", cfg.stream),
                                     (" --surge", cfg.surge)) if on), "")
        print(
            f"chaos: INVARIANT FAILURE — replay verbatim with: "
            f"{PROG} chaos{flag} --seed {cfg.seed} "
            f"(plan digest {summary['plan_digest']})",
            file=sys.stderr,
        )
        return 1
    return 0


def _chaos_cross_host(args, points) -> int:
    """The two-control-plane leg of ``chaos``: one startup JSON line, one
    summary line, exit 0 only when every invariant held."""
    import json
    import tempfile

    from tpu_life_torch.chaos.crosshost import CrossHostConfig, run_cross_host_drill

    if args.kills != 1:
        print(
            "chaos: the cross-host drill performs exactly one adopter "
            "SIGKILL (--kills must be 1); --kills N is the single-plane "
            "drill's knob",
            file=sys.stderr,
        )
        return 2
    cfg = CrossHostConfig(
        seed=args.seed,
        workers=args.workers,
        det_sessions=args.sessions,
        ising_sessions=args.ising_sessions,
        size=args.size,
        steps=args.steps,
        kills=args.kills,
        points=points,
        backend=args.backend,
        device=args.device,
        capacity=args.capacity,
        chunk_steps=args.chunk_steps,
        spill_every=args.spill_every,
        lease_ttl_s=args.lease_ttl,
        recovery_bound_s=args.recovery_bound,
        wait_timeout_s=args.wait_timeout,
        workdir=args.workdir or tempfile.mkdtemp(prefix="tpu-life-crosshost-"),
        summary_file=args.summary_file,
    )
    print(
        json.dumps(
            {
                "mode": "chaos",
                "cross_host": True,
                "seed": cfg.seed,
                "workers_b": cfg.workers,
                "sessions": cfg.det_sessions + cfg.ising_sessions,
                "lease_ttl_s": cfg.lease_ttl_s,
                "workdir": cfg.workdir,
            }
        ),
        flush=True,
    )
    summary = run_cross_host_drill(cfg)
    print(json.dumps(summary), flush=True)
    if not summary["ok"]:
        print(
            f"chaos: CROSS-HOST INVARIANT FAILURE — replay verbatim with: "
            f"{PROG} chaos --cross-host --seed {cfg.seed} "
            f"(plan digest {summary['plan_digest']})",
            file=sys.stderr,
        )
        return 1
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
