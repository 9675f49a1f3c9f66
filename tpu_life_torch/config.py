"""Run configuration: the reference's 3-int config file plus the flags of
``python -m tpu_life_torch run`` (a subset of ``tpu_life/config.py``, with
its names and defaults)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from tpu_life_torch.io.codec import read_config


@dataclass
class RunConfig:
    # board geometry + steps; None -> taken from config_file
    height: int | None = None
    width: int | None = None
    steps: int | None = None

    # I/O contract files
    config_file: str = "grid_size_data.txt"
    input_file: str = "data.txt"
    output_file: str = "output.txt"

    rule: str = "conway"
    bug_compat: bool = False  # replicate the reference binary's effective B/S2 rule
    # names the board a seeded run stages (height, width and steps from
    # flags and no input file); stamped into RunResult
    seed: int = 0

    # execution
    backend: str = "auto"  # auto | cuda | torch | numpy | sharded
    device: str | None = None  # None = the card; "cpu" runs the plain version
    num_devices: int | None = None  # sharded: shards (None = one per card)
    mesh_shape: tuple[int, int] | None = None  # sharded: rows x cols of shards
    local_kernel: str = "auto"  # sharded: per-shard stepper, auto | torch | cuda
    block_steps: int | None = None  # kernel substeps per launch; None = backend default
    bitpack: bool = True  # False: life-like rules run the int8 path (kernel K2)
    # neighbour-counting path of the torch, numpy and sharded backends:
    # auto | roll | matmul (ops.conv.resolve_stencil); the cuda backend's
    # kernels count with their own sums and ignore it
    stencil: str = "auto"
    sync_every: int = 0  # steps per host sync chunk; 0 = one run

    # aux subsystems (the JAX RunConfig's, with its defaults)
    snapshot_every: int = 0
    snapshot_dir: str = "snapshots"
    # retention: keep only the newest N snapshots (0 = keep all); pruning
    # happens after each successful snapshot publish
    keep_snapshots: int = 0
    resume: str | None = None
    # elastic recovery: on a recoverable device failure mid-run (a
    # RuntimeError from a step: a CUDA error, out of memory, the drill),
    # rebuild the backend and resume from the newest snapshot this run
    # wrote (or the original input when none exists yet), at most this
    # many times.  0 = fail fast
    max_restarts: int = 0
    # fault injection drill: raise a simulated device failure when the run
    # crosses this absolute step, fault_count times in a row (recovery
    # rewinds below fault_at, so the drill re-fires until spent).  0 = off
    fault_at: int = 0
    fault_count: int = 1
    # seconds to wait before each recovery attempt; 0 keeps drills instant
    restart_wait_s: float = 0.0
    profile: str | None = None  # torch.profiler trace directory
    # Chrome trace-event JSON file (Perfetto-loadable): host-phase spans,
    # stamped with the run's correlation id
    trace_events: str | None = None
    verbose: bool = False
    metrics: bool = False  # per-chunk live-cell counts + throughput
    # append each metrics record as a JSON line here (implies metrics)
    metrics_file: str | None = None

    def resolved_geometry(self) -> tuple[int, int, int]:
        """(height, width, steps), reading the config file for any None."""
        h, w, s = self.height, self.width, self.steps
        if h is None or w is None or s is None:
            if not Path(self.config_file).exists():
                raise FileNotFoundError(
                    f"config file {self.config_file!r} not found and geometry "
                    f"not fully specified by flags"
                )
            fh, fw, fs = read_config(self.config_file)
            h = fh if h is None else h
            w = fw if w is None else w
            s = fs if s is None else s
        return h, w, s

    def effective_rule(self) -> str:
        return "reference_bug_compat" if self.bug_compat else self.rule
