"""Runs of the port across processes (``tests/test_distributed.py`` on the
port): ``init_distributed`` joins a job from the environment, the driver
gates single-writer side effects on the lead process, and two real
processes over gloo on localhost run the sharded backend with halos sent
between them and their shards written per process.

The wiring tests run in this process with the rank monkeypatched; the
two-process tests run ``python -m tpu_life_torch run`` twice with the JAX
package's coordinate triple, each child with a hard timeout, behind a
capability probe that skips with its evidence where loopback is blocked.
``partition_mode='gspmd'`` stays refused, and the collective that settles
it is recounted here with ``CommDebugMode``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_life.parallel import mesh as jmesh
from tpu_life_torch import cli
from tpu_life_torch.backends.base import CudaUnavailableError
from tpu_life_torch.backends.sharded_backend import (
    GSPMD_COLLECTIVE,
    GSPMD_PER_STEP,
    PartitionModeRefused,
    ShardedBackend,
)
from tpu_life_torch.config import RunConfig
from tpu_life_torch.io.codec import encode_board, write_board, write_config
from tpu_life_torch.models.rules import get_rule
from tpu_life_torch.ops.reference import run_np
from tpu_life_torch.parallel import mesh
from tpu_life_torch.runtime import driver
from tpu_life_torch.runtime.recovery import InjectedFault

ROOT = Path(__file__).resolve().parent.parent
JOB_VARS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
            "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def no_job(monkeypatch):
    for var in JOB_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(mesh, "_initialized", False)
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    return calls


@pytest.fixture
def workload(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    board = np.random.default_rng(7).integers(0, 2, (40, 33)).astype(np.int8)
    write_board(tmp_path / "data.txt", board)
    write_config(tmp_path / "grid_size_data.txt", 40, 33, 5)
    return tmp_path, board


def _truth(board, steps) -> bytes:
    return encode_board(run_np(board, get_rule("conway"), steps))


# -- init_distributed --------------------------------------------------------


def test_init_distributed_noop_without_env(no_job):
    mesh.init_distributed("cpu")
    mesh.init_distributed()
    assert no_job == [] and mesh.process_count() == 1 and mesh.process_index() == 0
    assert mesh.is_lead()


@pytest.mark.parametrize("env,want", [
    ({"JAX_COORDINATOR_ADDRESS": "host0:8476", "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "2"},
     ("tcp://host0:8476", 4, 2)),
    ({"COORDINATOR_ADDRESS": "host1:9000", "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "0"},
     ("tcp://host1:9000", 2, 0)),
    ({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "WORLD_SIZE": "8", "RANK": "5"},
     ("env://", 8, 5)),
], ids=["jax-triple", "coordinator-address", "torchrun"])
def test_init_distributed_joins_when_env_present(no_job, monkeypatch, env, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mesh.init_distributed("cpu")
    assert no_job == [(("gloo",), dict(init_method=want[0], world_size=want[1], rank=want[2]))]
    # idempotent: the driver calls it on every run, and a process group
    # cannot be started twice
    mesh.init_distributed("cpu")
    assert len(no_job) == 1


def test_incomplete_triple_gives_the_jax_error(no_job, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "host0:8476")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError) as port_err:
        mesh.init_distributed("cpu")
    monkeypatch.setattr(jmesh, "_distributed_initialized", False)
    with pytest.raises(RuntimeError) as jax_err:
        jmesh.init_distributed()
    assert str(port_err.value) == str(jax_err.value)
    assert "JAX_PROCESS_ID" in str(port_err.value) and no_job == []


def test_coordinator_without_a_process_count_is_refused(no_job, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "host0:8476")
    with pytest.raises(RuntimeError, match="no process count"):
        mesh.init_distributed("cpu")
    assert no_job == []


def test_transport_follows_the_device(no_job, monkeypatch):
    # nccl for shards on the cards, and never a silent gloo without a card
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "host0:8476")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError, match="--device cpu"):
        mesh.init_distributed()
    assert no_job == []
    cards = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    mesh.init_distributed()
    assert no_job[0][0] == ("nccl",) and cards == [torch.device("cuda", 1)]


def test_driver_calls_init_distributed(workload, monkeypatch):
    calls = []
    monkeypatch.setattr(driver, "init_distributed", lambda device=None: calls.append(device))
    driver.run(RunConfig(backend="numpy", output_file=""))
    driver.run(RunConfig(backend="sharded", device="cpu", output_file=""))
    assert calls == [None, "cpu"]


# -- the lead process --------------------------------------------------------


def test_lead_process_writes_and_reports(workload, capsys):
    tmp, board = workload
    res = driver.run(RunConfig(backend="sharded", device="cpu", num_devices=2,
                               output_file="out.txt"))
    assert (tmp / "out.txt").read_bytes() == _truth(board, 5)
    assert "Total time =" in capsys.readouterr().out
    assert res.board is not None


def test_non_lead_process_skips_output_and_report(workload, monkeypatch, capsys):
    tmp, _ = workload
    monkeypatch.setattr(driver, "_is_lead_process", lambda: False)
    driver.run(RunConfig(backend="numpy", output_file="out.txt", metrics_file="m.jsonl",
                         trace_events="t.json"))
    assert not (tmp / "out.txt").exists()
    assert "Total time =" not in capsys.readouterr().out
    # the trace file and the metrics sink are lead-only too
    assert not (tmp / "t.json").exists() and not (tmp / "m.jsonl").exists()


@pytest.mark.parametrize("mesh_kw", [dict(num_devices=2), dict(mesh_shape=(2, 2))])
def test_non_lead_process_still_writes_its_shards(workload, monkeypatch, mesh_kw):
    # per-shard streamed output is collective (MPI_File_write_at_all,
    # Parallel_Life_MPI.cpp:175): every process writes the shards it holds,
    # lead or not, and its snapshots too
    tmp, board = workload
    monkeypatch.setattr(driver, "_is_lead_process", lambda: False)
    driver.run(RunConfig(backend="sharded", device="cpu", stream_io=True, output_file="out.txt",
                         snapshot_every=2, **mesh_kw))
    assert (tmp / "out.txt").read_bytes() == _truth(board, 5)
    assert (tmp / "snapshots" / "board_000000004.txt").read_bytes() == _truth(board, 4)
    # the sidecar is a single-writer side effect
    assert not (tmp / "snapshots" / "board_000000004.json").exists()


def test_several_processes_disable_in_process_recovery(workload, monkeypatch):
    tmp, _ = workload
    monkeypatch.setattr(driver, "_single_process", lambda: False)
    warnings = []
    monkeypatch.setattr(driver.log, "warning", lambda msg, *args: warnings.append(msg % args))
    with pytest.raises(InjectedFault):
        driver.run(RunConfig(backend="sharded", device="cpu", num_devices=2, stream_io=True,
                             output_file="out.txt", max_restarts=2, fault_at=3,
                             snapshot_every=2))
    # the JAX driver's warning, and no restart
    assert warnings == ["multi-process job: in-process elastic recovery disabled; on failure, "
                        "relaunch the whole job with --resume snapshots"]
    # in a job of several processes the streamed write goes direct (no
    # rename can publish a file several processes write)
    assert (tmp / "snapshots" / "board_000000002.txt").exists()
    assert not list((tmp / "snapshots").glob("*.tmp*"))


def test_a_gathered_run_across_processes_is_refused_before_staging(workload, monkeypatch):
    monkeypatch.setattr(driver, "_single_process", lambda: False)
    staged = []
    monkeypatch.setattr(ShardedBackend, "prepare", lambda *a: staged.append(a))
    with pytest.raises(ValueError, match="--stream-io"):
        driver.run(RunConfig(backend="sharded", device="cpu", num_devices=2, output_file="out.txt"))
    assert staged == []


def test_a_process_holding_some_shards_cannot_gather(workload):
    # a mesh whose shards 2 and 3 another process owns: this one loads and
    # holds only its own, and gathering the board names --stream-io
    tmp, board = workload
    m = mesh.Mesh((torch.device("cpu"),) * 4, ranks=(0, 0, 1, 1))
    runner = ShardedBackend(mesh=m).prepare_from_file(tmp / "data.txt", 40, 33, get_rule("conway"))
    assert runner.shard_ids == [0, 1] and len(runner.chunks) == 2
    with pytest.raises(ValueError, match="--stream-io"):
        runner.fetch()


def test_process_devices_lay_out_ranks_in_order(monkeypatch):
    monkeypatch.setattr(mesh, "process_count", lambda: 3)
    devices, ranks = mesh.process_devices([torch.device("cpu")] * 2)
    assert ranks == [0, 0, 1, 1, 2, 2] and len(devices) == 6
    m = mesh.make_mesh_2d((2, 3), devices=devices, ranks=ranks)
    assert m.ranks == (0, 0, 1, 1, 2, 2) and [m.is_local(s) for s in range(6)] == [True] * 2 + [False] * 4


# -- gspmd -------------------------------------------------------------------

GSPMD_PROBE = """
import json, sys, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor, Shard
from torch.distributed.tensor.debug import CommDebugMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from tpu_life_torch.ops.stencil import neighbor_counts
out = {}
for ws in (1, 2, 4):
    if ws == 1:  # one real process over gloo
        dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + sys.argv[1], rank=0,
                                world_size=1)
    else:  # ranks of a fake group, all in this process
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=ws)
    x = distribute_tensor(torch.zeros((64, 40), dtype=torch.int8), init_device_mesh("cpu", (ws,)),
                          [Shard(0)])
    for steps in (1, 3):
        with CommDebugMode() as comm:
            y = x
            for _ in range(steps):
                y = (neighbor_counts(y, 1) == 3).to(torch.int8)
        out[f"{ws}x{steps}"] = {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}
    dist.destroy_process_group()
print(json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in JOB_VARS}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_gspmd_refusal_is_backed_by_the_dtensor_collective_count():
    # the plain step on a row-sharded DTensor: no collective on one rank,
    # and on 2 and 4 ranks one whole-board all_gather per step, not a halo
    proc = subprocess.run([sys.executable, "-c", GSPMD_PROBE, str(_free_port())], env=_env(),
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    assert counts["1x1"] == counts["1x3"] == {}
    for ws in (2, 4):
        for steps in (1, 3):
            assert counts[f"{ws}x{steps}"] == {GSPMD_COLLECTIVE: GSPMD_PER_STEP * steps}


def test_cli_exits_2_on_gspmd_naming_the_collective(workload, capsys):
    assert cli.main(["run", "--backend", "sharded", "--device", "cpu", "--partition-mode",
                     "gspmd"]) == 2
    err = capsys.readouterr().err
    assert GSPMD_COLLECTIVE in err and "ROADMAP A6.2" in err
    with pytest.raises(PartitionModeRefused):
        driver.run(RunConfig(backend="sharded", device="cpu", partition_mode="gspmd"))


# -- two real processes over gloo ---------------------------------------------


PROBE = """
import torch, torch.distributed as dist
from tpu_life_torch.parallel import mesh
mesh.init_distributed("cpu")
assert mesh.process_count() == 2
x = torch.full((2, 3), mesh.process_index() + 1, dtype=torch.int8)
y = torch.zeros_like(x)
peer = 1 - mesh.process_index()
for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer), dist.P2POp(dist.irecv, y, peer)]):
    w.wait()
assert int(y[0, 0]) == peer + 1
print("probe-ok", mesh.process_index(), mesh.all_reduce_sum(torch.tensor(1)))
"""


def _two_processes(args: list[str], cwd: Path, timeout: float = 120) -> list[subprocess.CompletedProcess]:
    """Two children with the JAX package's coordinate triple on a free
    localhost port, each killed at ``timeout``."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(_env(), JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
                   JAX_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, *args], cwd=cwd, env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    done = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err += f"\n<killed after {timeout} s>"
            done.append(subprocess.CompletedProcess(p.args, p.returncode, out, err))
    finally:
        for p in procs:
            p.kill()
    return done


@pytest.fixture(scope="session")
def two_process_env(tmp_path_factory):
    """The capability the two-process tests need, probed first with two
    minimal processes (a gloo group over localhost and one exchange):
    where the machine cannot (blocked loopback), the tests skip with the
    probe's evidence instead of failing on machinery this repo does not
    own."""
    done = _two_processes(["-c", PROBE], tmp_path_factory.mktemp("probe"), timeout=60)
    if any(p.returncode != 0 for p in done):
        detail = "; ".join((p.stderr or p.stdout or "<no output>").strip().splitlines()[-1]
                           for p in done)
        pytest.skip(f"two gloo processes on localhost are unusable here (probe: {detail})")


@pytest.mark.parametrize("flags,steps", [
    (["--stream-io"], 6),
    (["--mesh-shape", "2,2", "--no-bitpack", "--stream-io"], 6),
    (["--num-devices", "4", "--stream-io", "--snapshot-every", "4", "--metrics"], 9),
    (["--mesh-shape", "2,2", "--stream-io", "--rule", "conway:T"], 6),
], ids=["rows2", "2x2-int8", "rows4-snapshots", "2x2-torus"])
def test_two_process_run(tmp_path, two_process_env, flags, steps):
    """Two real processes, the reference's ``mpiexec -n 2``: each loads its
    own shards, sends its halos to the other over gloo and writes its own
    shards of output.txt, which must equal the numpy oracle's bytes."""
    board = np.random.default_rng(13).integers(0, 2, (36, 64)).astype(np.int8)
    write_board(tmp_path / "data.txt", board)
    write_config(tmp_path / "grid_size_data.txt", 36, 64, steps)
    done = _two_processes(["-m", "tpu_life_torch", "run", "--backend", "sharded", "--device",
                           "cpu", *flags, "--output-file", "out.txt"], tmp_path)
    for p in done:
        assert p.returncode == 0, p.stderr[-3000:]
    # "Total time =" is lead-gated: exactly one process reports it
    assert sum("Total time =" in p.stdout for p in done) == 1
    rule = get_rule("conway:T" if "conway:T" in flags else "conway")
    assert (tmp_path / "out.txt").read_bytes() == encode_board(run_np(board, rule, steps))
    if "--snapshot-every" in flags:
        assert (tmp_path / "snapshots" / "board_000000008.txt").read_bytes() == encode_board(
            run_np(board, rule, 8))
        # both processes reduce the live count; the lead logs it
        live = int(np.count_nonzero(run_np(board, rule, steps) == 1))
        assert all(f"live={live}" in p.stderr for p in done)


def test_torchrun_launch(tmp_path, two_process_env):
    # torchrun's variables name the same job: two processes, env://
    board = np.random.default_rng(17).integers(0, 2, (30, 50)).astype(np.int8)
    write_board(tmp_path / "data.txt", board)
    write_config(tmp_path / "grid_size_data.txt", 30, 50, 7)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2", "--master-port",
         str(_free_port()), "-m", "tpu_life_torch", "run", "--backend", "sharded", "--device",
         "cpu", "--stream-io", "--output-file", "out.txt"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("Total time =") == 1
    assert (tmp_path / "out.txt").read_bytes() == _truth(board, 7)


EXCHANGE = """
import json, sys, torch
from tpu_life_torch.parallel import halo, mesh
mesh.init_distributed("cpu")
rows, cols, fr, fc = (int(v) for v in sys.argv[1:5])
n = rows * cols
ranks = [s * 2 // n for s in range(n)]
me = mesh.process_index()
chunks = [torch.arange(s * 48, s * 48 + 48, dtype=torch.int8).reshape(6, 8) if ranks[s] == me
          else None for s in range(n)]
tops, bots = halo.exchange_rows(chunks, fr, periodic=False, cols=cols, ranks=ranks)
out = {"tops": {}, "bots": {}, "lefts": {}, "rights": {}}
if cols > 1:
    lefts, rights = halo.exchange_cols(chunks, tops, bots, fc, cols=cols, periodic=False,
                                       ranks=ranks)
for s in range(n):
    if ranks[s] == me:
        out["tops"][s], out["bots"][s] = tops[s].tolist(), bots[s].tolist()
        if cols > 1:
            out["lefts"][s], out["rights"][s] = lefts[s].tolist(), rights[s].tolist()
out["copies"] = [halo.exchange_rows.copies, halo.exchange_cols.copies]
out["sends"] = [halo.exchange_rows.sends, halo.exchange_cols.sends]
print(json.dumps(out))
"""


@pytest.mark.parametrize("grid", [(4, 1), (2, 2), (1, 2)], ids=["rows4", "2x2", "1x2"])
def test_halos_between_processes_equal_one_process(tmp_path, two_process_env, grid):
    """The exchange split over two processes hands every shard the same
    halos as on one; halos between the processes are sends (one a row
    halo, one a column halo of three edges joined), the rest copies."""
    from tpu_life_torch.parallel import halo

    rows, cols = grid
    fr, fc = 2, 3
    done = _two_processes(["-c", EXCHANGE, str(rows), str(cols), str(fr), str(fc)], tmp_path)
    for p in done:
        assert p.returncode == 0, p.stderr[-3000:]
    got = [json.loads(p.stdout.strip().splitlines()[-1]) for p in done]
    n = rows * cols
    chunks = [torch.arange(s * 48, s * 48 + 48, dtype=torch.int8).reshape(6, 8) for s in range(n)]
    tops, bots = halo.exchange_rows(chunks, fr, periodic=False, cols=cols)
    want = {"tops": tops, "bots": bots}
    if cols > 1:
        want["lefts"], want["rights"] = halo.exchange_cols(chunks, tops, bots, fc, cols=cols,
                                                           periodic=False)
    for key, tensors in want.items():
        merged = {**got[0][key], **got[1][key]}
        assert {int(s): v for s, v in merged.items()} == {s: t.tolist() for s, t in enumerate(tensors)}
    # each process owns half the mesh: a halo between the halves is a send
    # (a row halo, or a column halo of three edges joined), every other
    # halo a copy (a column halo in three)
    ranks = [s * 2 // n for s in range(n)]
    row_halos = [(s, s + d * cols) for s in range(n) for d in (-1, 1) if 0 <= s // cols + d < rows]
    col_halos = [(s, s + d) for s in range(n) for d in (-1, 1) if 0 <= s % cols + d < cols]
    cross = [sum(ranks[s] != ranks[t] for s, t in halos) for halos in (row_halos, col_halos)]
    for g in got:
        assert g["sends"] == [cross[0] // 2, cross[1] // 2]
    assert sum(g["copies"][0] for g in got) == len(row_halos) - cross[0]
    assert sum(g["copies"][1] for g in got) == 3 * (len(col_halos) - cross[1])
