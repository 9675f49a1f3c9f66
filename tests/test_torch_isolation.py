"""tpu_life_torch stands alone: it imports neither jax nor tpu_life.

``tests/conftest.py`` loads jax into every test process, so the import
check runs in a subprocess; the AST scan reads every source file of the
package (and ``chip_smoke.py``) for such imports.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_life_torch.backends.base import CudaUnavailableError, get_backend, resolve_device

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "tpu_life_torch"
SOURCES = sorted(PKG.rglob("*.py"))
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in SOURCES
    if p.name != "__main__.py"
)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "tpu_life"


def test_every_module_imports_without_jax_or_tpu_life():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_life'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert len(MODULES) >= 20  # the scan found the package


@pytest.mark.parametrize(
    "path", [*SOURCES, ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT))
)
def test_source_imports_nothing_of_jax_or_tpu_life(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert bad == [], f"{path} imports {bad}"


def test_scan_covers_the_int8_slice():
    # the modules the int8 slice added are among those both checks read
    assert {
        "tpu_life_torch.ops.common",
        "tpu_life_torch.ops.stencil",
        "tpu_life_torch.kernels._build",
        "tpu_life_torch.kernels.int8_tiled",
    } <= set(MODULES)


@pytest.mark.parametrize("name", ["auto", "cuda", "torch"])
def test_card_backends_refuse_to_run_on_the_cpu_unasked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError, match="--device cpu"):
        get_backend(name)
    # asking for the CPU explicitly is the one way onto it
    assert get_backend(name, device="cpu").device == torch.device("cpu")


def test_numpy_backend_needs_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert get_backend("numpy").name == "numpy"


def test_resolve_device_rejects_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        resolve_device("meta")


def test_scan_covers_the_sharded_slice():
    # the modules the sharded slice added are among those both checks read
    assert {
        "tpu_life_torch.parallel",
        "tpu_life_torch.parallel.mesh",
        "tpu_life_torch.parallel.halo",
        "tpu_life_torch.kernels.sharded_stripe",
        "tpu_life_torch.backends.sharded_backend",
    } <= set(MODULES)


def test_scan_covers_the_2d_mesh_slice():
    # kernel K4's wrapper, which the 2-D mesh slice added, is among the
    # modules both checks read
    assert "tpu_life_torch.kernels.sharded_int8" in set(MODULES)
    assert PKG / "kernels" / "sharded_int8.py" in SOURCES


def test_scan_covers_the_k5_slice():
    # kernel K5's wrapper and experiment, and the seeded-board, RLE and
    # pattern copies, which the K5 slice added, are among the modules both
    # checks read
    assert {
        "tpu_life_torch.kernels.conway_block",
        "tpu_life_torch.experiments",
        "tpu_life_torch.experiments.block_bench",
        "tpu_life_torch.mc",
        "tpu_life_torch.mc.prng",
        "tpu_life_torch.io.rle",
        "tpu_life_torch.models.patterns",
    } <= set(MODULES)


def test_scan_covers_the_stripe_sweep():
    # the K1 and K3 sweep of depths and boards (an experiment run on the
    # card) is among the modules both checks read
    assert "tpu_life_torch.experiments.stripe_sweep" in set(MODULES)


def test_scan_covers_the_instruments_slice():
    # the run driver's instruments (obs, metrics, snapshots, recovery,
    # profiling) and the tuned record of bench are among the modules both
    # checks read
    assert {
        "tpu_life_torch.obs",
        "tpu_life_torch.obs.registry",
        "tpu_life_torch.obs.trace",
        "tpu_life_torch.runtime.metrics",
        "tpu_life_torch.runtime.checkpoint",
        "tpu_life_torch.runtime.recovery",
        "tpu_life_torch.runtime.profiling",
        "tpu_life_torch.autotune",
        "tpu_life_torch.autotune.space",
    } <= set(MODULES)


def test_scan_covers_the_conv_and_lenia_slice():
    # the banded-matmul counts and the continuous tier are among the
    # modules both checks read
    assert {"tpu_life_torch.ops.conv", "tpu_life_torch.models.lenia"} <= set(MODULES)


def test_scan_covers_the_streamed_io_and_multi_process_slice():
    # streamed per-shard I/O and the modules of runs across processes are
    # among the modules both checks read
    assert {
        "tpu_life_torch.io.sharded",
        "tpu_life_torch.parallel.mesh",
        "tpu_life_torch.parallel.halo",
        "tpu_life_torch.runtime.driver",
    } <= set(MODULES)


def test_scan_covers_the_stochastic_tier():
    # the mc package and kernels K6 and K7's wrapper are among the modules
    # both checks read (the AST scan and the import in a fresh process)
    assert {
        "tpu_life_torch.mc",
        "tpu_life_torch.mc.prng",
        "tpu_life_torch.mc.ising",
        "tpu_life_torch.mc.noisy",
        "tpu_life_torch.mc.packed",
        "tpu_life_torch.mc.engine",
        "tpu_life_torch.kernels.mc_threefry",
    } <= set(MODULES)
    for path in (*sorted((PKG / "mc").glob("*.py")), PKG / "kernels" / "mc_threefry.py"):
        assert path in SOURCES


def test_scan_covers_the_serving_tier():
    # the serving tier (service, scheduler, engines, spill, streams, the
    # governor), its obs and chaos copies, the device probe and K1's batch
    # mode are among the modules both checks read
    assert {
        "tpu_life_torch.serve",
        "tpu_life_torch.serve.engine",
        "tpu_life_torch.serve.errors",
        "tpu_life_torch.serve.governor",
        "tpu_life_torch.serve.mesh_engine",
        "tpu_life_torch.serve.qos",
        "tpu_life_torch.serve.scheduler",
        "tpu_life_torch.serve.service",
        "tpu_life_torch.serve.sessions",
        "tpu_life_torch.serve.spill",
        "tpu_life_torch.serve.stream",
        "tpu_life_torch.obs.flight",
        "tpu_life_torch.obs.timeseries",
        "tpu_life_torch.chaos",
        "tpu_life_torch.utils.platform",
        "tpu_life_torch.kernels.packed_batch",
    } <= set(MODULES)
    for path in (*sorted((PKG / "serve").glob("*.py")), PKG / "chaos" / "__init__.py"):
        assert path in SOURCES


def test_scan_covers_the_codec_and_autotune_slice():
    # the native codec's loader and binding, the autotuner and the device
    # probe are among the modules both checks read
    assert {
        "tpu_life_torch.utils.nativelib",
        "tpu_life_torch.io.native",
        "tpu_life_torch.utils.platform",
        "tpu_life_torch.autotune",
        "tpu_life_torch.autotune.space",
        "tpu_life_torch.autotune.cost_model",
        "tpu_life_torch.autotune.cache",
        "tpu_life_torch.autotune.runner",
        "tpu_life_torch.experiments.tune_fit",
    } <= set(MODULES)
    for path in sorted((PKG / "autotune").glob("*.py")):
        assert path in SOURCES


def test_the_codec_builds_only_from_the_ports_source():
    # nothing of native/ is loaded: the library is built from csrc/codec.cpp
    # into the package's own build directory
    from tpu_life_torch.io import native
    from tpu_life_torch.kernels import _build
    from tpu_life_torch.utils import nativelib

    assert native.SOURCE == PKG / "csrc" / "codec.cpp"
    assert _build.BUILD_ROOT == PKG / "_build"
    for path in (PKG / "utils" / "nativelib.py", PKG / "io" / "native.py"):
        text = path.read_text()
        assert "NATIVE_DIR" not in text and '"native"' not in text and "make" not in text
    assert nativelib.CXX_FLAGS == ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17")


def test_scan_covers_the_front_door_slice():
    # stats, the gateway, the HTTP spill store, the host backends and their
    # binding are among the modules both checks read
    assert {
        "tpu_life_torch.obs.stats",
        "tpu_life_torch.version",
        "tpu_life_torch.gateway",
        "tpu_life_torch.gateway.errors",
        "tpu_life_torch.gateway.limits",
        "tpu_life_torch.gateway.protocol",
        "tpu_life_torch.gateway.server",
        "tpu_life_torch.gateway.client",
        "tpu_life_torch.serve.spill_http",
        "tpu_life_torch.backends.native_backend",
        "tpu_life_torch.backends.stripes_backend",
        "tpu_life_torch.ops.native_step",
        "tpu_life_torch.utils.threefry",
    } <= set(MODULES)
    for path in sorted((PKG / "gateway").glob("*.py")):
        assert path in SOURCES


def _dead_url() -> str:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


@pytest.mark.parametrize("argv,rc", [
    (["client", "health", "--url", "DEAD", "--retries", "0"], 1),
    (["spill-store", "--help"], 0),
    (["stats", str(ROOT / "tests" / "fixtures" / "metrics_run.jsonl"), "--json"], 0),
    (["stats", str(ROOT / "tests" / "fixtures" / "metrics_run.jsonl")], 0),
])
def test_client_spill_store_and_stats_run_without_torch(argv, rc, tmp_path):
    # they run beside a wedged card: the CLI entry point of each loads no
    # torch (the check runs the real `python -m tpu_life_torch` entry in a
    # fresh process and reads its sys.modules at exit)
    argv = [_dead_url() if a == "DEAD" else a for a in argv]
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['tpu_life_torch', *{argv!r}]\n"
        "try:\n"
        "    runpy.run_module('tpu_life_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code or 0\n"
        "print('TORCH_LOADED', 'torch' in sys.modules, 'RC', rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == f"TORCH_LOADED False RC {rc}"


def test_the_spill_store_serves_without_torch(tmp_path):
    # the store's whole import chain (chaos, the spill contract, the JSON
    # envelope of gateway.server) is torch-free
    code = (
        "import sys\n"
        "from tpu_life_torch.serve.spill_http import SpillHTTPServer, HttpSpillBackend\n"
        "from tpu_life_torch.gateway.client import GatewayClient\n"
        "import numpy as np\n"
        f"srv = SpillHTTPServer({str(tmp_path / 'store')!r}); srv.start()\n"
        "be = HttpSpillBackend(srv.url, 'ns')\n"
        "be.save('s1', np.ones((3, 4), np.int8), 2, rule='conway', steps_total=5, seed=None,"
        " temperature=None, timeout_s=None)\n"
        "srv.close()\n"
        "print('TORCH_LOADED', 'torch' in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "TORCH_LOADED False"


def test_the_stepper_builds_only_from_the_ports_source():
    from tpu_life_torch.ops import native_step

    assert native_step.SOURCE == PKG / "csrc" / "life.cpp"
    for path in (PKG / "ops" / "native_step.py", PKG / "backends" / "native_backend.py"):
        text = path.read_text()
        assert "NATIVE_DIR" not in text and '"native"' not in text.replace(
            '@register_backend("native")', "").replace('name = "native"', "")


@pytest.mark.parametrize("argv", [
    ["gateway", "--port", "0"],
    ["gateway", "--port", "0", "--serve-backend", "numpy"],
])
def test_the_gateway_refuses_to_run_on_the_cpu_unasked(argv, monkeypatch, capsys):
    # the numpy serve backend needs no card; every other one does, unless
    # --device cpu asks for the plain versions
    from tpu_life_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if "numpy" in argv:
        from tpu_life_torch.gateway.server import Gateway

        start = Gateway.start

        def start_then_drain(self):
            start(self)
            self.begin_drain()  # what SIGTERM does: the run ends at once

        monkeypatch.setattr(Gateway, "start", start_then_drain)
        monkeypatch.setattr(Gateway, "install_signal_handlers", lambda self: None)
        assert cli.main([*argv, "--series-every", "0"]) == 0
        capsys.readouterr()
        return
    with pytest.raises(CudaUnavailableError, match="--device cpu"):
        cli.main(argv)


def test_scan_covers_the_fleet_slice():
    # the fleet, the drills and the console tools are among the modules
    # both checks read
    assert {
        "tpu_life_torch.fleet",
        "tpu_life_torch.fleet.errors",
        "tpu_life_torch.fleet.registry",
        "tpu_life_torch.fleet.placement",
        "tpu_life_torch.fleet.balancer",
        "tpu_life_torch.fleet.fanout",
        "tpu_life_torch.fleet.membership",
        "tpu_life_torch.fleet.autoscaler",
        "tpu_life_torch.fleet.supervisor",
        "tpu_life_torch.fleet.router",
        "tpu_life_torch.fleet.migrate",
        "tpu_life_torch.obs.journey",
        "tpu_life_torch.obs.slo",
        "tpu_life_torch.obs.console",
        "tpu_life_torch.chaos.drill",
        "tpu_life_torch.chaos.crosshost",
    } <= set(MODULES)


def test_the_fleet_front_and_top_run_without_torch(tmp_path):
    # the router process pays for no torch: a Fleet built (not started)
    # and top --once's view of a live router, in a fresh process
    code = (
        "import json, sys\n"
        "from tpu_life_torch.fleet import Fleet, FleetConfig\n"
        "from tpu_life_torch.obs import console\n"
        f"fleet = Fleet(FleetConfig(workers=2, port=0, log_dir={str(tmp_path / 'logs')!r}))\n"
        "fleet.router.start()\n"
        "url = f'http://127.0.0.1:{fleet.port}'\n"
        "client = console.TopClient(url)\n"
        "client.view()\n"
        "view = client.view()\n"
        "print(console.render_view(view, color=False))\n"
        "fleet.close()\n"
        "print(json.dumps({'torch': 'torch' in sys.modules, 'jax': 'jax' in sys.modules,\n"
        "                  'rows': sorted(view['workers']), 'states': view['states']}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (got["torch"], got["jax"]) == (False, False)
    assert got["states"] == {"w0": "down", "w1": "down"}


@pytest.mark.parametrize("argv,rc", [
    (["trace", "merge", "CAPTURE"], 0),
    (["doctor", "CAPTURE", "--sid", "w0g1-s000000"], 1),
    (["doctor", "CAPTURE", "--slo", "--json"], 0),
    (["doctor", "CAPTURE", "--scale"], 0),
    (["top", "--url", "DEAD", "--once", "--json"], 2),
    (["fleet", "--help"], 0),
])
def test_trace_doctor_top_and_fleet_run_without_torch(argv, rc, tmp_path):
    capture = tmp_path / "capture"
    capture.mkdir()
    (capture / "control.jsonl").write_text(json.dumps(
        {"worker": "control", "generation": 0, "pid": 1, "run_id": None, "wall_t0": None,
         "offset_s": 0.0, "dropped": 0, "events": [], "flight": [
             {"t": 1.0, "kind": "route.submit", "sid": "w0g1-s000000",
              "worker_sid": "s000000", "trace_id": "0123456789abcdef", "worker": "w0",
              "generation": 1}]}) + "\n")
    argv = [str(capture) if a == "CAPTURE" else _dead_url() if a == "DEAD" else a for a in argv]
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['tpu_life_torch', *{argv!r}]\n"
        "try:\n"
        "    runpy.run_module('tpu_life_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code or 0\n"
        "print('TORCH_LOADED', 'torch' in sys.modules, 'RC', rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == f"TORCH_LOADED False RC {rc}"
