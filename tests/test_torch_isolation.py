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
