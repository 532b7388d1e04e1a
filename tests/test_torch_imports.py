"""The port stands alone: no module of ``multigridmc_tpu_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package."""

import pathlib
import pkgutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

_CHECK = """
import importlib, pkgutil, sys
import multigridmc_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "jaxlib" or m == "multigridmc_tpu" or m.startswith("multigridmc_tpu."))
print(len(names), "modules imported; forbidden:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 37


def test_every_module_of_the_port_is_importable_here():
    """No module needs nvcc, triton or a card at import time."""
    import importlib

    import multigridmc_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    assert "multigridmc_tpu_torch.ops.kernels.mgmc_visit" in names
    # the second slice: the sweep kernels, the solver, the drivers and their utilities
    for name in ("ops.kernels.common", "ops.kernels.sor_sweep", "solvers.cholesky",
                 "solvers.loop", "utils.config", "utils.vtk", "utils.statistics", "qoi",
                 "drivers.common", "drivers.mgmc", "drivers.mg"):
        assert f"multigridmc_tpu_torch.{name}" in names
    # the third slice: the distilled subtree and the subtree kernel
    for name in ("samplers.distill", "ops.kernels.mgmc_subtree"):
        assert f"multigridmc_tpu_torch.{name}" in names


def test_no_source_of_the_port_names_jax():
    """Beyond what gets imported: no line of the port's Python sources imports
    ``jax`` or the JAX package (docstrings may name them as counterparts)."""
    import re

    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|multigridmc_tpu)(?:[.\s]|$)", re.M)
    sources = list((REPO / "multigridmc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) >= 37
    for path in sources:
        assert not pattern.search(path.read_text()), path


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_precision_policy_is_set():
    import torch

    from multigridmc_tpu_torch.utils import runtime

    runtime.configure_runtime()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert runtime.resolve_device("cpu").type == "cpu"
    assert runtime.resolve_dtype(None) is torch.float32
