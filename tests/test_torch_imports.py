"""The port stands alone: it imports neither JAX nor anything of ``repro``,
and its entry points refuse to run on the CPU unless asked to."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.launch import serve, train

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("torch_*.py")))


def test_importing_the_port_loads_no_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest.py)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, n)


def test_serve_without_device_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "yi-6b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_train_without_device_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "yi-6b", "--smoke", "--steps", "1"])


def test_import_checks_cover_the_dist_module():
    """The AST scan and the fresh-interpreter import both reach
    ``core/dist.py`` (the process groups), which imports torch.distributed."""
    assert PORT / "core" / "dist.py" in _port_files()
    code = ("import pkgutil, repro_torch\n"
            "print(' '.join(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert "repro_torch.core.dist" in out.stdout.split(), out.stderr


@pytest.mark.parametrize("module", ["core.pipeline", "core.schedules", "planner.simulator",
                                    "checkpointing.store", "resilience.reshard",
                                    "resilience.faults", "resilience.supervisor", "obs.metrics",
                                    "obs.trace", "obs.drift"])
def test_import_checks_cover_the_pipeline_modules(module):
    """The pipeline's modules, and the run-time services' (the checkpoint
    store, layouts, fault plans, the supervisor and telemetry, whose JAX
    counterparts are partly jax-free: the port keeps its own copies), are in
    both checks: the AST scan reads their files, and the fresh interpreter,
    which imports every module and finds no JAX, walks them."""
    path = PORT.joinpath(*module.split(".")).with_suffix(".py")
    assert path in _port_files()
    code = ("import pkgutil, repro_torch\n"
            "print(' '.join(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert f"repro_torch.{module}" in out.stdout.split(), out.stderr


@pytest.mark.parametrize("world,want", [
    (None, "--mesh 2x2 needs 4 processes: run it under python -m torch.distributed.run "
           "--nproc_per_node 4"),
    ("2", "--mesh 2x2 needs 4 processes, the launcher started 2")])
def test_train_refuses_a_mesh_that_is_not_the_world(monkeypatch, capsys, world, want):
    """A mesh of D x M ranks needs D x M processes: outside the launcher
    only 1x1 runs, and under it the world size must match."""
    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world)
        monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit):
        train.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--mesh", "2x2"])
    assert want in capsys.readouterr().err


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """It exits nonzero and prints no result, here and beside nothing of the repo."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], cwd=script.parent, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("module", ["core.calculator", "core.roofline", "planner.search",
                                    "planner.plan", "planner.validate", "launch.plan",
                                    "launch.dryrun"])
def test_import_checks_cover_the_planner_modules(module):
    """The planner's modules (copies of the JAX package's jax-free
    calculator, search and plan, the counter and the plan CLI) are in both
    checks: the AST scan reads their files, and the fresh interpreter walks
    them and finds no JAX."""
    path = PORT.joinpath(*module.split(".")).with_suffix(".py")
    assert path in _port_files()
    code = ("import pkgutil, repro_torch\n"
            "print(' '.join(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert f"repro_torch.{module}" in out.stdout.split(), out.stderr
