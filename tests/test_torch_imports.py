"""The port stands alone: it imports neither JAX nor the JAX package.

``repro_torch`` and every submodule import in a fresh interpreter with
neither ``jax`` nor ``repro`` in ``sys.modules`` afterwards, and without
building or loading a kernel; a scan of the sources (and of
``chip_smoke.py``) finds no import of either.
"""
import os
import pkgutil
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")


def _modules():
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax_or_repro():
    names = _modules()
    assert {"repro_torch.core.lower", "repro_torch.kernels.dispatch",
            "repro_torch.kernels._build",
            "repro_torch.kernels.stencil_multistep_db",
            "repro_torch.kernels.stencil_banded_mxu",
            "repro_torch.core.analytic", "repro_torch.core.params",
            "repro_torch.core.accounting", "repro_torch.core.calibrate",
            "repro_torch.core.autotune", "repro_torch.core.tune",
            "repro_torch.core.faults", "repro_torch.core.recovery",
            "repro_torch.checkpoint.manager",
            "repro_torch.serve.scheduler",
            "repro_torch.serve.service", "repro_torch.core.shard",
            "repro_torch.core.hierarchy", "repro_torch.core.distributed",
            "repro_torch.core.ranks", "repro_torch.launch.elastic",
            "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.qwen3_0_6b", "repro_torch.configs.mamba2_130m",
            "repro_torch.configs.mixtral_8x7b",
            "repro_torch.models", "repro_torch.models.layers",
            "repro_torch.models.transformer", "repro_torch.models.moe",
            "repro_torch.models.mamba2", "repro_torch.models.api",
            "repro_torch.models.convert", "repro_torch.serve.decode",
            "repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.train", "repro_torch.train.loop",
            "repro_torch.data", "repro_torch.data.pipeline",
            "repro_torch.launch.train", "repro_torch.launch.mesh",
            "repro_torch.launch.sharding", "repro_torch.launch.dryrun",
            "repro_torch.launch.op_analysis",
            "repro_torch.launch.collectives"} \
        <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "import repro_torch.kernels._build as b\n"
        "assert b._lib is None, 'importing the port loaded the kernels'\n"
        "import multiprocessing, threading\n"
        "assert not multiprocessing.active_children(), 'a process started'\n"
        "assert threading.active_count() == 1, 'a thread started'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)\b(?!_)|from\s+(?:jax|repro)\b(?!_))",
    re.MULTILINE)


def test_sources_do_not_import_jax_or_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, filenames in os.walk(PKG):
        files += [os.path.join(dirpath, f) for f in filenames
                  if f.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            hits = _IMPORT.findall(f.read())
        assert not hits, (path, hits)


def test_import_pattern_catches_what_it_should():
    assert _IMPORT.search("import jax.numpy as jnp")
    assert _IMPORT.search("    from repro.core import plan")
    assert _IMPORT.search("import repro")
    assert not _IMPORT.search("import repro_torch")
    assert not _IMPORT.search("from repro_torch.core import plan")
    assert not _IMPORT.search("# see repro.core.plan")


def test_launch_modules_start_no_process_group():
    """Importing the launch layer (the mesh, the dry run, the rules)
    touches no process-group or device state, as JAX's ``mesh.py``
    touches no device state."""
    code = (
        "import torch.distributed as dist\n"
        "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.sharding, repro_torch.launch.elastic\n"
        "assert dist.is_available() and not dist.is_initialized()\n"
        "import sys\n"
        "assert 'torch.testing._internal.distributed.fake_pg' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_public_names_cover_the_reference():
    """Every name ``repro`` exports, ``repro_torch`` exports too, and the
    executor module carries the reference's ``PLAN_EXECUTORS``."""
    import repro
    import repro_torch
    from repro.core.executor import PLAN_EXECUTORS as jax_plan_executors
    from repro_torch import (  # noqa: F401
        RTX3080_PAPER, TPU_V5E, autotune, autotune_box)
    from repro_torch.core.executor import EXECUTORS, PLAN_EXECUTORS

    assert set(repro.__all__) <= set(repro_torch.__all__), (
        sorted(set(repro.__all__) - set(repro_torch.__all__)))
    assert all(hasattr(repro_torch, n) for n in repro_torch.__all__)
    assert PLAN_EXECUTORS == jax_plan_executors
    assert set(PLAN_EXECUTORS) <= set(EXECUTORS)
