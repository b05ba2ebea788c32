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
            "repro_torch.kernels.stencil_multistep_db"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "import repro_torch.kernels._build as b\n"
        "assert b._lib is None, 'importing the port loaded the kernels'\n"
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
