"""The benchmark measures ``repro_torch`` alone: a run loads neither JAX
nor the JAX package ``repro`` (top-level names compared whole, so
``repro_torch`` passes), and the yardstick (reference, check, counts,
trace) imports nothing of the program."""
import ast
import glob
import os
import subprocess
import sys

from conftest import ROOT

from so2dr_bench import harness

BENCH = os.path.join(ROOT, "so2dr_bench")
YARDSTICK = ("references/*.py", "check.py", "counts.py", "trace.py")


def _python(code: str) -> str:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def test_a_run_loads_neither_jax_nor_repro():
    code = (
        "import sys; sys.path[:0] = ['src', '.', 'so2dr_bench/tests']\n"
        "from conftest import small_cell\n"
        "from so2dr_bench import harness\n"
        "for name in ('gradient2d.oocore', 'box2d4r.incore'):\n"
        "    for trace in (False, True):\n"
        "        harness.run_cell(name, 3, 0.1, trace, 0.0, device='cpu',\n"
        "                         require_chip=False, cell=small_cell(name))\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    loaded = set(_python(code).split())
    assert "repro_torch" in loaded and "so2dr_bench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}, loaded


def test_the_yardstick_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "import so2dr_bench.check, so2dr_bench.counts, so2dr_bench.trace\n"
        "import so2dr_bench.references.box, so2dr_bench.references.gradient\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    loaded = set(_python(code).split())
    assert not loaded & {"repro_torch", "repro", "jax"}, loaded
    for pattern in YARDSTICK:
        for path in glob.glob(os.path.join(BENCH, pattern)):
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                names = [a.name for a in node.names] \
                    if isinstance(node, ast.Import) else \
                    [node.module or ""] if isinstance(node, ast.ImportFrom) \
                    else []
                for name in names:
                    assert name.split(".")[0] not in (
                        "repro_torch", "repro", "jax"), (path, name)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "reprox", sys)
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["jaxlib", "repro"]
