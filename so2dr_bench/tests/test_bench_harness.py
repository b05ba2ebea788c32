"""A whole run on the CPU, with the harness's look for a card skipped: the
result line's shape, ``correct`` on the sound program, ``correct`` false
with the timed path broken underneath, and no result without a card or
without the program."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import CELLS, ROOT, small_cell

from so2dr_bench import harness


def _run(cell, trace=False, seed=2**31 + 11):
    return harness.run_cell(cell.name, seed, 0.2, trace, 0.0, device="cpu",
                            require_chip=False, cell=cell)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, trace):
    cell = small_cell(name)
    res = _run(cell, trace)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1 and res["solves"] >= 1
    assert list(res)[-1] == "check"
    assert set(res["check"]) == set(cell.limits)
    wanted = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in wanted}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == {"stencil_rate", "setup_s"}
        assert all(m["value"] > 0 for m in res["metrics"].values())
    else:
        # the CPU trace holds no device work: those readers stay silent
        assert {"transfer_gb", "host_setup_s"} <= set(res["metrics"])
        assert "stencil_roofline" not in res["metrics"]
        assert "breakdown" in res and "busy_s" in res["device"]


def _broken_executor(fault):
    """The program's executor with its fused step broken underneath."""
    from repro_torch.core.executor import DoubleBufferedExecutor
    from repro_torch.core.reference import multi_step_band

    def step(band, name, steps, keep_top=False, keep_bottom=False):
        out = multi_step_band(band, name, steps, keep_top, keep_bottom)
        if fault == "unchanged":
            # the band's rows the output covers, not advanced
            lost = band.shape[0] - out.shape[0]
            top = 0 if keep_top else lost if keep_bottom else lost // 2
            return band[top:top + out.shape[0]].clone()
        if fault == "altered":
            out = out.clone()
            out[out.shape[0] // 2, out.shape[1] // 2] += 1.0
        return out

    return lambda device: DoubleBufferedExecutor(fused_step=step,
                                                 device=device)


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    """A fused step that returns its state unchanged, or an answer altered
    where the kernel produces it, reads ``correct`` false."""
    monkeypatch.setattr(harness, "make_executor", _broken_executor(fault))
    res = _run(small_cell(name, check_rows=None))
    assert res["correct"] is False and res["failed"] == res["attempted"]
    assert any(c["value"] > c["limit"] for c in res["check"].values())


def _script(cwd, *args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "so2dr_bench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = _script(ROOT, "--workload", "box2d4r.incore", "--seed", "1",
                   "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_benchmark_alone_has_no_program(tmp_path):
    """A directory holding only ``BENCHMARK.json`` and the benchmark's
    files fails before any result: the program is not there."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "so2dr_bench"),
                    tmp_path / "so2dr_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from so2dr_bench import harness\n"
            "harness.run_cell('box2d4r.incore', 1, 1, False, 0.0,\n"
            "                 device='cpu', require_chip=False)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "repro_torch" in proc.stderr
    if not torch.cuda.is_available():
        proc = _script(tmp_path, "--workload", "box2d4r.incore", "--seed",
                       "1", "--seconds", "1")
        assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_every_cell_has_its_files():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"], spec)
        assert cell.limits and cell.end_to_end and cell.per_layer
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.exists(os.path.join(
            ROOT, "so2dr_bench", "metrics", m["name"] + ".py")), m["name"]
