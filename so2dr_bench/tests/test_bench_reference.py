"""The benchmark's plain reference against the port's plain path, the row
sample against the whole domain, and the controls against the limits."""
import numpy as np
import pytest
import torch
from conftest import CELLS, small_cell

from so2dr_bench import check, harness


def _program(cell, x):
    """The port's plain path through the timed entry, on the CPU."""
    from repro_torch.core.executor import DoubleBufferedExecutor
    from repro_torch.core.oocore import compile_plan
    from repro_torch.core.stencil import get_stencil

    c, t = cell.config, cell.traffic
    plan = compile_plan(t["engine"], get_stencil(c["stencil"]), x.shape[0],
                        x.shape[1], c["n_steps"], t["d"], c["k_off"],
                        c["k_on"])
    out, _ = DoubleBufferedExecutor(device="cpu").execute(plan, x)
    return out


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_ports_plain_path(name):
    cell = small_cell(name)
    size = cell.traffic["interior"] + 2 * cell.config["radius"]
    x = harness.make_domain(size, 2**31 + 17, "cpu")
    got = _program(cell, x)
    blocks = [(0, size)]
    ref = check.reference_rows(x, cell.config, blocks, device="cpu")
    # float32 sums in another order (box: cuDNN's conv2d), a few steps
    assert check.errors(got, blocks, ref)["max_abs_err"] <= 1e-6
    # the frame never changes
    r = cell.config["radius"]
    assert np.array_equal(got[:r], x[:r]) and np.array_equal(got[:, -r:],
                                                             x[:, -r:])


@pytest.mark.parametrize("name", CELLS)
def test_row_sample_equals_the_whole_domain(name):
    cell = small_cell(name, check_rows=8)
    size = cell.traffic["interior"] + 2 * cell.config["radius"]
    x = harness.make_domain(size, 5, "cpu")
    blocks = check.sample_blocks(cell.traffic, size, 5)
    whole = check.reference_rows(x, cell.config, [(0, size)], device="cpu")
    sample = check.reference_rows(x, cell.config, blocks, device="cpu")
    for (lo, hi), rows in zip(blocks, sample):
        assert torch.equal(rows, whole[0][lo:hi])


def test_sample_covers_every_seam_and_is_seeded():
    traffic = {"d": 4, "check_rows": 64, "random_blocks": 2}
    a = check.sample_blocks(traffic, 4096, 123)
    assert a == check.sample_blocks(traffic, 4096, 123)
    assert a != check.sample_blocks(traffic, 4096, 124)
    for j in (1, 2, 3):
        seam = j * 4096 // 4
        assert any(lo < seam < hi for lo, hi in a), (seam, a)
    assert all(b[1] < c[0] for b, c in zip(a, a[1:]))
    assert check.sample_blocks({"d": 1, "check_rows": None}, 100, 1) \
        == [(0, 100)]


def _control_err(cell, x, blocks, device):
    ref = check.reference_rows(x, cell.config, blocks, device=device)
    low = check.reference_rows(x, cell.config, blocks,
                               check.reference_module(cell.config).CONTROL,
                               device)
    return check.errors(torch.cat(low).numpy(), check.packed(blocks), ref)


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_far_above_the_program(name):
    """Over the configuration's whole ``n_steps`` on a small domain, the
    reference one precision step down, in the program's place, reads at
    least a hundred times the program's gap on the compared numbers (the
    limits themselves are set at the cell's size, where the control's
    gap is wider)."""
    cell = small_cell(name, interior=126 if "gradient" in name else 256)
    cell.config["n_steps"] = harness.load_cell(name).config["n_steps"]
    size = cell.traffic["interior"] + 2 * cell.config["radius"]
    x = harness.make_domain(size, 99, "cpu")
    blocks = [(0, size)]
    program = check.errors(_program(cell, x), blocks, check.reference_rows(
        x, cell.config, blocks, device="cpu"))
    control = _control_err(cell, x, blocks, "cpu")
    for key in cell.limits:
        assert control[key] > 100 * program[key], (key, program, control)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits_at_the_cells_size(card, name):
    """The control at the cell's own size and row sample, three seeds:
    every seed fails one of the cell's limits."""
    cell = harness.load_cell(name)
    size = cell.traffic["interior"] + 2 * cell.config["radius"]
    for seed in (1, 2, 3):
        x = harness.make_domain(size, seed, card)
        blocks = check.sample_blocks(cell.traffic, size, seed)
        errs = _control_err(cell, x, blocks, card)
        assert any(errs[k] > limit for k, limit in cell.limits.items()), \
            (seed, errs)
