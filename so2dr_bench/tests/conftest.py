"""Paths and small cells for the benchmark's own tests.

    python -m pytest -q so2dr_bench/tests

They run on the CPU at small sizes; the ones that need the card carry
the ``cuda`` marker and skip without one (the ``card`` fixture decides).
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

# cell -> small sizes that keep each engine's shape: the chunk count, a
# k_off that region sharing can fit, fused steps of k_on
SMALL = {
    "gradient2d.oocore": dict(interior=126, n_steps=16, k_off=4, k_on=2,
                              check_rows=16),
    "box2d4r.oocore": dict(interior=184, n_steps=8, k_off=2, k_on=2,
                           check_rows=16),
    "box2d4r.incore": dict(interior=60, n_steps=8, k_off=2, k_on=2,
                           check_rows=None),
}
CELLS = tuple(SMALL)


def small_cell(name: str, **overrides):
    """The cell as ``BENCHMARK.json`` defines it, at a size the CPU runs
    in well under a second."""
    from so2dr_bench import harness

    cell = harness.load_cell(name)
    sizes = dict(SMALL[name], **overrides)
    cell.config = dict(cell.config, **{k: sizes[k] for k in
                                       ("n_steps", "k_off", "k_on")})
    cell.traffic = dict(cell.traffic, interior=sizes["interior"],
                        check_rows=sizes["check_rows"])
    return cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
