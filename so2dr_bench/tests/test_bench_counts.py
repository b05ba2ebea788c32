"""The kernel bound's counts against hand counts, against the plans'
geometry, and against what a kernel doing one product per tap could
reach."""
import pytest
from conftest import CELLS, small_cell

from so2dr_bench import counts


def test_band_work_equals_hand_counts():
    # gradient2d, r = 1: a 10 x 8 band, two steps, no frame side:
    # 8 then 6 rows updated across 6 columns; 10 rows in, 6 out
    w = counts.band_work(10, 8, 2, False, False, radius=1, flops_per_elem=19)
    assert w == counts.OpWork(bytes=(10 + 6) * 8 * 4, flops=19 * (48 + 36))
    # box2d4r, r = 4: a 20 x 12 band under the top frame, one step: the 4
    # frame rows stay, rows 4..15 update across 4 columns, 16 rows out
    w = counts.band_work(20, 12, 1, True, False, radius=4, flops_per_elem=161)
    assert w == counts.OpWork(bytes=(20 + 16) * 12 * 4, flops=161 * 12 * 4)
    # in core (both sides frame): the band keeps its height every step
    w = counts.band_work(30, 30, 4, True, True, radius=1, flops_per_elem=19)
    assert w == counts.OpWork(bytes=2 * 30 * 30 * 4, flops=19 * 4 * 28 * 28)


def _plan(cell):
    from repro_torch.core.oocore import compile_plan
    from repro_torch.core.stencil import get_stencil

    c, t = cell.config, cell.traffic
    size = t["interior"] + 2 * c["radius"]
    return compile_plan(t["engine"], get_stencil(c["stencil"]), size, size,
                        c["n_steps"], t["d"], c["k_off"], c["k_on"])


@pytest.mark.parametrize("name", CELLS)
def test_plan_work_counts_every_update_once(name):
    """Over a whole plan the counted updates are the interior's ``n``
    steps plus the wedges SO2DR recomputes, as the plan's own accounting
    says, and the bytes its bands move."""
    cell = small_cell(name)
    plan = _plan(cell)
    work = counts.plan_work(counts.fused_ops(plan), cell.config)
    stats = plan.stats()
    assert work.flops == cell.config["flops_per_elem"] \
        * stats.elements_computed
    assert work.bytes == stats.kernel_hbm_bytes
    assert stats.elements_computed >= cell.traffic["interior"] ** 2 \
        * cell.config["n_steps"]


@pytest.mark.parametrize("name", CELLS)
def test_bound_is_at_or_below_a_one_product_kernel(name):
    """No kernel can beat the bound.  A linear stencil's kernel that moves
    each byte once and does one product and one sum per tap (``2 *
    points`` FLOPs, above the published ``2 * points - 1``) on the TF32
    tensor cores at their peak takes at least as long; so does a
    nonlinear one doing its published FLOPs on the fp32 cores."""
    cell = small_cell(name)
    config = cell.config
    per_elem = {"box": 2 * (2 * config["radius"] + 1) ** 2,
                "gradient": config["flops_per_elem"]}[config["reference"]]
    peaks = counts.peaks()
    for op in counts.fused_ops(_plan(cell)):
        w = counts.plan_work([op], config)
        b = counts.bound(w, config)
        updated = w.flops // config["flops_per_elem"]
        ideal = max(w.bytes / peaks["hbm_bytes_per_s"],
                    per_elem * updated / peaks["flops_per_s"][config["peak"]])
        assert b.seconds <= ideal
        assert b.seconds == max(b.bytes_s, b.flops_s) > 0


def test_peaks_are_the_data_sheets():
    p = counts.peaks()
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert p["flops_per_s"] == {"tf32": 494.7e12, "fp32": 67.0e12}


def test_an_op_that_does_not_shrink_as_counted_is_refused():
    class Op:
        steps, keep_lo, keep_hi = 1, (False, True), (False, True)
        shape_in, shape_out = (20, 12), (19, 12)

    with pytest.raises(ValueError):
        counts.plan_work([Op()], {"radius": 1, "flops_per_elem": 19})
