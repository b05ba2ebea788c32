"""The port's sharded programs split the work of heads that do not
divide "model", and the Mamba-2 mixer's parts, as the reference's
partitioning does, on the CPU.

* Attention whose query heads do not divide "model" runs sequence
  parallel (each model rank takes its slice of the query rows, with the
  whole kv).  minitron's smoke config (4 heads) traced on a fake (1, 8)
  group counts at most 1.25/8 of the (1, 1) FLOPs per rank (before, the
  heads ran replicated: 0.84 of them), and every smoke model's loss and
  grads on a (1, 8) gloo mesh, where no smoke model's 4 heads divide
  "model", equal the plain ones (loss 1e-5, grads 1e-4 of a leaf's max,
  fp32).  The SSD scan of heads that do not divide "model" splits the
  sequence instead: each rank scans its slice from a zero state, and the
  slices' final states and decays, all-gathered, give each rank the
  state entering its slice; the Mamba-2 smoke configs with 4 SSM heads
  on the (1, 8) mesh hold the same bounds.
* The Mamba-2 block's in-projection and conv run per part (z, the
  SSM input, B and C, dt), so nothing slices a channel-sharded tensor:
  zamba2's and mamba2's smoke train and prefill cells on a fake (2, 2)
  group all-gather nothing as large as a rank's rows of the conv output
  at its full width (before: the in-projection's output and the conv's,
  at every slice).
"""
import pytest

from _torch_spmd import run_spmd, spmd_processes
import _torch_launch_ranks as ranks
from repro_torch.configs import ARCH_NAMES, ShapeSpec, get_smoke_config
from repro_torch.launch.dryrun import lower_cell

TIMEOUT = 240.0


def _cell(arch, kind, mesh, seq=256, batch=8):
    shape = ShapeSpec(f"{kind}_s", seq, batch, kind)
    return lower_cell(arch, shape.name, False, device="cpu", smoke=True,
                      mesh_shape=mesh, shape=shape)


def test_attention_work_splits_over_model_when_heads_do_not_divide():
    one = _cell("minitron-4b", "train", (1, 1), seq=1024)
    eight = _cell("minitron-4b", "train", (1, 8), seq=1024)
    assert get_smoke_config("minitron-4b").n_heads % 8
    assert eight["cost"]["flops"] <= 1.25 / 8 * one["cost"]["flops"], (
        eight["cost"]["flops"] / one["cost"]["flops"])


# the Mamba-2 smoke configs with 4 SSM heads (head dim 32), which do not
# divide "model" = 8: their scan runs sequence parallel
SSD4 = [(f"{a}/4 heads", a, {"ssm_head_dim": 32})
        for a in ("mamba2-130m", "zamba2-2.7b")]


@pytest.fixture(scope="module")
def losses_18():
    out = run_spmd(ranks.loss_and_grads, 8, list(ARCH_NAMES) + SSD4, (1, 8),
                   True, timeout=TIMEOUT)[0]
    assert not spmd_processes()
    return out


@pytest.mark.parametrize("arch", list(ARCH_NAMES) + [c[0] for c in SSD4])
def test_sequence_parallel_loss_equals_plain(arch, losses_18):
    r = losses_18[arch]
    assert abs(r["sharded"] - r["plain"]) <= 1e-5 * abs(r["plain"]), r
    assert r["grad_err"] <= 1e-4, r


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-130m"])
def test_mamba_mixer_gathers_no_conv_output(arch, kind):
    rec = _cell(arch, kind, (2, 2), seq=128)
    cfg = get_smoke_config(arch)
    conv_rows = 8 // 2 * 128 * (cfg.d_inner + 2 * cfg.ssm_state)
    gathers = [c for c in rec["largest_collectives"]
               if c["kind"] == "all-gather"]
    assert gathers and max(c["numel"] for c in gathers) < conv_rows, gathers
