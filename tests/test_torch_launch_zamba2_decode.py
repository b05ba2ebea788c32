"""The port's zamba2 decode step, split where the rules place its state,
equals the plain one on gloo rank processes, on the CPU.

zamba2's in-projection has 296 columns at smoke size (z 128, the conv
input 160, dt 8); split 148 or 74 a rank over "model" on (2, 2) and
(2, 4), the chunks cross z, the conv input and dt, and the decode
region's all-to-alls bring each rank the ranges it reads.  Seven greedy
decode steps equal the plain ones within 1e-5 in fp32, both started from
the plain prefill's cache.  From their own prefills the two differ by up
to 8.7e-5 on (2, 4): a Mamba-2 prefill hands its conv state on in bf16,
so the prefills' fp32 roundoff comes back as bf16 steps.
"""
import math

import pytest

from _torch_spmd import run_spmd, spmd_processes
import _torch_launch_ranks as ranks

TIMEOUT = 240.0

ONE_CACHE_MESHES = [(2, 2), (2, 4)]


@pytest.fixture(scope="module")
def one_cache_decodes():
    out = {mesh: run_spmd(ranks.decode_vs_plain, math.prod(mesh),
                          ["zamba2-2.7b"], mesh, 7, ranks.B, True,
                          timeout=TIMEOUT)[0]["zamba2-2.7b"]
           for mesh in ONE_CACHE_MESHES}
    assert not spmd_processes()
    return out


@pytest.mark.parametrize("mesh", ONE_CACHE_MESHES, ids=["2x2", "2x4"])
def test_zamba2_decode_from_one_cache_equals_plain(mesh, one_cache_decodes):
    r = one_cache_decodes[mesh]
    assert len(r["errs"]) == 8, r
    assert max(r["errs"]) <= 1e-5 * max(r["scale"], 1.0), r
