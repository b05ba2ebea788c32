"""The port's SSM, hybrid, VLM and enc-dec families against the JAX
package, and ``greedy_generate`` on the qwen3 and mamba2 smoke models.

Tolerances as in ``tests/test_torch_lm_models.py``: 5e-2 relative to the
max |logit| in bf16 (``tests/test_models.py:73``), 1e-5 for whole models
run in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_case import (S, TOL, check_fp32_forward, check_smoke_model,
                            f32, make_batches, models, rel)
from repro.serve.decode import greedy_generate as jax_greedy_generate
from repro_torch.serve import greedy_generate


@pytest.mark.parametrize("arch", ["mamba2-130m", "llama-3.2-vision-90b",
                                  "whisper-tiny"])
def test_ssm_vlm_and_encdec_smoke_models_match_jax(arch):
    check_smoke_model(arch)


def test_hybrid_smoke_model_matches_jax(monkeypatch):
    """zamba2 at the JAX test's positions in bf16 (prefill, the forward's
    last position, a decode step), and at every position in fp32.

    Its bf16 forward over all 32 positions is 8.2e-2 from JAX's: the JAX
    package's own bf16 forward is 7.6e-2 from its fp32 forward there, so
    two bf16 evaluations that round at different points cannot meet 5e-2
    at every position; the fp32 comparison checks the translation."""
    errs = check_smoke_model("zamba2-2.7b", forward_all_positions=False)
    assert errs["forward_last"] < TOL
    check_fp32_forward("zamba2-2.7b", monkeypatch)


def test_ssm_stack_in_fp32_matches_jax(monkeypatch):
    check_fp32_forward("mamba2-130m", monkeypatch)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
def test_greedy_generate_matches_jax(arch):
    """Teacher-forced with JAX's greedy tokens, every step's logits are
    within the tolerance of JAX's.  ``greedy_generate`` equals the port's
    own prefill-argmax-decode loop, and its tokens equal JAX's up to the
    first step whose JAX top-2 margin is within twice that step's
    measured error (each of the two logits may move by it; the margin
    then says which token wins).  The smoke models' random logits are
    flat, so few steps clear it."""
    jm, jp, tm, tp = models(arch)
    jb, tb = make_batches(jm.cfg)
    max_new, max_len = 8, S + 8
    jtoks = np.asarray(jax_greedy_generate(jm, jp, jb, max_new, max_len))

    jc = jm.init_cache(2, max_len)
    tc = tm.init_cache(2, max_len, device="cpu")
    jl, jc = jm.prefill(jp, jb, jc)
    tl, tc = tm.prefill(tp, tb, tc)
    jlogs, tlogs = [f32(jl[:, -1])], [tl[:, -1]]
    for i in range(max_new - 1):
        tok = jtoks[:, i:i + 1].astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jnp.int32(S + i), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), S + i, tc)
        jlogs.append(f32(jl[:, -1]))
        tlogs.append(tl[:, -1])
    errs = [rel(t, j) for t, j in zip(tlogs, jlogs)]
    print(arch, "teacher-forced step errors", np.round(errs, 5))
    assert max(errs) < TOL, errs
    assert np.array_equal(np.stack([j.argmax(-1) for j in jlogs], 1), jtoks)

    ttoks = greedy_generate(tm, tp, tb, max_new, max_len)
    assert ttoks.shape == (2, max_new) and ttoks.dtype == torch.int32
    cache = tm.init_cache(2, max_len, device="cpu")
    logits, cache = tm.prefill(tp, tb, cache)
    own = [logits[:, -1].argmax(-1)]
    for i in range(max_new - 1):
        logits, cache = tm.decode_step(tp, own[-1][:, None].int(), S + i, cache)
        own.append(logits[:, -1].argmax(-1))
    assert torch.equal(ttoks, torch.stack(own, 1).int())

    ttoks = ttoks.numpy()
    compared = 0
    for b in range(2):
        for i, j in enumerate(jlogs):
            top2 = np.sort(j[b])[-2:]
            if top2[1] - top2[0] <= 2 * errs[i] * np.abs(j).max():
                break
            assert ttoks[b, i] == jtoks[b, i], (b, i)
            compared += 1
    print(arch, f"tokens compared {compared} of {ttoks.size}")
    assert compared > 0
