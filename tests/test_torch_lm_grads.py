"""Gradients of the port's smoke models against ``jax.grad`` of the JAX
package's, in bf16, from JAX's weights carried across.

The loss's grads per leaf within 5e-2 of the leaf's max |grad| (the JAX
package's bf16 tolerance).  On some leaves of mamba2, zamba2 and the
VLM the JAX package's own bf16 grad lies further than that from its
fp32 grad (the embedding's bf16 cast swapped out, as
``check_fp32_forward`` does): up to 9.4e-2, 0.25 and 8.7e-2 of the
leaf's max.  There the port is held to twice that distance, the most
that two grads, each that far from the fp32 grad, can differ; those
three families are also held in fp32, at 1e-4, in
``tests/test_torch_lm_vjp.py``.
"""
import jax
import pytest
import torch

from _torch_lm_case import leaf_err, make_batches, models, port_value_and_grad
from repro_torch.models.transformer import tree_leaves

BF16_TOL = 5e-2
ALL_ARCHS = ["minitron-4b", "phi3-medium-14b", "h2o-danube-1.8b",
             "qwen3-0.6b", "llama-3.2-vision-90b", "zamba2-2.7b",
             "llama4-maverick-400b-a17b", "mixtral-8x7b", "whisper-tiny",
             "mamba2-130m"]
# families whose JAX bf16 grads lie further than BF16_TOL from JAX's fp32
NOISY = ("llama-3.2-vision-90b", "zamba2-2.7b", "mamba2-130m")


def _jax_fp32_grads(jm, jp, jb):
    import repro.models.api as jax_api

    orig = jax_api._embed_tokens
    jax_api._embed_tokens = lambda p, tokens: p["embed"][tokens]
    try:
        return jax.jit(jax.grad(jm.loss))(jp, jb)
    finally:
        jax_api._embed_tokens = orig


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_model_grads_match_jax_in_bf16(arch):
    jm, jp, tm, tp = models(arch)
    jb, tb = make_batches(jm.cfg)
    jloss, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    tloss, tg = port_value_and_grad(tm, tp, tb)
    assert tloss.dtype == torch.float32
    assert abs(float(tloss) - float(jloss)) <= 1e-3 * abs(float(jloss))
    tleaves, jleaves = tree_leaves(tg), jax.tree.leaves(jg)
    assert len(tleaves) == len(jleaves)
    floors = ([leaf_err(a, b) for a, b in zip(jleaves, jax.tree.leaves(
        _jax_fp32_grads(jm, jp, jb)))] if arch in NOISY
        else [0.0] * len(jleaves))
    worst = 0.0
    for t, j, floor in zip(tleaves, jleaves, floors):
        err = leaf_err(t, j)
        assert err <= max(BF16_TOL, 2 * floor), (err, floor)
        worst = max(worst, err)
    print(arch, f"loss {float(tloss):.6f} vs {float(jloss):.6f}, worst leaf "
          f"{worst:.3e}, JAX's own bf16 vs fp32 up to {max(floors):.3e}")
