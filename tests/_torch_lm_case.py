"""Shared cases of the port's LM differential tests (not a test module).

One smoke model of each architecture: JAX ``init_params(PRNGKey(0))``,
carried to the port by ``params_from_numpy``; batches from
``tests/test_models.py::make_batch``'s recipe.  Logits are held to 5e-2
relative to the max |logit| of the JAX output compared with, the JAX
package's own bf16 tolerance (``tests/test_models.py:73``).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_numpy

TOL = 5e-2
B, S = 2, 32


def make_batches(cfg, B=B, S=S):
    """``tests/test_models.py::make_batch`` for JAX, and the same values
    for the port (the bf16 stubs carried bit for bit)."""
    rng = np.random.default_rng(zlib.crc32(cfg.name.encode()))
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    for key, n, fam in (("images", cfg.n_image_tokens, "vlm"),
                        ("frames", cfg.n_frames, "encdec")):
        if cfg.family == fam:
            jb[key] = jnp.asarray(rng.standard_normal((B, n, cfg.d_model)),
                                  jnp.bfloat16)
            tb[key] = torch.from_numpy(
                np.array(jb[key].astype(jnp.float32))).bfloat16()
    return jb, tb


def models(arch):
    """(JAX model, JAX params, port model, port params on the CPU)."""
    jm = jax_build_model(jax_smoke_config(arch))
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(get_smoke_config(arch))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel(got, ref) -> float:
    got, ref = f32(got), f32(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))


def same_layout(tcache, jcache):
    """The port's cache tree has JAX's keys, shapes and dtypes."""
    assert jax.tree.structure(tcache) == jax.tree.structure(jcache)
    for t, j in zip(jax.tree.leaves(tcache), jax.tree.leaves(jcache)):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)


def check_smoke_model(arch, forward_all_positions=True):
    """forward, prefill (its cache too) and one decode step against JAX;
    the port's own prefill against its forward (< 1e-3, as the JAX test);
    returns the observed errors."""
    jm, jp, tm, tp = models(arch)
    jb, tb = make_batches(jm.cfg)
    jl, jaux = jm.forward(jp, jb)
    tl, taux = tm.forward(tp, tb)
    assert tl.shape == (B, S, jm.cfg.vocab) and tl.dtype == torch.bfloat16
    errs = {"forward": rel(tl, jl),
            "aux": abs(float(taux) - float(jaux))}
    assert errs["aux"] <= 1e-3 * max(1.0, abs(float(jaux))), errs
    if forward_all_positions:
        assert errs["forward"] < TOL, errs

    jc = jm.init_cache(B, S + 4)
    tc = tm.init_cache(B, S + 4, device="cpu")
    same_layout(tc, jc)
    jlp, jc = jm.prefill(jp, jb, jc)
    tlp, tc = tm.prefill(tp, tb, tc)
    same_layout(tc, jc)
    errs["prefill"] = rel(tlp, jlp)
    errs["prefill_vs_own_forward_abs"] = float(
        np.abs(f32(tlp)[:, 0] - f32(tl)[:, -1]).max())
    errs["forward_last"] = rel(tl[:, -1], jl[:, -1])
    nxt = np.asarray(jnp.argmax(jlp[:, -1], axis=-1)[:, None]).astype(np.int32)
    jld, jc2 = jm.decode_step(jp, jnp.asarray(nxt), jnp.int32(S), jc)
    tld, tc2 = tm.decode_step(tp, torch.from_numpy(nxt), S, tc)
    same_layout(tc2, jc2)
    errs["decode"] = rel(tld, jld)
    assert errs["prefill"] < TOL and errs["decode"] < TOL \
        and errs["forward_last"] < TOL, errs
    assert errs["prefill_vs_own_forward_abs"] < 1e-3, errs
    for t, j in zip(jax.tree.leaves(tc2), jax.tree.leaves(jc2)):
        if t.dtype == torch.int32:   # the caches' lengths
            assert np.array_equal(t.numpy(), np.asarray(j))
    print(arch, {k: f"{v:.3e}" for k, v in errs.items()})
    return errs


def check_fp32_forward(arch, monkeypatch, tol=1e-5):
    """The whole forward in fp32 in both packages (the embedding's bf16
    cast swapped out for this test): within ``tol`` relative to the max
    |logit|, which separates translation faults from bf16 rounding.
    For the families whose embedding goes through
    ``repro.models.api._embed_tokens`` (MoE, SSM, hybrid)."""
    import repro.models.api as jax_api
    import repro_torch.models.api as torch_api

    def fp32_embed(p, tokens):
        return p["embed"][tokens]

    monkeypatch.setattr(jax_api, "_embed_tokens", fp32_embed)
    monkeypatch.setattr(torch_api, "_embed_tokens", fp32_embed)
    jm, jp, tm, tp = models(arch)
    jb, tb = make_batches(jm.cfg)
    tl, _ = tm.forward(tp, tb)
    assert tl.dtype == torch.float32
    err = rel(tl, jm.forward(jp, jb)[0])
    print(arch, f"fp32 forward {err:.3e}")
    assert err <= tol, err
    return err


def leaf_err(got, ref) -> float:
    """max |got - ref| over max |ref| of one leaf (a grad)."""
    got = f32(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def port_value_and_grad(model, params, batch):
    """(loss, grads tree) of the port's ``model.loss`` on the CPU, as its
    Trainer takes them."""
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainConfig, Trainer

    return Trainer(model, AdamW(), TrainConfig(),
                   device="cpu").value_and_grad(params, batch)
