"""The op-level cost counter (``repro_torch.launch.op_analysis``) on the
CPU: the four checks of ``tests/test_hlo_analysis.py`` on ``analyze``,
the same functions against the JAX package's ``analyze_hlo`` of their
compiled HLO, and one qwen3 smoke training step against JAX's
``value_and_grad`` + AdamW step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.api import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro_torch.launch.collectives import RING_FACTORS, collective_bytes
from repro_torch.launch.op_analysis import OpCost, analyze
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import AdamW
from repro_torch.train import TrainConfig, Trainer


def _hlo(f, *shapes):
    return analyze_hlo(jax.jit(f).lower(*shapes).compile().as_text())


def _loop(w, x, n=10):
    for _ in range(n):
        x = torch.tanh(x @ w)
    return (x ** 2).sum()


def _jax_loop(w, x, n=10):
    def body(x, _):
        return jnp.tanh(x @ w), None
    y, _ = jax.lax.scan(body, x, None, length=n)
    return jnp.sum(y ** 2)


def _nested(x):
    for _ in range(5):
        for _ in range(3):
            x = x @ x
    return x.sum()


def _jax_nested(x):
    def outer(x, _):
        def inner(x, _):
            return x @ x, None
        y, _ = jax.lax.scan(inner, x, None, length=3)
        return y, None
    y, _ = jax.lax.scan(outer, x, None, length=5)
    return jnp.sum(y)


def _value_and_grad(w, x, n=8):
    w = w.detach().requires_grad_()
    loss = _loop(w, x, n)
    return loss, torch.autograd.grad(loss, w)[0]


def test_loop_counts_every_trip():
    w, x = torch.randn(128, 128), torch.randn(128, 128)
    _, c = analyze(_loop, w, x)
    analytic = 10 * 2 * 128 ** 3
    assert abs(c.flops - analytic) / analytic < 0.05
    # the JAX scan and its unrolled twin count the same
    sd = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    j = _hlo(_jax_loop, sd, sd)
    assert abs(c.flops - j.flops) / j.flops < 0.05


def test_grad_flops_ratio():
    w, x = torch.randn(128, 128), torch.randn(128, 128)
    _, fwd = analyze(lambda w, x: _loop(w, x, 8), w, x)
    _, vg = analyze(_value_and_grad, w, x)
    # dL/dw: 2 matmuls per layer in bwd + 1 fwd -> ~3x
    assert 2.5 < vg.flops / fwd.flops < 3.6
    sd = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    j = _hlo(lambda w, x: jax.value_and_grad(
        lambda w, x: _jax_loop(w, x, 8))(w, x), sd, sd)
    assert abs(vg.flops - j.flops) / j.flops < 0.05


def test_nested_loops_multiply():
    x = torch.randn(64, 64) * 0.01
    _, c = analyze(_nested, x)
    analytic = 15 * 2 * 64 ** 3
    assert abs(c.flops - analytic) / analytic < 0.05
    j = _hlo(_jax_nested, jax.ShapeDtypeStruct((64, 64), jnp.float32))
    assert abs(c.flops - j.flops) / j.flops < 0.05


def test_fake_tensors_count_the_same_without_allocating():
    with FakeTensorMode():
        w, x = torch.empty(128, 128), torch.empty(128, 128)
        _, c = analyze(_loop, w, x)
    _, real = analyze(_loop, torch.randn(128, 128), torch.randn(128, 128))
    assert c.flops == real.flops and c.bytes == real.bytes


def test_collectives_counted_on_a_fake_group():
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh, start_fake_group, stop_group

    start_fake_group(4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        x = torch.randn(32, 32)

        def f(x):
            return fc.all_reduce(x @ x, "sum", (mesh, 0)).wait()

        _, c = analyze(f, x)
        assert c.flops > 0
        assert c.collectives["all-reduce"] == 32 * 32 * 4
        d = distribute_tensor(torch.randn(64, 32), mesh, [Shard(0), Replicate()])
        coll = collective_bytes(lambda d: d.redistribute(
            mesh, [Replicate(), Replicate()]).to_local(), d)
        assert coll["all-gather"] == 64 * 32 * 4
        assert set(coll) == set(RING_FACTORS)
    finally:
        stop_group()


def test_opcost_adds_and_scales():
    a = OpCost(1.0, 2.0)
    a.collectives["all-gather"] = 3.0
    b = a.scaled(2.0)
    a += b
    assert (a.flops, a.bytes, a.collectives["all-gather"]) == (3.0, 6.0, 9.0)


def test_smoke_train_step_flops_vs_jax():
    """One qwen3 smoke Trainer step (autograd over remat'd layers, AdamW)
    against JAX's jitted value_and_grad + AdamW update of the same model:
    the port counts within 15 % of ``analyze_hlo``."""
    cfg = jax_smoke_config("qwen3-0.6b")
    jm = jax_build_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    B, S = 2, 64
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jopt = JaxAdamW()

    def jstep(p, st, b):
        loss, g = jax.value_and_grad(jm.loss)(p, b)
        p, st = jopt.update(g, st, p)
        return p, st, loss

    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    j = analyze_hlo(jax.jit(jstep).lower(jp, jopt.init(jp), jb)
                    .compile().as_text())

    from repro_torch.models.api import build_model
    from repro_torch.configs import get_smoke_config

    model = build_model(get_smoke_config("qwen3-0.6b"))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    opt = AdamW()
    tr = Trainer(model, opt, TrainConfig(), device="cpu")
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    _, c = analyze(tr.step, params, opt.init(params), None, batch)
    ratio = c.flops / j.flops
    print(f"qwen3 smoke train step: port {c.flops:.4e} FLOPs, JAX "
          f"analyze_hlo {j.flops:.4e}, ratio {ratio:.4f}")
    assert abs(ratio - 1) <= 0.15
