"""The reference runs the sharded loss on the batches that the port's
one-sequence and undivided-batch tests hold the port to.

In a subprocess with 4 fake CPU devices: the JAX package's loss of
qwen3's, mamba2's and whisper's smoke configs, with params placed by
``replan`` and the batch by ``batch_specs``, on (1, 1) and (1, 2) meshes
at B = 1 (a batch split over a data axis of size 1) and on a (2, 2) mesh
at B = 3 (a batch replicated over "data"), equals its unsharded loss
within the LM tolerance (1e-3 relative, ``test_torch_lm_grads.py``).
The plain port is held to the JAX package by ``test_torch_lm_*.py``,
and the port's sharded runs to its plain ones by
``test_torch_launch_one_sequence.py`` and
``test_torch_launch_undivided_batch.py``.
"""
from _subproc import run_fake_device_subprocess

_SUBPROC = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.compat import AxisType, make_mesh
from repro.configs import get_smoke_config
from repro.configs.base import ShapeSpec
from repro.launch.elastic import replan
from repro.launch.sharding import batch_specs, named
from repro.models.api import build_model

S = 16
for arch in ("qwen3-0.6b", "mamba2-130m", "whisper-tiny"):
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    shapes = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    full = {"tokens": rng.integers(0, cfg.vocab, (3, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (3, S)).astype(np.int32)}
    if cfg.family == "encdec":
        full["frames"] = rng.standard_normal(
            (3, cfg.n_frames, cfg.d_model)).astype(np.float32)
    loss = jax.jit(model.loss)

    def batch_of(B):
        return {k: jnp.asarray(v[:B]) for k, v in full.items()}

    plain = {B: float(loss(params, batch_of(B))) for B in (1, 3)}
    for mesh_shape, B in (((1, 1), 1), ((1, 2), 1), ((2, 2), 3)):
        mesh = make_mesh(mesh_shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
        p = jax.tree.map(jax.device_put, params, replan(cfg, shapes, mesh))
        batch = batch_of(B)
        b = jax.tree.map(jax.device_put, batch, named(mesh, batch_specs(
            cfg, ShapeSpec("case", S, B, "train"), batch, mesh)))
        with mesh:
            sharded = float(loss(p, b))
        assert abs(sharded - plain[B]) <= 1e-3 * abs(plain[B]), (
            arch, mesh_shape, B, sharded, plain[B])
print("REFERENCE_OK")
"""


def test_reference_sharded_loss_runs_on_undivided_batches():
    run_fake_device_subprocess(_SUBPROC, "REFERENCE_OK", n_devices=4)
