"""The port's CheckpointManager vs the JAX package's, on the CPU.

The file format is the same: a checkpoint written by either package
restores bit-exactly in the other.  Writes are atomic (no ``.tmp`` left
behind), keep-K garbage collection holds, and a step directory missing
its payload or its meta marker is invisible (mirrors
tests/test_checkpoint.py).  Tensor leaves are saved from the CPU copy.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro_torch.checkpoint import CheckpointManager

RNG = np.random.default_rng(23)


def _tree():
    """A nested tree of numpy and torch leaves (dtypes JAX keeps without
    x64: float32 and int32)."""
    return {"host": RNG.standard_normal((6, 5)).astype(np.float32),
            "b": {"c": torch.arange(4, dtype=torch.int32),
                  "d": torch.from_numpy(RNG.standard_normal(3)).float()},
            "t": (np.zeros((), np.float32), np.full((2,), 7, np.int32)),
            "l": [torch.ones((2, 2), dtype=torch.bfloat16).float()]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree.numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)]


def _assert_same_leaves(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for step in (1, 2, 3):
        mgr.save(step, tree, extra_meta={"mesh": "1x1"})
    assert mgr.all_steps() == [2, 3]
    restored, meta = mgr.restore(tree)
    assert meta["step"] == 3 and meta["mesh"] == "1x1"
    assert meta["n_leaves"] == len(_leaves(tree))
    assert isinstance(restored["t"], tuple) and isinstance(restored["l"], list)
    _assert_same_leaves(tree, restored)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_restore_across_packages(writer, tmp_path):
    """Bit-exact in both directions, payload and meta alike."""
    tree = _tree()
    np_tree = {"host": tree["host"],
               "b": {"c": tree["b"]["c"].numpy(), "d": tree["b"]["d"].numpy()},
               "t": tree["t"], "l": [tree["l"][0].numpy()]}
    port, jax_ = CheckpointManager(str(tmp_path)), \
        JaxCheckpointManager(str(tmp_path))
    meta_in = {"round": 4, "plan_fingerprint": "abc"}
    if writer == "jax":
        jtree = {"host": jnp.asarray(np_tree["host"]),
                 "b": {k: jnp.asarray(v) for k, v in np_tree["b"].items()},
                 "t": tuple(jnp.asarray(v) for v in np_tree["t"]),
                 "l": [jnp.asarray(np_tree["l"][0])]}
        jax_.save(5, jtree, extra_meta=meta_in)
        restored, meta = port.restore(tree)
    else:
        port.save(5, tree, extra_meta=meta_in)
        restored, meta = jax_.restore(np_tree)
    _assert_same_leaves(np_tree, restored)
    assert meta == {"step": 5, "n_leaves": 6, **meta_in}
    # the same bytes on disk: the npz members and meta.json
    d = tmp_path / "step_00000005"
    with np.load(d / "arrays.npz") as z:
        assert sorted(z.files) == ["b/c", "b/d", "host", "l/0", "t/0", "t/1"]
    assert json.loads((d / "meta.json").read_text()) == meta


def test_atomic_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(7, {"x": torch.ones(3)})
    mgr.save(7, {"x": torch.zeros(3)})        # overwrite in place
    names = os.listdir(tmp_path)
    assert names == ["step_00000007"]
    restored, _ = mgr.restore({"x": None})
    np.testing.assert_array_equal(restored["x"], np.zeros(3, np.float32))


def test_incomplete_step_dirs_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    tree = {"x": torch.arange(4.0)}
    mgr.save(1, tree, extra_meta={"tag": "good"})
    os.makedirs(tmp_path / "step_00000002")
    (tmp_path / "step_00000002" / "meta.json").write_text("{}")
    os.makedirs(tmp_path / "step_00000003")
    np.savez(tmp_path / "step_00000003" / "arrays.npz", x=np.ones(4))
    os.makedirs(tmp_path / "step_00000004.tmp")
    os.makedirs(tmp_path / "step_backup")
    assert mgr.all_steps() == [1]
    assert mgr.latest_step() == 1
    restored, meta = mgr.restore(tree)
    assert meta["tag"] == "good"
    np.testing.assert_array_equal(restored["x"], np.arange(4.0,
                                                           dtype=np.float32))
    # the JAX package sees the same single step
    assert JaxCheckpointManager(str(tmp_path), keep=5).all_steps() == [1]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bf16_moment_checkpoints_restore_bitwise_across_packages(writer,
                                                                 tmp_path):
    """A trainer's ``(params, OptState, residual)`` with bf16 moments: a
    bf16 leaf is written as the JAX manager writes it (2-byte records,
    descr ``'<V2'``), comes back as a bf16 tensor in the port and as the
    same 2-byte records in the JAX package, bit for bit both ways."""
    from repro.optim import OptState as JaxOptState
    from repro_torch.optim import OptState

    rng = np.random.default_rng(29)
    p = {"w": RNG.standard_normal((4, 6)).astype(np.float32),
         "b": {"c": RNG.standard_normal(5).astype(np.float32)}}
    m = {k: v for k, v in (("w", rng.standard_normal((4, 6))),
                           ("b", {"c": rng.standard_normal(5)}))}

    def jax_tree():
        bf = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(np.float32(a)).astype(jnp.bfloat16), t)
        return (jax.tree.map(jnp.asarray, p),
                JaxOptState(step=jnp.int32(3), mu=bf(m),
                            nu=bf(jax.tree.map(np.abs, m))),
                jax.tree.map(lambda a: jnp.zeros((), jnp.float32), p))

    def port_tree():
        bf = lambda t: jax.tree.map(  # noqa: E731
            lambda a: torch.from_numpy(np.float32(a)).to(torch.bfloat16), t)
        return ({"w": torch.from_numpy(p["w"]),
                 "b": {"c": torch.from_numpy(p["b"]["c"])}},
                OptState(step=torch.tensor(3, dtype=torch.int32), mu=bf(m),
                         nu=bf(jax.tree.map(np.abs, m))),
                {"w": torch.zeros(()), "b": {"c": torch.zeros(())}})

    def bits(leaf):
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype == torch.bfloat16:
                return leaf.view(torch.int16).numpy().view(np.uint16)
            return leaf.numpy()
        a = np.asarray(leaf)
        return a.view(np.uint16) if a.dtype.itemsize == 2 else a

    jt, tt = jax_tree(), port_tree()
    for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(tt)):
        np.testing.assert_array_equal(bits(a), bits(b))
    if writer == "jax":
        JaxCheckpointManager(str(tmp_path)).save(3, jt)
        restored, meta = CheckpointManager(str(tmp_path)).restore(tt)
        assert isinstance(restored[1], OptState)
        assert restored[1].mu["w"].dtype == torch.bfloat16
        ref = jt
    else:
        CheckpointManager(str(tmp_path)).save(3, tt)
        restored, meta = JaxCheckpointManager(str(tmp_path)).restore(jt)
        assert restored[1].mu["w"].dtype.str == "|V2"
        ref = tt
    assert meta["step"] == 3 and meta["n_leaves"] == 9
    got, want = jax.tree.leaves(restored), jax.tree.leaves(ref)
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        np.testing.assert_array_equal(bits(a), bits(b))
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as z:
        # a tuple at the top gives keys with a leading "/", in both packages
        assert z["/1/1/w"].dtype.str == "|V2" and z["/1/0"].dtype == np.int32
