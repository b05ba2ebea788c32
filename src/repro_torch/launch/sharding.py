"""Per-architecture parameter / optimizer / batch / cache sharding rules
(the port of ``repro.launch.sharding``).

Strategy: FSDP (weights sharded over the data axes, ZeRO-3) x TP (d_ff /
head / vocab dims over "model") x EP (experts over "model" when E >=
|model|).  Optimizer moments mirror parameter specs.  KV caches shard
batch over data and kv-heads over "model" — with divisibility-aware
fallbacks (cache length = split-KV decode, then head_dim) because a dim
is only sharded where it divides evenly by its shard count; ragged
vocabularies (50280, 51865, ...) fall back from vocab- to d_model-
sharding the same way.

The rules are path-keyed (leaf name + rank) and written in JAX's terms:
a :class:`PartitionSpec` names, for each *tensor* dim, the mesh axis (or
tuple of axes) that splits it, so the rules read line for line like the
JAX package's.  A DTensor's placements name, for each *mesh* dim, the
tensor dim it splits: :func:`to_placements` turns one into the other,
and :func:`named` / :func:`distribute` apply it to a tree.

Every rule takes a shape tree (meta tensors, or anything with
``.shape``) and a mesh: a ``DeviceMesh``, or any stand-in with ``.shape``
(a mapping of axis sizes) and ``.axis_names``.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence, Tuple

from ..configs.base import ArchConfig, ShapeSpec
from ..optim import OptState
from .mesh import data_axes, mesh_sizes

__all__ = [
    "PartitionSpec", "NamedSharding", "param_specs", "batch_specs",
    "cache_specs", "named",
    "opt_specs", "to_placements", "distribute", "map_with_path",
    "local_shape",
]


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of axis names (split over their product, major to minor).
    Compares equal, entry for entry, to JAX's ``PartitionSpec``, which
    also writes a one-axis tuple as the axis name."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A mesh and the DTensor placements of one leaf on it (JAX's
    ``NamedSharding``); a leaf of a shardings tree."""
    mesh: Any
    placements: tuple


def map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over nested dicts and (named) tuples; ``path`` is
    the tuple of keys (field names for a NamedTuple, indices for a
    tuple) from the root — what ``jax.tree_util.tree_map_with_path``
    gives the JAX rules."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, (PartitionSpec,
                                                          NamedSharding)):
        fields = getattr(tree, "_fields", None)
        kids = [map_with_path(fn, v, path + (fields[i] if fields else str(i),))
                for i, v in enumerate(tree)]
        return type(tree)(*kids) if fields else tuple(kids)
    return fn(path, tree)


def _axis_size(mesh, axis) -> int:
    sizes = mesh_sizes(mesh)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def _assign(mesh, shape: Sequence[int],
            wants: List[Tuple[int, Any]]) -> PartitionSpec:
    """Build a PartitionSpec assigning each (dim, axis) in priority order,
    skipping assignments whose dim doesn't divide or whose axis/dim is
    already taken."""
    spec: List[Any] = [None] * len(shape)
    used = set()
    for dim, axis in wants:
        if dim < 0:
            dim += len(shape)
        if dim >= len(shape) or spec[dim] is not None:
            continue
        key = tuple(axis) if isinstance(axis, tuple) else (axis,)
        if any(a in used for a in key):
            continue
        if shape[dim] % _axis_size(mesh, axis) != 0 or shape[dim] == 0:
            continue
        spec[dim] = axis
        used.update(key)
    return P(*spec)


def param_specs(cfg: ArchConfig, params_shape, mesh) -> Any:
    dp = data_axes(mesh)
    fsdp = dp[-1]  # shard weights over "data" (pod axis pure DP for weights)
    M = "model"
    ep = cfg.n_experts >= mesh_sizes(mesh)[M]

    def rule(names, leaf):
        name = names[-1]
        shape = tuple(leaf.shape)
        r = len(shape)
        if name == "embed":                       # (V, D)
            return _assign(mesh, shape, [(0, M), (1, fsdp), (1, M)])
        if name == "head":                        # (D, V)
            return _assign(mesh, shape, [(1, M), (0, fsdp), (0, M)])
        if name == "router":                      # (..., D, E)
            return _assign(mesh, shape, [(r - 2, fsdp)])
        if name in ("w_gate", "w_up") and r >= 4 and "moe" in names:
            if ep:                                # (S, E, D, F)
                return _assign(mesh, shape, [(r - 3, M), (r - 2, fsdp)])
            return _assign(mesh, shape, [(r - 1, M), (r - 2, fsdp)])
        if name == "w_down" and r >= 4 and "moe" in names:
            if ep:                                # (S, E, F, D)
                return _assign(mesh, shape, [(r - 3, M), (r - 1, fsdp)])
            return _assign(mesh, shape, [(r - 2, M), (r - 1, fsdp)])
        if name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj"):
            # (..., D, F): TP on the output dim, FSDP on the input dim
            return _assign(mesh, shape,
                           [(r - 1, M), (r - 2, fsdp), (r - 2, M)])
        if name in ("wo", "w_down", "out_proj"):
            return _assign(mesh, shape,
                           [(r - 2, M), (r - 1, fsdp), (r - 1, M)])
        if name in ("conv_w", "conv_b"):          # (..., w, Cdim)
            return _assign(mesh, shape, [(r - 1, M)])
        return P()  # norms, gates, dt_bias, A_log, D — replicated

    return map_with_path(rule, params_shape)


def opt_specs(pspecs):
    """Optimizer state mirrors parameter sharding; step is replicated."""
    return OptState(step=P(), mu=pspecs, nu=pspecs)


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, batch_shape, mesh):
    dp = data_axes(mesh)
    n_dp = _axis_size(mesh, tuple(dp))

    def rule(names, leaf):
        name = names[-1]
        s = tuple(leaf.shape)
        if not s or s[0] % n_dp:
            return P()
        if name in ("tokens", "labels", "token"):
            return P(dp, *([None] * (len(s) - 1)))
        if name in ("images", "frames"):
            return _assign(mesh, s, [(0, dp), (2, "model")])
        return P()

    return map_with_path(rule, batch_shape)


def cache_specs(cfg: ArchConfig, shape: ShapeSpec, cache_shape, mesh):
    dp = data_axes(mesh)
    n_dp = _axis_size(mesh, tuple(dp))
    M = "model"

    def rule(names, leaf):
        name = names[-1]
        s = tuple(leaf.shape)
        r = len(s)
        if name in ("k", "v"):
            # (..., B, L, G, hd): batch over dp; model over kv-heads,
            # falling back to cache length (split-KV) then head_dim
            b_dim, l_dim, g_dim, h_dim = r - 4, r - 3, r - 2, r - 1
            wants = []
            if s[b_dim] % n_dp == 0 and s[b_dim] >= n_dp:
                wants.append((b_dim, dp))
            else:
                # batch too small (e.g. long_500k B=1): split cache length
                wants.append((l_dim, dp))
            wants += [(g_dim, M), (l_dim, M), (h_dim, M)]
            return _assign(mesh, s, wants)
        if name == "ssm":
            # (..., B, H, P, N)
            b_dim, h_dim, p_dim = r - 4, r - 3, r - 2
            wants = [(b_dim, dp)] if s[b_dim] % n_dp == 0 and s[b_dim] >= n_dp else []
            wants += [(h_dim, M), (p_dim, M)]
            return _assign(mesh, s, wants)
        if name == "conv":
            # (..., B, w, Cdim)
            b_dim, c_dim = r - 3, r - 1
            wants = [(b_dim, dp)] if s[b_dim] % n_dp == 0 and s[b_dim] >= n_dp else []
            wants += [(c_dim, M)]
            return _assign(mesh, s, wants)
        return P()  # len counters

    return map_with_path(rule, cache_shape)


# ------------------------------------------------------- specs -> DTensor


def to_placements(mesh, spec: PartitionSpec) -> tuple:
    """The DTensor placements, one per mesh dim, of ``spec``: ``Shard(d)``
    on every mesh dim of size > 1 that an entry of tensor dim ``d``
    names, else ``Replicate()`` (a split over one rank is that layout:
    ``layers.one_rank_replicated``).  A tuple entry such as ``("pod",
    "data")`` shards its dim over those mesh dims in mesh order (the
    order DTensor splits in); any other order raises."""
    from torch.distributed.tensor import Replicate, Shard

    from ..models.layers import one_rank_replicated

    sizes = mesh_sizes(mesh)
    axes = list(sizes)
    out = [Replicate()] * len(axes)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        idx = [axes.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{tuple(axes)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {axes[i]!r} named twice in "
                                 f"{spec!r}")
            out[i] = Shard(d)
    return one_rank_replicated(sizes.values(), out)


def local_shape(mesh, spec: PartitionSpec, shape: Sequence[int]) -> tuple:
    """One rank's shard shape of a ``shape`` tensor under ``spec`` (the
    rules only shard dims that divide evenly)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            n = _axis_size(mesh, tuple(entry) if isinstance(entry, tuple)
                           else entry)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                                 f"over {entry!r} ({n})")
            out[d] //= n
    return tuple(out)


def named(mesh, spec_tree):
    """A spec tree as a tree of :class:`NamedSharding` on ``mesh``."""
    return map_with_path(
        lambda _, s: NamedSharding(mesh, to_placements(mesh, s)), spec_tree)


def distribute(tree, mesh, spec_tree):
    """Place the leaves of ``tree`` on ``mesh`` by ``spec_tree``
    (``distribute_tensor``: every rank passes the whole leaf, rank 0's
    values are kept)."""
    from torch.distributed.tensor import distribute_tensor

    flat = {}
    map_with_path(lambda p, s: flat.__setitem__(p, s), spec_tree)
    return map_with_path(
        lambda p, t: distribute_tensor(t, mesh, to_placements(mesh, flat[p])),
        tree)
