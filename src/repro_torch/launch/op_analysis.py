"""Op-level cost counting: the port's counterpart of
``repro.launch.hlo_analysis``.

The JAX package counts the three roofline inputs from the compiled HLO
text.  PyTorch runs eagerly and has no HLO, so :func:`analyze` runs the
function under a ``TorchDispatchMode`` and counts every aten op that
reaches it, on real tensors or on fake ones (``FakeTensorMode``, no
allocation).  On DTensors it counts what one rank runs: the mode lets
DTensor handle its own ops and sees the local ops and collectives they
issue, so every number is per device, as the SPMD module's are.

The rules are ``hlo_analysis.py``'s, per aten op:

* **flops** — ``mm``/``bmm``/``addmm``/``baddbmm``/``convolution``:
  2 x numel(result) x contraction size; each elementwise op of the JAX
  list (and its in-place form): numel(result); a reduction:
  max(numel(input), numel(result)).
* **bytes** — 2 x the result bytes of every op that materialises its
  result.  This is the one deliberate divergence from the HLO byte
  model: XLA fuses elementwise chains into one kernel whose
  intermediates never reach HBM, while eager PyTorch materialises every
  op's result, so here every op but a view (or an ``empty``) counts.
* **collectives** — the result bytes of each ``_c10d_functional``
  collective (what DTensor's redistributions and the models' regions
  issue), under JAX's op names, and of each ``c10d`` send as a
  ``collective-permute``; added to bytes once as well.  The result
  shapes are kept too (:attr:`CostMode.collective_shapes`), so a record
  can say which tensor a collective moved.

There are no loops to multiply: eager execution runs every layer and
every step, so the counts are trip-count aware by construction.

Only the run's own ops count.  DTensor works out an op's sharding the
first time it meets it by running the op on fake tensors of the
*global* shape, built by ``torch.empty_strided`` (the models never call
it); those ops reach the mode too.  So a tensor built by
``empty_strided`` from no tensor, and every result of an op that reads
one, is DTensor's own and counts nothing; and on real tensors a fake
result is never the run's.

The mode also tracks the bytes alive on the device: every storage an
op of the run allocates (a result that aliases no input) counts until
it is freed (a weak reference on the storage), and :attr:`CostMode.peak_bytes` is
the most alive at once — what a caching allocator would have to hold,
beyond the tensors that existed before the run.  An op whose kernel
returns its input's storage while its fake (meta) version allocates a
new one (:data:`_RETURNS_INPUT`: a collective's ``wait_tensor``) shares
its input's entry, freed when the last of the two storages is gone.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .collectives import COLLECTIVES, collective_kind

__all__ = ["OpCost", "analyze", "CostMode"]


_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "convolution"}

# the JAX list (hlo_analysis._ELEMENTWISE_FLOP_OPS) in aten's names
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "pow", "tanh",
    "exp", "log", "rsqrt", "sqrt", "neg", "abs", "cos", "sin", "sigmoid",
    "expm1", "log1p", "atan2", "eq", "ne", "lt", "le", "gt", "ge", "where",
    "floor", "ceil", "round", "sign", "remainder", "clamp", "clamp_min",
    "clamp_max", "logical_and", "logical_or", "logical_not", "bitwise_and",
    "bitwise_or", "bitwise_not", "silu", "gelu", "softplus", "logaddexp",
    "tanh_backward", "sigmoid_backward", "silu_backward", "gelu_backward",
    "threshold_backward", "masked_fill", "lerp", "reciprocal", "square",
}

_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "var", "std", "var_mean", "norm", "linalg_vector_norm", "cumsum",
    "argmax", "argmin", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "any", "all",
}

# results that are not written: no bytes
_NO_WRITE = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "lift_fresh", "wait_tensor"}

# ops whose kernel returns their (first) input's storage, while their
# meta kernel, run on fake tensors, allocates another: the result is
# the input's bytes, not new ones.  Every other ``_c10d_functional`` op
# of the models' paths makes a new storage on real tensors too.
_RETURNS_INPUT = {("_c10d_functional", "wait_tensor")}


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {op: 0.0 for op in COLLECTIVES}
    )

    def __iadd__(self, other: "OpCost"):
        self.flops += other.flops
        self.bytes += other.bytes
        for k in self.collectives:
            self.collectives[k] += other.collectives[k]
        return self

    def scaled(self, m: float) -> "OpCost":
        return OpCost(
            flops=self.flops * m,
            bytes=self.bytes * m,
            collectives={k: v * m for k, v in self.collectives.items()},
        )


def _tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _base_name(func) -> str:
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") else name


def _contraction(name: str, args) -> int:
    if name == "mm":
        return args[0].shape[-1]
    if name == "bmm":
        return args[0].shape[-1]
    if name == "addmm":
        return args[1].shape[-1]
    if name == "baddbmm":
        return args[1].shape[-1]
    # convolution(input, weight, ...): C_in/groups x kernel spatial
    w = args[1]
    return max(w.numel() // max(w.shape[0], 1), 1)


class CostMode(TorchDispatchMode):
    """Counts :class:`OpCost` over every op of the run that reaches it on
    a plain or fake tensor (``fake_mode``: the run's fake mode, None on
    real tensors); a tensor subclass (a DTensor) handles its own op
    first and its local ops come back through the mode."""

    _PLAIN = (torch.Tensor, torch.nn.Parameter)

    def __init__(self, fake_mode=None):
        super().__init__()
        self.cost = OpCost()
        self.ops = 0
        self.fake_mode = fake_mode
        self.live_bytes = 0
        self.peak_bytes = 0
        # storage key -> [bytes, storages alive]; storages that are one
        # on the device (a waited result and its input) share one entry
        self._live: Dict[int, list] = {}
        self._shadow: set = set()   # ids of DTensor's global-shape stand-ins
        # (kind, result shape, dtype) -> count, of every collective
        self.collective_shapes: Dict[tuple, int] = {}

    @classmethod
    def _counted_type(cls, t) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor

        return t in cls._PLAIN or issubclass(t, FakeTensor)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not all(self._counted_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        outs = _tensors(out)
        ins = _tensors(args) + _tensors(list(kwargs.values()))
        if (any(id(t) in self._shadow for t in ins)
                or (not ins and func is torch.ops.aten.empty_strided.default)):
            for t in outs:
                self._shadow.add(id(t))
                weakref.finalize(t, self._shadow.discard, id(t))
        elif self._ours(outs):
            self._count(func, args, outs)
            if (func.namespace, func.overloadpacket.__name__) in _RETURNS_INPUT:
                self._share(ins[0], outs)
            elif not any(r.alias_info is not None
                         for r in func._schema.returns):
                self._track(outs)   # not a view, nor written in place
        return out

    def _ours(self, outs) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor

        return all(isinstance(t, FakeTensor) or self.fake_mode is None
                   for t in outs)

    def _free(self, key: int) -> None:
        entry = self._live.pop(key, None)
        if entry is not None:
            entry[1] -= 1
            if entry[1] == 0:
                self.live_bytes -= entry[0]

    def _add(self, st, entry: list) -> None:
        self._live[st._cdata] = entry
        entry[1] += 1
        weakref.finalize(st, self._free, st._cdata)

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            if st._cdata in self._live:
                continue
            self._add(st, [st.nbytes(), 0])
            self.live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _share(self, src, outs) -> None:
        """``outs`` are ``src``'s storage on the device: one entry for
        both (none where ``src`` is not the run's)."""
        entry = self._live.get(src.untyped_storage()._cdata)
        for t in outs:
            st = t.untyped_storage()
            if entry is not None and st._cdata not in self._live:
                self._add(st, entry)

    def _count(self, func, args, outs) -> None:
        self.ops += 1
        c = self.cost
        kind = collective_kind(func)
        if kind is not None:
            if kind == "collective-permute":      # a send: its payload
                n = sum(_nbytes(t) for t in _tensors(args[0]))
            else:
                n = sum(_nbytes(t) for t in outs)
                for t in outs:
                    key = (kind, tuple(t.shape), str(t.dtype))
                    self.collective_shapes[key] = (
                        self.collective_shapes.get(key, 0) + 1)
            c.collectives[kind] += n
            c.bytes += n
            return
        name = _base_name(func)
        numel = sum(t.numel() for t in outs)
        if name in _MATMULS:
            c.flops += 2.0 * numel * _contraction(name, args)
        elif name in _ELEMENTWISE:
            c.flops += numel
        elif name in _REDUCTIONS:
            ins = _tensors(args[:1])
            c.flops += max(ins[0].numel() if ins else 0, numel)
        if (name in _NO_WRITE or func.is_view
                or func.namespace in ("c10d", "_c10d_functional")):
            return
        c.bytes += 2.0 * sum(_nbytes(t) for t in outs)


def analyze(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), OpCost)``: the ops ``fn`` runs, counted per
    device.  Give it fake tensors (under ``FakeTensorMode``, which it
    finds on the mode stack) to count without allocating."""
    from torch._guards import detect_fake_mode

    mode = CostMode(detect_fake_mode())
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.cost
