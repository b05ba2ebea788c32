"""The port's planners, plan IR and codecs vs the JAX package.

Plans are pure Python on both sides, so they must agree exactly: op for
op (normalised to tuples by ``_norm``), ``stats()``, ``breakdown()``,
op counts and stage keys, for every engine x paper stencil, compressed
or not, and for all 48 entries of ``tests/data/golden_row_plans.json``.
The codecs are host numpy code: their payloads are byte-identical.
"""
import dataclasses
import json
import math
import os
import re

import numpy as np
import pytest

from repro.core import compress as jcomp
from repro.core import oocore as joo
from repro.core import stencil as jst
from repro_torch.core import compress as tcomp
from repro_torch.core import oocore as too
from repro_torch.core import stencil as tst
from repro_torch.core.executor import DryRunExecutor
from repro_torch.core.plan import Box

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_row_plans.json")
ENGINES = ("incore", "naive_tb", "resreu", "so2dr")
RNG = np.random.default_rng(5)


def _val(v):
    if type(v).__name__ == "Box":
        return ("Box", tuple(v.lo), tuple(v.hi))
    if isinstance(v, (tuple, list)):
        return tuple(_val(e) for e in v)
    return v


def _norm(op):
    """One op of either package as a plain tuple: type name + fields."""
    return (type(op).__name__,) + tuple(
        (f.name, _val(getattr(op, f.name))) for f in dataclasses.fields(op))


def _assert_same_plan(tp, jp):
    assert [_norm(o) for o in tp.ops] == [_norm(o) for o in jp.ops]
    for f in ("engine", "stencil", "shape", "itemsize", "n", "d", "k_off",
              "k_on", "exact_elements", "codec", "chunk_axis", "tiles"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert dataclasses.asdict(tp.stats()) == dataclasses.asdict(jp.stats())
    assert tp.breakdown() == jp.breakdown()
    assert tp.op_counts() == jp.op_counts()
    assert [k for k, _ in tp.stages()] == [k for k, _ in jp.stages()]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", jst.PAPER_BENCHMARKS)
@pytest.mark.parametrize("codec", [None, "bf16", "zrle"])
def test_plans_equal_jax(engine, name, codec):
    d = 1 if engine == "incore" else 3
    args = (70, 40, 10, d, 4, 3)
    tp = too.compile_plan(engine, tst.get_stencil(name), *args, codec=codec)
    jp = joo.compile_plan(engine, jst.get_stencil(name), *args, codec=codec)
    _assert_same_plan(tp, jp)
    _, stats = DryRunExecutor().execute(tp)
    assert stats == tp.stats()


@pytest.mark.parametrize("name", ["box2d1r", "gradient2d", "heat3d1r"])
def test_box_and_nd_plans_equal_jax(name):
    st_t, st_j = tst.get_stencil(name), jst.get_stencil(name)
    shape = (30, 28, 26) if st_t.ndim == 3 else (40, 36)
    tiles = (2, 2, 1) if st_t.ndim == 3 else (2, 3)
    _assert_same_plan(
        too.compile_box_plan(st_t, shape, 6, tiles, 3, k_on=2),
        joo.compile_box_plan(st_j, shape, 6, tiles, 3, k_on=2))
    for engine in ENGINES[1:]:
        _assert_same_plan(
            too.compile_plan_nd(engine, st_t, shape, 6, 2, 3, 2, chunk_axis=1),
            joo.compile_plan_nd(engine, st_j, shape, 6, 2, 3, 2, chunk_axis=1))


def test_infeasible_configs_raise_like_jax():
    st_t, st_j = tst.get_stencil("box2d4r"), jst.get_stencil("box2d4r")
    for args in [("so2dr", 40, 20, 8, 4, 8, 2), ("resreu", 30, 20, 2, 8, 1, 1)]:
        with pytest.raises(ValueError) as jexc:
            joo.compile_plan(args[0], st_j, *args[1:])
        with pytest.raises(ValueError) as texc:
            too.compile_plan(args[0], st_t, *args[1:])
        assert str(texc.value) == str(jexc.value)


def _op_as_row_record(op):
    """A port op in the golden fixture's row-field schema."""
    t = type(op).__name__
    d = {"type": t}
    if t == "H2D":
        d.update(reg=op.reg, host_lo=op.box.lo[0], host_hi=op.box.hi[0],
                 nbytes=op.nbytes, round=op.round, chunk=op.chunk)
    elif t == "D2H":
        d.update(reg=op.reg, reg_lo=op.reg_box.lo[0], reg_hi=op.reg_box.hi[0],
                 host_lo=op.box.lo[0], host_hi=op.box.hi[0],
                 nbytes=op.nbytes, round=op.round, chunk=op.chunk)
    elif t == "BufferWrite":
        d.update(buf=op.buf, reg=op.reg, reg_lo=op.reg_box.lo[0],
                 reg_hi=op.reg_box.hi[0], nbytes=op.nbytes, round=op.round,
                 chunk=op.chunk)
    elif t == "BufferRead":
        d.update(reg=op.reg, buf=op.buf, src=op.src, nbytes=op.nbytes,
                 rows=op.extent, round=op.round, chunk=op.chunk)
    elif t == "FusedKernel":
        d.update(reg=op.reg, stencil=op.stencil, steps=op.steps,
                 keep_top=op.keep_lo[0], keep_bottom=op.keep_hi[0],
                 h_in=op.shape_in[0], h_out=op.shape_out[0],
                 width=math.prod(op.shape_in[1:]), hbm_bytes=op.hbm_bytes,
                 flops=op.flops, elements=op.elements, round=op.round,
                 chunk=op.chunk)
    elif t in ("Compress", "Decompress"):
        d.update(codec=op.codec, reg=op.reg, direction=op.direction,
                 raw_nbytes=op.raw_nbytes, wire_nbytes=op.wire_nbytes,
                 host_lo=op.box.lo[0], host_hi=op.box.hi[0],
                 round=op.round, chunk=op.chunk)
    elif t == "HostCommit":
        d.update(nbytes=op.nbytes, round=op.round)
    return d


def test_golden_row_plans():
    """All 48 fixture entries recompile to the exact same schedule in the
    port, and infeasible ones fail with the exact same message."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert len(golden) == 48
    checked = errors = 0
    for key, rec in golden.items():
        eng, stname, geom, codec = key.split("/")
        codec_arg = None if codec == "identity" else codec
        if "error" in rec:
            g = re.match(r"Y(\d+)X(\d+)n(\d+)d(\d+)ko(\d+)ki(\d+)", geom)
            Y, X, n, d, ko, ki = map(int, g.groups())
            with pytest.raises(ValueError) as exc:
                too.compile_plan(eng, tst.get_stencil(stname), Y, X, n, d,
                                 ko, ki, codec=codec_arg)
            assert str(exc.value) == rec["error"], key
            errors += 1
            continue
        m = rec["plan"]
        plan = too.compile_plan(eng, tst.get_stencil(m["stencil"]), m["Y"],
                                m["X"], m["n"], m["d"], m["k_off"], m["k_on"],
                                itemsize=m["itemsize"], codec=codec_arg)
        assert plan.exact_elements == m["exact_elements"], key
        assert [_op_as_row_record(op) for op in plan.ops] == rec["ops"], key
        assert dataclasses.asdict(plan.stats()) == rec["stats"], key
        assert plan.breakdown() == rec["breakdown"], key
        assert plan.op_counts() == rec["op_counts"], key
        stage_keys = [list(k) if k else None for k, _ in plan.stages()]
        assert stage_keys == rec["stage_keys"], key
        checked += 1
    assert checked + errors == 48 and checked >= 40, (checked, errors)


@pytest.mark.parametrize("codec", ["identity", "bf16", "zrle"])
def test_codec_payloads_byte_identical(codec):
    x = RNG.standard_normal((13, 17)).astype(np.float32)
    x[3, :5] = 0.0
    x[4] = x[3]
    x[0, 0], x[1, 1], x[2, 2] = -0.0, np.inf, np.nan
    tc, jc = tcomp.get_codec(codec), jcomp.get_codec(codec)
    payload = tc.encode(x)
    assert payload.tobytes() == jc.encode(x).tobytes()
    out = tc.decode(payload, x.shape, x.dtype)
    assert out.tobytes() == jc.decode(payload, x.shape, x.dtype).tobytes()
    if tc.lossless:
        assert out.tobytes() == x.tobytes()
    for raw in (0, 4, 100, 4096):
        assert tc.wire_nbytes(raw, 4) == jc.wire_nbytes(raw, 4)


def test_compress_plan_rejects_what_jax_rejects():
    st = tst.get_stencil("box2d1r")
    plan = too.compile_plan("so2dr", st, 30, 20, 4, 2, 2, 2, codec="zrle")
    with pytest.raises(ValueError, match="already compressed"):
        tcomp.compress_plan(plan, "bf16")
    plan8 = too.compile_plan("so2dr", st, 30, 20, 4, 2, 2, 2, itemsize=8)
    with pytest.raises(ValueError, match="itemsize"):
        tcomp.compress_plan(plan8, "bf16")
    with pytest.raises(TypeError):
        tcomp.compress_plan(object(), "bf16")


def test_box_helpers():
    b = Box((2, 3), (10, 7))
    assert b.shape == (8, 4) and b.volume == 32
    assert b.shrink((1, 0), (0, 1)) == Box((3, 3), (10, 6))
    assert Box.span((20, 9), 0, 4, 6) == Box((4, 0), (6, 9))
    with pytest.raises(ValueError):
        Box((3,), (2,))
