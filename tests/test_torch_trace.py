"""The port's spans and copy counters (:mod:`repro_torch.core.trace`,
``ExecStats.pad_bytes`` / ``share_bytes``), on the CPU unless marked.

Under ``torch.profiler`` a solve names its domain copy, every chunk stage
and each round's commit wait and drain; a solve that leases a page-locked
domain (on a card, or on the CPU with page-locking faked) also names the
copy of its answer out, and the page-locking of a new domain, once; with
no profiler on no range is entered;
the answer is bitwise the same either way; the counters equal a count of
the plan's concatenations made from its ops and bucket heights.  Also
the script that reads them on the card (``examples/torch_solve_spans.py``),
on a profiled CPU window and on a hand-made trace.  No JAX import: the
card case runs on the GPU machine as it is.
"""
import collections
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import trace
from repro_torch.core.executor import DoubleBufferedExecutor, EagerExecutor
from repro_torch.core.lower import DomainPool, ExecStats, _bucket_heights
from repro_torch.core.oocore import compile_plan
from repro_torch.core.plan import BufferRead, FusedKernel, HostCommit
from repro_torch.core.stencil import get_stencil
from repro_torch.kernels.dispatch import DispatchPolicy
from repro_torch.serve import StencilJob, StencilService

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(28)
EXECUTORS = {"double_buffered": DoubleBufferedExecutor,
             "eager": EagerExecutor}
# case -> compile_plan arguments (engine, stencil, Y, X, n, d, k_off, k_on)
PLANS = {
    "so2dr-gradient2d": ("so2dr", "gradient2d", 40, 30, 8, 3, 4, 2),
    "so2dr-box2d4r": ("so2dr", "box2d4r", 72, 40, 8, 3, 4, 2),
    "incore-box2d4r": ("incore", "box2d4r", 40, 40, 8, 1, 4, 2),
}


def _plan(case):
    engine, name, *args = PLANS[case]
    return compile_plan(engine, get_stencil(name), *args)


def _domain(plan):
    return RNG.standard_normal(tuple(plan.shape)).astype(np.float32)


def _spans(fn):
    """``fn()`` under the CPU profiler: its result and the program's range
    names in start order, the prefix stripped."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted((e for e in prof.events()
                     if e.name.startswith(trace.PREFIX)),
                    key=lambda e: e.time_range.start)
    return out, [e.name[len(trace.PREFIX):] for e in events]


def _stage_names(plan):
    """One name per chunk stage: each run of ops of one (round, chunk)
    between HostCommit barriers, in plan order."""
    names, prev = [], None
    for op in plan.ops:
        if isinstance(op, HostCommit):
            prev = None
            continue
        if (op.round, op.chunk) != prev:
            prev = (op.round, op.chunk)
            names.append(f"stage.r{op.round}.c{op.chunk}")
    return names


def _copy_bytes(plan):
    """(pad, share) bytes from the plan alone: a banded kernel below its
    group's bucket height pads to a band of that height; a BufferRead's
    concatenation is the register the next kernel on it reads."""
    buckets = _bucket_heights(plan, True)
    pad = share = 0
    shared = set()
    for op in plan.ops:
        if isinstance(op, BufferRead):
            shared.add(op.reg)
        elif isinstance(op, FusedKernel):
            h, w = op.shape_in
            if op.reg in shared:
                shared.discard(op.reg)
                share += h * w * plan.itemsize
            key = (op.stencil, op.steps, op.keep_lo[0], op.keep_hi[0])
            if buckets.get(key, h) > h:
                pad += buckets[key] * w * plan.itemsize
    return pad, share


@pytest.mark.parametrize("case", PLANS)
@pytest.mark.parametrize("executor", EXECUTORS)
def test_a_profiled_solve_names_its_spans(executor, case):
    plan = _plan(case)
    ex = EXECUTORS[executor](device="cpu")
    _, names = _spans(lambda: ex.execute(plan, _domain(plan)))
    counts = collections.Counter(names)
    rounds = sum(isinstance(op, HostCommit) for op in plan.ops)
    assert counts["domain_copy"] == 1 and names[0] == "domain_copy"
    assert [n for n in names if n.startswith("stage.")] == _stage_names(plan)
    assert counts["commit.wait"] == counts["commit.drain"] == rounds >= 1
    # no copy stream on the CPU: nothing is page-locked
    assert counts["pin"] == counts["unpin"] == 0
    assert set(counts) == {"domain_copy", "commit.wait", "commit.drain"} \
        | set(_stage_names(plan))


@pytest.mark.parametrize("case", PLANS)
def test_a_leased_solve_names_its_spans(case, monkeypatch):
    """Page-locking faked on the CPU: the first solve page-locks its new
    domain after the copy in, the second page-locks nothing, and both
    copy the answer out last; the pool unlocks its domain when it goes."""
    lower_mod = sys.modules[DomainPool.__module__]
    monkeypatch.setattr(lower_mod, "host_register", lambda arr: None)
    monkeypatch.setattr(lower_mod, "host_unregister", lambda arr: None)
    plan = _plan(case)
    x = _domain(plan)
    ex = DoubleBufferedExecutor(device="cpu")
    ex.domain_pool = DomainPool()
    rounds = sum(isinstance(op, HostCommit) for op in plan.ops)
    answers = []
    for first in (True, False):
        (out, _), names = _spans(lambda: ex.execute(plan, x))
        answers.append(out)
        counts = collections.Counter(names)
        head = ["domain_copy", "pin"] if first else ["domain_copy"]
        assert names[:len(head)] == head and names[-1] == "answer_copy"
        assert [n for n in names if n.startswith("stage.")] == \
            _stage_names(plan)
        assert counts["commit.wait"] == counts["commit.drain"] == rounds
        assert set(counts) == {"domain_copy", "commit.wait", "commit.drain",
                               "answer_copy"} | set(head) \
            | set(_stage_names(plan))
        assert counts["domain_copy"] == counts["answer_copy"] == 1
    np.testing.assert_array_equal(answers[1], answers[0])
    _, names = _spans(ex.domain_pool.close)
    assert names == ["unpin"]


def test_an_unprofiled_solve_enters_no_range(monkeypatch):
    def refuse(name):
        raise RuntimeError(f"range {name} entered")

    monkeypatch.setattr(trace, "record_function", refuse)
    assert trace.span("a") is trace.span("b")
    plan = _plan("so2dr-gradient2d")
    x = _domain(plan)
    for cls in EXECUTORS.values():
        cls(device="cpu").execute(plan, x)
    # the patched name is the one a profiled solve enters
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="domain_copy"):
            DoubleBufferedExecutor(device="cpu").execute(plan, x)


@pytest.mark.parametrize("case", PLANS)
def test_copy_counters_count_the_plans_concatenations(case):
    plan = _plan(case)
    pad, share = _copy_bytes(plan)
    if case.startswith("so2dr"):
        assert pad > 0 and share > 0
    else:
        assert pad == share == 0
    for cls in EXECUTORS.values():
        ex = cls(device="cpu")
        ex.execute(plan, _domain(plan))
        es = ex.exec_stats
        assert (es.pad_bytes, es.share_bytes) == (pad, share)
        total = ExecStats().merge(es).merge(es)
        assert (total.pad_bytes, total.share_bytes) == (2 * pad, 2 * share)


def test_the_service_carries_the_copy_counters():
    svc = StencilService(policy=DispatchPolicy(impl="reference"),
                         device="cpu")
    job = StencilJob(shape=(40, 30), stencil="gradient2d", steps=8,
                     d=3, s_tb=4, k_on=2)
    for _ in range(2):
        svc.submit(job, RNG.standard_normal((40, 30)).astype(np.float32))
    flushed = svc.flush()
    solo = svc.run_solo(job, RNG.standard_normal((40, 30)).astype(np.float32))
    want = (solo.exec_stats.pad_bytes, solo.exec_stats.share_bytes)
    assert want == _copy_bytes(svc.compile_job(job, itemsize=4).plan)
    assert want[0] > 0 and want[1] > 0
    assert all((r.exec_stats.pad_bytes, r.exec_stats.share_bytes) == want
               for r in flushed)
    assert (svc.exec_stats.pad_bytes, svc.exec_stats.share_bytes) == \
        (3 * want[0], 3 * want[1])


@pytest.mark.parametrize("case", ["so2dr-gradient2d", "so2dr-box2d4r"])
@pytest.mark.parametrize("executor", EXECUTORS)
def test_the_answer_is_bitwise_with_the_profiler_on(executor, case):
    plan = _plan(case)
    x = _domain(plan)
    ex = EXECUTORS[executor](device="cpu")
    plain, _ = ex.execute(plan, x)
    (traced, _), names = _spans(lambda: ex.execute(plan, x))
    assert names
    np.testing.assert_array_equal(traced, plain)


@pytest.mark.cuda
def test_pin_and_unpin_spans_on_the_card():
    """The pooled order: the first solve page-locks its new domain after
    the copy in, the second neither page-locks nor unlocks, both copy the
    answer out last; the domain is unlocked once, when the pool goes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the copy stream and page-locking "
                    "exist only on a card)")
    plan = _plan("so2dr-gradient2d")
    x = _domain(plan)
    ex = DoubleBufferedExecutor(device="cuda")
    rounds = sum(isinstance(op, HostCommit) for op in plan.ops)
    answers = []
    for first in (True, False):
        (out, _), names = _spans(lambda: ex.execute(plan, x))
        answers.append(out)
        counts = collections.Counter(names)
        assert counts["pin"] == int(first) and counts["unpin"] == 0
        head = ["domain_copy", "pin"] if first else ["domain_copy"]
        assert names[:len(head)] == head
        assert names.index(head[-1]) < names.index("stage.r0.c0")
        assert names[-1] == "answer_copy" and counts["answer_copy"] == 1
        assert counts["commit.wait"] == counts["commit.drain"] == rounds
        assert [n for n in names if n.startswith("stage.")] == \
            _stage_names(plan)
        assert ex.exec_stats.domain_reused == int(not first)
        assert (ex.exec_stats.pad_bytes, ex.exec_stats.share_bytes) == \
            _copy_bytes(plan)
    np.testing.assert_array_equal(answers[1], answers[0])
    _, names = _spans(ex.domain_pool.close)
    assert names == ["unpin"]


# -- examples/torch_solve_spans.py ------------------------------------------


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_solve_spans", os.path.join(ROOT, "examples",
                                          "torch_solve_spans.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _event(name, cat, ts_s, dur_s, **args):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts_s * 1e6,
          "dur": dur_s * 1e6}
    if args:
        ev["args"] = args
    return ev


# a solve of one round: device work, a 4 s idle gap that the domain copy
# (2.5 s) and the pin (1 s) fill on the host, then the round's copies
FIXTURE = [
    _event("so2dr_bench.window", "user_annotation", 0.0, 10.0),
    _event("so2dr_bench.solve", "user_annotation", 0.5, 9.0),
    _event("so2dr_bench.round.0", "user_annotation", 0.6, 8.9),
    _event("fused_band_db_kernel", "kernel", 0.0, 1.0),
    _event("cudaHostRegister", "cuda_runtime", 3.6, 1.0),
    _event("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 5.0, 1.0,
           bytes=4_000_000_000),
    _event("CatArrayBatchedCopy_vect", "kernel", 6.0, 0.5),
    _event("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 7.0, 2.0,
           bytes=8_000_000_000),
]
PROGRAM = [
    _event("repro_torch.domain_copy", "user_annotation", 1.05, 2.5),
    _event("repro_torch.pin", "user_annotation", 3.6, 1.0),
    _event("repro_torch.stage.r0.c0", "user_annotation", 4.7, 1.5),
    _event("repro_torch.commit.wait", "user_annotation", 6.2, 0.8),
    _event("repro_torch.commit.drain", "user_annotation", 7.0, 2.0),
    _event("repro_torch.answer_copy", "user_annotation", 9.0, 0.2),
    _event("repro_torch.unpin", "user_annotation", 9.2, 0.3),
]


def test_the_span_script_reads_a_hand_made_trace():
    from so2dr_bench.trace import _label, gaps, parse

    script = _script()
    events = FIXTURE + PROGRAM
    tr = parse(events)
    program = script.program_spans(events)
    assert [n for _, _, n in program] == [
        "domain_copy", "pin", "stage.r0.c0", "commit.wait", "commit.drain",
        "answer_copy", "unpin"]
    rec = script.readings(tr, program, 1, pad_bytes=3_000_000_000,
                          share_bytes=1_000_000_000)
    assert rec["domain_copy_s"] == pytest.approx(2.5)
    assert rec["pin_s"] == pytest.approx(1.3)
    assert rec["commit_wait_s"] == pytest.approx(0.8)
    assert rec["commit_drain_s"] == pytest.approx(2.0)
    assert rec["answer_copy_s"] == pytest.approx(0.2)
    assert rec["dtoh_s"] == pytest.approx(2.0)
    assert rec["cat_s"] == pytest.approx(0.5)
    assert rec["cat_write_gbps"] == pytest.approx(8.0)
    assert (rec["pad_gb"], rec["share_gb"], rec["stage_spans"]) == \
        (3.0, 1.0, 1)
    gap = max(gaps(tr), key=lambda g: g[1] - g[0])
    assert gap == pytest.approx((1.0, 5.0))
    assert _label(gap, tr) == "round.0: cudaHostRegister"
    assert script.label(gap, tr, program) == \
        "round.0: domain_copy: cudaHostRegister"
    assert rec["idle_gaps"][0] == [
        "round.0: domain_copy: cudaHostRegister", pytest.approx(4.0)]

    # a trace without the program's ranges (an older program): the
    # benchmark's labels exactly, and nothing read from the spans
    bare = parse(FIXTURE)
    assert script.program_spans(FIXTURE) == []
    for g in gaps(bare):
        assert script.label(g, bare, []) == _label(g, bare)
    rec = script.readings(bare, [], 1, 0, 0)
    assert rec["domain_copy_s"] == rec["pin_s"] == rec["commit_wait_s"] \
        == rec["commit_drain_s"] == rec["answer_copy_s"] \
        == rec["stage_spans"] == 0


def test_the_span_script_reads_a_profiled_cpu_window():
    from so2dr_bench import harness

    script = _script()
    cell = harness.load_cell("gradient2d.oocore")
    cell.config = dict(cell.config, n_steps=16, k_off=4, k_on=2)
    cell.traffic = dict(cell.traffic, interior=126)
    rec = script.run_cell(cell.name, 2**31 + 28, 0.0, device="cpu",
                          cell=cell)
    size = 126 + 2 * cell.config["radius"]
    plan = compile_plan("so2dr", get_stencil("gradient2d"), size, size, 16,
                        cell.traffic["d"], 4, 2)
    pad, share = _copy_bytes(plan)
    assert (rec["pad_gb"], rec["share_gb"]) == (pad / 1e9, share / 1e9)
    assert rec["stage_spans"] == len(_stage_names(plan))
    assert rec["domain_copy_s"] > 0 and rec["commit_drain_s"] > 0
    assert rec["commit_wait_s"] >= 0 and rec["pin_s"] == 0
    # the CPU run copies its input once and leases nothing
    assert rec["answer_copy_s"] == 0 and rec["reuse_share"] is None
    assert rec["traced_equals_untraced"] is True
    assert rec["solves"] >= 1 and rec["untraced_solve_s"]
    # no device work on the CPU: the window is one gap, named by the
    # program span that covers the most of it
    assert len(rec["idle_gaps"]) == 1
    assert rec["idle_gaps"][0][0].split(": ")[1] in \
        {"domain_copy", "commit.wait", "commit.drain"} | \
        set(_stage_names(plan))
