#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run, one card
    python3 chip_smoke.py --size N   # the same phases on an N x N domain

Phases, none of them caught — any failure exits non-zero:

1. build and device: build the three CUDA kernels from ``src/repro_torch/
   kernels/csrc`` with nvcc for sm_90a; print the card and its power limit.
2. kernels vs plain: every kernel against its plain PyTorch version on
   the card, over stencils x steps x keep flags x band shapes (the banded
   kernel on the linear stencils only): the fused kernels in fp32
   (<= 1e-5 relative), the banded kernel in fp32 (<= 2e-5 absolute, the
   JAX package's bound for it), all in bf16 (<= 3e-2 relative); then
   CUDA-event times of each kernel, its plain version, the library
   yardstick, the bucketing pad and the host<->device copies at the main
   path's band shape; the one-CTA-per-tile kernel (``cuda``) and the
   persistent ring (``cuda_db``) on each other's band, the ring-vs-
   occupancy yardstick; and all three kernels on the box2d4r main band
   (with the time the banded kernel's own MMAs would take at the dense
   TF32 peak).  Every kernel's launch shape is recorded
   (threads and shared bytes per CTA, CTAs per SM, grid, tile, and for
   ``cuda`` the load path: TMA on the main bands, with >= 3 CTAs per SM
   at box2d1r, checked).
3. main path: SO2DR gradient2d on a 38400 x 38400 fp32 domain (the
   paper's out-of-core size), d=4, k_off=160, k_on=4, n=320, default
   dispatch (auto -> cuda_db), through the double-buffered and the eager
   executor: launch count == kernel calls, the two outputs bitwise equal,
   both within 1e-5 relative of the plain oracle run on the card; the
   sha256 of the double-buffered output is kept for the later phases.
4. the fused kernel on the path: SO2DR box2d1r, same size, n=160, with
   DispatchPolicy(impl="cuda"), checked the same way.
5. the banded kernel on the path: SO2DR box2d4r, same size, the paper's
   box2d4r configuration (d=4, k_off=40, k_on=4), n=80, with
   DispatchPolicy(impl="mxu"), checked the same way.
6. calibrate and tune: fit a DeviceProfile on the card with all four
   kernel impls in the sweep, on box2d4r (saved to
   ``chiprun_out/profile.json``), then rank box2d4r configurations with it
   and measure the top four; each measured candidate must have launched
   its own impl's kernel.
7. recovery: the box2d4r run of phase 5 again, through
   ``run_with_recovery`` with a checkpoint every round (to
   ``chiprun_out/ckpt``, deleted at the end) and a fault plan: a transient
   H2D fault on round 0, chunk 1, twice (retried), and a terminal kernel
   fault on round 1, chunk 2.  The resumed output's sha256 equals phase
   5's; 1 resume, 3 faults, 2 retries; ``mxu`` launched the plan's kernel
   calls plus round 1's calls before the fault.  Records the wall time,
   the seconds per checkpoint save and restore, and phase 5's wall.
8. service: a ``StencilService`` priced by phase 6's profile, default
   dispatch (auto -> ``cuda_db``), flushes three jobs at once, each
   copying on its own stream from a page-locked domain of the service's
   pool: gradient2d (bitwise equal to phase 3's output), box2d1r
   (bitwise equal to phase 4's, computed by ``cuda``) and a two-round
   box2d1r job (n=320) with a terminal kernel fault at round 1 (fails
   with last committed round 0, its domain back in the pool); the slot
   pool balances, the domain pool holds the three domains idle (its
   stats recorded) and, once closed, each can be page-locked again, and
   ``cuda_db`` launched the jobs' kernel calls.  Then a warm gradient2d job
   on a domain 1/16 shorter compiles no kernel and is within 1e-5 of the
   oracle.  Records the flush wall beside the main paths' solo walls,
   the modeled makespans interleaved and back to back, each job's
   latency and the service's counters.
9. sharded: box2d1r on the same domain through ``compile_sharded`` on a
   (4, 2) mesh with ``k_ici=4``, n=160 (the benchmarks' ``sharded/
   box2d1r/mesh4x2/k4`` geometry, cut in ``n`` only), run by
   ``ShardedSimExecutor`` on the card: every rank's band lives on the
   one card, halos move through a mailbox, each round runs the masked
   update (plain PyTorch, no kernel of ``repro_torch.kernels``: all
   three launch counts stay 0).  Within 1e-5 of the oracle; whether it
   is bitwise equal to phase 4's output is recorded; the executed op
   counts equal the plan's, one kernel signature.  Records the wall, the
   host wall per op class and the masked update's CUDA-event ms per
   rank-step on a rank's band.
10. hierarchical: the same stencil through ``compile_hierarchical`` on
   a (2, 2) mesh, ``k_ici=4``, n=16 and a 1 GiB device budget (the
   benchmarks' hierarchical knobs), so each 19208² band streams through
   inner SO2DR chunks: bitwise equal to the flat sharded plan of the same
   n and mesh, and within 1e-5 of the oracle.  Records the inner chunks,
   both walls, and per rank and round the host set-up around the inner
   run (the band's trip to the host and back, the inner run's copy of
   it) beside the inner walk.
11. elastic: the flat (4, 2) plan of n=16 through ``run_elastic_sharded``
   with a rank loss at round 1, rank 3: the mesh shrinks to (3, 2), one
   re-plan, one extra round, within 1e-5 absolute of the fault-free
   sharded run.  Records its wall beside the fault-free sharded run's
   and the fault-free output's sha256.
12. shard_map: the multi-process backend (``ShardMapExecutor``, one
   process per rank, ``torch.distributed`` halo exchanges).  (a) Phase
   9's plan on a (4, 2) group of 8 rank processes sharing the card over
   gloo with halos staged through page-locked host memory: within 1e-5
   of the oracle (a sha256 equal to phase 9's carries its oracle result
   over), bitwise equality with phases 9 and 4 recorded, 0 launches of
   the three kernels; records the wall split (group start, domain in,
   loads, rounds, halo exchange, masked update, stores, domain out) and
   every rank's CUDA-event ms of its masked updates per rank-step
   (time-sliced with the other seven ranks' contexts).  (b) phase 11's
   rank loss through ``run_elastic_sharded`` with ``ShardMapExecutor``,
   its (4, 2) rounds on (a)'s group: mesh (4, 2) -> (3, 2), 1 replan, 1
   extra round, within 1e-5 of phase 11's fault-free output (held by
   its sha256), the harness's (3, 2) group stopped, and no rank process
   alive once (a)'s group is closed.  (c) a (1, 1) plan of n=16 on one
   rank over NCCL: bitwise equal to ``ShardedSimExecutor`` on the same
   plan.
13. lm_serve: the LM stack's serve path (``build_model``, ``init_params``
   from a seeded generator on the card, ``greedy_generate``) at full
   published width: qwen3-0.6b and mamba2-130m whole, mixtral-8x7b with
   ``n_layers`` cut to 2 (the whole model is 187 GB in fp32).  4
   requests of 2048 prompt tokens each, 32 new tokens greedily.  Gates
   (the JAX package's own, tests/test_models.py:55-73): prefill's logits
   within 1e-3 of ``forward``'s last position; the first decode step
   within 5e-2, relative to the max |logit|, of ``forward`` on the
   extended prompt (mixtral at capacity factor E/K, where no assignment
   drops, as the JAX smoke configs hold it: at its own 1.25 a 4-token
   decode step has capacity 1 and drops what ``forward`` keeps; that
   error is recorded); every logit finite, every token in [0, vocab).
   Records prefill and decode-step ms (CUDA events), tokens/s, the
   device memory peak and each decode step's weight-byte bound.  No
   kernel of ``repro_torch.kernels`` launches (the LM stack has none).
14. lm_train: the LM stack's training path (``Trainer.run`` with
   ``AdamW`` on ``SyntheticLM`` batches, weights from a seeded generator
   on the card) at full published width, 4 x 2048 tokens a step.  (a)
   qwen3-0.6b whole, 20 steps at the train CLI's defaults (lr 3e-4,
   warmup 1): every loss finite, the mean of the last 5 below the mean of
   the first 5 minus 0.2 (tests/test_train_loop.py:22); then one step of
   4 microbatches against one of 1 from the trained params (fresh
   moments, lr 1e-3, no clipping): the grads it applies within 5e-2 of
   each leaf's max, and the params after it within 3e-3 absolute
   (tests/test_train_loop.py:27-44).  Records step ms (CUDA events, the
   first step apart), tokens/s, the device peak and the step's FLOP
   bound at the data-sheet bf16 dense rate.  (b) mamba2-130m whole: 6
   steps straight against 3, a checkpoint, a restore and 3 more
   (``ckpt_every=3`` under ``chiprun_out/``, deleted after), every leaf
   bitwise equal, under ``torch.use_deterministic_algorithms``, in a
   process of its own started with ``CUBLAS_WORKSPACE_CONFIG`` set; 20
   steps with bf16 gradient compression converge
   (tests/test_train_loop.py:61-70); seconds per save and restore.  (c)
   mixtral-8x7b with ``n_layers`` cut to 1 (params, grads and two fp32
   moments are 27 GB a layer): 3 steps, losses finite, the router's aux
   loss non-zero, every param leaf moved from the Trainer's initial
   weights (copied to the host); step ms and the device peak.  No kernel
   of ``repro_torch.kernels`` launches.
15. lm_launch: the LM stack's launch layer, in three processes of its
   own: (a), (e) and (c) on the card, (b)'s dry run on the host beside them, and
   (d) on the host from the run's start (its dry runs need no card; see
   below).  (a)-(c), one NCCL group of one rank, with
   ``CUBLAS_WORKSPACE_CONFIG`` set and deterministic algorithms: (a)
   qwen3-0.6b at full width, 3 steps of 4 x 2048 tokens (``SyntheticLM``,
   AdamW with bf16 moments) with the plain ``Trainer``, then the same
   steps from the same weights with params, moments and batch as
   DTensors on a (1, 1) mesh placed by ``replan``, ``opt_specs`` and
   ``batch_specs`` (the dry run's hooks registered): losses and every
   param and moment leaf bitwise equal; step ms (CUDA events) of both
   and the device peak.  (e) then, on the same mesh, one sequence (B =
   1, which the rules split over the data axis of size 1) for
   qwen3-0.6b and mamba2-130m whole: a 2048-token prefill and 8 greedy
   decode steps, and a loss with grads of one 2048-token sequence, on
   DTensors placed by the rules (cache and labels too) against the
   plain path from the same weights: logits, loss and grads bitwise;
   ms (CUDA events) of both.  (b) the dry run of that cell (mesh (1, 1), fake
   CUDA tensors): its FLOPs equal to the real step's counted by
   ``analyze`` (step 0 above), and its predicted peak (arguments +
   temp) within 25 % of the measured ``max_memory_allocated``, with
   the hand count of ``dense_train_flops`` beside them.  (c) the state
   checkpointed with ``CheckpointManager``, restored and placed back by
   ``reshard_restored``: every leaf bitwise.  (d) on the host, in a
   process started with the run, which traces while the kernels build
   and the card times them, is paused while a main path times its walls
   on the host, and is read (phase lm_launch_trace) before phase
   recovery: qwen3-0.6b ``train_4k`` traced on the (16, 16) production mesh
   of a fake group of 256 ranks: trace seconds, per-device FLOPs,
   bytes, memory, collectives and the roofline terms; then qwen3-0.6b
   ``decode_32k`` on the same mesh.  Gates: the train cell's temp within
   2x the JAX package's (31.2 GB), no all-gather or all-reduce as large
   as a rank's slab of the vocab-sharded logits, and in the decode cell
   no all-gather of the length-sharded cache; then a tied mamba2-130m
   smoke train step whose 250-entry vocab does not divide "model",
   traced on a (2, 4) group, which gathers no logits; the mixtral-8x7b
   smoke train cell on (16, 16), which neither all-reduces nor
   all-gathers a tensor as large as a rank's logits over the whole
   vocab; and mixtral-8x7b ``decode_32k`` at full width on (16, 16),
   which gathers no expert weight and puts at most 0.76 GB on the wire
   (1.25x the JAX package's record of it); and at full width on (16,
   16) mixtral-8x7b ``long_500k`` and mamba2-130m ``decode_32k``, which
   gather no decode state (SSM, conv or KV cache) and no table's vocab
   rows and put at most 1.25x the JAX package's wire bytes on the wire.
   No kernel of ``repro_torch.kernels`` launches.

Every phase records the host's RAM peak (``MemTotal - MemAvailable``,
sampled every 0.2 s, less the anonymous memory of (d)'s process, whose
own peak is recorded with it).  The line before the last is the card's name and
power limit; before it,
a ``{"kernels": [...]}`` JSON line, and before that the launch shape of
the kernels (threads and shared bytes per CTA, CTAs per SM from the
occupancy API, grid, tile, load path) and the build's seconds.  The last
line is ``{"ok": true, "device": {...}}``.  The full record goes to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import itertools
import json
import multiprocessing
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.calibrate import calibrate  # noqa: E402
from repro_torch.core.distributed import masked_local_steps  # noqa: E402
from repro_torch.core.executor import (  # noqa: E402
    DoubleBufferedExecutor, EagerExecutor, ShardMapExecutor,
    ShardedSimExecutor)
from repro_torch.core.faults import (  # noqa: E402
    KERNEL_FAULT, RANK_LOSS, TRANSIENT_TRANSFER, FaultPlan, FaultTrigger,
    RetryPolicy)
from repro_torch.core.hierarchy import (  # noqa: E402
    HierarchicalPlan, compile_hierarchical)
from repro_torch.core.lower import (  # noqa: E402
    CompiledPlan, host_register, host_unregister)
from repro_torch.core.oocore import compile_plan  # noqa: E402
from repro_torch.core.plan import FusedKernel, fused_box_geometry  # noqa: E402
from repro_torch.core.ranks import RankMesh  # noqa: E402
from repro_torch.core.recovery import (  # noqa: E402
    PlanCheckpointer, PlanExecutionError, run_with_recovery)
from repro_torch.core.reference import run_reference  # noqa: E402
from repro_torch.core.shard import compile_sharded  # noqa: E402
from repro_torch.core.stencil import get_stencil  # noqa: E402
from repro_torch.core.tune import TuneSpec, _default_measure, tune  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.dispatch import (  # noqa: E402
    DispatchPolicy, select_kernel)
from repro_torch.kernels.stencil_banded_mxu import (  # noqa: E402
    banded_fused_stencil, banded_fused_stencil_plain, banded_launch_shape,
    banded_mma_count, banded_smem_bytes)
from repro_torch.kernels.stencil_multistep import (  # noqa: E402
    band_launch_shape, band_uses_tma, fused_stencil_band,
    fused_stencil_band_plain)
from repro_torch.kernels.stencil_multistep_db import (  # noqa: E402
    db_launch_shape, fused_stencil_band_db, fused_stencil_band_db_plain)
from repro_torch.launch.elastic import run_elastic_sharded  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.moe import moe_capacity  # noqa: E402
from repro_torch.models.transformer import tree_leaves, tree_map  # noqa: E402
from repro_torch.data import DataSpec, SyntheticLM  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    StencilJob, StencilService, greedy_generate)

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 494.7e12       # dense, tensor cores
FP32_TOL, BF16_TOL = 1e-5, 3e-2
MXU_FP32_ABS_TOL = 2e-5           # tests/test_kernels.py:80
IMPLS = ("reference", "cuda", "cuda_db", "mxu")
ORACLE_BLOCK_ROWS = 2048
MAIN_SEED = 20231108              # every main path's input domain
FULL_SIZE = 38400
# the sharded phases: benchmarks/run.py's SHARD_MESH and its hierarchical
# HIER_MESH / HIER_K_ICI / HIER_STEPS / HIER_C_DEV; the sharded phase runs
# phase 4's n (160 of the dry run's 640), so the two outputs compare
SHARD_MESH, SHARD_K_ICI, SHARD_STEPS = (4, 2), 4, 160
HIER_MESH, HIER_STEPS, HIER_C_DEV = (2, 2), 16, 1 << 30
KERNELS = {
    "cuda": dict(
        fn=fused_stencil_band, plain=fused_stencil_band_plain,
        name="fused_stencil_band",
        source="src/repro_torch/kernels/csrc/fused_stencil_band.cu",
        replaces="src/repro/kernels/stencil_multistep.py:96"),
    "cuda_db": dict(
        fn=fused_stencil_band_db, plain=fused_stencil_band_db_plain,
        name="fused_stencil_band_db",
        source="src/repro_torch/kernels/csrc/fused_stencil_band_db.cu",
        replaces="src/repro/kernels/stencil_multistep_db.py:90"),
    "mxu": dict(
        fn=banded_fused_stencil, plain=banded_fused_stencil_plain,
        name="banded_fused_stencil",
        source="src/repro_torch/kernels/csrc/banded_fused_stencil.cu",
        replaces="src/repro/kernels/stencil_banded_mxu.py:110"),
}
# every wait on a rank process of the shard_map phase (group start, one
# dispatch, the join at close)
RANK_TIMEOUT_S = 300.0
# the lm_serve phase: (arch, n_layers cut to, or None for the whole model)
LM_MODELS = (("qwen3-0.6b", None), ("mamba2-130m", None),
             ("mixtral-8x7b", 2))
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
LM_SEED = 20251017
LM_PREFILL_TOL, LM_DECODE_TOL = 1e-3, 5e-2   # tests/test_models.py:61, :73
# one decode step's rise in allocated memory over what it held before
# (the caller's cache included): at most this many caches' bytes plus the
# margin (the logits and one layer's transients) plus the largest bf16
# copy of one weight the step makes (``dense`` and the experts cast the
# fp32 master weights per call: the tied head's table, one layer's
# expert stack); two new caches (a list beside its stack) cross it
LM_STEP_CACHES, LM_STEP_MARGIN = 1.2, 64e6
# the lm_train phase: 4 x 2048 tokens a step; the microbatch gate's bounds
# on the params after the step (tests/test_train_loop.py:44) and on the
# grads it applies, per leaf over the leaf's max (the bf16 tolerance of
# tests/test_torch_lm_grads.py); the H100 SXM data sheet's bf16 dense rate
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4, 2048, 20
LM_MICROBATCH_ATOL, LM_MICROBATCH_GRAD_TOL = 3e-3, 5e-2
# cuBLAS's deterministic workspace, for the bitwise resume's own process
LM_RESUME_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
BF16_FLOPS_PER_S = 989e12
# the lm_launch phase: qwen3-0.6b at full width, 3 steps of 4 x 2048 tokens
# on a (1, 1) DTensor mesh over NCCL against the plain Trainer; the dry
# run's predicted peak within 25 % of the measured one either way, its
# FLOPs equal to the real step's (to fp64 roundoff); the production cell
LM_LAUNCH_STEPS, LM_LAUNCH_PEAK_TOL, LM_LAUNCH_FLOP_RTOL = 3, 0.25, 1e-9
LM_LAUNCH_PROD = ("qwen3-0.6b", "train_4k")
LM_LAUNCH_TIMEOUT_S = 600
# the production cells' partitioning gates: the train cell's temp within
# 2x the JAX package's record of it (15.6 GB on (16, 16)), and no
# all-gather or all-reduce of the vocab-sharded logits (none as large
# as a rank's slab of them) nor, in the decode cell, of the
# length-sharded cache (none with its (kv heads, head dim) trailing dims
# as large as one layer's slice of a rank)
LM_LAUNCH_PROD_TEMP_GB = 31.2
LM_LAUNCH_DECODE = ("qwen3-0.6b", "decode_32k")
# and a tied table whose vocab does not divide "model" (mamba2-130m's
# smoke config with 250 entries, a train step of 8 x 64 tokens on a
# (2, 4) mesh): it traces, its table's gradients meeting in their own
# placements, and gathers no logits (none as large as a rank's rows of
# them over the whole vocab)
LM_LAUNCH_TIED = ("mamba2-130m", 250, (2, 4), 8, 64)
# and the MoE cells: mixtral-8x7b's smoke train_4k on (16, 16), whose
# residual stream the head must meet anchored (no collective result as
# large as a rank's logits over the whole vocab), and its decode_32k at
# full width, whose few tokens go to the FSDP-split expert weights (no
# all-gather of an expert weight; wire bytes, an all-reduce counted
# twice, within 1.25x the JAX package's 0.61 GB)
LM_LAUNCH_MOE = ("mixtral-8x7b", "train_4k", (16, 16))
LM_LAUNCH_MOE_DECODE = ("mixtral-8x7b", "decode_32k")
LM_LAUNCH_MOE_WIRE_GB = 0.76
# and two cells at full width on (16, 16) whose state the decode step
# takes where the rules place it: mixtral-8x7b's long_500k (one
# sequence: the cache split by length over "data", head_dim over
# "model") and mamba2-130m's decode_32k (its SSM state's head_dim and
# conv state's channels over "model"; its 50280-entry tied table, which
# does not divide "model", split over "data").  Each traces, all-gathers
# no state, no table's vocab rows and no cache-shaped slice, and puts at
# most 1.25x the JAX package's wire bytes on the wire (its dry-run
# records of them: 0.03988 and 0.03972 GB)
LM_LAUNCH_STATE = {"long": ("mixtral-8x7b", "long_500k", 0.03988),
                   "ssm_decode": ("mamba2-130m", "decode_32k", 0.03972)}
LM_LAUNCH_STATE_WIRE = 1.25
# and one sequence on (a)'s (1, 1) mesh, whose data axis of size 1
# "splits" a batch of one: qwen3-0.6b and mamba2-130m whole, a 2048-token
# prefill and 8 greedy decode steps, and a loss with grads of one 2048-
# token sequence, on DTensors placed by the rules against the plain path
# from the same weights, bitwise as (a)'s steps are
LM_LAUNCH_ONE = (("qwen3-0.6b", "mamba2-130m"), 2048, 8)
RESULT = {"phases": {}, "host_ram_peak_gb": {}}


def log(msg: str) -> None:
    print(msg, flush=True)


class RamPeak(threading.Thread):
    """Samples the host's used RAM (``MemTotal - MemAvailable`` of
    ``/proc/meminfo``, all processes) every 0.2 s, less the anonymous
    memory of ``child`` (a process working beside the phases, charged on
    its own: ``child_peak``); :meth:`take` returns the peak in GB since
    the last take."""

    def __init__(self):
        super().__init__(daemon=True)
        self.peak = self.child_peak = 0
        self.child = None
        self.lock = threading.Lock()

    @staticmethod
    def used() -> int:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                key, val = line.split(":", 1)
                info[key] = int(val.split()[0]) * 1024
        return info["MemTotal"] - info["MemAvailable"]

    @staticmethod
    def anon(pid: int) -> int:
        """``RssAnon`` of process ``pid`` in bytes (``VmRSS`` where the
        kernel reports no ``RssAnon``; 0 once it is gone)."""
        fields = {}
        try:
            with open(f"/proc/{pid}/status") as f:
                for line in f:
                    key, _, val = line.partition(":")
                    if key in ("RssAnon", "VmRSS"):
                        fields[key] = int(val.split()[0]) * 1024
        except (OSError, ValueError, IndexError):
            pass
        return fields.get("RssAnon", fields.get("VmRSS", 0))

    def sample(self) -> None:
        child = self.child
        own = self.anon(child.pid) if child is not None else 0
        used = self.used() - own
        with self.lock:
            self.peak = max(self.peak, used)
            self.child_peak = max(self.child_peak, own)

    def run(self) -> None:
        while True:
            self.sample()
            time.sleep(0.2)

    def take(self) -> float:
        self.sample()
        with self.lock:
            peak, self.peak = self.peak, 0
        return peak / 1e9


RAM = RamPeak()
TRACE = None      # (d) of phase lm_launch, tracing on the host: HostTrace


def host_quiet():
    """A context for a wall timed on the host: the (d) trace child
    (:class:`HostTrace`), where it still runs, is paused inside it."""
    return TRACE.paused() if TRACE is not None else contextlib.nullcontext()


def phase(name: str):
    """Record a phase's wall time (a phase that raises ends the run)."""
    class _Timer:
        def __enter__(self):
            log(f"== phase {name}")
            self.t0 = time.perf_counter()

        def __exit__(self, exc_type, *_):
            if exc_type is None:
                s = time.perf_counter() - self.t0
                RESULT["phases"][name] = s
                ram = RESULT["host_ram_peak_gb"][name] = RAM.take()
                log(f"== phase {name}: {s:.1f} s, host RAM peak "
                    f"{ram:.1f} GB")
    return _Timer()


def check(ok: bool, *what) -> None:
    """Fail the run (unlike ``assert``, also under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-6))


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reset_counts() -> None:
    for k in KERNELS.values():
        k["fn"].launches = 0


def counts() -> dict:
    return {impl: k["fn"].launches for impl, k in KERNELS.items()}


def sha256(arr: np.ndarray) -> str:
    """Digest of an output's bytes: later phases hold their outputs
    bitwise to a main path's without keeping its array alive."""
    return hashlib.sha256(np.ascontiguousarray(arr).data).hexdigest()


@functools.lru_cache(maxsize=1)
def main_domain(size: int) -> np.ndarray:
    """Every main path's input, drawn once per run (5.9 GB at full size)
    and shared by the phases; no executor writes its input."""
    return np.random.default_rng(MAIN_SEED).standard_normal(
        (size, size), dtype=np.float32)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build() -> None:
    with phase("build"):
        t0 = time.perf_counter()
        lib = _build.build()
        _build.library()
        RESULT["build_s"] = time.perf_counter() - t0
        log(f"built {os.path.relpath(lib, ROOT)} in {RESULT['build_s']:.1f} s")
        ptxas = [ln.strip() for ln in _build.build_log().splitlines()
                 if "registers" in ln or "spill" in ln]
        RESULT["ptxas"] = ptxas
        for ln in ptxas:
            log("  " + ln)
        RESULT["card"] = card_line()
        RESULT["torch"] = torch.__version__
        RESULT["cuda"] = torch.version.cuda
        log(f"card: {RESULT['card']}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")


def phase_kernels_vs_plain() -> None:
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    dtypes = {"fp32": (torch.float32, FP32_TOL),
              "bf16": (torch.bfloat16, BF16_TOL)}
    worst = {impl: dict.fromkeys(dtypes, 0.0) for impl in KERNELS}
    cases = 0
    bitwise = dict.fromkeys(KERNELS, 0)
    fp32_cases = dict.fromkeys(KERNELS, 0)
    # the one-CTA-per-tile kernel's fp32 cases by load path: [cases, bitwise]
    by_load = {"tma": [0, 0], "cp.async": [0, 0]}
    with phase("kernels_vs_plain"):
        for name, steps, (H, X), kt, kb in itertools.product(
                ("box2d1r", "box2d4r", "star2d3r", "gradient2d"), (1, 2, 4),
                ((48, 160), (37, 131), (41, 97), (20, 40)), (False, True),
                (False, True)):
            mr = steps * get_stencil(name).radius
            if H - 2 * mr + (kt + kb) * mr <= 0 or X <= 2 * mr:
                continue
            x = torch.from_numpy(rng.standard_normal((H, X)).astype(
                np.float32)).to(dev)
            for key, (dtype, tol) in dtypes.items():
                xb = x.to(dtype)
                for impl, k in KERNELS.items():
                    if impl == "mxu" and not get_stencil(name).is_linear:
                        continue
                    ref = k["plain"](xb, name, steps, kt, kb)
                    got = k["fn"](xb, name, steps, kt, kb)
                    torch.cuda.synchronize()
                    check(got.shape == ref.shape, impl, name, got.shape)
                    if impl == "mxu" and key == "fp32":
                        # the banded kernel sums in the tensor cores' order
                        err = float((got - ref).abs().max())
                        tol = MXU_FP32_ABS_TOL
                    else:
                        err = rel_err(got, ref)
                    check(err <= tol, impl, name, steps, H, X, kt, kb, key,
                          err)
                    worst[impl][key] = max(worst[impl][key], err)
                    cases += 1
                    if key == "fp32":
                        fp32_cases[impl] += 1
                        bitwise[impl] += int(torch.equal(got, ref))
                        if impl == "cuda":
                            load = band_launch_shape(xb, name, steps, kt,
                                                     kb)["load"]
                            by_load[load][0] += 1
                            by_load[load][1] += int(torch.equal(got, ref))
        check(all(n > 0 for n, _ in by_load.values()), by_load)
        RESULT["kernels_vs_plain"] = dict(
            cases=cases, fp32_cases=fp32_cases, fp32_bitwise=bitwise,
            cuda_fp32_by_load=by_load, worst_err=worst,
            err_kind="mxu fp32: max abs; else max rel")
        log(f"{cases} kernel-vs-plain cases pass; fp32 bitwise equal "
            f"{bitwise} of {fp32_cases} (cuda by load path [cases, "
            f"bitwise]: {by_load}); worst err (mxu fp32 absolute, else "
            f"relative) {worst}")


def main_band_shape(plan) -> tuple:
    """The (H, X) of the first fused call on a middle chunk: the band
    shape the main path hands its kernel most."""
    for op in plan.ops:
        if isinstance(op, FusedKernel) and not op.keep_lo[0] \
                and not op.keep_hi[0]:
            return op.shape_in, op.steps
    raise AssertionError("plan has no middle-chunk kernel")


def bound(name: str, shape, steps: int, itemsize: int = 4):
    st = get_stencil(name)
    shape_out, _, flops, _ = fused_box_geometry(
        st.radius, st.flops_per_elem, shape, steps, (False, True),
        (False, True), itemsize)
    nbytes = (shape[0] * shape[1] + shape_out[0] * shape_out[1]) * itemsize
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return dict(bytes=nbytes, flops=flops, bytes_ms=t_bytes * 1e3,
                ops_ms=t_ops * 1e3, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def conv_one_step_ms(band: torch.Tensor, name: str) -> float:
    """Yardstick only, never called by the port: one step of a linear
    stencil as a convolution, in full fp32 (TF32 off)."""
    w = torch.from_numpy(get_stencil(name).coeffs.astype(np.float32)).to(
        band.device)[None, None]
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return cuda_ms(lambda: torch.nn.functional.conv2d(band[None, None],
                                                          w), reps=3)
    finally:
        torch.backends.cudnn.allow_tf32 = allow


def mma_ms(name: str, shape, steps: int, tile=None) -> float:
    """The banded kernel's own tensor-core work at the dense TF32 rate:
    every m16n8k8 it issues (``banded_mma_count`` per tile: 3 per nonzero
    K-block, 2 K-blocks, 2r+1 row offsets, every fragment of each step's
    trapezoid grid) over all tiles, at 2048 FLOP each."""
    from repro_torch.kernels import MXU_CUDA_TILE, ceil_div
    from repro_torch.kernels._build import fit_tile

    r = get_stencil(name).radius
    H, X = shape
    h_out = H - 2 * steps * r
    ty, tx = fit_tile(tile or MXU_CUDA_TILE, h_out, X, steps, r, 4, 2,
                      lambda a, b: banded_smem_bytes(a, b, steps, r))
    mmas = (ceil_div(h_out, ty) * ceil_div(X, tx)
            * banded_mma_count(ty, tx, steps, r))
    return mmas * 2048 / TF32_FLOPS_PER_S * 1e3


def kernel_launch_shape(impl: str, name: str, band: torch.Tensor,
                        m: int) -> dict:
    """Threads and shared memory per CTA, CTAs per SM (the occupancy
    API's), the grid and the tile of a kernel's launch on this band; for
    ``cuda`` also its load path, held to ``band_uses_tma``."""
    fn = {"cuda": band_launch_shape, "cuda_db": db_launch_shape,
          "mxu": banded_launch_shape}[impl]
    shape = fn(band, name, m)
    if impl == "cuda":
        r = get_stencil(name).radius
        ty, tx = shape["tile"]
        tma = band_uses_tma(band.shape[1], band.element_size(),
                            band.data_ptr(), (ty + 2 * m * r, tx + 2 * m * r))
        check(shape["load"] == ("tma" if tma else "cp.async"), shape, tma)
    return shape


def kernel_record(impl: str, name: str, band: torch.Tensor, m: int) -> dict:
    """One kernel against its plain version on a main-path band: the
    error (held to its tolerance), CUDA-event times of both, the bound."""
    k = KERNELS[impl]
    got = k["fn"](band, name, m)
    ref = k["plain"](band, name, m)
    torch.cuda.synchronize()
    rec = dict(stencil=name, band=list(band.shape), steps=m,
               max_abs_err=float((got - ref).abs().max()),
               bitwise=bool(torch.equal(got, ref)))
    if impl == "mxu":
        check(rec["max_abs_err"] <= MXU_FP32_ABS_TOL, impl, rec)
    else:
        check(rel_err(got, ref) <= FP32_TOL, impl, rec)
    del got, ref
    rec["ms"] = cuda_ms(lambda: k["fn"](band, name, m), reps=10)
    rec["plain_ms"] = cuda_ms(lambda: k["plain"](band, name, m), reps=3)
    rec.update(bound(name, tuple(band.shape), m))
    torch.cuda.empty_cache()
    return rec


def other_kernel_ms(impl: str, name: str, band: torch.Tensor, m: int) -> dict:
    """The ring-vs-occupancy yardstick: ``impl`` on another main path's
    band, held bitwise to its plain version, then timed."""
    k = KERNELS[impl]
    got = k["fn"](band, name, m)
    ref = k["plain"](band, name, m)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), impl, name)
    del got, ref
    return dict(ms=cuda_ms(lambda: k["fn"](band, name, m), reps=10),
                launch_shape=kernel_launch_shape(impl, name, band, m))


def phase_kernel_times(size: int) -> None:
    dev = torch.device("cuda")
    timings, yardstick = {}, {}
    with phase("kernel_times"):
        for impl, name, other in (("cuda_db", "gradient2d", "cuda"),
                                  ("cuda", "box2d1r", "cuda_db")):
            plan = compile_plan("so2dr", get_stencil(name), size, size, 160,
                                4, 160, 4)
            (H, X), m = main_band_shape(plan)
            band = torch.randn((H, X), generator=torch.Generator(
                device=dev).manual_seed(3), device=dev)
            rec = kernel_record(impl, name, band, m)
            rec["launch_shape"] = kernel_launch_shape(impl, name, band, m)
            yardstick[name] = {impl: {"ms": rec["ms"]},
                               other: other_kernel_ms(other, name, band, m)}
            rec["library_ms"] = None
            if name == "box2d1r":
                rec["library_ms"] = conv_one_step_ms(band, name)
                rec["library_call"] = "F.conv2d, one step, TF32 off"
            # the lowering's bucketing pad: a fresh zero block concatenated
            # to the band before a shorter call of the same group
            z = torch.zeros((2 * m, X), device=dev)
            rec["bucket_pad_ms"] = cuda_ms(lambda: torch.cat([band, z]),
                                           reps=3)
            timings[impl] = rec
            log(f"{impl} on {name} {H}x{X} m={m}: kernel {rec['ms']:.3f} ms, "
                f"plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} "
                f"ms ({rec['bound_by']}), library {rec['library_ms']}, "
                f"pad {rec['bucket_pad_ms']:.3f} ms, max|err| "
                f"{rec['max_abs_err']}; {other} on the same band "
                f"{yardstick[name][other]['ms']:.3f} ms")
            del band
        sh = timings["cuda"]["launch_shape"]
        check(sh["load"] == "tma" and sh["ctas_per_sm"] >= 3, sh)
        RESULT["ring_vs_occupancy"] = yardstick
        # host<->device copy rates at the band's size
        H, X = timings["cuda_db"]["band"]
        # touched pages (np.ones): the executors copy from and into host
        # arrays that are already resident, not freshly mapped
        host = np.ones((H, X), np.float32)
        nbytes = host.nbytes
        src = torch.from_numpy(host)
        copies = {}
        t = time.perf_counter()
        dst = src.to(dev)
        torch.cuda.synchronize()
        copies["h2d_pageable_GBps"] = nbytes / (time.perf_counter() - t) / 1e9
        host_register(host)
        try:
            t = time.perf_counter()
            dst = src.to(dev, non_blocking=True)
            torch.cuda.synchronize()
            copies["h2d_registered_GBps"] = nbytes / (time.perf_counter()
                                                      - t) / 1e9
            t = time.perf_counter()
            src.copy_(dst)
            copies["d2h_registered_GBps"] = nbytes / (time.perf_counter()
                                                      - t) / 1e9
        finally:
            host_unregister(host)
        other = np.ones_like(host)
        t = time.perf_counter()
        torch.from_numpy(other).copy_(dst)
        copies["d2h_pageable_GBps"] = nbytes / (time.perf_counter() - t) / 1e9
        # the executors' per-run host set-up, at the full domain's size:
        # validate_domain's copy, and page-locking it for the copy stream
        dom = np.ones((size, size), np.float32)
        t = time.perf_counter()
        dom = dom.copy()
        copies["domain_copy_s"] = time.perf_counter() - t
        t = time.perf_counter()
        host_register(dom)
        copies["host_register_s"] = time.perf_counter() - t
        t = time.perf_counter()
        host_unregister(dom)
        copies["host_unregister_s"] = time.perf_counter() - t
        del dom
        RESULT["kernel_times"] = timings
        RESULT["copies"] = copies
        log("copies (GB/s): " + json.dumps(
            {k: round(v, 2) for k, v in copies.items()}))


def phase_box2d4r_times(size: int) -> None:
    """All three kernels on the box2d4r main path's band (the paper's
    box2d4r configuration): which is fastest on the card, and whether the
    data-sheet auto rule picks it."""
    dev = torch.device("cuda")
    name = "box2d4r"
    timings = {}
    with phase("box2d4r_times"):
        plan = compile_plan("so2dr", get_stencil(name), size, size, 80, 4,
                            40, 4)
        (H, X), m = main_band_shape(plan)
        band = torch.randn((H, X), generator=torch.Generator(
            device=dev).manual_seed(5), device=dev)
        library_ms = conv_one_step_ms(band, name)
        for impl in ("mxu", "cuda_db", "cuda"):
            rec = kernel_record(impl, name, band, m)
            rec["launch_shape"] = kernel_launch_shape(impl, name, band, m)
            rec["library_ms"] = library_ms
            rec["library_call"] = "F.conv2d, one step, TF32 off"
            if impl == "mxu":
                rec["mma_ms_at_tf32_peak"] = mma_ms(name, (H, X), m)
            timings[impl] = rec
            log(f"{impl} on {name} {H}x{X} m={m}: kernel {rec['ms']:.3f} ms, "
                f"plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} "
                f"ms ({rec['bound_by']}; bytes {rec['bytes_ms']:.3f} ms, "
                f"operations {rec['ops_ms']:.3f} ms), library (one step) "
                f"{library_ms:.3f} ms, max|err| {rec['max_abs_err']}"
                + (f", mma count at TF32 peak {rec['mma_ms_at_tf32_peak']:.3f}"
                   f" ms" if impl == "mxu" else ""))
        del band
        check(timings["cuda"]["launch_shape"]["load"] == "tma",
              timings["cuda"]["launch_shape"])
        fastest = min(timings, key=lambda i: timings[i]["ms"])
        auto = select_kernel(name, m, DispatchPolicy(), device=dev)[0]
        RESULT["box2d4r_times"] = dict(kernels=timings, fastest=fastest,
                                       auto_impl=auto,
                                       auto_is_fastest=auto == fastest)
        log(f"box2d4r: fastest kernel {fastest}; auto (data-sheet rule) "
            f"picks {auto}")


def oracle_check(x: np.ndarray, name: str, n: int, outs: dict) -> dict:
    """Run the plain oracle on the card and hold each output to it."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ref = run_reference(torch.from_numpy(x).to(dev), get_stencil(name), n,
                        block_rows=ORACLE_BLOCK_ROWS)
    torch.cuda.synchronize()
    rec = {"oracle_s": time.perf_counter() - t0}
    scale = float(ref.abs().max())
    for label, out in outs.items():
        diff, mismatched = 0.0, 0
        for lo in range(0, out.shape[0], ORACLE_BLOCK_ROWS):
            got = torch.from_numpy(out[lo:lo + ORACLE_BLOCK_ROWS]).to(dev)
            d = (got - ref[lo:lo + ORACLE_BLOCK_ROWS]).abs()
            diff = max(diff, float(d.max()))
            mismatched += int((d != 0).sum())
        rec[label] = dict(max_abs_err=diff, rel_err=diff / (scale + 1e-6),
                          mismatched=mismatched)
        check(diff / (scale + 1e-6) <= FP32_TOL, label, rec[label])
    del ref
    torch.cuda.empty_cache()
    return rec


def phase_main_path(key: str, name: str, size: int, n: int, impl: str,
                    policy: DispatchPolicy, k_off: int = 160) -> None:
    with phase(key):
        t0 = time.perf_counter()
        x = main_domain(size)
        plan = compile_plan("so2dr", get_stencil(name), size, size, n, 4,
                            k_off, 4)
        rec = {"stencil": name, "shape": [size, size], "n": n, "d": 4,
               "k_off": k_off, "k_on": 4, "setup_s": time.perf_counter() - t0,
               "plan_kernel_calls": plan.stats().kernel_calls}
        outs = {}
        for cls in (DoubleBufferedExecutor, EagerExecutor):
            exe = cls(policy=policy)
            reset_counts()
            with host_quiet():
                t = time.perf_counter()
                out, stats = exe.execute(plan, x)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            launched = counts()
            es = exe.exec_stats
            check(es.kernel_impl == impl, es.kernel_impl)
            check(launched[impl] == es.kernel_calls == stats.kernel_calls > 0,
                  launched, es.kernel_calls)
            check(sum(launched.values()) == launched[impl], launched)
            check(out.shape == x.shape and bool(np.isfinite(out).all()),
                  "output shape or finiteness")
            rec[cls.name] = dict(
                wall_s=wall, launches=launched[impl],
                kernel_calls=es.kernel_calls,
                shape_buckets=es.shape_buckets,
                kernel_compiles=es.kernel_compiles,
                op_wall_s=es.op_wall_s)
            log(f"{name} {cls.name}: {wall:.2f} s, {launched[impl]} {impl} "
                f"launches, op wall {json.dumps({k: round(v, 3) for k, v in es.op_wall_s.items()})}")
            outs[cls.name] = out
            del exe
        check(np.array_equal(outs["double_buffered"], outs["eager"]),
              "eager and double-buffered outputs differ")
        rec["eager_equals_double_buffered"] = True
        rec["sha256"] = sha256(outs["double_buffered"])
        rec["oracle"] = oracle_check(x, name, n, outs)
        log(f"{name}: eager == double_buffered bitwise; vs oracle "
            f"{json.dumps(rec['oracle'])}")
        RESULT[key] = rec


def phase_calibrate_tune(size: int, out_dir: str) -> None:
    with phase("calibrate_tune"):
        t0 = time.perf_counter()
        # calibrated on the stencil it then tunes: one stencil's ladder
        # moves bytes and FLOPs together, so a box2d1r fit cannot say what
        # box2d4r's 9x the FLOPs per byte cost
        prof = calibrate(quick=False, kernel_impls=IMPLS, stencil="box2d4r",
                         device="cuda", progress=log)
        path = prof.save(os.path.join(out_dir, "profile.json"))
        rec = {"calibrate_s": time.perf_counter() - t0,
               "profile": os.path.relpath(path, ROOT),
               "profile_id": prof.profile_id,
               "hardware": {k: prof.hardware[k] for k in (
                   "bw_intc", "bw_dmem", "peak_vpu_flops", "t_ici_latency")},
               "kernel_terms": prof.kernel_terms,
               "residuals": prof.residuals}
        log(f"profile {prof.profile_id} -> {rec['profile']}: "
            + json.dumps(rec["hardware"]))
        for impl, t in prof.kernel_terms.items():
            log(f"  {impl}: bw_eff {t['bw_eff']:.4g} B/s, flops_eff "
                f"{t['flops_eff']:.4g} FLOP/s, residual {t['residual']:.4f} "
                f"({t['n_points']} points)")
        spec = TuneSpec("box2d4r", size + 8, 640, kernel_impls=IMPLS)
        base = _default_measure(prof.as_hardware(), prof, "cuda")
        launched_by = []

        def measure(spec_, res):
            reset_counts()
            out = base(spec_, res)
            launched = counts()
            impl = res.config["kernel_impl"]
            if out is not None:
                es = out[2]
                check(es.kernel_impl == impl, impl, es.kernel_impl)
                # a warm-up run and the measured run
                want = 0 if impl == "reference" else 2 * es.kernel_calls
                check(sum(launched.values()) == want
                      and (impl == "reference" or launched[impl] == want),
                      impl, launched, es.kernel_calls)
            launched_by.append(dict(config=res.config, launches=launched))
            return out

        t0 = time.perf_counter()
        ranked = tune(spec, profile=prof, budget=4, measure=measure)
        rec["tune_s"] = time.perf_counter() - t0
        check(len(ranked) > 0, "tune found no candidate")
        measured = [r for r in ranked[:4] if r.measured_s is not None]
        check(len(measured) > 0, "tune measured no candidate")
        rec["candidates"] = len(ranked)
        rec["top5"] = [r.to_record() for r in ranked[:5]]
        rec["measured_launches"] = launched_by
        for r in ranked[:5]:
            log(f"  {json.dumps(r.config, default=str)}: modeled "
                f"{r.modeled_s:.4g} s, measured {r.measured_s}, model error "
                f"{r.model_error}")
        RESULT["calibrate_tune"] = rec


class TimedCheckpointManager(CheckpointManager):
    """A CheckpointManager that keeps the seconds of each save and
    restore (fsync and atomic rename included)."""

    def __init__(self, directory: str, keep: int):
        super().__init__(directory, keep=keep)
        self.save_s, self.restore_s = [], []

    def save(self, step, tree, extra_meta=None):
        t = time.perf_counter()
        out = super().save(step, tree, extra_meta)
        self.save_s.append(time.perf_counter() - t)
        return out

    def restore(self, like, step=None):
        t = time.perf_counter()
        out = super().restore(like, step)
        self.restore_s.append(time.perf_counter() - t)
        return out


def phase_recovery(size: int, out_dir: str) -> None:
    """The box2d4r main path through ``run_with_recovery``: a retried
    transient fault, then a terminal one resumed from the checkpoint of
    round 0; bitwise equal to the uninterrupted run."""
    name = "box2d4r"
    ckpt_dir = os.path.join(out_dir, "ckpt")
    with phase("recovery"):
        x = main_domain(size)
        plan = compile_plan("so2dr", get_stencil(name), size, size, 80, 4,
                            40, 4)
        faults = FaultPlan([
            FaultTrigger(round=0, chunk=1, op_class="H2D",
                         kind=TRANSIENT_TRANSFER, count=2),
            FaultTrigger(round=1, chunk=2, op_class="FusedKernel",
                         kind=KERNEL_FAULT)])
        # kernels of round 1 that run before its fault, and run again
        before_fault = sum(1 for op in plan.ops if isinstance(op, FusedKernel)
                           and op.round == 1 and op.chunk < 2)
        mgr = TimedCheckpointManager(ckpt_dir, keep=1)
        try:
            exe = DoubleBufferedExecutor(policy=DispatchPolicy(impl="mxu"))
            reset_counts()
            t = time.perf_counter()
            out, _ = run_with_recovery(
                plan, x, executor=exe, faults=faults,
                retry=RetryPolicy(max_retries=3, backoff_s=0.001),
                checkpoint=PlanCheckpointer(mgr, plan, every=1))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launched = counts()
            ckpt_bytes = sum(
                os.path.getsize(os.path.join(d, f))
                for d, _, files in os.walk(ckpt_dir) for f in files)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        es = exe.exec_stats
        want = plan.stats().kernel_calls + before_fault
        check(launched["mxu"] == want and sum(launched.values()) == want,
              launched, want)
        check((es.resumes, es.faults_injected, es.retries) == (1, 3, 2),
              es.resumes, es.faults_injected, es.retries)
        check(out.shape == x.shape, out.shape)
        digest = sha256(out)
        check(digest == RESULT["main_path_box2d4r"]["sha256"],
              "resumed box2d4r differs from the uninterrupted run")
        rec = dict(stencil=name, wall_s=wall,
                   uninterrupted_wall_s=RESULT["main_path_box2d4r"][
                       "double_buffered"]["wall_s"],
                   save_s=mgr.save_s, restore_s=mgr.restore_s,
                   checkpoint_bytes=ckpt_bytes, launches=launched["mxu"],
                   kernel_calls_rerun=before_fault, resumes=es.resumes,
                   faults_injected=es.faults_injected, retries=es.retries,
                   sha256=digest, bitwise_equal_uninterrupted=True)
        RESULT["recovery"] = rec
        log(f"recovery: {wall:.2f} s (uninterrupted "
            f"{rec['uninterrupted_wall_s']:.2f} s), saves "
            f"{[round(v, 2) for v in mgr.save_s]} s, restores "
            f"{[round(v, 2) for v in mgr.restore_s]} s, "
            f"{launched['mxu']} mxu launches ({before_fault} rerun), "
            "bitwise equal to the uninterrupted run")


class _RuntimeHosts:
    """Records the host array of every runtime built inside the block, by
    compiled plan: the service copies each job's input into a page-locked
    domain of its pool, which no result exposes, so this is the only
    handle on the memory whose registration the phase checks."""

    def __enter__(self):
        self.hosts, self._orig = {}, CompiledPlan.runtime
        orig, hosts = self._orig, self.hosts

        def runtime(compiled, *a, **kw):
            rt = orig(compiled, *a, **kw)
            hosts[id(compiled)] = rt.host
            return rt

        CompiledPlan.runtime = runtime
        return self.hosts

    def __exit__(self, *exc):
        CompiledPlan.runtime = self._orig


def phase_service(size: int, out_dir: str) -> None:
    """Three jobs through one flush of the stencil service (one poisoned),
    then a warm in-bucket job."""
    with phase("service"):
        x = main_domain(size)
        svc = StencilService(profile=os.path.join(out_dir, "profile.json"),
                             policy=DispatchPolicy())
        knobs = dict(d=4, k_on=4, s_tb=160)
        jobs = {
            "gradient2d": StencilJob((size, size), "gradient2d", 320, **knobs),
            "box2d1r": StencilJob((size, size), "box2d1r", 160, **knobs),
            # two rounds (n=160 with s_tb=160 is one): the fault at round
            # 1 fires after round 0 committed
            "box2d1r_poisoned": StencilJob(
                (size, size), "box2d1r", 320, **knobs,
                faults=FaultPlan([FaultTrigger(round=1, chunk=None,
                                               op_class="FusedKernel",
                                               kind=KERNEL_FAULT)])),
        }
        label = {svc.submit(job, x): key for key, job in jobs.items()}
        reset_counts()
        with _RuntimeHosts() as hosts:
            t = time.perf_counter()
            results = {label[r.job_id]: r for r in svc.flush()}
            torch.cuda.synchronize()
            flush_wall = time.perf_counter() - t
        launched = counts()
        host_of = {label[j.job_id]: hosts[id(j.compiled)]
                   for j in svc.last_admission}
        rec = {"order": [label[j.job_id] for j in svc.last_admission],
               "flush_wall_s": flush_wall, "jobs": {}}
        for key, r in results.items():
            rec["jobs"][key] = dict(
                status=r.status, latency_s=r.latency_s,
                predicted_s=r.predicted_s,
                kernel_impl=r.exec_stats.kernel_impl,
                kernel_calls=r.exec_stats.kernel_calls,
                kernel_compiles=r.exec_stats.kernel_compiles,
                op_wall_s=r.exec_stats.op_wall_s)
        for key, main in (("gradient2d", "main_path_gradient2d"),
                          ("box2d1r", "main_path_box2d1r")):
            r = results[key]
            check(r.status == "ok" and r.out is not None, key, r.status)
            check(r.exec_stats.kernel_impl == "cuda_db", key,
                  r.exec_stats.kernel_impl)
            rec["jobs"][key]["sha256"] = digest = sha256(r.out)
            check(digest == RESULT[main]["sha256"],
                  f"service job {key} differs from {main}")
        bad = results["box2d1r_poisoned"]
        check(bad.status == "failed" and bad.out is None
              and isinstance(bad.fault, PlanExecutionError)
              and bad.fault.last_committed_round == 0, bad.status, bad.fault)
        svc.slot_pool.assert_balanced()
        rec["domain_pool"] = pool = svc.domain_pool.stats()
        check(pool["in_use"] == 0 and pool["idle"] == len(host_of), pool)
        # the pool holds every job's domain page-locked, the failed job's
        # too, until it closes: then each registers again
        svc.domain_pool.close()
        for key, host in host_of.items():
            host_register(host)
            host_unregister(host)
        want = sum(r.exec_stats.kernel_calls for r in results.values())
        check(launched["cuda_db"] == want and sum(launched.values()) == want,
              launched, want)
        solo = {key: RESULT[main]["double_buffered"]["wall_s"]
                for key, main in (("gradient2d", "main_path_gradient2d"),
                                  ("box2d1r", "main_path_box2d1r"))}
        rec.update(
            solo_wall_s=solo, solo_wall_sum_s=sum(solo.values()),
            solo_note="box2d1r's main path ran cuda (B1); the poisoned job "
                      "has no solo run",
            modeled_interleaved_s=svc.modeled_makespan(interleaved=True),
            modeled_back_to_back_s=svc.modeled_makespan(interleaved=False),
            cuda_db_launches=launched["cuda_db"], pool_balanced=True,
            failed_job=dict(last_committed_round=0,
                            fault=str(bad.fault.fault),
                            host_registers_again=True))
        del results, host_of, hosts, bad
        log(f"service flush of 3 jobs: {flush_wall:.2f} s (solo main-path "
            f"walls {json.dumps({k: round(v, 2) for k, v in solo.items()})}); "
            f"modeled {rec['modeled_interleaved_s']:.4g} s interleaved, "
            f"{rec['modeled_back_to_back_s']:.4g} s back to back; latencies "
            + json.dumps({k: round(v["latency_s"], 2)
                          for k, v in rec["jobs"].items()}))
        # a warm job whose bands fit the buckets the first flush registered
        rows = size - size // 16
        xw = x[:rows]
        wid = svc.submit(StencilJob((rows, size), "gradient2d", 320, **knobs),
                         xw)
        reset_counts()
        t = time.perf_counter()
        [warm] = svc.flush()
        torch.cuda.synchronize()
        warm_wall = time.perf_counter() - t
        launched = counts()
        check(warm.job_id == wid and warm.status == "ok", warm.status)
        check(warm.exec_stats.kernel_compiles == 0,
              warm.exec_stats.kernel_compiles)
        check(launched["cuda_db"] == warm.exec_stats.kernel_calls > 0,
              launched, warm.exec_stats.kernel_calls)
        rec["warm"] = dict(shape=[rows, size], wall_s=warm_wall,
                           latency_s=warm.latency_s,
                           kernel_calls=warm.exec_stats.kernel_calls,
                           kernel_compiles=warm.exec_stats.kernel_compiles,
                           kernel_cache_hits=warm.exec_stats.kernel_cache_hits,
                           oracle=oracle_check(xw, "gradient2d", 320,
                                               {"service_warm": warm.out}))
        svc.slot_pool.assert_balanced()
        rec["service_stats"] = svc.service_stats()
        RESULT["service"] = rec
        log(f"warm job {rows}x{size}: {warm_wall:.2f} s, 0 kernel compiles, "
            f"vs oracle {json.dumps(rec['warm']['oracle'])}; service "
            + json.dumps(rec["service_stats"]))


def masked_step_ms(plan, rank: int) -> dict:
    """The masked update of one ShardKernel of ``rank`` on a random band
    of its shape, CUDA events, per rank-step; with the bound of one step
    (the band read and written once, its interior's fp32 operations)."""
    op = next(o for o in plan.streams[rank] if type(o).__name__
              == "ShardKernel")
    st = get_stencil(op.stencil)
    band = torch.randn((op.h, op.w), generator=torch.Generator(
        device="cuda").manual_seed(11), device="cuda")
    ms = cuda_ms(lambda: masked_local_steps(band, st, op.steps, op.gy0,
                                            op.gx0, plan.Y, plan.X),
                 reps=3) / op.steps
    nbytes = 2 * op.h * op.w * 4
    flops = op.flops // op.steps
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    del band
    torch.cuda.empty_cache()
    return dict(rank=rank, band=[op.h, op.w], steps=op.steps,
                ms_per_rank_step=ms, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                route="plain PyTorch (masked_local_steps)")


def run_sharded_sim(plan, x: np.ndarray):
    """One ShardedSimExecutor run on the card, checked against the plan:
    every op ran once, one kernel signature, no kernel of
    ``repro_torch.kernels`` launched."""
    ex = ShardedSimExecutor()
    reset_counts()
    t = time.perf_counter()
    out, stats = ex.execute(plan, x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = counts()
    es = ex.exec_stats
    want = plan.stats()
    check(sum(launched.values()) == 0, "a kernel launched", launched)
    check(stats == want and es.kernel_calls == plan.n_ranks * plan.rounds,
          es.kernel_calls)
    # a hierarchical plan's own counts add its inner ops, which run inside
    # the ShardKernel ops and are not the outer program's
    check(es.op_counts == getattr(plan, "outer", plan).op_counts(),
          es.op_counts)
    check(out.shape == x.shape and bool(np.isfinite(out).all()),
          "output shape or finiteness")
    rec = dict(wall_s=wall, kernel_calls=es.kernel_calls,
               halo_ops=want.halo_ops, shape_buckets=es.shape_buckets,
               kernel_compiles=es.kernel_compiles, op_wall_s=es.op_wall_s,
               launches=launched)
    return out, rec, es


def phase_sharded(size: int) -> None:
    name = "box2d1r"
    with phase("sharded"):
        x = main_domain(size)
        plan = compile_sharded(name, size, size, SHARD_STEPS, SHARD_K_ICI,
                               SHARD_MESH)
        out, rec, es = run_sharded_sim(plan, x)
        check(es.shape_buckets == 1 and es.kernel_compiles == 1
              and plan.stats().kernel_calls == es.kernel_calls,
              es.shape_buckets, es.kernel_compiles)
        check(rec["halo_ops"] == 2 * plan.op_counts()["HaloSend"],
              rec["halo_ops"])
        rec.update(stencil=name, shape=[size, size], n=SHARD_STEPS,
                   k_ici=SHARD_K_ICI, mesh=list(SHARD_MESH),
                   rounds=plan.rounds, ranks=plan.n_ranks)
        rec["sha256"] = sha256(out)
        rec["bitwise_equal_main_path_box2d1r"] = (
            rec["sha256"] == RESULT["main_path_box2d1r"]["sha256"])
        rec["oracle"] = oracle_check(x, name, SHARD_STEPS, {"sharded": out})
        del out
        # rank 2 is a middle row of the mesh: halos on three sides
        rec["masked_update"] = masked_step_ms(plan, 2)
        RESULT["sharded"] = rec
        log(f"sharded {name} mesh {SHARD_MESH} k_ici={SHARD_K_ICI} "
            f"n={SHARD_STEPS}: {rec['wall_s']:.2f} s, {rec['kernel_calls']} "
            f"ShardKernel calls, op wall "
            + json.dumps({k: round(v, 3) for k, v in rec["op_wall_s"].items()})
            + f"; bitwise equal to the B1 main path: "
            f"{rec['bitwise_equal_main_path_box2d1r']}; vs oracle "
            f"{json.dumps(rec['oracle'])}; masked update "
            f"{rec['masked_update']['ms_per_rank_step']:.3f} ms per "
            f"rank-step (bound {rec['masked_update']['bound_ms']:.3f} ms)")


class _InnerTimes:
    """Times every inner ``CompiledPlan.execute`` (a hierarchical
    ShardKernel's nested run) and, inside it, the runtime's host set-up
    (``validate_domain``'s copy of the band, the slot lease)."""

    def __enter__(self):
        self.calls = []
        self._execute, self._runtime = CompiledPlan.execute, \
            CompiledPlan.runtime
        orig_execute, orig_runtime, calls = self._execute, \
            self._runtime, self.calls

        def runtime(compiled, *a, **kw):
            t = time.perf_counter()
            rt = orig_runtime(compiled, *a, **kw)
            calls[-1]["runtime_s"] = time.perf_counter() - t
            return rt

        def execute(compiled, *a, **kw):
            calls.append({})
            t = time.perf_counter()
            out = orig_execute(compiled, *a, **kw)
            calls[-1].update(execute_s=time.perf_counter() - t,
                             walk_s=out[2].wall_s)
            return out

        CompiledPlan.execute, CompiledPlan.runtime = execute, runtime
        return self.calls

    def __exit__(self, *exc):
        CompiledPlan.execute = self._execute
        CompiledPlan.runtime = self._runtime


def phase_hierarchical(size: int) -> None:
    name = "box2d1r"
    # the 1 GiB budget at full size; scaled with the domain's area below
    # it, so a shorter rehearsal expands the shards too
    c_dev = int(HIER_C_DEV * min(1.0, (size / FULL_SIZE) ** 2))
    with phase("hierarchical"):
        x = main_domain(size)
        plan = compile_hierarchical(name, size, size, HIER_STEPS,
                                    SHARD_K_ICI, HIER_MESH, c_dev=c_dev,
                                    inner_engine="so2dr")
        check(isinstance(plan, HierarchicalPlan) and plan.inner_chunks >= 2,
              type(plan).__name__)
        with _InnerTimes() as inner:
            out, rec, es = run_sharded_sim(plan, x)
        n_calls = plan.n_ranks * plan.rounds
        check(len(inner) == n_calls, len(inner))
        sk_wall = es.op_wall_s["ShardKernel"]
        walk = sum(c["walk_s"] for c in inner)
        rec.update(stencil=name, shape=[size, size], n=HIER_STEPS,
                   k_ici=SHARD_K_ICI, mesh=list(HIER_MESH), c_dev=c_dev,
                   inner_engine="so2dr", inner_chunks=plan.inner_chunks,
                   inner_calls=n_calls,
                   shard_kernel_s_per_rank_round=sk_wall / n_calls,
                   inner_walk_s_per_rank_round=walk / n_calls,
                   host_setup_s_per_rank_round=(sk_wall - walk) / n_calls,
                   inner_copy_s_per_rank_round=sum(
                       c["runtime_s"] for c in inner) / n_calls,
                   band_trip_s_per_rank_round=(sk_wall - sum(
                       c["execute_s"] for c in inner)) / n_calls,
                   inner_calls_s=inner)
        flat = compile_sharded(name, size, size, HIER_STEPS, SHARD_K_ICI,
                               HIER_MESH)
        out_flat, flat_rec, _ = run_sharded_sim(flat, x)
        check(np.array_equal(out, out_flat),
              "hierarchical differs from the flat sharded plan")
        rec["flat"] = flat_rec
        rec["bitwise_equal_flat"] = True
        rec["oracle"] = oracle_check(x, name, HIER_STEPS,
                                     {"hierarchical": out})
        del out, out_flat
        RESULT["hierarchical"] = rec
        log(f"hierarchical {name} mesh {HIER_MESH} n={HIER_STEPS}, "
            f"{plan.inner_chunks} inner chunks: {rec['wall_s']:.2f} s "
            f"(flat {flat_rec['wall_s']:.2f} s), bitwise equal to flat; per "
            f"rank and round: ShardKernel "
            f"{rec['shard_kernel_s_per_rank_round']:.3f} s = inner walk "
            f"{rec['inner_walk_s_per_rank_round']:.3f} s + host set-up "
            f"{rec['host_setup_s_per_rank_round']:.3f} s (band trip "
            f"{rec['band_trip_s_per_rank_round']:.3f} s, inner copy "
            f"{rec['inner_copy_s_per_rank_round']:.3f} s); vs oracle "
            f"{json.dumps(rec['oracle'])}")


def phase_elastic(size: int) -> None:
    name = "box2d1r"
    with phase("elastic"):
        x = main_domain(size)
        plan = compile_sharded(name, size, size, HIER_STEPS, SHARD_K_ICI,
                               SHARD_MESH)
        ref, ref_rec, _ = run_sharded_sim(plan, x)
        rec = {"stencil": name, "shape": [size, size], "n": HIER_STEPS,
               "k_ici": SHARD_K_ICI, "mesh": list(SHARD_MESH),
               "fault_free_sharded_wall_s": ref_rec["wall_s"],
               "fault_free_sha256": sha256(ref)}
        reset_counts()
        faults = FaultPlan([FaultTrigger(round=1, chunk=3, op_class="*",
                                         kind=RANK_LOSS)])
        t = time.perf_counter()
        out, rep = run_elastic_sharded(plan, x, faults=faults)
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t
        launched = counts()
        check(sum(launched.values()) == 0, "a kernel launched", launched)
        check(rep.mesh_history == ((4, 2), (3, 2)) and rep.replans == 1
              and rep.extra_rounds == 1, rep)
        err = float(np.abs(out - ref).max())
        check(err <= FP32_TOL, "elastic vs fault-free", err)
        rec.update(mesh_history=[list(m) for m in rep.mesh_history],
                   replans=rep.replans, extra_rounds=rep.extra_rounds,
                   rounds_executed=rep.rounds_executed,
                   faults_injected=rep.faults_injected,
                   max_abs_err_vs_fault_free=err,
                   bitwise_equal_fault_free=bool(np.array_equal(out, ref)))
        del out, ref
        RESULT["elastic"] = rec
        log(f"elastic {name} mesh {SHARD_MESH} n={HIER_STEPS}, rank 3 lost "
            f"at round 1: {rec['wall_s']:.2f} s (fault-free sharded run "
            f"{rec['fault_free_sharded_wall_s']:.2f} s), mesh "
            f"{rep.mesh_history}, {rep.rounds_executed} rounds run, max "
            f"|err| vs fault-free {err}")


def rank_processes() -> list:
    """The shard_map backend's rank processes still alive."""
    return [p for p in multiprocessing.active_children()
            if p.name.startswith("repro_torch-rank")]


def shard_map_run(plan, x: np.ndarray, transport: str, mesh=None):
    """One ``ShardMapExecutor`` run, on ``mesh`` or else on a rank group
    of its own (closed after); checked against the plan: the plan's
    stats and calls, the transport of the rule, no kernel of
    ``repro_torch.kernels`` launched.  A run on ``mesh`` counts the
    mesh's start in its wall and split."""
    reset_counts()
    t = time.perf_counter()
    with ShardMapExecutor(mesh=mesh, timeout=RANK_TIMEOUT_S) as ex:
        out, stats = ex.execute(plan, x)
    wall = time.perf_counter() - t
    launched = counts()
    es = ex.exec_stats
    check(sum(launched.values()) == 0, "a kernel launched", launched)
    check(stats == plan.stats()
          and es.kernel_calls == plan.n_ranks * plan.rounds
          and es.stage_count == len(plan.barriers), es.kernel_calls)
    check(ex.transport == transport, ex.transport, transport)
    check(out.shape == x.shape and bool(np.isfinite(out).all()),
          "output shape or finiteness")
    split = dict(es.op_wall_s)
    if mesh is not None:
        split["GroupStart"] = mesh.start_s
        wall += mesh.start_s
    else:
        check(not rank_processes(), "rank processes outlive their executor")
    steps = plan.rounds * plan.k_ici
    ranks = [dict(rank=r["rank"], load_s=r["load_s"], rounds_s=r["rounds_s"],
                  halo_s=r["halo_s"], update_s=r["update_s"],
                  store_s=r["store_s"],
                  update_ms_per_rank_step=r["update_ms"] / steps)
             for r in ex.rank_stats]
    rec = dict(wall_s=wall, transport=ex.transport, wall_split_s=split,
               kernel_calls=es.kernel_calls, launches=launched, ranks=ranks)
    return out, rec


def phase_shard_map(size: int) -> None:
    name = "box2d1r"
    with phase("shard_map"):
        torch.cuda.empty_cache()   # the ranks' own contexts need the card
        x = main_domain(size)
        rec = {"stencil": name, "shape": [size, size]}
        # one (4, 2) group of 8 rank processes sharing the card, for (a)
        # and for the elastic run's (4, 2) rounds in (b)
        mesh = RankMesh(SHARD_MESH, timeout=RANK_TIMEOUT_S)
        try:
            rec["mesh4x2"] = shard_map_mesh4x2(size, x, mesh)
            rec["elastic"] = shard_map_elastic(size, x, mesh)
        finally:
            mesh.close()
        check(not rank_processes(), "rank processes outlive their mesh")
        rec["elastic"]["rank_processes_alive_after"] = 0

        # (c) one rank over NCCL, against the simulator
        plan11 = compile_sharded(name, size, size, HIER_STEPS, SHARD_K_ICI,
                                 (1, 1))
        out, run = shard_map_run(plan11, x, "nccl")
        sim_out, sim_rec, _ = run_sharded_sim(plan11, x)
        check(np.array_equal(out, sim_out),
              "NCCL (1, 1) differs from the simulator")
        del out, sim_out
        torch.cuda.empty_cache()
        run.update(n=HIER_STEPS, k_ici=SHARD_K_ICI, mesh=[1, 1],
                   bitwise_equal_sim=True, sim_wall_s=sim_rec["wall_s"])
        rec["mesh1x1_nccl"] = run
        RESULT["shard_map"] = rec
        log(f"shard_map {name} mesh (1, 1) n={HIER_STEPS} over NCCL: "
            f"{run['wall_s']:.2f} s, split "
            + json.dumps({k: round(v, 3)
                          for k, v in run["wall_split_s"].items()})
            + f"; bitwise equal to the simulator "
            f"({sim_rec['wall_s']:.2f} s)")


def shard_map_mesh4x2(size: int, x: np.ndarray, mesh) -> dict:
    """(a) the sharded phase's plan on ``mesh``'s 8 rank processes."""
    name = "box2d1r"
    plan = compile_sharded(name, size, size, SHARD_STEPS, SHARD_K_ICI,
                           SHARD_MESH)
    out, run = shard_map_run(plan, x, "gloo+host-staging", mesh)
    digest = sha256(out)
    run.update(n=SHARD_STEPS, k_ici=SHARD_K_ICI, mesh=list(SHARD_MESH),
               rounds=plan.rounds, ranks_n=plan.n_ranks, sha256=digest,
               bitwise_equal_sharded=digest == RESULT["sharded"]["sha256"],
               bitwise_equal_main_path_box2d1r=(
                   digest == RESULT["main_path_box2d1r"]["sha256"]))
    if run["bitwise_equal_sharded"]:
        run["oracle"] = dict(carried_over_from="sharded",
                             **RESULT["sharded"]["oracle"]["sharded"])
    else:
        run["oracle"] = oracle_check(x, name, SHARD_STEPS,
                                     {"shard_map": out})
    del out
    ms = [r["update_ms_per_rank_step"] for r in run["ranks"]]
    run["update_ms_per_rank_step_min_max"] = [min(ms), max(ms)]
    log(f"shard_map {name} mesh {SHARD_MESH} n={SHARD_STEPS} over "
        f"{run['transport']}: {run['wall_s']:.2f} s (sharded simulator "
        f"{RESULT['sharded']['wall_s']:.2f} s); split "
        + json.dumps({k: round(v, 3) for k, v in run["wall_split_s"].items()})
        + f"; masked update {min(ms):.3f}-{max(ms):.3f} ms per rank-step "
        f"(CUDA events, 8 contexts time-sliced); bitwise equal to sharded: "
        f"{run['bitwise_equal_sharded']}, to the B1 main path: "
        f"{run['bitwise_equal_main_path_box2d1r']}")
    return run


def shard_map_elastic(size: int, x: np.ndarray, mesh) -> dict:
    """(b) the elastic phase's rank loss through ``ShardMapExecutor``:
    the (4, 2) rounds on ``mesh``, the (3, 2) rounds on a group the
    harness starts and stops."""
    name = "box2d1r"
    plan = compile_sharded(name, size, size, HIER_STEPS, SHARD_K_ICI,
                           SHARD_MESH)
    faults = FaultPlan([FaultTrigger(round=1, chunk=3, op_class="*",
                                     kind=RANK_LOSS)])
    made = []

    def factory(mesh_shape):
        made.append(ShardMapExecutor(
            mesh=mesh if mesh_shape == SHARD_MESH else None,
            timeout=RANK_TIMEOUT_S))
        return made[-1]

    reset_counts()
    t = time.perf_counter()
    out, rep = run_elastic_sharded(plan, x, faults=faults,
                                   executor_factory=factory)
    wall = time.perf_counter() - t
    launched = counts()
    check(sum(launched.values()) == 0, "a kernel launched", launched)
    check(rep.mesh_history == ((4, 2), (3, 2)) and rep.replans == 1
          and rep.extra_rounds == 1, rep)
    check(all(e._own is None for e in made),
          "the harness left a rank group running")
    digest = sha256(out)
    if digest == RESULT["elastic"]["fault_free_sha256"]:
        err = 0.0
    else:
        ref, _, _ = run_sharded_sim(plan, x)
        err = float(np.abs(out - ref).max())
        del ref
        torch.cuda.empty_cache()
    check(err <= FP32_TOL, "elastic shard_map vs fault-free", err)
    del out
    log(f"shard_map elastic {name} mesh {SHARD_MESH} n={HIER_STEPS}, rank 3 "
        f"lost at round 1: {wall:.2f} s (simulator "
        f"{RESULT['elastic']['wall_s']:.2f} s; the (4, 2) group started "
        f"before), mesh {rep.mesh_history}, {rep.rounds_executed} rounds "
        f"run, max |err| vs fault-free {err}")
    return dict(
        n=HIER_STEPS, k_ici=SHARD_K_ICI, wall_s=wall,
        sim_elastic_wall_s=RESULT["elastic"]["wall_s"],
        mesh4x2_group_started_before=True,
        mesh_history=[list(m) for m in rep.mesh_history],
        replans=rep.replans, extra_rounds=rep.extra_rounds,
        rounds_executed=rep.rounds_executed,
        faults_injected=rep.faults_injected, executors=len(made),
        transports=sorted({e.transport for e in made if e.transport}),
        max_abs_err_vs_fault_free=err,
        bitwise_equal_fault_free=(
            digest == RESULT["elastic"]["fault_free_sha256"]))


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def device_kernel_ms(fn, top: int = 8, host: bool = False) -> dict:
    """One call of ``fn`` traced: the device-busy ms (the union of its
    kernels' and copies' spans), the number of spans, and the ``top``
    kernels by summed device ms.  ``host`` traces the host's op events
    too (the lm_serve yardstick); without them the card alone is traced,
    since host events would slow a training step of ~50k launches
    several times over."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    if not spans:
        return {"busy_ms": None, "kernels": 0, "top": []}
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_ms": (busy + hi - lo) / 1e3, "kernels": len(spans),
            "top": [(name[:120], ms) for name, ms in ranked]}


def lm_decode_gate(model, params, tokens: torch.Tensor) -> tuple:
    """(prefill's logits vs forward's last position, absolute; the first
    decode step vs forward on the extended prompt, relative to its max
    |logit|), as tests/test_models.py:55-73; every logit finite."""
    B, S = tokens.shape
    cache = model.init_cache(B, S + LM_NEW)
    lg_pre, cache = model.prefill(params, {"tokens": tokens}, cache)
    full, _ = model.forward(params, {"tokens": tokens})
    check(bool(torch.isfinite(full).all()), "forward logits not finite")
    e_pre = float((lg_pre[:, 0].float() - full[:, -1].float()).abs().max())
    del full
    nxt = lg_pre[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    lg_dec, _ = model.decode_step(params, nxt, S, cache)
    del cache
    full, _ = model.forward(params, {"tokens": torch.cat([tokens, nxt], 1)})
    check(bool(torch.isfinite(full).all()), "forward logits not finite")
    ref = full[:, S].float()
    del full
    check(bool(torch.isfinite(lg_pre).all() and torch.isfinite(lg_dec).all()),
          "prefill or decode logits not finite")
    e_dec = float((lg_dec[:, 0].float() - ref).abs().max()
                  / (ref.abs().max() + 1e-6))
    return e_pre, e_dec


def weight_cast_bytes(params) -> int:
    """The largest bf16 copy of one weight a step makes: one layer's
    slice of a stacked leaf (3-D and up), or a whole matrix."""
    return max(2 * (w.numel() // w.shape[0] if w.ndim >= 3 else w.numel())
               for w in _leaves(params))


def decode_step_memory(one_step, state, params) -> dict:
    """One decode step's rise in ``max_memory_allocated`` over the memory
    allocated before it, beside the cache's bytes and the gate; the peak
    so far is kept (the rise resets the peak statistics)."""
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    cache = sum(t.numel() * t.element_size() for t in _leaves(state["cache"]))
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    one_step()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    cast = weight_cast_bytes(params)
    return dict(peak_before_step=peak, cache_bytes=cache,
                decode_step_rise_bytes=rise, weight_cast_bytes=cast,
                decode_step_rise_over_cache=rise / cache,
                decode_step_rise_gate_bytes=int(
                    LM_STEP_CACHES * cache + LM_STEP_MARGIN + cast))


def lm_serve_one(arch: str, n_layers) -> dict:
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(LM_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = _leaves(params)
    weight_bytes = sum(w.numel() * w.element_size() for w in leaves)
    tokens = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)).cuda()
    B, S = tokens.shape
    rec = dict(arch=arch, n_layers=cfg.n_layers,
               n_layers_published=get_config(arch).n_layers,
               d_model=cfg.d_model, vocab=cfg.vocab, batch=B, prompt=S,
               new_tokens=LM_NEW, max_len=S + LM_NEW,
               params=sum(w.numel() for w in leaves),
               weight_bytes=weight_bytes, init_s=init_s)

    e_pre, e_dec = lm_decode_gate(model, params, tokens)
    rec.update(prefill_vs_forward_abs=e_pre, decode_vs_forward_rel=e_dec)
    if cfg.family == "moe":
        # the gate at capacity factor E/K (every token fits, nothing
        # drops); the model's own factor's decode error is recorded
        ample = dataclasses.replace(cfg, capacity_factor=max(
            cfg.capacity_factor, cfg.n_experts / cfg.top_k))
        rec["decode_vs_forward_rel_own_capacity"] = e_dec
        rec["capacity_own"] = dict(
            prefill=moe_capacity(cfg, B * S), decode=moe_capacity(cfg, B))
        e_pre_ample, e_dec = lm_decode_gate(build_model(ample), params,
                                            tokens)
        rec.update(capacity_factor_gate=ample.capacity_factor,
                   prefill_vs_forward_abs_ample=e_pre_ample,
                   decode_vs_forward_rel=e_dec)
        check(e_pre_ample < LM_PREFILL_TOL, arch, "prefill vs forward",
              e_pre_ample)
    check(e_pre < LM_PREFILL_TOL, arch, "prefill vs forward", e_pre)
    check(e_dec < LM_DECODE_TOL, arch, "decode vs forward", e_dec)

    # CUDA-event times of one prefill and of decode steps (warm: the
    # gates above ran both)
    batch = {"tokens": tokens}
    cache0 = model.init_cache(B, S + LM_NEW)
    out = {}
    rec["prefill_ms"] = cuda_ms(
        lambda: out.update(c=model.prefill(params, batch, cache0)), 2)
    logits, cache = out.pop("c")
    tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    state = {"cache": cache, "pos": S}

    def one_step():
        _, state["cache"] = model.decode_step(params, tok, state["pos"],
                                              state["cache"])
        state["pos"] += 1

    rec["decode_ms_per_step"] = cuda_ms(one_step, 8)
    rec.update(decode_step_memory(one_step, state, params))
    check(rec["decode_step_rise_bytes"] <= rec["decode_step_rise_gate_bytes"],
          arch, "one decode step's memory rise", rec["decode_step_rise_bytes"],
          rec["decode_step_rise_gate_bytes"])
    busy = device_kernel_ms(one_step, host=True)["busy_ms"]
    rec["decode_device_busy_ms"] = busy
    rec["decode_device_busy_share"] = (
        None if busy is None else busy / rec["decode_ms_per_step"])
    del cache0, cache, state, logits

    # the serve path itself: prefill + 31 decode steps, host clock
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = greedy_generate(model, params, batch, LM_NEW, S + LM_NEW)
    torch.cuda.synchronize()
    rec["generate_s"] = time.perf_counter() - t0
    check(tuple(toks.shape) == (B, LM_NEW) and toks.dtype == torch.int32,
          tuple(toks.shape), toks.dtype)
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token out of range")
    rec["tokens_per_s"] = B * LM_NEW / rec["generate_s"]
    rec["decode_tokens_per_s"] = B / (rec["decode_ms_per_step"] / 1e3)
    rec["first_tokens"] = toks[:, :4].tolist()
    # data-sheet rate: every weight read once per decode step, as stored
    rec["decode_weight_bound_ms"] = weight_bytes / HBM_BYTES_PER_S * 1e3
    rec["decode_over_bound"] = (rec["decode_ms_per_step"]
                                / rec["decode_weight_bound_ms"])
    rec["max_memory_allocated_gb"] = max(
        rec.pop("peak_before_step"), torch.cuda.max_memory_allocated()) / 1e9
    del params, leaves, toks
    torch.cuda.empty_cache()
    return rec


def phase_lm_serve() -> None:
    with phase("lm_serve"):
        rec = {"bf16_reduced_precision_reduction":
               torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}
        reset_counts()
        for arch, n_layers in LM_MODELS:
            r = rec[arch] = lm_serve_one(arch, n_layers)
            cut = ("" if r["n_layers"] == r["n_layers_published"] else
                   f", n_layers cut to {r['n_layers']} of "
                   f"{r['n_layers_published']}")
            gate = ("" if "capacity_factor_gate" not in r else
                    f" at capacity factor {r['capacity_factor_gate']} "
                    f"(own {get_config(arch).capacity_factor}: "
                    f"{r['decode_vs_forward_rel_own_capacity']:.3e}, decode "
                    f"capacity {r['capacity_own']['decode']})")
            log(f"lm_serve {arch} (full width{cut}; {r['params'] / 1e6:.1f} M "
                f"params, {r['weight_bytes'] / 1e9:.2f} GB fp32): {r['batch']} "
                f"x {r['prompt']} prompt tokens, {r['new_tokens']} new; "
                f"prefill {r['prefill_ms']:.2f} ms, decode "
                f"{r['decode_ms_per_step']:.2f} ms/step (CUDA events; "
                f"weight-byte bound {r['decode_weight_bound_ms']:.3f} ms at "
                f"the data-sheet 3.35 TB/s, {r['decode_over_bound']:.1f}x; "
                f"device busy {r['decode_device_busy_ms']} ms of a step by "
                f"the profiler); "
                f"greedy_generate {r['generate_s']:.2f} s, "
                f"{r['tokens_per_s']:.1f} tokens/s; device memory peak "
                f"{r['max_memory_allocated_gb']:.2f} GB; one decode step "
                f"raised it {r['decode_step_rise_bytes'] / 1e6:.1f} MB "
                f"({r['decode_step_rise_over_cache']:.3f}x the "
                f"{r['cache_bytes'] / 1e6:.1f} MB cache; largest weight "
                f"cast {r['weight_cast_bytes'] / 1e6:.1f} MB; gate "
                f"{r['decode_step_rise_gate_bytes'] / 1e6:.1f} MB); "
                f"prefill vs forward "
                f"{r['prefill_vs_forward_abs']:.3e} abs, decode vs forward "
                f"{r['decode_vs_forward_rel']:.3e} rel{gate}")
        launched = counts()
        check(sum(launched.values()) == 0, "a kernel launched", launched)
        RESULT["lm_serve"] = rec


def dense_train_flops(cfg, B: int, S: int) -> dict:
    """FLOPs of one training step of a dense model as the port runs it:
    each layer's GEMMs four times (forward, the layer's remat recompute,
    two in the backward), the tied head's three times, and attention's
    score and value products five times (forward, the layer's recompute,
    the q chunk's recompute, two in the backward) over every kv block of
    every q chunk, masked or not (``chunked_attention`` skips none)."""
    T, d, hd = B * S, cfg.d_model, cfg.d_head
    layer = (d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
             + (3 if cfg.mlp == "swiglu" else 2) * d * cfg.d_ff)
    q_chunk, kv_chunk = min(512, S), min(1024, S)
    sq, sk = -(-S // q_chunk) * q_chunk, -(-S // kv_chunk) * kv_chunk
    out = {"layer_gemms": 4 * 2 * T * layer * cfg.n_layers,
           "head": 3 * 2 * T * d * cfg.vocab,
           "attention": 5 * 2 * 2 * B * cfg.n_heads * sq * sk * hd
           * cfg.n_layers}
    out["total"] = sum(out.values())
    return out


class StepTimer:
    """Wraps ``Trainer.step`` with CUDA events, read after the run."""

    def __init__(self, trainer):
        self.events = []
        inner = trainer.step

        def step(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*args)
            end.record()
            self.events.append((start, end))
            return out

        trainer.step = step

    def ms(self) -> list:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def lm_train_data(cfg, seed: int = LM_SEED) -> SyntheticLM:
    return SyntheticLM(DataSpec(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ,
                                global_batch=LM_TRAIN_BATCH, seed=seed))


def lm_gen() -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(LM_SEED)


def lm_train_qwen3() -> dict:
    """(a) qwen3-0.6b whole: 20 steps, the loss gate, the microbatch gate."""
    cfg = get_config("qwen3-0.6b")
    model = build_model(cfg)
    data = lm_train_data(cfg)
    tr = Trainer(model, AdamW(lr=3e-4, warmup_steps=1,
                              total_steps=LM_TRAIN_STEPS),
                 TrainConfig(steps=LM_TRAIN_STEPS, log_every=10))
    timer = StepTimer(tr)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt_state, losses = tr.run(lm_gen(), data)
    wall = time.perf_counter() - t0
    ms = timer.ms()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(len(losses) == LM_TRAIN_STEPS and bool(np.isfinite(losses).all()),
          "qwen3 losses", losses)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first - 0.2, "qwen3 loss did not decrease", losses)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    step_ms = float(np.mean(ms[1:]))
    flops = dense_train_flops(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    n_params = sum(t.numel() for t in tree_leaves(params))
    # the optimizer's own traffic: p, g, m, v read and p, m, v written
    opt_bytes = 7 * 4 * n_params
    rec = dict(arch="qwen3-0.6b", n_layers=cfg.n_layers, vocab=cfg.vocab,
               params=n_params, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
               steps=LM_TRAIN_STEPS, losses=losses, first5_mean=first,
               last5_mean=last, step_ms=ms, first_step_ms=ms[0],
               step_ms_mean=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
               run_wall_s=wall, max_memory_allocated_gb=peak,
               flops=flops,
               flop_bound_ms=flops["total"] / BF16_FLOPS_PER_S * 1e3,
               optimizer_byte_bound_ms=opt_bytes / HBM_BYTES_PER_S * 1e3)
    rec["bound_ms"] = max(rec["flop_bound_ms"], rec["optimizer_byte_bound_ms"])

    # one more step, 4 microbatches against 1, from the trained params
    # with fresh moments (the JAX test's lr 1e-3, no clipping, step 1):
    # the grads the step applies, then the params after it
    del opt_state
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch(LM_TRAIN_STEPS).items()}
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=2, clip_norm=None)
    out = {}
    for m in (1, 4):
        mt = Trainer(model, opt, TrainConfig(steps=1, microbatches=m),
                     donate=False)

        def one_step(m=m, mt=mt):
            # Trainer.step's work without compression: grads, then AdamW
            loss, g = mt.grads(params, batch)
            out[m] = (float(loss), g,
                      opt.update(g, opt.init(params), params)[0])

        if m == 1:
            # the same work as a training step, traced on the card
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec["step_profile"] = device_kernel_ms(one_step)
            rec["profiled_step_wall_ms"] = (time.perf_counter() - t0) * 1e3
        else:
            one_step()
    grad_errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                 for a, b in zip(tree_leaves(out[4][1]), tree_leaves(out[1][1]))]
    err = max(float((a - b).abs().max()) for a, b in
              zip(tree_leaves(out[1][2]), tree_leaves(out[4][2])))
    rec.update(microbatch_loss=[out[1][0], out[4][0]],
               microbatch_grad_max_rel=max(grad_errs),
               microbatch_grad_median_rel=float(np.median(grad_errs)),
               microbatch_max_abs_diff=err)
    check(bool(np.isfinite(grad_errs).all())
          and max(grad_errs) <= LM_MICROBATCH_GRAD_TOL,
          "microbatches 4 vs 1, grads", max(grad_errs))
    check(err <= LM_MICROBATCH_ATOL, "microbatches 4 vs 1, params", err)
    del out, params
    torch.cuda.empty_cache()
    return rec


def lm_train_mamba2_resume(out_dir: str) -> dict:
    """(b) mamba2-130m whole: 6 steps straight against 3, a checkpoint, a
    restore and 3 more, every leaf bitwise equal, under deterministic
    algorithms.  Run in a process of its own that has
    ``LM_RESUME_ENV`` set before CUDA starts (cuBLAS reads it then)."""
    for k, v in LM_RESUME_ENV.items():
        check(os.environ.get(k) == v, k, os.environ.get(k))
    cfg = get_config("mamba2-130m")
    model = build_model(cfg)
    data = lm_train_data(cfg)
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=6)
    ckpt_dir = os.path.join(out_dir, "lm_train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def trainer(steps, ckpt):
        tr = Trainer(model, opt, TrainConfig(steps=steps, ckpt_every=3,
                                             log_every=1000))
        if ckpt:
            tr.ckpt = TimedCheckpointManager(ckpt_dir, keep=3)
        return tr

    torch.use_deterministic_algorithms(True)
    try:
        p_full, st_full, l_full = trainer(6, False).run(lm_gen(), data)
        first = trainer(3, True)
        first.run(lm_gen(), data)                       # saves step 2
        second = trainer(6, True)
        p_res, st_res, l_res = second.run(lm_gen(), data, resume=True)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    full = tree_leaves({"p": p_full, "mu": st_full.mu, "nu": st_full.nu})
    res = tree_leaves({"p": p_res, "mu": st_res.mu, "nu": st_res.nu})
    differ = sum(not torch.equal(a, b) for a, b in zip(full, res))
    rec = dict(losses_straight=l_full, losses_resumed=l_res,
               leaves=len(full), leaves_not_bitwise=differ,
               save_s=first.ckpt.save_s + second.ckpt.save_s,
               restore_s=second.ckpt.restore_s,
               checkpoint_gb=sum(t.numel() * t.element_size()
                                 for t in full) / 1e9,
               resume_max_memory_allocated_gb=(
                   torch.cuda.max_memory_allocated() / 1e9))
    check(bool(np.isfinite(l_full).all()), "mamba2 losses", l_full)
    check(l_res == l_full[3:] and differ == 0
          and int(st_res.step) == int(st_full.step) == 6,
          "mamba2 resume not bitwise", differ, l_full, l_res)
    return rec


def lm_train_mamba2(out_dir: str) -> dict:
    """(b) mamba2-130m whole: the bitwise resume in a process of its own
    (``lm_train_mamba2_resume``); bf16 gradient compression converges."""
    cfg = get_config("mamba2-130m")
    rec = {"arch": "mamba2-130m", "n_layers": cfg.n_layers,
           "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ}
    code = ("import json, sys, chip_smoke; print(json.dumps("
            "chip_smoke.lm_train_mamba2_resume(sys.argv[1])))")
    t0 = time.perf_counter()
    try:
        run = subprocess.run([sys.executable, "-c", code, out_dir], cwd=ROOT,
                             env=dict(os.environ, **LM_RESUME_ENV),
                             capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(os.path.join(out_dir, "lm_train_ckpt"),
                      ignore_errors=True)
    rec["resume_process_s"] = time.perf_counter() - t0
    check(run.returncode == 0, "mamba2 resume process", run.returncode,
          run.stderr[-3000:])
    rec.update(json.loads(run.stdout.strip().splitlines()[-1]))

    model = build_model(cfg)
    data = lm_train_data(cfg)
    tr = Trainer(model, AdamW(lr=3e-3, warmup_steps=2, total_steps=20),
                 TrainConfig(steps=20, log_every=1000,
                             grad_compression="bf16"))
    timer = StepTimer(tr)
    torch.cuda.reset_peak_memory_stats()
    _, _, losses = tr.run(lm_gen(), data)
    ms = timer.ms()
    rec.update(compression_losses=losses,
               compression_first4_mean=float(np.mean(losses[:4])),
               compression_last4_mean=float(np.mean(losses[-4:])),
               step_ms_mean=float(np.mean(ms[1:])),
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(bool(np.isfinite(losses).all())
          and rec["compression_last4_mean"] < rec["compression_first4_mean"],
          "mamba2 bf16 compression did not converge", losses)
    torch.cuda.empty_cache()
    return rec


def lm_train_mixtral() -> dict:
    """(c) mixtral-8x7b, one layer: 3 steps through the MoE backward."""
    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, n_layers=1)
    model = build_model(cfg)
    data = lm_train_data(cfg)
    tr = Trainer(model, AdamW(lr=3e-4, warmup_steps=1, total_steps=3),
                 TrainConfig(steps=3, log_every=1000))
    timer = StepTimer(tr)
    # the Trainer's own initial weights, copied to the host (off the
    # card's peak) to see every leaf move
    before = []
    init_state = tr.init_state

    def kept_init_state(generator):
        state = init_state(generator)
        before.extend(t.cpu() for t in tree_leaves(state[0]))
        return state

    tr.init_state = kept_init_state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, _, losses = tr.run(lm_gen(), data)
    ms = timer.ms()
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the router's aux loss on step 0's batch, at the trained weights
    with torch.no_grad():
        batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch(0).items()}
        aux = float(model.forward(params, batch)[1])
    del batch
    after = tree_leaves(params)
    unmoved = sum(torch.equal(a, b.cuda()) for a, b in zip(after, before))
    rec = dict(arch="mixtral-8x7b", n_layers=cfg.n_layers,
               n_layers_published=full.n_layers, batch=LM_TRAIN_BATCH,
               seq=LM_TRAIN_SEQ, params=sum(t.numel() for t in after),
               losses=losses, aux_step0_batch=aux, leaves=len(after),
               leaves_unmoved=unmoved, step_ms=ms,
               step_ms_mean=float(np.mean(ms[1:])),
               max_memory_allocated_gb=peak)
    check(len(before) == len(after) > 0, "mixtral initial leaves", len(before))
    check(bool(np.isfinite(losses).all()), "mixtral losses", losses)
    check(aux != 0.0 and np.isfinite(aux), "mixtral aux loss", aux)
    check(unmoved == 0, "mixtral params that did not move", unmoved)
    del before, after, params
    torch.cuda.empty_cache()
    return rec


def phase_lm_train(out_dir: str) -> None:
    with phase("lm_train"):
        reset_counts()
        rec = {"qwen3": lm_train_qwen3()}
        q = rec["qwen3"]
        log(f"lm_train qwen3-0.6b (full width, {q['params'] / 1e6:.1f} M "
            f"params): {q['steps']} steps of {q['batch']} x {q['seq']} "
            f"tokens, loss {q['first5_mean']:.4f} -> {q['last5_mean']:.4f} "
            f"(means of the first and last 5); step {q['step_ms_mean']:.1f} "
            f"ms (CUDA events, first step {q['first_step_ms']:.1f} ms apart), "
            f"{q['tokens_per_s']:.0f} tokens/s; bound {q['bound_ms']:.2f} ms "
            f"({q['flops']['total'] / 1e12:.2f} TFLOP at the data-sheet "
            f"989 TFLOP/s bf16 dense, {q['step_ms_mean'] / q['bound_ms']:.1f}"
            f"x); device busy {q['step_profile']['busy_ms']} ms in "
            f"{q['step_profile']['kernels']} kernels (a profiled step, "
            f"{q['profiled_step_wall_ms']:.1f} ms wall); device memory peak "
            f"{q['max_memory_allocated_gb']:.2f} GB; microbatches 4 vs 1: "
            f"grads {q['microbatch_grad_max_rel']:.3e} of a leaf's max "
            f"(median leaf {q['microbatch_grad_median_rel']:.3e}), loss "
            f"{q['microbatch_loss'][1]:.6f} vs {q['microbatch_loss'][0]:.6f}, "
            f"params {q['microbatch_max_abs_diff']:.3e} abs")
        for name, ms in q["step_profile"]["top"]:
            log(f"  qwen3 step, device ms {ms:9.2f}  {name}")
        m = rec["mamba2"] = lm_train_mamba2(out_dir)
        log(f"lm_train mamba2-130m (full width): resume after step 3 "
            f"bitwise ({m['leaves']} leaves, deterministic algorithms, in "
            f"its own process, {m['resume_process_s']:.1f} s); "
            f"checkpoint {m['checkpoint_gb']:.2f} GB, save "
            f"{', '.join(f'{s:.2f}' for s in m['save_s'])} s, restore "
            f"{', '.join(f'{s:.2f}' for s in m['restore_s'])} s; bf16 "
            f"compression loss {m['compression_first4_mean']:.4f} -> "
            f"{m['compression_last4_mean']:.4f}, step {m['step_ms_mean']:.1f} "
            f"ms; device memory peak {m['max_memory_allocated_gb']:.2f} GB")
        x = rec["mixtral"] = lm_train_mixtral()
        log(f"lm_train mixtral-8x7b (full width, n_layers cut to "
            f"{x['n_layers']} of {x['n_layers_published']}; "
            f"{x['params'] / 1e9:.2f} B params): losses "
            f"{', '.join(f'{v:.4f}' for v in x['losses'])}, aux "
            f"{x['aux_step0_batch']:.4f} (step 0's batch, trained weights), "
            f"{x['leaves']} leaves all moved; step "
            f"{x['step_ms_mean']:.1f} ms; device memory peak "
            f"{x['max_memory_allocated_gb']:.2f} GB")
        launched = counts()
        check(sum(launched.values()) == 0, "a kernel launched", launched)
        RESULT["lm_train"] = rec


def _leaves_host(tree) -> list:
    """The leaves of a (DTensor or plain) tree of dicts and tuples, whole,
    on the host."""
    from repro_torch.launch.sharding import map_with_path

    out = []
    map_with_path(lambda _, t: out.append(
        (t.full_tensor() if hasattr(t, "full_tensor") else t).cpu()), tree)
    return out


def lm_launch_card(out_dir: str, smoke: bool = False,
                   dry: bool = True) -> dict:
    """(a)-(c) of phase lm_launch, in a process of its own (one NCCL group
    per process), started with ``LM_RESUME_ENV`` under deterministic
    algorithms (the embedding's accumulating backward is otherwise
    atomic, and two runs of it differ in their last bits).  ``smoke``
    takes qwen3's smoke config (the card tests); ``dry`` False leaves
    (b) to the caller (:func:`lm_launch_dry`, :func:`check_dry_run`)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import clear_hooks, register_hooks
    from repro_torch.launch.elastic import gather_full, replan, reshard_restored
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_analysis import CostMode
    from repro_torch.launch.sharding import (
        batch_specs, distribute, named, opt_specs, param_specs)
    from repro_torch.optim import OptState

    for k, v in LM_RESUME_ENV.items():
        check(os.environ.get(k) == v, k, os.environ.get(k))
    torch.use_deterministic_algorithms(True)
    tmp = tempfile.mkdtemp(prefix="lm_launch")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/init", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    ckpt_dir = os.path.join(out_dir, "lm_launch_ckpt")
    try:
        reset_counts()
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        rec = {"mesh": [1, 1], "backend": dist.get_backend(),
               "torch": torch.__version__}
        cfg = (get_smoke_config if smoke else get_config)("qwen3-0.6b")
        model = build_model(cfg)
        shape = ShapeSpec("lm_launch", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train")
        data = lm_train_data(cfg)
        batches = [{k: torch.from_numpy(v).cuda()
                    for k, v in data.batch(i).items()}
                   for i in range(LM_LAUNCH_STEPS)]
        opt = AdamW(lr=3e-4, warmup_steps=1, total_steps=LM_LAUNCH_STEPS,
                    moment_dtype=torch.bfloat16)
        tr = Trainer(model, opt, TrainConfig(steps=LM_LAUNCH_STEPS))

        def run(params, state, batches, first=None):
            """The steps, CUDA-event ms each; ``first`` wraps step 0."""
            losses, ms = [], []
            for i, b in enumerate(batches):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                if i == 0 and first is not None:
                    with first:
                        params, state, _, loss = tr.step(params, state, None, b)
                else:
                    params, state, _, loss = tr.step(params, state, None, b)
                ev[1].record()
                torch.cuda.synchronize()
                losses.append(float(loss))
                ms.append(ev[0].elapsed_time(ev[1]))
            return params, state, losses, ms

        # (a) the plain Trainer, then the same steps on DTensors
        params = model.init_params(lm_gen(), device="cuda")
        init_tree = tree_map(lambda t: t.to("cpu", copy=True), params)
        init = [t.clone() for t in _leaves_host(init_tree)]
        params, state, plain_losses, plain_ms = run(
            params, opt.init(params), batches)
        plain = _leaves_host({"p": params, "mu": state.mu, "nu": state.nu})
        del params, state
        torch.cuda.empty_cache()

        shapes = model.init_params(None, device="meta")
        pspecs = param_specs(cfg, shapes, mesh)
        dparams = reshard_restored(init_tree, replan(cfg, shapes, mesh))
        del init_tree
        dstate = distribute(_moments_like(opt, dparams), mesh,
                            opt_specs(pspecs))
        dbatches = [distribute(b, mesh, batch_specs(cfg, shape, b, mesh))
                    for b in batches]
        register_hooks(mesh, shape)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        args_gb = (sum(t.numel() * t.element_size() for t in
                       tree_leaves({"p": dparams, "mu": dstate.mu,
                                    "nu": dstate.nu}))
                   + sum(t.numel() * t.element_size()
                         for t in tree_leaves(dbatches[0]))) / 1e9
        counter = CostMode()
        dparams, dstate, losses, ms = run(dparams, dstate, dbatches, counter)
        peak = torch.cuda.max_memory_allocated() / 1e9
        clear_hooks()
        sharded = _leaves_host({"p": dparams, "mu": dstate.mu,
                                "nu": dstate.nu})
        differ = sum(not torch.equal(a, b) for a, b in zip(sharded, plain))
        moved = sum(not torch.equal(a, b) for a, b in
                    zip(sharded[:len(init)], init))
        rec.update(losses=losses, plain_losses=plain_losses, step_ms=ms,
                   plain_step_ms=plain_ms, leaves=len(plain),
                   leaves_not_bitwise=differ, leaves_moved=moved,
                   max_memory_allocated_gb=peak, arguments_gb=args_gb,
                   real_step_flops=counter.cost.flops,
                   real_step_bytes=counter.cost.bytes,
                   real_step_collectives=counter.cost.collectives,
                   real_step_ops=counter.ops,
                   hand_count_tflop=dense_train_flops(
                       cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)["total"] / 1e12)
        check(bool(np.isfinite(losses).all()), "lm_launch losses", losses)
        check(moved == len(init), "lm_launch: params that did not move",
              len(init) - moved)
        check(losses == plain_losses and differ == 0,
              "lm_launch: DTensor steps not bitwise to the plain Trainer",
              differ, losses, plain_losses)

        rec["one_sequence"] = lm_launch_one_sequence(mesh, smoke)

        # (b) the dry run of the same cell, here or (``dry`` False) in a
        # process of its own that the caller holds to this record
        if dry:
            check_dry_run(rec, lm_launch_dry(smoke), smoke)

        # (c) checkpoint the (1, 1) state, restore, reshard: bitwise
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        mgr = CheckpointManager(ckpt_dir, keep=1)
        state = (dparams, dstate)
        full = gather_full(state)
        t0 = time.perf_counter()
        mgr.save(LM_LAUNCH_STEPS, full)
        rec["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, meta = mgr.restore(full)
        rec["restore_s"] = time.perf_counter() - t0
        del full
        shardings = (replan(cfg, shapes, mesh),
                     named(mesh, opt_specs(pspecs)))
        t0 = time.perf_counter()
        back = reshard_restored(restored, shardings)
        torch.cuda.synchronize()
        rec["reshard_s"] = time.perf_counter() - t0
        a, b = _leaves_host(back), _leaves_host(state)
        rec["reshard_leaves"] = len(a)
        rec["reshard_not_bitwise"] = sum(not torch.equal(x, y)
                                         for x, y in zip(a, b))
        rec["checkpoint_gb"] = sum(t.numel() * t.element_size()
                                   for t in b) / 1e9
        check(meta["step"] == LM_LAUNCH_STEPS and len(a) == len(b) > 0
              and rec["reshard_not_bitwise"] == 0,
              "lm_launch: resharded checkpoint not bitwise",
              rec["reshard_not_bitwise"])
        check(isinstance(back[1], OptState), "lm_launch: OptState lost")
        rec["kernel_launches"] = counts()
        check(sum(rec["kernel_launches"].values()) == 0, "a kernel launched",
              rec["kernel_launches"])
        return rec
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def lm_launch_one_sequence(mesh, smoke: bool = False) -> dict:
    """(e) of phase lm_launch, on (a)'s (1, 1) NCCL ``mesh``: per arch of
    ``LM_LAUNCH_ONE`` at full width (``smoke``: its smoke config), one
    sequence of ``LM_LAUNCH_ONE``'s prompt, its prefill
    and greedy decode steps and a loss with grads, on plain tensors and
    on DTensors placed by the rules (params, tokens, labels, cache) from
    the same weights, each decode step fed the plain path's token.  The
    worst absolute differences (logits; the loss; grads over each leaf's
    max) and the CUDA-event ms of both paths, gated bitwise."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.sharding import (
        batch_specs, cache_specs, distribute, param_specs)

    archs, prompt, steps = LM_LAUNCH_ONE
    out = {}
    for arch in archs:
        cfg = (get_smoke_config if smoke else get_config)(arch)
        model = build_model(cfg)
        params = model.init_params(lm_gen(), device="cuda")
        dparams = distribute(params, mesh, param_specs(cfg, params, mesh))
        seq = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
            0, cfg.vocab, (1, prompt + 1)).astype(np.int32)).cuda()
        shape = ShapeSpec("one_sequence", prompt + steps, 1, "decode")

        def placed(tree, specs):
            return distribute(tree, mesh, specs(cfg, shape, tree, mesh))

        def timed(fn):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            r = fn()
            ev[1].record()
            torch.cuda.synchronize()
            return r, ev[0].elapsed_time(ev[1])

        def whole(t):
            return t.full_tensor() if hasattr(t, "full_tensor") else t

        # the prefill and decode steps, plain and placed, step by step
        batch = {"tokens": seq[:, :prompt]}
        cache = model.init_cache(1, prompt + steps)
        dbatch, dcache = placed(batch, batch_specs), placed(cache, cache_specs)
        (l0, c0), pre_ms = timed(lambda: model.prefill(params, batch, cache))
        (l1, c1), dpre_ms = timed(lambda: model.prefill(dparams, dbatch,
                                                        dcache))
        errs, ms, dms = [float((whole(l1) - l0).abs().max())], [], []
        for i in range(steps):
            tok = l0[:, -1:].argmax(-1).to(torch.int32)
            dtok = placed({"token": tok}, batch_specs)["token"]
            (l0, c0), t0 = timed(lambda: model.decode_step(
                params, tok, prompt + i, c0))
            (l1, c1), t1 = timed(lambda: model.decode_step(
                dparams, dtok, prompt + i, c1))
            errs.append(float((whole(l1) - l0).abs().max()))
            ms.append(t0)
            dms.append(t1)
        scale = float(l0.abs().max())
        del c0, c1, l0, l1, cache, dcache

        # one loss with grads of the sequence (its next tokens the labels)
        tr = Trainer(model, AdamW(), TrainConfig())
        data = {"tokens": seq[:, :prompt], "labels": seq[:, 1:]}
        ddata = placed(data, batch_specs)
        (loss0, g0), loss_ms = timed(lambda: tr.value_and_grad(params, data))
        (loss1, g1), dloss_ms = timed(lambda: tr.value_and_grad(dparams,
                                                                ddata))
        grad_err = max(float((whole(a) - b).abs().max()
                             / (b.abs().max() + 1e-30))
                       for a, b in zip(tree_leaves(g1), tree_leaves(g0)))
        r = dict(prompt=prompt, steps=steps, logit_errs=errs,
                 logit_scale=scale, loss=float(loss0),
                 loss_err=abs(float(whole(loss1)) - float(loss0)),
                 grad_err=grad_err, prefill_ms=dpre_ms,
                 plain_prefill_ms=pre_ms, decode_ms=float(np.mean(dms)),
                 plain_decode_ms=float(np.mean(ms)), loss_grads_ms=dloss_ms,
                 plain_loss_grads_ms=loss_ms,
                 placements=sorted({str(t.placements)
                                    for t in tree_leaves(dparams)}))
        out[arch] = r
        check(bool(np.isfinite(errs + [r["loss"]]).all()), arch,
              "one sequence: a value not finite", errs, r["loss"])
        check(max(errs) == 0 and r["loss_err"] == 0 and grad_err == 0,
              arch, "one sequence on the (1, 1) mesh not bitwise to the "
              "plain path", errs, r["loss_err"], grad_err)
        del params, dparams, g0, g1, loss0, loss1
        torch.cuda.empty_cache()
    return out


def lm_launch_dry(smoke: bool = False) -> dict:
    """(b) of phase lm_launch: the dry run of (a)'s cell (mesh (1, 1), fake
    CUDA tensors), needing no card."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import lower_cell

    t0 = time.perf_counter()
    dry = lower_cell("qwen3-0.6b", "lm_launch", False, mesh_shape=(1, 1),
                     device="cuda", smoke=smoke, shape=ShapeSpec(
                         "lm_launch", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train"))
    dry["wall_s"] = time.perf_counter() - t0
    return dry


def check_dry_run(rec: dict, dry: dict, smoke: bool = False) -> None:
    """(b)'s gates on (a)'s record ``rec``: the dry run's FLOPs equal the
    real step's, and (at full width) its predicted peak is within 25 % of
    the measured one."""
    peak, flops = rec["max_memory_allocated_gb"], rec["real_step_flops"]
    rec["dryrun_wall_s"] = dry["wall_s"]
    rec["dryrun"] = dry
    pred = (dry["memory"]["argument_size_in_bytes"]
            + dry["memory"]["temp_size_in_bytes"]) / 1e9
    rec["predicted_peak_gb"] = pred
    rec["peak_error"] = (pred - peak) / peak
    rec["flop_rel_diff"] = (dry["cost"]["flops"] - flops) / flops
    check(abs(rec["flop_rel_diff"]) <= LM_LAUNCH_FLOP_RTOL,
          "lm_launch: dry-run FLOPs differ from the real step's",
          dry["cost"]["flops"], flops)
    # at smoke size the card's fixed allocations (cuBLAS's workspace)
    # outweigh the model's, so only the full-width peak is gated
    check(smoke or abs(rec["peak_error"]) <= LM_LAUNCH_PEAK_TOL,
          "lm_launch: predicted peak off by more than 25 %", pred, peak)


def _moments_like(opt, params):
    """AdamW's initial state for ``params``, as plain tensors on the card
    (``distribute`` then places them by ``opt_specs``)."""
    return opt.init(tree_map(
        lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t, params))


def lm_launch_production() -> dict:
    """(d) of phase lm_launch, in a process of its own: two production
    dry-run cells on a fake group of 256 ranks, fake CUDA tensors, the
    decode cell's record under ``"decode"``."""
    from repro_torch.launch.dryrun import lower_cell

    t0 = time.perf_counter()
    rec = lower_cell(*LM_LAUNCH_PROD, False, device="cuda")
    rec["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["decode"] = lower_cell(*LM_LAUNCH_DECODE, False, device="cuda")
    rec["decode"]["wall_s"] = time.perf_counter() - t0
    from repro_torch.configs import ShapeSpec

    arch, vocab, mesh, batch, seq = LM_LAUNCH_TIED
    t0 = time.perf_counter()
    rec["tied"] = lower_cell(arch, "train_s", False, device="cuda",
                             smoke=True, mesh_shape=mesh,
                             shape=ShapeSpec("train_s", seq, batch, "train"),
                             overrides={"vocab": vocab})
    rec["tied"]["wall_s"] = time.perf_counter() - t0
    arch, shape, mesh = LM_LAUNCH_MOE
    t0 = time.perf_counter()
    rec["moe"] = lower_cell(arch, shape, False, device="cuda", smoke=True,
                            mesh_shape=mesh)
    rec["moe"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["moe_decode"] = lower_cell(*LM_LAUNCH_MOE_DECODE, False,
                                   device="cuda")
    rec["moe_decode"]["wall_s"] = time.perf_counter() - t0
    for key, (arch, shape, _) in LM_LAUNCH_STATE.items():
        t0 = time.perf_counter()
        rec[key] = lower_cell(arch, shape, False, device="cuda")
        rec[key]["wall_s"] = time.perf_counter() - t0
    rec["ended_at"] = time.time()
    return rec


def state_gathers(rec: dict, arch: str) -> dict:
    """A full-width dry-run record's all-gathers of decode state: an SSM
    state's (head_dim, state) or a conv state's (width - 1, channels), a
    KV cache's (kv heads, head_dim), each whole or a rank's share over
    "model"; a table's vocab rows (a 2-D gather whose rows are a
    multiple of the vocab)."""
    cfg = get_config(arch)
    n = rec["mesh"]["model"]
    gathers = [c for c in rec["largest_collectives"]
               if c["kind"] == "all-gather"]
    P, N, C = cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner + 2 * cfg.ssm_state
    G, hd = cfg.n_kv_heads, cfg.d_head
    state = ({(P, N), (P // n, N), (cfg.conv_width - 1, C),
              (cfg.conv_width - 1, C // n)} if cfg.ssm_state else set())
    cache = {(G, hd), (G // n, hd), (G, hd // n)}
    return {
        "state": [c["shape"] for c in gathers if len(c["shape"]) >= 3
                  and tuple(c["shape"][-2:]) in state],
        "cache": [c["shape"] for c in gathers if len(c["shape"]) >= 4
                  and tuple(c["shape"][-2:]) in cache],
        "table": [c["shape"] for c in gathers if len(c["shape"]) == 2
                  and c["shape"][0] % cfg.vocab == 0]}


def production_gates(rec: dict) -> dict:
    """The (d) records' partitioning gates (see LM_LAUNCH_PROD_TEMP_GB):
    the numbers each is judged on, and whether it holds."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.collectives import RING_FACTORS

    cfg = get_config(LM_LAUNCH_PROD[0])
    train, dec = SHAPES[LM_LAUNCH_PROD[1]], SHAPES[LM_LAUNCH_DECODE[1]]
    mesh = rec["mesh"]
    n_dp, n_tp = mesh["data"], mesh["model"]
    slab = train.global_batch // n_dp * train.seq_len * cfg.vocab // n_tp
    cache = (dec.global_batch // n_dp * dec.seq_len * cfg.n_kv_heads
             * cfg.d_head // n_tp)
    gathers = [c for c in rec["largest_collectives"]
               if c["kind"] == "all-gather"]
    kv = (cfg.n_kv_heads, cfg.d_head)
    cache_gathers = [c for c in rec["decode"]["largest_collectives"]
                     if c["kind"] == "all-gather"
                     and tuple(c["shape"][-2:]) == kv]
    out = {
        "temp_gb": rec["memory"]["temp_size_in_bytes"] / 1e9,
        "largest_all_gather": max((c["numel"] for c in gathers), default=0),
        "largest_all_reduce": max(
            (c["numel"] for c in rec["largest_collectives"]
             if c["kind"] == "all-reduce"), default=0),
        "logits_slab": slab,
        "largest_cache_gather": max((c["numel"] for c in cache_gathers),
                                    default=0),
        "cache_slice": cache}
    _, vocab, (n_dp, _), batch, seq = LM_LAUNCH_TIED
    out["tied_rows"] = batch // n_dp * seq * vocab
    out["tied_largest_all_gather"] = max(
        (c["numel"] for c in rec["tied"]["largest_collectives"]
         if c["kind"] == "all-gather"), default=0)
    moe = get_smoke_config(LM_LAUNCH_MOE[0])
    n_dp = LM_LAUNCH_MOE[2][0]
    out["moe_logits"] = (SHAPES[LM_LAUNCH_MOE[1]].global_batch // n_dp
                         * SHAPES[LM_LAUNCH_MOE[1]].seq_len * moe.vocab)
    # (by its vocab-wide last dim, whole or a rank's slice of it: the
    # designed gather of the block's tokens is larger, with D columns)
    vocab = (moe.vocab, moe.vocab // LM_LAUNCH_MOE[2][1])
    out["moe_largest"] = max(
        (c["numel"] for c in rec["moe"]["largest_collectives"]
         if c["kind"] in ("all-reduce", "all-gather")
         and c["shape"][-1] in vocab), default=0)
    full = get_config(LM_LAUNCH_MOE_DECODE[0])
    n_tp = rec["moe_decode"]["mesh"]["model"]
    D, F = full.d_model, full.d_ff
    weights = {s for d in (D, D // rec["moe_decode"]["mesh"]["data"])
               for f in (F, F // n_tp) for s in ((d, f), (f, d))}
    out["moe_weight_gathers"] = [
        c["shape"] for c in rec["moe_decode"]["largest_collectives"]
        if c["kind"] == "all-gather" and len(c["shape"]) >= 3
        and tuple(c["shape"][-2:]) in weights]
    out["moe_decode_wire_gb"] = sum(
        v * RING_FACTORS[k]
        for k, v in rec["moe_decode"]["collectives"].items()) / 1e9
    out["temp_ok"] = out["temp_gb"] <= LM_LAUNCH_PROD_TEMP_GB
    out["vocab_ok"] = max(out["largest_all_gather"],
                          out["largest_all_reduce"]) < slab
    out["cache_ok"] = out["largest_cache_gather"] < cache
    out["tied_ok"] = (rec["tied"]["cost"]["flops"] > 0 and
                      out["tied_largest_all_gather"] < out["tied_rows"])
    out["moe_ok"] = (rec["moe"]["cost"]["flops"] > 0
                     and out["moe_largest"] < out["moe_logits"])
    out["moe_decode_ok"] = (not out["moe_weight_gathers"] and
                            out["moe_decode_wire_gb"] <= LM_LAUNCH_MOE_WIRE_GB)
    for key, (arch, _, jax_gb) in LM_LAUNCH_STATE.items():
        r = rec[key]
        wire = sum(v * RING_FACTORS[k]
                   for k, v in r["collectives"].items()) / 1e9
        bad = state_gathers(r, arch)
        out[key] = {"wire_gb": wire, "bound_gb": LM_LAUNCH_STATE_WIRE * jax_gb,
                    "gathers": bad,
                    "ok": (r["cost"]["flops"] > 0 and not any(bad.values())
                           and wire <= LM_LAUNCH_STATE_WIRE * jax_gb)}
    return out


def _json_child(code: str, env=None, err_path=None):
    """``python -c code`` from the checkout, started now (its last line of
    output is read by :func:`_json_result`); its errors to ``err_path``
    where given (a child left running for minutes must not fill a pipe
    no one reads yet)."""
    err = subprocess.PIPE if err_path is None else open(err_path, "w")
    try:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                env=dict(os.environ, **(env or {})),
                                stdout=subprocess.PIPE, stderr=err,
                                text=True)
    finally:
        if err_path is not None:
            err.close()
    proc.err_path = err_path
    return proc


def _json_result(proc, what: str) -> dict:
    try:
        out, err = proc.communicate(timeout=LM_LAUNCH_TIMEOUT_S)
    finally:
        _stop(proc)
    if proc.err_path is not None:
        with open(proc.err_path) as f:
            err = f.read()
    check(proc.returncode == 0, what, proc.returncode, err[-3000:])
    return json.loads(out.strip().splitlines()[-1])


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


class HostTrace:
    """(d) of phase lm_launch in a child process started with the run:
    its dry runs need no card, so they trace while the kernels build and
    the card times them.  The child is paused while a main path times
    its walls on the host (:meth:`paused`), its memory is charged to it,
    not to the phases it runs beside (``RAM.child``), and phase
    lm_launch_trace reads it before the phases from recovery on, which
    time the host throughout."""

    def __init__(self, out_dir: str):
        self.proc = _json_child(
            "import json, chip_smoke; print(json.dumps("
            "chip_smoke.lm_launch_production()))",
            err_path=os.path.join(out_dir, "lm_launch_production.err"))
        self.started_at = time.time()
        self.paused_s, self.pauses = 0.0, 0
        RAM.child = self.proc

    @contextlib.contextmanager
    def paused(self):
        live = self.proc.poll() is None
        if live:
            os.kill(self.proc.pid, signal.SIGSTOP)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if live:
                os.kill(self.proc.pid, signal.SIGCONT)
                self.paused_s += time.perf_counter() - t0
                self.pauses += 1

    def result(self) -> dict:
        """The child's record (waiting for it), with the seconds from its
        start to its end, its paused seconds and its memory peak."""
        try:
            rec = _json_result(self.proc, "lm_launch (d) process")
        finally:
            RAM.child = None
        rec["host_trace"] = {"done_s": rec["ended_at"] - self.started_at,
                             "paused_s": self.paused_s,
                             "pauses": self.pauses,
                             "anon_peak_gb": RAM.child_peak / 1e9}
        return rec

    def stop(self) -> None:
        _stop(self.proc)


def phase_lm_launch_trace() -> dict:
    """Wait for and read (d) (:class:`HostTrace`): the phases from here on
    time the host throughout, so none of them runs beside it."""
    with phase("lm_launch_trace"):
        rec = TRACE.result()
        h = rec["host_trace"]
        log(f"lm_launch (d) traced on the host from the run's start: done "
            f"after {h['done_s']:.1f} s, paused {h['paused_s']:.1f} s in {h['pauses']} host-timed "
            f"walls, its memory peak {h['anon_peak_gb']:.1f} GB "
            f"(charged to it, not to those phases)")
        return rec


def phase_lm_launch(out_dir: str, prod: dict | None = None) -> None:
    """(a)-(c) on the card in one process, (b)'s dry run on the host in
    another beside it; ``prod`` is (d)'s record (:class:`HostTrace`;
    None, the phase run alone: traced here beside them)."""
    with phase("lm_launch"):
        reset_counts()
        trace = HostTrace(out_dir) if prod is None else None
        card = _json_child(
            "import json, chip_smoke; print(json.dumps("
            f"chip_smoke.lm_launch_card({out_dir!r}, dry=False), "
            "default=str))", env=LM_RESUME_ENV)
        try:
            dry = _json_result(_json_child(
                "import json, chip_smoke; print(json.dumps("
                "chip_smoke.lm_launch_dry()))"), "lm_launch (b) process")
            rec = _json_result(card, "lm_launch (a)-(c) process")
            rec["production"] = prod or trace.result()
        finally:
            _stop(card)
            if trace is not None:
                trace.stop()
        check_dry_run(rec, dry)
        d, p = rec["dryrun"], rec["production"]
        log(f"lm_launch qwen3-0.6b (full width) on a (1, 1) DTensor mesh over "
            f"{rec['backend']}: {LM_LAUNCH_STEPS} steps of {LM_TRAIN_BATCH} x "
            f"{LM_TRAIN_SEQ} tokens, losses "
            f"{', '.join(f'{v:.6f}' for v in rec['losses'])}, bitwise to the "
            f"plain Trainer ({rec['leaves']} param and moment leaves, "
            f"{rec['leaves_not_bitwise']} differ); step ms (CUDA events) "
            f"{', '.join(f'{v:.1f}' for v in rec['step_ms'])} (step 0 "
            f"counted) vs plain {', '.join(f'{v:.1f}' for v in rec['plain_step_ms'])}; "
            f"device peak {rec['max_memory_allocated_gb']:.2f} GB")
        for arch, r in rec["one_sequence"].items():
            log(f"lm_launch one sequence {arch} (full width, B = 1 on a "
                f"data axis of size 1) on that (1, 1) mesh: prefill of "
                f"{r['prompt']} tokens + {r['steps']} decode "
                f"steps, logits max abs err "
                f"{max(r['logit_errs']):.3e} (scale {r['logit_scale']:.3f}), "
                f"loss {r['loss']:.6f} err {r['loss_err']:.3e}, grads err "
                f"{r['grad_err']:.3e} of a leaf's max (bitwise gate); ms "
                f"(CUDA events) prefill {r['prefill_ms']:.1f} vs plain "
                f"{r['plain_prefill_ms']:.1f}, decode step "
                f"{r['decode_ms']:.2f} vs {r['plain_decode_ms']:.2f}, loss "
                f"with grads {r['loss_grads_ms']:.1f} vs "
                f"{r['plain_loss_grads_ms']:.1f}")
        log(f"lm_launch dry run of that cell: {d['compile_s']} s trace, "
            f"{d['cost']['flops'] / 1e12:.4f} TFLOP vs the real step's "
            f"{rec['real_step_flops'] / 1e12:.4f} (analyze; rel diff "
            f"{rec['flop_rel_diff']:.2e}), dense_train_flops' hand count "
            f"{rec['hand_count_tflop']:.2f}; predicted peak "
            f"{rec['predicted_peak_gb']:.2f} GB (arguments "
            f"{d['memory']['argument_size_in_bytes'] / 1e9:.2f} + temp "
            f"{d['memory']['temp_size_in_bytes'] / 1e9:.2f}) vs measured "
            f"{rec['max_memory_allocated_gb']:.2f} GB ({rec['peak_error']:+.1%})")
        log(f"lm_launch reshard_restored on the card: {rec['reshard_leaves']} "
            f"leaves bitwise ({rec['reshard_not_bitwise']} differ), "
            f"{rec['checkpoint_gb']:.2f} GB, save {rec['save_s']:.2f} s, "
            f"restore {rec['restore_s']:.2f} s, reshard {rec['reshard_s']:.2f} s")
        colls = ", ".join(f"{k} {v / 1e9:.3f} GB"
                          for k, v in p["collectives"].items() if v)
        log(f"lm_launch production dry run {p['arch']} {p['shape']} on "
            f"{p['mesh']} ({p['n_chips']} fake ranks): trace "
            f"{p['compile_s']} s ({p['ops']} ops), per device "
            f"{p['cost']['flops'] / 1e12:.3f} TFLOP, "
            f"{p['cost']['bytes_accessed'] / 1e9:.1f} GB accessed, arguments "
            f"{p['memory']['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
            f"{p['memory']['temp_size_in_bytes'] / 1e9:.2f} GB; collectives "
            f"{colls}; roofline terms (data-sheet rates) compute "
            f"{p['roofline']['t_compute']:.4f} s, memory "
            f"{p['roofline']['t_memory']:.4f} s, collective "
            f"{p['roofline']['t_collective']:.4f} s, dominant "
            f"{p['roofline']['dominant']}")
        dec = p["decode"]
        g = rec["production_gates"] = production_gates(p)
        log(f"lm_launch production dry run {dec['arch']} {dec['shape']} on "
            f"{dec['mesh']}: trace {dec['compile_s']} s, per device "
            f"{dec['cost']['flops'] / 1e12:.4f} TFLOP, temp "
            f"{dec['memory']['temp_size_in_bytes'] / 1e9:.3f} GB, collectives "
            + ", ".join(f"{k} {v / 1e9:.3f} GB"
                        for k, v in dec["collectives"].items() if v))
        log(f"lm_launch partitioning gates: train temp {g['temp_gb']:.2f} GB "
            f"(<= {LM_LAUNCH_PROD_TEMP_GB}); largest all-gather "
            f"{g['largest_all_gather']} and all-reduce "
            f"{g['largest_all_reduce']} elements (< the logits slab "
            f"{g['logits_slab']}); decode's largest cache-shaped all-gather "
            f"{g['largest_cache_gather']} (< one layer's cache slice "
            f"{g['cache_slice']}); tied {LM_LAUNCH_TIED[0]} smoke, vocab "
            f"{LM_LAUNCH_TIED[1]}, on {LM_LAUNCH_TIED[2]}: trace "
            f"{p['tied']['compile_s']} s, largest all-gather "
            f"{g['tied_largest_all_gather']} elements (< its logits rows "
            f"{g['tied_rows']}); {LM_LAUNCH_MOE[0]} smoke "
            f"{LM_LAUNCH_MOE[1]} on {LM_LAUNCH_MOE[2]}: trace "
            f"{p['moe']['compile_s']} s, largest vocab-wide all-reduce or "
            f"all-gather {g['moe_largest']} elements (< a rank's logits "
            f"{g['moe_logits']}); {LM_LAUNCH_MOE_DECODE[0]} "
            f"{LM_LAUNCH_MOE_DECODE[1]} (full width): trace "
            f"{p['moe_decode']['compile_s']} s, wire "
            f"{g['moe_decode_wire_gb']:.4f} GB (<= {LM_LAUNCH_MOE_WIRE_GB}), "
            f"expert-weight all-gathers {g['moe_weight_gathers']} (none); "
            + "; ".join(
                f"{LM_LAUNCH_STATE[k][0]} {LM_LAUNCH_STATE[k][1]} (full "
                f"width): trace {p[k]['compile_s']} s, wire "
                f"{g[k]['wire_gb']:.5f} GB (<= {g[k]['bound_gb']:.5f}), "
                f"state/cache/table all-gathers {g[k]['gathers']} (none)"
                for k in LM_LAUNCH_STATE))
        check(g["temp_ok"], "lm_launch: train_4k temp over 2x JAX's",
              g["temp_gb"])
        check(g["vocab_ok"], "lm_launch: an all-gather or all-reduce of "
              "the logits",
              p["largest_collectives"])
        check(g["cache_ok"], "lm_launch: an all-gather of the cache",
              dec["largest_collectives"])
        check(g["tied_ok"], "lm_launch: the tied ragged-vocab cell",
              p["tied"]["largest_collectives"])
        check(g["moe_ok"], "lm_launch: a logits-sized collective in the "
              "MoE train cell", p["moe"]["largest_collectives"])
        check(g["moe_decode_ok"], "lm_launch: the MoE decode cell gathers "
              "expert weights or passes its wire bytes",
              g["moe_decode_wire_gb"], p["moe_decode"]["largest_collectives"])
        for key in LM_LAUNCH_STATE:
            check(g[key]["ok"], f"lm_launch: the {key} cell gathers a state, "
                  "a cache or a table, or passes its wire bytes", g[key],
                  p[key]["largest_collectives"])
        launched = counts()
        check(sum(launched.values()) == 0, "a kernel launched", launched)
        RESULT["lm_launch"] = rec


def kernels_line() -> dict:
    out = []
    for impl, key in (("cuda", "main_path_box2d1r"),
                      ("cuda_db", "main_path_gradient2d")):
        k, t = KERNELS[impl], RESULT["kernel_times"][impl]
        out.append({
            "name": k["name"], "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": RESULT[key]["double_buffered"]["launches"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    k, t = KERNELS["mxu"], RESULT["box2d4r_times"]["kernels"]["mxu"]
    out.append({
        "name": k["name"], "route": "cuda", "source": k["source"],
        "replaces": k["replaces"],
        "launches": RESULT["main_path_box2d4r"]["double_buffered"]["launches"],
        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=38400,
                    help="domain rows = columns (default: 38400)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    check(not torch.backends.cuda.matmul.allow_tf32,
          "fp32 matmuls must run in full precision for the plain versions")
    t_all = time.perf_counter()
    RAM.start()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    global TRACE
    TRACE = HostTrace(out_dir)
    try:
        phase_build()
        phase_kernels_vs_plain()
        phase_kernel_times(args.size)
        phase_box2d4r_times(args.size)
        phase_main_path("main_path_gradient2d", "gradient2d", args.size, 320,
                        "cuda_db", DispatchPolicy())
        phase_main_path("main_path_box2d1r", "box2d1r", args.size, 160,
                        "cuda", DispatchPolicy(impl="cuda"))
        phase_main_path("main_path_box2d4r", "box2d4r", args.size, 80, "mxu",
                        DispatchPolicy(impl="mxu"), k_off=40)
        prod = phase_lm_launch_trace()
        phase_recovery(args.size, out_dir)
        phase_calibrate_tune(args.size, out_dir)
        phase_service(args.size, out_dir)
        phase_sharded(args.size)
        phase_hierarchical(args.size)
        phase_elastic(args.size)
        phase_shard_map(args.size)
        phase_lm_serve()
        phase_lm_train(out_dir)
        phase_lm_launch(out_dir, prod)
    finally:
        TRACE.stop()
    RESULT["total_s"] = time.perf_counter() - t_all
    line = kernels_line()
    RESULT.update(line)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RESULT, f, indent=1, default=str)
    log(f"total {RESULT['total_s']:.1f} s, of it the kernels' build "
        f"{RESULT['build_s']:.1f} s; host RAM peak "
        f"{max(RESULT['host_ram_peak_gb'].values()):.1f} GB")
    box4 = RESULT["box2d4r_times"]["kernels"]
    for impl, name, rec in (
            ("cuda", "box2d1r", RESULT["kernel_times"]["cuda"]),
            ("cuda_db", "gradient2d", RESULT["kernel_times"]["cuda_db"]),
            ("cuda", "box2d4r", box4["cuda"]),
            ("cuda_db", "box2d4r", box4["cuda_db"]),
            ("mxu", "box2d4r", box4["mxu"])):
        sh = rec["launch_shape"]
        log(f"launch shape {KERNELS[impl]['name']} on {name} "
            f"{rec['band'][0]}x{rec['band'][1]}: {sh['threads']} threads and "
            f"{sh['smem_bytes']} B shared per CTA, {sh['ctas_per_sm']} CTAs "
            f"per SM, grid {sh['grid']}, tile {sh['tile'][0]}x{sh['tile'][1]}"
            + (f", load {sh['load']}" if "load" in sh else ""))
    print(json.dumps(line))
    print(RESULT["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
