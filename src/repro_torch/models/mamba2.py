"""Mamba-2 (SSD — state-space duality) blocks (the port of
``repro.models.mamba2``).

The SSD chunked scan is the direct structural analogue of the paper's
SO2DR: the sequence is split into chunks, an O(N·P) carried state plays
the role of the region-sharing buffer at chunk boundaries, and the
intra-chunk quadratic part is uninterrupted on-chip work — temporal
blocking along the sequence axis.

Shapes: x (B, S, H, P) heads×head_dim, B/C (B, S, N) state projections
(single group), dt (B, S, H), A (H,) negative decay.  The scan runs in
fp32; its four-operand contractions are split into pairwise ones (the
result, not the contraction order, is the spec).  ``softplus`` is
``logaddexp(x, 0)``, jax.nn.softplus exactly (``F.softplus`` would return
``x`` above its threshold of 20).

On DTensors with a "model" dim the in-projection and the conv run per
part (z, the SSM input, B and C, dt), each split over "model" its own
way, and the scan runs as a region over each rank's batch rows and
heads, as attention does, or, where the heads do not divide "model",
over its slice of the sequence, the slices' states handed on by an
all-gather (the chunked scan's own hand-off, one level up).  A decode
step is one region in the state's own placements: each rank steps its
heads (or head_dim entries) and conv channels, and only the step's few
rows move.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from .layers import (
    _head_placements, all_gather, all_reduce, all_to_all, column_chunk,
    constrain_acts, dense, dense_init, exchange_ranges, is_dtensor,
    length_dims, local_region, model_dim, move_shard, randn, rmsnorm,
    rmsnorm_init, rows_times_split_weight, split_heads,
)

__all__ = ["mamba_init", "mamba_apply", "mamba_init_state", "mamba_decode_step"]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) -> (..., Q, Q) with out[i, j] = sum_{k=j+1..i} a_k
    for i >= j, -inf otherwise (log-space decay matrix)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(Q, device=a.device)
    mask = i[:, None] >= i[None, :]
    return diff.masked_fill(~mask, -torch.inf)


def mamba_init(gen, cfg: ArchConfig, device=None):
    dev = resolve_device(device)
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.conv_width
    conv_dim = di + 2 * N
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "ln": rmsnorm_init(cfg.d_model, dev),
        "in_proj": dense_init(gen, cfg.d_model, 2 * di + 2 * N + H, device=dev),
        "conv_w": randn(gen, (w, conv_dim), dev) * (w ** -0.5),
        "conv_b": torch.zeros((conv_dim,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "A_log": torch.zeros((H,), **f32),  # A = -exp(A_log) = -1
        "D": torch.ones((H,), **f32),
        "gn": rmsnorm_init(di, dev),
        "out_proj": dense_init(gen, di, cfg.d_model, device=dev),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di: 2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]
    return z, xBC, dt


def _causal_conv(p, xBC: torch.Tensor, w: int) -> torch.Tensor:
    """Depthwise causal conv1d along S.  xBC: (B, S, C)."""
    if is_dtensor(xBC):
        return _sharded_conv(p, xBC, w)
    pad = F.pad(xBC, (0, 0, w - 1, 0))
    out = sum(
        pad[:, i: i + xBC.shape[1]] * p["conv_w"][i].to(xBC.dtype)
        for i in range(w)
    )
    return F.silu(out + p["conv_b"].to(xBC.dtype))


def _sharded_conv(p, xBC, w: int):
    """:func:`_causal_conv` on DTensors, one local conv per rank: batch
    rows over the data axes, channels over "model" where the conv's
    weights split them (DTensor's ``pad`` strategy fails on torch
    2.11)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = xBC.device_mesh
    x_pl, _, t, _ = _head_placements(mesh, xBC.shape[0], 1, 1)
    x_pl = list(x_pl)
    w_pl = [Replicate()] * mesh.ndim
    b_pl = [Replicate()] * mesh.ndim
    if t is not None and xBC.shape[-1] % mesh.size(t) == 0:
        x_pl[t], w_pl[t], b_pl[t] = Shard(2), Shard(1), Shard(0)

    def local(x, cw, cb):
        return _causal_conv({"conv_w": cw, "conv_b": cb}, x, w)

    return local_region(local, (xBC, p["conv_w"], p["conv_b"]),
                        (tuple(x_pl), tuple(w_pl), tuple(b_pl)),
                        (tuple(x_pl),), mesh)


def _model_split(x) -> bool:
    """Is ``x`` a DTensor on a mesh whose "model" dim has size > 1?"""
    if not is_dtensor(x):
        return False
    t = model_dim(x.device_mesh)
    return t is not None and x.device_mesh.size(t) > 1


def _column_blocks(w, widths):
    """The column blocks (last dim) of ``widths`` of the DTensor ``w``,
    each split over "model" where its width divides it: ``w``'s columns
    are gathered over "model" (a weight, not an activation), cut, and
    each block sharded again, so that an activation computed from a
    block is split the block's way, not ``w``'s."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = w.device_mesh
    t = model_dim(mesh)
    d = w.ndim - 1
    whole = w.redistribute(mesh, [Replicate() if q.is_shard(d) else q
                                  for q in w.placements])
    out, c0 = [], 0
    for n in widths:
        b = whole[..., c0:c0 + n]
        c0 += n
        if n % mesh.size(t) == 0:
            b = b.redistribute(mesh, [Shard(d) if i == t else q
                                      for i, q in enumerate(b.placements)])
        out.append(b)
    return out


def _whole_columns(w, x):
    """``x @ w`` on DTensors as one region whose output keeps all of its
    columns on every rank of "model" (the batch rows on their data
    shards, ``w`` gathered): for a block too narrow to split over
    "model", whose product DTensor may otherwise split there unevenly."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    x_pl, _, _, _ = _head_placements(mesh, x.shape[0], 1, 1)
    return local_region(lambda a, b: a @ b.to(a.dtype), (x, w),
                        (x_pl, (Replicate(),) * mesh.ndim), (x_pl,), mesh)


def _sharded_mixer_in(p, cfg: ArchConfig, x):
    """The in-projection and causal conv of :func:`mamba_apply` on a
    DTensor ``x`` with a "model" dim: one projection per part (z, the
    SSM input, B and C together, dt), each split over "model" its own
    way, so that no slice of a channel-sharded tensor is taken (DTensor
    gathers the whole tensor for each).  B and C, which every head
    reads, are gathered after their conv.  Returns (z, xs (B, S, H, P),
    B, C, dt, the raw conv inputs)."""
    from torch.distributed.tensor import Replicate, Shard

    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    wz, wx, wbc, wdt = _column_blocks(p["in_proj"], (di, di, 2 * N, H))
    z, xs_raw, bc_raw = (dense(w, x) for w in (wz, wx, wbc))
    n_t = x.device_mesh.size(model_dim(x.device_mesh))
    dt = dense(wdt, x) if H % n_t == 0 else _whole_columns(wdt, x)
    cw = _column_blocks(p["conv_w"], (di, 2 * N))
    cb = _column_blocks(p["conv_b"], (di, 2 * N))
    xs = _causal_conv({"conv_w": cw[0], "conv_b": cb[0]}, xs_raw,
                      cfg.conv_width)
    bc = _causal_conv({"conv_w": cw[1], "conv_b": cb[1]}, bc_raw,
                      cfg.conv_width)
    mesh = bc.device_mesh
    bc = bc.redistribute(mesh, [Replicate() if q.is_shard(2) else q
                                for q in bc.placements])
    t = model_dim(mesh)
    B, S = x.shape[:2]
    if H % mesh.size(t) and S % mesh.size(t) == 0:
        # heads that do not divide "model": the scan splits the sequence
        # (:func:`_seq_ssd`), so the SSM input leaves its channel split
        # for a sequence split (an all-to-all), not for a gather
        if xs.placements[t].is_shard(2):
            xs = move_shard(xs, t, 2, 1)
        else:
            xs = xs.redistribute(mesh, [Shard(1) if i == t else q
                                        for i, q in enumerate(xs.placements)])
        xs = xs.reshape(B, S, H, cfg.ssm_head_dim)
    else:
        xs = split_heads(xs, H)
    return z, xs, bc[..., :N], bc[..., N:], dt, (xs_raw, bc_raw)


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """SSD chunked scan.

    x: (B,S,H,P) raw inputs (dt applied here); dt: (B,S,H) softplus'd;
    A: (H,) negative; Bm/Cm: (B,S,N).
    Returns (y: (B,S,H,P) in x's dtype, final_state: (B,H,P,N) fp32).
    """
    if is_dtensor(x):
        return _sharded_ssd(x, dt, A, Bm, Cm, chunk, init_state)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))

    f32 = torch.float32
    xdt = (x * dt[..., None]).to(f32).reshape(Bsz, nc, Q, H, P)
    dA = (dt * A).to(f32).reshape(Bsz, nc, Q, H).movedim(3, 2)  # (B,nc,H,Q)
    Bc = Bm.to(f32).reshape(Bsz, nc, Q, N)
    Cc = Cm.to(f32).reshape(Bsz, nc, Q, N)

    L = torch.exp(_segsum(dA))                               # (B,nc,H,Q,Q)
    # intra-chunk (the "on-chip" quadratic part)
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", CB[:, :, None] * L, xdt)

    dA_cum = torch.cumsum(dA, dim=-1)                        # (B,nc,H,Q)
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)      # (B,nc,H,Q)
    xdt_dec = xdt * decay_states.movedim(2, 3)[..., None]    # (B,nc,Q,H,P)
    chunk_states = torch.einsum("bckn,bckhp->bchpn", Bc, xdt_dec)

    # inter-chunk recurrence (the "region-sharing" state hand-off)
    chunk_decay = torch.exp(dA_cum[..., -1])                 # (B,nc,H)
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(h)  # the state *entering* chunk c
        h = h * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev = torch.stack(prev, dim=1)                          # (B,nc,H,P,N)

    out_decay = torch.exp(dA_cum)                            # (B,nc,H,Q)
    y_off = (torch.einsum("bcqn,bchpn->bcqhp", Cc, prev)
             * out_decay.movedim(2, 3)[..., None])

    y = (y_diag + y_off).reshape(Bsz, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), h


def _sharded_ssd(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """:func:`_ssd_chunked` on DTensors, one local scan per rank: batch
    rows over the data axes, heads over "model" where they divide it
    (B and C, shared by the heads, whole on every rank)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    x_pl, _, t, _ = _head_placements(mesh, x.shape[0], x.shape[2],
                                     x.shape[2])
    if _seq_split(x, mesh, t):
        return _seq_ssd(x, dt, A, Bm, Cm, chunk, init_state, mesh, t, x_pl)

    def moved(dim):   # x's placements with its head shard on ``dim``
        return tuple(Shard(dim) if i == t and q.is_shard(2) else q
                     for i, q in enumerate(x_pl))

    bc_pl = tuple(Replicate() if i == t else q for i, q in enumerate(x_pl))
    a_pl = tuple(Shard(0) if i == t and q.is_shard(2) else Replicate()
                 for i, q in enumerate(x_pl))
    h_pl = moved(1)
    args = (x, dt, A, Bm, Cm, init_state)
    in_pl = (x_pl, x_pl, a_pl, bc_pl, bc_pl,
             h_pl if is_dtensor(init_state) else None)
    return local_region(
        lambda *a: _ssd_chunked(*a[:5], chunk, a[5]), args, in_pl,
        (x_pl, h_pl), mesh)


def _model_like(y, z):
    """``y`` redistributed over "model" as ``z`` is split there (other
    mesh dims as they are), where ``z`` is split there: a sequence split
    moved to the channels by an explicit all-to-all."""
    mesh = y.device_mesh
    t = model_dim(mesh)
    q = None if t is None else z.placements[t]
    if q is None or not q.is_shard() or y.placements[t] == q:
        return y
    if y.placements[t].is_shard():
        return move_shard(y, t, y.placements[t].dim, q.dim)
    return y.redistribute(mesh, [q if i == t else p_
                                 for i, p_ in enumerate(y.placements)])


def _sharded_gated_norm(g, y, z):
    """``rmsnorm(g, y · silu(z))`` on DTensors as one region: batch rows
    over the data axes, channels over "model" where ``z`` splits them
    there, each rank's sum of squares summed over "model".  Left to
    DTensor, its backward may move the channel split to the batch (a
    redistribution whose collective DTensor picks)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = y.device_mesh
    x_pl, _, t, _ = _head_placements(mesh, y.shape[0], 1, 1)
    x_pl, g_pl = list(x_pl), [Replicate()] * mesh.ndim
    dims = []
    if t is not None and z.placements[t].is_shard(2):
        x_pl[t], g_pl[t], dims = Shard(2), Shard(0), [t]
    di = y.shape[-1]

    def local(yl, zl, gl):
        v = yl * F.silu(zl)
        if not dims:
            return rmsnorm(gl, v)
        return _split_rmsnorm(gl, v, di, mesh, dims)

    return local_region(local, (y, z, g), (tuple(x_pl),) * 2 + (tuple(g_pl),),
                        (tuple(x_pl),), mesh)


def _split_rmsnorm(gl, v, di: int, mesh, dims, eps: float = 1e-6):
    """Inside a region: ``rmsnorm`` of ``v``, whose ``di`` channels are
    split over the mesh ``dims`` (``gl`` the rank's gains): each rank's
    sum of squares summed over them."""
    ss = all_reduce(v.float().square().sum(dim=-1, keepdim=True), "sum",
                    mesh, dims)
    return (v * torch.rsqrt(ss / di + eps).to(v.dtype)) * gl.to(v.dtype)


def _seq_split(x, mesh, t) -> bool:
    """Does the (B, S, H, P) DTensor ``x`` scan sequence-parallel over the
    mesh dim ``t``: its heads do not divide it, its length does?"""
    n = 1 if t is None else mesh.size(t)
    return n > 1 and x.shape[2] % n != 0 and x.shape[1] % n == 0


def _seq_ssd(x, dt, A, Bm, Cm, chunk: int, init_state, mesh, t, x_pl):
    """:func:`_ssd_chunked` split along the sequence over the mesh dim
    ``t`` (heads that do not divide it): each rank scans its slice of the
    positions from a zero state, the slices' final states and total
    decays are all-gathered, and each rank adds the decayed contribution
    of the state that enters its slice (the chunked scan's own hand-off,
    one level up).  Returns y split along the sequence and the final
    state on every rank."""
    from torch.distributed.tensor import Replicate, Shard

    s_pl = tuple(Shard(1) if i == t else q for i, q in enumerate(x_pl))
    rep = (Replicate(),) * mesh.ndim

    def local(xl, dtl, al, bl, cl, h0):
        j, n = mesh.get_local_rank(t), mesh.size(t)
        y, h = _ssd_chunked(xl, dtl, al, bl, cl, chunk)
        cs = torch.cumsum((dtl * al).float(), dim=1)            # (B,Sl,H)
        hs = all_gather(h[None], 0, mesh, [t])                  # (n,B,H,P,N)
        ds = all_gather(torch.exp(cs[None, :, -1]), 0, mesh, [t])
        h_in = torch.zeros_like(h) if h0 is None else h0.float()
        entering, h_out = h_in, h_in
        for i in range(n):
            # every slice's terms enter every rank's graph (with weight 0
            # from slice j on), so every rank runs the gathers' backward
            w = float(i < j)
            entering = (entering * (ds[i] * w + (1 - w))[..., None, None]
                        + hs[i] * w)
            h_out = h_out * ds[i][..., None, None] + hs[i]
        off = torch.einsum("bsn,bhpn->bshp", cl.float(), entering)
        return (y + (off * torch.exp(cs)[..., None]).to(y.dtype)), h_out

    h_pl = tuple(q if q.is_shard() else Replicate() for q in x_pl)
    args = (x, dt, A, Bm, Cm, init_state)
    in_pl = (s_pl, s_pl, rep, s_pl, s_pl,
             h_pl if is_dtensor(init_state) else None)
    return local_region(local, args, in_pl, (s_pl, h_pl), mesh)


def mamba_apply(
    p,
    cfg: ArchConfig,
    u: torch.Tensor,                       # (B, S, D)
    init_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Full-sequence Mamba-2 block (training / prefill)."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    B, S, D = u.shape
    res = u
    x = rmsnorm(p["ln"], u)
    if _model_split(x):
        z, xs, Bm, Cm, dt, raw = _sharded_mixer_in(p, cfg, x)
    else:
        z, xBC_raw, dt = _split_proj(cfg, dense(p["in_proj"], x))
        xBC = _causal_conv(p, xBC_raw, cfg.conv_width)
        xs = xBC[..., :di].reshape(B, S, H, P)
        Bm = xBC[..., di: di + N]
        Cm = xBC[..., di + N:]
        raw = (xBC_raw,)
    del x   # the norm output, read by the projections
    dt = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, hT = _ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk, init_state)
    y = y + xs * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    if is_dtensor(y):
        y = _model_like(y, z)          # a sequence split back to channels
        y = _sharded_gated_norm(p["gn"], y, z)
    else:
        y = rmsnorm(p["gn"], y * F.silu(z))
    out = constrain_acts(res + dense(p["out_proj"], y))
    if return_state:
        # conv history for decode continuity: last (w-1) raw conv inputs
        w = cfg.conv_width
        tail = [r[:, -(w - 1):] for r in raw]
        tail = (tail[0] if len(tail) == 1
                else torch.cat(tail, dim=-1)).to(torch.bfloat16)
        pad = (w - 1) - tail.shape[1]
        if pad > 0:
            tail = F.pad(tail, (0, 0, pad, 0))
        return out, {"ssm": hT, "conv": tail}
    return out, None


def mamba_init_state(cfg: ArchConfig, batch: int, device=None):
    dev = resolve_device(device)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * N
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=torch.bfloat16, device=dev),
    }


def mamba_decode_step(p, cfg: ArchConfig, u: torch.Tensor, state):
    """One-token recurrent step.  u: (B, 1, D) -> (B, 1, D), new state."""
    res = u
    x = rmsnorm(p["ln"], u)
    if is_dtensor(x):
        y, state = _sharded_decode_core(p, cfg, x, state)
        return res + y, state
    z, xBC, dt = _split_proj(cfg, dense(p["in_proj"], x))  # (B,1,*)
    y, state = _decode_core(p, cfg, z, xBC, dt, state)
    out = res + dense(p["out_proj"], y)
    return out, state


def _conv_step(p, xBC, conv):
    """The causal conv's one new position: (silu'd output (B, C) in
    fp32, new conv history)."""
    hist = torch.cat([conv, xBC.to(conv.dtype)], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", hist.float(), p["conv_w"])
    return F.silu(conv_out + p["conv_b"]), hist[:, 1:]


def _ssm_step(p, xs, Bm, Cm, dt, ssm):
    """The SSM recurrence's one step: xs (B, H, P), B/C (B, N) fp32, dt
    (B, H) raw, the state (B, H, P, N) -> (y (B, H, P) in xs's dtype,
    new state); ``p``'s dt_bias, A_log and D are the heads'."""
    dtv = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dtv * A)                                   # (B,H)
    xdt = xs.float() * dtv[..., None]                         # (B,H,P)
    h = ssm * dA[..., None, None] + xdt[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, Cm).to(xs.dtype)
    return y + xs * p["D"].to(y.dtype)[None, :, None], h


def _decode_core(p, cfg: ArchConfig, z, xBC, dt, state):
    """The recurrent step between the two projections: (y (B, 1, di),
    new state)."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    B = xBC.shape[0]
    # conv cache: last (w-1) inputs
    conv_out, new_conv = _conv_step(p, xBC, state["conv"])
    xBC1 = conv_out.to(z.dtype)                               # (B,C)
    y, h = _ssm_step(p, xBC1[:, :di].reshape(B, H, P),
                     xBC1[:, di: di + N].float(), xBC1[:, di + N:].float(),
                     dt.reshape(B, H), state["ssm"])
    y = rmsnorm(p["gn"], y.reshape(B, 1, di) * F.silu(z))
    return y, {"ssm": h, "conv": new_conv}


def _sharded_decode_core(p, cfg: ArchConfig, x, state):
    """:func:`mamba_decode_step` after its norm, on DTensors, as one
    region from the in-projection to the out-projection that takes the
    state's placements as they are: the batch rows over the data axes
    where they divide them, the SSM state's heads over "model" (or its
    head_dim, where the heads do not divide "model"), the conv state's
    channels over "model".  No state is gathered.  Each rank steps the
    conv on its channels and the SSM on its heads (or head_dim entries);
    the few rows' activations move instead, by all-to-alls that bring
    each rank only the in-projection columns and conv outputs it reads.
    The projections move the rows to the weights' FSDP split over
    "data" (:func:`rows_times_split_weight`), each rank of "model"
    computing a chunk of the in-projection's columns.  Where the heads
    split, each rank keeps its heads' output for its rows of the
    out-projection and the gated norm sums its squares over "model";
    else the output (one token a row) is gathered over "model".
    Returns (the block's output before the residual, (B, 1, D) placed as
    the batch rows are; the new state)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    C, n_cols = di + 2 * N, 2 * di + 2 * N + H
    names = list(mesh.mesh_dim_names or ())
    dp = [i for i, a in enumerate(names) if a in ("pod", "data")]
    split = bool(dp) and x.shape[0] % math.prod(mesh.size(i)
                                                 for i in dp) == 0
    x_pl = tuple(Shard(0) if split and i in dp else Replicate()
                 for i in range(mesh.ndim))
    w_in, w_out = p["in_proj"], p["out_proj"]

    def one(t, dim):
        dims = length_dims(t, dim)
        if len(dims) > 1:
            raise ValueError(f"a Mamba-2 decode operand split over mesh "
                             f"dims {dims}")
        return dims[0] if dims else None

    f_in, t_in = one(w_in, 0), one(w_in, 1)
    f_out, t_out = one(w_out, 1), one(w_out, 0)
    t_conv = one(state["conv"], 2)
    t_h, t_p = one(state["ssm"], 1), one(state["ssm"], 2)
    t = model_dim(mesh)
    t_cols = t_in if t_in is not None else (
        t if t is not None and mesh.size(t) > 1 else None)
    keys = ("dt_bias", "A_log", "D", "gn")

    def mine(n, md):
        return column_chunk(n, mesh, md)[:2]

    def reads(r):
        return _decode_reads(r, cfg, mesh, t_h, t_conv)

    def local(xl, wi, wo, cw, cb, conv, ssm, *small):
        sp = dict(zip(keys, small))
        Bl = xl.shape[0]
        h0, h1 = mine(H, t_h)
        q0, q1 = mine(P, t_p)
        c0, c1 = mine(C, t_conv)
        want, conv_want = reads(None)
        zs = want[0]
        if t_in is None and t_cols is not None:
            wi = wi[:, slice(*mine(n_cols, t_cols))]
        cols = rows_times_split_weight(xl, wi, mesh, f_in,
                                       split and f_in in dp)
        if t_cols is not None:
            cols = exchange_ranges(
                cols, 2, lambda r: column_chunk(n_cols, mesh, t_cols, r)[:2],
                lambda r: reads(r)[0], mesh, t_cols)
        else:
            cols = torch.cat([cols[..., a:b] for a, b in want], dim=-1)
        nz = zs[1] - zs[0]
        z, xr, dt = cols[..., :nz], cols[..., nz:nz + c1 - c0], cols[
            ..., nz + c1 - c0:]
        conv_out, new_conv = _conv_step({"conv_w": cw, "conv_b": cb}, xr,
                                        conv)
        conv_out = conv_out.to(z.dtype)
        if t_conv is not None:
            xbc = exchange_ranges(conv_out, 1,
                                  lambda r: column_chunk(C, mesh, t_conv, r)[:2],
                                  lambda r: reads(r)[1], mesh, t_conv)
        else:
            xbc = torch.cat([conv_out[:, a:b] for a, b in conv_want], -1)
        nx = (h1 - h0) * P
        xs = xbc[:, :nx].reshape(Bl, h1 - h0, P)[:, :, q0:q1]
        sp = {k: v[h0:h1] if k != "gn" else v for k, v in sp.items()}
        y, h = _ssm_step(sp, xs, xbc[:, nx:nx + N].float(),
                         xbc[:, nx + N:].float(), dt.reshape(Bl, h1 - h0),
                         ssm)
        if t_h is not None:
            # this rank's heads: its channels' share of the norm's sum
            y = _split_rmsnorm(sp["gn"][zs[0]:zs[1]],
                               y.reshape(Bl, 1, nx) * F.silu(z), di, mesh,
                               [t_h])
            rows, t_rows = zs, t_h
        else:
            y = all_gather(y, 2, mesh, [] if t_p is None else [t_p])
            y = rmsnorm(sp["gn"], y.reshape(Bl, 1, di) * F.silu(z))
            rows, t_rows = mine(di, t_out), t_out
        r0, _ = mine(di, t_out)
        wo = wo[rows[0] - r0:rows[1] - r0]
        y = y[..., rows[0] - zs[0]:rows[1] - zs[0]]
        red = [] if t_rows is None else [t_rows]
        wo = wo.to(y.dtype)
        if split and f_out in dp:
            # every rank's rows to this rank's columns, and back
            out = all_to_all(all_gather(y, 0, mesh, [f_out]) @ wo, 0, 2,
                             mesh, f_out)
            return all_reduce(out, "sum", mesh, red), new_conv, h
        out = all_reduce(y @ wo, "sum", mesh, red)
        return (all_gather(out, 2, mesh, [] if f_out is None else [f_out]),
                new_conv, h)

    rep = (Replicate(),) * mesh.ndim
    # the conv's weights split as the conv state's channels are
    cw_pl = tuple(Shard(1) if i == t_conv else Replicate()
                  for i in range(mesh.ndim))
    cb_pl = tuple(Shard(0) if i == t_conv else Replicate()
                  for i in range(mesh.ndim))
    args = (x, w_in, w_out, p["conv_w"], p["conv_b"], state["conv"],
            state["ssm"], *(p[k] for k in keys))
    in_pl = (x_pl, w_in.placements, w_out.placements, cw_pl, cb_pl,
             state["conv"].placements, state["ssm"].placements)
    y, conv, ssm = local_region(
        local, args, in_pl + (rep,) * len(keys),
        (x_pl, state["conv"].placements, state["ssm"].placements), mesh)
    return y, {"ssm": ssm, "conv": conv}


def _decode_reads(r, cfg: ArchConfig, mesh, t_h, t_conv):
    """What rank ``r`` of "model" reads in :func:`_sharded_decode_core`:
    the in-projection's columns (z of its heads, all of z where the heads
    are not split; its conv channels' inputs; its heads' dt) and the
    conv's outputs (its heads' SSM inputs; B and C, which every head
    reads), as sorted index ranges."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    h0, h1, _ = column_chunk(H, mesh, t_h, r)
    c0, c1, _ = column_chunk(di + 2 * N, mesh, t_conv, r)
    zs = (h0 * P, h1 * P) if t_h is not None else (0, di)
    dt0 = 2 * di + 2 * N
    return ([zs, (di + c0, di + c1), (dt0 + h0, dt0 + h1)],
            [(h0 * P, h1 * P), (di, di + 2 * N)])
