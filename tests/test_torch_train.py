"""The port's training path on the CPU: AdamW, ``compress_grads``,
``SyntheticLM``, the Trainer and the train CLI, against the JAX package.

* AdamW: one update vs JAX on a random tree, fp32 and bf16 moments,
  clipping on and off, within 1e-6 relative; the schedule over steps
  0–200 likewise.  Both compute the same fp32 operations, each rounded
  once, so they differ by roundoff only.
* ``compress_grads`` (bf16, int8, with residuals) and ``SyntheticLM``
  (seeds, steps, host shards): bitwise equal to JAX.
* The JAX package's own training tests run on the port
  (``tests/test_data.py``, ``tests/test_train_loop.py``,
  ``tests/test_checkpoint.py::test_bitwise_resume``,
  ``tests/test_system.py::test_tiny_lm_end_to_end``).
* One Trainer step of mixtral's smoke model in fp32 from JAX's weights vs
  the JAX ``Trainer._step_fn``, with int8 grads and without: loss within
  1e-5, params within 3e-3 absolute (the JAX microbatch test's bound),
  and Adam's moments, which carry the step's grads, within 1e-5 of each
  leaf's max.
* ``donate=True`` and ``donate=False`` give the same bits; the train CLI
  runs on the CPU; with no card the Trainer refuses rather than running
  on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_case import make_batches, models
from repro.data import DataSpec as JDataSpec, SyntheticLM as JSyntheticLM
from repro.launch.train import add_modality_stub as jax_add_modality_stub
from repro.optim import AdamW as JAdamW
from repro.train import (TrainConfig as JTrainConfig, Trainer as JTrainer,
                         compress_grads as jax_compress_grads)
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataSpec, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim import AdamW, OptState
from repro_torch.serve import greedy_generate
from repro_torch.train import TrainConfig, Trainer, compress_grads

CPU = "cpu"


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _leaves(*trees):
    return [x for t in trees for x in tree_leaves(t)]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


def _random_tree(rng):
    return {"w": rng.standard_normal((16, 24)).astype(np.float32),
            "blocks": {"a": rng.standard_normal((3, 8, 8)).astype(np.float32),
                       "g": (1 + 0.1 * rng.standard_normal(8)).astype(
                           np.float32)},
            "b": rng.standard_normal(5).astype(np.float32)}


# ------------------------------------------------------------------ AdamW

@pytest.mark.parametrize("moments", ["fp32", "bf16"])
@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_adamw_update_matches_jax(moments, clip_norm):
    rng = np.random.default_rng(5)
    p, g, m, v = (_random_tree(rng) for _ in range(4))
    v = tree_map(np.abs, v)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=50, clip_norm=clip_norm)
    jopt = JAdamW(moment_dtype=jnp.bfloat16 if moments == "bf16"
                  else jnp.float32, **kw)
    topt = AdamW(moment_dtype=torch.bfloat16 if moments == "bf16"
                 else torch.float32, **kw)
    # state at step 4 with non-zero moments (stored in the moment dtype)
    jst = jopt.init(jax.tree.map(jnp.asarray, p))
    jst = jst._replace(step=jnp.int32(4),
                       mu=jax.tree.map(lambda a: jnp.asarray(a).astype(
                           jopt.moment_dtype), m),
                       nu=jax.tree.map(lambda a: jnp.asarray(a).astype(
                           jopt.moment_dtype), v))
    tst = topt.init(params_from_numpy(p, CPU))
    assert tst.step.dtype == torch.int32 and tst.step.shape == ()
    tst = OptState(step=torch.tensor(4, dtype=torch.int32),
                   mu=tree_map(lambda a: torch.from_numpy(a).to(
                       topt.moment_dtype), m),
                   nu=tree_map(lambda a: torch.from_numpy(a).to(
                       topt.moment_dtype), v))
    jp, jst = jopt.update(jax.tree.map(jnp.asarray, g), jst,
                          jax.tree.map(jnp.asarray, p))
    tp, tst = topt.update(params_from_numpy(g, CPU), tst,
                          params_from_numpy(p, CPU))
    assert int(tst.step) == int(jst.step) == 5
    for tree_t, tree_j in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu)):
        for a, b in zip(tree_leaves(tree_t), jax.tree.leaves(tree_j)):
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)


def test_adamw_schedule_matches_jax():
    for kw in (dict(warmup_steps=10, total_steps=150),
               dict(warmup_steps=0, total_steps=200),
               dict(warmup_steps=1, total_steps=20)):
        jopt, topt = JAdamW(lr=3e-4, **kw), AdamW(lr=3e-4, **kw)
        steps = np.arange(201, dtype=np.int32)
        got = topt.schedule(torch.from_numpy(steps)).numpy()
        ref = np.asarray(jopt.schedule(jnp.asarray(steps)))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_adamw_inplace_update_is_the_same_bits():
    rng = np.random.default_rng(6)
    p, g = _random_tree(rng), _random_tree(rng)
    opt = AdamW(lr=1e-2, warmup_steps=1, moment_dtype=torch.bfloat16)
    params = params_from_numpy(p, CPU)
    st = opt.init(params)
    new_p, new_st = opt.update(params_from_numpy(g, CPU), st, params)
    ptrs = [t.data_ptr() for t in tree_leaves(params)]
    ip, ist = opt.update(params_from_numpy(g, CPU), st, params, inplace=True)
    assert [t.data_ptr() for t in tree_leaves(ip)] == ptrs
    assert ist.step is st.step and int(st.step) == 1
    for a, b in zip(_leaves(new_p, new_st.mu, new_st.nu),
                    _leaves(ip, ist.mu, ist.nu)):
        assert torch.equal(a, b)


# ---------------------------------------------------------- compress_grads

@pytest.mark.parametrize("mode", ["bf16", "int8", "none"])
def test_compress_grads_matches_jax_bitwise(mode):
    rng = np.random.default_rng(7)
    g = {"w": (rng.standard_normal((64, 48)) * 1e-3).astype(np.float32),
         "b": {"c": rng.standard_normal(33).astype(np.float32)}}
    jr = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), g)
    tr = tree_map(lambda a: torch.zeros(a.shape), g)
    for _ in range(5):
        jq, jr = jax_compress_grads(jax.tree.map(jnp.asarray, g), jr, mode)
        tq, tr = compress_grads(params_from_numpy(g, CPU), tr, mode)
        for a, b in zip(tree_leaves(tq) + tree_leaves(tr),
                        jax.tree.leaves(jq) + jax.tree.leaves(jr)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        compress_grads(tq, tr, "fp8")


# ------------------------------------------------------------- SyntheticLM

@pytest.mark.parametrize("seed,n_hosts", [(0, 1), (7, 2), (123, 4)])
def test_synthetic_lm_is_bitwise_jax(seed, n_hosts):
    for host in range(n_hosts):
        kw = dict(vocab=1000, seq_len=24, global_batch=8, seed=seed,
                  n_hosts=n_hosts, host_id=host)
        t, j = SyntheticLM(DataSpec(**kw)), JSyntheticLM(JDataSpec(**kw))
        assert DataSpec(**kw).host_batch == JDataSpec(**kw).host_batch
        for step in (0, 1, 17, 999):
            tb, jb = t.batch(step), j.batch(step)
            assert sorted(tb) == sorted(jb)
            for k in tb:
                assert tb[k].dtype == jb[k].dtype == np.int32
                np.testing.assert_array_equal(tb[k], jb[k])


def test_modality_stubs_are_jax_s():
    for arch in ("llama-3.2-vision-90b", "whisper-tiny"):
        cfg = get_smoke_config(arch)
        tb = train_cli.add_modality_stub({"tokens": np.zeros((2, 4))}, cfg, 3)
        jb = jax_add_modality_stub({"tokens": np.zeros((2, 4))}, cfg, 3)
        key = "images" if cfg.family == "vlm" else "frames"
        assert tb[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tb[key].float().numpy(), np.asarray(jb[key].astype(jnp.float32)))


# port of tests/test_data.py

def test_deterministic_by_step():
    d1 = SyntheticLM(DataSpec(vocab=100, seq_len=16, global_batch=4, seed=7))
    d2 = SyntheticLM(DataSpec(vocab=100, seq_len=16, global_batch=4, seed=7))
    b1, b2 = d1.batch(42), d2.batch(42)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(d1.batch(42)["tokens"], d1.batch(43)["tokens"])


def test_labels_are_shifted_tokens():
    d = SyntheticLM(DataSpec(vocab=100, seq_len=16, global_batch=2))
    b = d.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_sharding_partitions_global_batch():
    full = SyntheticLM(DataSpec(vocab=50, seq_len=8, global_batch=4, n_hosts=1))
    h0 = SyntheticLM(DataSpec(vocab=50, seq_len=8, global_batch=4, n_hosts=2,
                              host_id=0))
    h1 = SyntheticLM(DataSpec(vocab=50, seq_len=8, global_batch=4, n_hosts=2,
                              host_id=1))
    assert h0.batch(3)["tokens"].shape == (2, 8)
    assert not np.array_equal(h0.batch(3)["tokens"], h1.batch(3)["tokens"])
    assert full.batch(3)["tokens"].shape == (4, 8)


def test_prefetch_iterator_matches_batch():
    d = SyntheticLM(DataSpec(vocab=60, seq_len=8, global_batch=2), prefetch=2)
    it = d.iterate(start_step=5)
    got = next(it)
    np.testing.assert_array_equal(got["tokens"], d.batch(5)["tokens"])
    it.close()


def test_learnable_structure():
    d = SyntheticLM(DataSpec(vocab=1000, seq_len=512, global_batch=2))
    t = d.batch(0)["tokens"]
    assert (t[:, 4:] == t[:, :-4]).mean() > 0.15


# ------------------------------------------- port of tests/test_train_loop.py

def test_loss_decreases():
    cfg = get_smoke_config("qwen3-0.6b")
    model = build_model(cfg)
    data = SyntheticLM(DataSpec(vocab=cfg.vocab, seq_len=32, global_batch=4))
    opt = AdamW(lr=3e-3, warmup_steps=2, total_steps=30)
    tr = Trainer(model, opt, TrainConfig(steps=30, log_every=1000), device=CPU)
    _, _, losses = tr.run(_gen(), data)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, \
        losses[:3] + losses[-3:]


def test_microbatch_equivalence():
    """4-way grad accumulation == single big batch (same data, fp32-close)."""
    cfg = get_smoke_config("mamba2-130m")
    model = build_model(cfg)
    data = SyntheticLM(DataSpec(vocab=cfg.vocab, seq_len=16, global_batch=8))
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=2, clip_norm=None)

    def one(microbatches):
        tr = Trainer(model, opt, TrainConfig(steps=1, microbatches=microbatches,
                                             log_every=1000), donate=False,
                     device=CPU)
        p, _, _ = tr.run(_gen(), data)
        return p

    p1, p4 = one(1), one(4)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.double().numpy(), b.double().numpy(),
                                   rtol=0, atol=3e-3)


def test_microbatch_grads_are_the_whole_batch_grads(monkeypatch):
    """What a step applies: 4 microbatches' grads, summed and divided by
    4, within 1e-5 of each leaf's max of the whole batch's, in fp32 (the
    embedding's bf16 cast swapped out)."""
    import repro_torch.models.api as torch_api

    monkeypatch.setattr(torch_api, "_embed_tokens",
                        lambda p, tokens: p["embed"][tokens])
    cfg = get_smoke_config("mamba2-130m")
    model = build_model(cfg)
    data = SyntheticLM(DataSpec(vocab=cfg.vocab, seq_len=16, global_batch=8))
    batch = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    params = model.init_params(_gen(), device=CPU)
    out = {m: Trainer(model, AdamW(), TrainConfig(microbatches=m),
                      device=CPU).grads(params, batch) for m in (1, 4)}
    assert abs(float(out[4][0]) - float(out[1][0])) <= 1e-6 * float(out[1][0])
    for a, b in zip(tree_leaves(out[4][1]), tree_leaves(out[1][1])):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_grad_compression_error_feedback():
    g = {"w": torch.from_numpy((np.random.default_rng(0).standard_normal(
        (64, 64)) * 1e-3).astype(np.float32))}
    r = {"w": torch.zeros((64, 64))}
    total_sent = torch.zeros((64, 64))
    for _ in range(20):
        q, r = compress_grads(g, r, "int8")
        total_sent = total_sent + q["w"]
    expect = 20 * g["w"]
    err = float((total_sent - expect).abs().max()) / float(expect.abs().max())
    assert err < 0.05


def test_grad_compression_training_still_converges():
    cfg = get_smoke_config("qwen3-0.6b")
    model = build_model(cfg)
    data = SyntheticLM(DataSpec(vocab=cfg.vocab, seq_len=32, global_batch=4))
    opt = AdamW(lr=3e-3, warmup_steps=2, total_steps=20)
    tr = Trainer(model, opt, TrainConfig(steps=20, log_every=1000,
                                         grad_compression="bf16"), device=CPU)
    _, _, losses = tr.run(_gen(), data)
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_adamw_matches_reference_step():
    opt = AdamW(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                clip_norm=None, warmup_steps=0, total_steps=10**9)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.25])}
    st = opt.init(p)
    p1, st1 = opt.update(g, st, p)
    m = 0.1 * g["w"].numpy()
    v = 0.01 * g["w"].numpy() ** 2
    mhat = m / (1 - 0.9)
    vhat = v / (1 - 0.99)
    lr1 = float(opt.schedule(torch.tensor(1)))
    expect = p["w"].numpy() - lr1 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(p1["w"].numpy(), expect, rtol=1e-5)


def test_straggler_watchdog_records():
    tr = Trainer.__new__(Trainer)
    tr.straggler_events = []
    assert tr.straggler_events == []


# ---------------------- port of tests/test_checkpoint.py::test_bitwise_resume

def test_bitwise_resume(tmp_path):
    """Train 6 steps; train 3 + restart + 3: identical final params."""
    cfg = get_smoke_config("qwen3-0.6b")
    model = build_model(cfg)
    data = SyntheticLM(DataSpec(vocab=cfg.vocab, seq_len=16, global_batch=2))
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=6,
                moment_dtype=torch.bfloat16)

    def train(ckpt_dir, steps, resume):
        tc = TrainConfig(steps=steps, ckpt_every=3, ckpt_dir=ckpt_dir,
                         log_every=100)
        tr = Trainer(model, opt, tc, donate=False, device=CPU)
        params, st, losses = tr.run(_gen(), data, resume=resume)
        return params, st, losses

    p_full, st_full, l_full = train(str(tmp_path / "a"), 6, False)
    train(str(tmp_path / "b"), 3, False)              # writes step_2 ckpt
    p_res, st_res, l_res = train(str(tmp_path / "b"), 6, True)  # resumes at 3
    assert len(l_res) == 3 and l_res == l_full[3:]
    assert int(st_res.step) == int(st_full.step) == 6
    for a, b in zip(_leaves(p_full, st_full.mu, st_full.nu),
                    _leaves(p_res, st_res.mu, st_res.nu)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------- port of tests/test_system.py::test_tiny_lm_end_to_end

def test_tiny_lm_end_to_end():
    """Train a tiny LM for 12 steps, then serve 4 tokens greedily."""
    cfg = get_smoke_config("mamba2-130m")
    model = build_model(cfg)
    data = SyntheticLM(DataSpec(vocab=cfg.vocab, seq_len=32, global_batch=2))
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=12)
    tr = Trainer(model, opt, TrainConfig(steps=12, log_every=1000), device=CPU)
    params, _, losses = tr.run(_gen(), data)
    assert np.isfinite(losses).all()
    batch = {k: torch.from_numpy(v) for k, v in data.batch(99).items()}
    toks = greedy_generate(model, params, batch, max_new=4, max_len=40)
    assert toks.shape == (2, 4)
    assert bool(((toks >= 0) & (toks < cfg.vocab)).all())


# ------------------------------------------------------- one step vs JAX

def _fp32_step_vs_jax(monkeypatch, grad_compression, **opt):
    """One Trainer step of mixtral's smoke model (MoE, aux loss) in fp32
    (the embedding's bf16 cast swapped out in both packages), 2
    microbatches, from JAX's weights: the port's and ``_step_fn``'s
    (params, state, residual, loss)."""
    import repro.models.api as jax_api
    import repro_torch.models.api as torch_api

    def fp32_embed(p, tokens):
        return p["embed"][tokens]

    monkeypatch.setattr(jax_api, "_embed_tokens", fp32_embed)
    monkeypatch.setattr(torch_api, "_embed_tokens", fp32_embed)
    jm, jp, tm, tp = models("mixtral-8x7b")
    jb, tb = make_batches(jm.cfg, B=4)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=4, **opt)
    tc = dict(steps=1, microbatches=2, grad_compression=grad_compression)
    jtr = JTrainer(jm, JAdamW(**kw), JTrainConfig(**tc), donate=False)
    ttr = Trainer(tm, AdamW(**kw), TrainConfig(**tc), device=CPU)
    jres = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
    tres = tree_map(lambda p: torch.zeros(p.shape), tp)
    jout = jtr._step_fn(jp, jtr.opt.init(jp), jres, jb)
    tout = ttr.step(tp, ttr.opt.init(tp), tres, tb)
    assert int(tout[1].step) == int(jout[1].step) == 1
    assert abs(float(tout[3]) - float(jout[3])) <= 1e-5 * abs(float(jout[3]))
    return tout, jout


def _hold_moments(tst, jst, int8_ties=False):
    """After one step ``mu = (1 - b1)·g`` and ``nu = (1 - b2)·g²`` of the
    step's (accumulated, compressed, clipped) grads ``g``: they carry the
    gradient that Adam's first, sign-like update of the params hides.
    Each is held per leaf within 1e-5 of the leaf's max.  Under int8
    compression an element whose grad lies within roundoff of a rounding
    tie may round to the next int8 step in one package; such an element
    differs by that step (the leaf's max |mu| / 127) and is counted (at
    most one in a thousand of a leaf), not held.  Returns the count."""
    ties = 0
    for mt, mj, vt, vj in zip(tree_leaves(tst.mu), jax.tree.leaves(jst.mu),
                              tree_leaves(tst.nu), jax.tree.leaves(jst.nu)):
        mt, mj, vt, vj = mt.numpy(), np.asarray(mj), vt.numpy(), np.asarray(vj)
        top = float(np.abs(mj).max())
        d = np.abs(mt - mj)
        tie = (np.abs(d - top / 127) <= 1e-3 * top / 127) if int8_ties \
            else np.zeros(d.shape, bool)
        assert (d[~tie] <= 1e-5 * top).all(), float(d[~tie].max() / top)
        assert tie.sum() <= max(1, tie.size // 1000), (tie.sum(), tie.size)
        ties += int(tie.sum())
        dv = np.abs(vt - vj)[~tie]
        assert (dv <= 1e-5 * float(np.abs(vj).max())).all(), \
            float(dv.max() / np.abs(vj).max())
    return ties


def test_one_trainer_step_matches_jax_in_fp32(monkeypatch):
    """2 microbatches and int8 grads: loss within 1e-5, params within
    3e-3 absolute (the JAX microbatch test's bound, which a first Adam
    step meets whatever the grads), and the moments, which hold the
    grads, within 1e-5 of each leaf's max."""
    (tp1, tst, _, _), (jp1, jst, _, _) = _fp32_step_vs_jax(monkeypatch, "int8")
    for a, b in zip(tree_leaves(tp1), jax.tree.leaves(jp1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=3e-3)
    print("int8 rounding ties", _hold_moments(tst, jst, int8_ties=True))


def test_one_uncompressed_trainer_step_holds_the_grads_of_jax(monkeypatch):
    """2 microbatches, no compression and no clipping (which would scale
    the grads to a norm of 1 and hide their size): the moments within
    1e-5 of each leaf's max, element for element."""
    (_, tst, _, _), (_, jst, _, _) = _fp32_step_vs_jax(monkeypatch, "none",
                                                       clip_norm=None)
    assert _hold_moments(tst, jst) == 0


# ----------------------------------------------------------------- donate

def test_donate_and_no_donate_are_the_same_bits():
    cfg = get_smoke_config("mixtral-8x7b")
    model = build_model(cfg)
    data = SyntheticLM(DataSpec(vocab=cfg.vocab, seq_len=16, global_batch=4))
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=3)
    out = {}
    for donate in (True, False):
        tr = Trainer(model, opt, TrainConfig(steps=3, microbatches=2,
                                             grad_compression="bf16"),
                     donate=donate, device=CPU)
        params, st, res = tr.init_state(_gen(4))
        ptrs = [t.data_ptr() for t in _leaves(params, st.mu, res)]
        before = [t.clone() for t in _leaves(params, st.mu, res)]
        losses = []
        for step in range(3):
            batch = {k: torch.from_numpy(v) for k, v in data.batch(step).items()}
            params, st, res, loss = tr.step(params, st, res, batch)
            losses.append(float(loss))
        after = _leaves(params, st.mu, res)
        same_storage = [t.data_ptr() for t in after] == ptrs
        assert same_storage == donate
        if not donate:     # the caller's first state is untouched
            first = tr.init_state(_gen(4))
            for a, b in zip(_leaves(first[0], first[1].mu, first[2]),
                            before):
                assert torch.equal(a, b)
        out[donate] = (losses, [t.clone() for t in after])
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


# -------------------------------------------------------------------- CLI

def test_train_cli_on_the_cpu(capsys):
    losses = train_cli.main(["--arch", "whisper-tiny", "--smoke", "--steps",
                             "4", "--batch", "2", "--seq", "16", "--device",
                             "cpu", "--microbatches", "2",
                             "--grad-compression", "int8"])
    out = capsys.readouterr().out
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert f"first-10-mean {losses[0]:.4f}  last-10-mean {losses[-1]:.4f}" \
        in out


def test_the_trainer_runs_on_the_card_by_default():
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), n_layers=1)
    model = build_model(cfg)
    if torch.cuda.is_available():
        assert Trainer(model, AdamW(), TrainConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(model, AdamW(), TrainConfig())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--smoke", "--steps", "1"])
