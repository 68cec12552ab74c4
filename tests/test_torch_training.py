"""The port's training path against the JAX package's, on the CPU in f32.

* ``Model.loss`` and the gradient of EVERY parameter leaf against
  ``jax.value_and_grad`` of ``repro.models.Model.loss`` on the same
  weights (``params_from_jax``) and the same numpy batch, for the dense
  decoder, MLA at MiniCPM3's q/k 96 and v 64, the MoE (granite's routing,
  a nonzero load-balance loss), the SSM (a backward through the
  recurrent plain version at chunk 8 and through the chunked one at
  chunk 64), the hybrid with a tail (one (rec, rec, attn) group and two
  rec layers, past its window of 64) and ``internvl2-26b.reduced()`` with
  a prefix of 8 embeddings. Tolerances: the loss and its parts to rtol
  1e-5 (XLA and torch order CPU sums differently), each leaf to
  ``||g - g_jax|| / ||g_jax|| <= 1e-4`` (measured: 3e-6 at most).
* ``cosine_lr``, ``clip_by_global_norm`` and four ``adamw_update`` steps
  (clipped and not, the decay mask on ``scale``, ``A_log``, ``D``,
  ``dt_bias``, and ``bq`` decayed) on the same gradients: rtol 1e-6.
* One ``make_train_step`` on the tiny llama: the parameters' updates
  against JAX's. Adam's first step maps g to g / (|g| + eps), so an
  element whose gradient is near its rounding error may move by up to 2
  lr; at least 99.9 % of the elements must agree to 1e-3 * lr and all to
  2 * lr.
* Checkpoints cross-load both ways (keys are JAX ``keystr`` paths) and
  raise on a missing key or a wrong shape; ``train_loop`` and the
  launcher (``--device cpu --reduced``) reduce the loss.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel, RuntimeFlags as JaxFlags  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ssd_chunked, ssd_chunked_plain  # noqa: E402
from repro_torch.models import Model, RuntimeFlags, params_from_jax  # noqa: E402
from repro_torch.training import (OptimizerConfig, TrainState,  # noqa: E402
                                  adamw_update, checkpoint,
                                  clip_by_global_norm, cosine_lr,
                                  init_adamw, init_state, make_train_step,
                                  train_loop, value_and_grad)
from repro_torch.training.tree import flatten_with_paths, keystr  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
_SMALL = dict(d_model=64, d_ff=128, vocab_size=128)
_MINICPM3 = dict(q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=64,
                 qk_rope_head_dim=32, v_head_dim=64)


def _pair(arch, **kw):
    """(JAX config, port config): ``arch``'s reduced() with ``kw``; an
    ``mla`` or ``ssm`` dict replaces fields of that sub-config."""
    sub = {k: kw.pop(k) for k in ("mla", "ssm") if k in kw}
    out = []
    for get in (jax_get_config, get_config):
        cfg = dataclasses.replace(get(arch).reduced(), **kw)
        for k, fields in sub.items():
            cfg = dataclasses.replace(
                cfg, **{k: dataclasses.replace(getattr(cfg, k), **fields)})
        out.append(cfg)
    return tuple(out)


# family -> (arch, config overrides, batch, seq)
FAMILIES = {
    "dense": ("llama3.2-1b", dict(**_SMALL, num_prefix_embeddings=0), 2, 24),
    "mla": ("minicpm3-4b", dict(**_SMALL, num_layers=2, mla=_MINICPM3), 2,
            24),
    "moe": ("granite-moe-3b-a800m",
            dict(num_layers=2, d_model=64, d_ff=32, vocab_size=128,
                 num_heads=6, num_kv_heads=2, head_dim=64), 2, 24),
    "ssm_chunk8": ("mamba2-2.7b", dict(**_SMALL, num_prefix_embeddings=0),
                   2, 24),
    "ssm_chunk64": ("mamba2-2.7b", dict(**_SMALL, num_prefix_embeddings=0,
                                        ssm=dict(chunk_size=64)), 1, 128),
    "hybrid_tail": ("recurrentgemma-9b", dict(**_SMALL, num_layers=5), 2,
                    80),
    "vlm_prefix": ("internvl2-26b", {}, 2, 16),
}


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size,
                                     (B, S)).astype(np.int32)}
    if cfg.num_prefix_embeddings:
        batch["prefix"] = rng.standard_normal(
            (B, cfg.num_prefix_embeddings, cfg.d_model)).astype(np.float32)
    return batch


def _jax_paths(tree):
    """{keystr: numpy leaf} of a JAX tree."""
    return {jax.tree_util.keystr(p): np.asarray(leaf, np.float32)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grad_leaves(params):
    for _, leaf in flatten_with_paths(params):
        leaf.requires_grad_(True)
    return params


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_every_gradient_match_jax(family):
    arch, kw, B, S = FAMILIES[family]
    jcfg, tcfg = _pair(arch, **dict(kw))
    jm = JaxModel(jcfg, JaxFlags(dtype=jnp.float32, attn_chunk=8))
    jp = jm.init(jax.random.key(0))
    batch = _batch(jcfg, B, S)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True))(jp)
    tp = _grad_leaves(params_from_jax(jax.tree.map(np.asarray, jp),
                                      device="cpu"))
    model = Model(tcfg, RuntimeFlags(dtype=torch.float32))
    (loss, parts), grads = value_and_grad(
        model, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(parts[k].detach()),
                                   float(jparts[k]), rtol=LOSS_RTOL,
                                   atol=1e-7)
    if family == "moe":
        assert float(parts["aux"].detach()) > 0.5   # E * sum(f * p) ~ 1+
    jg = _jax_paths(jgrads)
    flat = flatten_with_paths(grads)
    assert sorted(keystr(p) for p, _ in flat) == sorted(jg)
    for path, g in flat:
        want = jg[keystr(path)]
        assert g.shape == want.shape, keystr(path)
        norm = np.linalg.norm(want)
        assert norm > 0, f"{keystr(path)}: the JAX gradient is zero"
        rel = np.linalg.norm(_np(g) - want) / norm
        assert rel <= GRAD_REL, f"{keystr(path)}: {rel:.2e}"


REMAT_FAMILIES = ("dense", "mla", "moe", "ssm_chunk8", "hybrid_tail")


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("family", REMAT_FAMILIES)
def test_remat_keeps_the_loss_and_gradients(family, policy, monkeypatch):
    """``remat`` around every block (every hybrid group; the tail runs
    without it): the loss equals remat off exactly and every leaf's
    gradient to ``||dg|| / ||g|| <= 1e-6`` (recomputed and saved values
    sum in another order); both equal JAX's remat loss (rtol 1e-5) and
    ``jax.grad`` (1e-5 per leaf). The blocks' RMSNorm runs again in the
    backward pass."""
    arch, kw, B, S = FAMILIES[family]
    jcfg, tcfg = _pair(arch, **dict(kw))
    jm = JaxModel(jcfg, JaxFlags(dtype=jnp.float32, attn_chunk=8,
                                 remat=True, remat_policy=policy))
    jp = jm.init(jax.random.key(0))
    batch = _batch(jcfg, B, S)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True))(jp)
    tp = _grad_leaves(params_from_jax(jax.tree.map(np.asarray, jp),
                                      device="cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    from repro_torch.kernels import rmsnorm as RMS
    calls = []
    plain = RMS.fused_rmsnorm_plain
    monkeypatch.setattr(RMS, "fused_rmsnorm_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    runs = {}
    for remat in (False, True):
        calls.clear()
        model = Model(tcfg, RuntimeFlags(dtype=torch.float32, remat=remat,
                                         remat_policy=policy))
        (loss, _), grads = value_and_grad(model, tp, tb)
        runs[remat] = (float(loss.detach()), flatten_with_paths(grads),
                       len(calls))
    assert runs[True][0] == runs[False][0]
    assert runs[True][2] > runs[False][2]
    np.testing.assert_allclose(runs[True][0], float(jloss), rtol=LOSS_RTOL)
    jg = _jax_paths(jgrads)
    for (path, g), (_, g0) in zip(runs[True][1], runs[False][1]):
        key = keystr(path)
        assert float((g - g0).norm() / g0.norm()) <= 1e-6, key
        rel = np.linalg.norm(_np(g) - jg[key]) / np.linalg.norm(jg[key])
        assert rel <= 1e-5, f"{key}: {rel:.2e}"


def test_prefill_takes_a_prefix_like_jax():
    jcfg, tcfg = _pair("internvl2-26b")
    jm = JaxModel(jcfg, JaxFlags(dtype=jnp.float32, attn_chunk=8))
    jp = jm.init(jax.random.key(1))
    batch = _batch(jcfg, 2, 8, seed=3)
    jlogits, jcache = jm.prefill(jp, jnp.asarray(batch["tokens"]),
                                 prefix=jnp.asarray(batch["prefix"]))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    model = Model(tcfg, RuntimeFlags(dtype=torch.float32))
    with torch.no_grad():
        logits, cache = model.prefill(tp, torch.from_numpy(batch["tokens"]),
                                      prefix=torch.from_numpy(batch["prefix"]))
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    assert cache[0]["k"].shape[2] == 8 + jcfg.num_prefix_embeddings
    np.testing.assert_allclose(_np(cache[0]["k"]), np.asarray(jcache[0]["k"]),
                               rtol=1e-4, atol=1e-4)


def test_the_loss_builds_no_decode_cache_and_keeps_moe_serving_ops():
    """The serving path's MoE returns y alone; the loss asks for the aux."""
    arch, kw = FAMILIES["moe"][:2]
    _, tcfg = _pair(arch, **kw)
    model = Model(tcfg, RuntimeFlags(dtype=torch.float32))
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.randn(2, 6, tcfg.d_model)
    from repro_torch.models import moe as TMOE
    layer0 = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    assert isinstance(TMOE.apply_moe(layer0, x, tcfg), torch.Tensor)
    y, aux = TMOE.apply_moe(layer0, x, tcfg, with_aux=True)
    assert y.shape == x.shape and aux.shape == ()
    calls = []
    real = model.init_cache
    model.init_cache = lambda *a, **k: calls.append(a) or real(*a, **k)
    model.loss(params, {k: torch.from_numpy(v)
                        for k, v in _batch(tcfg, 2, 6).items()})
    assert calls == []


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

OPT = dict(lr=3e-3, warmup_steps=3, total_steps=12, weight_decay=0.1)


@pytest.mark.parametrize("cfg_kw", [OPT, dict(lr=1e-3, warmup_steps=1,
                                              total_steps=5,
                                              min_lr_ratio=0.0)])
def test_cosine_lr_matches_jax(cfg_kw):
    for step in range(cfg_kw["total_steps"] + 3):
        want = JO.cosine_lr(JO.OptimizerConfig(**cfg_kw), jnp.int32(step))
        got = cosine_lr(OptimizerConfig(**cfg_kw),
                        torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _opt_tree(rng, dtype=np.float32):
    """A tree with every kind of key the decay mask looks at."""
    r = lambda *s: rng.standard_normal(s).astype(dtype)
    return {"embed": {"tok": r(6, 4)},
            "blocks": {"ln1": {"scale": r(3, 4)},
                       "attn": {"wq": r(3, 4, 2, 2), "bq": r(3, 2, 2)},
                       "ssm": {"A_log": r(3, 2), "D": r(3, 2),
                               "dt_bias": r(3, 2), "w_x": r(3, 4, 8),
                               "norm": {"scale": r(3, 8)}}},
            "final_norm": {"scale": r(4)}}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _opt_tree(np.random.default_rng(0))
    jc, jn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tc, tn = clip_by_global_norm(_to_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    want = _jax_paths(jc)
    for p, leaf in flatten_with_paths(tc):
        np.testing.assert_allclose(_np(leaf), want[keystr(p)], rtol=1e-6,
                                   atol=1e-7)


def test_adamw_steps_match_jax_with_the_decay_mask():
    rng = np.random.default_rng(1)
    params = _opt_tree(rng)
    jcfg, tcfg = JO.OptimizerConfig(**OPT), OptimizerConfig(**OPT)
    jp = jax.tree.map(jnp.asarray, params)
    js = JO.init_adamw(jp)
    tp = _to_torch(params)
    ts = init_adamw(tp)
    for step, scale in enumerate((3.0, 0.01, 1.0, 0.1)):   # clipped or not
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                        * scale).astype(np.float32), params)
        jp, js, jm = jax.jit(JO.adamw_update, static_argnums=0)(
            jcfg, jp, jax.tree.map(jnp.asarray, grads), js)
        tp, ts, tm = adamw_update(tcfg, tp, _to_torch(grads), ts)
        assert int(ts.step) == int(js.step) == step + 1
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        for jtree, ttree in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
            want = _jax_paths(jtree)
            for p, leaf in flatten_with_paths(ttree):
                np.testing.assert_allclose(_np(leaf), want[keystr(p)],
                                           rtol=1e-6, atol=1e-8)
    # the mask: scale, A_log, D, dt_bias undecayed; bq decayed
    zero = jax.tree.map(np.zeros_like, params)
    tp = _to_torch(params)
    adamw_update(tcfg, tp, _to_torch(zero), init_adamw(tp))
    moved = {keystr(p): not np.array_equal(_np(leaf), want_leaf)
             for (p, leaf), want_leaf in zip(
                 flatten_with_paths(tp),
                 [a for _, a in flatten_with_paths(params)])}
    assert moved == {k: not any(n in k for n in ("scale", "A_log", "'D'",
                                                 "dt_bias"))
                     for k in moved}
    assert moved["['blocks']['attn']['bq']"]


def _tiny_llama():
    return _pair("llama3.2-1b", **_SMALL, num_prefix_embeddings=0)


def test_one_train_step_matches_jax():
    jcfg, tcfg = _tiny_llama()
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jm = JaxModel(jcfg, JaxFlags(dtype=jnp.float32, attn_chunk=8))
    jp = jm.init(jax.random.key(2))
    batch = _batch(jcfg, 2, 16, seed=5)
    before = _jax_paths(jp)
    jstate, jmet = jax.jit(JT.make_train_step(jm, JO.OptimizerConfig(**kw)))(
        JT.TrainState(jp, JO.init_adamw(jp)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp = _grad_leaves(params_from_jax(jax.tree.map(np.asarray, jp),
                                      device="cpu"))
    model = Model(tcfg, RuntimeFlags(dtype=torch.float32))
    state, met = make_train_step(model, OptimizerConfig(**kw))(
        TrainState(tp, init_adamw(tp)),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5)
    after = _jax_paths(jstate.params)
    lr = kw["lr"]
    n_far = n = 0
    for p, leaf in flatten_with_paths(state.params):
        key = keystr(p)
        du = _np(leaf) - before[key]
        dj = after[key] - before[key]
        err = np.abs(du - dj)
        assert err.max() <= 2 * lr, key
        n_far += int((err > 1e-3 * lr).sum())
        n += err.size
    assert n_far <= 1e-3 * n, f"{n_far} of {n} updates differ by > 1e-3 lr"


# ---------------------------------------------------------------------------
# checkpoints, the loop and the launcher
# ---------------------------------------------------------------------------

def test_checkpoints_cross_load_both_ways(tmp_path):
    jcfg, tcfg = _pair("recurrentgemma-9b", **_SMALL, num_layers=5)
    jp = JaxModel(jcfg, JaxFlags(dtype=jnp.float32)).init(jax.random.key(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert "tail" in tp                        # a hybrid with a tail
    # JAX writes, the port reads
    jax_ckpt.save(str(tmp_path / "j.npz"), jp, step=7)
    like = Model(tcfg, RuntimeFlags(dtype=torch.float32)).init(
        torch.Generator().manual_seed(9))
    got, step = checkpoint.restore(str(tmp_path / "j.npz"), like)
    assert step == 7
    want = _jax_paths(jp)
    for p, leaf in flatten_with_paths(got):
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(_np(leaf), want[keystr(p)])
    # the port writes (bf16 leaves widened), JAX reads into bf16
    tb = jax.tree.map(lambda t: t.to(torch.bfloat16), tp,
                      is_leaf=lambda t: isinstance(t, torch.Tensor))
    checkpoint.save(str(tmp_path / "t.npz"), tb, step=3)
    assert not list(tmp_path.glob("*.tmp"))    # renamed into place
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    back, step = jax_ckpt.restore(str(tmp_path / "t.npz"), jb)
    assert step == 3
    tb_paths = {keystr(p): _np(leaf) for p, leaf in flatten_with_paths(tb)}
    for p, leaf in jax.tree_util.tree_flatten_with_path(back)[0]:
        assert leaf.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                      tb_paths[jax.tree_util.keystr(p)])
    # and the port's own round trip into bf16 targets
    again, _ = checkpoint.restore(str(tmp_path / "t.npz"), tb)
    for (p, a), (_, b) in zip(flatten_with_paths(again),
                              flatten_with_paths(tb)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), keystr(p)


def test_restore_raises_on_a_wrong_shape_or_a_missing_key(tmp_path):
    _, tcfg = _tiny_llama()
    params = Model(tcfg, RuntimeFlags(dtype=torch.float32)).init(
        torch.Generator().manual_seed(0))
    path = str(tmp_path / "c.npz")
    checkpoint.save(path, params)
    wide = Model(dataclasses.replace(tcfg, d_model=96),
                 RuntimeFlags(dtype=torch.float32)).init(
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="checkpoint shape"):
        checkpoint.restore(path, wide)
    with pytest.raises(KeyError, match="missing"):
        checkpoint.restore(path, {**params, "unembed": torch.zeros(2)})


def test_train_loop_reduces_the_loss_and_checkpoints(tmp_path):
    from repro_torch.data import DataConfig, TokenPipeline
    _, tcfg = _tiny_llama()
    model = Model(tcfg, RuntimeFlags(dtype=torch.float32))
    data = TokenPipeline(DataConfig(vocab_size=tcfg.vocab_size, seq_len=32,
                                    batch_size=4))
    path = str(tmp_path / "ck.npz")
    state, log = train_loop(model, OptimizerConfig(lr=3e-3, warmup_steps=2,
                                                   total_steps=16),
                            iter(data), 16,
                            generator=torch.Generator().manual_seed(0),
                            log_every=5, checkpoint_path=path,
                            checkpoint_every=5, verbose=False)
    assert log.steps == [0, 5, 10, 15]
    assert log.losses[-1] < 0.8 * log.losses[0]
    restored, step = checkpoint.restore(path, state.params)
    assert step == 16
    for (_, a), (_, b) in zip(flatten_with_paths(restored),
                              flatten_with_paths(state.params)):
        assert torch.equal(a, b.detach())


def test_init_state_gives_leaves_that_require_grad():
    _, tcfg = _tiny_llama()
    state = init_state(Model(tcfg, RuntimeFlags(dtype=torch.float32)),
                       torch.Generator().manual_seed(0))
    assert all(leaf.requires_grad and leaf.is_leaf
               for _, leaf in flatten_with_paths(state.params))
    assert int(state.opt.step) == 0


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    ck = str(tmp_path / "l.npz")
    code = launch_train.main(["--device", "cpu", "--reduced", "--steps",
                              "12", "--batch", "4", "--seq", "32",
                              "--log-every", "4", "--checkpoint", ck])
    assert code == 0
    out = capsys.readouterr().out
    assert "training llama3.2-1b (reduced) on cpu" in out
    assert "% reduction" in out and os.path.exists(ck)


def test_train_small_example_drops_the_loss_on_the_cpu(capsys):
    """``examples/train_small_torch.py``: the JAX example's flags and gate
    (the loss falls by more than 0.5)."""
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import train_small_torch
    finally:
        sys.path.remove(str(REPO / "examples"))
    assert train_small_torch.main(["--device", "cpu", "--steps", "30"]) == 0
    assert "training example OK" in capsys.readouterr().out


def test_launcher_takes_the_jax_launchers_flags():
    from repro_torch.launch import train as launch_train
    args = launch_train.parse_args([])
    assert (args.arch, args.steps, args.batch, args.seq, args.lr,
            args.checkpoint, args.log_every, args.device) == (
        "llama3.2-1b", 100, 8, 256, 3e-4, None, 10, "cuda")


def test_launcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.launch import train as launch_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "2"])


def test_training_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch.launch.train, repro_torch.training, "
            "repro_torch.data; bad = sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'repro')); print(bad)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


# ---------------------------------------------------------------------------
# the SSD scan's gradient where exp overflows
# ---------------------------------------------------------------------------

def test_ssd_gradient_stays_finite_where_the_decay_overflows():
    """At mamba2-2.7b's widths cum_i - cum_j above the diagonal exceeds
    log(f32 max) (A down to -80, dt near 0.1 and more, 256 rows a chunk);
    the reference's ``where(mask, exp(diff), 0)`` then has a NaN gradient
    (0 * inf). The port masks before the exp: its gradients stay finite
    and agree across chunkings of the same sequence (chunked plain at 64,
    recurrent plain at 32)."""
    rng = np.random.default_rng(4)
    S, nh, hd, N = 128, 3, 16, 8
    x = rng.standard_normal((1, S, nh, hd)).astype(np.float32)
    dt = np.full((1, S, nh), 2.0, np.float32)
    A = -np.array([1.0, 20.0, 80.0], np.float32)
    Bm = rng.standard_normal((1, S, N)).astype(np.float32)
    Cm = rng.standard_normal((1, S, N)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda a: jax_ssd_chunked(
        jnp.asarray(x), jnp.asarray(dt), a, jnp.asarray(Bm),
        jnp.asarray(Cm), 64)[0].sum()))(jnp.asarray(A))
    assert np.isnan(np.asarray(jg)).any()      # the reference's behaviour
    grads = []
    for chunk in (64, 32):
        ins = [torch.from_numpy(a).requires_grad_(True)
               for a in (x, dt, A, Bm, Cm)]
        y, _ = ssd_chunked(*ins, chunk)
        assert y.grad_fn is not None
        y.sum().backward()
        grads.append([t.grad for t in ins])
        assert all(torch.isfinite(g).all() for g in grads[-1])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    y_ref, _ = ssd_chunked_plain(*(torch.from_numpy(a)
                                   for a in (x, dt, A, Bm, Cm)), 64)
    assert torch.isfinite(y_ref).all()
