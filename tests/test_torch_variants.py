"""The port's ``RuntimeFlags`` variants against the JAX package.

``window`` (ring caches for dense, MoE and MLA stacks), ``kv_quant`` (the
int8 K/V cache), ``mla_absorbed`` (MLA prefill in the latent space) and
``moe_group_rows`` (MoE routing groups of several batch rows), each held
against ``repro.models`` at the same flags, in float32 on the CPU, where
the kernels take their plain versions. Weights come from the JAX
``init`` (or numpy seeds) through ``params_from_jax``; tolerance 1e-4
unless a test says otherwise.

Small configurations: ``llama3.2-1b`` and ``mistral-nemo-12b`` at
``reduced()``; ``granite-moe-3b-a800m`` at its own routing (40 experts,
top 8) and heads (6 q / 2 kv of 64) with d_model 64; ``minicpm3-4b``
at MiniCPM3's head widths (q/k 96, v 64) with small ranks;
``recurrentgemma-9b`` at ``reduced()`` with d_model 64 (one (rec, rec,
attn) group, window 64).

Bit-equality of an int8 cache needs equal rows to quantize. XLA's and
PyTorch's float32 matmuls sum in other orders, and ``jnp.cos`` and
``torch.cos`` differ in the last bit for about one angle in twenty, so
the decode test that claims bit-equal caches projects exactly (inputs and
weights on a grid of 1/32, so every product and partial sum is exact in
float32) and hands the port the JAX RoPE tables; its output is compared
at 1e-4. Through a whole model the rows to quantize differ in their last
bits, so now and then one entry lies across a rounding boundary and is
stored one level apart (one flip moves llama's logits by about 1e-3):
the teacher-forced int8 decodes hold logits to 1e-4 until the first such
entry, then to 1e-2, and allow at most ``MAX_FLIPS`` entries, each one
level apart.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import MLAConfig as JaxMLAConfig  # noqa: E402
from repro.models import Model as JaxModel, RuntimeFlags as JaxFlags  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MLAConfig  # noqa: E402
from repro_torch.models import Model, RuntimeFlags, params_from_jax  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.training.tree import flatten_with_paths  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
FLIP_TOL = dict(rtol=0, atol=1e-2)   # logits after an int8 entry a level apart
MAX_FLIPS = 8                        # of about 25k int8 entries written
_PAD_SLOT = 2 ** 30
LLAMA, NEMO, GRANITE, MINICPM, RGEMMA = (
    "llama3.2-1b", "mistral-nemo-12b", "granite-moe-3b-a800m", "minicpm3-4b",
    "recurrentgemma-9b")
_SMALL = {
    GRANITE: dict(num_layers=2, d_model=64, d_ff=32, vocab_size=128,
                  num_heads=6, num_kv_heads=2, head_dim=64),
    MINICPM: dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128),
    RGEMMA: dict(d_model=64, d_ff=128, vocab_size=128),
}
_MINICPM_MLA = dict(q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=64,
                    qk_rope_head_dim=32, v_head_dim=64)


def _cfg(get, mla_cls, arch):
    if arch == GRANITE:
        return dataclasses.replace(get(arch), **_SMALL[arch])
    cfg = get(arch).reduced()
    if arch in _SMALL:
        cfg = dataclasses.replace(cfg, **_SMALL[arch])
    if arch == MINICPM:
        cfg = dataclasses.replace(cfg, mla=mla_cls(**_MINICPM_MLA))
    return cfg


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """(JAX params, the port's copy) from ``jax.random.key(0)``."""
    jcfg = _cfg(jax_get_config, JaxMLAConfig, arch)
    jp = JaxModel(jcfg, JaxFlags(dtype=jnp.float32)).init(jax.random.key(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _models(arch, **flags):
    """(JAX model, its params, the port's model, its params) at ``flags``."""
    jp, tp = _weights(arch)
    jm = JaxModel(_cfg(jax_get_config, JaxMLAConfig, arch),
                  JaxFlags(dtype=jnp.float32, **flags))
    tm = Model(_cfg(get_config, MLAConfig, arch),
               RuntimeFlags(dtype=torch.float32, **flags))
    return jm, jp, tm, tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _raw(x):
    """The array with its own dtype, for bit-equality."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_caches_close(tc, jc, **tol):
    tl, jl = flatten_with_paths(tc), flatten_with_paths(jc)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_, j) in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape), path
        np.testing.assert_allclose(_np(t), _np(j), err_msg=str(path), **tol)


def _int8_flips(tc, jc) -> int:
    """Entries of the int8 leaves stored one level apart (and none
    further)."""
    n = 0
    for (p, t), (_, j) in zip(flatten_with_paths(tc), flatten_with_paths(jc)):
        if t.dtype == torch.int8:
            diff = np.abs(_raw(t).astype(np.int32) - _raw(j).astype(np.int32))
            assert diff.max() <= 1, p
            n += int(diff.sum())
    return n


def _teacher_forced(arch, flags, B, max_len, pos0, steps, seed):
    """Decode ``steps`` seeded tokens from empty caches at ragged starting
    positions ``pos0`` in both packages; logits each step within 1e-4 (for
    an int8 cache, until its first entry a level apart: see the module
    docstring). Returns (JAX model, port's cache, JAX cache)."""
    jm, jp, tm, tp = _models(arch, **flags)
    jcache = jm.init_cache(B, max_len)
    tcache = tm.init_cache(B, max_len, device="cpu")
    dec = jax.jit(jm.decode_step)
    rng = np.random.default_rng(seed)
    pos0 = np.asarray(pos0, np.int32)
    for step in range(steps):
        tok = rng.integers(0, jm.cfg.vocab_size, size=B).astype(np.int32)
        pos = pos0 + step
        jl, jcache = dec(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        flips = _int8_flips(tcache, jcache)
        assert flips <= MAX_FLIPS, f"step {step}: {flips} int8 entries"
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=f"step {step}",
                                   **(FLIP_TOL if flips else TOL))
    return jm, tcache, jcache


# ---------------------------------------------------------------------------
# RuntimeFlags
# ---------------------------------------------------------------------------

def test_runtime_flags_have_the_jax_defaults():
    port, ref = RuntimeFlags(), JaxFlags()
    for name in ("window", "kv_quant", "mla_absorbed", "moe_group_rows"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16


# ---------------------------------------------------------------------------
# kv_quant
# ---------------------------------------------------------------------------

def _rows_to_quantize(case):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    if case == "zero row":                       # the 1e-8 floor
        x[1, 2] = 0.0
    if case == "half ties":
        # max |x| 127 gives scale 1 exactly: x / scale = k + 0.5 rounds to
        # the even neighbour (2.5 -> 2, -3.5 -> -4, 0.5 -> 0)
        x[0, 0, :8] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]
        x[2, 4] = np.round(x[2, 4] * 4) / 4
        x[2, 4, 0] = 127.0
    return x


@pytest.mark.parametrize("case", ["normal", "zero row", "half ties",
                                  "bfloat16"])
def test_quantize_rows_is_bit_equal(case):
    x = _rows_to_quantize(case)
    if case == "bfloat16":
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
        assert np.array_equal(np.asarray(jx.astype(jnp.float32)),
                              tx.float().numpy())
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jq, js = JL._quantize_rows(jx)
    tq, ts = TL._quantize_rows(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(_raw(tq), _raw(jq))
    assert np.array_equal(_raw(ts), _raw(js))
    if case == "zero row":
        assert ts[1, 2].item() == np.float32(1e-8)
        assert not tq[1, 2].any()
    if case == "half ties":
        assert tq[0, 0, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]


def _exact_attention(cfg, rng):
    """Attention weights and inputs on a grid of 1/32: every product and
    partial sum of the projections is exact in float32."""
    d, H, KV, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    grid = lambda shape, den: (rng.integers(-4, 5, shape) / den).astype(
        np.float32)
    p = {"wq": grid((d, H, D), 8), "wk": grid((d, KV, D), 8),
         "wv": grid((d, KV, D), 8),
         "wo": (rng.standard_normal((H, D, d)) / 16).astype(np.float32)}
    return p, grid


def _jax_rope(pos, cfg):
    """The JAX model's RoPE tables of ``pos``, in the port's layout."""
    ang = (jnp.asarray(pos)[:, None].astype(jnp.float32)
           * JL.rope_frequencies(cfg.head_dim, cfg.rope_theta))
    return (torch.from_numpy(np.asarray(jnp.cos(ang)))[:, None, :],
            torch.from_numpy(np.asarray(jnp.sin(ang)))[:, None, :])


@pytest.mark.parametrize("arch", [LLAMA, GRANITE])
@pytest.mark.parametrize("slots,ctx", [(False, None), (True, None),
                                       (True, 16)],
                         ids=["rows", "arena", "arena-ctx16"])
def test_int8_decode_writes_the_cache_bit_equal(arch, slots, ctx):
    """One decode step over an int8 cache (a per-row cache, or a slot arena
    with a padding row at the out-of-range slot): the output within 1e-4
    and every leaf — int8 K/V and float32 scales — bit-equal to JAX's."""
    cfg = _cfg(jax_get_config, JaxMLAConfig, arch)
    tcfg = _cfg(get_config, MLAConfig, arch)
    rng = np.random.default_rng(1)
    p, grid = _exact_attention(cfg, rng)
    N, T, KV, D = 4, 24, cfg.num_kv_heads, cfg.head_dim
    hist = rng.standard_normal((N, T, KV, D)).astype(np.float32)
    kq, ks = JL._quantize_rows(jnp.asarray(hist))
    vq, vs = JL._quantize_rows(jnp.asarray(hist * 0.7))
    cache = {k: np.asarray(v) for k, v in
             {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}.items()}
    if slots:
        slot_ids = np.array([2, 0, _PAD_SLOT], np.int32)
        pos = np.array([5, 13, 0], np.int32)
        live, n_out = 2, 2
    else:
        slot_ids, live, n_out = None, None, N
        pos = np.array([0, 7, 13, 15], np.int32)
    x = grid((len(pos), cfg.d_model), 4)
    jy, jc = JL.apply_attention_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(pos), cfg,
        slots=None if slot_ids is None else jnp.asarray(slot_ids), ctx=ctx)
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ty, tc = TL.apply_attention_decode(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        tc, torch.from_numpy(pos), tcfg,
        slots=None if slot_ids is None else torch.from_numpy(slot_ids),
        ctx=ctx, live=live, rope=_jax_rope(pos, cfg))
    np.testing.assert_allclose(_np(ty)[:n_out], _np(jy)[:n_out], **TOL)
    assert set(tc) == set(jc)
    for key in jc:
        assert tc[key].dtype == (torch.int8 if key in ("k", "v")
                                 else torch.float32)
        assert np.array_equal(_raw(tc[key]), _raw(jc[key])), key
    changed = (_raw(tc["k"]) != cache["k"]).any(axis=(1, 2, 3))
    assert changed.sum() == (live or N)          # padding rows write nothing


_CACHE_CASES = [
    (LLAMA, dict(kv_quant=True)), (LLAMA, dict(window=16)),
    (LLAMA, dict(window=16, kv_quant=True)),
    (GRANITE, dict(window=24, kv_quant=True)),
    (MINICPM, dict(window=24, kv_quant=True)),
    (RGEMMA, dict(window=8, kv_quant=True)),
]


@pytest.mark.parametrize("arch,flags", _CACHE_CASES,
                         ids=[f"{a}-{'-'.join(f)}" for a, f in _CACHE_CASES])
def test_init_cache_leaves_match_jax(arch, flags):
    """Leaf shapes and dtypes: rings of min(max_len, window) rows for dense,
    MoE and MLA; int8 K/V with float32 scales for GQA blocks (the hybrid's
    local attention too), never for MLA's latent; a hybrid keeps its own
    window."""
    jm, _, tm, _ = _models(arch, **flags)
    jl = flatten_with_paths(jm.init_cache(2, 128))
    tl = flatten_with_paths(tm.init_cache(2, 128, device="cpu"))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_, j) in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).replace("torch.", "") == np.dtype(j.dtype).name, \
            path


@pytest.mark.parametrize("arch,steps", [(LLAMA, 12), (RGEMMA, 12)])
def test_int8_cache_teacher_forced_decode_matches_jax(arch, steps):
    """From an empty int8 cache, seeded tokens at ragged positions: logits
    each step within 1e-4 (1e-2 after an entry a level apart); the caches
    end int8 with float32 scales."""
    _, tc, jc = _teacher_forced(arch, dict(kv_quant=True), B=2, max_len=32,
                                pos0=[0, 3], steps=steps, seed=2)
    quant = [t for p, t in flatten_with_paths(tc) if p[-1] in ("k", "v")]
    assert quant and all(t.dtype == torch.int8 for t in quant)
    scales = [(t, j) for (p, t), (_, j) in zip(flatten_with_paths(tc),
                                               flatten_with_paths(jc))
              if p[-1].endswith("_scale")]
    for t, j in scales:
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# window
# ---------------------------------------------------------------------------

_RING = [(NEMO, 8, [0, 3]), (GRANITE, 24, [0, 17]), (MINICPM, 24, [0, 17])]


@pytest.mark.parametrize("arch,window,pos0", _RING,
                         ids=[a for a, _, _ in _RING])
def test_ring_decode_matches_jax(arch, window, pos0):
    """12 decode steps over caches of ``window`` rows from an empty cache,
    with rows that wrap the ring: logits each step, and the ring caches."""
    _, tc, jc = _teacher_forced(arch, dict(window=window), B=2, max_len=1024,
                                pos0=pos0, steps=12, seed=3)
    assert all(t.shape[2] == window for _, t in flatten_with_paths(tc))
    _assert_caches_close(tc, jc, **TOL)


@pytest.mark.parametrize("arch,window", [(NEMO, 8), (GRANITE, 24),
                                         (MINICPM, 24)])
def test_windowed_prefill_matches_jax(arch, window):
    """Prefill of 40 tokens under a window: logits and the (unwindowed,
    full-length) prefill cache."""
    jm, jp, tm, tp = _models(arch, window=window)
    tokens = np.random.default_rng(4).integers(
        0, jm.cfg.vocab_size, size=(2, 40)).astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(tokens))
    tl, tc = tm.prefill(tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _assert_caches_close(tc, jc, **TOL)
    # the window changed the function
    _, _, plain, _ = _models(arch)
    free, _ = plain.prefill(tp, torch.from_numpy(tokens))
    assert np.abs(_np(free) - _np(tl)).max() > 1e-3


def test_hybrid_keeps_its_local_window():
    """``flags.window`` leaves a hybrid's local attention at its own window,
    as JAX does: prefill past it and decode steps give JAX's logits, and
    the same as without the flag."""
    jm, jp, tm, tp = _models(RGEMMA, window=8)
    assert tm._window("attn") == tm.cfg.hybrid.local_window == 64
    assert tm._window("rec") is None
    tokens = np.random.default_rng(5).integers(
        0, jm.cfg.vocab_size, size=(2, 20)).astype(np.int32)
    jl, _ = jm.prefill(jp, jnp.asarray(tokens))
    tl, _ = tm.prefill(tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _, _, plain, _ = _models(RGEMMA)
    free, _ = plain.prefill(tp, torch.from_numpy(tokens))
    np.testing.assert_array_equal(_np(free), _np(tl))
    _teacher_forced(RGEMMA, dict(window=8), B=2, max_len=128, pos0=[0, 60],
                    steps=6, seed=6)


# ---------------------------------------------------------------------------
# mla_absorbed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 2048])
@pytest.mark.parametrize("window", [None, 24])
def test_absorbed_mla_dense_matches_jax(window, chunk):
    """``apply_mla_dense(absorbed=True)`` against the JAX absorbed path at
    the same query chunk, S 64: output and latent cache."""
    jp, tp = _weights(MINICPM)
    cfg = _cfg(jax_get_config, JaxMLAConfig, MINICPM)
    tcfg = _cfg(get_config, MLAConfig, MINICPM)
    bj = jax.tree.map(lambda a: a[1], jp["blocks"]["attn"])
    bt = {k: (v[1] if isinstance(v, torch.Tensor)
              else {"scale": v["scale"][1]})
          for k, v in tp["blocks"]["attn"].items()}
    x = np.random.default_rng(7).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    jy, jc = JL.apply_mla_dense(bj, jnp.asarray(x), cfg, chunk=chunk,
                                window=window, absorbed=True)
    ty, tc = TL.apply_mla_dense(bt, torch.from_numpy(x), tcfg, chunk=chunk,
                                window=window, absorbed=True)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL)
    # and the non-absorbed flash path computes the same function
    fy, _ = TL.apply_mla_dense(bt, torch.from_numpy(x), tcfg, window=window)
    np.testing.assert_allclose(_np(fy), _np(ty), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [None, 24])
def test_absorbed_prefill_and_loss_match_jax(window):
    """``Model.prefill`` (logits and cache) and ``Model.loss`` with
    ``mla_absorbed`` against the JAX model's."""
    jm, jp, tm, tp = _models(MINICPM, mla_absorbed=True, window=window)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, jm.cfg.vocab_size, size=(2, 40)).astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(tokens))
    tl, tc = tm.prefill(tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _assert_caches_close(tc, jc, **TOL)
    targets = rng.integers(0, jm.cfg.vocab_size, size=(2, 40)).astype(np.int32)
    jloss, jparts = jm.loss(jp, {"tokens": jnp.asarray(tokens),
                                 "targets": jnp.asarray(targets)})
    tloss, tparts = tm.loss(tp, {"tokens": torch.from_numpy(tokens),
                                 "targets": torch.from_numpy(targets)})
    np.testing.assert_allclose(_np(tloss), _np(jloss), **TOL)
    np.testing.assert_allclose(_np(tparts["ce"]), _np(jparts["ce"]), **TOL)


# ---------------------------------------------------------------------------
# moe_group_rows
# ---------------------------------------------------------------------------

def _moe_params():
    cfg = _cfg(jax_get_config, JaxMLAConfig, GRANITE)
    jp = JMOE.init_moe(jax.random.key(1), cfg, jnp.float32)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _dropped(tp, x, cfg, rows):
    """(token, expert) pairs dropped at capacity in groups of ``rows``."""
    B, S, d = x.shape
    xg = x.reshape(B // rows, rows * S, d)
    probs = torch.softmax(xg.float() @ tp["router"], dim=-1)
    top_e = torch.topk(probs, cfg.moe.experts_per_token, dim=-1).indices
    G, t = xg.shape[:2]
    keep = TMOE._dispatch_indices(top_e.reshape(G, -1),
                                  TMOE.capacity(cfg, t))[3]
    return int((~keep).sum())


@pytest.mark.parametrize("rows", [1, 2, 4])
def test_apply_moe_routing_groups_match_jax(rows):
    """B 4, S 3 at granite's routing in groups of 1, 2 and 4 rows (capacity
    1, 2 and 3 slots, so pairs are dropped): y and the aux loss."""
    cfg, jp, tp = _moe_params()
    tcfg = _cfg(get_config, MLAConfig, GRANITE)
    x = np.random.default_rng(9).standard_normal(
        (4, 3, cfg.d_model)).astype(np.float32)
    jy, jaux = JMOE.apply_moe(jp, jnp.asarray(x), cfg, group_rows=rows)
    ty, taux = TMOE.apply_moe(tp, torch.from_numpy(x), tcfg, with_aux=True,
                              group_rows=rows)
    assert _dropped(tp, torch.from_numpy(x), tcfg, rows) > 0
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_allclose(_np(taux), _np(jaux), **TOL)
    if rows > 1:     # groups route otherwise than rows alone
        y1 = TMOE.apply_moe(tp, torch.from_numpy(x), tcfg)
        assert np.abs(_np(y1) - _np(ty)).max() > 1e-3


def test_apply_moe_rejects_rows_the_group_does_not_divide():
    cfg, jp, tp = _moe_params()
    tcfg = _cfg(get_config, MLAConfig, GRANITE)
    x = np.zeros((3, 2, cfg.d_model), np.float32)
    with pytest.raises(ValueError, match="routing groups of 2"):
        TMOE.apply_moe(tp, torch.from_numpy(x), tcfg, group_rows=2)
    with pytest.raises(TypeError):
        JMOE.apply_moe(jp, jnp.asarray(x), cfg, group_rows=2)


def test_granite_decode_and_loss_in_routing_groups_match_jax():
    """``Model.decode_step`` at B 4 (two groups of two rows) and
    ``Model.loss`` (with its aux) under ``moe_group_rows`` 2."""
    _teacher_forced(GRANITE, dict(moe_group_rows=2), B=4, max_len=32,
                    pos0=[0, 2, 5, 9], steps=4, seed=10)
    jm, jp, tm, tp = _models(GRANITE, moe_group_rows=2)
    rng = np.random.default_rng(11)
    batch = {k: rng.integers(0, jm.cfg.vocab_size, size=(4, 8)).astype(
        np.int32) for k in ("tokens", "targets")}
    jloss, jparts = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tparts = tm.loss(tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    np.testing.assert_allclose(_np(tloss), _np(jloss), **TOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(_np(tparts[key]), _np(jparts[key]), **TOL)
