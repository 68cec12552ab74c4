"""The port's SSD scan and Mamba-2 model against the JAX package.

On the CPU ``repro_torch.kernels.ssd_chunked`` takes its plain version.
``ssd_chunk_intra_plain`` is held against the Pallas kernel
``ssd_chunk_intra`` (interpret mode) output by output, and
``ssd_chunked_plain`` against ``ref.ssd_chunked_ref`` (the JAX model's
``ssd_chunked``) and ``ssd_chunked_pallas``, over the shapes of
``tests/test_kernels.py`` plus chunk-1 cases, which is what an odd prefill
length runs. ``ssd_chunked_recurrent_plain`` (the recurrent kernel's
arithmetic) is held against the JAX model's ``ssd_chunked`` and
``ssd_chunked_plain`` at chunks 1, 2, 4 and 32, and so is
``ssd_chunked_tiled_plain`` (the tensor-core scan's: 64-row tiles, the
pairs inside a chunk rounded as the reference, those across chunks in
float32), also against ``ssd_chunked_pallas`` and the recurrent version,
at S below, equal to and past 64 with a partial last tile, and with heads
whose decay underflows inside a tile. Tolerances as there:
float32 1e-4, bfloat16 5e-2 on y; the float32 states, cumsums and decays
1e-4 in both.

The tiny Mamba-2 (``_tiny("mamba2-2.7b")`` of tests/test_engine.py: 2
layers, d_model 64, d_state 16, head_dim 32, chunk 32) runs on the JAX
``Model.init`` weights through ``params_from_jax``; prefill logits, the
state and conv caches, ragged decode steps and a span decode over a slot
arena with a padding row match the JAX model in float32 to 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunk_intra as pallas_intra  # noqa: E402
from repro.models import Model as JaxModel, RuntimeFlags as JaxFlags  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
import repro_torch.kernels as K  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model, RuntimeFlags, params_from_jax  # noqa: E402
from repro_torch.models.ssm import _chunk_for  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
_PAD_SLOT = 2 ** 30
_KW = dict(d_model=64, d_ff=128, vocab_size=128, num_prefix_embeddings=0)

SSD_SHAPES = [
    (2, 128, 4, 32, 16, 32),
    (1, 256, 2, 64, 32, 64),
    (2, 64, 8, 16, 8, 16),
    (1, 33, 4, 32, 16, 1),       # odd length: the halving rule gives chunk 1
    (2, 7, 2, 64, 24, 1),
]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _pair(a: np.ndarray, dtype=jnp.float32):
    """(jax array, torch tensor) holding the same values in ``dtype``."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _ssd_inputs(B, S, nh, hd, N, dtype, seed=7, A=None):
    rng = np.random.default_rng(seed)
    x = _pair(rng.standard_normal((B, S, nh, hd)), dtype)
    dt = _pair(np.logaddexp(rng.standard_normal((B, S, nh)), 0.0))
    A = _pair(-np.exp(rng.standard_normal((nh,)) * 0.3) if A is None else A)
    Bm = _pair(rng.standard_normal((B, S, N)), dtype)
    Cm = _pair(rng.standard_normal((B, S, N)), dtype)
    return x, dt, A, Bm, Cm


def _y_tol(dtype):
    return dict(rtol=5e-2, atol=5e-2) if dtype == jnp.bfloat16 else TOL


@pytest.mark.parametrize("B,S,nh,hd,N,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssd_chunk_intra_plain_matches_pallas(B, S, nh, hd, N, chunk, dtype):
    (xj, xt), (dj, dt_), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(
        B, S, nh, hd, N, dtype)
    want = pallas_intra(xj, dj, aj, bj, cj, chunk=chunk, interpret=True)
    got = K.ssd_chunk_intra_plain(xt, dt_, at, bt, ct, chunk)
    assert got[0].dtype == xt.dtype
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), **_y_tol(dtype))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


@pytest.mark.parametrize("B,S,nh,hd,N,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssd_chunked_plain_matches_ref_and_pallas(B, S, nh, hd, N, chunk,
                                                  dtype):
    (xj, xt), (dj, dt_), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(
        B, S, nh, hd, N, dtype)
    n0 = K.ssd_chunked.launches
    y, st = K.ssd_chunked(xt, dt_, at, bt, ct, chunk)   # CPU: plain version
    assert K.ssd_chunked.launches == n0
    assert y.dtype == xt.dtype and st.dtype == torch.float32
    y_ref, st_ref = ref.ssd_chunked_ref(xj, dj, aj, bj, cj, chunk)
    y_pal, st_pal = ops.ssd_chunked_pallas(xj, dj, aj, bj, cj, chunk,
                                           interpret=True)
    for yw, sw in ((y_ref, st_ref), (y_pal, st_pal)):
        np.testing.assert_allclose(_np(y), _np(yw), **_y_tol(dtype))
        np.testing.assert_allclose(_np(st), _np(sw), **TOL)


# the recurrent kernel's chunks (below 64): 1, 2, 4 and 32
SSD_RECURRENT_SHAPES = [
    (2, 7, 2, 64, 24, 1),
    (1, 33, 4, 32, 16, 1),
    (2, 66, 3, 16, 100, 2),
    (1, 64, 2, 32, 16, 4),
    (2, 96, 2, 16, 8, 32),
]


@pytest.mark.parametrize("B,S,nh,hd,N,chunk", SSD_RECURRENT_SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssd_chunked_recurrent_plain_matches_jax_and_plain(B, S, nh, hd, N,
                                                           chunk, dtype):
    """The recurrent kernel's arithmetic (h carried chunk by chunk, no
    per-chunk states) against the JAX model's ``ssd_chunked`` and the
    port's ``ssd_chunked_plain``."""
    (xj, xt), (dj, dt_), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(
        B, S, nh, hd, N, dtype)
    y, st = K.ssd_chunked_recurrent_plain(xt, dt_, at, bt, ct, chunk)
    assert y.dtype == xt.dtype and st.dtype == torch.float32
    y_jax, st_jax = jax_ssd_chunked(xj, dj, aj, bj, cj, chunk)
    y_pl, st_pl = K.ssd_chunked_plain(xt, dt_, at, bt, ct, chunk)
    for yw, sw in ((y_jax, st_jax), (y_pl, st_pl)):
        assert tuple(y.shape) == tuple(yw.shape)
        np.testing.assert_allclose(_np(y), _np(yw), **_y_tol(dtype))
        np.testing.assert_allclose(_np(st), _np(sw), **TOL)


# the tensor-core scan's chunks (below 64, dividing 64): S below 64, equal
# to it, a multiple of it, and past it with a partial last tile (383-like)
SSD_TILED_SHAPES = [
    (2, 7, 2, 64, 24, 1),
    (1, 64, 3, 32, 16, 2),
    (2, 128, 2, 16, 8, 4),
    (1, 96, 2, 16, 8, 32),
    (1, 191, 2, 16, 8, 1),
    (2, 130, 2, 16, 8, 2),
]


def _tiled_against_references(inputs, chunk, dtype, pallas=True):
    (xj, xt), (dj, dt_), (aj, at), (bj, bt), (cj, ct) = inputs
    y, st = K.ssd_chunked_tiled_plain(xt, dt_, at, bt, ct, chunk)
    assert y.dtype == xt.dtype and st.dtype == torch.float32
    wants = [jax_ssd_chunked(xj, dj, aj, bj, cj, chunk),
             K.ssd_chunked_recurrent_plain(xt, dt_, at, bt, ct, chunk)]
    if pallas:
        wants.append(ops.ssd_chunked_pallas(xj, dj, aj, bj, cj, chunk,
                                            interpret=True))
    for yw, sw in wants:
        assert tuple(y.shape) == tuple(yw.shape)
        np.testing.assert_allclose(_np(y), _np(yw), **_y_tol(dtype))
        np.testing.assert_allclose(_np(st), _np(sw), **TOL)


@pytest.mark.parametrize("B,S,nh,hd,N,chunk", SSD_TILED_SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssd_chunked_tiled_plain_matches_jax_and_recurrent(B, S, nh, hd, N,
                                                           chunk, dtype):
    """The tensor-core scan's arithmetic against the JAX model's
    ``ssd_chunked``, ``ssd_chunked_pallas`` (interpret) and the recurrent
    kernel's arithmetic."""
    _tiled_against_references(_ssd_inputs(B, S, nh, hd, N, dtype), chunk,
                              dtype)


@pytest.mark.parametrize("chunk", [1, 4, 32])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssd_chunked_tiled_plain_where_the_decay_underflows(chunk, dtype):
    """mamba2-2.7b's decay range: dt at init (softplus of noise plus the
    inverse softplus of a log-uniform [1e-3, 1e-1] draw) and A down to -80,
    so exp(G) underflows to 0 inside a 64-row tile on the last heads, over
    three tiles, the last one partial."""
    B, S, nh, hd, N = 1, 160, 4, 16, 8
    rng = np.random.default_rng(13)
    dt0 = np.exp(np.log(1e-3) + rng.random(nh) * (np.log(1e-1)
                                                    - np.log(1e-3)))
    (xj, xt), _, _, (bj, bt), (cj, ct) = _ssd_inputs(B, S, nh, hd, N, dtype,
                                                     seed=14)
    dt = _pair(np.logaddexp(rng.standard_normal((B, S, nh))
                            + np.log(np.expm1(dt0)), 0.0))
    A = _pair(np.array([-1.0, -20.0, -60.0, -80.0]))
    tile_decay = float((dt[1].numpy()[0, :64] * A[1].numpy()).sum(0).min())
    assert tile_decay < -104     # exp underflows float32 in the first tile
    _tiled_against_references(((xj, xt), dt, A, (bj, bt), (cj, ct)), chunk,
                              dtype, pallas=chunk > 1)


@pytest.mark.parametrize("chunks", [(32, 64), (1, 16)])
def test_ssd_chunked_plain_chunk_invariance(chunks):
    """Different chunk sizes give the same sequence semantics (the
    sequence is cut at other points; y and the final state stay)."""
    _, (_, dt), (_, A), (_, Bm), (_, Cm) = _ssd_inputs(1, 128, 2, 16, 8,
                                                       jnp.float32, seed=8)
    (_, x), = [_pair(np.random.default_rng(9).standard_normal((1, 128, 2, 16)))]
    (ya, sa), (yb, sb) = (K.ssd_chunked_plain(x, dt, A, Bm, Cm, c)
                          for c in chunks)
    np.testing.assert_allclose(_np(ya), _np(yb), **TOL)
    np.testing.assert_allclose(_np(sa), _np(sb), **TOL)


def test_chunk_halving_rule():
    """The reference's rule, kept: 256 halves until it divides S."""
    assert [_chunk_for(S, 256) for S in (256, 384, 64, 96, 33, 383, 1)] == \
        [256, 128, 64, 32, 1, 1, 1]


def test_ssd_wrapper_rejects_unsupported_devices(monkeypatch):
    """A device that is neither the CPU nor CUDA raises. Meta tensors take
    the shape-only path of a dry run's trace (``kernels/_shape.py``), so
    the check is reached here with that path switched off."""
    from repro_torch.kernels import ssd_chunk
    x = torch.zeros((1, 4, 2, 16), device="meta")
    args = (x, x[..., 0], x[0, 0, :, 0], x[..., 0, :8], x[..., 0, :8], 4)
    y, final = K.ssd_chunked(*args)
    assert y.device.type == "meta" and tuple(final.shape) == (1, 2, 16, 8)
    monkeypatch.setattr(ssd_chunk, "shape_only", lambda *t: False)
    with pytest.raises(ValueError, match="unsupported device"):
        K.ssd_chunked(*args)


# ---------------------------------------------------------------------------
# the tiny Mamba-2 model
# ---------------------------------------------------------------------------

def _tiny_pair():
    return (dataclasses.replace(jax_get_config("mamba2-2.7b").reduced(), **_KW),
            dataclasses.replace(get_config("mamba2-2.7b").reduced(), **_KW))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _tiny_pair()
    jm = JaxModel(jcfg, JaxFlags(dtype=jnp.float32))
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    port = Model(tcfg, RuntimeFlags(dtype=torch.float32))
    return jm, jp, port, tp


def _leaves(jtree, ttree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        t = ttree
        for key in path:
            t = t[key.key]
        yield path, leaf, t


def test_weight_bridge_keeps_the_ssm_tree():
    """bf16 JAX weights convert leaf by leaf: f32 ``A_log``/``D``/
    ``dt_bias``/norm scales stay f32, bf16 weights stay bf16, values
    exact."""
    jcfg, _ = _tiny_pair()
    jp = JaxModel(jcfg, JaxFlags()).init(jax.random.key(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    seen = set()
    for path, leaf, t in _leaves(jp, tp):
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
        np.testing.assert_array_equal(_np(t), np.asarray(leaf, np.float32))
        seen.add((path[-1].key, str(leaf.dtype)))
    assert {("A_log", "float32"), ("D", "float32"), ("dt_bias", "float32"),
            ("w_x", "bfloat16")} <= seen


def test_init_mirrors_jax_ssm_shapes_dtypes_and_values():
    jcfg, tcfg = _tiny_pair()
    shapes = jax.eval_shape(JaxModel(jcfg, JaxFlags()).init, jax.random.key(0))
    gen = torch.Generator().manual_seed(0)
    tp = Model(tcfg, RuntimeFlags()).init(gen)
    for path, leaf, t in _leaves(shapes, tp):
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
    p = tp["blocks"]["ssm"]
    nh = tcfg.ssm.n_heads(tcfg.d_model)
    np.testing.assert_allclose(_np(p["A_log"][0]),
                               np.log(np.arange(1, nh + 1)), rtol=1e-6)
    assert torch.all(p["D"] == 1)
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert torch.all((dt > 0.99e-3) & (dt < 1.01e-1))


@pytest.mark.parametrize("S", [16, 13])
def test_prefill_logits_and_caches_match_jax(models, S):
    """S = 16 runs chunk 16, S = 13 chunk 1 (the halving rule)."""
    jm, jp, port, tp = models
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jm.cfg.vocab_size, size=(2, S)).astype(np.int32)
    jl, (jc, _) = jm.prefill(jp, jnp.asarray(tokens))
    tl_, (tc, _) = port.prefill(tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(tl_), _np(jl), **TOL)
    for key in ("state", "conv"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL)


def test_ragged_decode_steps_match_jax(models):
    """Prefill two rows, then three decode steps at ragged positions (the
    SSM reads none of them) over the prefill's own caches."""
    jm, jp, port, tp = models
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jm.cfg.vocab_size, size=(2, 8)).astype(np.int32)
    _, jcache = jm.prefill(jp, jnp.asarray(tokens))
    _, tcache = port.prefill(tp, torch.from_numpy(tokens))
    pos = np.array([8, 3], np.int32)
    for step in range(3):
        tok = rng.integers(0, jm.cfg.vocab_size, size=2).astype(np.int32)
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos + step))
        tl_, tcache = port.decode_step(tp, tcache, torch.from_numpy(tok),
                                       torch.from_numpy(pos + step))
        np.testing.assert_allclose(_np(tl_), _np(jl), **TOL)
    for key in ("state", "conv"):
        np.testing.assert_allclose(_np(tcache[0][key]), _np(jcache[0][key]),
                                   **TOL)


def test_span_decode_over_slot_arena_matches_jax(models):
    """A decode step through the layer span over a FLAT slot arena of SSM
    leaves (layer k at ``slots + k * n_slots``) with a padding row at the
    out-of-range slot: live rows and every arena row match JAX, whose
    padding scatter drops (the port writes only the live rows)."""
    jm, jp, port, tp = models
    cfg = jm.cfg
    s = cfg.ssm
    n_slots, Lr = 4, cfg.num_layers
    nh, di = s.n_heads(cfg.d_model), s.d_inner(cfg.d_model)
    rng = np.random.default_rng(2)
    state0 = rng.standard_normal((Lr * n_slots, nh, s.head_dim, s.d_state))
    conv0 = rng.standard_normal((Lr * n_slots, s.conv_width - 1,
                                 di + 2 * s.d_state))
    jarena = {"state": jnp.asarray(state0, jnp.float32),
              "conv": jnp.asarray(conv0, jnp.float32)}
    tarena = {"state": torch.tensor(state0, dtype=torch.float32),
              "conv": torch.tensor(conv0, dtype=torch.float32)}
    slots = np.array([2, 0, _PAD_SLOT], np.int32)
    pos = np.array([3, 9, 0], np.int32)
    offs = [k * n_slots for k in range(Lr)]
    layer_bps = port.layer_params(tp)
    for step in range(2):
        x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
        jx, jarena = jm.apply_span_decode(
            jp["blocks"], jnp.asarray(x), jarena, jnp.asarray(pos + step),
            "ssm", offs=jnp.asarray(offs, jnp.int32),
            slots=jnp.asarray(slots))
        tx, tarena = port.apply_span_decode(
            layer_bps, torch.from_numpy(x), tarena,
            torch.from_numpy(pos + step), offs=offs,
            slots=torch.from_numpy(slots), live=2, kind="ssm")
        np.testing.assert_allclose(_np(tx)[:2], _np(jx)[:2], **TOL)
    for key in ("state", "conv"):
        np.testing.assert_allclose(_np(tarena[key]), _np(jarena[key]), **TOL)
