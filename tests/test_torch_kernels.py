"""The port's kernels against the JAX package's Pallas kernels and oracles.

On the CPU each wrapper of ``repro_torch.kernels`` takes its plain PyTorch
version; that version is held against the Pallas kernel in interpret mode
(as ``tests/test_kernels.py`` runs it) and against ``repro.kernels.ref``,
over the same shape and dtype sweeps. Inputs are made once with numpy from
a fixed seed and handed to both frameworks with identical values (bf16
inputs are rounded once, on the JAX side, and copied over).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunk_intra as pallas_intra  # noqa: E402
from repro.models.layers import chunked_causal_attention as jax_chunked  # noqa: E402
from repro.models.layers import rms_norm as jax_rms_norm  # noqa: E402
import repro_torch.kernels as K  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rmsnorm import row_stride  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd_tc_heads  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

_PAD_SLOT = 2 ** 30


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(a: np.ndarray, dtype=jnp.float32):
    """(jax array, torch tensor) holding the same values in ``dtype``."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# ragged decode attention
# ---------------------------------------------------------------------------

DECODE_SHAPES = [
    (4, 8, 8, 64, 256),      # MHA
    (4, 8, 2, 64, 256),      # GQA 4:1
    (2, 16, 1, 128, 512),    # MQA, large D
    (3, 6, 3, 32, 128),      # odd sizes
    (3, 16, 1, 256, 256),    # recurrentgemma-9b: MQA at G 16, D 256
]


def _decode_inputs(B, H, KV, D, T, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = _pair(rng.standard_normal((B, H, D)), dtype)
    k = _pair(rng.standard_normal((B, T, KV, D)), dtype)
    v = _pair(rng.standard_normal((B, T, KV, D)), dtype)
    # ragged lengths incl. edge cases: 1, exactly one block, full T
    lens = np.array([1, T // 4 + 3, T // 2, T][:B] + [T // 3] * max(0, B - 4),
                    np.int32)
    return q, k, v, (jnp.asarray(lens), torch.from_numpy(lens))


@pytest.mark.parametrize("B,H,KV,D,T", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ragged_decode_plain_matches_pallas_and_ref(B, H, KV, D, T, dtype):
    (qj, qt), (kj, kt), (vj, vt), (lj, lt) = _decode_inputs(B, H, KV, D, T,
                                                            dtype)
    pallas = ops.ragged_decode_attention(qj, kj, vj, lj, block_t=64,
                                         interpret=True)
    oracle = ref.ragged_decode_attention_ref(qj, kj, vj, lj)
    got = K.ragged_decode_attention(qt, kt, vt, lt)
    assert got.dtype == qt.dtype and got.shape == (B, H, D)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


def test_ragged_decode_ctx_bound_invariance():
    """The static ``ctx`` bound changes what the plain version reads, never
    its result, as long as it covers every row's length."""
    B, H, KV, D, T = 2, 4, 2, 64, 256
    (_, q), (_, k), (_, v), _ = _decode_inputs(B, H, KV, D, T, jnp.float32,
                                               seed=1)
    lengths = torch.tensor([100, 120], dtype=torch.int32)
    slots = torch.tensor([1, 0], dtype=torch.int32)
    outs = [K.ragged_decode_attention(q, k, v, lengths, slots=slots, ctx=c)
            for c in (None, 128, 256, 512)]
    for o in outs[1:]:
        np.testing.assert_array_equal(_np(outs[0]), _np(o))


@pytest.mark.parametrize("B,KV,span", [
    (8, 8, 1024),        # llama3.2-1b decode at the arena's full context
    (1, 8, 1024),        # one long row
    (8, 8, 64),          # short context bucket
    (2, 1, 512),         # MQA
    (3, 3, 100),         # odd sizes
])
def test_ragged_decode_split_plan(B, KV, span):
    """The context split is planned from static sizes: its spans cover the
    context exactly once, are whole granules, and fill the card's SMs twice
    where the context has enough granules for it."""
    from repro_torch.kernels.ragged_decode_attn import (H100_SMS,
                                                        SPLIT_GRANULE,
                                                        split_plan)
    n, st = split_plan(B, KV, span)
    assert (n - 1) * st < span <= n * st
    assert st % SPLIT_GRANULE == 0
    most = -(-span // SPLIT_GRANULE)              # one granule per CTA
    assert n * B * KV >= min(2 * H100_SMS, most * B * KV)
    # a context inside one span is not split
    assert split_plan(B, KV, span, split_t=span) == (1, span)
    assert split_plan(B, KV, span, split_t=2 * span)[0] == 1


def test_ragged_decode_split_plan_reads_no_lengths():
    """The plan takes sizes only, so the wrapper never reads ``lengths``
    on the host (no sync): at the main shape it is (8, 128), 512 CTAs."""
    import inspect
    from repro_torch.kernels.ragged_decode_attn import split_plan
    assert list(inspect.signature(split_plan).parameters) == [
        "B", "KV", "span", "split_t"]
    assert split_plan(8, 8, 1024) == (8, 128)
    assert split_plan(8, 8, 64) == (1, 128)
    assert split_plan(1, 8, 4096) == (32, 128)
    with pytest.raises(ValueError):
        split_plan(8, 8, 64, split_t=0)
    # a long context with few groups stops at MAX_SPLITS spans
    assert split_plan(1, 1, 65536) == (64, 1024)
    with pytest.raises(ValueError):
        split_plan(1, 1, 65536, split_t=32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ragged_decode_slot_indexed_arena_read(dtype):
    """Row i reads arena row slots[i]; a padding row at _PAD_SLOT reads the
    clamped last row, exactly as the JAX engine's clamped slot vector
    drives the Pallas kernel (test_engine_arena.py's slot indirection)."""
    rng = np.random.default_rng(0)
    B, N, T, H, KV, D = 4, 6, 32, 4, 2, 16
    qj, qt = _pair(rng.standard_normal((B, H, D)), dtype)
    kj, kt = _pair(rng.standard_normal((N, T, KV, D)), dtype)
    vj, vt = _pair(rng.standard_normal((N, T, KV, D)), dtype)
    lens = np.array([5, 17, 32, 1], np.int32)
    slots = np.array([4, 0, 2, _PAD_SLOT], np.int32)
    gslots = np.minimum(slots, N - 1)
    pallas = ops.ragged_decode_attention(qj, kj, vj, jnp.asarray(lens),
                                         slots=jnp.asarray(gslots),
                                         block_t=16, interpret=True)
    got = K.ragged_decode_attention(qt, kt, vt, torch.from_numpy(lens),
                                    slots=torch.from_numpy(slots))
    gathered = K.ragged_decode_attention(
        qt, kt[torch.from_numpy(gslots).long()],
        vt[torch.from_numpy(gslots).long()], torch.from_numpy(lens))
    np.testing.assert_array_equal(_np(got), _np(gathered))
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


# the decode route at every attention head shape of the repo's configs (full
# width: bf16 serves, f32 exact checks) and of the tests: (dtype, G, D)
DECODE_ROUTES = [
    (torch.bfloat16, 16, 256, "tc"),           # recurrentgemma-9b serve
    (torch.float32, 16, 256, "cuda_cores"),    # its f32 exact check
    (torch.bfloat16, 4, 64, "n8"),             # llama3.2-1b, reduced()
    (torch.bfloat16, 4, 128, "n8"),            # mistral-nemo-12b
    (torch.bfloat16, 5, 128, "n8"),            # qwen2.5-32b
    (torch.bfloat16, 6, 128, "n8"),            # internvl2-26b, grok-1-314b
    (torch.bfloat16, 3, 64, "n8"),             # granite-moe-3b-a800m
    (torch.bfloat16, 1, 64, "n8"),             # musicgen-large (MHA)
    (torch.bfloat16, 8, 64, "n8"),             # 8 heads: one n8 tile
    (torch.bfloat16, 4, 32, "cuda_cores"),     # no n8 instantiation
    (torch.bfloat16, 4, 256, "cuda_cores"),
    (torch.float32, 4, 128, "n8_tf32"),        # nemo's f32 exact check
    (torch.float32, 3, 64, "n8_tf32"),         # granite's f32 exact check
    (torch.float32, 8, 128, "n8_tf32"),        # 8 heads: one n8 tile
    (torch.float32, 1, 64, "n8_tf32"),         # MHA
    (torch.float32, 4, 32, "cuda_cores"),      # no n8 instantiation
    (torch.float32, 4, 256, "cuda_cores"),
    (torch.float32, 9, 64, "cuda_cores"),      # above one n8 tile
    (torch.bfloat16, 9, 128, "tc"),
    (torch.bfloat16, 12, 64, "tc"),
    (torch.bfloat16, 12, 256, "tc"),
    (torch.bfloat16, 16, 32, "tc"),
    (torch.bfloat16, 16, 64, "tc"),
    (torch.bfloat16, 16, 128, "tc"),
    (torch.bfloat16, 17, 256, "cuda_cores"),   # above one m16 tile
    (torch.bfloat16, 32, 64, "cuda_cores"),
    (torch.bfloat16, 16, 16, "cuda_cores"),    # no compiled head dim
    (torch.float32, 12, 64, "cuda_cores"),
    (torch.float32, 4, 64, "n8_tf32"),         # llama's f32 exact check
    (torch.float16, 16, 256, "cuda_cores"),
    (torch.float16, 4, 64, "cuda_cores"),
]


@pytest.mark.parametrize("dtype,G,D,route", DECODE_ROUTES)
def test_decode_route_by_dtype_and_shape(dtype, G, D, route):
    """bf16 at 8 < G <= 16 and a compiled head dim takes the tensor-core
    kernel, bf16 at G <= 8 and head dim 64 or 128 the n8 kernel, float32
    there the split-TF32 n8 kernel; float32 above 8 heads a group, and
    other head dims, the CUDA-core kernel."""
    assert K.decode_route(dtype, G, D) == route


def test_decode_route_of_every_config():
    """The configs' own heads: recurrentgemma-9b's bf16 decode (G 16, D
    256) takes the tensor-core route, every other dense, MoE and hybrid
    architecture's bf16 decode (G 1 to 6 at D 64 or 128, and every
    reduced() width, G 1 or 4 at D 64) the n8 route; their float32 decode
    (the exact checks) the split-TF32 n8 route, and recurrentgemma-9b's
    float32 decode (G 16) the CUDA cores."""
    from repro_torch.configs import ARCHITECTURES
    routes = {}
    for name, cfg in ARCHITECTURES.items():
        for c in (cfg, cfg.reduced()):
            if c.num_kv_heads and c.mla is None and c.ssm is None:
                G = c.num_heads // c.num_kv_heads
                for dt in (torch.bfloat16, torch.float32):
                    routes[name, c is cfg, dt] = K.decode_route(
                        dt, G, c.head_dim)
    assert {key for key, r in routes.items() if r == "tc"} == {
        ("recurrentgemma-9b", True, torch.bfloat16)}
    assert {key for key, r in routes.items() if r == "n8"} == {
        key for key in routes if key[2] == torch.bfloat16
        and key[:2] != ("recurrentgemma-9b", True)}
    assert {key for key, r in routes.items() if r == "n8_tf32"} == {
        key for key in routes if key[2] == torch.float32
        and key[:2] != ("recurrentgemma-9b", True)}
    assert routes["recurrentgemma-9b", True, torch.float32] == "cuda_cores"


@pytest.mark.parametrize("B,KV,D,span,split_t", [
    (8, 1, 256, 1024, None),     # recurrentgemma-9b serve: arena T 1024
    (3, 1, 256, 256, None),      # the legacy stacks at B 3 and 7
    (7, 1, 256, 256, None),
    (128, 1, 256, 2048, None),   # decode_32k: rings of 2048 at B 128
    (8, 1, 256, 1000, None),     # the card tests' T 1000
    (8, 1, 256, 1000, 32),       # 32 spans walked by 8 CTAs
    (8, 1, 256, 1000, 160),
    (8, 1, 256, 1000, 1024),
    (1, 1, 256, 1, None),
    (2, 3, 64, 100, None),
    (1, 1, 128, 65536, None),
    (4, 1, 64, 70, 8),
    (8, 2, 32, 1000, None),
])
def test_ragged_decode_tc_plan(B, KV, D, span, split_t):
    """The tensor-core route's plan: spans cover the context exactly once,
    an explicit split_t is kept, every cluster is at most 8 CTAs and at
    most the spans, and without split_t the grid fits one wave of two
    CTAs an SM, one span of whole tiles a CTA."""
    from repro_torch.kernels.ragged_decode_attn import (H100_SMS,
                                                        TC_MAX_CLUSTER,
                                                        tc_plan,
                                                        tc_tile_rows)
    cluster, n, st = tc_plan(B, KV, D, span, split_t)
    assert (n - 1) * st < span <= n * st
    assert 1 <= cluster <= TC_MAX_CLUSTER and cluster <= n
    assert cluster == min(TC_MAX_CLUSTER, n)
    if split_t is not None:
        assert st == split_t
    else:
        assert st % tc_tile_rows(D) == 0 and n == cluster
        assert cluster == 1 or B * KV * cluster <= 2 * H100_SMS


def test_ragged_decode_tc_plan_reads_no_lengths():
    """The plan takes sizes only (no host sync): at the rgemma serve's
    arena 8 CTAs a row over spans of 128; at the legacy stacks' 256 rows
    8 of one 32-row tile; at decode_32k's B 128 two."""
    import inspect
    from repro_torch.kernels.ragged_decode_attn import tc_plan
    assert list(inspect.signature(tc_plan).parameters) == [
        "B", "KV", "D", "span", "split_t"]
    assert tc_plan(8, 1, 256, 1024) == (8, 8, 128)
    assert tc_plan(3, 1, 256, 256) == (8, 8, 32)
    assert tc_plan(128, 1, 256, 2048) == (2, 2, 1024)
    assert tc_plan(8, 1, 256, 1000, 32) == (8, 32, 32)
    assert tc_plan(8, 1, 64, 1024) == (8, 8, 128)
    with pytest.raises(ValueError):
        tc_plan(8, 1, 256, 64, split_t=0)


def _tc_case(G, D, T, dtype, seed):
    """B 5 over an arena of N 6: a padding row at _PAD_SLOT, a row of
    length 0, one of length 1, one at T and one in between."""
    rng = np.random.default_rng(seed)
    B, N = 5, 6
    q = _pair(rng.standard_normal((B, G, D)), dtype)
    k = _pair(rng.standard_normal((N, T, 1, D)), dtype)
    v = _pair(rng.standard_normal((N, T, 1, D)), dtype)
    lens = np.array([T, 0, T // 2 + 3, 1, T - 5], np.int32)
    slots = np.array([4, 0, 2, 5, _PAD_SLOT], np.int32)
    return q, k, v, lens, slots


# (G, D, T): G 12 and 16 at D 64 and 256, T no multiple of a tile (64 at
# D 64, 32 at D 256)
TC_CASES = [(12, 64, 100), (16, 64, 100), (12, 256, 70), (16, 256, 70)]


@pytest.mark.parametrize("G,D,T", TC_CASES)
@pytest.mark.parametrize("split_t,ctx", [(None, None), (8, None),
                                         (48, 50)])
def test_ragged_decode_tc_plain_matches_plain(G, D, T, split_t, ctx):
    """The tensor-core route's arithmetic (its spans walked by the CTAs of
    a cluster, tiles, P as bf16 hi + lo, the cluster merge) against the
    plain version in float32 at 1e-5, every row of nonzero length: with
    spans of 8 rows (9 spans of 70 rows over 8 CTAs, so CTA 0 walks two)
    and of 48 (tiles cut by a span's end), and ``ctx`` 50 below a row's
    length. A row of length 0 gives zeros (the plain softmax over no
    position gives the mean of V; the TPU kernel zeros)."""
    (_, q), (_, k), (_, v), lens, slots = _tc_case(G, D, T, jnp.float32,
                                                   seed=G + D)
    lt, st = torch.from_numpy(lens), torch.from_numpy(slots)
    got = K.ragged_decode_tc_plain(q, k, v, lt, slots=st, ctx=ctx,
                                   split_t=split_t)
    want = K.ragged_decode_attention_plain(q, k, v, lt, slots=st, ctx=ctx)
    live = lens > 0
    np.testing.assert_allclose(_np(got)[live], _np(want)[live], rtol=1e-5,
                               atol=1e-5)
    assert not _np(got)[~live].any()


@pytest.mark.parametrize("G,D,T", TC_CASES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ragged_decode_tc_plain_matches_pallas(G, D, T, dtype):
    """The same arithmetic against the Pallas kernel in interpret mode
    (one block of T rows, the clamped slots), at tests/test_kernels.py's
    tolerances, the row of length 0 included (zeros in both)."""
    (qj, qt), (kj, kt), (vj, vt), lens, slots = _tc_case(G, D, T, dtype,
                                                         seed=G * D)
    pallas = ops.ragged_decode_attention(
        qj, kj, vj, jnp.asarray(lens), slots=jnp.asarray(np.minimum(slots,
                                                                    5)),
        block_t=T, interpret=True)
    got = K.ragged_decode_tc_plain(qt, kt, vt, torch.from_numpy(lens),
                                   slots=torch.from_numpy(slots))
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


@pytest.mark.parametrize("B,KV,D,span,split_t,want", [
    (8, 8, 64, 1024, None, (2, 2, 512)),    # the llama and granite serves
    (8, 8, 128, 1024, None, (4, 4, 256)),   # the nemo serve
    (3, 8, 64, 256, None, (1, 1, 256)),     # the legacy stacks at B 3, 7
    (7, 8, 64, 256, None, (1, 1, 256)),
    (128, 8, 64, 32768, None, (1, 1, 32768)),   # decode_32k: a CTA a group
    (1, 8, 64, 1024, None, (4, 4, 256)),    # 256 rows a CTA at least
    (1, 8, 128, 4096, None, (8, 8, 512)),
    (8, 32, 64, 1024, None, (1, 1, 1024)),  # 256 groups: one wave already
    (8, 8, 64, 64, None, (1, 1, 128)),      # one round of sub-tiles
    (8, 8, 128, 64, None, (1, 1, 64)),
    (8, 8, 64, 1000, 16, (8, 63, 16)),      # 63 spans walked by 8 CTAs
    (8, 8, 128, 1000, 48, (8, 21, 48)),
])
def test_ragged_decode_n8_plan(B, KV, D, span, split_t, want):
    """The n8 route's plan, from static sizes only: spans of whole rounds
    of the CTA's warps' 16-row sub-tiles (8 warps at D 64, 4 at D 128), at
    least 256 rows a CTA, a cluster that fits one wave of 8 warps an SM,
    spans covering the context once, an explicit split_t kept."""
    import inspect
    from repro_torch.kernels.ragged_decode_attn import n8_plan, n8_warps
    assert list(inspect.signature(n8_plan).parameters) == [
        "B", "KV", "D", "span", "split_t"]
    assert (n8_warps(64), n8_warps(128)) == (8, 4)
    cluster, n, st = n8_plan(B, KV, D, span, split_t)
    assert (cluster, n, st) == want
    assert (n - 1) * st < span <= n * st
    with pytest.raises(ValueError):
        n8_plan(8, 8, 64, 64, split_t=0)


def _n8_case(H, D, T, dtype, seed):
    """B 5 over an arena of N 6 at eight kv heads: a padding row at
    _PAD_SLOT, a row of length 0, one of length 1, one at T and one in
    between."""
    rng = np.random.default_rng(seed)
    B, N, KV = 5, 6, 8
    q = _pair(rng.standard_normal((B, H, D)), dtype)
    k = _pair(rng.standard_normal((N, T, KV, D)), dtype)
    v = _pair(rng.standard_normal((N, T, KV, D)), dtype)
    lens = np.array([T, 0, T // 2 + 3, 1, T - 5], np.int32)
    slots = np.array([4, 0, 2, 5, _PAD_SLOT], np.int32)
    return q, k, v, lens, slots


# (H, D, T) over eight kv heads: granite's G 3 and llama's G 4 at D 64,
# nemo's G 4 at D 128; T no multiple of a 16-row sub-tile
N8_CASES = [(24, 64, 100), (32, 64, 100), (32, 128, 70)]


@pytest.mark.parametrize("H,D,T", N8_CASES)
@pytest.mark.parametrize("split_t,ctx", [(None, None), (8, None),
                                         (48, 50), (16, None)])
def test_ragged_decode_n8_plain_matches_plain(H, D, T, split_t, ctx):
    """The n8 route's arithmetic (spans walked by the CTAs of a cluster,
    16-row sub-tiles dealt to the warps, a softmax a warp, P as bf16 hi +
    lo, the warps' and the CTAs' merges) against the plain version in
    float32 at 1e-5, every row of nonzero length: planned spans; spans of
    8 rows (sub-tiles cut by a span's end, 13 spans of 100 rows over 8
    CTAs, so CTA 0 walks two); of 48 (``ctx`` 50 below a row's length); of
    16 (one sub-tile a span). A row of length 0 gives zeros."""
    (_, q), (_, k), (_, v), lens, slots = _n8_case(H, D, T, jnp.float32,
                                                   seed=H + D)
    lt, st = torch.from_numpy(lens), torch.from_numpy(slots)
    got = K.ragged_decode_n8_plain(q, k, v, lt, slots=st, ctx=ctx,
                                   split_t=split_t)
    want = K.ragged_decode_attention_plain(q, k, v, lt, slots=st, ctx=ctx)
    live = lens > 0
    np.testing.assert_allclose(_np(got)[live], _np(want)[live], rtol=1e-5,
                               atol=1e-5)
    assert not _np(got)[~live].any()


@pytest.mark.parametrize("H,D,T", N8_CASES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ragged_decode_n8_plain_matches_pallas(H, D, T, dtype):
    """The same arithmetic against the Pallas kernel in interpret mode
    (one block of T rows, the clamped slots), at tests/test_kernels.py's
    tolerances, the row of length 0 included (zeros in both)."""
    (qj, qt), (kj, kt), (vj, vt), lens, slots = _n8_case(H, D, T, dtype,
                                                         seed=H * D)
    pallas = ops.ragged_decode_attention(
        qj, kj, vj, jnp.asarray(lens), slots=jnp.asarray(np.minimum(slots,
                                                                    5)),
        block_t=T, interpret=True)
    got = K.ragged_decode_n8_plain(qt, kt, vt, torch.from_numpy(lens),
                                   slots=torch.from_numpy(slots))
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


def test_ragged_decode_n8_plain_without_slots():
    """Without a slot vector row b of the stack is read, as the kernels
    read a null slot pointer: equal to the same call given slots 0 .. B -
    1, and to the plain version."""
    (_, q), (_, k), (_, v), lens, _ = _n8_case(32, 64, 60, jnp.float32, 3)
    q, lens = q[:5], torch.from_numpy(lens)
    k, v = k[:5], v[:5]
    got = K.ragged_decode_n8_plain(q, k, v, lens)
    same = K.ragged_decode_n8_plain(q, k, v, lens,
                                    slots=torch.arange(5, dtype=torch.int32))
    np.testing.assert_array_equal(_np(got), _np(same))
    live = lens.numpy() > 0
    want = K.ragged_decode_attention_plain(q, k, v, lens)
    np.testing.assert_allclose(_np(got)[live], _np(want)[live], rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# flash prefill attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    (2, 256, 4, 64, None, 0),
    (2, 256, 4, 64, 64, 0),           # sliding window
    (1, 128, 2, 32, None, 128),       # catch-up chunk: q_offset > 0, T > S
    (2, 128, 8, 128, 96, 64),         # window + offset
]


@pytest.mark.parametrize("B,S,H,D,window,q_offset", FLASH_CASES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_plain_matches_pallas_and_ref(B, S, H, D, window, q_offset,
                                            dtype):
    rng = np.random.default_rng(2)
    T = q_offset + S
    qj, qt = _pair(rng.standard_normal((B, S, H, D)), dtype)
    kj, kt = _pair(rng.standard_normal((B, T, H, D)), dtype)
    vj, vt = _pair(rng.standard_normal((B, T, H, D)), dtype)
    pallas = ops.flash_attention(qj, kj, vj, window=window, q_offset=q_offset,
                                 block_q=64, block_k=64, interpret=True)
    oracle = ref.flash_attention_ref(qj, kj, vj, window=window,
                                     q_offset=q_offset)
    got = K.flash_attention(qt, kt, vt, window=window, q_offset=q_offset)
    assert got.dtype == qt.dtype and got.shape == (B, S, H, D)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("KV", [1, 2])
def test_flash_reads_gqa_heads_without_repeat(KV):
    """The port's flash takes KV heads dividing H (query head h reads KV
    head h // (H // KV)); it equals the JAX oracle on repeated heads."""
    rng = np.random.default_rng(4)
    B, S, H, D = 2, 64, 4, 32
    qj, qt = _pair(rng.standard_normal((B, S, H, D)))
    kj, kt = _pair(rng.standard_normal((B, S, KV, D)))
    vj, vt = _pair(rng.standard_normal((B, S, KV, D)))
    oracle = ref.flash_attention_ref(qj, jnp.repeat(kj, H // KV, axis=2),
                                     jnp.repeat(vj, H // KV, axis=2))
    got = K.flash_attention(qt, kt, vt)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("KV", [1, 2])
def test_flash_plain_chunks_gqa_like_jax_chunked_on_repeated_heads(KV):
    """Chunked, with KV heads read by h // G: the JAX model's
    ``chunked_causal_attention`` on heads repeated ``H // KV`` times."""
    rng = np.random.default_rng(5)
    B, S, H, D = 2, 96, 4, 32
    qj, qt = _pair(rng.standard_normal((B, S, H, D)))
    kj, kt = _pair(rng.standard_normal((B, S, KV, D)))
    vj, vt = _pair(rng.standard_normal((B, S, KV, D)))
    got = K.flash_attention_plain(qt, kt, vt, chunk=32)
    want = jax_chunked(qj, jnp.repeat(kj, H // KV, axis=2),
                       jnp.repeat(vj, H // KV, axis=2), chunk=32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_plain_at_head_dim_256_with_a_binding_window(dtype):
    """recurrentgemma-9b's local attention: 16 q heads over one kv head of
    256, a window (48) shorter than the prompt (160) and than the chunk
    (64), so chunks past the first read keys from ``hi - chunk - window``
    on: the JAX model's ``chunked_causal_attention`` on heads repeated 16
    times."""
    rng = np.random.default_rng(9)
    B, S, H, KV, D = 2, 160, 16, 1, 256
    qj, qt = _pair(rng.standard_normal((B, S, H, D)), dtype)
    kj, kt = _pair(rng.standard_normal((B, S, KV, D)), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, KV, D)), dtype)
    got = K.flash_attention(qt, kt, vt, window=48)
    plain = K.flash_attention_plain(qt, kt, vt, window=48, chunk=32)
    want = jax_chunked(qj, jnp.repeat(kj, H, axis=2),
                       jnp.repeat(vj, H, axis=2), window=48, chunk=32)
    assert got.dtype == qt.dtype and tuple(got.shape) == (B, S, H, D)
    np.testing.assert_allclose(_np(plain), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("Dqk,Dv", [(96, 64), (48, 32)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_plain_takes_mla_widths_like_jax_chunked(Dqk, Dv, dtype):
    """MLA's non-absorbed prefill (MiniCPM3's (96, 64), reduced()'s (48,
    32)): q, k at Dqk and v at Dv; the JAX model's
    ``chunked_causal_attention`` scales by 1 / sqrt(Dqk) and returns Dv
    columns, and so does the port."""
    rng = np.random.default_rng(8)
    B, S, H = 2, 96, 4
    qj, qt = _pair(rng.standard_normal((B, S, H, Dqk)), dtype)
    kj, kt = _pair(rng.standard_normal((B, S, H, Dqk)), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, H, Dv)), dtype)
    got = K.flash_attention(qt, kt, vt)
    plain = K.flash_attention_plain(qt, kt, vt, chunk=32)
    want = jax_chunked(qj, kj, vj, chunk=32)
    assert got.dtype == qt.dtype and tuple(got.shape) == (B, S, H, Dv)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(plain), _np(want), **_tol(dtype))


@pytest.mark.parametrize("D,Dv,width", [(64, 64, 64), (32, 32, 32),
                                        (128, 128, 128), (96, 64, 128),
                                        (48, 32, 64), (40, 40, 64),
                                        (256, 256, 256), (136, 64, 256),
                                        (64, 96, None), (60, 60, None),
                                        (264, 64, None), (128, 32, 128)])
def test_flash_kernel_width(D, Dv, width):
    """The kernel's compiled width for q/k width D and v width Dv: the
    smallest of 32, 64, 128 and 256 that holds D; None for what it does
    not take (Dv > D, widths no multiple of 8, D above 256). The V width
    is the C entry's to choose (the bf16 kernel runs (96, 64) at (128, 64)
    and refuses (128, 32), for which it has no instantiation)."""
    assert K.flash_attn.kernel_width(D, Dv) == width


@pytest.mark.parametrize("D,Dv,dtype,heads", [
    (256, 256, torch.bfloat16, 2), (256, 128, torch.bfloat16, 1),
    (128, 128, torch.bfloat16, 2), (256, 256, torch.float32, 2)])
def test_flash_forced_layout_takes_cuda_inputs_only(D, Dv, dtype, heads):
    """The forced-layout entry (one or two q heads a CTA of the bf16 kernel
    at width 256, for comparing the layouts on the card) launches or
    raises: on CPU tensors it raises before any library is built, and it
    never falls back to the plain version."""
    q = torch.zeros((1, 64, 2, D), dtype=dtype)
    v = torch.zeros((1, 64, 2, Dv), dtype=dtype)
    with pytest.raises(ValueError, match="_launch_heads"):
        K.flash_attn._launch_heads(q, q, v, heads)


def _tf32(x):
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest on the low 13 mantissa bits, ties away from zero (the carry
    runs into the exponent), in int32 bit operations."""
    bits = np.asarray(x, np.float32).view(np.int32)
    return ((bits + np.int32(0x1000)) & np.int32(-0x2000)).view(np.float32)


def _tf32_matmul(a, b, three: bool):
    """a @ b as the float32 flash kernel's tensor cores form it, summed in
    float64 and rounded to float32: hi*hi + hi*lo + lo*hi with hi = tf32(x)
    and lo = tf32(x - hi) (``three``), or hi*hi alone (one TF32 product)."""
    ah, bh = _tf32(a), _tf32(b)
    f64 = np.float64
    out = ah.astype(f64) @ bh.astype(f64)
    if three:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        out += ah.astype(f64) @ bl.astype(f64) + al.astype(f64) @ bh.astype(f64)
    return out.astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_flash_f32_split_tf32_keeps_the_f32_tolerance(scale):
    """The float32 flash kernel's numerics budget: attention with both
    products (Q K^T and P V) as three TF32 products lies within the f32
    tolerance (2e-5) of the plain version, one TF32 product does not. A
    llama-like shape (S 128, 4 query heads on one KV head, D 64); q and k
    scaled by ``scale`` (2: scores four times larger)."""
    rng = np.random.default_rng(9)
    B, S, H, D = 1, 128, 4, 64
    q = (rng.standard_normal((B, S, H, D)) * scale).astype(np.float32)
    k = (rng.standard_normal((B, S, 1, D)) * scale).astype(np.float32)
    v = rng.standard_normal((B, S, 1, D)).astype(np.float32)
    want = K.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v)).numpy()
    qh = q[0].transpose(1, 0, 2)                    # (H, S, D)
    kt, vv = k[0, :, 0].T, v[0, :, 0]               # (D, S), (S, D)
    causal = np.tril(np.ones((S, S), bool))

    def emulate(three):
        s = _tf32_matmul(qh, kt, three)             # raw scores, f32
        s = np.where(causal, s, -np.inf)
        p = np.exp((s - s.max(-1, keepdims=True)) / np.sqrt(D))
        p = p.astype(np.float32)
        o = _tf32_matmul(p, vv, three) / p.sum(-1, keepdims=True,
                                                  dtype=np.float64)
        return o.astype(np.float32).transpose(1, 0, 2)[None]

    np.testing.assert_allclose(emulate(True), want, rtol=2e-5, atol=2e-5)
    one = emulate(False)
    assert not np.allclose(one, want, rtol=2e-5, atol=2e-5)
    assert np.abs(one - want).max() > 10 * np.abs(emulate(True) - want).max()


def test_tf32_rounding_ties_away_from_zero():
    """The test helper's rounding: a tie rounds away from zero in both
    signs, a value below the tie truncates, and a carry reaches the
    exponent."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                     # TF32's ulp at 1
    half = np.float32(2.0 ** -11)
    assert _tf32(one + half) == one + ulp
    assert _tf32(-(one + half)) == -(one + ulp)
    below = np.nextafter(one + half, np.float32(0))
    assert _tf32(below) == one
    top = np.float32(2.0) - np.float32(2.0 ** -23)   # all mantissa bits set
    assert _tf32(top) == np.float32(2.0)


def _ssd_tf32_emulate(x, dt, A, Bm, Cm, chunk: int, three: bool = True,
                      factor: bool = True):
    """``ssd_chunk_intra`` as the float32 SSD kernel's split-TF32 route
    forms it, in numpy: per chunk the cumsum of dt·A in order; C·Bᵀ as one
    tensor-core product (``ssd_scores_tf32_kernel``); the decay weights W
    in float32, below the diagonal 64-row tile factored into
    exp(cum_i − cum_i0) · (exp(cum_i0 − cum_j)·dt_j) (``factor``), on it
    exp(cum_i − cum_j)·dt_j where j ≤ i; y = W·x_j and the state
    ((B∘u)ᵀ·x)ᵀ, u = exp(total − cum)·dt, as tensor-core products. Each
    product is three TF32 products (``three``) or one."""
    f32 = np.float32
    Bb, S, nh, hd = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    y = np.zeros_like(x)
    states = np.zeros((Bb, nc, nh, hd, N), f32)
    cum_exp = np.zeros((Bb, S, nh), f32)
    decay = np.zeros((Bb, nc, nh), f32)
    rows = np.arange(chunk)
    i0 = rows // 64 * 64                       # each row's i-tile start
    for b in range(Bb):
        for c in range(nc):
            part = slice(c * chunk, (c + 1) * chunk)
            Bc, Cc = Bm[b, part], Cm[b, part]
            scores = _tf32_matmul(Cc, Bc.T, three)
            for h in range(nh):
                d = dt[b, part, h]
                cum = np.cumsum(d * A[h], dtype=f32)
                ci, cj, c0 = cum[:, None], cum[None, :], cum[i0][:, None]
                causal = rows[None, :] <= rows[:, None]
                below = rows[None, :] < i0[:, None]
                # exponents above the diagonal would overflow: -inf there
                per_entry = np.exp(np.where(causal, ci - cj, -np.inf))
                row_f = np.exp(ci - c0)
                col_f = np.exp(np.where(below, c0 - cj, -np.inf))
                w = np.where(below & factor, scores * row_f * (col_f * d),
                             scores * per_entry * d).astype(f32)
                y[b, part, h] = _tf32_matmul(w, x[b, part, h], three)
                u = (np.exp(cum[-1] - cum) * d).astype(f32)
                st_t = _tf32_matmul((Bc * u[:, None]).T, x[b, part, h], three)
                states[b, c, h] = st_t.T
                cum_exp[b, part, h] = np.exp(cum)
                decay[b, c, h] = np.exp(cum[-1])
    return y, states, cum_exp, decay


def _ssd_f32_inputs(B, S, nh, hd, N, seed):
    """float32 SSD inputs with the model's dt at init (softplus of noise
    plus the inverse softplus of a log-uniform [1e-3, 1e-1] draw per head)
    and A = -(1 ... nh), as ``chip_smoke.py`` makes them."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    dt0 = np.exp(np.log(1e-3) + rng.random(nh) * (np.log(1e-1) - np.log(1e-3)))
    return (rng.standard_normal((B, S, nh, hd)).astype(f32),
            np.logaddexp(rng.standard_normal((B, S, nh))
                         + np.log(np.expm1(dt0)), 0.0).astype(f32),
            -np.arange(1, nh + 1, dtype=f32),
            rng.standard_normal((B, S, N)).astype(f32),
            rng.standard_normal((B, S, N)).astype(f32))


def test_ssd_f32_split_tf32_keeps_the_f32_tolerance():
    """The float32 SSD kernel's numerics budget at mamba2-2.7b's widths
    (hd 64, N 128, chunk 256; four heads): its three products C·Bᵀ, W·x_j
    and (B∘u)ᵀ·x_j as three TF32 products each keep y_intra and the chunk
    states within the f32 tolerance (1e-4) of ``ssd_chunk_intra_plain``,
    with the decay factored below the diagonal tile or not; one TF32
    product does not."""
    inp = _ssd_f32_inputs(1, 256, 4, 64, 128, seed=11)
    want = [t.numpy() for t in
            K.ssd_chunk_intra_plain(*map(torch.from_numpy, inp), 256)]
    for factor in (True, False):
        got = _ssd_tf32_emulate(*inp, 256, factor=factor)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    one = _ssd_tf32_emulate(*inp, 256, three=False)
    assert not np.allclose(one[0], want[0], rtol=1e-4, atol=1e-4)
    three_err = np.abs(_ssd_tf32_emulate(*inp, 256)[0] - want[0]).max()
    assert np.abs(one[0] - want[0]).max() > 10 * three_err


def test_ssd_f32_split_tf32_matches_pallas_intra():
    """The same emulation at a tiny size (two chunks of one 64-row tile)
    against the JAX package's Pallas ``ssd_chunk_intra`` in interpret
    mode, output by output, within 1e-4."""
    inp = _ssd_f32_inputs(1, 128, 2, 64, 32, seed=12)
    want = pallas_intra(*map(jnp.asarray, inp), chunk=64, interpret=True)
    got = _ssd_tf32_emulate(*inp, 64)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)


def test_flash_matches_model_chunked_attention():
    """The plain version is the JAX model's chunked attention (the serving
    path): chunk by chunk it equals ``chunked_causal_attention``, with and
    without a window, and the chunk size changes nothing."""
    rng = np.random.default_rng(3)
    B, S, H, D = 2, 256, 4, 64
    qj, qt = _pair(rng.standard_normal((B, S, H, D)))
    kj, kt = _pair(rng.standard_normal((B, S, H, D)))
    vj, vt = _pair(rng.standard_normal((B, S, H, D)))
    for window in (None, 48):
        a = K.flash_attention(qt, kt, vt, window=window)
        b = K.flash_attention_plain(qt, kt, vt, window=window, chunk=128)
        c = jax_chunked(qj, kj, vj, window=window, chunk=128)
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(_np(b), _np(c), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# fused rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 128), (2, 64, 256), (3, 5, 512)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fused_rmsnorm_plain_matches_pallas_and_ref(shape, dtype):
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng.standard_normal(shape) * 3.0, dtype)
    sj, st = _pair(rng.standard_normal((shape[-1],)))
    pallas = ops.fused_rmsnorm(xj, sj, interpret=True)
    oracle = ref.fused_rmsnorm_ref(xj, sj)
    got = K.fused_rmsnorm(xt, st)
    assert got.dtype == xt.dtype and got.shape == shape
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


def test_fused_rmsnorm_matches_layer():
    rng = np.random.default_rng(6)
    xj, xt = _pair(rng.standard_normal((4, 16, 128)))
    p_j = {"scale": jnp.full((128,), 1.5, jnp.float32)}
    p_t = {"scale": torch.full((128,), 1.5, dtype=torch.float32)}
    a = K.fused_rmsnorm(xt, p_t["scale"], eps=1e-5)
    b = TL.rms_norm(xt, p_t, 1e-5)
    c = jax_rms_norm(xj, p_j, 1e-5)
    np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_allclose(_np(b), _np(c), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,KV,D,span,split_t,want", [
    (8, 8, 64, 1024, None, (4, 4, 256)),    # llama and granite exact
    (8, 8, 128, 1024, None, (4, 4, 256)),   # nemo exact
    (3, 8, 64, 256, None, (2, 2, 128)),     # the legacy stacks at B 3, 7
    (7, 8, 64, 256, None, (2, 2, 128)),
    (128, 8, 64, 32768, None, (1, 1, 32768)),   # a CTA a group
    (1, 8, 64, 1024, None, (8, 8, 128)),    # 128 rows a CTA at least
    (1, 8, 128, 4096, None, (8, 8, 512)),
    (8, 32, 64, 1024, None, (2, 2, 512)),   # 256 groups: two CTAs a group
    (8, 8, 64, 64, None, (1, 1, 64)),       # one round of sub-tiles
    (8, 8, 128, 40, None, (1, 1, 64)),
    (8, 8, 64, 1000, 16, (8, 63, 16)),      # 63 spans walked by 8 CTAs
    (8, 8, 128, 1000, 48, (8, 21, 48)),
])
def test_ragged_decode_n8_tf32_plan(B, KV, D, span, split_t, want):
    """The float32 n8 route's plan, from static sizes only: spans of whole
    rounds of the CTA's warps' 16-row sub-tiles (4 warps), at least 128
    rows a CTA, a cluster that covers one wave of 8 warps an SM (rounded
    up), spans covering the context once, an explicit split_t kept."""
    import inspect
    from repro_torch.kernels.ragged_decode_attn import (N8_TF32_WARPS,
                                                        n8_tf32_plan)
    assert list(inspect.signature(n8_tf32_plan).parameters) == [
        "B", "KV", "D", "span", "split_t"]
    assert N8_TF32_WARPS == 4
    cluster, n, st = n8_tf32_plan(B, KV, D, span, split_t)
    assert (cluster, n, st) == want
    assert (n - 1) * st < span <= n * st
    with pytest.raises(ValueError):
        n8_tf32_plan(8, 8, 64, 64, split_t=0)


def test_tf32_rounding_is_the_kernels():
    """The mirror's TF32 rounding is cvt.rna.tf32.f32's: to nearest with
    10 mantissa bits, ties away from zero, on the int32 view; x = hi + lo
    leaves a residual below 2^-21 |x|."""
    from repro_torch.kernels.ragged_decode_attn import _tf32
    rng = np.random.default_rng(5)
    x = rng.standard_normal(4096).astype(np.float32) * np.float32(
        2.0) ** rng.integers(-20, 20, 4096).astype(np.float32)
    ties = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                     2 ** -11, 0.0, -0.0], np.float32)
    x = np.concatenate([x, ties])
    got = _np(_tf32(torch.from_numpy(x)))
    m, e = np.frexp(x.astype(np.float64))      # |m| in [0.5, 1)
    scaled = m * 2 ** 11
    want = np.ldexp(np.sign(scaled) * np.floor(np.abs(scaled) + 0.5), e - 11)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_array_equal(got[-6:], [1 + 2 ** -10, -(1 + 2 ** -10),
                                             1 + 2 ** -9, 2 ** -11, 0, 0])
    lo = _np(_tf32(torch.from_numpy(x - got)))
    resid = np.abs(x.astype(np.float64) - got - lo)
    assert (resid <= 2.0 ** -21 * np.abs(x)).all()


@pytest.mark.parametrize("H,D,T", N8_CASES)
@pytest.mark.parametrize("split_t,ctx", [(None, None), (8, None),
                                         (48, 50), (16, None)])
def test_ragged_decode_n8_tf32_plain_matches_plain(H, D, T, split_t, ctx):
    """The float32 n8 route's arithmetic (its plan's spans walked by the
    CTAs of a cluster, 16-row sub-tiles dealt to 4 warps, a softmax a
    warp, every product as three TF32 products, the warps' and the CTAs'
    merges) against the plain version in float32 at 1e-5, every row of
    nonzero length: planned spans; spans of 8 rows (13 spans of 100 rows
    over 8 CTAs); of 48 (``ctx`` 50 below a row's length); of 16 (one
    sub-tile a span). A row of length 0 gives zeros."""
    (_, q), (_, k), (_, v), lens, slots = _n8_case(H, D, T, jnp.float32,
                                                   seed=H + D + 1)
    lt, st = torch.from_numpy(lens), torch.from_numpy(slots)
    got = K.ragged_decode_n8_tf32_plain(q, k, v, lt, slots=st, ctx=ctx,
                                        split_t=split_t)
    want = K.ragged_decode_attention_plain(q, k, v, lt, slots=st, ctx=ctx)
    assert got.dtype == torch.float32
    live = lens > 0
    np.testing.assert_allclose(_np(got)[live], _np(want)[live], rtol=1e-5,
                               atol=1e-5)
    assert not _np(got)[~live].any()


@pytest.mark.parametrize("H,D,T", N8_CASES)
def test_ragged_decode_n8_tf32_plain_matches_pallas(H, D, T):
    """The same arithmetic against the Pallas kernel in interpret mode
    (one block of T rows, the clamped slots) in float32 at 2e-5, the row
    of length 0 included (zeros in both)."""
    (qj, qt), (kj, kt), (vj, vt), lens, slots = _n8_case(H, D, T,
                                                         jnp.float32,
                                                         seed=H * D + 1)
    pallas = ops.ragged_decode_attention(
        qj, kj, vj, jnp.asarray(lens), slots=jnp.asarray(np.minimum(slots,
                                                                    5)),
        block_t=T, interpret=True)
    got = K.ragged_decode_n8_tf32_plain(qt, kt, vt, torch.from_numpy(lens),
                                        slots=torch.from_numpy(slots))
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=2e-5, atol=2e-5)


def test_ragged_decode_n8_tf32_plain_without_slots():
    """Without a slot vector row b of the stack is read, as the kernel
    reads a null slot pointer: equal to the same call given slots 0 .. B -
    1, and to the plain version."""
    (_, q), (_, k), (_, v), lens, _ = _n8_case(32, 128, 60, jnp.float32, 4)
    lens = torch.from_numpy(lens)
    k, v = k[:5], v[:5]
    got = K.ragged_decode_n8_tf32_plain(q, k, v, lens)
    same = K.ragged_decode_n8_tf32_plain(
        q, k, v, lens, slots=torch.arange(5, dtype=torch.int32))
    np.testing.assert_array_equal(_np(got), _np(same))
    live = lens.numpy() > 0
    want = K.ragged_decode_attention_plain(q, k, v, lens)
    np.testing.assert_allclose(_np(got)[live], _np(want)[live], rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# wrappers: CPU dispatch, launch counters, build plumbing
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    K.reset_launch_counts()
    x = torch.randn(4, 64)
    K.fused_rmsnorm(x, torch.ones(64))
    q = torch.randn(2, 4, 32)
    kv = torch.randn(2, 16, 2, 32)
    K.ragged_decode_attention(q, kv, kv, torch.tensor([3, 16],
                                                      dtype=torch.int32))
    K.flash_attention(torch.randn(1, 8, 4, 32), torch.randn(1, 8, 2, 32),
                      torch.randn(1, 8, 2, 32))
    K.ssd_chunked(torch.randn(1, 8, 2, 16), torch.rand(1, 8, 2),
                  -torch.rand(2), torch.randn(1, 8, 4), torch.randn(1, 8, 4), 4)
    assert K.launch_counts() == {"ragged_decode_attention": 0,
                                 "ragged_decode_attention_tc": 0,
                                 "ragged_decode_attention_n8": 0,
                                 "ragged_decode_attention_n8_tf32": 0,
                                 "fused_rmsnorm": 0, "flash_attention": 0,
                                 "ssd_chunked": 0, "ssd_chunked_tc": 0,
                                 "ssd_chunked_tf32": 0,
                                 "ssd_chunked_recurrent": 0,
                                 "ssd_chunked_tc_scan": 0}


@pytest.mark.parametrize("dtype,chunk,hd,N,route", [
    (torch.bfloat16, 64, 64, 128, "tc"),
    (torch.bfloat16, 128, 64, 128, "tc"),
    (torch.bfloat16, 256, 64, 128, "tc"),       # the mamba2-2.7b serve's
    (torch.bfloat16, 256, 64, 32, "tc"),
    (torch.float32, 256, 64, 128, "tf32"),      # the mamba2-2.7b exact
    (torch.float32, 64, 64, 128, "tf32"),       # check's, and chunk 64
    (torch.float32, 128, 64, 128, "tf32"),
    (torch.float32, 256, 64, 32, "tf32"),
    (torch.float32, 64, 64, 64, "tf32"),
    (torch.float32, 200, 64, 128, "cuda_cores"),
    (torch.float32, 256, 32, 128, "cuda_cores"),
    (torch.float32, 256, 64, 256, "cuda_cores"),
    (torch.bfloat16, 1, 64, 128, "tc_scan"),     # odd prefill length
    (torch.bfloat16, 32, 64, 128, "tc_scan"),
    (torch.float32, 1, 64, 128, "recurrent"),    # mamba exact's chunk 1
    (torch.bfloat16, 63, 64, 128, "recurrent"),  # divides no tile
    (torch.float32, 2, 128, 256, "recurrent"),
    (torch.bfloat16, 200, 64, 128, "cuda_cores"),
    (torch.bfloat16, 256, 32, 128, "cuda_cores"),
    (torch.bfloat16, 256, 64, 256, "cuda_cores"),
    (torch.float32, 32, 64, 128, "recurrent"),   # train mamba's chunk 32
    (torch.bfloat16, 3, 64, 128, "recurrent"),
    (torch.bfloat16, 1, 32, 128, "recurrent"),   # other hd and N
    (torch.bfloat16, 2, 128, 64, "recurrent"),
    (torch.bfloat16, 1, 64, 256, "recurrent"),
])
def test_ssd_route_by_dtype_and_shape(dtype, chunk, hd, N, route):
    """Chunks below 64 that divide 64 take the tensor-core scan in bf16 at
    hd 64, N 32, 64 or 128, every other chunk below 64 the recurrent
    kernel; chunks of whole 64-row tiles (hd 64, N 32, 64 or 128) the
    tensor-core kernel in bf16 and the split-TF32 kernel in float32; every
    other shape the CUDA cores."""
    assert K.ssd_route(dtype, chunk, hd, N) == route


@pytest.mark.parametrize("chunk", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("N", [32, 64, 128])
def test_ssd_tc_scan_takes_every_halved_chunk(chunk, N):
    """Every chunk the halving rule from 256 gives below 64, at hd 64 and
    each tensor-core state size: the tensor-core scan in bf16, the
    recurrent kernel in float32."""
    assert K.ssd_route(torch.bfloat16, chunk, 64, N) == "tc_scan"
    assert K.ssd_route(torch.float32, chunk, 64, N) == "recurrent"


@pytest.mark.parametrize("Bb,S,nh,chunk,heads", [
    (1, 256, 80, 256, 2),      # mamba2-2.7b prefills: 160 two-head CTAs
    (1, 384, 80, 128, 2),      # 240
    (1, 128, 80, 128, 1),      # 80 two-head CTAs would leave SMs idle
    (1, 64, 80, 64, 1),        # 40
    (2, 256, 5, 64, 1),
])
def test_ssd_tc_heads_per_cta(Bb, S, nh, chunk, heads):
    """Two heads per CTA when that grid still covers the card's 132 SMs,
    for the bf16 and the split-TF32 kernels alike."""
    assert ssd_tc_heads(Bb, S, nh, chunk, 132) == heads


def test_build_sources_and_dtype_codes():
    assert list(_build.sources()) == ["flash_attn", "ragged_decode_attn",
                                      "rmsnorm", "ssd_chunk"]
    assert set(_build.SIGNATURES) == set(_build.sources())
    assert set(_build.SIGNATURES["ssd_chunk"]) == {
        "repro_ssd_chunk", "repro_ssd_chunk_tc", "repro_ssd_chunk_tf32",
        "repro_ssd_chunk_recurrent", "repro_ssd_chunk_tc_scan",
        "repro_ssd_tc_scan_info"}
    assert set(_build.SIGNATURES["rmsnorm"]) == {"repro_rmsnorm"}
    for name in _build.sources():
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name == f"lib{name}.so"
    assert _build.dtype_code(torch.float32) == 0
    assert _build.dtype_code(torch.bfloat16) == 1
    with pytest.raises(TypeError):
        _build.dtype_code(torch.float16)


def _c_entries(source):
    """{symbol: [parameter declaration, ...]} of every ``extern "C"``
    function defined in ``source``."""
    import re
    text = re.sub(r"//[^\n]*", "", source.read_text())
    found = {}
    for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', text):
        found[m.group(1)] = [p.strip() for p in m.group(2).split(",")]
    return found


def _c_kind(decl):
    """The ctypes type a C parameter declaration crosses as."""
    import ctypes
    if "*" in decl:
        return ctypes.c_void_p
    words = decl.replace("const", " ").split()
    return {"int": ctypes.c_int, "float": ctypes.c_float}[words[0]]


@pytest.mark.parametrize("name", ["flash_attn", "ragged_decode_attn",
                                  "rmsnorm", "ssd_chunk"])
def test_signatures_match_the_c_declarations(name):
    """Every ``_build.SIGNATURES`` entry has the count and the kinds of its
    ``extern "C"`` declaration's parameters (pointer <-> c_void_p, int <->
    c_int, float <-> c_float), and every C entry of the source is listed."""
    entries = _c_entries(_build.CSRC / f"{name}.cu")
    sigs = _build.SIGNATURES[name]
    assert set(entries) == set(sigs)
    for symbol, params in entries.items():
        assert [_c_kind(p) for p in params] == sigs[symbol], symbol


@pytest.mark.parametrize("make,stride", [
    (lambda t: t, 32),                              # contiguous (2, 3, 32)
    (lambda t: t[:, -1], 96),                       # the prefill's x[:, -1]
    (lambda t: t[:, 1], 96),
    (lambda t: t[:1, :2], 32),                      # leading slices that
    (lambda t: t[:, :1], 96),                       # still collapse
    (lambda t: t[:, 1:], None),                     # (2, 2, 32) no longer
    (lambda t: t[..., ::2], None),                  # a strided last axis
    (lambda t: t.transpose(0, 1), None),
    (lambda t: t[:, :, :1], 32),                    # D == 1
    (lambda t: t[0, 0].expand(4, 32), 0),           # one row read 4 times
])
def test_rmsnorm_row_stride(make, stride):
    """The kernel's row stride of a view, or None where its rows do not
    sit at one stride with a contiguous last axis."""
    x = torch.zeros(2, 3, 32)
    assert row_stride(make(x)) == stride


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rms_norm_layer_on_a_strided_view(dtype):
    """``layers.rms_norm`` of ``x[:, -1]`` (the prefill's final norm, read
    in place on the card) against the JAX layer on the same rows."""
    rng = np.random.default_rng(7)
    xj, xt = _pair(rng.standard_normal((3, 5, 96)) * 2.0, dtype)
    sj, st = _pair(rng.standard_normal((96,)))
    view = xt[:, -1]
    assert not view.is_contiguous() and row_stride(view) == 5 * 96
    got = TL.rms_norm(view, {"scale": st}, 1e-5)
    want = jax_rms_norm(xj[:, -1], {"scale": sj}, 1e-5)
    assert got.shape == (3, 96) and got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


# ---------------------------------------------------------------------------
# gradients: the autograd Functions, with their plain forwards on the CPU
# ---------------------------------------------------------------------------

def _grads(fn, inputs, upstream):
    """Gradients of ``sum(fn(*inputs) * upstream)`` w.r.t. every input, on
    fresh leaves."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is not None
    torch.autograd.backward(out, upstream)
    return out, [t.grad for t in leaves]


# (B, S, T, H, KV, Dqk, Dv, window, q_offset)
FLASH_GRAD_CASES = [
    (2, 16, 16, 4, 2, 32, 32, None, 0),    # GQA 2:1
    (1, 24, 24, 4, 1, 64, 64, 8, 0),       # MQA with a sliding window
    (2, 8, 20, 2, 2, 32, 32, None, 12),    # catch-up chunk: T > S
    (1, 16, 16, 4, 4, 96, 64, None, 0),    # MLA's q/k 96 and v 64
]


@pytest.mark.parametrize("B,S,T,H,KV,D,Dv,window,q_offset", FLASH_GRAD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_backward_matches_autograd_of_plain(
        B, S, T, H, KV, D, Dv, window, q_offset, dtype):
    rng = np.random.default_rng(S + T + D)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  .to(dtype) for s in ((B, S, H, D), (B, T, KV, D),
                                       (B, T, KV, Dv), (B, S, H, Dv)))
    kw = dict(window=window, q_offset=q_offset)
    out, got = _grads(lambda *a: K.flash_attention(*a, **kw), (q, k, v), g)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    _, want = _grads(lambda *a: K.flash_attention_plain(*a, **kw), (q, k, v),
                     g)
    tol = _tol(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        np.testing.assert_allclose(_np(a), _np(b), **tol)


@pytest.mark.parametrize("make", [
    lambda r: r((8, 128)),
    lambda r: r((2, 6, 64)),
    lambda r: r((3, 5, 64))[:, -1],          # rows at a stride
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_function_backward_matches_autograd_of_plain(make, dtype):
    rng = np.random.default_rng(5)
    r = lambda s: torch.from_numpy(
        (rng.standard_normal(s) * 3).astype(np.float32)).to(dtype)
    x = make(r)
    scale = torch.from_numpy(rng.standard_normal(x.shape[-1]).astype(
        np.float32))
    g = r(x.shape)
    out, got = _grads(K.fused_rmsnorm, (x, scale), g)
    assert type(out.grad_fn).__name__ == "FusedRMSNormBackward"
    _, want = _grads(K.fused_rmsnorm_plain, (x, scale), g)
    tol = _tol(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **tol)


@pytest.mark.parametrize("S,chunk", [(128, 64), (128, 128), (48, 16),
                                     (9, 1)])
def test_ssd_function_backward_matches_autograd_of_plain(S, chunk):
    """Chunks of 64 and up recompute through ``ssd_chunked_plain``, those
    below through ``ssd_chunked_recurrent_plain``; both against autograd
    through ``ssd_chunked_plain``, in float32 (tolerance 1e-4)."""
    rng = np.random.default_rng(S + chunk)
    nh, hd, N = 3, 16, 8
    x = torch.from_numpy(rng.standard_normal((2, S, nh, hd)).astype(
        np.float32))
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (2, S, nh)).astype(
        np.float32))
    A = -torch.arange(1, nh + 1, dtype=torch.float32)
    Bm, Cm = (torch.from_numpy(rng.standard_normal((2, S, N)).astype(
        np.float32)) for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((2, S, nh, hd)).astype(
        np.float32))
    fn = lambda *a: K.ssd_chunked(*a, chunk)
    out, got = _grads(fn, (x, dt, A, Bm, Cm), g)
    assert type(out.grad_fn).__name__ == "SSDChunkedBackward"
    _, want = _grads(lambda *a: K.ssd_chunked_plain(*a, chunk),
                     (x, dt, A, Bm, Cm), g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4)


def test_no_wrapper_cuts_the_graph_under_grad():
    """Under grad every wrapper's output has a grad_fn or the wrapper
    raises (decode); with grad off they take the direct path."""
    x = torch.randn(4, 32, requires_grad=True)
    assert K.fused_rmsnorm(x, torch.ones(32)).grad_fn is not None
    q = torch.randn(1, 8, 2, 32, requires_grad=True)
    assert K.flash_attention(q, q.detach(), q.detach()).grad_fn is not None
    y, final = K.ssd_chunked(torch.randn(1, 8, 2, 16), torch.rand(1, 8, 2),
                             -torch.rand(2, requires_grad=True),
                             torch.randn(1, 8, 4), torch.randn(1, 8, 4), 4)
    assert y.grad_fn is not None and not final.requires_grad
    qd = torch.randn(2, 4, 32, requires_grad=True)
    kv = torch.randn(2, 16, 2, 32)
    lengths = torch.tensor([3, 16], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no gradient"):
        K.ragged_decode_attention(qd, kv, kv, lengths)
    with torch.no_grad():
        assert K.ragged_decode_attention(qd, kv, kv, lengths).grad_fn is None
        assert K.fused_rmsnorm(x, torch.ones(32)).grad_fn is None
