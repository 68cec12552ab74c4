"""Ragged decode attention: the CUDA kernels' wrapper and plain version.

Replaces the TPU kernel ``src/repro/kernels/ragged_decode_attn.py``
(``ragged_decode_attention``). Lazily merged sub-batches have ragged
per-request progress, so row b of one merged decode step attends its own
``lengths[b]`` cached tokens. Four routes, picked by :func:`decode_route`
on dtype and shape alone: bfloat16 at 8 < G <= 16 query heads a kv head
(recurrentgemma-9b's G 16) runs ``ragged_decode_tc_kernel`` on the tensor
cores, bfloat16 at G <= 8 and head dim 64 or 128 (llama3.2-1b,
mistral-nemo-12b, granite-moe-3b-a800m) ``ragged_decode_n8_kernel`` on the
tensor cores, float32 at the same shapes (their exact checks)
``ragged_decode_n8_tf32_kernel`` on the tensor cores as split TF32, every
other call (float32 above 8 heads a group, other head dims)
``ragged_decode_split_kernel`` on the CUDA cores. Source, bound and design
notes: ``csrc/ragged_decode_attn.cu``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from ._shape import record, shape_only


def ragged_decode_attention_plain(q, k, v, lengths, *, slots=None,
                                  ctx: Optional[int] = None):
    """The JAX model's plain decode attention in PyTorch: gather arena row
    ``min(slots[b], N - 1)`` for query row b (row b without ``slots``),
    only its first ``ctx`` time rows when ``ctx`` is given, mask positions
    ``>= lengths[b]``, and attend per KV group with float32 scores, softmax
    and P·V, cast to q.dtype at the end (in float32 it is the JAX path term
    for term).

    q: (B, H, D); k, v: (N, T, KV, D); lengths: (B,) int32. ``ctx`` is a
    static bound with max(lengths) <= ctx: reading fewer rows changes
    nothing but the cost. Returns (B, H, D) in q.dtype."""
    B, H, D = q.shape
    N, T, KV = k.shape[0], k.shape[1], k.shape[2]
    G = H // KV
    if ctx is None or ctx >= T:
        ctx = T
    if slots is None:
        rk, rv = k[:, :ctx], v[:, :ctx]
    else:
        rows = torch.clamp(slots, max=N - 1)
        rk, rv = k[rows, :ctx], v[rows, :ctx]
    qf = q.to(torch.float32).reshape(B, KV, G, D)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bkgd,btkd->bkgt", qf, rk.to(torch.float32)) * scale
    valid = (torch.arange(ctx, device=q.device)[None, :]
             < lengths[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, rv.to(torch.float32))
    return out.reshape(B, H, D).to(q.dtype)


def ragged_decode_cost(q, k, ctx: Optional[int] = None):
    """(flops, bytes) of one call at its static bound: every query row
    reads ``ctx`` (T without it) cached K and V rows once — the lengths
    are data, which a shape-only trace cannot read — q read and the output
    written once, lengths and slots as int32."""
    B, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    span = T if ctx is None else min(ctx, T)
    elt = q.element_size()
    return (4 * H * D * B * span,
            2 * q.numel() * elt + 2 * B * span * KV * D * elt + 8 * B)


def _check(q, k, v, lengths, slots):
    B, H, D = q.shape
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"ragged_decode_attention: k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} must be one (N, T, KV, D) shape")
    KV = k.shape[2]
    if k.shape[3] != D or H % KV != 0:
        raise ValueError(f"ragged_decode_attention: q {tuple(q.shape)} does "
                         f"not fit k {tuple(k.shape)} (H % KV, D)")
    if D not in HEAD_DIMS:
        raise ValueError(f"ragged_decode_attention: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    named = [("k", k), ("v", v), ("lengths", lengths)]
    if slots is not None:
        named.append(("slots", slots))
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"ragged_decode_attention: {name} on "
                             f"{t.device}, q on {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("ragged_decode_attention: q, k, v dtypes differ")
    for name, t in named[2:]:
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError(f"ragged_decode_attention: {name} must be "
                             f"({B},) int32, got {tuple(t.shape)} {t.dtype}")
    for name, t in [("q", q), *named]:
        if not t.is_contiguous():
            raise ValueError(f"ragged_decode_attention: {name} must be "
                             f"contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"ragged_decode_attention: {name} must be "
                             f"16-byte aligned (vector loads)")


HEAD_DIMS = (32, 64, 128, 256)   # the kernel's compiled head dims
H100_SMS = 132              # the grid is planned for the card's SM count
# split spans are multiples of this many rows: one round of a CTA's loads
# at D = 64 in bf16 (4 warps x 4 rows x 8 loads in flight)
SPLIT_GRANULE = 128
MAX_SPLITS = 64             # spans per row (csrc: kMaxSplits)


def split_granule(D: int) -> int:
    """Rows per split granule at head dim ``D``: ``SPLIT_GRANULE`` up to
    D = 128; at D = 256 (a 512-byte bf16 row, one per warp load) 32 rows,
    so that recurrentgemma-9b's single kv head at batch 8 still spreads a
    context of 512 over 128 CTAs and one of 1024 over 256."""
    return SPLIT_GRANULE if D <= 128 else SPLIT_GRANULE * 64 // D


def split_plan(B: int, KV: int, span: int, split_t: Optional[int] = None):
    """``(n_split, split_t)`` of the context split, from static sizes only,
    in granules of ``SPLIT_GRANULE`` rows (see :func:`_plan`)."""
    return _plan(B, KV, span, split_t, SPLIT_GRANULE)


def _plan(B: int, KV: int, span: int, split_t: Optional[int],
          granule: int):
    """``(n_split, split_t)`` of the context split, from static sizes only.

    ``span`` is the static context bound (the engine's ``ctx`` bucket, or
    the arena's T): the kernel's grid is (n_split, KV, B) and CTA s reads
    positions [s * split_t, (s + 1) * split_t) of its row, up to the row's
    length. Without ``split_t`` the span is cut so that the grid covers
    the H100's 132 SMs at least twice, in multiples of ``granule`` rows
    (rounded down, so n_split never falls short of the target), and into
    at most ``MAX_SPLITS`` spans. Nothing here reads ``lengths``: planning
    costs no host sync."""
    span = max(1, int(span))
    if split_t is None:
        want = -(-2 * H100_SMS // max(1, B * KV))   # splits for two waves
        per = -(-span // want)
        split_t = max(granule, per // granule * granule)
        if -(-span // split_t) > MAX_SPLITS:
            split_t = -(-span // (MAX_SPLITS * granule)) * granule
    if split_t <= 0:
        raise ValueError(f"split_plan: split_t must be > 0, got {split_t}")
    n_split = -(-span // split_t)
    if n_split > MAX_SPLITS:
        raise ValueError(f"split_plan: {n_split} spans of {split_t} rows "
                         f"exceed {MAX_SPLITS}")
    return n_split, split_t


# the tensor-core routes (bf16): 8 < G <= 16, and G <= 8
TC_MAX_GROUP = 16           # query heads a kv head: one m16 tile
TC_MAX_CLUSTER = 8          # CTAs a (b, kv) group: a portable cluster
N8_MAX_GROUP = 8            # query heads a kv head: the n8 of the product
N8_HEAD_DIMS = (64, 128)    # the n8 kernel's compiled head dims
N8_CTA_ROWS = 256           # rows a CTA takes at least before a cluster
N8_SM_WARPS = 8             # the plan's wave: warps of n8 CTAs an SM
N8_TF32_CTA_ROWS = 128      # N8_CTA_ROWS for float32 rows, twice as wide
# warps of a float32 n8 CTA at D 64 and 128: its stages are twice bf16's
# (96 KB of rings a CTA at D 64, two CTAs an SM; 192 KB at D 128, one)
N8_TF32_WARPS = 4


def n8_warps(D: int) -> int:
    """Warps of an n8 CTA at head dim ``D``, each walking its own 16-row
    sub-tiles: 8 at D 64, 4 at D 128 (96 KB of rings a CTA either way)."""
    return 8 if D == 64 else 4


def decode_route(dtype, G: int, D: int) -> str:
    """The kernel a CUDA call takes, by dtype and shape alone: ``"tc"``
    (``ragged_decode_tc_kernel``: the G heads of a group an m16 tile, one
    pass over K/V on the tensor cores, spans merged across a cluster) for
    bfloat16 at 8 < G <= 16 and a head dim in ``HEAD_DIMS``; ``"n8"``
    (``ragged_decode_n8_kernel``: the G heads the n8 side of the product,
    16 keys its m16, each warp its own ring and softmax, a cluster merge)
    for bfloat16 at G <= 8 and a head dim in ``N8_HEAD_DIMS``; else
    ``"n8_tf32"`` (``ragged_decode_n8_tf32_kernel``: the n8 layout with
    every product as three TF32 products) for float32 at G <= 8 and a
    head dim in ``N8_HEAD_DIMS``; else ``"cuda_cores"``
    (``ragged_decode_split_kernel``), where a float32 group above 8 heads
    reads each span's K/V once per chunk of 8 heads."""
    if dtype == torch.bfloat16:
        if 8 < G <= TC_MAX_GROUP and D in HEAD_DIMS:
            return "tc"
        if G <= N8_MAX_GROUP and D in N8_HEAD_DIMS:
            return "n8"
    if dtype == torch.float32 and G <= N8_MAX_GROUP and D in N8_HEAD_DIMS:
        return "n8_tf32"
    return "cuda_cores"


def tc_tile_rows(D: int) -> int:
    """Rows of a K/V tile of the tensor-core kernel at head dim ``D``: 32
    at D 256, 64 below (16 or 32 KB of K and V a stage)."""
    return 32 if D == 256 else 64


def tc_plan(B: int, KV: int, D: int, span: int,
            split_t: Optional[int] = None):
    """``(cluster, n_split, split_t)`` of the tensor-core route, from static
    sizes only (no ``lengths``: no host sync).

    The grid is (cluster, KV, B): a cluster of ``cluster`` CTAs per (b, kv)
    group, CTA c walking spans c, c + cluster, ... of ``split_t`` rows
    each, ``n_split`` spans covering ``span``. Without ``split_t`` the
    cluster is as large as one wave of two CTAs an SM allows (at most
    ``TC_MAX_CLUSTER``, at most one CTA per tile of
    :func:`tc_tile_rows` rows of the context), and each CTA takes one span
    of whole tiles. An explicit ``split_t`` is kept; spans past the cluster
    are walked by its CTAs in turn."""
    return _cluster_plan(B, KV, span, split_t, tc_tile_rows(D), "tc_plan")


def n8_plan(B: int, KV: int, D: int, span: int,
            split_t: Optional[int] = None):
    """``(cluster, n_split, split_t)`` of the n8 route, from static sizes
    only (no ``lengths``: no host sync): :func:`tc_plan`'s rule with spans
    of whole rounds of the CTA's warps' 16-row sub-tiles (``16 *
    n8_warps(D)`` rows) in place of the tensor-core kernel's tiles, one
    wave at ``N8_SM_WARPS`` warps an SM in place of two CTAs an SM, and at
    least ``N8_CTA_ROWS`` rows a CTA: below that a cluster merge costs
    more than the rows it moves off the CTA."""
    warps = n8_warps(D)
    return _cluster_plan(B, KV, span, split_t, 16 * warps, "n8_plan",
                         N8_CTA_ROWS, N8_SM_WARPS // warps)


def n8_tf32_plan(B: int, KV: int, D: int, span: int,
                 split_t: Optional[int] = None):
    """``(cluster, n_split, split_t)`` of the float32 n8 route, from static
    sizes only: :func:`n8_plan`'s rule at ``N8_TF32_WARPS`` warps a CTA
    (spans of whole rounds of ``16 * N8_TF32_WARPS`` rows), at
    least ``N8_TF32_CTA_ROWS`` rows a CTA (a float32 row is twice a bf16
    row's bytes), and a cluster that covers one wave at ``N8_SM_WARPS``
    warps an SM at least (rounded up, where n8_plan rounds down: at B 8
    over 32 kv heads two CTAs a group, not one; the CTAs of rows shorter
    than a span exit at once)."""
    return _cluster_plan(B, KV, span, split_t, 16 * N8_TF32_WARPS,
                         "n8_tf32_plan", N8_TF32_CTA_ROWS,
                         N8_SM_WARPS // N8_TF32_WARPS, fill=True)


def _cluster_plan(B: int, KV: int, span: int, split_t: Optional[int],
                  tile: int, who: str, least: int = 1, per_sm: int = 2,
                  fill: bool = False):
    span = max(1, int(span))
    if split_t is None:
        slots = per_sm * H100_SMS     # CTAs a wave; fill: cover it
        groups = max(1, B * KV)
        want = max(1, -(-slots // groups) if fill else slots // groups)
        cluster = max(1, min(TC_MAX_CLUSTER, want, -(-span // tile),
                             -(-span // least)))
        per = -(-span // cluster)
        split_t = -(-per // tile) * tile
    if split_t <= 0:
        raise ValueError(f"{who}: split_t must be > 0, got {split_t}")
    n_split = -(-span // split_t)
    return min(TC_MAX_CLUSTER, n_split), n_split, split_t


def ragged_decode_n8_plain(q, k, v, lengths, *, slots=None,
                           ctx: Optional[int] = None,
                           split_t: Optional[int] = None):
    """The n8 route's arithmetic in plain PyTorch, for the tests only: the
    spans of :func:`n8_plan`, each CTA of a (b, kv) group cutting its spans
    into 16-row sub-tiles dealt to its warps in turn (:func:`n8_warps`),
    each warp one online softmax in base 2 over its sub-tiles (float32
    scores of the widened values times log2(e) / sqrt(D), P as bf16 hi +
    lo in P·V), the warps merged in order, then the CTAs merged online in
    rank order. A row of length 0 gives zeros (as the TPU kernel). Same
    arguments as :func:`ragged_decode_attention`; returns (B, H, D) in
    q.dtype."""
    D = q.shape[2]
    return _mirror(q, k, v, lengths, slots, ctx, n8_plan, split_t, 16,
                   n8_warps(D))


def ragged_decode_n8_tf32_plain(q, k, v, lengths, *, slots=None,
                                ctx: Optional[int] = None,
                                split_t: Optional[int] = None):
    """The float32 n8 route's arithmetic in plain PyTorch, for the tests
    only: the spans of :func:`n8_tf32_plan`, 16-row sub-tiles dealt to
    ``N8_TF32_WARPS`` warps, a softmax in base 2 a warp, the warps'
    and the CTAs' merges in order (as :func:`ragged_decode_n8_plain`), with
    every product as the kernel's three TF32 products: each float32
    operand x (Q, K, P, V) split into hi = tf32(x) and lo = tf32(x - hi),
    TF32 rounding emulated on the int32 view (``(bits + 0x1000) &
    0xffffe000``), each product lo·hi + hi·lo + hi·hi. Same arguments as
    :func:`ragged_decode_attention`; returns (B, H, D) in q.dtype."""
    return _mirror(q, k, v, lengths, slots, ctx, n8_tf32_plan, split_t, 16,
                   N8_TF32_WARPS, tf32=True)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as the kernels round it (tf32.cuh:
    to nearest on the low 13 mantissa bits, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_dot(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` as three TF32 products: lo·hi + hi·lo +
    hi·hi, each operand x split into hi = tf32(x), lo = tf32(x - hi)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def ragged_decode_tc_plain(q, k, v, lengths, *, slots=None,
                           ctx: Optional[int] = None,
                           split_t: Optional[int] = None):
    """The tensor-core route's arithmetic in plain PyTorch, for the tests
    only: the spans of :func:`tc_plan`, each CTA of a (b, kv) group walking
    its spans by tiles of :func:`tc_tile_rows` rows with one online
    softmax in base 2 (float32 scores of the widened values times
    log2(e) / sqrt(D), P as bf16 hi + lo in P·V), then the cluster merge
    of the CTAs' (m, l, O), online in rank order. A row of length 0 gives
    zeros (as the TPU kernel). Same arguments as
    :func:`ragged_decode_attention`; returns (B, H, D) in q.dtype."""
    D = q.shape[2]
    return _mirror(q, k, v, lengths, slots, ctx, tc_plan, split_t,
                   tc_tile_rows(D), 1)


def _mirror(q, k, v, lengths, slots, ctx, plan, split_t, tile: int,
            streams: int, tf32: bool = False):
    """The tensor-core routes' arithmetic: ``plan``'s spans, CTA c of a
    (b, kv) group walking spans c, c + cluster, ... by tiles of ``tile``
    rows dealt in turn to ``streams`` online softmaxes (the CTA's, or each
    warp's), those merged in order, then the CTAs in rank order. The
    products: float32 sums of the widened values for S and P as bf16 hi +
    lo for P·V, or, with ``tf32``, both as three TF32 products."""
    B, H, D = q.shape
    N, T, KV = k.shape[0], k.shape[1], k.shape[2]
    G = H // KV
    span = T if ctx is None else min(ctx, T)
    cluster, n_split, split_t = plan(B, KV, D, span, split_t)
    scale_log2 = math.log2(math.e) / math.sqrt(D)
    rows = (torch.arange(B) if slots is None
            else torch.clamp(slots.long().cpu(), max=N - 1))
    f32 = torch.float32
    out = torch.zeros((B, KV, G, D), dtype=f32, device=q.device)
    bf = lambda x: x.to(torch.bfloat16).to(f32)

    def online(qb, rk, rv, tiles):
        m = torch.full((KV, G), -1e30, dtype=f32, device=q.device)
        l = torch.zeros((KV, G), dtype=f32, device=q.device)
        o = torch.zeros((KV, G, D), dtype=f32, device=q.device)
        for t0, t1 in tiles:
            kt, vt = rk[t0:t1].to(f32), rv[t0:t1].to(f32)   # (n, KV, D)
            if tf32:
                sc = _split_dot("kgd,nkd->kgn", qb, kt) * scale_log2
            else:
                sc = torch.einsum("kgd,nkd->kgn", qb, kt) * scale_log2
            mn = torch.maximum(m, sc.amax(-1))
            corr = torch.exp2(m - mn)
            p = torch.exp2(sc - mn[..., None])
            l = l * corr + p.sum(-1)
            if tf32:
                pv = _split_dot("kgn,nkd->kgd", p, vt)
            else:
                hi = bf(p)
                pv = (torch.einsum("kgn,nkd->kgd", hi, vt)
                      + torch.einsum("kgn,nkd->kgd", bf(p - hi), vt))
            o = o * corr[..., None] + pv
            m = mn
        return m, l, o

    def merge(parts):               # online, in order
        mm = torch.full_like(parts[0][0], -1e30)
        den = torch.zeros_like(mm)
        acc = torch.zeros_like(parts[0][2])
        for pm, pl, po in parts:
            mn = torch.maximum(mm, pm)
            ca, cb = torch.exp2(mm - mn), torch.exp2(pm - mn)
            den = den * ca + pl * cb
            acc = acc * ca[..., None] + po * cb[..., None]
            mm = mn
        return mm, den, acc

    for b in range(B):
        n = max(0, min(int(lengths[b]), span, n_split * split_t))
        qb = q[b].to(f32).reshape(KV, G, D)
        ctas = []
        for c in range(cluster):
            tiles = [(t0, min(t0 + tile, (s + 1) * split_t, n))
                     for s in range(c, n_split, cluster)
                     for t0 in range(s * split_t, min((s + 1) * split_t, n),
                                     tile)]
            ctas.append(merge([online(qb, k[rows[b]], v[rows[b]],
                                      tiles[w::streams])
                               for w in range(streams)]))
        _, den, acc = merge(ctas)
        out[b] = acc / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def tc_info(D: int, route: str = "tc") -> dict:
    """A tensor-core kernel's instantiation at head dim ``D`` (``route``
    "tc", "n8" or "n8_tf32"), read on the card without launching it:
    {"regs", "spill_bytes", "ctas_per_sm", "smem", "clusters_of_8"}
    (registers and local bytes a thread by ``cudaFuncGetAttributes``;
    resident CTAs an SM and clusters of ``TC_MAX_CLUSTER`` CTAs held at
    once by the occupancy calculator; shared memory bytes a CTA)."""
    import ctypes
    info = (ctypes.c_int * 5)()
    err = _build.function("ragged_decode_attn",
                          f"repro_ragged_decode_{route}_info")(
        D, ctypes.addressof(info))
    if err:
        raise RuntimeError(f"tc_info: CUDA error {err} (D={D}, {route})")
    return dict(zip(("regs", "spill_bytes", "ctas_per_sm", "smem",
                     "clusters_of_8"), info))


_COUNTERS = {}              # device -> int32 zeros, one per (b, kv) group


def _counters(device, n: int) -> torch.Tensor:
    """The per-(b, kv) arrival counters of ``device``: zeroed once, grown
    when B * KV grows; every launch leaves the counters it used at 0."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _raise_on(err: int, route: str, B, H, KV, D, N, T, n_split,
              split_t) -> None:
    if err:
        raise RuntimeError(f"ragged_decode_attention: CUDA error {err} at "
                           f"launch ({route} route, B={B}, H={H}, KV={KV}, "
                           f"D={D}, N={N}, T={T}, n_split={n_split}, "
                           f"split_t={split_t})")


def _ptr(slots) -> int:
    """The slot vector's address; 0 without one (the kernels read row b)."""
    return 0 if slots is None else slots.data_ptr()


def _launch_split(q, k, v, lengths, slots, ctx=None, split_t=None):
    """``ragged_decode_split_kernel`` (the CUDA cores) on checked CUDA
    inputs (``slots`` may be None); counts nothing. Returns the output."""
    B, H, D = q.shape
    N, T, KV = k.shape[0], k.shape[1], k.shape[2]
    G = H // KV
    span = T if ctx is None else min(ctx, T)
    n_split, split_t = _plan(B, KV, span, split_t, split_granule(D))
    out = torch.empty_like(q)
    n_part = B * KV * n_split * G if n_split > 1 else 0
    part_acc = torch.empty((n_part * D,), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((n_part * 2,), dtype=torch.float32,
                          device=q.device)
    counters = _counters(q.device, B * KV)
    fn = _build.function("ragged_decode_attn",
                         "repro_ragged_decode_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             _ptr(slots), out.data_ptr(), part_acc.data_ptr(),
             part_ml.data_ptr(), counters.data_ptr(), B, H, KV, D, N, T,
             n_split, split_t, _build.dtype_code(q.dtype),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "cuda_cores", B, H, KV, D, N, T, n_split, split_t)
    return out


_PLANS = {"tc": tc_plan, "n8": n8_plan, "n8_tf32": n8_tf32_plan}


def _launch_tc(q, k, v, lengths, slots, ctx=None, split_t=None,
               route="tc"):
    """``ragged_decode_tc_kernel`` (``route`` "tc") or
    ``ragged_decode_n8_kernel`` ("n8"), bf16 on the tensor cores, or
    ``ragged_decode_n8_tf32_kernel`` ("n8_tf32"), float32 as split TF32,
    on checked CUDA inputs (``slots`` may be None); counts nothing.
    Returns the output."""
    B, H, D = q.shape
    N, T, KV = k.shape[0], k.shape[1], k.shape[2]
    span = T if ctx is None else min(ctx, T)
    plan = _PLANS[route]
    cluster, n_split, split_t = plan(B, KV, D, span, split_t)
    out = torch.empty_like(q)
    fn = _build.function("ragged_decode_attn", f"repro_ragged_decode_{route}")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             _ptr(slots), out.data_ptr(), B, H, KV, D, N, T, span,
             n_split, split_t, cluster,
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, route, B, H, KV, D, N, T, n_split, split_t)
    return out


def _launch_n8(q, k, v, lengths, slots, ctx=None, split_t=None):
    """``ragged_decode_n8_kernel`` (bf16 at G <= 8, the tensor cores) on
    checked CUDA inputs; counts nothing. Returns the output."""
    return _launch_tc(q, k, v, lengths, slots, ctx, split_t, route="n8")


def _launch_n8_tf32(q, k, v, lengths, slots, ctx=None, split_t=None):
    """``ragged_decode_n8_tf32_kernel`` (float32 at G <= 8, the tensor
    cores as split TF32) on checked CUDA inputs; counts nothing. Returns
    the output."""
    return _launch_tc(q, k, v, lengths, slots, ctx, split_t,
                      route="n8_tf32")


def ragged_decode_attention(q, k, v, lengths, *,
                            slots: Optional[torch.Tensor] = None,
                            ctx: Optional[int] = None,
                            split_t: Optional[int] = None):
    """q: (B, H, D); k, v: (N, T, KV, D); lengths: (B,) int32 — row i
    attends to ``k[slots[i], :lengths[i]]`` (``k[i]`` without ``slots``).
    ``ctx`` is a static bound with max(lengths) <= ctx. Returns (B, H, D)
    in q.dtype.

    A CPU tensor takes :func:`ragged_decode_attention_plain`, which reads
    only the first ``ctx`` time rows when that bound is given; a CUDA
    tensor launches, on the current stream, the kernel of the route
    :func:`decode_route` picks, or raises (no route falls back to the
    other). Every kernel splits ``ctx`` (T without it) into spans of
    ``split_t`` rows and stops at each row's length; a bound below a row's
    length would drop its tail, as in the plain version. The CUDA-core
    kernel (float32 above 8 heads a group, other head dims) plans its
    spans as :func:`split_plan` does, in granules of :func:`split_granule`
    rows, one CTA a span; the tensor-core kernels (bf16 at 8 < G <= 16,
    bf16 and float32 at G <= 8) as :func:`tc_plan`, :func:`n8_plan` and
    :func:`n8_tf32_plan` do, a cluster of CTAs per (row, kv head) walking
    the spans. Without ``slots`` the kernels read row b of the stack (no
    slot vector is made). ``launches`` counts every route, ``tc_launches``,
    ``n8_launches`` and ``n8_tf32_launches`` the tensor-core ones.

    Decode is on no loss path and has no gradient: with grad mode on and
    q, k or v requiring grad it raises (on the CPU too), rather than
    return an output that silently cuts the graph."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "ragged_decode_attention: decode attention has no gradient; "
            "an input requires grad — run decode under torch.no_grad()")
    if shape_only(q, k, v, lengths, slots):
        record("ragged_decode_attention",
               *ragged_decode_cost(q, k, ctx))
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return ragged_decode_attention_plain(q, k, v, lengths, slots=slots,
                                             ctx=ctx)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode_attention: unsupported device "
                         f"{q.device}")
    B, H, D = q.shape
    _check(q, k, v, lengths, slots)
    route = decode_route(q.dtype, H // k.shape[2], D)
    if route == "tc":
        out = _launch_tc(q, k, v, lengths, slots, ctx, split_t)
        ragged_decode_attention.tc_launches += 1
    elif route == "n8":
        out = _launch_n8(q, k, v, lengths, slots, ctx, split_t)
        ragged_decode_attention.n8_launches += 1
    elif route == "n8_tf32":
        out = _launch_n8_tf32(q, k, v, lengths, slots, ctx, split_t)
        ragged_decode_attention.n8_tf32_launches += 1
    else:
        out = _launch_split(q, k, v, lengths, slots, ctx, split_t)
    ragged_decode_attention.launches += 1
    return out


ragged_decode_attention.launches = 0      # every launch, any route
ragged_decode_attention.tc_launches = 0   # the tensor-core route's (G > 8)
ragged_decode_attention.n8_launches = 0   # the n8 route's (bf16, G <= 8)
# the float32 n8 route's (G <= 8, split TF32)
ragged_decode_attention.n8_tf32_launches = 0
