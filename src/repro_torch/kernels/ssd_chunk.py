"""Mamba-2 SSD chunked scan: the CUDA kernels' wrapper and plain versions.

Replaces the TPU kernel ``src/repro/kernels/ssd_chunk.py``
(``ssd_chunk_intra`` and its wrapper ``ssd_chunked_pallas``): per
(batch, chunk, head) the within-chunk decay cumsum, the causal decay
matrix, ``C·Bᵀ``, ``y_intra``, the chunk state, ``exp(cum)`` and
``exp(total)``; then the inter-chunk state recurrence and ``y_inter``.
The SSM prefill of every layer runs it. Five routes, picked by dtype and
shape alone (:func:`ssd_route`): at head dim 64 and state 32, 64 or 128,
bfloat16 chunks below 64 that divide 64 on the tensor-core scan (64-row
tiles with the state carried from tile to tile); every other chunk below
64 on the recurrent kernel; chunks of whole 64-row tiles at head dim 64
and state 32, 64 or 128 on the tensor cores, in bfloat16 directly and in
float32 as split TF32 (three TF32 products per product); the rest (odd
long chunks, other head dims and states) on the CUDA cores. Source, bound
and design notes: ``csrc/ssd_chunk.cu``.

Under autograd (grad mode on and x, dt, A, B or C requiring grad) the call
goes through :class:`SSDChunked`: the kernels' forward, and the gradient
of the plain version at the same inputs as its backward (the JAX package
has no backward kernel).
"""
from __future__ import annotations

import functools

import torch

from . import _build
from ._shape import record, shape_only
from ._vjp import plain_vjp

HEAD_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 256
MAX_STATE = 256
# the tensor-core routes' shapes (bf16 and split-TF32 f32): chunks of whole
# 64-row tiles, hd 64
TC_ROWS = 64
TC_HEAD_DIM = 64
TC_STATES = (32, 64, 128)
# the recurrent route's chunks: every one below a tensor-core tile
RECURRENT_BELOW = 64


def _chunked(x, dt, B_ssm, C_ssm, chunk: int):
    Bb, S, nh, hd = x.shape
    N = B_ssm.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd: sequence length S={S} must be a multiple of "
                         f"chunk={chunk}")
    nc = S // chunk
    return (x.reshape(Bb, nc, chunk, nh, hd), dt.reshape(Bb, nc, chunk, nh),
            B_ssm.reshape(Bb, nc, chunk, N), C_ssm.reshape(Bb, nc, chunk, N))


def _exp(t):
    """exp. On the CPU that of a float32 tensor is taken in float64 and
    rounded once: there ``torch.exp`` of float32 calls MKL's vector math
    on several threads, and on an AVX-512 host it has returned about 1,840
    of the 32,768 entries of a fresh process's L at (2, 4, 32, 32, 4)
    (:func:`_decay_terms`) about 1e-4 off, none with ``MKL_NUM_THREADS=1``
    (``tools/cpu_exp_check.py``)."""
    if t.device.type == "cpu" and t.dtype == torch.float32:
        return torch.exp(t.double()).to(torch.float32)
    return torch.exp(t)


def _decay_terms(dtc, A, chunk: int):
    """cum (B, nc, cs, nh), total (B, nc, nh) and the causal decay matrix
    L (B, nc, i, j, nh) = exp(cum_i - cum_j) where j <= i, else 0. The
    mask is applied before the exp: above the diagonal cum_i - cum_j > 0
    can overflow to inf (at mamba2-2.7b's widths it does), and a masked
    inf would make the gradient NaN (0 * inf); exp(-inf) is the same 0."""
    cum = torch.cumsum(dtc * A[None, None, None, :], dim=2)
    total = cum[:, :, -1]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=dtc.device))
    masked = torch.where(mask[None, None, :, :, None], diff,
                         torch.full((), -torch.inf, dtype=diff.dtype,
                                    device=diff.device))
    return cum, total, _exp(masked)


def ssd_chunk_intra_plain(x, dt, A, B_ssm, C_ssm, chunk: int):
    """The Pallas kernel ``ssd_chunk_intra`` in plain PyTorch, term for
    term: every cell in float32, ``y_intra`` cast to x.dtype. In float32
    these are the terms the CUDA intra-chunk kernel computes; in bfloat16
    that kernel rounds as :func:`ssd_chunked_plain` does.

    x: (B, S, nh, hd); dt: (B, S, nh) post-softplus; A: (nh,) negative;
    B_ssm, C_ssm: (B, S, N). Returns (y_intra (B, S, nh, hd),
    states (B, nc, nh, hd, N), cum_exp (B, S, nh), decay (B, nc, nh))."""
    Bb, S, nh, hd = x.shape
    xc, dtc, Bc, Cc = _chunked(x, dt, B_ssm, C_ssm, chunk)
    xc, dtc = xc.to(torch.float32), dtc.to(torch.float32)
    Bc, Cc = Bc.to(torch.float32), Cc.to(torch.float32)
    cum, total, L = _decay_terms(dtc, A.to(torch.float32), chunk)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    w = scores[..., None] * L * dtc[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    xw = xc * (torch.exp(total[:, :, None, :] - cum) * dtc)[..., None]
    states = torch.einsum("bcjhp,bcjn->bchpn", xw, Bc)
    return (y.reshape(Bb, S, nh, hd).to(x.dtype), states,
            torch.exp(cum).reshape(Bb, S, nh), torch.exp(total))


def _y_inter(C_ssm, cum_exp, h_prev, chunk: int, dtype):
    """(C_i · exp(cum_i)) · h_prevᵀ per chunk: the contribution of the
    state entering each chunk, (B, S, nh, hd) in ``dtype``."""
    Bb, S, nh = cum_exp.shape
    nc = S // chunk
    Cc = C_ssm.reshape(Bb, nc, chunk, -1)
    Ci = Cc[:, :, :, None, :] * cum_exp.reshape(Bb, nc, chunk, nh)[..., None]
    y = torch.einsum("bcihn,bchpn->bcihp", Ci.to(torch.float32), h_prev)
    return y.to(dtype).reshape(Bb, S, nh, -1)


def ssd_chunked_plain(x, dt, A, B_ssm, C_ssm, chunk: int):
    """The JAX model's ``ssd_chunked`` (``src/repro/models/ssm.py``) in
    plain PyTorch, term for term; its associative scan over chunks is a
    sequential loop here. Returns (y (B, S, nh, hd), final state
    (B, nh, hd, N) float32)."""
    Bb, S, nh, hd = x.shape
    xc, dtc, Bc, Cc = _chunked(x, dt, B_ssm, C_ssm, chunk)
    cum, total, L = _decay_terms(dtc, A, chunk)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    w = scores[..., None] * L * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w.to(x.dtype), xc)
    xw = xc * (torch.exp(total[:, :, None, :] - cum) * dtc)[..., None]
    states = torch.einsum("bcjhp,bcjn->bchpn", xw, Bc.to(xw.dtype))
    decay = torch.exp(total).to(torch.float32)
    states = states.to(torch.float32)
    run = states[:, 0]
    scanned = [run]
    for c in range(1, states.shape[1]):
        run = run * decay[:, c, :, None, None] + states[:, c]
        scanned.append(run)
    st_s = torch.stack(scanned, dim=1)
    h_prev = torch.cat([torch.zeros_like(st_s[:, :1]), st_s[:, :-1]], dim=1)
    y = y_intra.reshape(Bb, S, nh, hd) + _y_inter(
        C_ssm, torch.exp(cum).reshape(Bb, S, nh), h_prev, chunk, x.dtype)
    return y, st_s[:, -1]


def ssd_chunked_recurrent_plain(x, dt, A, B_ssm, C_ssm, chunk: int):
    """The recurrent kernel's arithmetic in plain PyTorch: chunk by chunk,
    the state h carried from one to the next and no per-chunk state kept.
    Per chunk, the intra-chunk pairs are rounded as in
    :func:`ssd_chunked_plain` (C·Bᵀ and the weights to x.dtype), then
    y = y_intra + T((C_i·exp(cum_i))·hᵀ) in x.dtype and
    h = h·exp(total) + S_c in float32. Same arguments and results as
    :func:`ssd_chunked_plain`; the tests hold the two together."""
    Bb, S, nh, hd = x.shape
    N = B_ssm.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd: sequence length S={S} must be a multiple of "
                         f"chunk={chunk}")
    h = torch.zeros((Bb, nh, hd, N), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        part = slice(c0, c0 + chunk)
        xc, dtc, Bc, Cc = _chunked(x[:, part], dt[:, part], B_ssm[:, part],
                                   C_ssm[:, part], chunk)
        cum, total, L = _decay_terms(dtc, A, chunk)
        scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
        w = scores[..., None] * L * dtc[:, :, None, :, :]
        y_intra = torch.einsum("bcijh,bcjhp->bcihp", w.to(x.dtype), xc)[:, 0]
        Ci = Cc[:, 0, :, None, :] * torch.exp(cum[:, 0])[..., None]
        y_inter = torch.einsum("bihn,bhpn->bihp", Ci.to(torch.float32), h)
        ys.append(y_intra + y_inter.to(x.dtype))
        xw = xc[:, 0] * (torch.exp(total[:, 0, None, :] - cum[:, 0])
                         * dtc[:, 0])[..., None]
        state = torch.einsum("bjhp,bjn->bhpn", xw, Bc[:, 0].to(xw.dtype))
        h = h * torch.exp(total[:, 0]).to(torch.float32)[..., None, None] \
            + state.to(torch.float32)
    return torch.cat(ys, dim=1), h


def _group_sums(v):
    """For v (B, 64, nh), every entry <= 0 (dt·A), the sums the tensor-core
    scan takes its cross-chunk exponents from, over 8-row groups: F (from
    the row's group start to the row), Bk (from the next row to its
    group's end) and M (B, 8, 8, nh), the groups strictly between g > g'.
    Sums of same-signed terms keep their own precision; the difference of
    two long ones would not."""
    Bb, _, nh = v.shape
    vg = v.reshape(Bb, 8, 8, nh)
    F = torch.cumsum(vg, dim=2)
    incl = torch.flip(torch.cumsum(torch.flip(vg, (2,)), dim=2), (2,))
    Bk = torch.cat([incl[:, :, 1:], torch.zeros_like(incl[:, :, :1])], dim=2)
    tot = F[:, :, -1]                                           # (B, 8, nh)
    M = torch.zeros((Bb, 8, 8, nh), dtype=v.dtype, device=v.device)
    for g in range(2, 8):
        for g1 in range(g - 1):
            M[:, g, g1] = tot[:, g1 + 1:g].sum(dim=1)
    return F.reshape(Bb, 64, nh), Bk.reshape(Bb, 64, nh), M


def ssd_chunked_tiled_plain(x, dt, A, B_ssm, C_ssm, chunk: int):
    """The tensor-core scan's arithmetic in plain PyTorch, for chunks that
    divide 64: the sequence goes by 64-row tiles (the last padded with
    rows of dt 0), the float32 state h carried from one to the next. In a
    tile, with E_ij the sum of dt·A over rows j+1 … i, the decay of a pair
    j <= i in one 8-row group is taken per pair (exp(cum_i - cum_j), the
    reference's, in one chunk; exp(F_i - F_j) across), else factored as
    exp(F_i + M[g_i][g_j]) · exp(Bk_j) dt_j (:func:`_group_sums`). The
    pairs inside one chunk give T(y_intra), rounded as in
    :func:`ssd_chunked_plain`, T(T(C_i·B_j) decay dt_j) with T the rounding
    to x.dtype; the pairs across chunks and the state entering the tile,
    exp(G_i) C_i·hᵀ with G_i the sum from the tile's start, are summed in
    float32 and rounded once, T(y_inter); y = T(y_intra) + T(y_inter) in
    x.dtype. Then h = h exp(G_end) + Σ_j (x_j u_j) ⊗ B_j with u_j =
    exp(R_j) dt_j, R_j the sum over the tile's rows after j. Same
    arguments and results as :func:`ssd_chunked_plain`; the tests only."""
    Bb, S, nh, hd = x.shape
    N = B_ssm.shape[-1]
    if S % chunk or TC_ROWS % chunk:
        raise ValueError(f"ssd: chunk={chunk} must divide S={S} and "
                         f"{TC_ROWS}")
    f32, T = torch.float32, TC_ROWS
    dev = x.device
    a = A.to(f32)
    K = T // chunk
    ids = torch.arange(T, device=dev)
    lower = ids[None, :] <= ids[:, None]
    same = (ids[None, :] // chunk) == (ids[:, None] // chunk)
    inside = (lower & same)[None, :, :, None]
    across = (lower & ~same)[None, :, :, None]
    group = ids // 8
    zero = torch.zeros((), dtype=f32, device=dev)
    h = torch.zeros((Bb, nh, hd, N), dtype=f32, device=dev)
    ys = []
    for t0 in range(0, S, T):
        rows = min(T, S - t0)
        pad = lambda z: torch.cat([z, z.new_zeros((Bb, T - rows,
                                                    *z.shape[2:]))], dim=1)
        part = slice(t0, t0 + rows)
        xt, Bt, Ct = (pad(z[:, part]) for z in (x, B_ssm, C_ssm))
        dtt = pad(dt[:, part].to(f32))
        v = dtt * a
        cum = torch.cumsum(v.reshape(Bb, K, chunk, nh), dim=2).reshape(
            Bb, T, nh)
        G = torch.cumsum(v, dim=1)            # from the tile's start
        R = torch.cat([torch.flip(torch.cumsum(torch.flip(v[:, 1:], (1,)),
                                               dim=1), (1,)),
                       torch.zeros_like(v[:, :1])], dim=1)   # to its end
        u = _exp(R) * dtt
        F, Bk, M = _group_sums(v)
        # inside one 8-row group the exponent per pair, masked before the
        # exp (the reference's cum_i - cum_j in one chunk); across groups
        # exp(F_i + M[g_i][g_j]) and cd_j = exp(Bk_j) dt_j, both <= 1
        one_group = (group[None, :] == group[:, None])[None, :, :, None]
        expo = torch.where(inside, cum[:, :, None] - cum[:, None],
                           torch.where(across, F[:, :, None] - F[:, None],
                                       torch.full((), -torch.inf, dtype=f32,
                                                   device=dev)))
        pe = _exp(torch.where(one_group, expo, zero))
        rowf = torch.where(lower[None, :, :, None] & ~one_group,
                           _exp(F[:, :, None] + M[:, group][:, :, group]),
                           zero)
        cdj = (_exp(Bk) * dtt)[:, None]                       # (B, 1, j, nh)
        d_j = dtt[:, None, :, :]
        scores = torch.einsum("bin,bjn->bij", Ct.to(f32), Bt.to(f32))
        # T(C_i·B_j) as the reference forms it: a product in x.dtype
        sb = torch.einsum("bin,bjn->bij", Ct, Bt).to(f32)[..., None]
        w_d = torch.where(inside, torch.where(one_group, sb * pe * d_j,
                                              sb * rowf * cdj).to(x.dtype),
                          zero.to(x.dtype))
        w_x = torch.where(across, scores[..., None] * torch.where(
            one_group, pe * d_j, rowf * cdj), zero)
        # summed in float32 and rounded once, as the kernel (a bf16 product
        # on the card may reduce in bf16)
        y_intra = torch.einsum("bijh,bjhp->bihp", w_d.to(f32),
                               xt.to(f32)).to(x.dtype)
        y_inter = (torch.einsum("bin,bhpn->bihp", Ct.to(f32), h)
                   * _exp(G)[..., None]
                   + torch.einsum("bijh,bjhp->bihp", w_x, xt.to(f32)))
        ys.append((y_intra + y_inter.to(x.dtype))[:, :rows])
        g_end = G[:, -1]                                       # (B, nh)
        xu = xt.to(f32) * u[..., None]
        h = (h * _exp(g_end)[..., None, None]
             + torch.einsum("bjhp,bjn->bhpn", xu, Bt.to(f32)))
    return torch.cat(ys, dim=1), h


def _check_inputs(x, dt, A, B_ssm, C_ssm, chunk: int):
    if x.dim() != 4:
        raise ValueError(f"ssd: x must be (B, S, nh, hd), got {tuple(x.shape)}")
    Bb, S, nh, hd = x.shape
    N = B_ssm.shape[-1]
    if B_ssm.shape != (Bb, S, N) or C_ssm.shape != (Bb, S, N):
        raise ValueError(f"ssd: B {tuple(B_ssm.shape)} / C "
                         f"{tuple(C_ssm.shape)} do not fit x {tuple(x.shape)}")
    if dt.shape != (Bb, S, nh) or A.shape != (nh,):
        raise ValueError(f"ssd: dt {tuple(dt.shape)} / A {tuple(A.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"ssd: head_dim {hd} not in {HEAD_DIMS}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssd: state size N={N} not in 1..{MAX_STATE}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"ssd: chunk {chunk} must be in 1..{MAX_CHUNK} and "
                         f"divide S={S}")
    if any(t.device != x.device for t in (dt, A, B_ssm, C_ssm)):
        raise ValueError("ssd: inputs on different devices")
    if B_ssm.dtype != x.dtype or C_ssm.dtype != x.dtype:
        raise TypeError("ssd: x, B and C dtypes differ")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("ssd: dt and A must be float32")
    if not all(t.is_contiguous() for t in (x, dt, A, B_ssm, C_ssm)):
        raise ValueError("ssd: inputs must be contiguous")


def ssd_route(dtype, chunk: int, hd: int, N: int) -> str:
    """The kernel a CUDA call takes, by dtype and shape alone. Below chunk
    64 (the chunks 63 of every 64 prefill lengths take under the halving
    rule): ``"tc_scan"`` (the tensor-core scan over 64-row tiles) for
    bfloat16 at a chunk that divides 64, head dim 64 and state size 32, 64
    or 128, else ``"recurrent"`` (float32, chunk 63, other shapes). At a
    chunk that is a multiple of 64, head dim 64 and state size 32, 64 or
    128, ``"tc"`` (the tensor-core kernel) for bfloat16 and ``"tf32"``
    (the split-TF32 tensor-core kernel) for float32; else ``"cuda_cores"``
    (long chunks of other shapes)."""
    tc_shape = hd == TC_HEAD_DIM and N in TC_STATES
    if chunk < RECURRENT_BELOW:
        if dtype == torch.bfloat16 and TC_ROWS % chunk == 0 and tc_shape:
            return "tc_scan"
        return "recurrent"
    if chunk % TC_ROWS == 0 and tc_shape:
        if dtype == torch.bfloat16:
            return "tc"
        if dtype == torch.float32:
            return "tf32"
    return "cuda_cores"


def ssd_tc_heads(Bb: int, S: int, nh: int, chunk: int, n_sm: int) -> int:
    """Heads per CTA of the tensor-core kernels (bf16 and split TF32): 2
    when a grid of two-head CTAs still covers the card's ``n_sm`` SMs,
    else 1 — a small grid finishes sooner spread one head per CTA
    (PERF.md §6, measured for each kernel)."""
    ctas = -(-nh // 2) * Bb * (S // chunk) * (chunk // TC_ROWS)
    return 2 if ctas >= n_sm else 1


def tc_scan_info(N: int) -> dict:
    """The tensor-core scan's kernel at state size ``N``, read on the card
    without launching it: {"regs", "spill_bytes", "ctas_per_sm", "smem"}
    (registers and local bytes a thread, by ``cudaFuncGetAttributes``;
    resident CTAs by ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``;
    shared memory bytes a CTA)."""
    import ctypes
    info = (ctypes.c_int * 4)()
    err = _build.function("ssd_chunk", "repro_ssd_tc_scan_info")(
        N, ctypes.addressof(info))
    if err:
        raise RuntimeError(f"tc_scan_info: CUDA error {err} (N={N})")
    return dict(zip(("regs", "spill_bytes", "ctas_per_sm", "smem"), info))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _raise_on(err: int, route: str, Bb, S, nh, hd, N, chunk) -> None:
    if err:
        raise RuntimeError(f"ssd: CUDA error {err} at launch ({route} route, "
                           f"B={Bb}, S={S}, nh={nh}, hd={hd}, N={N}, "
                           f"chunk={chunk})")


def ssd_chunked(x, dt, A, B_ssm, C_ssm, chunk: int):
    """SSD over a full sequence. x: (B, S, nh, hd) float32 or bfloat16;
    dt: (B, S, nh) float32 post-softplus; A: (nh,) float32 negative;
    B_ssm, C_ssm: (B, S, N) in x's dtype; ``chunk`` divides S. Returns
    (y (B, S, nh, hd) in x.dtype, final state (B, nh, hd, N) float32).

    A CPU tensor takes :func:`ssd_chunked_plain`; a CUDA tensor launches
    ``csrc/ssd_chunk.cu`` on the current stream, on the route
    :func:`ssd_route` picks, or raises. The tensor-core scan carries the
    state across the sequence by 64-row tiles and writes y and the final
    state only; so does the recurrent route, after forming the intra-chunk
    scores (B, S, chunk) once for all heads, row by row. The other three
    run the intra-chunk kernel (with the JAX model's roundings
    of C·Bᵀ and the weights; the split-TF32 route forms C·Bᵀ of the
    chunk's tile pairs first, once for all heads), then the state pass,
    which turns the chunk states into the state entering each chunk in
    place and writes the final state; ``y_inter`` is added with one
    batched product when there is more than one chunk. With grad mode on
    and an input requiring grad, the call goes through
    :class:`SSDChunked`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B_ssm, C_ssm)):
        return SSDChunked.apply(x, dt, A, B_ssm, C_ssm, chunk)
    return _forward(x, dt, A, B_ssm, C_ssm, chunk)


def ssd_cost(x, B_ssm, chunk: int):
    """(flops, bytes) of one call: x, dt, A, B and C read once, y and the
    final float32 state written once; C·Bᵀ once for all heads over each
    chunk's causal half, W·x and the chunk states per head, the state
    pass, and ``y_inter`` for the chunks after the first."""
    Bb, S, nh, hd = x.shape
    N = B_ssm.shape[-1]
    nc, tri = S // chunk, chunk * (chunk + 1) // 2
    nbytes = ((2 * x.numel() + 2 * Bb * S * N) * x.element_size()
              + 4 * (Bb * S * nh + nh) + 4 * Bb * nh * hd * N)
    flops = Bb * (2 * nc * tri * N + 2 * nc * nh * tri * hd
                  + 2 * S * nh * hd * N + 2 * nc * nh * hd * N
                  + 2 * (nc - 1) * chunk * nh * hd * N)
    return flops, nbytes


def _launch_recurrent(x, dt, A, B_ssm, C_ssm, chunk: int):
    """The recurrent pair (``ssd_scores_kernel``, ``ssd_recurrent_kernel``)
    on checked CUDA inputs at any chunk below 64; counts nothing. Returns
    (y, final state)."""
    Bb, S, nh, hd = x.shape
    N = B_ssm.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    final = torch.empty((Bb, nh, hd, N), **f32)
    scores = torch.empty((Bb, S, chunk), **f32)
    err = _build.function("ssd_chunk", "repro_ssd_chunk_recurrent")(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_ssm.data_ptr(),
        C_ssm.data_ptr(), scores.data_ptr(), y.data_ptr(), final.data_ptr(),
        Bb, S, nh, hd, N, chunk, _build.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "recurrent", Bb, S, nh, hd, N, chunk)
    return y, final


def _forward(x, dt, A, B_ssm, C_ssm, chunk: int):
    """The shape-only path on fake or meta tensors, the plain version on
    the CPU, else the kernels of the route."""
    if shape_only(x, dt, A, B_ssm, C_ssm):
        record("ssd_chunked", *ssd_cost(x, B_ssm, chunk))
        Bb, _, nh, hd = x.shape
        return (torch.empty_like(x),
                x.new_empty((Bb, nh, hd, B_ssm.shape[-1]),
                            dtype=torch.float32))
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, A, B_ssm, C_ssm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunked: unsupported device {x.device}")
    _check_inputs(x, dt, A, B_ssm, C_ssm, chunk)
    Bb, S, nh, hd = x.shape
    N = B_ssm.shape[-1]
    nc = S // chunk
    route = ssd_route(x.dtype, chunk, hd, N)
    f32 = dict(dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "tc_scan":
        y = torch.empty_like(x)
        final = torch.empty((Bb, nh, hd, N), **f32)
        err = _build.function("ssd_chunk", "repro_ssd_chunk_tc_scan")(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_ssm.data_ptr(),
            C_ssm.data_ptr(), y.data_ptr(), final.data_ptr(), Bb, S, nh, hd,
            N, chunk, stream)
        _raise_on(err, route, Bb, S, nh, hd, N, chunk)
        ssd_chunked.launches += 1
        ssd_chunked.tc_scan_launches += 1
        return y, final
    if route == "recurrent":
        y, final = _launch_recurrent(x, dt, A, B_ssm, C_ssm, chunk)
        ssd_chunked.launches += 1
        ssd_chunked.recurrent_launches += 1
        return y, final
    y_intra = torch.empty_like(x)
    h_prev = torch.empty((Bb, nc, nh, hd, N), **f32)
    cum_exp = torch.empty((Bb, S, nh), **f32)
    final = torch.empty((Bb, nh, hd, N), **f32)
    # the state pass's decay per chunk and head, then on the split-TF32
    # route C·Bᵀ of the chunk's tile pairs for all heads, 16-byte aligned:
    # one allocation, since the host's cost per call is the route's floor
    n_decay = -(-Bb * nc * nh // 4) * 4
    decay = torch.empty(n_decay + (Bb * nc * chunk * chunk
                                   if route == "tf32" else 0), **f32)
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_ssm.data_ptr(),
            C_ssm.data_ptr(), y_intra.data_ptr(), h_prev.data_ptr(),
            cum_exp.data_ptr(), decay.data_ptr(), final.data_ptr(),
            Bb, S, nh, hd, N, chunk)
    if route in ("tc", "tf32"):
        heads = ssd_tc_heads(Bb, S, nh, chunk, _sm_count(x.device.index))
    if route == "tc":
        err = _build.function("ssd_chunk", "repro_ssd_chunk_tc")(
            *args, heads, stream)
    elif route == "tf32":
        err = _build.function("ssd_chunk", "repro_ssd_chunk_tf32")(
            *args[:5], args[8] + 4 * n_decay, *args[5:], heads, stream)
    else:
        err = _build.function("ssd_chunk", "repro_ssd_chunk")(
            *args, _build.dtype_code(x.dtype), stream)
    _raise_on(err, route, Bb, S, nh, hd, N, chunk)
    ssd_chunked.launches += 1
    if route == "tc":
        ssd_chunked.tc_launches += 1
    elif route == "tf32":
        ssd_chunked.tf32_launches += 1
    if nc == 1:          # the only chunk enters with a zero state
        return y_intra, final
    return y_intra + _y_inter(C_ssm, cum_exp, h_prev, chunk, x.dtype), final


ssd_chunked.launches = 0            # every launch, any route
ssd_chunked.tc_launches = 0         # the tensor-core route's
ssd_chunked.tf32_launches = 0       # the split-TF32 route's
ssd_chunked.recurrent_launches = 0  # the recurrent route's
ssd_chunked.tc_scan_launches = 0    # the tensor-core scan's


class SSDChunked(torch.autograd.Function):
    """The SSD scan with a gradient. Forward: the kernels' route on the
    card, the plain version on the CPU (:func:`_forward`), saving the
    inputs. Backward: the gradient of the plain version at the saved
    inputs, recomputed under autograd in PyTorch ops, for x, dt, A, B and
    C: :func:`ssd_chunked_plain` for chunks of ``RECURRENT_BELOW`` and up,
    :func:`ssd_chunked_recurrent_plain` below (the chunked version would
    keep a state per chunk: at chunk 1 one per token). The final state is
    a cache output and takes no gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, B_ssm, C_ssm, chunk):
        ctx.save_for_backward(x, dt, A, B_ssm, C_ssm)
        ctx.chunk = chunk
        y, final = _forward(x, dt, A, B_ssm, C_ssm, chunk)
        ctx.mark_non_differentiable(final)
        return y, final

    @staticmethod
    def backward(ctx, gy, _g_final):
        plain = (ssd_chunked_plain if ctx.chunk >= RECURRENT_BELOW
                 else ssd_chunked_recurrent_plain)
        return (*plain_vjp(lambda *ins: plain(*ins, ctx.chunk)[0],
                           ctx.saved_tensors, ctx.needs_input_grad[:5], gy),
                None)
