"""The port's hand-written kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips where no CUDA device is
present. The file imports no JAX (the machine with the card has none), so
it runs there as it stands:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

It sweeps the shapes of ``tests/test_kernels.py`` — MHA, GQA, MQA, head
dims 32/64/128/256, the head shapes of the dense and MoE architectures (G
1, 3, 4, 5 and 6), recurrentgemma-9b's MQA at head dim 256 (G 16, local
window 2048), MLA's prefill widths (q/k 96 with v 64, 48 with 32),
ragged lengths, padding rows at an out-of-range slot,
sliding windows, query offsets and tails that are no multiple of a tile —
in float32 (tolerance 2e-5) and bfloat16 (2e-2); the SSD scan over its
shapes, full width and chunks 1 … 256 in float32 (1e-4) and bfloat16
(5e-2 on y, 1e-4 on the float32 states), on each of its five routes;
ragged decode without slots at batches 3 and 7 (the legacy engine's
decode), ragged decode's tensor-core route (bf16 at G 12 and 16, D 32 to
256, one or more kv heads, explicit spans walked by a cluster, its launch
counter, two calls bit-equal) and float32 at G 16 staying on the CUDA
cores, its n8 route (bf16 at G <= 8, D 64 and 128: llama3.2-1b's,
mistral-nemo-12b's and granite-moe-3b-a800m's heads with and without
slots, a row of length 0, rings and a dequantized int8 cache, repeat
calls bit-equal, every span size), its float32 n8 route (split TF32 at
the same heads and at G 1, 5 and 6, against its plain mirror and the
plain version at 2e-5, with and without slots, every span size, a
wrapped ring, the legacy stacks, repeat calls bit-equal), and tiny
engines of every family on the card against the CPU engine, in arena and
in legacy mode.
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch.kernels as K  # noqa: E402

_PAD_SLOT = 2 ** 30

DECODE_SHAPES = [
    (4, 8, 8, 64, 256),      # MHA
    (4, 8, 2, 64, 256),      # GQA 4:1
    (2, 16, 1, 128, 512),    # MQA, large D
    (3, 6, 3, 32, 128),      # odd sizes
    (8, 32, 8, 64, 1024),    # llama3.2-1b decode
    (8, 16, 1, 256, 1024),   # recurrentgemma-9b decode: MQA at D 256
]

FLASH_CASES = [
    (2, 256, 4, 64, None, 0),
    (2, 256, 4, 64, 64, 0),           # sliding window
    (1, 128, 2, 32, None, 128),       # catch-up chunk: q_offset > 0, T > S
    (2, 128, 8, 128, 96, 64),         # window + offset
]


SSD_CASES = [
    (2, 128, 4, 32, 16, 32),
    (1, 256, 2, 64, 32, 64),
    (2, 64, 8, 16, 8, 16),
    (1, 33, 4, 32, 16, 1),          # odd prefill length: chunk 1
    (1, 96, 2, 128, 256, 32),       # largest head_dim and state
    (2, 200, 3, 64, 100, 200),      # chunk and N no multiple of a tile
    (1, 256, 80, 64, 128, 256),     # mamba2-2.7b prefill, chunk 256
    (1, 384, 80, 64, 128, 128),     # mamba2-2.7b prefill, chunk 128
]

# bf16 on the tensor-core route (chunks of whole 64-row tiles, hd 64)
SSD_TC_CASES = [
    (2, 256, 3, 64, 128, 64),       # B = 2, nh 3: an idle warpgroup
    (2, 256, 5, 64, 128, 128),      # nh 5: a group of one head
    (2, 512, 5, 64, 64, 256),
    (1, 256, 3, 64, 32, 256),
    (1, 64, 80, 64, 128, 64),       # mamba2-2.7b prefill, chunk 64
    (1, 128, 80, 64, 128, 128),     # chunk 128, one chunk
    (1, 256, 80, 64, 128, 256),     # chunk 256
    (1, 384, 80, 64, 128, 128),     # chunk 128, three chunks
]

# f32 on the split-TF32 route (the same shapes): B = 2, several chunks per
# sequence, N 32, 64 and 128, nh 3 and 5 (a two-head CTA's second warpgroup
# idle), and mamba2-2.7b's f32 prefills
SSD_TF32_CASES = [
    (2, 256, 3, 64, 128, 64),
    (2, 256, 5, 64, 64, 128),
    (2, 512, 5, 64, 32, 256),
    (1, 256, 3, 64, 32, 64),
    (2, 384, 3, 64, 64, 64),
    (1, 64, 80, 64, 128, 64),       # mamba2-2.7b prefill, chunk 64
    (1, 384, 80, 64, 128, 128),     # chunk 128, three chunks
    (1, 256, 80, 64, 128, 256),     # chunk 256
]

# every chunk below 64 on the recurrent route: B = 2, nh 3 and 80, hd 16 …
# 128, N 16 … 256 (100 and 24 no multiple of a vector), both dtypes
SSD_RECURRENT_CASES = [
    (2, 40, 3, 16, 16, 1),
    (2, 66, 3, 64, 100, 2),
    (2, 96, 3, 128, 256, 16),
    (2, 128, 80, 64, 128, 32),
    (2, 126, 3, 32, 24, 63),        # the longest chunk it takes, odd
    (2, 258, 80, 64, 128, 2),       # mamba2-2.7b prefill 258: chunk 2
    (2, 383, 80, 64, 128, 1),       # prefill 383: chunk 1
]

# bf16 chunks below 64 that divide 64 on the tensor-core scan: B = 2, nh 3
# and 80, N 32, 64 and 128, chunks 1, 2, 16 and 32, mamba2-2.7b's prefill
# lengths 383, 258 and 127 (partial last tiles) and 64 (one whole tile)
SSD_TC_SCAN_CASES = [
    (2, 383, 80, 64, 128, 1),       # mamba2-2.7b prefill 383: chunk 1
    (2, 258, 80, 64, 128, 2),       # prefill 258: chunk 2
    (2, 127, 80, 64, 128, 1),       # prefill 127
    (2, 64, 80, 64, 128, 32),
    (2, 383, 3, 64, 32, 1),
    (2, 258, 3, 64, 64, 2),
    (2, 127, 3, 64, 64, 1),
    (2, 64, 3, 64, 32, 16),
    (2, 64, 3, 64, 128, 16),
    (2, 64, 3, 64, 64, 32),
]

LLAMA_KERNELS = ("ragged_decode_attention", "fused_rmsnorm", "flash_attention")
MAMBA_KERNELS = ("ssd_chunked", "fused_rmsnorm")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run "
                    "only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,D,T", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_decode_kernel_on_card(cuda, B, H, KV, D, T, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    N = B + 2
    q = torch.randn((B, H, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((N, T, KV, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((N, T, KV, D), generator=g, device=cuda).to(dtype)
    lens = [1, T // 4 + 3, T // 2, T][:B] + [T // 3] * max(0, B - 4)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    slots = torch.tensor(list(range(1, B)) + [_PAD_SLOT], dtype=torch.int32,
                         device=cuda)
    n0 = K.ragged_decode_attention.launches
    got = K.ragged_decode_attention(q, k, v, lengths, slots=slots)
    want = K.ragged_decode_attention_plain(q, k, v, lengths, slots=slots)
    assert K.ragged_decode_attention.launches == n0 + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [3, 7])
@pytest.mark.parametrize("H,KV,D", [(32, 8, 64), (16, 1, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_decode_kernel_without_slots(cuda, B, H, KV, D, dtype):
    """The legacy engine's decode: no slot vector, row b of a contiguous
    (B, max_len) stack at a B that is no power of two, lengths up to
    max_len 256; llama3.2-1b's heads and recurrentgemma-9b's (G 16, D
    256)."""
    T = 256
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((B, H, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, T, KV, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, T, KV, D), generator=g, device=cuda).to(dtype)
    lengths = torch.tensor([1, T, 17, 133, T - 1, 64, 200][:B],
                           dtype=torch.int32, device=cuda)
    n0 = K.ragged_decode_attention.launches
    got = K.ragged_decode_attention(q, k, v, lengths)
    assert K.ragged_decode_attention.launches == n0 + 1
    want = K.ragged_decode_attention_plain(q, k, v, lengths)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _decode_case(cuda, B, H, KV, D, T, dtype, seed):
    """Rows of length 1, T and in between; the last row is padding at an
    out-of-range slot."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    N = B + 2
    q = torch.randn((B, H, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((N, T, KV, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((N, T, KV, D), generator=g, device=cuda).to(dtype)
    lens = ([1, T, T // 2 + 7, 33, T - 1] * B)[:B]
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    slots = torch.tensor(list(range(1, B)) + [_PAD_SLOT], dtype=torch.int32,
                         device=cuda)
    return q, k, v, lengths, slots


@pytest.mark.cuda
@pytest.mark.parametrize("split_t", [32, 64, 96, 160, 256, 1024])
def test_ragged_decode_kernel_blocksize_invariance(cuda, split_t):
    """The context split changes the order of the online softmax and of the
    merge, not the result: every span size agrees with one unsplit span
    (and with the plain version) in float32."""
    B, H, KV, D, T = 5, 8, 2, 64, 1024
    q, k, v, lengths, slots = _decode_case(cuda, B, H, KV, D, T,
                                           torch.float32, seed=1)
    whole = K.ragged_decode_attention(q, k, v, lengths, slots=slots,
                                      split_t=T)
    got = K.ragged_decode_attention(q, k, v, lengths, slots=slots,
                                    split_t=split_t)
    want = K.ragged_decode_attention_plain(q, k, v, lengths, slots=slots)
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_decode_kernel_repeat_calls_agree(cuda, dtype):
    """Launches in a row on one stream give identical outputs: the last
    span of each group leaves its arrival counter at 0 for the next one.
    The llama3.2-1b decode shape, split six ways."""
    q, k, v, lengths, slots = _decode_case(cuda, 8, 32, 8, 64, 1024, dtype,
                                           seed=3)
    outs = [K.ragged_decode_attention(q, k, v, lengths, slots=slots)
            for _ in range(3)]
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    want = K.ragged_decode_attention_plain(q, k, v, lengths, slots=slots)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(outs[0].float(), want.float(), rtol=tol,
                               atol=tol)


def _flash_case(cuda, B, S, T, H, KV, D, dtype, window, q_offset, Dv=None):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, T, KV, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, T, KV, Dv or D), generator=g, device=cuda).to(dtype)
    n0 = K.flash_attention.launches
    got = K.flash_attention(q, k, v, window=window, q_offset=q_offset)
    want = K.flash_attention_plain(q, k, v, window=window, q_offset=q_offset)
    assert K.flash_attention.launches == n0 + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D,window,q_offset,KV_div", [
    c + (kv_div,) for c in FLASH_CASES for kv_div in (1, 2, 4)
    if c[2] % kv_div == 0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_on_card(cuda, B, S, H, D, window, q_offset, KV_div,
                              dtype):
    """MHA, GQA and llama's G = 4; T = q_offset + S - 3 and S - 5 leave
    tails of no multiple of 64 on both axes."""
    T = q_offset + S - 3
    _flash_case(cuda, B, S - 5, T, H, H // KV_div, D, dtype, window,
                q_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D", [(8, 1, 64), (6, 2, 64), (16, 1, 128),
                                    (6, 1, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_head_passes(cuda, H, KV, D, dtype):
    """Groups wider than one CTA's consumer warpgroups (G 8, 16 and 6) and
    groups that leave one idle in the last pass (G 3)."""
    _flash_case(cuda, 2, 150, 150, H, KV, D, dtype, None, 0)


# (H, KV, D) of qwen2.5-32b (G 5), internvl2-26b and grok-1-314b (G 6),
# mistral-nemo-12b (G 4), musicgen-large (MHA at D 64) and
# granite-moe-3b-a800m (G 3)
GQA_ARCH_HEADS = [(40, 8, 128), (48, 8, 128), (32, 8, 128), (32, 32, 64),
                  (24, 8, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D", GQA_ARCH_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_the_gqa_archs_heads(cuda, H, KV, D, dtype):
    """Each dense architecture's head shape: causal prefill at S 317, S 65
    and 129 (a last q tile of one row) and a catch-up chunk (S 190 at
    q_offset 63, T 253), tails of no multiple of 64 on both axes; and a
    window of 100 that cuts whole key tiles below a catch-up chunk (S 200
    at q_offset 60, T 260)."""
    _flash_case(cuda, 2, 317, 317, H, KV, D, dtype, None, 0)
    _flash_case(cuda, 2, 65, 65, H, KV, D, dtype, None, 0)
    _flash_case(cuda, 2, 129, 129, H, KV, D, dtype, None, 0)
    _flash_case(cuda, 1, 190, 253, H, KV, D, dtype, None, 63)
    _flash_case(cuda, 2, 200, 260, H, KV, D, dtype, 100, 60)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D", GQA_ARCH_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_decode_kernel_at_the_gqa_archs_heads(cuda, H, KV, D, dtype):
    """Each dense architecture's head shape over a T 1000 arena: rows of
    length 1, T, T / 2 + 7, 33 and T - 1, a padding row last."""
    q, k, v, lengths, slots = _decode_case(cuda, 8, H, KV, D, 1000, dtype,
                                           seed=5)
    n0 = K.ragged_decode_attention.launches
    got = K.ragged_decode_attention(q, k, v, lengths, slots=slots)
    assert K.ragged_decode_attention.launches == n0 + 1
    want = K.ragged_decode_attention_plain(q, k, v, lengths, slots=slots)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("Dqk,Dv", [(96, 64), (48, 32)])
@pytest.mark.parametrize("B,S,T,H,q_offset,window", [
    (2, 317, 317, 40, 0, None),          # minicpm3-4b's 40 heads
    (1, 190, 253, 4, 63, None),          # a catch-up chunk
    (2, 200, 200, 6, 0, 77),             # a sliding window
    (4, 512, 512, 40, 0, None),          # the smoke's prefill shape
    (4, 200, 200, 40, 0, 256),           # RuntimeFlags.window, unbound
    (2, 512, 512, 40, 0, 256),           # and binding
    (2, 65, 65, 4, 0, None),             # last q tiles of one row
    (2, 129, 129, 4, 0, None),
    (2, 128, 128, 4, 0, 100),            # a window inside the second tile
    (2, 200, 260, 4, 60, 100)])          # a window cutting tiles below
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_mla_widths(cuda, B, S, T, H, q_offset, window, Dqk,
                                    Dv, dtype):
    """MLA's non-absorbed prefill: q and k at Dqk, v at Dv, KV == H
    (MiniCPM3's (96, 64) runs at the kernel's widths (128, 64), reduced()'s
    (48, 32) at (64, 32), with the columns past each width loaded as
    zeros); the output is (B, S, H, Dv). Tails of one row past a q tile,
    catch-up chunks and windows that bind inside a tile or cut whole key
    tiles below it."""
    _flash_case(cuda, B, S, T, H, H, Dqk, dtype, window, q_offset, Dv=Dv)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,Dqk,Dv", [(40, 40, 96, 64), (32, 8, 128, 128),
                                        (16, 1, 256, 256)])
def test_flash_bf16_kernel_is_batch_invariant(cuda, H, KV, Dqk, Dv):
    """minicpm3-4b's MLA prefill, mistral-nemo-12b's and recurrentgemma-
    9b's heads in bfloat16: row b of a B 4 call equals the same request run
    at B 1 bit for bit, and a 384-token prompt gives the same rows at S 384
    as padded to the 512 bucket (at D 256 the B 4 calls take two heads a
    CTA and the B 1 ones one)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((4, 512, H, Dqk), generator=g, device=cuda).bfloat16()
    k = torch.randn((4, 512, KV, Dqk), generator=g, device=cuda).bfloat16()
    v = torch.randn((4, 512, KV, Dv), generator=g, device=cuda).bfloat16()
    batched = K.flash_attention(q, k, v)
    for b in range(4):
        alone = K.flash_attention(q[b:b + 1].clone(), k[b:b + 1].clone(),
                                  v[b:b + 1].clone())
        assert torch.equal(batched[b:b + 1], alone), b
    short = K.flash_attention(q[:, :384].contiguous(),
                              k[:, :384].contiguous(),
                              v[:, :384].contiguous())
    assert torch.equal(batched[:, :384], short)
    torch.testing.assert_close(
        short.float(), K.flash_attention_plain(
            q[:, :384], k[:, :384], v[:, :384]).float(), rtol=2e-2,
        atol=2e-2)


@pytest.mark.cuda
def test_flash_bf16_raises_on_pairs_it_is_not_compiled_for(cuda):
    """(128, 32) fits the kernel's rule for widths but no instantiation:
    the bf16 call raises rather than run a wider V tile."""
    q = torch.zeros((1, 64, 2, 128), device=cuda, dtype=torch.bfloat16)
    v = torch.zeros((1, 64, 2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not compiled"):
        K.flash_attention(q, q, v)
    assert K.flash_attention(q.float(), q.float(), v.float()).shape == (
        1, 64, 2, 32)


# recurrentgemma-9b's local attention: 16 q heads over 1 kv head of 256
RGEMMA_FLASH_CASES = [
    (2, 317, 317, 16, 1, None, 0),       # causal, tails of no tile multiple
    (1, 300, 300, 16, 1, 100, 0),        # a binding window
    (1, 190, 253, 16, 1, 64, 63),        # window and a catch-up offset
    (2, 150, 150, 4, 4, 2048, 0),        # MHA, the model's window, unbound
    (8, 256, 256, 16, 1, 2048, 0),       # hybrid training's shape
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,KV,window,q_offset", RGEMMA_FLASH_CASES)
@pytest.mark.parametrize("Dqk,Dv", [(256, 256), (256, 128), (136, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_head_dim_256(cuda, B, S, T, H, KV, window, q_offset,
                                      Dqk, Dv, dtype):
    """Width 256: bf16 on the tensor cores (four 64-column TMA boxes a row,
    P V as one m64n256k16 wgmma a k slice), float32 as split TF32 on the
    tensor cores (``flash_tf32x3_d256_kernel``: Q split a k slice at a
    time, 32-key tiles); (256, 128) and (136, 64) run at 256 with the
    columns past each width zero."""
    _flash_case(cuda, B, S, T, H, KV, Dqk, dtype, window, q_offset, Dv=Dv)


def _flash_layouts(cuda, B, S, T, H, KV, Dqk, Dv, window, q_offset):
    """The bf16 kernel at width 256 in each forced layout (one and two q
    heads a CTA) on the same inputs: each within 2e-2 of the plain version,
    two launches of each bit-equal, and the two layouts bit-equal (the same
    products and softmax in the same order)."""
    from repro_torch.kernels.flash_attn import _launch_heads
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((B, S, H, Dqk), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, T, KV, Dqk), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, T, KV, Dv), generator=g, device=cuda).bfloat16()
    want = K.flash_attention_plain(q, k, v, window=window, q_offset=q_offset)
    n0 = K.flash_attention.launches
    outs = {}
    for heads in (1, 2):
        got = _launch_heads(q, k, v, heads, window=window, q_offset=q_offset)
        again = _launch_heads(q, k, v, heads, window=window,
                              q_offset=q_offset)
        assert torch.equal(got, again), heads
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        outs[heads] = got
    assert K.flash_attention.launches == n0     # forced launches count none
    assert torch.equal(outs[1], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,KV,window,q_offset", RGEMMA_FLASH_CASES + [
    (2, 200, 200, 12, 4, None, 0),       # G 3: the last pass's second
    (1, 130, 190, 12, 4, 64, 60)])       # consumer idle
@pytest.mark.parametrize("Dqk,Dv", [(256, 256), (256, 128), (136, 64)])
def test_flash_bf16_layouts_at_head_dim_256(cuda, B, S, T, H, KV, window,
                                            q_offset, Dqk, Dv):
    """recurrentgemma-9b's shapes (and a G of 3) in both layouts of the
    bf16 kernel at width 256: one head a CTA, and two heads a CTA whose
    consumer warpgroups share each K/V tile and take turns at the tensor
    cores."""
    _flash_layouts(cuda, B, S, T, H, KV, Dqk, Dv, window, q_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 128, 256, 384])
def test_flash_bf16_at_the_rgemma_serves_prefills(cuda, S):
    """The rgemma serve's prefills (one request at its exact length, 16 q
    heads over one kv head of 256, window 2048): the wrapper takes one head
    a CTA, and both layouts agree."""
    assert K.flash_attn.tc_info(1, S, S, 16, 1, 256, 256)["heads"] == 1
    _flash_case(cuda, 1, S, S, 16, 1, 256, torch.bfloat16, 2048, 0)
    _flash_layouts(cuda, 1, S, S, 16, 1, 256, 256, 2048, 0)


@pytest.mark.cuda
def test_flash_bf16_layout_by_grid_at_head_dim_256(cuda):
    """Two heads a CTA where the two-head grid still fills the card (B 4 x
    S 512 at G 16: 256 CTAs), one where it would not (the serve's B 1 x S
    384: 48) or where a group has one head; the report names the
    instantiation: no spill, one CTA an SM in the two-head layout."""
    info = K.flash_attn.tc_info
    two = info(4, 512, 512, 16, 1, 256, 256)
    assert two["heads"] == 2 and two["spill_bytes"] == 0
    assert two["ctas_per_sm"] == 1
    assert info(1, 384, 384, 16, 1, 256, 256)["heads"] == 1
    assert info(1, 4096, 4096, 16, 1, 256, 256)["heads"] == 2
    assert info(4, 512, 512, 4, 4, 256, 256)["heads"] == 1       # G 1
    assert info(1, 384, 384, 16, 1, 256, 256, heads=2)["heads"] == 2
    assert info(4, 512, 512, 16, 1, 256, 256, heads=1)["heads"] == 1
    with pytest.raises(RuntimeError):      # a layout is forced at 256 only
        info(4, 512, 512, 32, 8, 128, 128, heads=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_where_the_window_binds_at_head_dim_256(cuda, dtype):
    """The smoke's long case: S 4096, window 2048, so most q-tiles start
    past key 0."""
    _flash_case(cuda, 1, 4096, 4096, 16, 1, 256, dtype, 2048, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("split_t", [None, 32, 160, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_decode_kernel_at_head_dim_256(cuda, split_t, dtype):
    """recurrentgemma-9b's decode (one kv head of 256 for G 16; bf16 on the
    tensor-core kernel, float32 on the CUDA cores in two chunks of 8 heads,
    each float32 lane carrying two 16-byte chunks of a row) over a T 1000
    arena with a padding row, split any way."""
    q, k, v, lengths, slots = _decode_case(cuda, 8, 16, 1, 256, 1000, dtype,
                                           seed=7)
    got = K.ragged_decode_attention(q, k, v, lengths, slots=slots,
                                    split_t=split_t)
    want = K.ragged_decode_attention_plain(q, k, v, lengths, slots=slots)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _tc_call(q, k, v, lengths, slots=None, split_t=None):
    """One call that must take the tensor-core route: both counters move
    by one."""
    n0 = K.ragged_decode_attention.launches
    t0 = K.ragged_decode_attention.tc_launches
    got = K.ragged_decode_attention(q, k, v, lengths, slots=slots,
                                    split_t=split_t)
    assert K.ragged_decode_attention.launches == n0 + 1
    assert K.ragged_decode_attention.tc_launches == t0 + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("split_t", [None, 32, 160, 1024])
def test_ragged_decode_tc_route_at_g16_d256(cuda, split_t):
    """bf16 at recurrentgemma-9b's heads (G 16, D 256) takes the
    tensor-core kernel: a T 1000 arena with a padding row, spans of 32 (32
    spans walked by a cluster of 8), 160 (a cluster of 7), 1024 (one CTA)
    or planned (8 of 128); within 2e-2 of the plain version, and two
    calls equal bit for bit."""
    q, k, v, lengths, slots = _decode_case(cuda, 8, 16, 1, 256, 1000,
                                           torch.bfloat16, seed=7)
    got = _tc_call(q, k, v, lengths, slots, split_t)
    again = _tc_call(q, k, v, lengths, slots, split_t)
    want = K.ragged_decode_attention_plain(q, k, v, lengths, slots=slots)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [3, 7])
def test_ragged_decode_tc_route_without_slots(cuda, B):
    """The legacy engine's decode at G 16 / D 256: no slot vector, a
    (B, 256) stack, on the tensor-core kernel."""
    T = 256
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((B, 16, 256), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, T, 1, 256), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, T, 1, 256), generator=g, device=cuda).bfloat16()
    lengths = torch.tensor([1, T, 17, 133, T - 1, 64, 200][:B],
                           dtype=torch.int32, device=cuda)
    got = _tc_call(q, k, v, lengths)
    want = K.ragged_decode_attention_plain(q, k, v, lengths)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D", [(12, 1, 256), (12, 1, 64), (24, 2, 128),
                                    (16, 1, 64), (16, 1, 128), (32, 2, 32),
                                    (48, 4, 64)])
def test_ragged_decode_tc_route_at_other_groups(cuda, H, KV, D):
    """G 12 (padding rows of the m16 tile), G 16 at D 32, 64 and 128, and
    more than one kv head (a tile's rows KV * D apart): a T 1000 arena
    with a padding row, within 2e-2 of the plain version; a row of length
    0 gives zeros (the TPU kernel's), every other row the plain version's
    output."""
    q, k, v, lengths, slots = _decode_case(cuda, 8, H, KV, D, 1000,
                                           torch.bfloat16, seed=H + D)
    lengths[2] = 0
    got = _tc_call(q, k, v, lengths, slots)
    want = K.ragged_decode_attention_plain(q, k, v, lengths, slots=slots)
    live = lengths > 0
    assert not got[~live].float().any()
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_ragged_decode_f32_at_g16_stays_on_the_cuda_cores(cuda):
    """float32 at G 16 runs the CUDA-core kernel: ``launches`` moves,
    ``tc_launches`` does not."""
    q, k, v, lengths, slots = _decode_case(cuda, 8, 16, 1, 256, 1000,
                                           torch.float32, seed=7)
    n0 = K.ragged_decode_attention.launches
    t0 = K.ragged_decode_attention.tc_launches
    got = K.ragged_decode_attention(q, k, v, lengths, slots=slots)
    assert K.ragged_decode_attention.launches == n0 + 1
    assert K.ragged_decode_attention.tc_launches == t0
    want = K.ragged_decode_attention_plain(q, k, v, lengths, slots=slots)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def _n8_call(q, k, v, lengths, slots=None, split_t=None):
    """One call that must take the n8 route: ``launches`` and
    ``n8_launches`` move by one, ``tc_launches`` not."""
    n0 = K.ragged_decode_attention.launches
    t0 = K.ragged_decode_attention.tc_launches
    e0 = K.ragged_decode_attention.n8_launches
    got = K.ragged_decode_attention(q, k, v, lengths, slots=slots,
                                    split_t=split_t)
    assert K.ragged_decode_attention.launches == n0 + 1
    assert K.ragged_decode_attention.n8_launches == e0 + 1
    assert K.ragged_decode_attention.tc_launches == t0
    return got


# the serves' bf16 decode heads over eight kv heads: llama3.2-1b's G 4 at
# D 64, mistral-nemo-12b's at D 128, granite-moe-3b-a800m's G 3
N8_SERVE_HEADS = [(32, 8, 64), (32, 8, 128), (24, 8, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D", N8_SERVE_HEADS)
@pytest.mark.parametrize("with_slots", [True, False])
def test_ragged_decode_n8_route_at_the_serves_heads(cuda, H, KV, D,
                                                    with_slots):
    """bf16 at the serves' heads takes the n8 kernel, over a T 1000 arena
    with a padding row (slots) or a stack read row by row (no slots: the
    legacy engine's decode, no slot vector made): a row of length 0 gives
    zeros, every other row the plain version's output within 2e-2, and
    two calls are equal bit for bit."""
    q, k, v, lengths, slots = _decode_case(cuda, 8, H, KV, D, 1000,
                                           torch.bfloat16, seed=H + D)
    lengths[3] = 0
    if not with_slots:
        k, v, slots = k[:8].contiguous(), v[:8].contiguous(), None
    got = _n8_call(q, k, v, lengths, slots)
    again = _n8_call(q, k, v, lengths, slots)
    want = K.ragged_decode_attention_plain(q, k, v, lengths, slots=slots)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    live = lengths > 0
    assert not got[~live].float().any()
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D", N8_SERVE_HEADS)
@pytest.mark.parametrize("split_t", [16, 48, 64, 128, 320, 1024])
def test_ragged_decode_n8_route_split_invariance(cuda, H, KV, D, split_t):
    """Every span size (sub-tiles cut by a span's end at 48 and 320; 63
    spans of 16 rows walked by 8 CTAs; one CTA a row at 1024) agrees with
    the planned spans and with the plain version within 2e-2 (bf16
    outputs: the order of the merges moves the last bits)."""
    q, k, v, lengths, slots = _decode_case(cuda, 8, H, KV, D, 1000,
                                           torch.bfloat16, seed=11)
    planned = _n8_call(q, k, v, lengths, slots)
    got = _n8_call(q, k, v, lengths, slots, split_t)
    want = K.ragged_decode_attention_plain(q, k, v, lengths, slots=slots)
    torch.testing.assert_close(got.float(), planned.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D", [(8, 8, 64), (40, 8, 128), (48, 8, 128),
                                    (64, 8, 64), (16, 8, 128), (8, 1, 64)])
def test_ragged_decode_n8_route_at_other_groups(cuda, H, KV, D):
    """G 1 (MHA), 5 (qwen2.5-32b), 6 (internvl2-26b, grok-1-314b), 8 and 2
    over eight kv heads, and G 8 over one: within 2e-2 of the plain
    version, a row of length 0 zeros."""
    q, k, v, lengths, slots = _decode_case(cuda, 8, H, KV, D, 1000,
                                           torch.bfloat16, seed=H * D)
    lengths[2] = 0
    got = _n8_call(q, k, v, lengths, slots)
    want = K.ragged_decode_attention_plain(q, k, v, lengths, slots=slots)
    live = lengths > 0
    assert not got[~live].float().any()
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [3, 7, 128])
def test_ragged_decode_n8_route_at_the_legacy_and_long_batches(cuda, B):
    """The legacy engine's stacks at B 3 and 7 (T 256) and B 128 (T 2048,
    every row full: one CTA a group), no slots, at llama's heads."""
    T = 256 if B < 128 else 2048
    g = torch.Generator(device=cuda).manual_seed(12)
    q = torch.randn((B, 32, 64), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, T, 8, 64), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, T, 8, 64), generator=g, device=cuda).bfloat16()
    lens = [1, T, 17, 133, T - 1, 64, 200] if B < 128 else [T] * B
    lengths = torch.tensor(lens[:B], dtype=torch.int32, device=cuda)
    got = _n8_call(q, k, v, lengths)
    want = K.ragged_decode_attention_plain(q, k, v, lengths)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D", N8_SERVE_HEADS)
def test_ragged_decode_f32_at_g4_stays_on_the_cuda_cores(cuda, H, KV, D):
    """float32 at the serves' heads no longer runs the CUDA-core kernel
    but the float32 n8 route: ``launches`` and ``n8_tf32_launches`` move,
    neither bf16 tensor-core counter does; without slots it reads row b
    (a null slot pointer), equal bit for bit to slots 0 .. B - 1."""
    q, k, v, lengths, _ = _decode_case(cuda, 8, H, KV, D, 1000,
                                       torch.float32, seed=13)
    k, v = k[:8].contiguous(), v[:8].contiguous()
    n0 = K.ragged_decode_attention.launches
    e0 = K.ragged_decode_attention.n8_launches
    t0 = K.ragged_decode_attention.tc_launches
    f0 = K.ragged_decode_attention.n8_tf32_launches
    got = K.ragged_decode_attention(q, k, v, lengths)
    assert K.ragged_decode_attention.launches == n0 + 1
    assert K.ragged_decode_attention.n8_launches == e0
    assert K.ragged_decode_attention.tc_launches == t0
    assert K.ragged_decode_attention.n8_tf32_launches == f0 + 1
    rows = torch.arange(8, dtype=torch.int32, device=cuda)
    same = K.ragged_decode_attention(q, k, v, lengths, slots=rows)
    torch.cuda.synchronize()
    assert torch.equal(got, same)
    want = K.ragged_decode_attention_plain(q, k, v, lengths)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def _n8_tf32_call(q, k, v, lengths, slots=None, split_t=None):
    """One call that must take the float32 n8 route: ``launches`` and
    ``n8_tf32_launches`` move by one, neither bf16 tensor-core counter."""
    n0 = K.ragged_decode_attention.launches
    t0 = K.ragged_decode_attention.tc_launches
    e0 = K.ragged_decode_attention.n8_launches
    f0 = K.ragged_decode_attention.n8_tf32_launches
    got = K.ragged_decode_attention(q, k, v, lengths, slots=slots,
                                    split_t=split_t)
    assert K.ragged_decode_attention.launches == n0 + 1
    assert K.ragged_decode_attention.n8_tf32_launches == f0 + 1
    assert K.ragged_decode_attention.n8_launches == e0
    assert K.ragged_decode_attention.tc_launches == t0
    return got


def _against_mirror_and_plain(got, q, k, v, lengths, slots=None,
                              split_t=None, mirror=True):
    """The float32 n8 kernel's output against its plain mirror (same plan
    and split_t; a Python loop over sub-tiles, left out of the longest
    case) and the plain version, both at 2e-5; a row of length 0 gives
    zeros."""
    want = K.ragged_decode_attention_plain(q, k, v, lengths, slots=slots)
    live = lengths > 0
    assert not got[~live].any()
    if mirror:
        torch.testing.assert_close(
            got, K.ragged_decode_n8_tf32_plain(q, k, v, lengths, slots=slots,
                                               split_t=split_t),
            rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got[live], want[live], rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D", N8_SERVE_HEADS)
@pytest.mark.parametrize("with_slots", [True, False])
def test_ragged_decode_n8_tf32_route_at_the_exact_checks_heads(
        cuda, H, KV, D, with_slots):
    """float32 at the exact checks' heads (llama's G 4 at D 64, nemo's at
    D 128, granite's G 3) takes the split-TF32 n8 kernel, over a T 1000
    arena with a padding row (slots) or a stack read row by row (no
    slots): within 2e-5 of its mirror and of the plain version, a row of
    length 0 zeros, two calls equal bit for bit."""
    q, k, v, lengths, slots = _decode_case(cuda, 8, H, KV, D, 1000,
                                           torch.float32, seed=H + D + 1)
    lengths[3] = 0
    if not with_slots:
        k, v, slots = k[:8].contiguous(), v[:8].contiguous(), None
    got = _n8_tf32_call(q, k, v, lengths, slots)
    again = _n8_tf32_call(q, k, v, lengths, slots)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _against_mirror_and_plain(got, q, k, v, lengths, slots)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D", N8_SERVE_HEADS)
@pytest.mark.parametrize("split_t", [16, 48, 64, 128, 320, 1024])
def test_ragged_decode_n8_tf32_route_split_invariance(cuda, H, KV, D,
                                                      split_t):
    """Every span size (sub-tiles cut by a span's end at 48 and 320; 63
    spans of 16 rows walked by 8 CTAs; one CTA a row at 1024) within 2e-5
    of the planned spans, of the mirror at the same spans and of the plain
    version."""
    q, k, v, lengths, slots = _decode_case(cuda, 8, H, KV, D, 1000,
                                           torch.float32, seed=17)
    planned = _n8_tf32_call(q, k, v, lengths, slots)
    got = _n8_tf32_call(q, k, v, lengths, slots, split_t)
    torch.testing.assert_close(got, planned, rtol=2e-5, atol=2e-5)
    _against_mirror_and_plain(got, q, k, v, lengths, slots, split_t)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D", [(40, 8, 128), (48, 8, 128), (32, 32, 64),
                                    (64, 8, 64), (8, 1, 64), (16, 8, 128)])
def test_ragged_decode_n8_tf32_route_at_other_groups(cuda, H, KV, D):
    """qwen2.5-32b's G 5 and internvl2-26b's G 6 at D 128, musicgen-large's
    G 1 (32 kv heads of 64), G 8 over eight kv heads and over one, G 2:
    within 2e-5 of the mirror and of the plain version, a row of length 0
    zeros."""
    q, k, v, lengths, slots = _decode_case(cuda, 8, H, KV, D, 1000,
                                           torch.float32, seed=H * D + 1)
    lengths[2] = 0
    got = _n8_tf32_call(q, k, v, lengths, slots)
    _against_mirror_and_plain(got, q, k, v, lengths, slots)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [3, 7, 128])
def test_ragged_decode_n8_tf32_route_at_the_legacy_and_long_batches(cuda, B):
    """The legacy engine's stacks at B 3 and 7 (T 256) and B 128 (T 2048,
    every row full: one CTA a group), no slots, at llama's heads in
    float32: within 2e-5 of the mirror (not at B 128) and of the plain
    version."""
    T = 256 if B < 128 else 2048
    g = torch.Generator(device=cuda).manual_seed(14)
    q = torch.randn((B, 32, 64), generator=g, device=cuda)
    k = torch.randn((B, T, 8, 64), generator=g, device=cuda)
    v = torch.randn((B, T, 8, 64), generator=g, device=cuda)
    lens = [1, T, 17, 133, T - 1, 64, 200] if B < 128 else [T] * B
    lengths = torch.tensor(lens[:B], dtype=torch.int32, device=cuda)
    got = _n8_tf32_call(q, k, v, lengths)
    _against_mirror_and_plain(got, q, k, v, lengths, mirror=B < 128)


@pytest.mark.cuda
def test_ragged_decode_n8_tf32_route_over_a_wrapped_ring(cuda):
    """RuntimeFlags.window's decode at granite's heads in float32: a ring
    of 256 rows, two rows wrapped (all 256 rows read): within 2e-5 of the
    mirror and of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(15)
    q = torch.randn((4, 24, 64), generator=g, device=cuda)
    k = torch.randn((4, 256, 8, 64), generator=g, device=cuda)
    v = torch.randn((4, 256, 8, 64), generator=g, device=cuda)
    lengths = torch.clamp(torch.tensor([300, 255, 256, 17], device=cuda) + 1,
                          max=256).to(torch.int32)
    got = _n8_tf32_call(q, k, v, lengths)
    _against_mirror_and_plain(got, q, k, v, lengths)


# RuntimeFlags.window's decode: a ring of T rows; a row past T has wrapped
# and reads all T rows (lengths min(pos + 1, T))
RING_CASES = [
    (4, 32, 8, 64, 8192, [8196, 8172, 524292, 4]),   # llama, window 8192
    (4, 24, 8, 64, 256, [300, 255, 256, 17]),        # granite, window 256
    (2, 32, 8, 128, 8, [11, 8]),                     # nemo, window 8
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,D,T,pos", RING_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_decode_kernel_over_a_wrapped_ring(cuda, B, H, KV, D, T, pos,
                                                  dtype):
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn((B, H, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, T, KV, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, T, KV, D), generator=g, device=cuda).to(dtype)
    lengths = torch.clamp(torch.tensor(pos, device=cuda) + 1,
                          max=T).to(torch.int32)
    assert int(lengths.max()) == T
    e0 = K.ragged_decode_attention.n8_launches
    got = K.ragged_decode_attention(q, k, v, lengths)
    assert K.ragged_decode_attention.n8_launches == e0 + (
        dtype == torch.bfloat16)
    want = K.ragged_decode_attention_plain(q, k, v, lengths)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D", [(32, 8, 64), (32, 8, 128), (24, 8, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_decode_kernel_over_a_dequantized_int8_cache(cuda, H, KV, D,
                                                            dtype):
    """RuntimeFlags.kv_quant's decode: int8 K/V with a float32 scale per
    (token, kv head), dequantized into the model dtype (scale cast first)
    and read by the kernel, against the plain version on the same copy."""
    from repro_torch.models.layers import _quantize_rows
    q, k, v, lengths, slots = _decode_case(cuda, 8, H, KV, D, 1024, dtype,
                                           seed=9)
    k8, ks = _quantize_rows(k)
    v8, vs = _quantize_rows(v)
    rows = torch.clamp(slots, max=k.shape[0] - 1)
    ck = k8[rows].to(dtype) * ks[rows, ..., None].to(dtype)
    cv = v8[rows].to(dtype) * vs[rows, ..., None].to(dtype)
    e0 = K.ragged_decode_attention.n8_launches
    got = K.ragged_decode_attention(q, ck, cv, lengths)
    assert K.ragged_decode_attention.n8_launches == e0 + (
        dtype == torch.bfloat16)
    want = K.ragged_decode_attention_plain(q, ck, cv, lengths)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [False, True])
def test_int8_decode_layer_on_card_matches_the_cpu(cuda, slots):
    """``apply_attention_decode`` over an int8 cache (a per-row cache, or a
    slot arena with a padding row), float32 with TF32 off: the card's
    output and cache against the same call on the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3.2-1b"), d_model=256)
    g = torch.Generator().manual_seed(10)
    p = {n: torch.randn(shape, generator=g) / 16 for n, shape in
         (("wq", (256, 32, 64)), ("wk", (256, 8, 64)), ("wv", (256, 8, 64)),
          ("wo", (32, 64, 256)))}
    N, T = 5, 96
    k8, ks = L._quantize_rows(torch.randn((N, T, 8, 64), generator=g))
    v8, vs = L._quantize_rows(torch.randn((N, T, 8, 64), generator=g))
    cache = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
    if slots:
        sl = torch.tensor([3, 0, _PAD_SLOT], dtype=torch.int32)
        pos = torch.tensor([40, 95, 0], dtype=torch.int32)
        kw, n = dict(slots=sl, live=2, ctx=96), 2
    else:
        pos = torch.tensor([0, 17, 50, 94, 95], dtype=torch.int32)
        kw, n = {}, N
    x = torch.randn((len(pos), 256), generator=g)
    on = {k: v.to(cuda) for k, v in cache.items()}
    y, on = L.apply_attention_decode(
        {k: v.to(cuda) for k, v in p.items()}, x.to(cuda), on, pos.to(cuda),
        cfg, **{k: (v.to(cuda) if torch.is_tensor(v) else v)
                for k, v in kw.items()})
    want, cache = L.apply_attention_decode(p, x, cache, pos, cfg, **kw)
    torch.testing.assert_close(y.cpu()[:n], want[:n], rtol=1e-4, atol=1e-4)
    for key in cache:
        diff = (on[key].cpu().double() - cache[key].double()).abs()
        assert float(diff.max()) <= (1 if key in ("k", "v") else 1e-6), key


@pytest.mark.cuda
def test_flash_kernel_raises_on_widths_it_does_not_take(cuda):
    for dk, dv in ((64, 96), (60, 60), (264, 64)):
        q = torch.zeros((1, 64, 2, dk), device=cuda)
        v = torch.zeros((1, 64, 2, dv), device=cuda)
        with pytest.raises(ValueError, match="head dims"):
            K.flash_attention(q, q, v)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 128, 256, 512])
@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_serve_buckets(cuda, B, S, dtype):
    """llama3.2-1b's prefill buckets: H 32, KV 8, D 64, T == S."""
    _flash_case(cuda, B, S, S, 32, 8, 64, dtype, None, 0)


def _flash_inputs(cuda, B, S, T, H, KV, D, seed=7, scale=1.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=g, device=cuda) * scale
    k = torch.randn((B, T, KV, D), generator=g, device=cuda) * scale
    v = torch.randn((B, T, KV, D), generator=g, device=cuda)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,D,window", [(32, 8, 64, None),
                                           (16, 1, 256, 2048)])
def test_flash_f32_kernel_is_batch_invariant(cuda, H, KV, D, window):
    """llama's and recurrentgemma-9b's heads in float32: row b of a B 4
    call equals the same request run at B 1 bit for bit, and a 384-token
    prompt gives the same rows at S 384 as padded to the 512 bucket (no
    split over keys depends on the grid)."""
    q, k, v = _flash_inputs(cuda, 4, 512, 512, H, KV, D)
    kw = dict(window=window)
    batched = K.flash_attention(q, k, v, **kw)
    for b in range(4):
        alone = K.flash_attention(q[b:b + 1].clone(), k[b:b + 1].clone(),
                                  v[b:b + 1].clone(), **kw)
        assert torch.equal(batched[b:b + 1], alone), b
    short = K.flash_attention(q[:, :384].contiguous(),
                              k[:, :384].contiguous(),
                              v[:, :384].contiguous(), **kw)
    assert torch.equal(batched[:, :384], short)
    torch.testing.assert_close(short, K.flash_attention_plain(
        q[:, :384], k[:, :384], v[:, :384], **kw), rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,KV,D,window,q_offset", [
    (4, 512, 512, 32, 8, 64, None, 0),   # llama's largest bucket
    (2, 187, 250, 8, 2, 128, None, 63),
    (2, 200, 200, 6, 3, 32, 77, 0),
])
def test_flash_f32_kernel_at_large_scores(cuda, B, S, T, H, KV, D, window,
                                          q_offset):
    """q and k scaled by 2 (scores four times larger, softmax peakier): the
    split products still agree with the plain version within 2e-5."""
    q, k, v = _flash_inputs(cuda, B, S, T, H, KV, D, seed=8, scale=2.0)
    got = K.flash_attention(q, k, v, window=window, q_offset=q_offset)
    want = K.flash_attention_plain(q, k, v, window=window, q_offset=q_offset)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,q_offset,window", [
    (1, 1, 0, None),          # one row, one key
    (20, 23, 3, None),        # one partial key tile
    (63, 63, 0, None),
    (65, 65, 0, 17),          # a q-tile's second half idle at D <= 64
    (129, 200, 71, None),     # odd tile counts, T > S
    (257, 257, 0, 100),
    (383, 384, 1, None),      # llama's 384 prompt after one cached token
])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (6, 1)])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_f32_kernel_sweep(cuda, D, H, KV, S, T, q_offset, window):
    """The float32 kernel against the plain version within 2e-5 at every
    head dim, MHA, GQA 4 and MQA 6, with S and T no multiple of a tile, one,
    two, odd and many key tiles per q-tile, query offsets and windows."""
    _flash_case(cuda, 2, S, T, H, KV, D, torch.float32, window, q_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,q_offset,H,KV,D,window", [
    (512, 512, 0, 32, 8, 64, None),
    (383, 384, 1, 32, 8, 64, None),
    (383, 384, 1, 32, 8, 128, None),
    (512, 512, 0, 16, 1, 256, 2048),     # recurrentgemma-9b's prefill
    (383, 384, 1, 16, 1, 256, 2048),
    (1024, 1024, 0, 16, 1, 256, 300)])   # a binding window
def test_flash_f32_kernel_repeat_launches_are_bit_equal(cuda, S, T, q_offset,
                                                        H, KV, D, window):
    """200 launches in a row on one stream give the first launch's output
    bit for bit: the producer/consumer ring (at D 256 the K and V planes
    and their barriers) hands every tile over whole, whatever the timing
    of the warps."""
    q, k, v = _flash_inputs(cuda, 4, S, T, H, KV, D, seed=9)
    kw = dict(q_offset=q_offset, window=window)
    first = K.flash_attention(q, k, v, **kw)
    outs = [K.flash_attention(q, k, v, **kw) for _ in range(200)]
    torch.cuda.synchronize()
    assert [i for i, o in enumerate(outs) if not torch.equal(o, first)] == []
    torch.testing.assert_close(first, K.flash_attention_plain(
        q, k, v, **kw), rtol=2e-5, atol=2e-5)


def _rmsnorm_check(got, want):
    tol = 2e-2 if want.dtype == torch.bfloat16 else 2e-5
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128), (2, 64, 256), (3, 5, 512),
                                   (8, 2048), (7, 1000),
                                   # mamba2-2.7b: d_model and d_inner
                                   (8, 2560), (8, 5120), (1, 384, 5120),
                                   # internvl2-26b's d_model
                                   (8, 6144), (1, 384, 6144),
                                   # no multiple of a 16-byte slot, a width
                                   # of 1, rows past 8 slots x 512 threads
                                   (3, 1001), (2, 5, 36), (4, 1),
                                   (2, 40000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_on_card(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.randn(shape, generator=g, device=cuda) * 3.0).to(dtype)
    scale = torch.randn((shape[-1],), generator=g, device=cuda)
    n0 = K.fused_rmsnorm.launches
    got = K.fused_rmsnorm(x, scale)
    assert K.fused_rmsnorm.launches == n0 + 1
    _rmsnorm_check(got, K.fused_rmsnorm_plain(x, scale))


def _rmsnorm_inputs(cuda, shape, dtype, seed=6):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=cuda) * 3.0).to(dtype)
    return x, torch.randn((shape[-1],), generator=g, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2048, 5120, 36])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_reads_row_views_in_place(cuda, D, dtype):
    """``x[:, -1]`` of a (B, S, D) block (rows at stride S * D) and a view
    whose pointer is one element past a 16-byte boundary (the
    element-by-element path): each equals the kernel on a contiguous copy
    of the same values bit for bit, and the plain version within the
    tolerance."""
    block, scale = _rmsnorm_inputs(cuda, (4, 7, D), dtype)
    view = block[:, -1]
    assert not view.is_contiguous()
    got = K.fused_rmsnorm(view, scale)
    assert got.is_contiguous()
    assert torch.equal(got, K.fused_rmsnorm(view.contiguous(), scale))
    _rmsnorm_check(got, K.fused_rmsnorm_plain(view, scale))
    flat = torch.empty(3 * D + 1, dtype=dtype, device=cuda)
    offset = flat[1:].view(3, D)
    offset.copy_(block[0, :3])
    assert offset.data_ptr() % 16 != 0
    got = K.fused_rmsnorm(offset, scale)
    assert torch.equal(got, K.fused_rmsnorm(block[0, :3].contiguous(),
                                            scale))
    _rmsnorm_check(got, K.fused_rmsnorm_plain(offset, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 2048), (3, 1001), (1, 384, 5120)])
def test_rmsnorm_kernel_takes_a_bf16_scale(cuda, shape):
    x, scale = _rmsnorm_inputs(cuda, shape, torch.bfloat16)
    scale = scale.to(torch.bfloat16)
    _rmsnorm_check(K.fused_rmsnorm(x, scale),
                   K.fused_rmsnorm_plain(x, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2048, 5120])
def test_rmsnorm_kernel_is_batch_invariant(cuda, D):
    """Each row of an (8, D) float32 call equals that row normalised alone,
    bit for bit: a row's sum does not depend on the rows beside it."""
    x, scale = _rmsnorm_inputs(cuda, (8, D), torch.float32)
    batched = K.fused_rmsnorm(x, scale)
    for i in range(8):
        alone = K.fused_rmsnorm(x[i:i + 1].clone(), scale)
        assert torch.equal(batched[i:i + 1], alone), i


@pytest.mark.cuda
def test_rmsnorm_kernel_rejects_what_it_does_not_take(cuda):
    """A CUDA tensor the kernel does not take raises; nothing falls back
    to the plain version."""
    x, scale = _rmsnorm_inputs(cuda, (4, 64), torch.float32)
    n0 = K.fused_rmsnorm.launches
    with pytest.raises(TypeError):
        K.fused_rmsnorm(x.half(), scale)
    with pytest.raises(TypeError):                  # a bf16 scale, f32 x
        K.fused_rmsnorm(x, scale.to(torch.bfloat16))
    with pytest.raises(ValueError):                 # a strided last axis
        K.fused_rmsnorm(x[:, ::2], scale[:32])
    with pytest.raises(ValueError):
        K.fused_rmsnorm(x, scale[:32])
    with pytest.raises(ValueError):
        K.fused_rmsnorm(x, scale.cpu())
    assert K.fused_rmsnorm.launches == n0


def _ssd_inputs(cuda, B, S, nh, hd, N, dtype):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((B, S, nh, hd), generator=g, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, nh), generator=g, device=cuda))
    A = -torch.exp(torch.randn((nh,), generator=g, device=cuda) * 0.3)
    Bm = torch.randn((B, S, N), generator=g, device=cuda).to(dtype)
    Cm = torch.randn((B, S, N), generator=g, device=cuda).to(dtype)
    return x, dt, A, Bm, Cm


def _check_ssd(y, st, y_ref, st_ref):
    y_tol = 5e-2 if y.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=y_tol,
                               atol=y_tol)
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-4)
    # no head may be off as a whole, however small its values
    yf, rf = y.float(), y_ref.float()
    head_rel = ((yf - rf).square().sum(dim=(0, 1, 3)).sqrt()
                / rf.square().sum(dim=(0, 1, 3)).sqrt())
    assert head_rel.max().item() < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,hd,N,chunk", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_on_card(cuda, B, S, nh, hd, N, chunk, dtype):
    inputs = _ssd_inputs(cuda, B, S, nh, hd, N, dtype)
    n0, tc0 = K.ssd_chunked.launches, K.ssd_chunked.tc_launches
    rc0 = K.ssd_chunked.recurrent_launches
    tf0 = K.ssd_chunked.tf32_launches
    ts0 = K.ssd_chunked.tc_scan_launches
    y, st = K.ssd_chunked(*inputs, chunk)
    y_ref, st_ref = K.ssd_chunked_plain(*inputs, chunk)
    route = K.ssd_route(dtype, chunk, hd, N)
    assert K.ssd_chunked.launches == n0 + 1
    assert K.ssd_chunked.tc_launches == tc0 + (route == "tc")
    assert K.ssd_chunked.tf32_launches == tf0 + (route == "tf32")
    assert K.ssd_chunked.recurrent_launches == rc0 + (route == "recurrent")
    assert K.ssd_chunked.tc_scan_launches == ts0 + (route == "tc_scan")
    _check_ssd(y, st, y_ref, st_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,hd,N,chunk", SSD_TC_CASES)
def test_ssd_tc_route_on_card(cuda, B, S, nh, hd, N, chunk):
    """The tensor-core route: every chunk it takes, B = 2, groups of heads
    with idle warpgroups (nh 3 and 5), one and several chunks per
    sequence; two launches on the same inputs are bit-equal."""
    assert K.ssd_route(torch.bfloat16, chunk, hd, N) == "tc"
    inputs = _ssd_inputs(cuda, B, S, nh, hd, N, torch.bfloat16)
    n0, tc0 = K.ssd_chunked.launches, K.ssd_chunked.tc_launches
    y, st = K.ssd_chunked(*inputs, chunk)
    assert K.ssd_chunked.launches == n0 + 1
    assert K.ssd_chunked.tc_launches == tc0 + 1
    y2, st2 = K.ssd_chunked(*inputs, chunk)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(st, st2)
    _check_ssd(y, st, *K.ssd_chunked_plain(*inputs, chunk))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,hd,N,chunk", SSD_TF32_CASES)
@pytest.mark.parametrize("heads", [1, 2])
def test_ssd_tf32_route_on_card(cuda, monkeypatch, B, S, nh, hd, N, chunk,
                                heads):
    """The split-TF32 route at one and two heads per CTA: every chunk it
    takes, N 32 … 128, B = 2, groups of heads with an idle warpgroup (nh 3
    and 5), one and several chunks per sequence; its counter moves, two
    launches on the same inputs are bit-equal, and y and the final state
    agree with the plain version (per head too)."""
    from repro_torch.kernels import ssd_chunk
    monkeypatch.setattr(ssd_chunk, "ssd_tc_heads", lambda *a: heads)
    assert K.ssd_route(torch.float32, chunk, hd, N) == "tf32"
    inputs = _ssd_inputs(cuda, B, S, nh, hd, N, torch.float32)
    n0, tf0 = K.ssd_chunked.launches, K.ssd_chunked.tf32_launches
    y, st = K.ssd_chunked(*inputs, chunk)
    assert K.ssd_chunked.launches == n0 + 1
    assert K.ssd_chunked.tf32_launches == tf0 + 1
    y2, st2 = K.ssd_chunked(*inputs, chunk)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(st, st2)
    _check_ssd(y, st, *K.ssd_chunked_plain(*inputs, chunk))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,hd,N,chunk", SSD_RECURRENT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_recurrent_route_on_card(cuda, B, S, nh, hd, N, chunk, dtype):
    """The recurrent route: its counter moves, two launches on the same
    inputs are bit-equal, and y and the final state agree with the plain
    version (per head too). The bf16 shapes that now take the tensor-core
    scan run the recurrent pair through its launcher directly (the pair
    ``chip_smoke.py`` times the scan against)."""
    from repro_torch.kernels import ssd_chunk
    inputs = _ssd_inputs(cuda, B, S, nh, hd, N, dtype)
    route = K.ssd_route(dtype, chunk, hd, N)
    if route == "recurrent":
        run = lambda: K.ssd_chunked(*inputs, chunk)
    else:
        assert route == "tc_scan" and dtype == torch.bfloat16
        run = lambda: ssd_chunk._launch_recurrent(*inputs, chunk)
    n0, rc0 = K.ssd_chunked.launches, K.ssd_chunked.recurrent_launches
    y, st = run()
    assert K.ssd_chunked.launches == n0 + (route == "recurrent")
    assert K.ssd_chunked.recurrent_launches == rc0 + (route == "recurrent")
    y2, st2 = run()
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(st, st2)
    _check_ssd(y, st, *K.ssd_chunked_plain(*inputs, chunk))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,hd,N,chunk", SSD_TC_SCAN_CASES)
def test_ssd_tc_scan_route_on_card(cuda, B, S, nh, hd, N, chunk):
    """The tensor-core scan: its counter moves, two launches on the same
    inputs are bit-equal, and y and the final state agree with the plain
    version and with the scan's own arithmetic in plain PyTorch (per head
    too)."""
    assert K.ssd_route(torch.bfloat16, chunk, hd, N) == "tc_scan"
    inputs = _ssd_inputs(cuda, B, S, nh, hd, N, torch.bfloat16)
    n0, ts0 = K.ssd_chunked.launches, K.ssd_chunked.tc_scan_launches
    rc0 = K.ssd_chunked.recurrent_launches
    y, st = K.ssd_chunked(*inputs, chunk)
    assert K.ssd_chunked.launches == n0 + 1
    assert K.ssd_chunked.tc_scan_launches == ts0 + 1
    assert K.ssd_chunked.recurrent_launches == rc0
    y2, st2 = K.ssd_chunked(*inputs, chunk)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(st, st2)
    _check_ssd(y, st, *K.ssd_chunked_plain(*inputs, chunk))
    _check_ssd(y, st, *K.ssd_chunked_tiled_plain(*inputs, chunk))


@pytest.mark.cuda
def test_ssd_recurrent_route_keeps_no_chunk_states(cuda):
    """mamba2-2.7b's chunk-1 prefill (S 383) allocates y and the final
    state only, not a state per chunk (1.0 GB there): in float32 on the
    recurrent route (with its (B, S, chunk) scores), in bf16 on the
    tensor-core scan."""
    for dtype in (torch.float32, torch.bfloat16):
        inputs = _ssd_inputs(cuda, 1, 383, 80, 64, 128, dtype)
        K.ssd_chunked(*inputs, 1)            # load the library first
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y, st = K.ssd_chunked(*inputs, 1)
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base < 64 << 20
        del y, st


@pytest.mark.cuda
def test_ssd_kernel_rejects_unsupported_shapes(cuda):
    x = torch.zeros((1, 8, 2, 48), device=cuda)
    dt, A = torch.zeros((1, 8, 2), device=cuda), torch.zeros((2,), device=cuda)
    bc = torch.zeros((1, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        K.ssd_chunked(x, dt, A, bc, bc, 4)
    with pytest.raises(ValueError, match="chunk"):
        K.ssd_chunked(x[..., :32].contiguous(), dt, A, bc, bc, 3)


def _engine_on_card_vs_cpu(cuda, arch, prompts, kernels, **engine_kw):
    """A tiny ``arch`` through TorchEngine (``engine_kw``: e.g. its cache
    mode) on the card generates the CPU engine's tokens (the kernels'
    plain versions), in float32 with TF32 off, under ServingSession +
    LazyBatching; every kernel of ``kernels`` ran on the card."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policies import LazyBatching
    from repro_torch.core.slack import SlackPredictor
    from repro_torch.serving import (H100_SXM, LengthDist, NPUPerfModel,
                                     ServingSession, TorchEngine,
                                     from_model_config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              d_model=64, d_ff=128, vocab_size=128)
    wl = from_model_config(
        cfg, prompt_dist=LengthDist(prompts, (1 / len(prompts),) * len(prompts)),
        decode_dist=LengthDist((2, 4, 6), (.4, .3, .3)))
    params = None
    tokens = {}
    K.reset_launch_counts()
    for device in ("cpu", cuda):
        engine = TorchEngine(cfg, max_len=64, device=device, params=params,
                             **engine_kw)
        params = engine.params
        pred = SlackPredictor.build([wl], NPUPerfModel(H100_SXM), 60.0)
        session = ServingSession(LazyBatching(pred, max_batch=3), engine,
                                 seed=0)
        rng = np.random.default_rng(0)
        handles, t = [], 0.0
        for _ in range(6):
            t += rng.exponential(0.05)
            handles.append(session.submit(wl.sample_request(rng, t)))
        session.drain()
        tokens[str(device)] = [engine.states[h.request.rid].generated
                               for h in handles]
    assert tokens["cpu"] == tokens["cuda"]
    counts = K.launch_counts()
    assert all(counts[n] > 0 for n in kernels), counts


@pytest.mark.cuda
def test_engine_on_card_matches_cpu_engine(cuda):
    """The tiny llama: ragged decode, RMSNorm and flash prefill."""
    _engine_on_card_vs_cpu(cuda, "llama3.2-1b", (5, 9, 20), LLAMA_KERNELS)


@pytest.mark.cuda
def test_mamba_engine_on_card_matches_cpu_engine(cuda):
    """The tiny Mamba-2 at prefill lengths 4, 8, 32 and 33 (SSD chunks 4,
    8, 32 and 1): the SSD scan and RMSNorm."""
    _engine_on_card_vs_cpu(cuda, "mamba2-2.7b", (5, 9, 33, 34),
                           MAMBA_KERNELS)


@pytest.mark.cuda
def test_mla_engine_on_card_matches_cpu_engine(cuda):
    """The tiny MiniCPM3 (MLA at reduced()'s widths, q/k 48 and v 32):
    flash prefill at those widths and RMSNorm; MLA decode is PyTorch
    ops."""
    _engine_on_card_vs_cpu(cuda, "minicpm3-4b", (5, 9, 20),
                           ("fused_rmsnorm", "flash_attention"))


@pytest.mark.cuda
def test_hybrid_engine_on_card_matches_cpu_engine(cuda):
    """The tiny recurrentgemma (rec, rec, attn at reduced()'s head dim 64,
    window 64): local attention on the llama kernels, the RG-LRU in
    PyTorch ops; prompts of 2 and 3 tokens leave short conv tails."""
    _engine_on_card_vs_cpu(cuda, "recurrentgemma-9b", (2, 3, 9, 20),
                           LLAMA_KERNELS)


@pytest.mark.cuda
def test_moe_engine_on_card_matches_cpu_engine(cuda):
    """The tiny granite MoE (4 experts, top 2): GQA attention on the llama
    kernels, the MoE FFN in PyTorch ops."""
    _engine_on_card_vs_cpu(cuda, "granite-moe-3b-a800m", (5, 9, 20),
                           LLAMA_KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,prompts,kernels", [
    ("llama3.2-1b", (5, 9, 20), LLAMA_KERNELS),
    ("minicpm3-4b", (5, 9, 20), ("fused_rmsnorm", "flash_attention")),
    ("granite-moe-3b-a800m", (5, 9, 20), LLAMA_KERNELS),
    ("mamba2-2.7b", (5, 9, 33, 34), MAMBA_KERNELS),
    ("recurrentgemma-9b", (2, 3, 9, 20), LLAMA_KERNELS),
])
def test_legacy_engine_on_card_matches_cpu_engine(cuda, arch, prompts,
                                                  kernels):
    """Legacy mode (per-request caches restacked at each decode node, B
    unpadded): the same kernels as the arena path, without slots."""
    _engine_on_card_vs_cpu(cuda, arch, prompts, kernels, cache_mode="legacy")


def _no_hidden_sync(cuda, arch):
    """Inside a committed run nothing waits for the card: with torch's sync
    debug mode set to raise, warm fused runs (prefill + decode cycles,
    padded batch) complete; only the run boundary's explicit device
    synchronize — which that mode does not flag — waits."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.request import SubBatch
    from repro_torch.serving import LengthDist, TorchEngine, from_model_config
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              d_model=64, d_ff=128, vocab_size=128)
    wl = from_model_config(cfg, prompt_dist=LengthDist((9,), (1.0,)),
                           decode_dist=LengthDist((4,), (1.0,)))
    engine = TorchEngine(cfg, max_len=64, device=cuda, n_slots=8)
    rng = np.random.default_rng(0)

    def schedule():
        reqs = []
        for _ in range(3):                       # Bp = 4: one padding row
            r = wl.sample_request(rng, 0.0)
            engine.register(r, rng.integers(2, cfg.vocab_size, size=9))
            reqs.append(r)
        sb = SubBatch(reqs)
        while sb.size:
            run = sb.run_nodes(stop_after={"head"})
            assert len(run) > 1
            engine.execute_run("m", sb, run)
            sb.advance_n(len(run), 0.0)
        return [engine.states[r.rid].generated for r in reqs]

    schedule()                                    # warmup: build, allocate
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = schedule()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(len(g) == 4 for g in got)


@pytest.mark.cuda
def test_fused_runs_make_no_hidden_host_sync(cuda):
    _no_hidden_sync(cuda, "llama3.2-1b")


@pytest.mark.cuda
def test_fused_ssm_runs_make_no_hidden_host_sync(cuda):
    _no_hidden_sync(cuda, "mamba2-2.7b")


@pytest.mark.cuda
def test_fused_hybrid_runs_make_no_hidden_host_sync(cuda):
    """The RG-LRU's gathers, scans and scatter of the live rows wait for
    nothing inside a run."""
    _no_hidden_sync(cuda, "recurrentgemma-9b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm3-4b", "granite-moe-3b-a800m"])
def test_fused_mla_and_moe_runs_make_no_hidden_host_sync(cuda, arch):
    """MLA decode and the MoE dispatch (top-k, argsort, searchsorted,
    scatter-adds) wait for nothing inside a run."""
    _no_hidden_sync(cuda, arch)


# ---------------------------------------------------------------------------
# gradients: the kernels' autograd Functions and the training path
# ---------------------------------------------------------------------------

def _card_grads(fn, inputs, upstream):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is not None
    torch.autograd.backward(out, upstream)
    torch.cuda.synchronize()
    return [t.grad for t in leaves]


def _close(got, want, tol):
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,KV,D,Dv,window,q_offset", [
    (8, 256, 256, 32, 8, 64, 64, None, 0),    # llama's training shape
    (2, 128, 128, 8, 1, 256, 256, 64, 0),     # MQA at D 256, a window
    (8, 256, 256, 16, 1, 256, 256, 2048, 0),  # hybrid training's shape
    (2, 64, 96, 4, 2, 64, 64, None, 32),      # catch-up chunk: T > S
    (2, 128, 128, 8, 8, 96, 64, None, 0),     # MLA's q/k 96 and v 64
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_gradients_on_card(cuda, B, S, T, H, KV, D, Dv,
                                          window, q_offset, dtype):
    """The kernel's forward (launched once) and the Function's backward
    against autograd through the plain version on the card."""
    g = torch.Generator(device=cuda).manual_seed(S + D)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    q, k, v, up = r(B, S, H, D), r(B, T, KV, D), r(B, T, KV, Dv), \
        r(B, S, H, Dv)
    kw = dict(window=window, q_offset=q_offset)
    n0 = K.flash_attention.launches
    got = _card_grads(lambda *a: K.flash_attention(*a, **kw), (q, k, v), up)
    assert K.flash_attention.launches == n0 + 1
    want = _card_grads(lambda *a: K.flash_attention_plain(*a, **kw),
                       (q, k, v), up)
    _close(got, want, 2e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 2048), (4, 256, 2560), (8, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_function_gradients_on_card(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(7)
    x = (torch.randn(shape, generator=g, device=cuda) * 3).to(dtype)
    scale = torch.randn(shape[-1], generator=g, device=cuda)
    up = torch.randn(shape, generator=g, device=cuda).to(dtype)
    n0 = K.fused_rmsnorm.launches
    got = _card_grads(K.fused_rmsnorm, (x, scale), up)
    assert K.fused_rmsnorm.launches == n0 + 1
    want = _card_grads(K.fused_rmsnorm_plain, (x, scale), up)
    # dscale sums over every row: its tolerance scales with the rows
    rows = x.numel() // shape[-1]
    _close(got[:1], want[:1], 2e-5 if dtype == torch.float32 else 2e-2)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4,
                               atol=1e-5 * rows ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,chunk", [(4, 256, 256), (1, 384, 128),
                                       (4, 256, 32), (1, 400, 200),
                                       (1, 33, 1)])
def test_ssd_function_gradients_on_card(cuda, B, S, chunk):
    """mamba2-2.7b's heads (80 of 64, state 128) in float32, on each route
    (split TF32, recurrent, CUDA cores), against autograd through the
    plain version on the card (tolerance 1e-4)."""
    import math
    g = torch.Generator(device=cuda).manual_seed(chunk)
    nh, hd, N = 80, 64, 128
    x = torch.randn((B, S, nh, hd), generator=g, device=cuda)
    Bm = torch.randn((B, S, N), generator=g, device=cuda)
    Cm = torch.randn((B, S, N), generator=g, device=cuda)
    u = torch.rand((nh,), generator=g, device=cuda)
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, nh), generator=g, device=cuda)
        + torch.log(torch.expm1(dt0)))
    A = -torch.arange(1, nh + 1, dtype=torch.float32, device=cuda)
    up = torch.randn((B, S, nh, hd), generator=g, device=cuda)
    n0 = K.ssd_chunked.launches
    got = _card_grads(lambda *a: K.ssd_chunked(*a, chunk),
                      (x, dt, A, Bm, Cm), up)
    assert K.ssd_chunked.launches == n0 + 1
    want = _card_grads(lambda *a: K.ssd_chunked_plain(*a, chunk),
                       (x, dt, A, Bm, Cm), up)
    assert all(torch.isfinite(t).all() for t in got)
    for a, b in zip(got, want):
        rel = ((a - b).norm() / b.norm()).item()
        assert rel < 1e-4, rel


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b",
                                  "minicpm3-4b", "granite-moe-3b-a800m",
                                  "recurrentgemma-9b"])
def test_loss_gradients_on_card_match_cpu(cuda, arch):
    """A tiny model of each family: the loss and every leaf's gradient on
    the card (kernels in the forward) against the CPU (plain versions),
    float32 with TF32 off: loss rtol 1e-5, each leaf ||dg|| / ||g|| 1e-4;
    the kernels of the path launched."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model, RuntimeFlags
    from repro_torch.training import value_and_grad
    from repro_torch.training.tree import flatten_with_paths, keystr
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), d_model=64,
                              d_ff=128, vocab_size=128)
    model = Model(cfg, RuntimeFlags(dtype=torch.float32))
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.randint(0, 128, (2, 64), generator=torch.Generator()
                        .manual_seed(1))
    batch = {"tokens": tok, "targets": torch.roll(tok, -1, 1)}
    out = []
    K.reset_launch_counts()
    for dev in ("cpu", cuda):
        b = {k: v.to(dev) for k, v in batch.items()}
        (loss, _), grads = value_and_grad(model, _tree_to(params, dev), b)
        out.append((loss.item(), {keystr(k): g.cpu() for k, g in
                                  flatten_with_paths(grads)}))
    (l_cpu, g_cpu), (l_card, g_card) = out
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for key, want in g_cpu.items():
        rel = ((g_card[key] - want).norm() / want.norm()).item()
        assert rel <= 1e-4, (key, rel)
    counts = K.launch_counts()
    assert counts["fused_rmsnorm"] > 0
    assert counts["ssd_chunked" if arch == "mamba2-2.7b"
                  else "flash_attention"] > 0


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev).requires_grad_(True)


@pytest.mark.cuda
def test_train_launcher_on_card(cuda, tmp_path):
    from repro_torch.launch import train as launch_train
    K.reset_launch_counts()
    code = launch_train.main(["--reduced", "--steps", "10", "--batch", "4",
                              "--seq", "64", "--log-every", "3",
                              "--checkpoint", str(tmp_path / "c.npz")])
    assert code == 0
    counts = K.launch_counts()
    assert counts["flash_attention"] > 0 and counts["fused_rmsnorm"] > 0
    assert counts["ragged_decode_attention"] == 0
