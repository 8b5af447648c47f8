"""CUDA kernels vs their plain PyTorch versions on the card, at small and
ragged shapes (the main-path shapes are held in chip_smoke.py). Marked
``cuda``: they skip where torch finds no GPU. On a machine with the card
and without JAX (tests/conftest.py imports it):

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _close(out, ref, rtol, atol):
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    assert err <= atol + rtol * float(ref.float().abs().max()), err


@pytest.mark.parametrize("b,sq,sk,kv_len,heads", [
    (2, 200, 200, None, 3), (2, 256, 256, None, 3), (2, 200, 200, 150, 3), (2, 300, 64, None, 3),
    (2, 7, 513, 300, 3), (1, 1000, 512, None, 3), (2, 120, 200, None, 3), (2, 200, 390, 130, 3),
    (21, 156, 624, None, 3), (1, 1000, 257, None, 3), (2, 300, 257, 200, 3),
    (1, 1000, 1000, 970, 24), (1, 1100, 1100, 1060, 24),
    (1, 390, 1170, 780, 40), (1, 390, 1170, 1170, 40), (2, 1275, 1275, None, 3)])
def test_flash_kernel_vs_plain(dev, b, sq, sk, kv_len, heads):
    """Ragged sq (7, 120 below one 128-row tile, 200), sk below one 128-key
    tile, not a multiple of it and 512 (the cross-attention shape, narrowed),
    257 (i2v's image keys: one valid row in the last key tile), kv_len inside
    the first and the second key tile, batch 1, 2 and 21; and HunyuanVideo's
    joint stream, narrowed: 24 heads, Sq = Sk not a multiple of 128, kv_len a
    few dozen below Sk inside the last key tile (the padded text keys); CausVid's
    block against its KV cache, narrowed (40 heads, a 390-token block, a
    1170-slot window, kv_len the second block's end and the window's end,
    stale slots past it); SkyReels-V2-DF's CFG batch of two, narrowed (25
    frames of 51 tokens). V is 1e4 past kv_len, so a kernel that reads a
    masked key (a re-anchored cache's stale slots) fails by orders of
    magnitude."""
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(sq + sk)
    q, k, v = (torch.randn((b, s, heads, 128), generator=g, device=dev).to(torch.bfloat16) for s in (sq, sk, sk))
    if kv_len is not None:
        v[:, kv_len:] = 1e4
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, kv_len=kv_len)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    # bar: bf16 P rounded at different running maxima, summation order
    _close(out, fa.flash_attention_plain(q, k, v, kv_len), 2e-2, 2e-3)


@pytest.mark.parametrize("pattern", ["column", "key"])
def test_flash_kernel_structured_v(dev, pattern):
    """One 128-key tile with V holding its column index (or its key index):
    a wrong transpose flag or stride in the P.V product gives another
    pattern, not noise."""
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(5)
    q, k = (torch.randn((1, 128, 2, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    idx = torch.arange(128, device=dev, dtype=torch.float32)
    v = (idx[None, None, None, :] if pattern == "column" else idx[None, :, None, None]).expand(1, 128, 2, 128)
    v = v.to(torch.bfloat16).contiguous()
    out = fa.flash_attention(q, k, v)
    _close(out, fa.flash_attention_plain(q, k, v), 2e-2, 2e-3)


def test_flash_kernel_strided_views(dev):
    """q/k/v as views into a fused (B, S, 3, N, D) buffer: read by stride."""
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa

    qkv = torch.randn((1, 130, 3, 2, 128), device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    _close(fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v), 2e-2, 2e-3)


def test_flash_rope_kernel_vs_plain(dev):
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa
    from lightx2v_tpu_torch.ops.rope import build_wan_rope_grid

    cos, sin = (torch.from_numpy(a).to(dev) for a in build_wan_rope_grid(128, 3, 7, 7))  # 147 < 200
    q, k, v = (torch.randn((1, 200, 2, 128), device=dev).to(torch.bfloat16) for _ in range(3))
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention_fused_rope(q, k, v, cos, sin)
    assert fa.LAUNCHES["flash_attention_fused_rope"] == before["flash_attention_fused_rope"] + 1
    assert fa.LAUNCHES["rope_rotate"] == before["rope_rotate"] + 1
    _close(out, fa.flash_attention_fused_rope_plain(q, k, v, cos, sin), 2e-2, 2e-3)


def test_flash_rope_kernel_phase_a_shape(dev):
    """Changing resolution's phase A: CFG's batch of two over 16 x 21 x 44 x
    78 latents, 18,018 tokens (21 x 22 x 39), whose last 128-row query tile
    holds 98 rows; two of the 40 heads (the plain version holds S x S)."""
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa
    from lightx2v_tpu_torch.ops.rope import build_wan_rope_grid

    cos, sin = (torch.from_numpy(a).to(dev) for a in build_wan_rope_grid(128, 21, 22, 39))
    g = torch.Generator(device=dev).manual_seed(18018)
    q, k, v = (torch.randn((2, 18018, 2, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    out = fa.flash_attention_fused_rope(q, k, v, cos, sin)
    _close(out, fa.flash_attention_fused_rope_plain(q, k, v, cos, sin), 2e-2, 2e-3)


@pytest.mark.parametrize("sq,sk,grid", [(200, 200, (3, 7, 7)), (300, 260, (2, 10, 10)), (64, 64, (1, 8, 8))])
def test_rope_rotate_pass_is_exact(dev, sq, sk, grid):
    """The RoPE pass against its plain version on the same card tensors, bit
    for bit: tables shorter than sq (147 < 200, 200 < 300) and as long; q a
    strided view of a fused buffer."""
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa
    from lightx2v_tpu_torch.ops.rope import build_wan_rope_grid

    cos, sin = (torch.from_numpy(a).to(dev) for a in build_wan_rope_grid(128, *grid))
    g = torch.Generator(device=dev).manual_seed(sq)
    q = torch.randn((2, sq, 2, 3, 128), generator=g, device=dev).to(torch.bfloat16)[:, :, 0]
    k = torch.randn((2, sk, 3, 128), generator=g, device=dev).to(torch.bfloat16)
    gain = fa._gain(128)
    before = fa.LAUNCHES["rope_rotate"]
    qr, kr = fa.rope_rotate(q, k, cos, sin, gain)
    assert fa.LAUNCHES["rope_rotate"] == before + 1
    qp, kp = fa.rope_rotate_plain(q, k, cos, sin, gain)
    torch.cuda.synchronize()
    assert qr.is_contiguous() and kr.is_contiguous()
    assert torch.equal(qr, qp) and torch.equal(kr, kp)


def test_flash_refuses_bad_input(dev):
    """Widths other than 64 and 128 are refused by the dense wrapper; 64 by
    the sage, block-sparse, fused-RoPE and LSE wrappers (their kernels are
    128 only)."""
    from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa
    from lightx2v_tpu_torch.ops.cuda import sage_attention as sa

    with pytest.raises(ValueError):
        fa.flash_attention(*(torch.zeros((1, 8, 2, 96), device=dev, dtype=torch.bfloat16) for _ in range(3)))
    q = torch.zeros((1, 256, 2, 64), device=dev, dtype=torch.bfloat16)
    cos = torch.zeros((256, 32), device=dev)
    idx = torch.zeros((2, 2, 1), dtype=torch.int32, device=dev)
    for call in (lambda: sa.sage_attention(q, q, q),
                 lambda: bsa.block_sparse_attention(q, q, q, idx, idx[..., 0]),
                 lambda: fa.flash_attention_with_lse(q, q, q),
                 lambda: fa.flash_attention_fused_rope(q, q, q, cos, cos)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("b,sq,sk,kv_len", [(2, 200, 200, None), (2, 256, 256, None), (1, 300, 64, None),
                                            (2, 7, 513, 300), (2, 130, 257, 150), (1, 1100, 1100, None),
                                            (2, 192, 192, None), (2, 193, 385, None), (1, 383, 434, None),
                                            (2, 384, 129, None), (1, 191, 178, None), (2, 577, 306, 200)])
def test_flash_d64_kernel_vs_plain(dev, b, sq, sk, kv_len):
    """The 64-wide dense kernel (CogVideoX's 48 heads of 64): ragged sq and
    sk (a 50-key last tile at the main shape; here 1-key, 50-key, 72-key and
    76-key last tiles), sq at and around the 192-row work tile's edges (191,
    192, 193, 383, 384, 577 = 3 * 192 + 1), kv_len inside a tile, batch 1
    and 2; it counts under ``flash_attention_d64`` and not under the
    128-wide row."""
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(sq + sk)
    q, k, v = (torch.randn((b, s, 3, 64), generator=g, device=dev).to(torch.bfloat16) for s in (sq, sk, sk))
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(q, k, v, kv_len=kv_len)
    assert fa.LAUNCHES["flash_attention_d64"] == before["flash_attention_d64"] + 1
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"]
    assert out.shape == (b, sq, 3, 64)
    # bar: bf16 P rounded at different running maxima, summation order
    _close(out, fa.flash_attention_plain(q, k, v, kv_len), 2e-2, 2e-3)


@pytest.mark.parametrize("pattern", ["column", "key"])
def test_flash_d64_kernel_structured_v(dev, pattern):
    """V holding its column (or key) index through the 64-wide kernel: a
    wrong box, stride or transpose in its one-box P.V or O staging gives
    another pattern, not noise."""
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(6)
    q, k = (torch.randn((1, 256, 2, 64), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    idx = torch.arange(256, device=dev, dtype=torch.float32)
    v = (idx[None, None, None, :64] if pattern == "column" else idx[None, :, None, None]).expand(1, 256, 2, 64)
    v = v.to(torch.bfloat16).contiguous()
    _close(fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v), 2e-2, 2e-3)


@pytest.mark.parametrize("b,sq,sk,kv_len", [(2, 200, 434, 300), (1, 385, 385, 193), (2, 193, 129, 128)])
def test_flash_d64_masked_keys_carry_no_mass(dev, b, sq, sk, kv_len):
    """V is 3e38 (near bf16's largest) at every key at or past kv_len
    (inside the second and the third key tile, and at a tile's edge): a
    masked key whose P is not exactly 0, even 2^-126, puts 3e38 * P into its
    rows, far outside the bar. The plain version never reads those keys."""
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(sq + kv_len)
    q, k, v = (torch.randn((b, s, 3, 64), generator=g, device=dev).to(torch.bfloat16) for s in (sq, sk, sk))
    v[:, kv_len:] = 3e38
    out = fa.flash_attention(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    _close(out, fa.flash_attention_plain(q, k, v, kv_len), 2e-2, 2e-3)


@pytest.mark.parametrize("sq,sk", [(200, 512), (384, 385)])
def test_flash_d64_wide_range_logits(dev, sq, sk):
    """q and k at 5x unit scale: a row's logits (exp2 domain) spread over
    ~200, so x - m runs far below -126, where 2^x is flushed to 0, and P
    mixes values near 1 with values near the flush."""
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(sk)
    q, k, v = ((torch.randn((2, s, 3, 64), generator=g, device=dev) * a).to(torch.bfloat16)
               for s, a in ((sq, 5.0), (sk, 5.0), (sk, 1.0)))
    out = fa.flash_attention(q, k, v)
    _close(out, fa.flash_attention_plain(q, k, v), 2e-2, 2e-3)


def _x(g, dev, m, k, one_signed=False):
    x = torch.randn((m, k), generator=g, device=dev)
    return (x.abs() if one_signed else x).to(torch.bfloat16)


def _int8_w(g, dev, n, k, one_signed=False):
    return torch.randint(0 if one_signed else -127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)


# one_signed: x = |randn| and positive codes, where truncated partial sums
# would add up rather than cancel
@pytest.mark.parametrize("m,n,k,act,one_signed", [(200, 200, 256, None, False), (37, 384, 4096, "gelu", False),
                                                  (512, 136, 96, None, False), (300, 256, 5120, None, True),
                                                  # ragged on all three axes: 128-row, 256-column, 128-deep tiles
                                                  (300, 266, 416, "gelu", False),
                                                  # i2v's image k / v: 257 CLIP tokens at the 14B width
                                                  (257, 5120, 5120, None, False),
                                                  # HunyuanVideo: a modulation projection at M = 1, the
                                                  # single block's linear2 (K = 15,360), a ragged linear1
                                                  (1, 18432, 3072, None, False), (300, 3072, 15360, None, False),
                                                  (33, 21504, 3072, "gelu", False)])
def test_fullk_kernel_vs_plain(dev, m, n, k, act, one_signed):
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    g = torch.Generator(device=dev).manual_seed(m + n + k)
    x = _x(g, dev, m, k, one_signed)
    w = _int8_w(g, dev, n, k, one_signed)
    ws = torch.rand((n,), generator=g, device=dev) * 1e-3
    b = torch.randn((n,), generator=g, device=dev) * 0.1
    # bar: same codes, exact int32 sums, same fp32 epilogue; bf16 ties aside
    _close(wm.w8a8_matmul_fullk(x, w, ws, b, act=act), wm.w8a8_matmul_fullk_plain(x, w, ws, b, act=act),
           2 ** -7, 0.0)


# (m, k, h): bh 128, 256 and 512 (H = 384, 8960, 13,824); K = 5120 with M
# ragged past a 128-row tile (333) and M = 4096 at H = 13,824, 864 units of
# GEMM1, more than the persistent clusters in flight, so they wrap
FFN_SHAPES = [(70, 256, 384), (70, 256, 8960), (70, 256, 13824), (333, 5120, 8960), (4096, 5120, 13824)]


@pytest.mark.parametrize("m,k,h", FFN_SHAPES)
def test_ffn_kernel_vs_plain(dev, m, k, h):
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    g = torch.Generator(device=dev).manual_seed(h)
    n = 128
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w0 = torch.randint(-127, 128, (h, k), generator=g, device=dev, dtype=torch.int8)
    w2 = torch.randint(-127, 128, (n, h), generator=g, device=dev, dtype=torch.int8)
    s0, s2 = torch.full((h,), 0.02 / 127, device=dev), torch.full((n,), 0.02 / 127, device=dev)
    b0, b2 = torch.randn((h,), generator=g, device=dev) * 0.02, torch.randn((n,), generator=g, device=dev) * 0.02
    # bar: a tanh ulp can flip a rare hidden code by one step
    _close(wm.ffn_w8a8(x, w0, s0, b0, w2, s2, b2), wm.ffn_w8a8_plain(x, w0, s0, b0, w2, s2, b2), 2e-2, 0.0)


@pytest.mark.parametrize("mm_type,key", [("W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu", "w8a8_matmul_fullk"),
                                         ("W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Tpu", "w8a8_matmul_fullk_fp8")])
def test_narrow_8bit_linears_run_the_kernel(dev, monkeypatch, mm_type, key):
    """Below the JAX package's 4096 threshold (a TPU measurement) an 8-bit
    linear on the card runs the full-K kernel, never the float64 exact dot:
    HunyuanVideo's and CogVideoX's 3072-wide linears at M = 1 and 300, and
    K = 12,288 -> N = 3072; the result equals the kernel's plain version."""
    from lightx2v_tpu_torch.ops import linear
    from lightx2v_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    def refuse(*a, **kw):
        raise AssertionError("the exact dot ran on the card")

    monkeypatch.setattr(linear, "int_dot_exact", refuse)
    kind = "fp8" if "fp8" in mm_type else "int8"
    mm = linear.resolve_mm(mm_type)
    g = torch.Generator(device=dev).manual_seed(2)
    reset_launch_counts()
    for m, k, n in ((1, 3072, 18432), (300, 3072, 3072), (300, 12288, 3072)):
        x = torch.randn((1, m, k), generator=g, device=dev).to(torch.bfloat16)
        w = _int8_w(g, dev, n, k, False) if kind == "int8" else _fp8_w(g, dev, n, k)
        p = {"w": w, "w_scale": torch.full((n,), 1e-4, device=dev), "b": torch.randn((n,), generator=g, device=dev)}
        # bar: the same codes and epilogue (rows 3 and 3f's bar)
        _close(mm(p, x), wm.w8a8_matmul_fullk_plain(x, w, p["w_scale"], p["b"], kind=kind), 2 ** -7, 0.0)
    assert {k_: v for k_, v in launch_counts().items() if v} == {key: 3}


def test_int8_linear_dispatch_uses_kernel(dev):
    from lightx2v_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from lightx2v_tpu_torch.ops.linear import mm_ffn, resolve_mm

    mm = resolve_mm("W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu")
    p = {"w": torch.zeros((4096, 4096), dtype=torch.int8, device=dev), "w_scale": torch.ones(4096, device=dev),
         "b": None}
    reset_launch_counts()
    y = mm(p, torch.ones((1, 3, 4096), dtype=torch.bfloat16, device=dev))
    p0 = {"w": torch.zeros((1024, 4096), dtype=torch.int8, device=dev), "w_scale": torch.ones(1024, device=dev),
          "b": None}
    p2 = {"w": torch.zeros((4096, 1024), dtype=torch.int8, device=dev), "w_scale": torch.ones(4096, device=dev),
          "b": None}
    mm_ffn(mm, p0, p2, torch.ones((1, 3, 4096), dtype=torch.bfloat16, device=dev))
    torch.cuda.synchronize()
    assert y.shape == (1, 3, 4096) and float(y.abs().max()) == 0.0
    assert launch_counts()["w8a8_matmul_fullk"] == 1 and launch_counts()["ffn_w8a8"] == 1


def _packed(g, dev, n, k, group):
    return (torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8),
            torch.rand((n, k // group), generator=g, device=dev) * 0.01)


@pytest.mark.parametrize("m,n,k,group,bias", [(200, 136, 1024, 512, True), (37, 384, 13824, 512, False),
                                              (513, 256, 384, 128, True), (1, 130, 768, 256, False),
                                              (300, 3072, 15360, 512, True), (1, 18432, 3072, 512, True)])
def test_w4a8_kernel_vs_plain(dev, m, n, k, group, bias):
    """Ragged M and N, odd group counts (27 at K = 13,824), groups of 128,
    256 and 512; HunyuanVideo's single-block linear2 (30 groups) and a
    modulation projection at M = 1."""
    from lightx2v_tpu_torch.ops.cuda import w4a8_matmul as w4

    g = torch.Generator(device=dev).manual_seed(m + n + k)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w, ws = _packed(g, dev, n, k, group)
    b = torch.randn((n,), generator=g, device=dev) * 0.1 if bias else None
    # bar: same codes, exact int32 group sums, same fp32 order; bf16 ties aside
    _close(w4.w4a8_matmul(x, w, ws, b), w4.w4a8_matmul_plain(x, w, ws, b), 2 ** -7, 0.0)


@pytest.mark.parametrize("case", ["wrap", "nibbles_00", "nibbles_ff", "gemm2_k"])
def test_w4a8_kernel_hazards(dev, case):
    """wrap: more output tiles than CTAs (M = 4096, N = 2048: 22 x 16 tiles of
    192 tokens x 128 weight rows), so the persistent walk wraps and the ring
    carries its phases from tile to tile. nibbles_00 / nibbles_ff: one-signed
    x (positive codes) against all-0x00 and all-0xFF packed weights, the
    nibble extremes -8 and 7, so every group sum has one sign and its
    largest size. gemm2_k: K = 13,824 in 27 groups of 512 (the FFN's second
    GEMM) with ragged M and N."""
    from lightx2v_tpu_torch.ops.cuda import w4a8_matmul as w4

    m, n, k = {"wrap": (4096, 2048, 5120), "gemm2_k": (333, 136, 13824)}.get(case, (300, 256, 5120))
    g = torch.Generator(device=dev).manual_seed(m + n + k)
    x = _x(g, dev, m, k, one_signed=case.startswith("nibbles"))
    w, ws = _packed(g, dev, n, k, 512)
    if case.startswith("nibbles"):
        w.fill_(0x00 if case == "nibbles_00" else 0xFF)
    b = torch.randn((n,), generator=g, device=dev) * 0.1
    # bar: same codes, exact int32 group sums, same fp32 order; bf16 ties aside
    _close(w4.w4a8_matmul(x, w, ws, b), w4.w4a8_matmul_plain(x, w, ws, b), 2 ** -7, 0.0)


# (m, k, h, n, w0's quant group, w0's fill): bh (w2's quant group) 512 at H =
# 13,824 (27 hidden groups, GEMM1 clusters of 4 CTAs), 256 at H = 768 and
# 8960 (clusters of 2), 128 at H = 384 (1); M ragged past a 192-token tile
# (333, 200), 1, and 4096 at K = 5120, H = 13,824: 22 x 27 units of GEMM1,
# more than the clusters in flight, so the walk wraps; w0 groups of 512, 256
# and 128. A fill (0x00, 0xFF: every nibble -8 or 7, the extremes) comes with
# one-signed x, so every group sum has one sign and its largest size.
FFN_W4A8_CASES = [(70, 512, 13824, 128, 512, None), (33, 1024, 768, 256, 512, None), (129, 256, 384, 64, 256, None),
                  (4096, 5120, 13824, 128, 512, None), (333, 5120, 8960, 136, 512, None),
                  (1, 5120, 13824, 128, 512, None), (333, 1024, 13824, 128, 128, None),
                  (200, 768, 384, 64, 256, None), (300, 5120, 13824, 128, 512, 0x00),
                  (300, 5120, 13824, 128, 512, 0xFF)]


@pytest.mark.parametrize("m,k,h,n,group,fill", FFN_W4A8_CASES)
def test_ffn_w4a8_kernel_vs_plain(dev, m, k, h, n, group, fill):
    from lightx2v_tpu_torch.ops.cuda import w4a8_matmul as w4
    from lightx2v_tpu_torch.tools.convert import _pick_bk

    g = torch.Generator(device=dev).manual_seed(h + k)
    x = _x(g, dev, m, k, one_signed=fill is not None)
    w0, s0 = _packed(g, dev, h, k, group)
    if fill is not None:
        w0.fill_(fill)
    w2, s2 = _packed(g, dev, n, h, _pick_bk(h))
    b0, b2 = torch.randn((h,), generator=g, device=dev) * 0.02, torch.randn((n,), generator=g, device=dev) * 0.02
    # bar: a tanh ulp can flip a rare hidden code by one step
    _close(w4.ffn_w4a8(x, w0, s0, b0, w2, s2, b2), w4.ffn_w4a8_plain(x, w0, s0, b0, w2, s2, b2), 2e-2, 0.0)


@pytest.mark.parametrize("m,n,k,act,one_signed", [(37, 136, 10240, None, False), (200, 256, 2560, "gelu", False),
                                                  (8, 64, 8320, None, False), (200, 256, 13824, None, True),
                                                  (130, 266, 1152, "gelu", False)])
def test_kblocked_w8a8_kernel_vs_plain(dev, m, n, k, act, one_signed):
    """k-blocks of 1024, 512 and 128 (K = 8320 = 65 * 128); 27 blocks of 512
    at K = 13,824 (the FFN's second GEMM's grouping); ragged M and N."""
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    g = torch.Generator(device=dev).manual_seed(m + k)
    x = _x(g, dev, m, k, one_signed)
    w = _int8_w(g, dev, n, k, one_signed)
    ws = torch.rand((n,), generator=g, device=dev) * 1e-3
    _close(wm.w8a8_matmul(x, w, ws, act=act), wm.w8a8_matmul_plain(x, w, ws, act=act), 2 ** -7, 0.0)


def _tables(dev, bn, nq, nk, nnz, seed):
    """Out-of-order block lists with counts below nnz, the straddling last
    key block at varying positions, and one spare row past nq."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.stack([torch.stack([torch.randperm(nk, generator=g)[:nnz] for _ in range(nq + 1)])
                       for _ in range(bn)]).to(torch.int32)
    idx[0, 0, 0] = nk - 1
    idx[0, 0, 1:] = torch.arange(nnz - 1)
    cnt = torch.randint(1, nnz + 1, (bn, nq + 1), generator=g).to(torch.int32)
    return idx.to(dev).contiguous(), cnt.to(dev).contiguous()


@pytest.mark.parametrize("s,bq,bk,nnz", [(600, 128, 128, 3), (1000, 256, 256, 3), (2100, 1024, 512, 2),
                                          (600, 128, 192, 3), (1000, 256, 64, 4)])
def test_block_sparse_kernel_vs_plain(dev, s, bq, bk, nnz):
    """bk 192 and 64: a superblock that ends half way through a 128-key
    tile (the half tile's other 64 keys are masked)."""
    from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as bsa

    g = torch.Generator(device=dev).manual_seed(s)
    q, k, v = (torch.randn((2, s, 3, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    bq_, bk_ = bsa.clamp_blocks(s, s, bq, bk)
    idx, cnt = _tables(dev, 6, -(-s // bq_), -(-s // bk_), nnz, s)
    out = bsa.block_sparse_attention(q, k, v, idx, cnt, bq=bq, bk=bk)
    # bar: bf16 P rounded at different running maxima, summation order
    _close(out, bsa.block_sparse_attention_plain(q, k, v, idx, cnt, bq=bq, bk=bk), 2e-2, 2e-3)


def test_block_sparse_kernel_zero_count_rows(dev):
    """Rows whose count is 0 store zeros; the rows around them are unharmed."""
    from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as bsa

    s = 700
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn((1, s, 2, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    idx, cnt = _tables(dev, 2, -(-s // 128), -(-s // 128), 3, 11)
    cnt[0, 1] = 0
    cnt[1, ::2] = 0
    out = bsa.block_sparse_attention(q, k, v, idx, cnt)
    torch.cuda.synchronize()
    assert not out[:, 128:256, 0].any() and not out[:, :128, 1].any() and not out[:, 256:384, 1].any()
    _close(out, bsa.block_sparse_attention_plain(q, k, v, idx, cnt), 2e-2, 2e-3)


@pytest.mark.parametrize("bk", [128, 192])
def test_block_sparse_kernel_uneven_counts(dev, bk):
    """512 work tiles on at most 132 CTAs, so each CTA walks several, with
    counts from 0 to 24 superblocks (at bk 128 odd and even key-tile counts,
    so a work tile starts on either stage of the ring): the producer and the
    consumers must agree on the phase of every tile across work tiles."""
    from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as bsa

    s, heads = 8192, 8
    g = torch.Generator(device=dev).manual_seed(bk)
    q, k, v = (torch.randn((1, s, heads, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    nq, nk = s // 128, -(-s // bk)
    idx, _ = _tables(dev, heads, nq, nk, 24, bk)
    gc = torch.Generator().manual_seed(bk)
    cnt = torch.randint(0, 25, (heads, nq + 1), generator=gc).to(torch.int32)
    cnt[:, 1::7] = 24
    cnt = cnt.to(dev).contiguous()
    out = bsa.block_sparse_attention(q, k, v, idx, cnt, bq=128, bk=bk)
    _close(out, bsa.block_sparse_attention_plain(q, k, v, idx, cnt, bq=128, bk=bk), 2e-2, 2e-3)


def test_sparge_kernel_vs_plain(dev):
    from lightx2v_tpu_torch.ops import sparge

    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((1, 1300, 2, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    kw = dict(keep_ratio=0.3, l1=0.3, block_q=256, block_k=128)
    _close(sparge.sparge_attention(q, k, v, **kw), sparge.sparge_attention_plain(q, k, v, **kw), 2e-2, 2e-3)


def test_new_wrappers_launch_kernels_on_cuda(dev, monkeypatch):
    """On CUDA tensors each new wrapper launches its kernel (its counter
    moves) and never runs its plain version."""
    from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from lightx2v_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from lightx2v_tpu_torch.ops.cuda import w4a8_matmul as w4
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm
    from lightx2v_tpu_torch.ops.linear import mm_ffn, resolve_mm

    def refuse(*a, **kw):
        raise AssertionError("plain version called on CUDA")

    for mod, name in ((w4, "w4a8_matmul_plain"), (w4, "ffn_w4a8_plain"), (wm, "w8a8_matmul_plain"),
                      (bsa, "block_sparse_attention_plain")):
        monkeypatch.setattr(mod, name, refuse)
    g = torch.Generator(device=dev).manual_seed(0)
    mm4 = resolve_mm("W-int4-group-sym-A-int8-token-dynamic-Tpu")
    mm8 = resolve_mm("W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu")
    x = torch.randn((1, 3, 4096), generator=g, device=dev).to(torch.bfloat16)
    reset_launch_counts()
    w, ws = _packed(g, dev, 4096, 4096, 512)
    mm4({"w": w, "w_scale": ws, "b": None}, x)
    w0, s0 = _packed(g, dev, 4096, 4096, 512)
    w2, s2 = _packed(g, dev, 4096, 4096, 512)
    mm_ffn(mm4, {"w": w0, "w_scale": s0, "b": None}, {"w": w2, "w_scale": s2, "b": None}, x)
    w8 = torch.randint(-127, 128, (4096, 10240), generator=g, device=dev, dtype=torch.int8)
    mm8({"w": w8, "w_scale": torch.ones(4096, device=dev), "b": None},
        torch.randn((1, 3, 10240), generator=g, device=dev).to(torch.bfloat16))
    q = torch.randn((1, 256, 2, 128), generator=g, device=dev).to(torch.bfloat16)
    idx = torch.zeros((2, 2, 1), dtype=torch.int32, device=dev)
    bsa.block_sparse_attention(q, q, q, idx, torch.ones((2, 2), dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    c = launch_counts()
    assert (c["w4a8_matmul"], c["ffn_w4a8"], c["w8a8_matmul"], c["block_sparse_attention"]) == (1, 1, 1, 1), c


@pytest.mark.parametrize("b,sq,sk,kv_len", [(1, 256, 256, None), (8, 195, 1505, None), (21, 156, 624, None),
                                            (2, 70, 200, 150), (1, 130, 129, None)])
def test_flash_lse_kernel_vs_plain(dev, b, sq, sk, kv_len):
    """Ragged odd lengths, Sq below two CTA tiles, a batch axis of 8 and 21
    (the two-pass radial passes' form), kv_len."""
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(sq + sk)
    q, k, v = (torch.randn((b, s, 3, 128), generator=g, device=dev).to(torch.bfloat16) for s in (sq, sk, sk))
    before = fa.LAUNCHES["flash_attention_with_lse"]
    out, lse = fa.flash_attention_with_lse(q, k, v, kv_len=kv_len)
    assert fa.LAUNCHES["flash_attention_with_lse"] == before + 1
    ref, ref_lse = fa.flash_attention_with_lse_plain(q, k, v, kv_len)
    _close(out, ref, 2e-2, 2e-3)
    # bar: fp32 sums in another order
    assert lse.shape == (b, sq, 3) and float((lse - ref_lse).abs().max()) <= 1e-3
    assert torch.equal(out, fa.flash_attention(q, k, v, kv_len=kv_len))


def test_flash_lse_all_keys_masked(dev):
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa

    q = torch.randn((1, 40, 2, 128), device=dev).to(torch.bfloat16)
    out, lse = fa.flash_attention_with_lse(q, q, q, kv_len=0)
    torch.cuda.synchronize()
    assert not out.any() and torch.isinf(lse).all() and (lse < 0).all()


@pytest.mark.parametrize("s,bq,bk", [(600, 128, 128), (1000, 256, 128), (2100, 1024, 512)])
def test_block_sparse_shared_kernel_vs_plain(dev, s, bq, bk):
    """2-D tables read by every (batch, head), ascending lists whose tail
    repeats the last block, B = 2; equal to the per-head kernel on the table
    repeated per head."""
    import numpy as np

    from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from lightx2v_tpu_torch.ops.radial import mask_to_indices

    g = torch.Generator(device=dev).manual_seed(s)
    q, k, v = (torch.randn((2, s, 3, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    bq_, bk_ = bsa.clamp_blocks(s, s, bq, bk)
    nq, nk = -(-s // bq_), -(-s // bk_)
    mask = np.random.default_rng(s).random((nq, nk)) < 0.4
    mask[np.arange(nq), np.minimum(np.arange(nq) * bq_ // bk_, nk - 1)] = True
    idx_np, cnt_np = mask_to_indices(mask)
    assert idx_np.shape[1] > cnt_np.min()  # some row has repeated tail entries
    idx, cnt = torch.from_numpy(idx_np).to(dev), torch.from_numpy(cnt_np).to(dev)
    before = dict(bsa.LAUNCHES)
    out = bsa.block_sparse_attention(q, k, v, idx, cnt, bq=bq, bk=bk)
    assert bsa.LAUNCHES["block_sparse_attention_shared"] == before["block_sparse_attention_shared"] + 1
    assert bsa.LAUNCHES["block_sparse_attention"] == before["block_sparse_attention"]
    _close(out, bsa.block_sparse_attention_plain(q, k, v, idx, cnt, bq=bq, bk=bk), 2e-2, 2e-3)
    per_head = bsa.block_sparse_attention(q, k, v, idx[None].repeat(6, 1, 1).contiguous(),
                                          cnt[None].repeat(6, 1).contiguous(), bq=bq, bk=bk)
    assert torch.equal(out, per_head)


@pytest.mark.parametrize("b,sq,sk,kv_len,inputs", [
    (1, 256, 256, None, "randn"), (2, 200, 200, None, "randn"), (1, 200, 200, 150, "randn"),
    (2, 77, 333, None, "randn"), (1, 300, 64, 40, "randn"), (2, 333, 700, 450, "randn"),
    (1, 256, 640, None, "one_signed"), (2, 200, 300, None, "zero_q_row"), (2, 260, 390, 300, "fused"),
    (1, 130, 130, None, "misaligned_v")])
def test_sage_kernel_vs_plain(dev, b, sq, sk, kv_len, inputs):
    """Ragged sq (77, 200, 300, 333) and sk (64, 333, 700), kv_len inside
    the first and in the middle of the fourth 128-key tile; ``one_signed``:
    q, k = |randn| * 3 with rows of one value, whose codes are all 127, so
    that int32 sums reach their top, 128 * 127^2 (the exact int -> float
    conversion); ``zero_q_row``: q rows of zeros (all logits 0); ``fused``:
    q, k, v and out as strided views of fused (B, S, 3, N, 128) buffers;
    ``misaligned_v``: a v whose base is off 16 bytes is refused with an
    error, before any launch."""
    from lightx2v_tpu_torch.ops.cuda import sage_attention as sa

    g = torch.Generator(device=dev).manual_seed(sq + sk)
    q, k, v = (torch.randn((b, s, 3, 128), generator=g, device=dev).to(torch.bfloat16) for s in (sq, sk, sk))
    before = sa.LAUNCHES["sage_attention"]
    if inputs == "misaligned_v":
        buf = torch.zeros(v.numel() + 1, dtype=torch.bfloat16, device=dev)
        with pytest.raises(ValueError, match="16-byte aligned"):
            sa.sage_attention(q, k, buf[1:].view(v.shape))
        assert sa.LAUNCHES["sage_attention"] == before
        return
    if inputs == "one_signed":
        q, k = q.abs() * 3, k.abs() * 3
        q[:, :5], k[:, 3:9] = 3.0, 2.5
    if inputs == "zero_q_row":
        q[:, 5] = 0.0
        q[1, 77, 2] = 0.0
    if inputs == "fused":
        qkv = torch.randn((b, sq, 3, 3, 128), generator=g, device=dev).to(torch.bfloat16)
        kvo = torch.randn((b, sk, 3, 3, 128), generator=g, device=dev).to(torch.bfloat16)
        q, k, v = qkv[:, :, 0], kvo[:, :, 0], kvo[:, :, 1]
        keep = qkv[:, :, :2].clone()
        lib, stream = sa._lib(), torch.cuda.current_stream().cuda_stream
        out = sa._attend(lib, *sa._quant_rows(lib, q, stream), *sa._quant_rows(lib, k, stream), v, kv_len, stream,
                         out=qkv[:, :, 2])
        assert out.data_ptr() == qkv[:, :, 2].data_ptr()
    else:
        out = sa.sage_attention(q, k, v, kv_len=kv_len)
    assert sa.LAUNCHES["sage_attention"] == before + 1
    # bar: identical int32 logits; bf16 P rounded at different running maxima, summation order
    _close(out, sa.sage_attention_plain(q, k, v, kv_len), 2e-2, 2e-3)
    if inputs == "fused":  # the store stayed inside out's own slots
        assert torch.equal(qkv[:, :, :2], keep)


def test_sage_quantize_pass_is_exact(dev):
    """The row quantization pre-pass gives the plain version's codes and
    scales bit for bit, on a strided view too; the scales lie head-major,
    (B, N, pitch) with the pitch S rounded up to 4."""
    from lightx2v_tpu_torch.ops.cuda import sage_attention as sa

    qkv = torch.randn((2, 130, 3, 2, 128), device=dev).to(torch.bfloat16)
    qkv[0, 7, 1] = 0.0
    x = qkv[:, :, 1]
    codes, scales = sa._quant_rows(sa._lib(), x, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    ref_codes, ref_scales = sa.quant_rows_plain(x)
    assert scales.shape == (2, 2, 132)
    assert torch.equal(codes, ref_codes) and torch.equal(scales[..., :130], ref_scales[..., 0].transpose(1, 2))


@pytest.mark.parametrize("m,n,k,group,bias", [(200, 256, 1024, 512, True), (37, 384, 768, 256, False),
                                              (512, 136, 256, 128, True), (1000, 5120, 5120, 512, True),
                                              # below one 128-token tile; N not a multiple of 64;
                                              # 27 groups; a single 128-column stage
                                              (1, 256, 1024, 512, True), (63, 200, 512, 128, False),
                                              (300, 256, 13824, 512, True), (130, 200, 128, 128, True),
                                              # HunyuanVideo's single-block linear2 and a modulation at M = 1
                                              (300, 3072, 15360, 512, True), (1, 9216, 3072, 512, True)])
def test_int4_kernel_vs_plain(dev, m, n, k, group, bias):
    from lightx2v_tpu_torch.ops.cuda import int4_matmul as i4

    g = torch.Generator(device=dev).manual_seed(m + n + k)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w, ws = _packed(g, dev, n, k, group)
    b = torch.randn((n,), generator=g, device=dev) * 0.1 if bias else None
    before = i4.LAUNCHES["int4_matmul"]
    out = i4.int4_matmul(x, w, ws, b)
    assert i4.LAUNCHES["int4_matmul"] == before + 1
    # bar: exact bf16 x int4 products; fp32 additions inside a group in
    # another order move a bf16 rounding now and then (one ulp at the top)
    _close(out, i4.int4_matmul_plain(x, w, ws, b), 2 ** -7, 0.0)


def test_int4_kernel_refuses_small_groups(dev):
    from lightx2v_tpu_torch.ops.cuda import int4_matmul as i4

    x = torch.zeros((4, 192), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        i4.int4_matmul(x, torch.zeros((64, 96), dtype=torch.uint8, device=dev), torch.ones((64, 1), device=dev))


def test_radial_executions_on_cuda(dev, monkeypatch):
    """radial_attention on the card: the block-sparse execution launches the
    shared-mask kernel once, two_pass launches the LSE kernel 1 + F times,
    and both agree with their plain versions on the CPU."""
    from lightx2v_tpu_torch.ops import radial
    from lightx2v_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    f, tpf = 6, 512
    s = f * tpf
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn((1, s, 2, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    assert radial._two_pass_plan(s, s, f, 0.5, "wan", 256) is not None
    for kind, key, n in (("radial", "block_sparse_attention_shared", 1), ("two_pass", "flash_attention_with_lse",
                                                                           1 + f)):
        reset_launch_counts()
        out = radial.radial_attention(q, k, v, radial.MaskMap(s, f), sparsity_type=kind, block_q=128, block_k=128)
        counts = launch_counts()
        assert counts.pop(key) == n and not any(counts.values()), (kind, counts)
        ref = radial.radial_attention(q.cpu(), k.cpu(), v.cpu(), radial.MaskMap(s, f), sparsity_type=kind,
                                      block_q=128, block_k=128)
        _close(out.cpu(), ref, 2e-2, 2e-3)


def _fp8_w(g, dev, n, k, one_signed=False):
    """e4m3 codes as the synthesizers make them: normal * 100, clipped."""
    w = torch.randn((n, k), generator=g, device=dev) * 100
    return (w.abs() if one_signed else w).clamp_(-448, 448).to(torch.float8_e4m3fn)


@pytest.mark.parametrize("m,n,k,act,one_signed", [(200, 200, 256, None, False), (37, 384, 4096, "gelu", False),
                                                  (512, 136, 96, None, False),
                                                  # below one 128-row tile, ragged N, K below one stage
                                                  (5, 66, 64, None, False), (300, 256, 5120, None, False),
                                                  (300, 256, 5120, None, True), (300, 392, 416, "gelu", False),
                                                  # HunyuanVideo: M = 1 modulation, K = 15,360 linear2
                                                  (1, 18432, 3072, None, False), (300, 3072, 15360, None, False)])
def test_fullk_fp8_kernel_vs_plain(dev, m, n, k, act, one_signed):
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    g = torch.Generator(device=dev).manual_seed(m + n + k)
    x = _x(g, dev, m, k, one_signed)
    w = _fp8_w(g, dev, n, k, one_signed)
    ws = torch.rand((n,), generator=g, device=dev) * 1e-4
    b = torch.randn((n,), generator=g, device=dev) * 0.1
    before = wm.LAUNCHES["w8a8_matmul_fullk_fp8"]
    out = wm.w8a8_matmul_fullk(x, w, ws, b, act=act, kind="fp8")
    assert wm.LAUNCHES["w8a8_matmul_fullk_fp8"] == before + 1
    # bar: same e4m3 codes and scales; exact products summed in fp32 on the
    # tensor cores against one rounding of the exact sum; bf16 ties aside
    _close(out, wm.w8a8_matmul_fullk_plain(x, w, ws, b, act=act, kind="fp8"), 2 ** -7, 0.0)


def test_fp8_quantize_pass_is_exact(dev):
    """The e4m3 quantize pass gives the plain version's codes and scales bit
    for bit (IEEE division, round to nearest even), a zero row included."""
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    x = torch.randn((70, 1024), device=dev).to(torch.bfloat16) * 3
    x[5] = 0
    for group in (1024, 128):
        q, s = wm._quant(wm._lib(), x, group, "fp8", torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        rq, rs = wm.quantize_groups_plain(x, group, "fp8")
        assert torch.equal(q.view(torch.uint8), rq.view(torch.uint8)) and torch.equal(s, rs)


# one_signed: x = |randn| and positive w0 codes, so GEMM1's truncated e4m3
# partial sums add up rather than cancel (difference "o" of ROADMAP.md)
@pytest.mark.parametrize("m,k,h,one_signed", [(*shape, False) for shape in FFN_SHAPES] + [(333, 5120, 13824, True)])
def test_ffn_fp8_kernel_vs_plain(dev, m, k, h, one_signed):
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    g = torch.Generator(device=dev).manual_seed(h)
    n = 128
    x = _x(g, dev, m, k, one_signed)
    w0, w2 = _fp8_w(g, dev, h, k, one_signed), _fp8_w(g, dev, n, h)
    s0, s2 = torch.full((h,), 0.02 / 100, device=dev), torch.full((n,), 0.02 / 100, device=dev)
    b0, b2 = torch.randn((h,), generator=g, device=dev) * 0.02, torch.randn((n,), generator=g, device=dev) * 0.02
    before = wm.LAUNCHES["ffn_w8a8_fp8"]
    out = wm.ffn_w8a8(x, w0, s0, b0, w2, s2, b2, kind="fp8")
    assert wm.LAUNCHES["ffn_w8a8_fp8"] == before + 1
    # bar: a tanh ulp can move a rare hidden code by one step
    _close(out, wm.ffn_w8a8_plain(x, w0, s0, b0, w2, s2, b2, kind="fp8"), 2e-2, 0.0)


@pytest.mark.parametrize("m,n,k,act,one_signed", [(37, 136, 10240, None, False), (200, 256, 2560, "gelu", False),
                                                  (8, 64, 128, None, False), (200, 256, 13824, None, True),
                                                  (130, 266, 1152, "gelu", False)])
def test_kblocked_fp8_kernel_vs_plain(dev, m, n, k, act, one_signed):
    """k-blocks of 1024 and 512, and K = 128: a single k-block; 27 blocks of
    512 at K = 13,824 (the FFN's second GEMM's grouping); ragged M and N."""
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    g = torch.Generator(device=dev).manual_seed(m + k)
    x = _x(g, dev, m, k, one_signed)
    w = _fp8_w(g, dev, n, k, one_signed)
    ws = torch.rand((n,), generator=g, device=dev) * 1e-4
    before = wm.LAUNCHES["w8a8_matmul_fp8"]
    out = wm.w8a8_matmul(x, w, ws, act=act, kind="fp8")
    assert wm.LAUNCHES["w8a8_matmul_fp8"] == before + 1
    _close(out, wm.w8a8_matmul_plain(x, w, ws, act=act, kind="fp8"), 2 ** -7, 0.0)


def test_8bit_wrappers_refuse_the_other_kind(dev):
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    x = torch.zeros((4, 256), dtype=torch.bfloat16, device=dev)
    ws = torch.ones(64, device=dev)
    w8 = torch.zeros((64, 256), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        wm.w8a8_matmul_fullk(x, w8, ws, kind="fp8")
    with pytest.raises(ValueError, match="int8"):
        wm.w8a8_matmul(x, w8.to(torch.float8_e4m3fn), ws)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_8bit_wrappers_refuse_misaligned_weights(dev, kind):
    """TMA reads the weights: a base pointer off 16 bytes raises, it is never
    run through the plain version."""
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    x = torch.zeros((4, 256), dtype=torch.bfloat16, device=dev)
    buf = torch.zeros(64 * 256 + 1, dtype=wm._CODE_DTYPE[kind], device=dev)
    w = buf[1:].view(64, 256)
    assert w.is_contiguous() and w.data_ptr() % 16
    before = dict(wm.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        wm.w8a8_matmul_fullk(x, w, torch.ones(64, device=dev), kind=kind)
    assert wm.LAUNCHES == before


def test_fp8_linear_dispatch_uses_kernels(dev, monkeypatch):
    """The fp8 scheme on the card: full-K, k-blocked and the fused FFN each
    launch their fp8 kernel, no int8 one, and no plain version."""
    from lightx2v_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm
    from lightx2v_tpu_torch.ops.linear import mm_ffn, resolve_mm

    def refuse(*a, **kw):
        raise AssertionError("plain version called on CUDA")

    for name in ("w8a8_matmul_plain", "w8a8_matmul_fullk_plain", "ffn_w8a8_plain"):
        monkeypatch.setattr(wm, name, refuse)
    g = torch.Generator(device=dev).manual_seed(1)
    mm = resolve_mm("W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Vllm")
    x = torch.randn((1, 3, 4096), generator=g, device=dev).to(torch.bfloat16)
    reset_launch_counts()
    ones = lambda n: torch.full((n,), 1e-4, device=dev)  # noqa: E731
    y = mm({"w": _fp8_w(g, dev, 4096, 4096), "w_scale": ones(4096), "b": None}, x)
    mm({"w": _fp8_w(g, dev, 4096, 10240), "w_scale": ones(4096), "b": None},
       torch.randn((1, 3, 10240), generator=g, device=dev).to(torch.bfloat16))
    mm_ffn(mm, {"w": _fp8_w(g, dev, 1024, 4096), "w_scale": ones(1024), "b": None},
           {"w": _fp8_w(g, dev, 4096, 1024), "w_scale": ones(4096), "b": None}, x)
    torch.cuda.synchronize()
    c = {k: v for k, v in launch_counts().items() if v}
    assert y.shape == (1, 3, 4096) and torch.isfinite(y.float()).all()
    assert c == {"w8a8_matmul_fullk_fp8": 1, "w8a8_matmul_fp8": 1, "ffn_w8a8_fp8": 1}, c


def test_mm_default_bf16_on_card(dev):
    """``Default`` on the card (bf16 operands, fp32 result from torch.mm)
    against its CPU branch (operands widened to fp32) on the same inputs."""
    from lightx2v_tpu_torch.ops.linear import resolve_mm

    g = torch.Generator().manual_seed(3)
    x = torch.randn((3, 70, 512), generator=g).to(torch.bfloat16)
    p = {"w": (torch.randn((384, 512), generator=g) * 0.05).to(torch.bfloat16), "b": torch.randn(384, generator=g)}
    mm = resolve_mm("Default")
    y = mm({k: v.to(dev) for k, v in p.items()}, x.to(dev))
    assert y.dtype == torch.bfloat16
    # bar: the same exact products summed in fp32 in another order, then one bf16 rounding
    _close(y.cpu(), mm(p, x), 2 ** -7, 0.0)


@pytest.mark.parametrize("scheme", ["bf16", "int8"])
def test_clip_tower_on_card(dev, scheme):
    """Two blocks of the CLIP ViT-H/14 tower at its full width (1280, 16
    heads of 80, 257 tokens) on the card vs the CPU: the embedding and each
    block on the same input."""
    import dataclasses

    import numpy as np

    from lightx2v_tpu_torch.encoders import clip

    arch = dataclasses.replace(clip.ClipVisionArch(), use_blocks=2)
    params = clip.init_random_clip_params_on_device(arch, seed=3, device=dev)
    if scheme == "int8":
        params = clip.quantize_clip_params(params, "int8")
    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        return [to_cpu(v) for v in tree] if isinstance(tree, list) else tree.cpu()

    cpu = to_cpu(params)
    img = np.random.default_rng(5).uniform(-1, 1, (480, 832, 3)).astype(np.float32)
    px = torch.from_numpy(clip.preprocess_image(img))
    x = clip.clip_embed(params, px, arch)
    pairs = [(x, clip.clip_embed(cpu, px, arch))]
    for bp, cbp in zip(params["blocks"], cpu["blocks"]):
        pairs.append((clip.clip_block(bp, x, arch), clip.clip_block(cbp, x.cpu(), arch)))
        x = pairs[-1][0]
    torch.cuda.synchronize()
    assert x.shape == (1, 257, 1280) and x.dtype == torch.bfloat16
    for out, ref in pairs:
        # bar: relative L2 1e-2 (bf16 activations; fp32 sums in another order)
        assert float((out.cpu().float() - ref.float()).norm() / ref.float().norm()) < 1e-2


def test_two_slot_copier_is_byte_exact_under_load(dev):
    """The host-RAM tier's copier: pinned packed blocks stream through two
    device slots while the compute stream is kept busy before each block
    is read; every tensor of every block arrives byte for byte, in two
    passes (a copy that overwrote a slot still in use would show)."""
    from lightx2v_tpu_torch.models.wan.streaming import BlockStreamer, HostBlocks

    g = torch.Generator().manual_seed(0)
    blocks = [{"w": torch.randint(-127, 128, (777, 129), generator=g, dtype=torch.int8),
               "s": torch.randn((777,), generator=g),
               "n": {"b": torch.randn((3, 5), generator=g).to(torch.bfloat16), "none": None},
               "f8": torch.randn((64, 33), generator=g).to(torch.float8_e4m3fn)} for _ in range(7)]
    want = [{k: v for k, v in b.items()} for b in blocks]
    host = HostBlocks([dict(b) for b in blocks], pin=True)
    assert all(buf.is_pinned() for buf in host.bufs)
    streamer = BlockStreamer(host, dev)
    busy = torch.randn((2048, 2048), device=dev)
    for _ in range(2):
        got = []
        for blk in streamer:
            for _ in range(8):
                busy = torch.tanh(busy @ busy * 1e-3)
            got.append({"w": blk["w"].clone(), "s": blk["s"].clone(), "b": blk["n"]["b"].clone(),
                        "f8": blk["f8"].view(torch.uint8).clone(), "none": blk["n"]["none"]})
        torch.cuda.synchronize()
        stats = streamer.take_stats()
        assert stats["h2d_bytes"] == 7 * host.layout.nbytes and stats["h2d_ms"] > 0 and stats["stall_ms"] >= 0
        for blk, ref in zip(got, want):
            assert torch.equal(blk["w"].cpu(), ref["w"]) and torch.equal(blk["s"].cpu(), ref["s"])
            assert torch.equal(blk["b"].cpu(), ref["n"]["b"]) and blk["none"] is None
            assert torch.equal(blk["f8"].cpu(), ref["f8"].view(torch.uint8))


def test_card_written_checkpoint_reads_back_exact(dev, tmp_path):
    """A checkpoint made, quantized and written from the card (the
    converter's blocks layout) reads back exact: through ``load_file``, and
    through the disk tier (pinned staging pool, copy stream) onto the card."""
    from lightx2v_tpu_torch.models.wan.config import WanArch
    from lightx2v_tpu_torch.models.wan.lazy_offload import BlockPrefetcher, LazyBlockStore
    from lightx2v_tpu_torch.models.wan.streaming import BlockStreamer
    from lightx2v_tpu_torch.models.wan.weights import init_random_weight_dict_on_device
    from lightx2v_tpu_torch.tools.convert import quantize_model, save_quantized
    from lightx2v_tpu_torch.utils.safetensors_io import load_file

    arch = WanArch(dim=256, ffn_dim=512, num_heads=2, num_layers=3, text_dim=256)
    q = quantize_model(init_random_weight_dict_on_device(arch, seed=5, device=dev), "int8")
    assert q["blocks.0.ffn.0.weight"].device.type == "cuda"
    save_quantized(q, str(tmp_path), "blocks", "int8")
    back = load_file(str(tmp_path / "block_1.safetensors"))
    for k, v in back.items():
        assert v.dtype == q[k].dtype and torch.equal(v, q[k].cpu()), k
    store = LazyBlockStore(str(tmp_path), arch, device=dev)
    with BlockPrefetcher(store, num_workers=2, max_host_bytes=None, pin=True) as pf:
        streamer = BlockStreamer(pf, dev)
        for _ in range(2):
            for i, blk in enumerate(streamer):
                assert torch.equal(blk["ffn"]["2"]["w"], q[f"blocks.{i}.ffn.2.weight"])
                assert torch.equal(blk["cross_attn"]["k"]["w_scale"], q[f"blocks.{i}.cross_attn.k.weight_scale"])
        torch.cuda.synchronize()
        assert streamer.take_stats()["disk_bytes"] > 0


def test_tiny_vae_decode_on_card(dev):
    """The taew2_1 decoder (seed 2, as the runner draws it) on the card
    against the same decode on the CPU, whole and in chunks of 2 latent
    frames. Bar: relative L2 1e-2 (TF32 convolutions on the card against
    fp32 on the CPU; the random decoder's outputs reach ~1e3)."""
    from lightx2v_tpu_torch.vae.tiny_vae import init_random_tiny_vae_params, tiny_decode

    params = init_random_tiny_vae_params(seed=2)
    lat = torch.randn((1, 5, 8, 12, 16), generator=torch.Generator().manual_seed(0))
    ref = tiny_decode(params, lat)
    card = init_random_tiny_vae_params(seed=2, device=dev)
    for chunk in (None, 2):
        out = tiny_decode(card, lat.to(dev), chunk=chunk).cpu()
        assert out.shape == ref.shape == (1, 17, 64, 96, 3)
        assert float((out - ref).norm() / ref.norm()) < 1e-2


def test_vae_int8_conv_on_card(dev):
    """The int8 decoder conv (fp32 sums of exact code products through
    cuDNN) against its plain version in fp64 on the CPU (the int32 sums):
    a causal 3x3x3 conv with a temporal cache and a 1x1x1 conv. Bar: 1e-5 of
    the output's max (fp32 rounding of sums up to 127^2 * 3456)."""
    from lightx2v_tpu_torch.vae.wan_vae import cconv3d, quantize_vae_decoder_int8

    g = torch.Generator().manual_seed(1)
    for k, cin in ((3, 128), (1, 384)):
        conv = {"w": torch.randn((96, cin, k, k, k), generator=g) * 0.05, "b": torch.randn((96,), generator=g)}
        q = quantize_vae_decoder_int8({"decoder": {"conv": conv}})["decoder"]["conv"]
        assert q["w"].dtype == torch.int8
        x = torch.randn((1, cin, 4, 20, 28), generator=g)
        cache = torch.randn((1, cin, 2, 20, 28), generator=g) if k == 3 else None
        ref = cconv3d(q, x, cache)
        out = cconv3d({n: v.to(dev) for n, v in q.items()}, x.to(dev), None if cache is None else cache.to(dev))
        assert out.dtype == torch.float32
        _close(out.cpu(), ref, 1e-5, 0.0)


@pytest.mark.parametrize("mode", ["TaylorSeer", "Ada", "Custom"])
def test_streamed_caching_on_card(dev, mode):
    """A tiny streamed denoise with caching on the card (the host-RAM tier,
    pinned blocks and staged state): every skip step copies no block (0
    bytes) and copies its staged state in; a calc step copies every block;
    the latents are finite and within 2e-2 (relative L2) of the same run on
    the CPU."""
    from lightx2v_tpu_torch import infer
    from lightx2v_tpu_torch.utils.config import set_config

    linear = [[1.0, 0.0], [1.0, 0.0]]
    extra = {"TaylorSeer": dict(taylor_pattern=2, infer_steps=4), "Ada": dict(infer_steps=5),
             "Custom": dict(coefficients=linear, teacache_thresh=1.0, infer_steps=5)}[mode]
    cfg = dict(model_cls="wan2.1", task="t2v", synthetic_weights=True, prompt="a red panda", seed=42,
               enable_cfg=False, target_video_length=9, target_height=64, target_width=96, sample_shift=5,
               latent_init="torch", text_len=64, cpu_offload=True, feature_caching=mode, dim=256, ffn_dim=512,
               num_heads=2, num_layers=2, text_dim=256, **extra)
    lats = {}
    for d in ("cuda", "cpu"):
        r = infer.init_runner(set_config(dict(cfg, device=d)))
        lats[d] = r.run_dit(r.run_input_encoder()).float().cpu()
        calc = r.timings["calc_steps"]
        assert any(calc) and not all(calc), calc
        nbytes = r.model["blocks"].num_blocks * r.model["blocks"].layout.nbytes
        for c, st in zip(calc, r.timings["offload"]):
            assert st["h2d_bytes"] == (nbytes if c else 0) and (c or st["cache_h2d_bytes"] > 0), (calc, st)
    assert torch.isfinite(lats["cuda"]).all()
    assert float((lats["cuda"] - lats["cpu"]).norm() / lats["cpu"].norm()) < 2e-2
