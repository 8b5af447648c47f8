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


@pytest.mark.parametrize("sq,sk,kv_len", [(200, 200, None), (256, 256, None), (200, 200, 150), (300, 64, None),
                                          (7, 513, 300)])
def test_flash_kernel_vs_plain(dev, sq, sk, kv_len):
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(sq + sk)
    q, k, v = (torch.randn((2, s, 3, 128), generator=g, device=dev).to(torch.bfloat16) for s in (sq, sk, sk))
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, kv_len=kv_len)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    # bar: bf16 P rounded at different running maxima, summation order
    _close(out, fa.flash_attention_plain(q, k, v, kv_len), 2e-2, 2e-3)


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
    _close(fa.flash_attention_fused_rope(q, k, v, cos, sin), fa.flash_attention_fused_rope_plain(q, k, v, cos, sin),
           2e-2, 2e-3)


def test_flash_refuses_bad_input(dev):
    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa

    with pytest.raises(ValueError):
        fa.flash_attention(*(torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.bfloat16) for _ in range(3)))


@pytest.mark.parametrize("m,n,k,act", [(200, 200, 256, None), (37, 384, 4096, "gelu"), (512, 136, 96, None)])
def test_fullk_kernel_vs_plain(dev, m, n, k, act):
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    g = torch.Generator(device=dev).manual_seed(m + n + k)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    ws = torch.rand((n,), generator=g, device=dev) * 1e-3
    b = torch.randn((n,), generator=g, device=dev) * 0.1
    # bar: same codes, exact int32 sums, same fp32 epilogue; bf16 ties aside
    _close(wm.w8a8_matmul_fullk(x, w, ws, b, act=act), wm.w8a8_matmul_fullk_plain(x, w, ws, b, act=act),
           2 ** -7, 0.0)


@pytest.mark.parametrize("h", [384, 8960, 13824])
def test_ffn_kernel_vs_plain(dev, h):
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    g = torch.Generator(device=dev).manual_seed(h)
    m, k, n = 70, 256, 128
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w0 = torch.randint(-127, 128, (h, k), generator=g, device=dev, dtype=torch.int8)
    w2 = torch.randint(-127, 128, (n, h), generator=g, device=dev, dtype=torch.int8)
    s0, s2 = torch.full((h,), 0.02 / 127, device=dev), torch.full((n,), 0.02 / 127, device=dev)
    b0, b2 = torch.randn((h,), generator=g, device=dev) * 0.02, torch.randn((n,), generator=g, device=dev) * 0.02
    # bar: a tanh ulp can flip a rare hidden code by one step
    _close(wm.ffn_w8a8(x, w0, s0, b0, w2, s2, b2), wm.ffn_w8a8_plain(x, w0, s0, b0, w2, s2, b2), 2e-2, 0.0)


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
                                              (513, 256, 384, 128, True), (1, 130, 768, 256, False)])
def test_w4a8_kernel_vs_plain(dev, m, n, k, group, bias):
    """Ragged M and N, odd group counts (27 at K = 13,824), groups of 128,
    256 and 512."""
    from lightx2v_tpu_torch.ops.cuda import w4a8_matmul as w4

    g = torch.Generator(device=dev).manual_seed(m + n + k)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w, ws = _packed(g, dev, n, k, group)
    b = torch.randn((n,), generator=g, device=dev) * 0.1 if bias else None
    # bar: same codes, exact int32 group sums, same fp32 order; bf16 ties aside
    _close(w4.w4a8_matmul(x, w, ws, b), w4.w4a8_matmul_plain(x, w, ws, b), 2 ** -7, 0.0)


@pytest.mark.parametrize("m,k,h,n", [(70, 512, 13824, 128), (33, 1024, 768, 256), (129, 256, 384, 64)])
def test_ffn_w4a8_kernel_vs_plain(dev, m, k, h, n):
    """bh = 512 (27 hidden groups), 256 and 128."""
    from lightx2v_tpu_torch.ops.cuda import w4a8_matmul as w4
    from lightx2v_tpu_torch.tools.convert import _pick_bk

    g = torch.Generator(device=dev).manual_seed(h + k)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w0, s0 = _packed(g, dev, h, k, _pick_bk(k))
    w2, s2 = _packed(g, dev, n, h, _pick_bk(h))
    b0, b2 = torch.randn((h,), generator=g, device=dev) * 0.02, torch.randn((n,), generator=g, device=dev) * 0.02
    # bar: a tanh ulp can flip a rare hidden code by one step
    _close(w4.ffn_w4a8(x, w0, s0, b0, w2, s2, b2), w4.ffn_w4a8_plain(x, w0, s0, b0, w2, s2, b2), 2e-2, 0.0)


@pytest.mark.parametrize("m,n,k,act", [(37, 136, 10240, None), (200, 256, 2560, "gelu"), (8, 64, 8320, None)])
def test_kblocked_w8a8_kernel_vs_plain(dev, m, n, k, act):
    """k-blocks of 1024, 512 and 128 (K = 8320 = 65 * 128)."""
    from lightx2v_tpu_torch.ops.cuda import w8a8_matmul as wm

    g = torch.Generator(device=dev).manual_seed(m + k)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
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


@pytest.mark.parametrize("s,bq,bk,nnz", [(600, 128, 128, 3), (1000, 256, 256, 3), (2100, 1024, 512, 2)])
def test_block_sparse_kernel_vs_plain(dev, s, bq, bk, nnz):
    from lightx2v_tpu_torch.ops.cuda import block_sparse_attention as bsa

    g = torch.Generator(device=dev).manual_seed(s)
    q, k, v = (torch.randn((2, s, 3, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    bq_, bk_ = bsa.clamp_blocks(s, s, bq, bk)
    idx, cnt = _tables(dev, 6, -(-s // bq_), -(-s // bk_), nnz, s)
    out = bsa.block_sparse_attention(q, k, v, idx, cnt, bq=bq, bk=bk)
    # bar: bf16 P rounded at different running maxima, summation order
    _close(out, bsa.block_sparse_attention_plain(q, k, v, idx, cnt, bq=bq, bk=bk), 2e-2, 2e-3)


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
