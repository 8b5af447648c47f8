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
