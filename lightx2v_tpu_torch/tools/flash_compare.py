"""Times the dense flash kernel of one checkout on the card, to compare two
checkouts on the same card in turns (parent, change, change, parent):

    python3 lightx2v_tpu_torch/tools/flash_compare.py ROOT

imports ``lightx2v_tpu_torch`` from the checkout at ROOT, holds
``flash_attention_with_lse`` against its plain version on small ragged cases
(and its output bit-equal to ``flash_attention``'s) and the 64-wide
``flash_attention`` on small ragged cases (query and key counts around the
128- and 192-row tiles, a 1-key and a 50-key last key tile, kv_len inside a
tile), then prints one line: ROOT, the CUDA-event median ms of
``flash_attention`` at the main path's cross-attention shape (q 32,760 x 512
keys, 40 heads; 40 calls) and self-attention shape (32,760^2; 10 calls), of
the two-pass radial LSE passes (21 x 1560 q x 6240 k; 8 x 195 x 11,505), of
the 64-wide kernel at CogVideoX's joint stream (2, 45,106, 48, 64; 10
calls, ``d64``) and of ``F.scaled_dot_product_attention`` on the same q, k,
v (``sdpa_d64``, a yardstick the port never calls), and the card's SM clock
and power draw just after.
"""

from __future__ import annotations

import json
import subprocess
import sys

SMALL = ((2, 200, 200, None), (2, 7, 513, 300), (1, 1000, 512, None), (21, 156, 624, None), (1, 300, 2000, 1500))
SMALL64 = ((2, 193, 385, None), (1, 384, 434, 300), (2, 178, 200, None), (1, 383, 129, None), (1, 1000, 1100, 1000))


def cuda_ms(fn, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` calls after one warm-up call, each
    call timed with CUDA events (the timer of ``chip_smoke.py``)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return float(times[len(times) // 2])


def main(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from lightx2v_tpu_torch.ops.cuda import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("flash_compare.py: no CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    for b, sq, sk, kv_len in SMALL:
        q, k, v = rnd(b, sq, 3, 128), rnd(b, sk, 3, 128), rnd(b, sk, 3, 128)
        out, lse = fa.flash_attention_with_lse(q, k, v, kv_len=kv_len)
        ref, ref_lse = fa.flash_attention_with_lse_plain(q, k, v, kv_len)
        err = float((out.float() - ref.float()).abs().max())
        # bars of tests/test_torch_cuda.py
        if not (err <= 2e-3 + 2e-2 * float(ref.float().abs().max()) and float((lse - ref_lse).abs().max()) <= 1e-3
                and torch.equal(out, fa.flash_attention(q, k, v, kv_len=kv_len))):
            raise SystemExit(f"flash_compare.py: ({b}, {sq}, {sk}, {kv_len}) off its plain version: {err}")
    for b, sq, sk, kv_len in SMALL64:
        q, k, v = rnd(b, sq, 3, 64), rnd(b, sk, 3, 64), rnd(b, sk, 3, 64)
        out, ref = fa.flash_attention(q, k, v, kv_len=kv_len), fa.flash_attention_plain(q, k, v, kv_len)
        err = float((out.float() - ref.float()).abs().max())
        if not err <= 2e-3 + 2e-2 * float(ref.float().abs().max()):
            raise SystemExit(f"flash_compare.py: d64 ({b}, {sq}, {sk}, {kv_len}) off its plain version: {err}")
    s, heads = 32760, 40
    q, k, v = rnd(1, s, heads, 128), rnd(1, s, heads, 128), rnd(1, s, heads, 128)
    kc, vc = rnd(1, 512, heads, 128), rnd(1, 512, heads, 128)
    qn, kn, vn = rnd(21, 1560, heads, 128), rnd(21, 6240, heads, 128), rnd(21, 6240, heads, 128)
    qf, kf, vf = rnd(8, 195, heads, 128), rnd(8, 11505, heads, 128), rnd(8, 11505, heads, 128)
    times = {"cross": cuda_ms(lambda: fa.flash_attention(q, kc, vc), 40),
             "self": cuda_ms(lambda: fa.flash_attention(q, k, v), 10),
             "near": cuda_ms(lambda: fa.flash_attention_with_lse(qn, kn, vn), 10),
             "far": cuda_ms(lambda: fa.flash_attention_with_lse(qf, kf, vf), 40)}
    del q, k, v, kc, vc, qn, kn, vn, qf, kf, vf
    q, k, v = rnd(2, 45106, 48, 64), rnd(2, 45106, 48, 64), rnd(2, 45106, 48, 64)
    times["d64"] = cuda_ms(lambda: fa.flash_attention(q, k, v), 10)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    times["sdpa_d64"] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), 10)
    card = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(root, json.dumps(times), card, flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
