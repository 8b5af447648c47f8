"""LoRA extraction and merging (counterpart of ``lightx2v_tpu.tools.lora``).

    python -m lightx2v_tpu_torch.tools.lora extract --base BASE_DIR --tuned TUNED_DIR --output lora.safetensors
    python -m lightx2v_tpu_torch.tools.lora merge --base BASE_DIR --lora lora.safetensors --output merged.safetensors

extract: the difference of two checkpoints as rank-``rank`` (A, B) factors
per 2-D weight (a truncated SVD in fp32, ``torch.linalg.svd``), and as
full diffs for the other tensors. merge: ``convert.apply_lora``.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

from ..utils.logging_utils import logger
from ..utils.safetensors_io import as_tensor, load_file, load_sharded, save_file
from .convert import apply_lora


def extract_lora(base: Dict[str, Any], tuned: Dict[str, Any], rank: int = 32, threshold: float = 1e-6,
                 prefix: str = "diffusion_model.", device=None) -> Dict[str, torch.Tensor]:
    """LoRA tensors with ``tuned - base ≈ b @ a`` per 2-D weight wider than
    ``rank`` (b = U sqrt(S), a = sqrt(S) V^T), ``.diff`` / ``.diff_b``
    for the others; tensors whose difference stays under ``threshold`` are
    left out. Computes on ``device`` (default: where each tensor lies);
    returns fp32 tensors there."""
    out: Dict[str, torch.Tensor] = {}
    for name, w0 in base.items():
        if name not in tuned:
            continue
        w0 = as_tensor(w0)
        dev = device if device is not None else w0.device
        diff = as_tensor(tuned[name]).to(dev, torch.float32) - w0.to(dev, torch.float32)
        if float(diff.abs().max()) < threshold:
            continue
        stem = name[: -len(".weight")] if name.endswith(".weight") else name
        if diff.ndim == 2 and min(diff.shape) > rank:
            u, s, vt = torch.linalg.svd(diff, full_matrices=False)
            sq = s[:rank].sqrt()
            out[f"{prefix}{stem}.lora_A.weight"] = (sq[:, None] * vt[:rank]).contiguous()  # (r, in)
            out[f"{prefix}{stem}.lora_B.weight"] = (u[:, :rank] * sq).contiguous()  # (out, r)
        elif name.endswith(".bias"):
            out[prefix + name[: -len(".bias")] + ".diff_b"] = diff
        else:
            out[prefix + stem + ".diff"] = diff
    logger.info(f"extracted {len(out)} LoRA tensors")
    return out


def main(argv=None):
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser(description="LoRA extract / merge")
    sub = p.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("extract")
    ex.add_argument("--base", required=True)
    ex.add_argument("--tuned", required=True)
    ex.add_argument("--output", required=True)
    ex.add_argument("--rank", type=int, default=32)
    mg = sub.add_parser("merge")
    mg.add_argument("--base", required=True)
    mg.add_argument("--lora", required=True)
    mg.add_argument("--strength", type=float, default=1.0)
    mg.add_argument("--output", required=True)
    for sp in (ex, mg):
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the SVD or the fold runs (default cuda; cuda without a GPU raises)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.cmd == "extract":
        lora = extract_lora(load_sharded(args.base), load_sharded(args.tuned), rank=args.rank, device=device)
        save_file(lora, args.output)
    else:
        base = load_sharded(args.base)
        apply_lora(base, load_file(args.lora), args.strength, device=device)
        save_file(base, args.output)


if __name__ == "__main__":
    main()
