"""Checkpoint validation, one command with a pass/fail report (counterpart of
``lightx2v_tpu.tools.validate_ckpt``).

    python -m lightx2v_tpu_torch.tools.validate_ckpt --model_cls wan2.1 --ckpt CKPT \
        [--component dit|vae|tiny_vae] [--task i2v] [--no-forward] \
        [--ref-frames ref.npy --gen-frames out.npy] [--device cpu]

1. **Key coverage**: the raw state dict is read, the port's loader replays
   it through a recording dict, and the report gives the keys consumed,
   missing (asked for and absent) and unused (present and never asked for).
2. **One forward** (Wan DiTs): a 32-token forward at the checkpoint's real
   dims on the card (``--device cpu`` for the host), finite outputs and the
   seconds. The linears run the ``mm_type`` of the ``config.json`` beside
   the checkpoint (the converter writes one), else ``Default``.
3. **PSNR** (optional): ``tools/psnr`` of two frame files (35 dB bar).

Components: the Wan, HunyuanVideo and CogVideoX DiTs (safetensors, a
directory of them, or a torch ``.pt`` / ``.pth``), their VAEs
(``--component vae``) and the taew2_1 tiny VAE (``--component tiny_vae``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch


class RecordingDict(dict):
    """Flat state dict that records the keys asked for (by ``[]``, ``in`` or
    ``get``) and the ones read with ``[]`` and absent."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.requested: set = set()
        self.missing: set = set()

    def __getitem__(self, k):
        self.requested.add(k)
        try:
            return super().__getitem__(k)
        except KeyError:
            self.missing.add(k)
            raise

    def __contains__(self, k):
        self.requested.add(k)
        return super().__contains__(k)

    def get(self, k, default=None):
        self.requested.add(k)
        return super().get(k, default)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A safetensors file or directory (``load_sharded``), or a torch
    ``.pt`` / ``.pth`` / ``.tar`` (its ``state_dict`` where it has one)."""
    from ..utils.safetensors_io import load_file, load_sharded

    if os.path.isdir(path):
        return load_sharded(path)
    if path.endswith((".pt", ".pth", ".tar")):
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(raw, dict) and "state_dict" in raw:
            raw = raw["state_dict"]
        return dict(raw)
    return load_file(path)


def _report_keys(name: str, sd: RecordingDict, ignore_unused=()) -> Dict[str, Any]:
    unused = sorted(k for k in sd.keys() - sd.requested if not any(k.startswith(p) for p in ignore_unused))
    out = {"component": name, "total_keys": len(sd), "consumed": len(sd.requested & sd.keys()),
           "missing": sorted(sd.missing), "unused": unused}
    out["key_coverage_ok"] = not sd.missing and not unused
    return out


def _mm_type(args) -> str:
    cfg = os.path.join(args.ckpt, "config.json") if os.path.isdir(args.ckpt) else None
    if cfg and os.path.exists(cfg):
        with open(cfg) as f:
            return json.load(f).get("mm_type", "Default")
    return "Default"


# ---------------------------------------------------------------- handlers


def validate_wan(sd: Dict[str, torch.Tensor], args) -> List[Dict[str, Any]]:
    from ..models.wan.config import WanArch
    from ..models.wan.model import wan_forward
    from ..models.wan.weights import load_wan_params
    from ..ops.rope import build_wan_rope_grid

    num_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    dim = sd["blocks.0.self_attn.q.weight"].shape[0]
    kw = dict(dim=dim, ffn_dim=sd["blocks.0.ffn.0.weight"].shape[0], num_heads=args.num_heads or dim // 128,
              num_layers=num_layers, in_dim=sd["patch_embedding.weight"].shape[1],
              out_dim=sd["head.head.weight"].shape[0] // 4, freq_dim=sd["time_embedding.0.weight"].shape[1],
              text_dim=sd["text_embedding.0.weight"].shape[1],
              task="i2v" if "blocks.0.cross_attn.k_img.weight" in sd else args.task)
    if "img_emb.proj.1.weight" in sd:
        kw["clip_dim"] = sd["img_emb.proj.1.weight"].shape[1]
    arch = WanArch(**kw)
    rec = RecordingDict(sd)
    dev = torch.device(args.device)
    params = load_wan_params(rec, arch, device=dev)
    reports = [_report_keys(f"wan dit (dim={arch.dim}, L={arch.num_layers})", rec)]
    if not args.no_forward:
        mm_type = _mm_type(args)
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)

        def randn(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

        lat = randn(1, 16, 2, 8, 8)
        y = randn(1, arch.in_dim - 16, 2, 8, 8) if arch.in_dim > 16 else None
        clip_fea = randn(1, 257, arch.clip_dim) if arch.task == "i2v" else None
        ctx = randn(1, arch.text_len, arch.text_dim)
        cos, sin = build_wan_rope_grid(arch.head_dim, 2, 4, 4)
        out = wan_forward(params, lat, torch.tensor([500.0], device=dev), ctx, torch.from_numpy(cos).to(dev),
                          torch.from_numpy(sin).to(dev), arch, y=y, clip_fea=clip_fea, mm_type=mm_type,
                          self_attn_type="xla", cross_attn_type="xla")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        reports.append({"component": "wan dit forward", "ok": bool(torch.isfinite(out).all()),
                        "seconds": round(time.perf_counter() - t0, 2), "output_shape": list(out.shape),
                        "mm_type": mm_type, "device": str(dev)})
    return reports


def validate_hunyuan(sd: Dict[str, torch.Tensor], args) -> List[Dict[str, Any]]:
    from ..models.hunyuan.config import HunyuanArch
    from ..models.hunyuan.weights import load_hunyuan_params

    n_double = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("double_blocks."))
    n_single = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("single_blocks."))
    dim = sd["img_in.proj.weight"].shape[0]
    arch = HunyuanArch(hidden_size=dim, heads_num=args.num_heads or dim // 128, double_blocks=n_double,
                       single_blocks=n_single, mlp_hidden_dim=sd["double_blocks.0.img_mlp.fc1.weight"].shape[0])
    rec = RecordingDict(sd)
    load_hunyuan_params(rec, arch)
    return [_report_keys(f"hunyuan dit (dim={dim}, {n_double}d+{n_single}s)", rec)]


def validate_cog(sd: Dict[str, torch.Tensor], args) -> List[Dict[str, Any]]:
    from ..models.cogvideox.config import CogArch
    from ..models.cogvideox.weights import load_cog_params

    prefix = "transformer_blocks."
    n_layers = 1 + max(int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix))
    dim = sd["transformer_blocks.0.attn1.to_q.weight"].shape[0]
    arch = CogArch(num_layers=n_layers, num_heads=args.num_heads or dim // 64)
    rec = RecordingDict(sd)
    load_cog_params(rec, arch)
    return [_report_keys(f"cogvideox dit (dim={dim}, L={n_layers})", rec)]


def validate_vae(sd: Dict[str, torch.Tensor], args) -> List[Dict[str, Any]]:
    """The VAE's loader over every key, the encoder's included."""
    fam = args.model_cls
    rec = RecordingDict(sd)
    if fam.startswith("wan"):
        from ..vae.wan_vae import load_wan_vae_params

        load_wan_vae_params(rec)
        name = "wan vae"
    elif fam == "hunyuan":
        from ..vae.hunyuan_vae import HunyuanVAEConfig, load_hunyuan_vae_params

        boc = tuple(sd[f"encoder.down_blocks.{i}.resnets.0.conv1.conv.weight"].shape[0] for i in range(4))
        lpb = sum(1 for k in sd if k.startswith("encoder.down_blocks.0.resnets.") and k.endswith(".conv1.conv.weight"))
        cfg = HunyuanVAEConfig(block_out_channels=boc, layers_per_block=lpb,
                               latent_channels=sd["post_quant_conv.weight"].shape[1], norm_num_groups=args.vae_groups)
        load_hunyuan_vae_params(rec, cfg, encoder=True)
        name = "hunyuan vae"
    else:
        from ..vae.cogvideox_vae import CogVAEConfig, load_cog_vae_params

        boc = tuple(sd[f"encoder.down_blocks.{i}.resnets.0.conv1.conv.weight"].shape[0] for i in range(4))
        cfg = CogVAEConfig(block_out_channels=boc, latent_channels=sd["decoder.conv_in.conv.weight"].shape[1])
        load_cog_vae_params(rec, cfg, encoder=True)
        name = "cogvideox vae"
    return [_report_keys(name, rec)]


def validate_tiny_vae(sd: Dict[str, torch.Tensor], args) -> List[Dict[str, Any]]:
    from ..vae.tiny_vae import convert_taehv_state_dict

    rec = RecordingDict(sd)
    convert_taehv_state_dict(rec)
    return [_report_keys("tiny vae (taehv)", rec)]


# ---------------------------------------------------------------- command line


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_cls", required=True,
                   choices=["wan2.1", "wan2.1_distill", "wan2.1_audio", "hunyuan", "cogvideox"])
    p.add_argument("--ckpt", required=True, help="checkpoint dir / .safetensors / .pt")
    p.add_argument("--component", default="dit", choices=["dit", "vae", "tiny_vae"])
    p.add_argument("--task", default="t2v", choices=["t2v", "i2v"])
    p.add_argument("--num_heads", type=int, default=None, help="override head count (shape inference can't see it)")
    p.add_argument("--vae_groups", type=int, default=32, help="GroupNorm group count (invisible to shape inference)")
    p.add_argument("--no-forward", action="store_true", help="skip the forward pass (key coverage only)")
    p.add_argument("--ref-frames", default=None, help="reference frames (.npy / .npz / video) for PSNR")
    p.add_argument("--gen-frames", default=None, help="generated frames for PSNR")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the forward runs (default cuda; cuda without a GPU raises)")
    return p


def validate(args) -> List[Dict[str, Any]]:
    """The reports for parsed ``args`` (``build_parser``)."""
    from ..utils.device import resolve_device

    args.device = str(resolve_device(args.device))
    sd = load_state_dict(args.ckpt)
    print(f"loaded {len(sd)} tensors from {args.ckpt}")
    if args.component == "vae":
        reports = validate_vae(sd, args)
    elif args.component == "tiny_vae":
        reports = validate_tiny_vae(sd, args)
    elif args.model_cls.startswith("wan"):
        reports = validate_wan(sd, args)
    elif args.model_cls == "hunyuan":
        reports = validate_hunyuan(sd, args)
    else:
        reports = validate_cog(sd, args)
    if args.ref_frames and args.gen_frames:
        from .psnr import load_frames, psnr

        ref, got = load_frames(args.ref_frames), load_frames(args.gen_frames)
        n = min(len(ref), len(got))
        val = psnr(ref[:n], got[:n])
        reports.append({"component": "psnr", "db": round(val, 2), "ok": val >= 35.0, "target_db": 35.0})
    return reports


def main(argv=None) -> int:
    reports = validate(build_parser().parse_args(argv))
    ok = True
    for r in reports:
        ok &= bool(r.get("key_coverage_ok", r.get("ok", False)))
        print(json.dumps(r, indent=2))
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
