"""Capability detection and memory-based auto-configuration (counterpart
of ``lightx2v_tpu.server.autoconfig``), probing ``torch.cuda``: which
attention types and quant schemes the port runs (and whether their
hand-written CUDA kernels can launch here), the registered runners, the
card's memory and the host's RAM; the decision tree sizes the resident and
offload tiers as the JAX package's does."""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import torch


def available_attention_ops() -> List[Tuple[str, bool]]:
    """(attention type, native kernel available): every type registered in
    the port's ``ATTN_REGISTER``; native means that a CUDA device is there
    (on the CPU each runs its plain version)."""
    from ..ops import attention  # noqa: F401  (registers the types)
    from ..utils.registry import ATTN_REGISTER

    cuda = torch.cuda.is_available()
    return [(name, cuda) for name in ATTN_REGISTER.keys()]


# supported tasks per model class (the web UI's model/task matrix)
_MODEL_TASKS = {
    "wan2.1": ("t2v", "i2v"),
    "wan2.1_distill": ("t2v", "i2v"),
    "wan2.1_causvid": ("t2v",),
    "wan2.1_skyreels_v2_df": ("t2v", "i2v"),
    "wan2.1_audio": ("audio",),
    "hunyuan": ("t2v", "i2v"),
    "cogvideox": ("t2v",),
}


def model_matrix() -> List[Dict[str, Any]]:
    """Registered model classes and their tasks, from the live
    ``RUNNER_REGISTER`` (an unregistered runner never shows up)."""
    from .. import infer  # noqa: F401  (registers the runners)
    from ..utils.registry import RUNNER_REGISTER

    return [{"model_cls": k, "tasks": list(_MODEL_TASKS.get(k, ("t2v",)))}
            for k in sorted(RUNNER_REGISTER.keys())]


def available_quant_schemes() -> List[Tuple[str, bool]]:
    """int8 and fp8 W8A8 and the int4 schemes run hand-written kernels;
    block-128 fp8 runs the group-rescaled fp8 GEMMs in torch ops
    (``ops/linear._mm_fp8_block128``)."""
    return [("bf16", True), ("int8", True), ("fp8", True),
            ("fp8_block128", True), ("int4", True)]


def device_info() -> Dict[str, Any]:
    cuda = torch.cuda.is_available()
    info: Dict[str, Any] = {
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "hbm_gb": round(torch.cuda.get_device_properties(0).total_memory / (1 << 30), 1) if cuda else None,
        "host_ram_gb": None,
    }
    try:
        info["host_ram_gb"] = round(
            os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / (1 << 30), 1)
    except (ValueError, OSError):
        pass
    return info


# bf16 parameter footprints of the supported DiT sizes
_MODEL_GB = {"1.3b": 2.6, "14b": 28.0}


def auto_configure(resolution: str = "832x480", model_size: str = "14b",
                   hbm_gb: float = None, host_ram_gb: float = None) -> Dict[str, Any]:
    """Memory-based recommended settings:

    * model fits device memory with headroom -> everything resident, bf16;
    * model fits device memory only quantized -> int8 resident;
    * model over device memory but fits host RAM -> host-RAM block
      streaming (cpu_offload) + int8;
    * model over host RAM too -> disk tier (lazy_load) + int8;
    * 720P-class output -> tiled VAE decode.
    """
    dev = device_info()
    hbm = hbm_gb if hbm_gb is not None else (dev["hbm_gb"] or 16.0)
    host = host_ram_gb if host_ram_gb is not None else (dev["host_ram_gb"] or 32.0)
    model_gb = _MODEL_GB.get(model_size.lower(), 28.0)

    w, h = (int(v) for v in resolution.lower().split("x"))
    is_720p = min(w, h) >= 700 or max(w, h) >= 1100

    cfg: Dict[str, Any] = {
        "attention_type": "flash_attn3",
        "quant_scheme": "bf16",
        "mm_type": "Default",
        "cpu_offload": False,
        "lazy_load": False,
        "weight_streaming": False,
        "tiny_vae": False,
        "use_tiling_vae": bool(is_720p),
        "feature_caching": "NoCaching",
        "teacache_thresh": 0.26,
        "rope_fused": True,
    }

    # activation + VAE working set headroom (GB) at each resolution class
    headroom = 4.0 if is_720p else 2.5
    if model_gb + headroom <= hbm:
        return cfg  # fully resident bf16

    int8_gb = model_gb / 2
    cfg["quant_scheme"] = "int8"
    cfg["mm_type"] = "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu"
    if int8_gb + headroom <= hbm:
        return cfg  # resident int8

    cfg["weight_streaming"] = True
    cfg["cpu_offload"] = True
    cfg["tiny_vae"] = True
    if int8_gb + 4.0 <= host:
        return cfg  # host-RAM block streaming

    cfg["lazy_load"] = True  # disk tier: bounded host buffer
    cfg["max_memory"] = max(2.0, round(host / 4, 1))
    cfg["num_disk_workers"] = 2
    return cfg


def service_metadata(server_config: Dict[str, Any] = None) -> Dict[str, Any]:
    """Payload for GET /v1/service/metadata (read by the web UI)."""
    meta = {
        "attention_ops": available_attention_ops(),
        "quant_schemes": available_quant_schemes(),
        "device": device_info(),
        "model_matrix": model_matrix(),
    }
    if server_config:
        meta["model_cls"] = server_config.get("model_cls")
        meta["task"] = server_config.get("task", "t2v")
        # the scheme the server loaded with (quantization is a load-time property; the UI shows it as the active
        # selection)
        mm = (server_config.get("mm_config") or {}).get("mm_type", "Default")
        meta["active_quant_scheme"] = (
            "bf16" if mm in ("Default", "Default-Force-FP32") else
            "fp8_block128" if "block128" in mm else
            "int4" if "int4" in mm else
            "int8" if "int8" in mm else
            "fp8" if "fp8" in mm else "bf16")
        meta["defaults"] = {
            "infer_steps": server_config.get("infer_steps"),
            "seed": server_config.get("seed", 42),
            "target_height": server_config.get("target_height"),
            "target_width": server_config.get("target_width"),
            "target_video_length": server_config.get("target_video_length"),
            "sample_guide_scale": server_config.get("sample_guide_scale"),
        }
        res = f"{server_config.get('target_width', 832)}x{server_config.get('target_height', 480)}"
        size = "14b" if server_config.get("dim", 1536) >= 5120 else "1.3b"
        meta["auto_config"] = auto_configure(res, size)
    return meta
