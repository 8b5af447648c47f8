"""Layered run config: defaults <- CLI args <- task config JSON <-
``{model_path}/config.json`` <- quantized-checkpoint config.json, plus the
i2v video-length fix. Same merge order as ``lightx2v_tpu.utils.config``."""

from __future__ import annotations

import json
import os
from typing import Any, Dict


class ConfigDict(dict):
    """dict with attribute-style access; nested dicts are wrapped lazily."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def copy(self) -> "ConfigDict":
        return ConfigDict({k: (ConfigDict(v).copy() if isinstance(v, dict) else v) for k, v in self.items()})


def get_default_config() -> Dict[str, Any]:
    return {
        "do_mm_calib": False,
        "cpu_offload": False,
        "parallel_attn_type": None,
        "parallel_vae": False,
        "max_area": False,
        "vae_stride": (4, 8, 8),
        "patch_size": (1, 2, 2),
        "feature_caching": "NoCaching",
        "teacache_thresh": 0.26,
        "use_ret_steps": False,
        "use_bfloat16": True,
        "lora_configs": None,
        "mm_config": {},
        "use_prompt_enhancer": False,
        "mesh_shape": None,
        "attention_impl": None,
        "weight_streaming": False,
    }


def load_json(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return json.load(f)


def set_config(args: Any) -> ConfigDict:
    """Merge config layers. ``args`` is an argparse.Namespace or dict."""
    config = ConfigDict(get_default_config())
    ns = vars(args) if not isinstance(args, dict) else args
    config.update({k: v for k, v in ns.items()})

    if config.get("config_json"):
        config.update(load_json(config["config_json"]))

    model_cfg_path = os.path.join(config.get("model_path", "") or "", "config.json")
    if config.get("model_path") and os.path.exists(model_cfg_path):
        config.update(load_json(model_cfg_path))

    if config.get("dit_quantized_ckpt"):
        qcfg = os.path.join(config["dit_quantized_ckpt"], "config.json")
        if os.path.exists(qcfg):
            config.update(load_json(qcfg))

    if config.get("task") == "i2v":
        tvl = config.get("target_video_length", 81)
        stride_t = config["vae_stride"][0]
        if tvl % stride_t != 1:
            config["target_video_length"] = tvl // stride_t * stride_t + 1

    return config
