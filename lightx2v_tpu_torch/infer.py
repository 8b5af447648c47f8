"""CLI offline inference on the port:

    python -m lightx2v_tpu_torch.infer --model_cls wan2.1_distill --task t2v \
        --config_json configs/deploy/wan_t2v.json --synthetic_weights --device cuda

The flags of ``lightx2v_tpu.infer``, with ``--device {cuda,cpu}`` (default
cuda) in place of ``--platform``. Runs on the CUDA device unless
``--device cpu`` is given; with no GPU, ``cuda`` raises.
"""

from __future__ import annotations

import argparse

import torch

from .runners import (cogvideox_runner, hunyuan_runner, wan_audio_runner,  # noqa: F401  (registers runners)
                      wan_causvid_runner, wan_runner, wan_skyreels_v2_df_runner)
from .utils.config import set_config
from .utils.logging_utils import logger
from .utils.media import seed_all, video_writer
from .utils.registry import RUNNER_REGISTER


def set_numerics():
    """fp32 matmuls stay full fp32 (the time embedding and the Default GEMMs
    accumulate in fp32); cuDNN convolutions (the VAE) run in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True


def init_runner(config):
    seed_all(int(config.get("seed", 42)))
    set_numerics()
    if config["model_cls"] not in RUNNER_REGISTER:
        raise NotImplementedError(f"runner {config['model_cls']!r} is not ported yet (ROADMAP.md, Queue 1)")
    return RUNNER_REGISTER[config["model_cls"]](config)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="lightx2v_tpu_torch offline inference")
    parser.add_argument("--model_cls", type=str, required=True,
                        choices=["wan2.1", "wan2.1_distill", "wan2.1_causvid", "wan2.1_skyreels_v2_df",
                                 "wan2.1_audio", "hunyuan", "cogvideox"],
                        help="registered runner key")
    parser.add_argument("--task", type=str, default="t2v", choices=["t2v", "i2v"])
    parser.add_argument("--model_path", type=str, default=None)
    parser.add_argument("--config_json", type=str, default=None)
    parser.add_argument("--prompt", type=str, default="")
    parser.add_argument("--negative_prompt", type=str, default="")
    parser.add_argument("--image_path", type=str, default=None)
    parser.add_argument("--audio_path", type=str, default=None)
    parser.add_argument("--save_video_path", type=str, default="./output.mp4",
                        help="output video; an empty string runs without writing one")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--use_prompt_enhancer", action="store_true")
    parser.add_argument("--prompt_enhancer_url", type=str, default=None)
    parser.add_argument("--synthetic_weights", action="store_true",
                        help="run with randomly initialized weights (no checkpoint)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="run device (default cuda; cuda without a GPU raises)")
    parser.add_argument("--compile_cache_dir", type=str, default=None,
                        help="accepted for CLI parity with lightx2v_tpu.infer; unused (nothing is "
                             "compiled ahead of time here)")
    return parser


def main():
    args = build_parser().parse_args()
    config = set_config(args)
    logger.info(f"config:\n{config}")
    save = bool(config.get("save_video_path"))
    if save:
        video_writer()  # fail before loading any model
    runner = init_runner(config)
    runner.run_pipeline(save_video=save)


if __name__ == "__main__":
    main()
