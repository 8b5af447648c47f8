"""CLI offline inference on the port:

    python -m lightx2v_tpu_torch.infer --model_cls wan2.1_distill --task t2v \
        --config_json configs/deploy/wan_t2v.json --synthetic_weights --device cuda

The flags of ``lightx2v_tpu.infer``, with ``--device {cuda,cpu}`` (default
cuda) in place of ``--platform``. Runs on the CUDA device unless
``--device cpu`` is given; with no GPU, ``cuda`` raises.

Multi-GPU: one process per GPU under torchrun, with a config that sets
``mesh_shape`` (and ``parallel_attn_type``, ``parallel_vae``)::

    python -m torch.distributed.run --nproc_per_node 8 -m lightx2v_tpu_torch.infer \
        --model_cls wan2.1 --config_json configs/dist_infer/wan_t2v_dist_ulysses.json --synthetic_weights

Under torchrun's environment the process group is initialised before the
runner (NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``) and destroyed
at exit; only rank 0 writes the video. Each rank prints one ``{"run": ...}``
JSON line: its rank and world, the backend, the stage seconds, the device's
peak memory (and the peak after each stage) and the launch counts of the
port's kernels in the run.
Without torchrun's environment a run is one process, as before.
"""

from __future__ import annotations

import argparse
import json

import torch

from .runners import (cogvideox_runner, hunyuan_runner, wan_audio_runner,  # noqa: F401  (registers runners)
                      wan_causvid_runner, wan_runner, wan_skyreels_v2_df_runner)
from .ops.cuda import launch_counts, reset_launch_counts
from .parallel.mesh import destroy_distributed, init_distributed
from .utils.config import set_config
from .utils.logging_utils import logger
from .utils.media import seed_all
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
    parser.add_argument("--save_latents_path", type=str, default=None,
                        help="also write the final latents (.npy, fp32; rank 0)")
    parser.add_argument("--compile_cache_dir", type=str, default=None,
                        help="accepted for CLI parity with lightx2v_tpu.infer; unused (nothing is "
                             "compiled ahead of time here)")
    return parser


def main(argv=None, init_method=None):
    """The CLI. ``init_method``: the process group's rendezvous under
    torchrun's variables (default ``env://``)."""
    args = build_parser().parse_args(argv)
    config = set_config(args)
    dist_info = init_distributed(config.get("device") or "cuda", init_method=init_method)
    try:
        if dist_info is None or dist_info["rank"] == 0:
            logger.info(f"config:\n{config}")
        runner = init_runner(config)
        reset_launch_counts()
        runner.run_pipeline(save_video=bool(config.get("save_video_path")))
        tm = runner.timings
        print(json.dumps({"run": {
            "rank": runner.rank, "world": runner.world, "backend": None if dist_info is None else dist_info["backend"],
            "device": str(runner.device), "mesh": None if runner.mesh is None else runner.mesh.sizes,
            "stage_s": {k: tm[k] for k in ("encode_s", "dit_s", "decode_s", "save_s") if k in tm},
            "peak_mem_gb": (torch.cuda.max_memory_allocated(runner.device) / 1e9
                            if runner.device.type == "cuda" else None),
            "mem_gb_by_stage": tm.get("mem_gb"),
            "launch_counts": launch_counts()}}), flush=True)
    finally:
        destroy_distributed()


if __name__ == "__main__":
    main()
