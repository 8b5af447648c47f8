"""API server entry point (counterpart of ``lightx2v_tpu.api_server``):

    python -m lightx2v_tpu_torch.api_server --model_cls wan2.1 \
        --config_json configs/wan_t2v_synthetic_smoke.json --synthetic_weights --device cpu --port 8000

The flags of ``lightx2v_tpu_torch.infer`` (``--device {cuda,cpu}``, default
cuda) plus ``--host``, ``--port`` and ``--output_root``; ``--compile_cache_dir``
is accepted and unused. ``num_replicas`` in the config serves that many
runners, one a card (``cuda:i``), each with its own copy of the config.
"""

from __future__ import annotations

import copy

import torch

from .infer import build_parser, init_runner
from .server.api import ApiServer
from .server.service import VideoGenerationService
from .utils.config import set_config
from .utils.logging_utils import logger


def runner_factory(config, replicas: int):
    """A factory of runners for ``VideoGenerationService``: each call builds
    one on its own deep copy of ``config`` (``set_inputs`` mutates a runner's
    config, and replicas run concurrently); with several replicas on CUDA,
    on the worker thread's current device (the service's replica scope)."""

    def make():
        cfg = copy.deepcopy(config)
        if replicas > 1 and str(cfg.get("device") or "cuda") == "cuda":
            cfg["device"] = f"cuda:{torch.cuda.current_device()}"
        return init_runner(cfg)

    return make


def main():
    parser = build_parser()
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--output_root", type=str, default="./outputs",
                        help="directory client save paths are contained under")
    args = parser.parse_args()
    config = set_config(args)
    replicas = int(config.get("num_replicas", 1))
    service = VideoGenerationService(runner_factory(config, replicas), output_root=args.output_root,
                                     server_config=config, num_replicas=replicas)
    server = ApiServer(service, host=args.host, port=args.port, output_root=args.output_root)
    logger.info(f"serving model_cls={config.get('model_cls')} on {args.host}:{server.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
