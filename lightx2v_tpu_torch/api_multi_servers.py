"""Multi-server launcher (counterpart of ``lightx2v_tpu.api_multi_servers``):
one ``python -m lightx2v_tpu_torch.api_server`` process per server on free
ports, server i on GPU ``i % GPU count`` (``CUDA_VISIBLE_DEVICES``; without
it every server would land on ``cuda:0``), each health-polled before the
launcher reports the ready ports.

    python -m lightx2v_tpu_torch.api_multi_servers --num_servers 2 \
        --server_args "--model_cls wan2.1_distill --config_json configs/deploy/wan_t2v.json --synthetic_weights"
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from typing import List

from .utils.logging_utils import logger


def find_free_ports(start: int, count: int) -> List[int]:
    ports = []
    port = start
    while len(ports) < count and port < start + 1000:
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
                ports.append(port)
            except OSError:
                pass
        port += 1
    if len(ports) < count:
        raise RuntimeError("not enough free ports")
    return ports


def wait_healthy(port: int, timeout: float = 600.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/service/status", timeout=5) as r:
                if r.status == 200:
                    return True
        except Exception:
            time.sleep(2)
    return False


def server_env(index: int, gpu_count: int) -> dict:
    """Server ``index``'s environment: one GPU, ``index % gpu_count``
    (the inherited environment where there is none)."""
    env = dict(os.environ)
    if gpu_count > 0:
        env["CUDA_VISIBLE_DEVICES"] = str(index % gpu_count)
    return env


def main():
    parser = argparse.ArgumentParser(description="launch N API servers")
    parser.add_argument("--num_servers", type=int, default=1)
    parser.add_argument("--start_port", type=int, default=8000)
    parser.add_argument("--server_args", type=str, default="",
                        help="args forwarded to lightx2v_tpu_torch.api_server, quoted")
    args = parser.parse_args()

    import torch

    gpus = torch.cuda.device_count()
    ports = find_free_ports(args.start_port, args.num_servers)
    procs = []
    for i, port in enumerate(ports):
        cmd = [sys.executable, "-m", "lightx2v_tpu_torch.api_server", "--port", str(port)] + args.server_args.split()
        logger.info(f"launching: {' '.join(cmd)}")
        procs.append(subprocess.Popen(cmd, env=server_env(i, gpus)))

    ready = [p for p in ports if wait_healthy(p)]
    print(json.dumps({"ports": ready, "requested": args.num_servers, "healthy": len(ready)}))
    try:
        for p in procs:
            p.wait()
    except KeyboardInterrupt:
        for p in procs:
            p.terminate()


if __name__ == "__main__":
    main()
