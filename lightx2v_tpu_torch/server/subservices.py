"""Stage microservices (counterpart of ``lightx2v_tpu.server.subservices``).

Each pipeline stage can run as a standalone HTTP service exchanging tensors
as base64-encoded float32 npz blobs, as the JAX package's do; a caller
probes one with ``check_subservice`` (a 2 s health check).

    python -m lightx2v_tpu_torch.server.subservices --stage text_encoder ...

The ``prompt_enhancer`` stage needs the local enhancer, which is not ported
(``utils/prompt_enhancer.PromptEnhancer`` raises); ``image_encoder`` is an
unknown stage, as in the JAX package.
"""

from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..utils.logging_utils import logger


def encode_arrays(arrays: Dict[str, np.ndarray]) -> str:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return base64.b64encode(buf.getvalue()).decode()


def decode_arrays(blob: str) -> Dict[str, np.ndarray]:
    buf = io.BytesIO(base64.b64decode(blob))
    with np.load(buf) as z:
        return {k: z[k] for k in z.files}


class StageService:
    """Wraps a handler fn(payload dict) -> payload dict as an HTTP service
    with /v1/health."""

    def __init__(self, stage: str, handler: Callable[[Dict[str, Any]], Dict[str, Any]],
                 host: str = "0.0.0.0", port: int = 9000):
        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *a):
                logger.debug("subservice: " + fmt % a)

            def _json(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/v1/health":
                    return self._json(200, {"stage": stage, "status": "ok"})
                return self._json(404, {"detail": "not found"})

            def do_POST(self):
                if self.path != f"/v1/{stage}":
                    return self._json(404, {"detail": "not found"})
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
                try:
                    return self._json(200, handler(payload))
                except Exception as e:  # the service keeps serving: the caller gets the error
                    logger.error(f"{stage}: {e}")
                    return self._json(500, {"detail": str(e)})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self.stage = stage

    def serve_forever(self):
        logger.info(f"{self.stage} subservice on :{self.port}")
        self.httpd.serve_forever()

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def check_subservice(url: str, timeout: float = 2.0) -> bool:
    """Health probe: True when ``{url}/v1/health`` answers 200."""
    import urllib.request

    try:
        with urllib.request.urlopen(url.rstrip("/") + "/v1/health", timeout=timeout) as r:
            return r.status == 200
    except Exception:
        return False


def _build_handler(stage: str, config) -> Callable:
    if stage == "text_encoder":
        from ..infer import init_runner

        runner = init_runner(config)

        def handle(payload):
            ctx = runner.text_encoder.infer([payload["prompt"]])
            return {"context": encode_arrays({"context": ctx.float().cpu().numpy()})}

        return handle
    if stage == "vae":
        from ..infer import init_runner

        runner = init_runner(config)

        def handle(payload):
            arrays = decode_arrays(payload["latents"])
            frames = runner.run_vae_decoder(torch.from_numpy(arrays["latents"]).to(runner.device))
            return {"frames": encode_arrays({"frames": frames})}

        return handle
    if stage == "dit":
        from ..infer import init_runner

        runner = init_runner(config)

        def handle(payload):
            runner.set_inputs({k: v for k, v in payload.items() if not isinstance(v, dict)})
            enc = runner.run_input_encoder()
            latents = runner.run_dit(enc)
            return {"latents": encode_arrays({"latents": latents.float().cpu().numpy()})}

        return handle
    if stage == "prompt_enhancer":
        from ..utils.prompt_enhancer import PromptEnhancer

        enhancer = PromptEnhancer(config.get("prompt_enhancer_model", "Qwen/Qwen2.5-32B-Instruct"))

        def handle(payload):
            return {"prompt": enhancer(payload["prompt"])}

        return handle
    raise ValueError(f"unknown stage {stage}")


def main():
    from ..infer import build_parser
    from ..utils.config import set_config

    parser = build_parser()
    parser.add_argument("--stage", required=True,
                        choices=["text_encoder", "image_encoder", "vae", "dit", "prompt_enhancer"])
    parser.add_argument("--port", type=int, default=9000)
    args = parser.parse_args()
    config = set_config(args)
    StageService(args.stage, _build_handler(args.stage, config), port=args.port).serve_forever()


if __name__ == "__main__":
    main()
