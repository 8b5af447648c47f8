"""HTTP API server (counterpart of ``lightx2v_tpu.server.api``): the same
routes, status codes and bodies.

  POST   /v1/tasks                      create generation task
  GET    /v1/tasks                      list tasks
  GET    /v1/tasks/{id}/status          task status
  GET    /v1/tasks/{id}/result          result metadata
  DELETE /v1/tasks/running              stop the running task
  GET    /v1/service/status             idle/busy
  GET    /v1/service/metrics            serving counters + last stage seconds
  GET    /v1/files/download/{path}      fetch produced video
  DELETE /v1/tasks/{id}                 stop one task (pending or processing)
  POST   /v1/files/upload?name=...      upload a conditioning image
  GET    /v1/service/metadata           capabilities (web UI)
  GET    /                              the web UI

The stdlib ThreadingHTTPServer; handlers are thin JSON shims over
VideoGenerationService.
"""

from __future__ import annotations

import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.logging_utils import logger
from .schema import TaskRequest
from .service import VideoGenerationService


def make_handler(service: VideoGenerationService, output_root: str = "."):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt % args)

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b"{}"
            return json.loads(raw or b"{}")

        # ------------- routes -------------
        def do_POST(self):
            if self.path == "/v1/tasks" or self.path == "/v1/tasks/":
                try:
                    req = TaskRequest.from_dict(self._read_body())
                except Exception as e:
                    return self._json(422, {"detail": str(e)})
                rec = service.submit(req)
                return self._json(200, {
                    "task_id": rec.request.task_id,
                    "task_status": rec.status,
                    "save_video_path": rec.request.save_video_path,
                })
            m = re.match(r"^/v1/files/upload\?name=([\w.\-]+)$", self.path)
            if m:
                # i2v conditioning image upload (web UI); contained under
                # output_root/uploads with a sanitized basename
                name = os.path.basename(m.group(1))
                updir = os.path.join(os.path.abspath(output_root), "uploads")
                os.makedirs(updir, exist_ok=True)
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0 or n > 64 << 20:
                    return self._json(413, {"detail": "bad upload size"})
                path = os.path.join(updir, name)
                with open(path, "wb") as f:
                    f.write(self.rfile.read(n))
                return self._json(200, {"path": path})
            return self._json(404, {"detail": "not found"})

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                from .webui import WEB_UI_HTML

                body = WEB_UI_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path == "/v1/service/status":
                return self._json(200, service.status())
            if self.path == "/v1/service/metrics":
                return self._json(200, service.metrics())
            if self.path == "/v1/service/metadata":
                from .autoconfig import service_metadata

                cfg = getattr(service, "server_config", None)
                return self._json(200, service_metadata(cfg))
            if self.path == "/v1/tasks" or self.path == "/v1/tasks/":
                tasks = service.all_tasks()
                return self._json(200, {"tasks": [
                    {"task_id": tid, "status": r.status} for tid, r in tasks.items()]})
            m = re.match(r"^/v1/tasks/([\w-]+)/status$", self.path)
            if m:
                rec = service.get(m.group(1))
                if rec is None:
                    return self._json(404, {"detail": "task not found"})
                return self._json(200, {"task_id": m.group(1), "status": rec.status, "error": rec.error})
            m = re.match(r"^/v1/tasks/([\w-]+)/result$", self.path)
            if m:
                rec = service.get(m.group(1))
                if rec is None:
                    return self._json(404, {"detail": "task not found"})
                if rec.status != "completed":
                    return self._json(400, {"detail": f"task status: {rec.status}"})
                # download_path: relative to output_root, usable directly
                # in /v1/files/download/ (basename alone breaks for save
                # paths in subdirectories of the output root)
                try:
                    dl = os.path.relpath(rec.request.save_video_path,
                                         os.path.abspath(output_root))
                except ValueError:  # different drive (win)
                    dl = os.path.basename(rec.request.save_video_path)
                return self._json(200, {
                    "task_id": m.group(1), "status": rec.status,
                    "save_video_path": rec.request.save_video_path,
                    "download_path": dl,
                })
            m = re.match(r"^/v1/files/download/(.+)$", self.path)
            if m:
                root = os.path.abspath(output_root)
                path = os.path.abspath(os.path.join(root, m.group(1).lstrip("/")))
                if os.path.commonpath([root, path]) != root:
                    return self._json(403, {"detail": "forbidden"})
                if not os.path.isfile(path):
                    return self._json(404, {"detail": "file not found"})
                with open(path, "rb") as f:
                    data = f.read()
                self.send_response(200)
                self.send_header("Content-Type", "video/mp4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            return self._json(404, {"detail": "not found"})

        def do_DELETE(self):
            if self.path == "/v1/tasks/running":
                return self._json(200, service.stop_running())
            m = re.match(r"^/v1/tasks/([\w-]+)$", self.path)
            if m:  # stop one specific task (per-task stop event)
                return self._json(200, service.stop_running(m.group(1)))
            return self._json(404, {"detail": "not found"})

    return Handler


class ApiServer:
    def __init__(self, service: VideoGenerationService, host: str = "0.0.0.0", port: int = 8000,
                 output_root: str = "."):
        self.service = service
        self.httpd = ThreadingHTTPServer((host, port), make_handler(service, output_root))
        self.port = self.httpd.server_address[1]

    def serve_forever(self):
        logger.info(f"API server listening on :{self.port}")
        try:
            self.httpd.serve_forever()
        finally:
            self.service.shutdown()

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.shutdown()
