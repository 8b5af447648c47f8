"""Inference service (counterpart of ``lightx2v_tpu.server.service``): a task
queue and one worker thread per replica, each calling its runner's
``run_pipeline`` one task at a time, with the same task state machine
(pending -> processing -> completed | stopped | failed), per-task stop
events, save-path containment and metrics keys as the JAX service.

``num_replicas > 1`` is data parallelism for serving: replica i's runner
is built and run under ``torch.cuda.device(i)`` (the caller's factory gives
it ``device: "cuda:i"``; ``api_server.py`` does), weights replicated, all
replicas pulling from one queue. A task runs over a mesh (``mesh_shape``)
only in a world of one process (a mesh of 1); serving over a mesh of
several processes, and replicas over meshes, are not ported (ROADMAP.md,
Queue 1 item 14)."""

from __future__ import annotations

import contextlib
import os
import queue
import random
import threading
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..parallel.mesh import rank_and_world
from ..runners.base_runner import TaskStopped
from ..utils.logging_utils import logger
from .schema import TaskRequest

# runner.timings key -> the JAX package's stage name (GET /v1/service/metrics reads the same fields from either
# server)
STAGE_NAMES = {"encode_s": "Run Encoders", "dit_s": "Run DiT", "decode_s": "Run VAE Decoder", "save_s": "Save video"}


def generate_task_id() -> str:
    """XXXX-XXXX-XXXX-XXXX-XXXX ids."""
    chars = "ABCDEFGHJKLMNPQRSTUVWXYZ23456789"
    return "-".join("".join(random.choices(chars, k=4)) for _ in range(5))


class TaskRecord:
    """A task's request and state. ``created`` / ``started`` / ``finished``
    are host-clock seconds (``time.time``); ``timings`` is a copy of the
    runner's ``timings`` after the task's run (None when it never ran)."""

    def __init__(self, req: TaskRequest):
        self.request = req
        self.status = "pending"
        self.error: Optional[str] = None
        self.created = time.time()
        self.started: Optional[float] = None
        self.finished: Optional[float] = None
        self.timings: Optional[Dict[str, Any]] = None
        self.stop_event = threading.Event()  # per-task stop signal


class VideoGenerationService:
    """Owns the runner(s) and the task loop."""

    def __init__(self, runner_factory, output_root: str = "./outputs",
                 server_config: Optional[Dict[str, Any]] = None,
                 num_replicas: int = 1):
        self.num_replicas = max(1, int(num_replicas))
        if self.num_replicas > 1 and (server_config or {}).get("mesh_shape"):
            raise NotImplementedError("num_replicas > 1 over multi-device runs (mesh_shape) is not ported yet "
                                      "(ROADMAP.md, Queue 1 item 14)")
        if (server_config or {}).get("mesh_shape") and rank_and_world()[1] > 1:
            # each task would have to reach every rank of the mesh; rank 0 alone cannot run it
            raise NotImplementedError("serving over a mesh (mesh_shape in a world of more than one process): rank 0 "
                                      "would have to broadcast each task to its group; not ported yet (ROADMAP.md, "
                                      "Queue 1 item 14)")
        self._runner_factory = runner_factory
        self._output_root = os.path.abspath(output_root)
        self.server_config = server_config  # exposed via /v1/service/metadata
        self._queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._tasks: Dict[str, TaskRecord] = {}
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {
            "tasks_submitted": 0, "tasks_completed": 0,
            "tasks_failed": 0, "tasks_stopped": 0,
            "task_seconds_total": 0.0, "last_task_seconds": None,
        }
        self._last_stages: Dict[str, float] = {}
        self._shutdown = threading.Event()
        self._runners: Dict[int, Any] = {}
        self._current: Dict[int, Optional[str]] = {i: None for i in range(self.num_replicas)}
        self._workers = []
        for i in range(self.num_replicas):
            w = threading.Thread(target=self._loop, args=(i,), daemon=True)
            w.start()
            self._workers.append(w)

    # ---------------- public API ----------------
    def submit(self, req: TaskRequest) -> TaskRecord:
        task_id = req.task_id or generate_task_id()
        req.task_id = task_id
        req.save_video_path = self._resolve_save_path(req.save_video_path, task_id)
        rec = TaskRecord(req)
        with self._lock:
            self._tasks[task_id] = rec
            self._metrics["tasks_submitted"] += 1
        self._queue.put(task_id)
        return rec

    def metrics(self) -> Dict[str, Any]:
        """Serving counters and the last finished run's seconds per stage
        (GET /v1/service/metrics)."""
        with self._lock:
            m = dict(self._metrics)
            m["queue_depth"] = self._queue.qsize()
            m["busy_replicas"] = sum(1 for v in self._current.values() if v)
            m["last_stage_seconds"] = dict(self._last_stages)
        return m

    def _resolve_save_path(self, requested: Optional[str], task_id: str) -> str:
        """Contain client-supplied save paths under output_root, the write-
        side mirror of the download handler's traversal guard."""
        if requested:
            cand = os.path.abspath(requested)
            if os.path.commonpath([self._output_root, cand]) == self._output_root:
                return cand  # already contained
            name = os.path.basename(requested)
        else:
            name = ""
        if not name or name in (".", ".."):
            name = f"{task_id}.mp4"
        return os.path.join(self._output_root, name)

    def get(self, task_id: str) -> Optional[TaskRecord]:
        with self._lock:
            return self._tasks.get(task_id)

    def all_tasks(self) -> Dict[str, TaskRecord]:
        with self._lock:
            return dict(self._tasks)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            running = {i: t for i, t in self._current.items() if t is not None}
            busy = len(running) >= self.num_replicas
            first = next(iter(running.values()), None)
            out = {"service_status": "busy" if busy else "idle", "task_id": first}
            if self.num_replicas > 1:
                out["replicas"] = {str(i): t for i, t in self._current.items()}
            return out

    def stop_running(self, task_id: Optional[str] = None) -> Dict[str, Any]:
        """Request a stop. With ``task_id``, only that task's event is set
        (pending or processing); otherwise every running task's. Each task
        has its own event, so a replica finishing an unrelated task can
        neither absorb nor clear another task's stop request."""
        with self._lock:
            running = [t for t in self._current.values() if t is not None]
            if task_id is not None:
                rec = self._tasks.get(task_id)
                if rec is None:
                    return {"stop_status": "do_nothing", "reason": "task not found"}
                if task_id not in running and rec.status not in ("pending", "processing"):
                    return {"stop_status": "do_nothing", "reason": f"task status: {rec.status}"}
                rec.stop_event.set()
                return {"stop_status": "requested", "reason": None, "task_id": task_id}
            if not running:
                return {"stop_status": "do_nothing", "reason": "no running task"}
            for tid in running:
                self._tasks[tid].stop_event.set()
            return {"stop_status": "requested", "reason": None,
                    "task_id": running[0] if len(running) == 1 else running}

    def shutdown(self):
        self._shutdown.set()
        for _ in range(self.num_replicas):
            self._queue.put(None)  # wake every worker

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the workers to exit after ``shutdown`` (each within
        ``timeout`` seconds); True when all have."""
        for w in self._workers:
            w.join(timeout)
        return not any(w.is_alive() for w in self._workers)

    # ---------------- worker ----------------
    def _replica_scope(self, replica: int, cfg: Optional[Dict[str, Any]]):
        """Replica i's CUDA device as the worker thread's current device (it
        is per thread), so the runner built and run there stays on card i; a
        null context for one replica, a CPU config or no card."""
        device = str((cfg or {}).get("device") or "cuda")
        if self.num_replicas <= 1 or not device.startswith("cuda") or not torch.cuda.is_available():
            return contextlib.nullcontext()
        return torch.cuda.device(replica % torch.cuda.device_count())

    def _loop(self, replica: int = 0):
        while not self._shutdown.is_set():
            task_id = self._queue.get()
            if task_id is None:
                break
            rec = self.get(task_id)
            if rec is None:
                continue
            with self._lock:
                self._current[replica] = task_id
                rec.status = "processing"
                rec.started = time.time()
            t_task = time.perf_counter()
            runner, ran, status, error = None, False, "failed", None
            try:
                if replica not in self._runners:
                    with self._replica_scope(replica, self.server_config):
                        self._runners[replica] = self._runner_factory()
                runner = self._runners[replica]
                with self._replica_scope(replica, getattr(runner, "config", None)):
                    inputs = rec.request.model_dump()
                    inputs.update(inputs.pop("options", None) or {})
                    inputs = {k: v for k, v in inputs.items() if v not in (None, "")}
                    runner.set_inputs(inputs)
                    runner.stop_event = rec.stop_event
                    try:
                        if rec.stop_event.is_set():
                            raise TaskStopped("stopped before start")
                        ran = True
                        runner.run_pipeline()
                    finally:
                        runner.stop_event = None
                status = "completed"
            except TaskStopped:
                logger.info(f"task {task_id} stopped on request")
                status = "stopped"
            except Exception as e:
                logger.error(f"task {task_id} failed: {e}\n{traceback.format_exc()}")
                error = str(e)
            finally:
                dur = time.perf_counter() - t_task
                timings = dict(getattr(runner, "timings", None) or {}) if ran else None
                with self._lock:  # the status, the record and the counters change together
                    rec.timings, rec.finished, rec.error, rec.status = timings, time.time(), error, status
                    if timings is not None:
                        self._last_stages = {name: round(float(timings[k]), 6) for k, name in STAGE_NAMES.items()
                                             if k in timings}
                    self._current[replica] = None
                    key = {"completed": "tasks_completed", "stopped": "tasks_stopped"}.get(status, "tasks_failed")
                    self._metrics[key] += 1
                    self._metrics["task_seconds_total"] = round(self._metrics["task_seconds_total"] + dur, 3)
                    self._metrics["last_task_seconds"] = round(dur, 3)
