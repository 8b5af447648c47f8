"""The disk tier (counterpart of ``lightx2v_tpu.models.wan.lazy_offload``):
block weights stay in the converter's per-block files
(``tools/convert.py --layout blocks``: ``block_{i}.safetensors`` beside
``non_block.safetensors``), and only the pre/post weights are resident.

``LazyBlockStore`` reads the layout of block 0's header (every block file
must match it) and reads a block's tensors straight into a caller's byte
buffer at the layout's 256-byte-aligned offsets (one scatter ``preadv`` per
run of tensors that lie back to back in the file). ``BlockPrefetcher``
is the store that ``streaming.BlockStreamer`` drains: ``num_workers``
threads read upcoming blocks, in schedule order, into a fixed pool of
pinned staging buffers of one block each. The pool is bounded by
``max_host_bytes`` (the config's ``max_memory`` GB) and never holds fewer
than ``num_workers + 1`` blocks, so the next block can always be read while
every worker holds one. A buffer returns to the pool once its host-to-device
copy has completed (its CUDA event). ``preadv`` and the copies release the
GIL, so the workers read while the Python block loop runs.

With ``rope_fused`` the store permutes each block's self-attention q/k
into the half-split pair layout on the device as it is built
(``weights.permute_block_qk_half``), so the fused-RoPE flash kernel runs on
streamed blocks too; the JAX runner turns fused RoPE off here instead."""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch

from ...utils.safetensors_io import SafetensorsFile, load_file
from .config import WanArch
from .streaming import BlockLayout
from .weights import build_block_params, build_non_block_params, permute_block_qk_half

Params = Dict[str, Any]
FETCH_TIMEOUT_S = 600.0  # the longest a fetch waits for its block, and close() for each worker


def is_blocks_layout(ckpt_dir: str) -> bool:
    return os.path.isfile(os.path.join(ckpt_dir, "non_block.safetensors")) and \
        os.path.isfile(os.path.join(ckpt_dir, "block_0.safetensors"))


class LazyBlockStore:
    """Per-block access to a blocks-layout checkpoint directory: ``small``
    holds the pre/post params on ``device``; blocks are read on demand."""

    def __init__(self, ckpt_dir: str, arch: WanArch, device="cpu", compute_dtype=torch.bfloat16):
        self.arch, self.device, self.compute_dtype = arch, torch.device(device), compute_dtype
        self.paths: List[str] = [os.path.join(ckpt_dir, f"block_{i}.safetensors") for i in range(arch.num_layers)]
        for p in self.paths:
            if not os.path.isfile(p):
                raise FileNotFoundError(f"blocks-layout checkpoint missing {p} (tools/convert.py --layout blocks)")
        entries = None
        for i, p in enumerate(self.paths):
            with SafetensorsFile(p) as f:
                prefix = f"blocks.{i}."
                got = sorted((k[len(prefix):], *f.get_shape_dtype(k)) for k in f.keys())
                if any(not k.startswith(prefix) for k in f.keys()):
                    raise ValueError(f"{p} holds keys of another block")
            if entries is None:
                entries = got
            elif got != entries:
                raise ValueError(f"{p} differs from block_0.safetensors in its tensors")
        self.layout = BlockLayout.of(entries)
        self.small: Params = build_non_block_params(load_file(os.path.join(ckpt_dir, "non_block.safetensors")),
                                                    arch, compute_dtype, self.device)

    @property
    def num_blocks(self) -> int:
        return len(self.paths)

    def names(self, i: int) -> List[str]:
        return [f"blocks.{i}.{n}" for n in self.layout.names]

    def quantized(self) -> bool:
        """Do block 0's linears carry scales (int8, e4m3 or int4 codes)?"""
        return "ffn.0.weight_scale" in self.layout.names

    def read_block(self, i: int, buf: torch.Tensor) -> int:
        """Block i's tensors into ``buf`` (a CPU byte buffer of
        ``layout.nbytes``) at the layout's offsets; returns bytes read."""
        with SafetensorsFile(self.paths[i]) as f:
            return f.read_runs(self.names(i), self.layout.byte_views(buf))

    def block(self, i: int, views: Dict[str, torch.Tensor]) -> Params:
        """Block i's params from its tensors' views (on the device)."""
        blk = build_block_params(dict(zip(self.names(i), views.values())), i, self.arch, self.compute_dtype,
                                 self.device)
        return permute_block_qk_half(blk, self.arch) if self.arch.rope_fused else blk


class BlockPrefetcher:
    """``num_workers`` threads reading a store's blocks in schedule order
    into a bounded pool of (pinned, with ``pin``) staging buffers; the store
    interface that ``BlockStreamer`` drains (``start_pass`` schedules one
    pass over the blocks)."""

    def __init__(self, store: LazyBlockStore, num_workers: int = 2, max_host_bytes: Optional[int] = None,
                 pin: bool = True):
        self.store, self.layout = store, store.layout
        num_workers = max(1, min(num_workers, os.cpu_count() or 1))
        n = max(1, int(max_host_bytes // self.layout.nbytes)) if max_host_bytes else 4
        self.num_buffers = max(n, num_workers + 1)
        self._free = [torch.empty(self.layout.nbytes, dtype=torch.uint8, pin_memory=pin)
                      for _ in range(self.num_buffers)]
        self._schedule: deque = deque()
        self._ready: Dict[int, torch.Tensor] = {}
        self._out: Dict[int, torch.Tensor] = {}  # handed to the streamer, copy not yet issued
        self._pending: deque = deque()  # (event, buffer): copies in flight
        self._cond = threading.Condition()
        self._stop = False
        self._err: Optional[BaseException] = None
        self.peak_held = 0  # the most buffers out of the pool at once
        self._stats = {"disk_bytes": 0, "disk_read_s": 0.0, "fetch_wait_s": 0.0}
        self._workers = [threading.Thread(target=self._work, daemon=True) for _ in range(num_workers)]
        for w in self._workers:
            w.start()

    @property
    def num_blocks(self) -> int:
        return self.store.num_blocks

    def block(self, i: int, views) -> Params:
        return self.store.block(i, views)

    def start_pass(self):
        """Schedule one read of every block, in order."""
        with self._cond:
            self._schedule.extend(range(self.num_blocks))
            self._cond.notify_all()

    def _work(self):
        while True:
            with self._cond:
                while not self._stop and not (self._schedule and self._free):
                    self._cond.wait()
                if self._stop:
                    return
                idx, buf = self._schedule.popleft(), self._free.pop()
                self.peak_held = max(self.peak_held, self.num_buffers - len(self._free))
            try:
                t0 = time.perf_counter()
                nbytes = self.store.read_block(idx, buf)
                dt = time.perf_counter() - t0
            except Exception as e:  # surfaced to the consumer, which re-raises it
                with self._cond:
                    self._err = e
                    self._cond.notify_all()
                return
            with self._cond:
                self._ready[idx] = buf
                self._stats["disk_bytes"] += nbytes
                self._stats["disk_read_s"] += dt
                self._cond.notify_all()

    def _reap(self) -> None:
        """Return the buffers whose copies have completed (lock held)."""
        while self._pending and (self._pending[0][0] is None or self._pending[0][0].query()):
            self._free.append(self._pending.popleft()[1])
            self._cond.notify_all()

    def fetch(self, i: int) -> torch.Tensor:
        """Block i's staging buffer, once a worker has read it."""
        t0 = time.perf_counter()
        with self._cond:
            while i not in self._ready:
                if self._err is not None:
                    raise RuntimeError("disk prefetch worker failed") from self._err
                self._reap()
                if time.perf_counter() - t0 > FETCH_TIMEOUT_S:
                    raise TimeoutError(f"block {i} not read within {FETCH_TIMEOUT_S} s (schedule it before fetching)")
                self._cond.wait(timeout=0.002 if self._pending else 1.0)
            buf = self._out[i] = self._ready.pop(i)
            self._stats["fetch_wait_s"] += time.perf_counter() - t0
            return buf

    def release(self, i: int, event) -> None:
        """Block i's copy is issued; its buffer returns to the pool when
        ``event`` (None: at once) has completed."""
        with self._cond:
            self._pending.append((event, self._out.pop(i)))
            self._reap()

    def pass_stats(self) -> Dict[str, float]:
        with self._cond:
            out, self._stats = self._stats, {"disk_bytes": 0, "disk_read_s": 0.0, "fetch_wait_s": 0.0}
        return out

    def close(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for w in self._workers:
            w.join(timeout=FETCH_TIMEOUT_S)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
