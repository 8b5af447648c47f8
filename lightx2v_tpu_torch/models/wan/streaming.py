"""Block streaming for models over the card's memory (counterpart of
``lightx2v_tpu.models.wan.streaming``): the host-RAM tier, and the
two-slot device copier that both offload tiers run through.

Host-RAM tier (``cpu_offload`` / ``weight_streaming``): each block's
parameters are packed at load into one pinned byte buffer, every tensor at
a 256-byte-aligned offset (``BlockLayout``), so one host-to-device copy
moves a block. ``BlockStreamer`` owns two device slots of one block each,
made once and reused every step, with the block's parameter dict built once
per slot as typed views of it. A copy stream fills slot (i + 1) % 2 while
the compute stream runs block i; CUDA events order both ways: compute waits
on "block i landed", and the copy into a slot waits on "the block that last
used the slot is done". Quantized blocks stream as they are (int8 or e4m3
codes, fp32 scales).

The streamer is an iterable of blocks with a length, so it stands in for
``params["blocks"]`` in the resident forward and denoise loop
(``dict(params, blocks=BlockStreamer(store, device))``): the same kernels
run in the same order, and the offloaded prediction equals the resident
one bit for bit. On a CUDA device the host buffers are pinned and
every copy is asynchronous; there is no pageable or CPU fallback. A CPU
run (the tests) copies synchronously from plain host memory.

Per pass (one forward over the stack) ``take_stats`` gives the bytes
copied to the device and the copy stream's milliseconds, the milliseconds
the compute stream waited for a block to land (stall), and for the disk
tier (``lazy_offload.py``) the bytes read, the workers' read seconds and
the seconds the host waited for a read.

Feature caching under offload (``StreamedCache``, driven by the denoise
loop with ``streamed=True``) follows the JAX streamed forward, not the
resident caching: a skipped step does not iterate the streamer, so it
copies no block and reads nothing from the disk; the cached state is the
whole stack's residual ``x_out - x_in`` (fp32), staged in host memory
(pinned on a CUDA device) and added back in fp32. Tea and Ada keep it in
bf16; TaylorSeer and Custom keep ``(f0, f1)`` in ``taylor_cache_dtype``
(e4m3 saturating at +-448), f1 = 0 at the first calc. Tea decides once a
step for the whole CFG batch."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Sequence, Tuple

import torch

from ...caching.teacache import store

Params = Dict[str, Any]
ALIGN = 256  # bytes; every tensor of a packed block starts on this boundary


@dataclass(frozen=True)
class BlockLayout:
    """Where each tensor of a block lies in its flat byte buffer."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    nbytes: int

    @classmethod
    def of(cls, entries: Sequence[Tuple[str, Sequence[int], torch.dtype]]) -> "BlockLayout":
        names, shapes, dtypes, offsets, sizes, off = [], [], [], [], [], 0
        for name, shape, dtype in entries:
            size = int(torch.Size(shape).numel()) * torch.empty((), dtype=dtype).element_size()
            names.append(name)
            shapes.append(tuple(int(s) for s in shape))
            dtypes.append(dtype)
            offsets.append(off)
            sizes.append(size)
            off += -(-size // ALIGN) * ALIGN
        return cls(tuple(names), tuple(shapes), tuple(dtypes), tuple(offsets), tuple(sizes), max(off, ALIGN))

    def byte_views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """Each tensor's bytes in ``buf`` (uint8 slices, in ``names`` order)."""
        return [buf[o:o + s] for o, s in zip(self.offsets, self.sizes)]

    def views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """name -> typed view of ``buf`` (the offsets keep every view aligned)."""
        return {n: b.view(d).view(s) for n, b, d, s in zip(self.names, self.byte_views(buf), self.dtypes, self.shapes)}


def _flatten(tree: Params, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _flatten(v, f"{prefix}{k}.")
        elif isinstance(v, torch.Tensor):
            out.append((prefix + k, v))
    return out


_LEAF = object()  # a tensor's place in a block's skeleton


def _skeleton(tree: Params) -> Params:
    """``tree``'s nesting with each tensor replaced by ``_LEAF``."""
    return {k: _skeleton(v) if isinstance(v, dict) else _LEAF if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}


def _unflatten(skeleton: Params, views: Dict[str, torch.Tensor], prefix: str = "") -> Params:
    """``skeleton``'s nesting with each tensor's place filled by its view
    (other leaves, such as a missing bias's None, kept)."""
    return {k: (_unflatten(v, views, f"{prefix}{k}.") if isinstance(v, dict)
                else views[prefix + k] if v is _LEAF else v)
            for k, v in skeleton.items()}


class HostBlocks:
    """The host-RAM tier's store: every block packed into one byte buffer
    (pinned with ``pin``). Takes the blocks from ``blocks`` one at a time
    and keeps none, so a generator that builds each block on the device
    (``weights.load_wan_params(iter_blocks=True)``) puts one block at a
    time there, never the stack."""

    def __init__(self, blocks: Iterable[Params], pin: bool):
        self.bufs: List[torch.Tensor] = []
        for blk in blocks:
            flat = _flatten(blk)
            if not self.bufs:
                self.layout = BlockLayout.of([(n, t.shape, t.dtype) for n, t in flat])
                self.skeleton = _skeleton(blk)
            elif [(n, t.shape, t.dtype) for n, t in flat] != list(zip(self.layout.names, self.layout.shapes,
                                                                       self.layout.dtypes)):
                raise ValueError(f"block {len(self.bufs)} differs in structure from block 0")
            buf = torch.empty(self.layout.nbytes, dtype=torch.uint8, pin_memory=pin)
            for (_, t), dst in zip(flat, self.layout.byte_views(buf)):
                dst.copy_(t.contiguous().reshape(-1).view(torch.uint8))
            self.bufs.append(buf)
            del blk, flat  # before the next block is built

    @property
    def num_blocks(self) -> int:
        return len(self.bufs)

    def block(self, i: int, views: Dict[str, torch.Tensor]) -> Params:
        return _unflatten(self.skeleton, views)

    def start_pass(self):
        pass

    def fetch(self, i: int) -> torch.Tensor:
        return self.bufs[i]

    def release(self, i: int, event) -> None:
        pass

    def pass_stats(self) -> Dict[str, float]:
        return {}


class BlockStreamer:
    """Iterate a store's blocks (``HostBlocks``, or the disk tier's
    ``BlockPrefetcher``) on ``device`` through two slots; each iteration is
    one pass over the stack."""

    def __init__(self, store, device):
        self.store = store
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        nbytes = store.layout.nbytes
        self.slots = [torch.empty(nbytes, dtype=torch.uint8, device=self.device) for _ in range(2)]
        self.views = [store.layout.views(s) for s in self.slots]
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(self.device)
            self.landed = [torch.cuda.Event() for _ in range(2)]
            self.freed = [torch.cuda.Event() for _ in range(2)]
        self._reset()

    def __len__(self) -> int:
        return self.store.num_blocks

    def _reset(self):
        self._h2d_bytes = 0
        self._stalls: List[Tuple[Any, Any]] = []
        self._copies: List[Tuple[Any, Any]] = []

    def _issue(self, i: int):
        s = i % 2
        buf = self.store.fetch(i)
        self._h2d_bytes += buf.numel()
        if not self.cuda:
            self.slots[s].copy_(buf)
            self.store.release(i, None)
            return
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(self.freed[s])
            t0.record(self.copy_stream)
            self.slots[s].copy_(buf, non_blocking=True)
            t1.record(self.copy_stream)
            self.landed[s].record(self.copy_stream)
        self._copies.append((t0, t1))
        self.store.release(i, self.landed[s])

    def __iter__(self):
        n = len(self)
        self.store.start_pass()
        self._issue(0)
        for i in range(n):
            s = i % 2
            if self.cuda:
                cur = torch.cuda.current_stream(self.device)
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record(cur)
                cur.wait_event(self.landed[s])
                b.record(cur)
                self._stalls.append((a, b))
            yield self.store.block(i, self.views[s])
            if self.cuda:
                self.freed[s].record(torch.cuda.current_stream(self.device))
            if i + 1 < n:
                self._issue(i + 1)

    def take_stats(self) -> Dict[str, float]:
        """The counters since the last call (call after a device sync):
        ``h2d_bytes``, ``h2d_ms`` (copy stream busy), ``stall_ms`` (compute
        stream waiting for blocks), and the store's (the disk tier's
        ``disk_bytes``, ``disk_read_s``, ``fetch_wait_s``)."""
        out = {"h2d_bytes": self._h2d_bytes,
               "h2d_ms": sum(a.elapsed_time(b) for a, b in self._copies),
               "stall_ms": sum(a.elapsed_time(b) for a, b in self._stalls),
               **self.store.pass_stats()}
        self._reset()
        return out


class StreamedCache:
    """The host-staged whole-stack cache of a streamed stack (counterpart of
    the caching state in the JAX ``make_streamed_forward``): ``mode`` is
    Tea, Ada (bf16 residual) or TaylorSeer, Custom (first-order ``(f0, f1)``
    in ``dtype``). ``ready`` says a skip step can be rebuilt;
    ``replay(x, step)`` rebuilds it, ``stage(x_in, x_out, step)`` stores a
    calc step's. ``take_stats`` gives the bytes staged to and from the host
    since its last call."""

    def __init__(self, mode: str, dtype=torch.bfloat16, device="cpu"):
        self.taylor = mode in ("TaylorSeer", "Custom")
        self.dtype = dtype if self.taylor else torch.bfloat16
        self.device = torch.device(device)
        self.host: Dict[str, torch.Tensor] = {}  # "r", or "f0" and "f1"
        self.last_calc = 0
        self._stats = {"cache_d2h_bytes": 0, "cache_h2d_bytes": 0}

    @property
    def ready(self) -> bool:
        return bool(self.host)

    def _put(self, name: str, t: torch.Tensor) -> None:
        """Stage ``t`` in its host buffer (made once, pinned on CUDA; the copy
        is ordered before any later copy back on the same stream)."""
        buf = self.host.get(name)
        if buf is None or buf.shape != t.shape:
            buf = self.host[name] = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.device.type == "cuda")
        buf.copy_(t, non_blocking=True)
        self._stats["cache_d2h_bytes"] += t.numel() * t.element_size()

    def _get(self, name: str) -> torch.Tensor:
        buf = self.host[name]
        self._stats["cache_h2d_bytes"] += buf.numel() * buf.element_size()
        return buf.to(self.device, non_blocking=True).float()

    def replay(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """x plus the cached residual (Tea, Ada) or f0 + f1 * (step -
        last_calc) (TaylorSeer, Custom), added in fp32."""
        rec = self._get("f0") + self._get("f1") * float(step - self.last_calc) if self.taylor else self._get("r")
        return (x.float() + rec).to(x.dtype)

    def stage(self, x_in: torch.Tensor, x_out: torch.Tensor, step: int) -> None:
        r = x_out.float() - x_in.float()
        if not self.taylor:
            self._put("r", r.to(torch.bfloat16))
            return
        if self.ready:
            f1 = (r - self._get("f0")) / float(max(step - self.last_calc, 1))
        else:
            f1 = torch.zeros_like(r)  # the first calc: f0 alone
        self._put("f1", store(f1, self.dtype))
        del f1
        self._put("f0", store(r, self.dtype))
        self.last_calc = step

    def take_stats(self) -> Dict[str, int]:
        out, self._stats = self._stats, {"cache_d2h_bytes": 0, "cache_h2d_bytes": 0}
        return out
