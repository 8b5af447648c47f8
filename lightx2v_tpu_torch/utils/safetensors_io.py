"""Safetensors reader and writer on torch tensors (counterpart of
``lightx2v_tpu.utils.safetensors_io``).

Format: 8-byte little-endian header length N, N bytes of JSON
(``{name: {dtype, shape, data_offsets: [begin, end]}}``, optional
``__metadata__``), then the raw tensor bytes, one tensor after the other.
Dtypes map by name (``BF16`` -> ``torch.bfloat16``, ``F8_E4M3`` ->
``torch.float8_e4m3fn``, ...).

Offsets are cumulative byte counts, so a bf16 or fp32 tensor that follows
an odd-sized int8 or uint8 tensor starts at an odd address of the file: a
typed view over a map of the file would be misaligned. The reader therefore
never views the file: it reads each tensor's bytes (``os.preadv``, which
releases the GIL) into a buffer it allocates, or into one the caller gives
(``read_into``, ``read_runs``: the offload tiers' pinned staging buffers),
and views that buffer. ``load_sharded`` and ``load_dir`` (a key filter,
each kept tensor moved to its device as it is read) honour
``*.index.json`` and fall back to an ``original/`` subdirectory, as the JAX
loader does. ``read_config`` reads the directory's ``config.json``.

The JAX package also has a C++ thread-pool reader
(``csrc/safetensors_reader.cpp``); the port reads with ``preadv`` from
Python threads instead (``models/wan/lazy_offload.py``)."""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}
for _name, _attr in (("U16", "uint16"), ("U32", "uint32"), ("U64", "uint64")):
    if hasattr(torch, _attr):
        _DTYPES[_name] = getattr(torch, _attr)
_NAMES = {v: k for k, v in _DTYPES.items()}
# numpy dtypes torch cannot take through from_numpy, carried as their bytes (the JAX package's
# ml_dtypes arrays, recognised by name: the port does not import ml_dtypes)
_BYTE_DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}
_MAX_READ = 1 << 30  # bytes per preadv call (Linux caps one read just under 2 GiB)
_IOV_MAX = 512


def as_tensor(a) -> torch.Tensor:
    """A torch tensor as it is, or a numpy array as a CPU tensor sharing its
    memory where it can (bf16 and float8 arrays cross as their bytes)."""
    if isinstance(a, torch.Tensor):
        return a
    arr = np.ascontiguousarray(a)
    if arr.dtype.name in _BYTE_DTYPES:
        return torch.from_numpy(arr.view(np.uint8)).view(_BYTE_DTYPES[arr.dtype.name])
    return torch.from_numpy(arr)


def _bytes_view(t: torch.Tensor) -> np.ndarray:
    """The bytes of a contiguous CPU tensor as a writable uint8 numpy array
    (shares memory)."""
    return t.reshape(-1).view(torch.uint8).numpy()


def pread_full(fd: int, views: Sequence[np.ndarray], offset: int) -> int:
    """Read ``sum(len(v))`` bytes at ``offset`` of ``fd`` into the byte
    arrays ``views`` in order (scatter read), looping over short reads;
    returns the bytes read. Raises at end of file."""
    mvs = [memoryview(v).cast("B") for v in views if v.size]
    done = 0
    while mvs:
        batch, size = [], 0
        for mv in mvs[:_IOV_MAX]:
            batch.append(mv[: _MAX_READ - size])
            size += len(batch[-1])
            if size >= _MAX_READ:
                break
        n = os.preadv(fd, batch, offset + done)
        if n <= 0:
            raise EOFError(f"safetensors file ends {sum(len(m) for m in mvs)} bytes early")
        done += n
        while n:  # drop what was filled
            if n >= len(mvs[0]):
                n -= len(mvs[0])
                mvs.pop(0)
            else:
                mvs[0] = mvs[0][n:]
                n = 0
    return done


class SafetensorsFile:
    """One safetensors file: the parsed header and reads of its tensors."""

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        try:
            head = os.pread(self._fd, 8, 0)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file")
            (n,) = struct.unpack("<Q", head)
            header = json.loads(os.pread(self._fd, n, 8).decode("utf-8"))
        except BaseException:
            os.close(self._fd)
            raise
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._entries: Dict[str, dict] = header
        self.data_start = 8 + n

    def keys(self) -> List[str]:
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get_shape_dtype(self, name: str) -> Tuple[Tuple[int, ...], torch.dtype]:
        ent = self._entries[name]
        return tuple(ent["shape"]), _DTYPES[ent["dtype"]]

    def offsets(self, name: str) -> Tuple[int, int]:
        """(begin, end) of the tensor's bytes, from the start of the data."""
        begin, end = self._entries[name]["data_offsets"]
        return int(begin), int(end)

    def nbytes(self, name: str) -> int:
        begin, end = self.offsets(name)
        return end - begin

    def read_into(self, name: str, out: torch.Tensor) -> torch.Tensor:
        """Read the tensor's bytes into ``out`` (a contiguous CPU tensor of
        exactly that many bytes, of any dtype) and return ``out``."""
        begin, end = self.offsets(name)
        if out.device.type != "cpu" or not out.is_contiguous() or out.numel() * out.element_size() != end - begin:
            raise ValueError(f"{name}: needs a contiguous CPU buffer of {end - begin} bytes")
        pread_full(self._fd, [_bytes_view(out)], self.data_start + begin)
        return out

    def read_runs(self, names: Sequence[str], outs: Sequence[torch.Tensor]) -> int:
        """Read several tensors, each into its own buffer, with one scatter
        read per run of tensors that lie back to back in the file; returns
        the bytes read."""
        order = sorted(range(len(names)), key=lambda j: self.offsets(names[j])[0])
        total, run, run_start, run_end = 0, [], None, None
        for j in order:
            begin, end = self.offsets(names[j])
            view = _bytes_view(outs[j])
            if view.size != end - begin:
                raise ValueError(f"{names[j]}: buffer of {view.size} bytes for {end - begin}")
            if run and begin != run_end:
                total += pread_full(self._fd, run, self.data_start + run_start)
                run = []
            if not run:
                run_start = begin
            run.append(view)
            run_end = end
        if run:
            total += pread_full(self._fd, run, self.data_start + run_start)
        return total

    def get_tensor(self, name: str) -> torch.Tensor:
        """The tensor, read into a fresh (aligned) CPU buffer."""
        shape, dtype = self.get_shape_dtype(name)
        out = torch.empty(shape, dtype=dtype)
        return self.read_into(name, out)

    def items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        for k in self._entries:
            yield k, self.get_tensor(k)

    def close(self):
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def load_file(path: str) -> Dict[str, torch.Tensor]:
    with SafetensorsFile(path) as f:
        return dict(f.items())


def save_file(tensors: Dict[str, Any], path: str, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (torch tensors on any device, or numpy arrays) in
    key order; the header is padded to 8 bytes, as the JAX writer pads it.
    The file appears at ``path`` only once complete."""
    header: Dict[str, Any] = {"__metadata__": metadata} if metadata else {}
    items, offset = [], 0
    for name, v in tensors.items():
        t = as_tensor(v).detach()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: no safetensors dtype for {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        items.append(t)
        offset += nbytes
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hjson += b" " * ((-(8 + len(hjson))) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for t in items:
            f.write(memoryview(_bytes_view(t.cpu().contiguous())))
    os.replace(tmp, path)


def checkpoint_files(ckpt_dir: str) -> List[str]:
    """The safetensors files of a checkpoint directory: those its
    ``*.index.json`` names if it has one, else every ``*.safetensors`` in
    name order, else those of ``ckpt_dir/original``."""
    index_files = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".index.json"))
    if index_files:
        with open(os.path.join(ckpt_dir, index_files[0])) as f:
            index = json.load(f)
        return [os.path.join(ckpt_dir, n) for n in sorted(set(index["weight_map"].values()))]
    files = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".safetensors"))
    if not files:
        orig = os.path.join(ckpt_dir, "original")
        if os.path.isdir(orig):
            return checkpoint_files(orig)
        raise FileNotFoundError(f"No .safetensors files found in: {ckpt_dir}")
    return [os.path.join(ckpt_dir, n) for n in files]


def load_dir(ckpt_dir: str, keep: Optional[Callable[[str], bool]] = None, device="cpu") -> Dict[str, torch.Tensor]:
    """The tensors of a checkpoint directory (``checkpoint_files``) whose
    names ``keep`` accepts (all without it), each read into its own host
    buffer and moved to ``device`` in its stored dtype before the next is
    read: a tensor the filter drops is never read, and no second full copy
    of the kept ones is held on the host."""
    out: Dict[str, torch.Tensor] = {}
    for path in checkpoint_files(ckpt_dir):
        with SafetensorsFile(path) as f:
            for name in f.keys():
                if keep is None or keep(name):
                    out[name] = f.get_tensor(name).to(device)
    return out


def read_config(path: str, name: str = "config.json") -> dict:
    """A JSON file of an HF model directory (``config.json`` unless
    ``name`` says otherwise)."""
    with open(os.path.join(path, name)) as f:
        return json.load(f)


def load_sharded(ckpt_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a checkpoint directory, on the host."""
    return load_dir(ckpt_dir)


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file, or a torch ``.pth`` read with
    ``weights_only`` and ``mmap`` (its tensors stay on disk until used)."""
    if path.endswith(".safetensors"):
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)
