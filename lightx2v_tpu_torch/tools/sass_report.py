"""Compiles ``csrc`` sources to cubins with the build's nvcc flags and reports
their SASS, one JSON line per kernel: the counts of the tensor-core and
conversion instructions that tell how a kernel was lowered (``IGMMA``,
``HGMMA``, ``QGMMA``, ``IMMA``, ``HMMA``, ``I2F``, ``I2FP``, ``MUFU.EX2``),
of local-memory stores and loads (``STL``, ``LDL``: spills) and of register
reallocations (``USETMAXREG``, from ``setmaxnreg``), and the count of all
instructions.

    python3 lightx2v_tpu_torch/tools/sass_report.py SOURCE [SOURCE ...]
    python3 lightx2v_tpu_torch/tools/sass_report.py flash_attention --same-as OTHER_ROOT --kernel flash_wgmma_kernel
    python3 lightx2v_tpu_torch/tools/sass_report.py w8a8_matmul --same-as OTHER_ROOT --kernel w8a8_wgmma_kernel

SOURCE is a file stem under ``lightx2v_tpu_torch/csrc`` (``sage_attention``).
With ``--same-as``, each kernel whose name holds ``--kernel`` is also
compiled from the checkout at OTHER_ROOT and its instructions compared line
by line (addresses and encodings dropped): the line says ``identical`` and
how many lines differ. Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit);
writes the cubins under ``build/sass``.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OPS = ("IGMMA", "HGMMA", "QGMMA", "IMMA", "HMMA", "I2F", "I2FP", "MUFU.EX2", "STL", "LDL", "USETMAXREG")
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def _flags():
    sys.path.insert(0, str(ROOT))
    from lightx2v_tpu_torch.ops.cuda import _build

    drop = {"-shared", "-fPIC", "-Xcompiler", "-Xptxas", "-v"}
    return _build.nvcc_path(), [f for f in _build.NVCC_FLAGS if f not in drop]


def sass(root: Path, stem: str, tag: str) -> dict:
    """{kernel name: [instruction text, ...]} of csrc/<stem>.cu under root."""
    nvcc, flags = _flags()
    out = ROOT / "build" / "sass" / f"{stem}-{tag}.cubin"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(out), str(root / "lightx2v_tpu_torch" / "csrc" / f"{stem}.cu")],
                   check=True)
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(out)], capture_output=True, text=True, check=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
            continue
        m = _INSTR.search(line)
        if name and m:
            kernels[name].append(m.group(1))
    return {_demangle(k): v for k, v in kernels.items()}


def _demangle(name: str) -> str:
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if not tool:
        return name
    return subprocess.run([tool, name], capture_output=True, text=True).stdout.strip() or name


def counts(instrs) -> dict:
    c = {op: sum(1 for i in instrs if re.search(rf"(^|\s){re.escape(op)}[\s.]", i + " ")) for op in OPS}
    c["instructions"] = len(instrs)
    return c


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--same-as", metavar="OTHER_ROOT", default=None)
    ap.add_argument("--kernel", default=None, help="with --same-as: compare the kernels whose name holds this")
    args = ap.parse_args()
    for stem in args.sources:
        mine = sass(ROOT, stem, "this")
        other = sass(Path(args.same_as).resolve(), stem, "other") if args.same_as else None
        for name, instrs in mine.items():
            line = {"source": stem, "kernel": name, **counts(instrs)}
            if other is not None and args.kernel and args.kernel in name:
                match = [o for o in other if o == name] or [o for o in other if args.kernel in o]
                if match:
                    theirs = other[match[0]]
                    pairs = [(i, a, b) for i, (a, b) in enumerate(zip(instrs, theirs)) if a != b]
                    diff = len(pairs) + abs(len(instrs) - len(theirs))
                    line.update(other_kernel=match[0], identical=instrs == theirs, lines_differing=diff,
                                first_differences=pairs[:8])
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
