"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`_kernels_build/lib<name>-<hash>.so` inside the package (a directory the
repository's `.gitignore` lists), at first use, for `sm_90a`.  The hash
covers the source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source or header is never served a stale library.  Several sources
build in parallel: one nvcc process each.
Nothing here runs at import time, and there is no fallback: a missing nvcc
or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_kernels_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false",  # an FMA would change the packed key bits
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
)
#: Every source under csrc/: B1, B3 and B7i (int8_tile_topk), B2, B4, B5 and
#: B7f (float_tile_topk), B6 (batch_relevance), B8 (kernel_sweep).
KERNEL_SOURCES = (
    "int8_tile_topk", "packed_candidate_merge", "float_tile_topk", "batch_relevance",
    "kernel_sweep",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built"
        )
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, all nvcc
    processes at once.  Returns {name: ptxas report} for what was built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            target,
        )
    reports, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
        target.with_suffix(".log").write_text(out)
        reports[name] = out
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


KERNEL_NAMES = ("Int8", "Bf16", "PackedKey", "SuperKey", "ExactKey", "__nv_bfloat16")


def kernel_label(mangled: str) -> str:
    """A readable name for a mangled kernel: its base name, then its
    template's integers, known types and a set DOTS flag, as
    tc_tile_topk_kernel<128,16,Int8,PackedKey> (a kernel's name ends in
    `_kernel`, or `_kernel_tc` for B4's tensor-core kernel)."""
    base = None
    for i in range(len(mangled)):  # names are length-prefixed
        m = re.match(r"\d+", mangled[i:])
        name = mangled[i + m.end():i + m.end() + int(m.group())] if m else ""
        if name.endswith(("_kernel", "_kernel_tc")):
            base = name
            break
    if base is None:
        return mangled[:64]
    tail = mangled.split(base, 1)[1]
    tail = tail.split("Ev", 1)[0] if tail.startswith("I") else ""  # the template's arguments
    args = re.findall(r"Li(\d+)E|Lb(1)E|(" + "|".join(KERNEL_NAMES) + ")", tail)
    parts = [a or ("DOTS" if b else c.replace("__nv_bfloat16", "bf16")) for a, b, c in args]
    return base + (f"<{','.join(parts)}>" if parts else "")


def ptxas_report(report: str) -> List[Tuple[str, str]]:
    """(kernel label, "N registers, stack and spill bytes") for each entry
    function of a build's `-Xptxas -v` log."""
    out, fn, frame = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = kernel_label(m.group(1))
        elif "stack frame" in line:
            frame = line.strip()
        elif fn and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((fn, f"{regs} registers, {frame}"))
            fn = None
    return out


def sass_opcodes(lib: Path) -> Dict[str, List[str]]:
    """{kernel label: its machine instructions' opcodes in order} of a built
    library, read with the toolkit's cuobjdump."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = kernel_label(m.group(1))
            out[fn] = []
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and op:
            out[fn].append(op.group(1))
    return out
