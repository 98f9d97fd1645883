"""Build the CUDA kernels of `csrc/` at first use and load them.

Each `csrc/*.cu` file is compiled by `nvcc` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded
with `ctypes`.  Libraries are named by a hash of their sources and flags
and kept in `_build/` beside this package (git-ignored;
`TOKENIZERS_TPU_TORCH_BUILD` overrides the directory), so an edited source
is rebuilt and an unchanged one is reused.  `build()` compiles every
missing library at once, one `nvcc` process per source.  `defines` builds
a variant of a source with preprocessor macros set (`-D`), kept beside the
plain build under a name that includes them.  nvcc's output (ptxas's
register and spill report) is kept beside each library (`build_log`).

A failed build raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, Iterable, Tuple

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
SOURCES = ("merge_round.cu", "layout.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

SMEM_MAX = 232448  # dynamic shared memory a block may use on an H100
PORTABLE_N = 8  # the widest thread-block cluster every Hopper part must hold

_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
# (library, entry, device, slice, cluster size, args) -> clusters resident at once
CLUSTERS: Dict[Tuple[str, str, int, int, int, Tuple[int, ...]], int] = {}


def build_dir() -> str:
    return os.environ.get("TOKENIZERS_TPU_TORCH_BUILD") or os.path.join(PKG, "_build")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path(src: str, defines: Tuple[str, ...] = ()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + _d_flags(defines)).encode())
    for name in sorted(os.listdir(CSRC)):
        if name == src or name.endswith(".cuh"):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    stem = os.path.splitext(src)[0] + "".join(f"-{d}" for d in defines)
    return os.path.join(build_dir(), f"lib{stem}-{h.hexdigest()[:16]}.so")


def _d_flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(f"-D{d}" for d in defines)


def build(sources: Iterable[str] = SOURCES, defines: Tuple[str, ...] = ()) -> Dict[str, str]:
    """Compile the libraries that are missing, all in parallel, each with
    the macros `defines`.  Returns {source: library path}."""
    os.makedirs(build_dir(), exist_ok=True)
    paths = {s: _lib_path(s, defines) for s in sources}
    procs = {}
    for src, path in paths.items():
        if os.path.exists(path) and os.path.exists(f"{path}.log"):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, *_d_flags(defines), "-o", tmp, os.path.join(CSRC, src)]
        procs[src] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    errors = []
    for src, (tmp, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed on {src} (exit {p.returncode}):\n{out}")
        else:
            with open(f"{tmp}.log", "w") as f:
                f.write(out)
            os.replace(f"{tmp}.log", f"{paths[src]}.log")
            os.replace(tmp, paths[src])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(src: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of one source (with the macros `defines`), built
    first if needed."""
    lib = _libs.get((src, defines))
    if lib is None:
        lib = ctypes.CDLL(build([src], defines)[src])
        _libs[(src, defines)] = lib
    return lib


def build_log(src: str, defines: Tuple[str, ...] = ()) -> str:
    """nvcc's output (ptxas's `-v` report) from the build of the library of
    `src` with `defines`, kept beside it; builds it first if needed."""
    with open(f"{build([src], defines)[src]}.log") as f:
        return f.read()


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """{mangled kernel name: {"registers", "spill_store_bytes",
    "spill_load_bytes", "stack_bytes", "static_smem_bytes"}} from the
    `-Xptxas -v` report of one build (`build_log`)."""
    out: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(m.group(1)) if m else 0
    return out


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")


def check_cuda_int32(name: str, shape, **tensors) -> None:
    """Raise unless every tensor is a contiguous int32 CUDA tensor of
    `shape` (None: any shape) on one device."""
    import torch

    dev = None
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected cuda")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected int32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")


def device_of(name: str, t) -> str:
    """'cpu' for the plain version, 'cuda' for the kernel; anything else
    raises."""
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def max_clusters(lib: ctypes.CDLL, entry: str, dev, S: int, n: int, *args: int) -> int:
    """Clusters of n CTAs with slices of S that the card `dev` holds at
    once: the library's `entry(S, n, *args)` (cudaOccupancyMaxActiveClusters),
    asked once per library, device, shape and args.  Raises where it is not
    positive: such a cluster can never launch, and there is no fallback."""
    import torch

    key = (lib._name, entry, dev.index, S, n, args)
    if key not in CLUSTERS:
        with torch.cuda.device(dev):
            num = getattr(lib, entry)(S, n, *args)
        if num <= 0:
            raise RuntimeError(f"{entry}: no cluster of {n} CTAs with slices of {S} fits "
                               f"the card (cudaOccupancyMaxActiveClusters: {num})")
        CLUSTERS[key] = num
    return CLUSTERS[key]
