"""Build, load and dispatch of the hand-written CUDA kernels.

* **Build.** Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
  into its own shared library with a plain C interface, one ``nvcc``
  per source, all started together. The libraries land in ``build/`` at
  the repository root (git-ignored), named by a hash of the sources and
  flags, so an edited source rebuilds and an unchanged one loads as is.
  Nothing is built when a module is imported: the first launch on a
  CUDA tensor builds, or ``build()`` does it up front.
* **Load.** ``ctypes``; every pointer and the stream pass as
  ``c_void_p``, every int as ``c_int``. Each C entry returns
  ``cudaGetLastError()`` and ``check()`` raises on anything but 0.
* **Dispatch.** A kernel wrapper follows its tensors: on the CPU it runs
  the kernel's plain PyTorch version, on a CUDA device it launches the
  kernel or raises. There is no fallback from a failed build or launch
  to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# loaded libraries by source stem, their bound C entries by symbol, and
# the ptxas report of each build
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, ctypes._CFuncPtr] = {}
BUILD_LOG: Dict[str, str] = {}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA on a machine without a card raises instead
    of running on the CPU. On CUDA, TF32 is switched off for matmuls
    and convolutions: the port computes in full float32 like the JAX
    reference."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def on_cpu(what: str, *tensors: torch.Tensor, dtypes) -> bool:
    """Hold the operands to the kernel's contract (one device, the given
    dtypes, contiguous) on either device, so the CPU tests catch a
    layout the kernel would refuse. True when they lie on the CPU (the
    plain version runs), False when they lie on a CUDA device (the
    kernel launches)."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{what}: operands lie on different devices, "
                             f"{t.device} and {dev}")
        if t.dtype != dt:
            raise ValueError(f"{what}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    return dev.type == "cpu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built")


def _sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every source that has no library for its current content
    yet, one ``nvcc`` process each, in parallel. Returns the library
    path of every source."""
    srcs = _sources()
    paths = {n: _lib_path(p) for n, p in srcs.items()}
    todo = [n for n in srcs if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".tmp{os.getpid()}")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def kernel(source: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of ``csrc/<source>.cu``, loaded on first
    use; the first use of any kernel builds every source. Raises when
    there is no CUDA device or no compiler."""
    fn = _FNS.get(symbol)
    if fn is not None:
        return fn
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"the {source} kernel needs a CUDA device, and none is "
            "available")
    lib = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build()[source]))
        _LIBS[source] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _FNS[symbol] = fn
    return fn


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as a pointer."""
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
