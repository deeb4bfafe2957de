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
* **Counts.** Each wrapper's ``launches`` adds one for every call on
  CUDA tensors, where it launches its kernel on PyTorch's current
  stream. Under a CUDA graph capture that launch is recorded, not run,
  and it still counts once; the graph's replays run the kernel again
  without a call and count nothing. So a counter counts eager launches
  and captures; the launches of a captured round are its replays
  (``core/federated.py::_CapturedRound.replays``) times what the
  capture counted, or what a profile of the replays shows by kernel
  name (``chip_smoke.py`` phase 4h holds the two to each other).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# loaded libraries by source stem, their bound C entries by symbol, and
# the ptxas report and seconds of each build (all started together)
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, ctypes._CFuncPtr] = {}
BUILD_LOG: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}


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


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and an operand requires grad: for a
    kernel with no backward, whose CUDA result would carry no
    ``grad_fn`` while the CPU's plain version differentiates. Checked on
    both devices, so the CPU tests see what the card would do."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward yet (ROADMAP C.1): call it under "
            "torch.no_grad() or with operands that do not require grad; "
            "LM training takes the plain branch (use_kernels=False), as "
            "the reference differentiates its plain path")


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
    t0 = time.perf_counter()
    for n in todo:
        tmp = paths[n].with_suffix(f".tmp{os.getpid()}")
        log = tmp.with_suffix(f".log{os.getpid()}")
        with open(log, "w") as out:
            procs[n] = (tmp, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])],
                stdout=out, stderr=subprocess.STDOUT))
    pending = set(procs)
    while pending:  # each build's own seconds
        for n in [n for n in pending if procs[n][2].poll() is not None]:
            BUILD_SECONDS[n] = time.perf_counter() - t0
            pending.discard(n)
        time.sleep(0.05)
    failed = []
    for n, (tmp, log, proc) in procs.items():
        out = BUILD_LOG[n] = log.read_text()
        log.unlink()
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
