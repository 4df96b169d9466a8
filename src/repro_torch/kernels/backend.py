"""Device resolution, the CUDA build, and the flush-to-zero guard shared by
every kernel entry point.

Devices.  Entry points run on CUDA unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda`` and raises when there is no card, so
a run never quietly continues on the host.

Build.  Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, loaded with ``ctypes``.
Libraries land in ``kernels/build/`` (git-ignored), named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one loads at once.  :func:`build_all` starts one ``nvcc`` per source, all
together.  Nothing is built or loaded at import time.

Numerics (the reference's arithmetic, not just its formulas):

* ``-ftz=true``: XLA on the CPU and the TPU flush subnormals, so the
  kernels do too; the plain versions run under :func:`flush_denormal`.
* ``-prec-div=true -prec-sqrt=true -fmad=false``: IEEE division and
  square root and no multiply-add contraction, so ``x/s`` is the
  reference's quotient and ``p*s + a`` rounds twice, like the plain
  version.  Never ``--use_fast_math``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("fused_hop", "fused_reduce", "fused_adamw", "fused_rmsnorm",
           "flash_attention", "mailbox")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-ftz=true",
              "-prec-div=true", "-prec-sqrt=true", "-fmad=false",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as
    given.  Tests pass ``device="cpu"`` explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on "
                "the host explicitly")
        return torch.device("cuda")
    return torch.device(device)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "kernels are built from src/repro_torch/kernels/csrc")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together.  Returns ``{name: ptxas report}`` for the sources
    built now (empty for ones already built).  Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n"
                          f"{text}")
            continue
        os.replace(tmp, out)            # atomic: concurrent builds agree
        reports[name] = text
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def stream_ptr() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` from a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def vector_aligned(*tensors: torch.Tensor | None, width: int = 16) -> bool:
    """Whether every tensor given (``None`` skipped) starts on a
    ``width``-byte boundary: the test that sends a kernel down its
    vector path.  A view may start at any element of its storage."""
    return all(t.data_ptr() % width == 0 for t in tensors if t is not None)


def check_cuda(what: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected a contiguous tensor")


def _flushes_now() -> bool:
    tiny = torch.tensor(1e-39, dtype=torch.float32)
    return bool((tiny * 1.0).item() == 0.0)


@contextlib.contextmanager
def flush_denormal():
    """Run the enclosed CPU arithmetic with subnormals flushed to zero,
    as the reference's XLA CPU backend does, and restore the previous
    state after.  ``torch.set_flush_denormal`` sets the calling thread
    only, so the guard also runs torch's intra-op work on that one
    thread for its duration."""
    prev_flush = _flushes_now()
    prev_threads = torch.get_num_threads()
    torch.set_flush_denormal(True)
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev_threads)
        torch.set_flush_denormal(prev_flush)
