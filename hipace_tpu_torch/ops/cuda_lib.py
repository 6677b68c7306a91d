"""Build and load the port's CUDA kernels (``hipace_tpu_torch/csrc``).

The sources are compiled with ``nvcc`` for sm_90a into one shared library
with a plain C interface, loaded through ctypes. The build happens at the
first kernel launch, into ``build/hipace_tpu_torch/<hash>/`` at the root of
the checkout, keyed by a hash of the sources and flags, so a changed source
is rebuilt and an unchanged one reused. Importing this module builds
nothing; a machine without nvcc fails at the first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "hipace_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libhipace_tpu_torch.so"

_P, _I, _LL, _U, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint, ctypes.c_double)
# C signatures, one per dtype suffix (_f32, _f64)
SIGNATURES = {
    "hipace_deposit": [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _U, _U, _P],
    "hipace_gather_main": [_P, _P, _P, _P, _LL, _I, _I, _I, _P],
    "hipace_mg_smooth": [_P, _P, _P, _I, _I, _I, _D, _D, _I, _P],
    "hipace_mg_residual": [_P, _P, _P, _P, _I, _I, _I, _D, _D, _P],
    "hipace_mg_restrict": [_P, _P, _P, _I, _I, _I, _P],
    "hipace_mg_prolong_add": [_P, _P, _I, _I, _I, _P],
    "hipace_mg_maxabs": [_P, _P, _LL, _P],
    "hipace_mg_coarse": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                         _I, _I, _P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The loaded shared library and how it was obtained."""

    def __init__(self):
        out_dir = BUILD_ROOT / source_hash()
        self.path = out_dir / LIB_NAME
        cus, _ = _sources()
        self.command = [nvcc_path()] + NVCC_FLAGS + [
            "-o", str(self.path)] + [str(p) for p in cus]
        self.build_seconds = 0.0
        self.compiler_output = ""
        self.built = False
        if not self.path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
            cmd = self.command[:]
            cmd[cmd.index(str(self.path))] = str(tmp)
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  check=False)
            self.build_seconds = time.perf_counter() - t0
            self.compiler_output = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + self.compiler_output)
            os.replace(tmp, self.path)
            self.built = True
        self.lib = ctypes.CDLL(str(self.path))
        for name, argtypes in SIGNATURES.items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(self.lib, name + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int

    def fn(self, name: str, dtype):
        suffix = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
        return getattr(self.lib, name + suffix)


_LIBRARY: KernelLibrary | None = None


def library() -> KernelLibrary:
    """The kernel library, built on first use in this process."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = KernelLibrary()
    return _LIBRARY


def use_kernel(tensor) -> bool:
    """The dispatch rule of every kernel wrapper: CUDA tensors launch the
    kernel, CPU tensors take the plain version, anything else raises."""
    if tensor.device.type == "cuda":
        return True
    if tensor.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {tensor.device}")


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed with cudaError {err}")


def stream_ptr(tensor) -> int:
    return torch.cuda.current_stream(tensor.device).cuda_stream


def require(tensor, name: str, dtype=None, shape=None, device=None) -> None:
    """Check a kernel argument: CUDA, dtype, shape, contiguous."""
    if tensor.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {tensor.device}")
    if device is not None and tensor.device != device:
        raise ValueError(f"{name} is on {tensor.device}, expected {device}")
    if dtype is not None and tensor.dtype != dtype:
        raise ValueError(f"{name} has dtype {tensor.dtype}, expected {dtype}")
    if shape is not None and tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(tensor.shape)}, "
                         f"expected {tuple(shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
