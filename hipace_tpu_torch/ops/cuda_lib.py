"""Build and load the port's CUDA kernels (``hipace_tpu_torch/csrc``).

The sources are compiled with ``nvcc`` for sm_90a, one process per source
and all at once, and linked into one shared library with a plain C
interface, loaded through ctypes. The build happens at the first kernel
launch, into ``build/hipace_tpu_torch/<hash>/`` at the root of the checkout,
keyed by a hash of the sources and flags, so a changed source is rebuilt and
an unchanged one reused (processes that build at once, such as the ranks of
a pipelined run, each build into files of their own, renamed into place);
the compiler's output (``-Xptxas -v``: registers, stack frame and spills per
kernel) is kept beside the library. Importing this module builds nothing; a
machine without nvcc fails at the first launch.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libhipace_tpu_torch.so"
LOG_NAME = "nvcc.log"   # the build's compiler output, kept beside the library

_P, _I, _LL, _U, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint, ctypes.c_double)
# C signatures, one per dtype suffix (_f32, _f64)
SIGNATURES = {
    "hipace_deposit": [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _U, _U, _I,
                       _U, _P, _P],
    "hipace_gather_main": [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I,
                           _P],
    "hipace_beam_push": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I,
                         _I, _I, _I, _I, _I, _P],
    "hipace_mg_solve": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _D, _D, _I, _D, _I, _I, _P, _P, _P, _I, _P],
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
        nvcc = [nvcc_path()] + NVCC_FLAGS
        tag = f".{os.getpid()}.tmp"
        objects = [out_dir / f"{p.stem}{tag}.o" for p in cus]
        tmp = out_dir / f".{LIB_NAME}{tag}"
        self.commands = [nvcc + ["-c", "-o", str(o), str(p)]
                         for o, p in zip(objects, cus)]
        self.commands.append(nvcc + ["-shared", "-o", str(tmp)]
                             + [str(o) for o in objects])
        self.build_seconds = 0.0
        self.compiler_output = ""
        self.built = False
        log = out_dir / LOG_NAME
        if self.path.exists():
            self.compiler_output = log.read_text() if log.exists() else ""
        else:
            out_dir.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            procs, outputs = [], []
            try:
                for cmd in self.commands[:-1]:
                    procs.append(subprocess.Popen(
                        cmd, stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT, text=True))
                outputs = [proc.communicate()[0] for proc in procs]
                failed = any(proc.returncode for proc in procs)
                if not failed:
                    link = subprocess.run(
                        self.commands[-1], stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT, text=True, check=False)
                    outputs.append(link.stdout)
                    failed = link.returncode != 0
            finally:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                for o in objects:
                    o.unlink(missing_ok=True)
            self.build_seconds = time.perf_counter() - t0
            self.compiler_output = "".join(outputs)
            if failed:
                raise RuntimeError("nvcc failed:\n" + self.compiler_output)
            # processes that build at once (the ranks of a run) each write
            # their own temporaries and rename them: a process that finds
            # the library finds it whole, and its log
            log_tmp = out_dir / f".{LOG_NAME}{tag}"
            log_tmp.write_text(self.compiler_output)
            os.replace(log_tmp, log)
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


def launch(fn, tensor, *args, what: str) -> None:
    """Call the launcher fn(*args) with tensor's card as the current device
    (a launcher runs on the current device, and the stream it is given
    belongs to tensor's) and check its error."""
    with torch.cuda.device(tensor.device):
        check(fn(*args), what)


def stream_ptr(tensor) -> int:
    return torch.cuda.current_stream(tensor.device).cuda_stream


def require(tensor, name: str, dtype=None, shape=None, device=None) -> None:
    """Check a kernel argument: CUDA, dtype, shape, contiguous."""
    if not tensor.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {tensor.device}")
    if device is not None and tensor.device != device:
        raise ValueError(f"{name} is on {tensor.device}, expected {device}")
    if dtype is not None and tensor.dtype != dtype:
        raise ValueError(f"{name} has dtype {tensor.dtype}, expected {dtype}")
    if shape is not None and tensor.shape != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(tensor.shape)}, "
                         f"expected {tuple(shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
