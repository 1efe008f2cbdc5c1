"""Build and load the port's CUDA kernels.

All kernels are compiled by one nvcc call from the package's own
``csrc/*.cu`` into ``libmfi_torch_kernels.so`` and loaded with ctypes:
plain C entry points, no PyTorch headers, so the build takes seconds.
The library lands in ``build/mfi_torch_kernels/<hash>/`` beside the
package, keyed by a hash of the sources and the command line, and is
built at the first launch of any kernel -- never at import.

Every C entry point takes device pointers and the CUDA stream as
``void *`` and plain ``int`` scalars, enqueues its launches on that
stream, and returns ``cudaGetLastError()``; ``check`` turns a non-zero
code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "mfi_torch_kernels"
LIB_NAME = "libmfi_torch_kernels.so"
SOURCES = ("flow_step.cu", "blur.cu", "warp_pair.cu")

# --fmad=false: no multiply-add contraction, so the warp's f32
# round(flow * t) is the product rounded once, as in the reference;
# -Xptxas=-v: ptxas reports each kernel's registers and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int

# C signature of every entry point: (argtypes); restype is int
_SIGNATURES = {
    # f1y f1u f1v y2 u2 v2 off_x off_y out sums | is_y radius ds nbs
    # window nb_enabled rs H W lh lw f1y_pitch f1c_pitch | stream
    "mfi_flow_step": (P,) * 10 + (I,) * 13 + (P,),
    # in out | planes lh lw | stream
    "mfi_blur_flow": (P, P, I, I, I, P),
    # f1y f1uv f2y f2uv blurred ts out_y out_uv | n H Wa pitch lh lw rs
    # | stream
    "mfi_pair_blend": (P,) * 8 + (I,) * 7 + (P,),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found; "
                           "set CUDA_HOME")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def nvcc_command(nvcc: str, out: Path) -> list:
    """The one compile command: every source under csrc/, nothing else."""
    return [nvcc, *NVCC_FLAGS, "-o", str(out),
            *(str(CSRC_DIR / s) for s in SOURCES)]


def build_log() -> str:
    """nvcc's and ptxas' output of the build that made the library."""
    path = build_dir() / "build.log"
    return path.read_text() if path.exists() else ""


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in SOURCES:
        h.update(s.encode())
        h.update((CSRC_DIR / s).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build the library if this source hash has none yet, then load it
    and declare every entry point's types."""
    out = build_dir() / LIB_NAME
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        # build to a private name and rename: a concurrent process never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = nvcc_command(_nvcc(), Path(tmp))
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        (out.parent / "build.log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(name: str, rc: int):
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on t's device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtype, shape=None, device=None):
    """Wrapper-side validation: a CUDA tensor of the given dtype (and
    shape / device), contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class LaunchCounts:
    """Plain counters of one kernel module: `kernel` counts launches of
    the CUDA kernel, `plain` calls of its PyTorch version (CPU tensors)."""

    __slots__ = ("kernel", "plain")

    def __init__(self):
        self.reset()

    def reset(self):
        self.kernel = 0
        self.plain = 0
