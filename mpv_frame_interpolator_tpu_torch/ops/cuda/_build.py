"""Build and load the port's CUDA kernels.

Each of the package's own ``csrc/*.cu`` (with the headers beside them)
is compiled by its own nvcc process, all started together, and the
objects are linked into ``libmfi_torch_kernels.so``, loaded with ctypes:
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
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "mfi_torch_kernels"
LIB_NAME = "libmfi_torch_kernels.so"
SOURCES = ("flow_step.cu", "flow_slice.cu", "blur.cu", "warp_pair.cu",
           "warp_fused.cu", "warp_sample.cu", "blend_levels.cu",
           "warp_bilinear.cu", "warp_views.cu", "pair_prologue.cu",
           "pack_probe.cu", "dma_probe.cu")
HEADERS = ("warp_common.cuh", "warp_runs.cuh", "blur_tile.cuh",
           "flow_tile.cuh", "subpel_tile.cuh")

# --fmad=false: no multiply-add contraction, so the warp's f32
# round(flow * t) is the product rounded once, as in the reference;
# -Xptxas=-v: ptxas reports each kernel's registers and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int

# C signature of every entry point: (argtypes); restype is int
_SIGNATURES = {
    # f1y f1u f1v y2 u2 v2 in_x in_y field blurred fine cut sums | steps
    # (host ints) | n_steps sums_words layers radius ds nbs rs H W lh lw
    # f1y_pitch f1c_pitch sample_bytes luma_shift | timeline stream
    "mfi_flow_pyramid": (P,) * 13 + (ctypes.POINTER(I),) + (I,) * 15
    + (P, P),
    # f1y f1u f1v y2 u2 v2 field gathered pairs sums next_sums |
    # next_words ranks prev_code code z0 n radius ds nbs rs H W lh lw
    # f1y_pitch f1c_pitch sample_bytes luma_shift | timeline stream
    "mfi_flow_layer_slice": (P,) * 11 + (I,) * 18 + (P, P),
    # sample_bytes layers radius subpel | per_sm (one host int, out)
    "mfi_flow_pyramid_occupancy": (I, I, I, I, ctypes.POINTER(I)),
    # in out | lh lw | stream
    "mfi_blur_flow": (P, P, I, I, P),
    # offset f1y f1u f1v y2 u2 v2 out field sums | lh lw rs H W f1y_pitch
    # f1c_pitch sample_bytes luma_shift | stream
    "mfi_subpel_refine": (P,) * 10 + (I,) * 9 + (P,),
    # f1y f1uv f2y f2uv blurred ts out_y out_uv | n H Wa pitch lh lw rs
    # scale_shift black white vec | stream
    "mfi_pair_blend": (P,) * 8 + (I,) * 11 + (P,),
    # f1y f1uv f2y f2uv blurred ts out_y out_uv | n H Wa pitch lh lw rs
    # scale_shift black white vec r0 r1 | stream
    "mfi_pair_blend_rows": (P,) * 8 + (I,) * 13 + (P,),
    # f1y f1uv f2y f2uv blurred t out_y out_uv | H Wa pitch lh lw rs
    # scale_shift black white vec | stream
    "mfi_fused_blend": (P,) * 8 + (I,) * 10 + (P,),
    # src_y src_uv blurred t out_y out_uv | H Wa pitch lh lw rs direction
    # sample_bytes vec | stream
    "mfi_sample_dir": (P,) * 6 + (I,) * 9 + (P,),
    # s12y s12uv s21y s21uv t out_y out_uv | H Wa scale_shift black white
    # vec occlusion | stream
    "mfi_blend_levels": (P,) * 7 + (I,) * 7 + (P,),
    # f1y f1uv f2y f2uv blurred frac t out_y out_uv | H Wa pitch lh lw rs
    # scale_shift black white occlusion vec | stream
    "mfi_bilinear_blend": (P,) * 9 + (I,) * 11 + (P,),
    # f1y f1uv f2y f2uv blurred t out_y out_uv | mode H Wa pitch lh lw rs
    # scale_shift black white | stream
    "mfi_warp_sbs": (P,) * 8 + (I,) * 10 + (P,),
    # f1y f1uv f2y f2uv blurred t out_y out_uv | H Wa pitch lh lw rs
    # scale_shift black white | stream
    "mfi_warp_hsv": (P,) * 8 + (I,) * 9 + (P,),
    # blurred out_y out_uv | H Wa lh lw rs scale_shift | stream
    "mfi_warp_grey": (P,) * 3 + (I,) * 6 + (P,),
    # y1 y2 f2u f2v ts_in ts_out py pu pv score cut cuts partials | n rows
    # cols ypitch cpitch rs lh lw sample_bytes bit_shift scene nearest
    # repeat | threshold (float32) | stream
    "mfi_pair_prologue": (P,) * 13 + (I,) * 13 + (ctypes.c_float, P),
    # a idx val acc lo | outs (a table of pointers, one a probe) | mask
    # col_shift row_shift | stream
    "mfi_probe_run": (P,) * 5 + (ctypes.POINTER(P), I, I, I, P),
    # src | src_row_bytes dy dx_bytes rows row_bytes width band_rows |
    # out stream
    "mfi_dma_cp_async": (P,) + (I,) * 7 + (P, P),
    # src | item H W dy dx rows cols | max_polls | load | out stream
    "mfi_dma_tma": (P,) + (I,) * 7 + (ctypes.c_longlong, I, P, P),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found; "
                           "set CUDA_HOME")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def nvcc_commands(nvcc: str, out: Path, objdir: Path):
    """One compile command per source under csrc/ (objects into
    `objdir`), and the command that links them into `out`."""
    objs = [objdir / (Path(s).stem + ".o") for s in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / s), "-o", str(o)]
                for s, o in zip(SOURCES, objs)]
    return compiles, [nvcc, "-shared", "-o", str(out), *map(str, objs)]


def build_log() -> str:
    """nvcc's and ptxas' output of the build that made the library."""
    path = build_dir() / "build.log"
    return path.read_text() if path.exists() else ""


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in SOURCES + HEADERS:
        h.update(s.encode())
        h.update((CSRC_DIR / s).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _start(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(cmd, proc: subprocess.Popen) -> str:
    """Wait for one nvcc process; its output, or raise if it failed."""
    text = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{text}")
    return text


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build the library if this source hash has none yet, then load it
    and declare every entry point's types."""
    out = build_dir() / LIB_NAME
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        # build in a private directory and rename: a concurrent process
        # never sees a half-written library
        tmp = Path(tempfile.mkdtemp(dir=out.parent))
        procs = []
        try:
            compiles, link = nvcc_commands(_nvcc(), tmp / LIB_NAME, tmp)
            procs = [_start(c) for c in compiles]
            log = "".join(_finish(c, p) for c, p in zip(compiles, procs))
            log += _finish(link, _start(link))
            (out.parent / "build.log").write_text(log)
            os.replace(tmp / LIB_NAME, out)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            shutil.rmtree(tmp, ignore_errors=True)
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
    """The raw handle of PyTorch's current stream on t's device, read as
    PyTorch's own generated launchers read it (``torch.cuda.
    current_stream`` builds a Stream object first, which costs the host
    more than some launches)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


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
