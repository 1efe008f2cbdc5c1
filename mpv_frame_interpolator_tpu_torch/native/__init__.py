"""The port's native host library, ``_mfi_native``: the y4m and container
reader rings, NV12 chroma (de)interleave, and the FFV1, Ut Video and
baseline-JPEG codecs (C++ over the CPython C API; this directory's
``*.cpp``).

It is built at first use, never at import: one ``g++`` process compiles
the four sources into ``build/mfi_torch_native/<hash>/_mfi_native.so``
beside the package, keyed by a hash of the sources, the compiler and its
flags, and loads it with ``importlib``.  A concurrent build (test workers) writes
to a private name and renames it into place, so no process loads a
half-written library.  A failed build raises ``NativeBuildError`` with the
compiler's output: nothing falls back to Python.  The Python codecs
(``use_native=False``, ``--ingest python``) are the plain versions and run
only where the caller asks for them.

The compiler is ``$CXX`` where set, else ``g++``.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_ROOT = NATIVE_DIR.parents[1] / "build" / "mfi_torch_native"
SOURCES = ("repack.cpp", "jpeg.cpp", "utvideo.cpp", "ffv1.cpp")
MODULE = "_mfi_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-Wall", "-pthread", "-shared", "-fPIC")


class NativeBuildError(RuntimeError):
    """The native library could not be built or loaded."""


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def python_include() -> Path:
    return Path(sysconfig.get_paths()["include"])


def toolchain_missing() -> Optional[str]:
    """Why the library cannot be built on this machine (no C++ compiler,
    no ``Python.h``), or None when both are there."""
    if shutil.which(compiler()) is None:
        return f"no C++ compiler ({compiler()!r} is not on the PATH)"
    header = python_include() / "Python.h"
    if not header.exists():
        return f"no {header} (the Python development headers)"
    return None


def command(cxx: str, out: Path):
    """The one compile-and-link command that builds the library `out`."""
    return [cxx, *CXX_FLAGS, f"-I{python_include()}",
            *(str(NATIVE_DIR / s) for s in SOURCES), "-o", str(out)]


def build_dir(cxx: Optional[str] = None) -> Path:
    """Where this build lives: keyed by the compiler, its flags, the
    Python include directory and each source's name and bytes."""
    cxx = cxx or compiler()
    h = hashlib.sha256(" ".join([cxx, *CXX_FLAGS,
                                 str(python_include())]).encode())
    for s in SOURCES:
        h.update(s.encode())
        h.update((NATIVE_DIR / s).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(cxx: Optional[str] = None, root: Optional[Path] = None) -> Path:
    """The library's path, compiling it first if this hash has none yet
    (under `root`, default ``build_dir``).  Raises NativeBuildError with
    the compiler's output if the compiler fails."""
    cxx = cxx or compiler()
    out_dir = root if root is not None else build_dir(cxx)
    out = out_dir / f"{MODULE}.so"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = command(cxx, Path(tmp))
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"building {MODULE} failed ({proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}")
        (out_dir / "build.log").write_text(" ".join(cmd) + "\n"
                                           + proc.stdout)
        os.replace(tmp, out)
    except OSError as e:
        raise NativeBuildError(f"building {MODULE}: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=1)
def load():
    """The native module, built on first use.  It is named
    ``_mfi_native``, which its ``PyInit__mfi_native`` matches."""
    path = build()
    spec = importlib.util.spec_from_file_location(
        f"{__name__}.{MODULE}", str(path))
    try:
        mod = importlib.util.module_from_spec(spec)     # dlopen
        spec.loader.exec_module(mod)
    except ImportError as e:
        raise NativeBuildError(f"loading {path}: {e}") from e
    return mod


def interleave_chroma_into(u: np.ndarray, v: np.ndarray,
                           out: np.ndarray) -> np.ndarray:
    """out[:, 0::2] = u; out[:, 1::2] = v (uint8 or uint16 planes whose
    rows are contiguous)."""
    load().interleave_chroma(u, v, out)
    return out


def deinterleave_chroma_into(uv: np.ndarray, u: np.ndarray, v: np.ndarray):
    """u[:] = uv[:, 0::2]; v[:] = uv[:, 1::2]."""
    load().deinterleave_chroma(uv, u, v)
    return u, v
