"""Build the package's CUDA kernels at first use and load them with ctypes.

Every `csrc/*.cu` file is compiled by `nvcc` into ONE shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), named
by a hash of the sources and flags, in the package's `build/` directory
(gitignored). A library whose hash matches is reused; a changed source
builds anew. Importing this module runs nothing: the compiler runs on the
first `load_library()` call, and a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # per-kernel registers, shared memory and spills go to the build log
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libscc_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH or CUDA_HOME): the CUDA kernels cannot be built"
    )


def build() -> Path:
    """Compile the library unless a build of the same sources exists.
    The compiler's output is kept beside it as `<name>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    return out


def build_log() -> str:
    """The compiler's output for the current library ('' before a build)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.scc_stft_launch.argtypes = [
                p, p, p, p, i64, i64, i64, i32, i32, i32, i32,
                ctypes.c_double, p,
            ]
            lib.scc_stft_launch.restype = i32
            f32 = ctypes.c_float
            # csrc/stft_variants.cu
            lib.scc_stftv_mma_launch.argtypes = [
                p, p, p, p, i64, i64, i64, i32, i32, i32, i32, i32, i32,
                f32, p,
            ]
            lib.scc_stftv_mma_launch.restype = i32
            lib.scc_stftv_f32_launch.argtypes = [
                p, p, p, p, i64, i64, i64, i32, i32, i32, i32, i32, f32, p,
            ]
            lib.scc_stftv_f32_launch.restype = i32
            lib.scc_stftv_passthrough_launch.argtypes = [
                p, p, i64, i64, i64, i32, i32, i32, p,
            ]
            lib.scc_stftv_passthrough_launch.restype = i32
            # csrc/stft_layout.cu
            lib.scc_stftl_launch.argtypes = [
                p, p, p, p, i64, i64, i32, i32, i32, f32, p,
            ]
            lib.scc_stftl_launch.restype = i32
            lib.scc_cuda_error_string.argtypes = [i32]
            lib.scc_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
