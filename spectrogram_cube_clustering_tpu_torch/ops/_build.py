"""Build the package's CUDA kernels at first use and load them with ctypes.

Every `csrc/*.cu` file is compiled by `nvcc`, one process a file, all
started together, and the objects linked into ONE shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), named by
a hash of the sources, the headers (`csrc/*.cuh`) and the flags, in the
package's `build/` directory (gitignored). A library whose hash matches is
reused; a changed source builds anew. Importing this module runs nothing:
the compiler runs on the first `load_library()` call, and a failed build
raises with the compiler's output. `opcode_counts` reads the built
library's SASS (`cuobjdump -sass`, beside `nvcc`) for the instructions of
one opcode in each kernel: DMMA (FP64 tensor cores) or HMMA (TF32 and bf16
tensor cores).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
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


def _run_all(cmds: list) -> tuple:
    """Run the commands at once; (the first failing return code or 0,
    each command and its output)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    log, rc = "", 0
    for cmd, proc in zip(cmds, procs):
        text = proc.communicate()[0]
        log += f"$ {' '.join(cmd)}\n{text}"
        rc = rc or proc.returncode
    return rc, log


def build() -> Path:
    """Compile the library unless a build of the same sources exists:
    every source at once, then one link. The compiler's output is kept
    beside it as `<name>.log`."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in sources()]
    rc, log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(sources(), objs)])
    tmp = out.with_name(f"{stem}.tmp.so")
    if rc == 0:
        rc, link = _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                              *map(str, objs)]])
        log += link
    for obj in objs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(log)
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({rc}):\n{log}")
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
                p, p, i32, i32, i32, i32, i32, i32, p,
            ]
            lib.scc_stftv_passthrough_launch.restype = i32
            # csrc/stft_layout.cu
            lib.scc_stftl_launch.argtypes = [
                p, p, p, p, i64, i64, i32, i32, i32, f32, p,
            ]
            lib.scc_stftl_launch.restype = i32
            # csrc/convt.cu
            lib.scc_convt_relu_launch.argtypes = [
                p, p, p, p, i64, *[i32] * 13, p,
            ]
            lib.scc_convt_relu_launch.restype = i32
            # csrc/conv_enc.cu
            lib.scc_conv_relu3_launch.argtypes = [
                *[p] * 10, i64, i32, i32, i32, i32, p,
            ]
            lib.scc_conv_relu3_launch.restype = i32
            lib.scc_cuda_error_string.argtypes = [i32]
            lib.scc_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def sass() -> str:
    """`cuobjdump -sass` of the built library (built first if needed)."""
    path = build()
    tool = Path(_nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(path)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout


def opcode_counts(text: str, opcode: str) -> dict:
    """Per kernel of a `cuobjdump -sass` listing (its mangled name), the
    number of instructions of `opcode` (any variant: "HMMA" counts
    HMMA.1688.F32.TF32 and HMMA.16816.F32.BF16)."""
    op = re.compile(rf"\b{re.escape(opcode)}\b")
    counts, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = 0
        elif name is not None and op.search(line):
            counts[name] += 1
    return counts
