"""Build the port's hand-written kernels into shared libraries with a
plain C interface and load them through ``ctypes``.

The CUDA sources are compiled by ``nvcc`` at first use into
``ppls_tpu_torch/csrc/build/<hash>/``, keyed by a hash of the sources and
flags, so a fresh checkout builds them on its first call and later
calls reuse the library. A failed build raises. The same header also
compiles with ``g++`` into a host library the CPU tests use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"

# Numerics flags are part of the kernel's contract: the ds error-free
# transforms need IEEE float32 with no multiply-add contraction and no
# flush-to-zero. Never add --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-ftz=false", "-prec-div=true",
              "-prec-sqrt=true", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")
HOST_FLAGS = ("-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")


class BuiltLib(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: float     # 0.0 when the library was already built
    log: str                 # compiler output (ptxas register report)


def find_nvcc() -> Optional[str]:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand:
            p = Path(cand) / "bin" / "nvcc"
            if p.exists():
                return str(p)
    return shutil.which("nvcc")


def _digest(sources: Sequence[Path], cmd: Sequence[str]) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(cmd).encode())
    return h.hexdigest()[:16]


def build_library(name: str, compiler: str, flags: Sequence[str],
                  sources: Sequence[Path], depends: Sequence[Path],
                  out_root: Path) -> BuiltLib:
    """Compile ``sources`` into ``out_root/<hash>/lib<name>.so`` unless
    that file exists, and load it. Raises ``RuntimeError`` with the
    compiler output when the build fails."""
    cmd = [compiler, *flags]
    key = _digest([*sources, *depends], cmd)
    out_dir = Path(out_root) / key
    lib_path = out_dir / f"lib{name}.so"
    log_path = out_dir / f"{name}.log"
    seconds = 0.0
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [*cmd, "-I", str(CSRC), "-o", str(tmp),
             *[str(s) for s in sources]],
            capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} with {compiler} failed "
                f"(exit {proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib_path)
    log = log_path.read_text() if log_path.exists() else ""
    return BuiltLib(ctypes.CDLL(str(lib_path)), lib_path, seconds, log)


@functools.lru_cache(maxsize=None)
def load_walk_rf() -> BuiltLib:
    """Build (at first use) and load the K1 walk-segment kernel."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
            "/usr/local/cuda and PATH); the walk kernel is built from "
            "ppls_tpu_torch/csrc at first use")
    built = build_library("walk_rf", nvcc, NVCC_FLAGS,
                          [CSRC / "walk_rf.cu"], [CSRC / "walk_step.cuh"],
                          BUILD_DIR)
    lib = built.lib
    lib.walk_rf_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.walk_rf_launch.restype = ctypes.c_int
    lib.walk_rf_max_coresident_blocks.argtypes = [ctypes.c_int,
                                                  ctypes.c_int]
    lib.walk_rf_max_coresident_blocks.restype = ctypes.c_int
    return built


def build_walk_host(out_root: Path) -> BuiltLib:
    """Build the host (g++) twin of the K1 step machine into
    ``out_root`` and load it. Used by the CPU tests only."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    built = build_library("walk_host", gxx, HOST_FLAGS,
                          [CSRC / "walk_host.cpp"],
                          [CSRC / "walk_step.cuh"], out_root)
    fn = built.lib.walk_rf_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return built
