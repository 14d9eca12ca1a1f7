"""Build the port's hand-written kernels into shared libraries with a
plain C interface and load them through ``ctypes``.

Each CUDA source is compiled by ``nvcc`` at first use into
``ppls_tpu_torch/csrc/build/<hash>/``, keyed by a hash of the sources and
flags, so a fresh checkout builds them on its first call and later
calls reuse the library. A build holds an exclusive file lock in its
directory, so threads (a serve attempt under a watchdog and its retry)
and processes that reach the first use at once build it once. A failed
build raises. The same header also
compiles with ``g++`` into a host library the CPU tests use.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
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
HOST_FLAGS = ("-O2", "-ffp-contract=off", "-std=c++20", "-shared", "-fPIC")
DEVICE_HEADERS = (CSRC / "walk_step.cuh", CSRC / "walk_grid.cuh")

# libraries this process compiled (a warm build directory compiles none)
_BUILDS = {"n": 0}


def builds_done() -> int:
    """How many libraries this process has compiled so far."""
    return _BUILDS["n"]


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
    that file exists, and load it. The build runs under an exclusive
    ``flock`` of ``<name>.lock`` in that directory (the kernel drops it
    when its holder exits), so concurrent first uses build once and the
    others load the result. Raises ``RuntimeError`` with the compiler
    output when the build fails."""
    cmd = [compiler, *flags]
    key = _digest([*sources, *depends], cmd)
    out_dir = Path(out_root) / key
    lib_path = out_dir / f"lib{name}.so"
    log_path = out_dir / f"{name}.log"
    seconds = 0.0
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / f"{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not lib_path.exists():
                seconds = _compile(name, compiler, cmd, sources, out_dir,
                                   lib_path, log_path)
    log = log_path.read_text() if log_path.exists() else ""
    return BuiltLib(ctypes.CDLL(str(lib_path)), lib_path, seconds, log)


def _compile(name: str, compiler: str, cmd: Sequence[str],
             sources: Sequence[Path], out_dir: Path, lib_path: Path,
             log_path: Path) -> float:
    """Run the compiler into a temporary file and rename it into place;
    returns the seconds it took."""
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
    _BUILDS["n"] += 1
    return seconds


def _load_nvcc(name: str) -> BuiltLib:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
            "/usr/local/cuda and PATH); the walk kernels are built from "
            "ppls_tpu_torch/csrc at first use")
    return build_library(name, nvcc, NVCC_FLAGS, [CSRC / f"{name}.cu"],
                         DEVICE_HEADERS, BUILD_DIR)


def _sig(fn, argtypes, restype=ctypes.c_int):
    fn.argtypes = argtypes
    fn.restype = restype


_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def load_walk_rf() -> BuiltLib:
    """Build (at first use) and load K1, the in-kernel-refill segment."""
    built = _load_nvcc("walk_rf")
    _sig(built.lib.walk_rf_launch,
         [_P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P])
    _sig(built.lib.walk_rf_max_coresident_blocks, [_I, _I, _I])
    return built


@functools.lru_cache(maxsize=None)
def load_walk_ee() -> BuiltLib:
    """Build (at first use) and load K2, the early-exit segment."""
    built = _load_nvcc("walk_ee")
    _sig(built.lib.walk_ee_launch,
         [_P, _I, _I, _I, _F, _I, _I, _I, _I, _P])
    _sig(built.lib.walk_ee_max_coresident_blocks, [_I, _I, _I])
    return built


@functools.lru_cache(maxsize=None)
def load_walk_seg() -> BuiltLib:
    """Build (at first use) and load K3, the fixed-length segment."""
    built = _load_nvcc("walk_seg")
    _sig(built.lib.walk_seg_launch, [_P, _I, _I, _I, _F, _I, _P])
    return built


def load_all_kernels() -> dict:
    """Build every walk kernel at once (one nvcc process per source, all
    started together) and load them: ``{name: BuiltLib}``."""
    loaders = {"walk_rf": load_walk_rf, "walk_ee": load_walk_ee,
               "walk_seg": load_walk_seg}
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        futures = {k: pool.submit(f) for k, f in loaders.items()}
        return {k: f.result() for k, f in futures.items()}


def build_walk_host(out_root: Path) -> BuiltLib:
    """Build the host (g++) twin of the walk kernels' step machine into
    ``out_root`` and load it: ``walk_rf_host``, ``walk_ee_host`` (both
    with a theta block T) and ``walk_seg_host``, the packed-count, vote
    and integrand checks
    (``wg_*``, ``ws_f_*_host``), and the two-product
    (``ws_two_prod_host``, ``ws_fma_product``). Used by the CPU tests
    only."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    built = build_library("walk_host", gxx, HOST_FLAGS,
                          [CSRC / "walk_host.cpp"], DEVICE_HEADERS, out_root)
    lib = built.lib
    _sig(lib.walk_rf_host, [_P, _I, _I, _I, _I, _F, _I, _I, _I, _I])
    _sig(lib.walk_ee_host, [_P, _I, _I, _I, _F, _I, _I, _I])
    _sig(lib.walk_seg_host, [_P, _I, _I, _I, _F, _I])
    _sig(lib.wg_limits, [_P], None)
    _sig(lib.wg_packed_fits, [_I])
    _sig(lib.wg_pack_sum, [ctypes.c_uint64, _I, _P, _P, _P], None)
    _sig(lib.wg_group_any_host, [_P, _I, _I, _I, ctypes.c_uint32, _P])
    _sig(lib.ws_f_ds_host, [_I, _I, _I, _P, _P, _F, _F, _P, _P])
    _sig(lib.ws_f_sc_host, [_I, _I, _I, _P, _F, _P])
    _sig(lib.ws_two_prod_host, [_I, _I, _P, _P, _P, _P], None)
    _sig(lib.ws_fma_product, [_I])
    return built
