"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a
plain C interface under `build/karpenter_tpu_torch/` at the repository
root (listed in .gitignore), named by a digest of its source, so an edited
source rebuilds and an unchanged one loads the library already built. A
debug build (`load(name, defines)` with -D macros, such as the phase
stamps of -DTOURNAMENT_PROFILE) gets a library of its own. The
target is Hopper (`sm_90a`); the build never uses --use_fast_math and
forbids FMA contraction (`-fmad=false`), because the solve must agree bit
for bit with the reference's f32 expressions.

The host library of the native rung (`native/ffd.cpp`, the C++ group FFD
the reference's `ops/native.py` loads) is built the same way with g++ into
the same directory: the source under `native/` is only read, never
written beside.

Nothing here runs at import: tests on a machine without nvcc import every
module, and only a launch on a CUDA tensor reaches `load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "karpenter_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("screen_k", "solve_scan", "tournament")
NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "ffd.cpp"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return found


def _tag(name: str, defines: Sequence[str]) -> str:
    """The name of one build of a source: the source's own name, plus each
    -D macro of a debug build."""
    return name + "".join("+" + d[2:] for d in defines)


def _target(name: str, defines: Sequence[str] = ()) -> Path:
    flags = " ".join([*NVCC_FLAGS, *defines])
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + flags.encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{_tag(name, defines)}-{digest}.so"


def _start(name: str, defines: Sequence[str] = ()
           ) -> Optional[subprocess.Popen]:
    """Start nvcc for one source unless its library is already built."""
    out = _target(name, defines)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    tag = _tag(name, defines)
    log = open(BUILD_DIR / f"{tag}.log", "w")
    try:
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, *defines, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    proc.tmp, proc.out, proc.name = tmp, out, tag  # type: ignore[attr-defined]
    return proc


def _finish(proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    rc = proc.wait()
    if rc != 0:
        text = (BUILD_DIR / f"{proc.name}.log").read_text()
        raise RuntimeError(f"nvcc failed for {proc.name} (exit {rc}):\n"
                           f"{text}")
    os.replace(proc.tmp, proc.out)


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source at once (one nvcc each, all started together)
    and return {name: nvcc log}, which holds the -Xptxas -v resource
    report of each kernel."""
    procs = [_start(n) for n in names]
    for p in procs:
        _finish(p)
    logs = {}
    for n in names:
        log = BUILD_DIR / f"{n}.log"
        logs[n] = log.read_text() if log.exists() else ""
    return logs


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed;
    `defines` (-D macros) selects a debug build of the same source."""
    tag = _tag(name, defines)
    lib = _libs.get(tag)
    if lib is None:
        _finish(_start(name, defines))
        lib = ctypes.CDLL(str(_target(name, defines)))
        _libs[tag] = lib
    return lib


def load_native() -> ctypes.CDLL:
    """The native FFD library, built from `native/ffd.cpp` with g++ into
    BUILD_DIR if needed. Raises OSError / CalledProcessError when g++ or
    the source is missing."""
    lib = _libs.get("ffd")
    if lib is None:
        digest = hashlib.sha256(NATIVE_SRC.read_bytes()
                                + " ".join(GXX_FLAGS).encode()
                                ).hexdigest()[:12]
        out = BUILD_DIR / f"libffd-{digest}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                            str(NATIVE_SRC)],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _libs["ffd"] = lib
    return lib
