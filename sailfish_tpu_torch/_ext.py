"""Build and load the port's CUDA kernels.

The sources under `csrc/` have a plain C interface; `nvcc` compiles them
into one shared library that is loaded with ctypes (no PyTorch headers,
so a build takes seconds, and no `ninja` is needed).  The library lands
in `_build/<key>/`, where the key hashes the sources, the nvcc version
and the flags, so an edited source or another toolkit rebuilds.  The
build happens at first use, never at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "mmp_scan.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int


@dataclasses.dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float          # 0.0 when an existing build was reused
    build_log: str                # nvcc / ptxas output of the build

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.lib.sf_cuda_error_string(err).decode()
            raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


_LOADED: KernelLibrary | None = None


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or CUDA_HOME/bin); the CUDA kernels "
            "are compiled from csrc/ at first use")
    return nvcc


def nvcc_version(nvcc: str | None = None) -> str:
    out = subprocess.run([nvcc or find_nvcc(), "--version"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[-1] if out.strip() else ""


def _build(nvcc: str, out: Path) -> tuple[float, str]:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.time() - t0
    log = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{log}")
    os.replace(tmp, out)
    (out.parent / "build.log").write_text(log + "\n")
    return dt, log


def _bind(lib: ctypes.CDLL) -> None:
    lib.sf_mmp_scan.argtypes = [
        _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I,
        _P, _P, _P, _P, _I, _P,
    ]
    lib.sf_mmp_scan.restype = _I
    lib.sf_cuda_error_string.argtypes = [_I]
    lib.sf_cuda_error_string.restype = ctypes.c_char_p


def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises when nvcc or
    the build fails — callers never fall back to another path."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    nvcc = find_nvcc()
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(nvcc_version(nvcc).encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / h.hexdigest()[:16] / "libsf_kernels.so"
    seconds, log = 0.0, ""
    if out.exists():
        log_file = out.parent / "build.log"
        log = log_file.read_text() if log_file.exists() else ""
    else:
        seconds, log = _build(nvcc, out)
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    _LOADED = KernelLibrary(lib=lib, path=out, build_seconds=seconds,
                            build_log=log)
    return _LOADED
