"""Build and load the port's native code: the CUDA kernels and the host
helpers.

The sources under `csrc/` have a plain C interface; they are compiled
into shared libraries that are loaded with ctypes (no PyTorch headers,
so a build takes seconds, and no `ninja` is needed).  `nvcc` compiles
the kernels (`csrc/*.cu`, one process per source, all started together,
then one link); `g++` compiles the host helpers (`csrc/host/*.cpp`:
SA-IS suffix array construction and the FASTQ decoder).  A library lands
in `_build/<key>/`, where the key hashes the sources, the compiler's
version and the flags, so an edited source or another toolchain
rebuilds.  The host flags name no machine (`-march=native` is left out),
so a build directory may be shared between machines.  Builds happen at
first use, never at import.
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
SOURCES = (_PKG / "csrc" / "mmp_scan.cu", _PKG / "csrc" / "ubench.cu")
HOST_SOURCES = (_PKG / "csrc" / "host" / "sais.cpp",
                _PKG / "csrc" / "host" / "fastq_decode.cpp")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


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


def _version_line(compiler: str, which: int) -> str:
    out = subprocess.run([compiler, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[which] if out else ""


def nvcc_version(nvcc: str | None = None) -> str:
    return _version_line(nvcc or find_nvcc(), -1)


def _keyed_path(sources, version: str, flags, name: str) -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.read_bytes())
    h.update(version.encode())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / h.hexdigest()[:16] / name


def _compile(cmds: list[list[str]]) -> str:
    """Run the compiler commands together; returns their joined output
    and raises with it when one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0].strip() for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(cmd[0]).name} failed ({' '.join(cmd)}):\n{log}")
    return "\n".join(x for x in logs if x)


def _build(compiler: str, flags, sources, out: Path,
           link_flags=()) -> tuple[float, str]:
    """Objects in parallel (one compiler process per source), then one
    link; the library appears under its final name only when complete."""
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [str(Path(tmp) / (src.stem + ".o")) for src in sources]
        log = _compile([[compiler, *flags, "-c", "-o", obj, str(src)]
                        for src, obj in zip(sources, objs)])
        lib = str(Path(tmp) / out.name)
        link = _compile([[compiler, "-shared", "-o", lib, *objs,
                          *link_flags]])
        os.replace(lib, out)
    log = "\n".join(x for x in (log, link) if x)
    (out.parent / "build.log").write_text(log + "\n")
    return time.time() - t0, log


def _bind(lib: ctypes.CDLL) -> None:
    lib.sf_mmp_scan.argtypes = [
        _P, _P, _P, _I, _I, _P, _LL, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I,
        _P, _P, _P, _P, _P, _I, _P,
    ]
    lib.sf_mmp_scan.restype = _I
    lib.sf_ubench.argtypes = [
        _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _I,
        _P, _I, _P,
    ]
    lib.sf_ubench.restype = _I
    lib.sf_ubench_num_variants.argtypes = []
    lib.sf_ubench_num_variants.restype = _I
    lib.sf_cuda_error_string.argtypes = [_I]
    lib.sf_cuda_error_string.restype = ctypes.c_char_p


def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises when nvcc or
    the build fails — callers never fall back to another path."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    nvcc = find_nvcc()
    out = _keyed_path(SOURCES, nvcc_version(nvcc), NVCC_FLAGS,
                      "libsf_kernels.so")
    seconds, log = 0.0, ""
    if out.exists():
        log_file = out.parent / "build.log"
        log = log_file.read_text() if log_file.exists() else ""
    else:
        seconds, log = _build(nvcc, NVCC_FLAGS, SOURCES, out)
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    _LOADED = KernelLibrary(lib=lib, path=out, build_seconds=seconds,
                            build_log=log)
    return _LOADED


def host_library_path() -> Path:
    """Build (if needed) the host helper library with g++ (needs zlib)
    and return its path.  Raises when there is no g++ or the build
    fails; io/native.py turns that into the numpy fallbacks."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found; the host helpers are compiled "
                           "from csrc/host/ at first use")
    out = _keyed_path(HOST_SOURCES, _version_line(gxx, 0), GXX_FLAGS,
                      "libsf_host.so")
    if not out.exists():
        _build(gxx, GXX_FLAGS, HOST_SOURCES, out, link_flags=("-lz",))
    return out
