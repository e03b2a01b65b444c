"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` process (all
started together) for `sm_90a`, and the objects are linked into one
shared library with a plain C interface.  The library goes to
`repro_torch/_build/`, named by a hash of the flags, the sources and the
headers they share (`csrc/*.cuh`), so an edited source or header is
rebuilt and an unchanged tree is loaded as it is.  The
build happens at the first launch of any kernel, never at import, and a
failed build raises.

Each C entry point launches on the stream it is given, does not
synchronize, and returns `cudaGetLastError()`; `check` turns a
non-zero code into a `RuntimeError`.  Pointers and the stream cross
ctypes as `c_void_p` (an `int` argument would be cut to 32 bits).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["SRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "library_path", "build",
           "function", "check", "events", "PTR", "INT", "LONG"]

PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Kernel-library builds (nvcc runs) and loads in this process: the
# runtime's recompile audit (`serving.runtime.telemetry.jit_cache_size`)
# reads their sum, which stays constant once the first launch is past.
events = {"builds": 0, "loads": 0}
_functions: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc at first use")


def _digest(files: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the build of the current csrc/ tree goes: named by a hash of
    the flags, the sources and the headers."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    tree = sorted([*sources, *SRC_DIR.glob("*.cuh")])
    return BUILD_DIR / f"libreprotorch_{_digest(tree)}.so"


def build() -> Path:
    """Compile csrc/*.cu into one shared library unless a build of the
    same sources and headers exists; returns its path.  The nvcc output
    (with `-Xptxas -v`: registers, shared memory and spills of each
    kernel) is kept beside it as `<library>.log`."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    sources = sorted(SRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [src.name for src, p in zip(sources, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-Xcompiler", "-fPIC", *map(str, objs),
             "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        Path(str(lib_path) + ".log").write_text(
            "\n".join(logs) + link.stdout)
        os.replace(tmp_lib, lib_path)      # atomic if processes build at once
    events["builds"] += 1
    return lib_path


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.repro_cuda_error_string.argtypes = [INT]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
            events["loads"] += 1
    return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry `name` of the kernel library, with its argument
    types declared and `int` (a cudaError_t) as its result."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(_library(), name)
        fn.argtypes = argtypes
        fn.restype = INT
        _functions[name] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err:
        msg = _library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
