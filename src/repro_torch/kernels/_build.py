"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface (route (b) of the port's kernel rules:
no PyTorch headers, so a build takes seconds) and loaded with ``ctypes``.
The build happens at first use, into ``kernels/_build/`` (listed in
``.gitignore``), under a name that carries a digest of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every entry point, by library (= source stem)
SIGNATURES = {
    "fused_rbf": {
        # x, y, V, rs, cs, out, n, m, d, b, inv2s2, stream
        "fused_rbf_matmat": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
        # x, y, V, cs, cv, out, deg, m, n, d, b, inv2s2, stream
        "fused_nystrom_matmat": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _F, _P),
    },
    "kmeans_assign": {
        # points, centers, idx, dist, n, k, d, stream
        "kmeans_assign": (_P, _P, _P, _P, _I, _I, _I, _P),
    },
    "rbf_similarity": {
        # x, y, out, n, m, d, inv2s2, stream
        "rbf_similarity": (_P, _P, _P, _I, _I, _I, _F, _P),
    },
    "block_matmat": {
        # A, V, out, n, m, b, stream
        "block_matmat": (_P, _P, _P, _I, _I, _I, _P),
    },
    "flash_attention": {
        # q, k, v, o, B, H, KV, S, T, hd, dtype, scale, causal, window,
        # stream
        "flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                            _I, _I, _P),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default location, else ``nvcc`` on the PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every named source (default: all) that has no current
    library yet, one ``nvcc`` process each, all started together.  Returns
    the library path of each name; raises with the compiler's output if
    any build fails.  The compiler's register/shared-memory report
    (``-Xptxas -v``) is kept beside each library as ``<library>.log``."""
    names = list(SIGNATURES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    compiler = nvcc() if todo else None
    procs = {}
    for name, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        p = paths[name]
        Path(f"{p}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, p)      # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(code: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error (a ``cudaError_t``
    value: 1 invalid value, 9 invalid configuration, ...)."""
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with "
                           f"cudaError_t {code}")
