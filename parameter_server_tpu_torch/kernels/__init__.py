"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface and bound with ``ctypes`` (no PyTorch
headers, so a build takes seconds). All sources compile in parallel,
one ``nvcc`` process each, at the first CUDA call, never at import.
Libraries go to ``build/torch_kernels/`` at the repository root, named
by a hash of the sources and flags, so a changed source is rebuilt and
an unchanged one is reused.

``--fmad=false`` keeps multiplies and adds uncontracted, so each kernel
rounds exactly as its plain PyTorch version does (see
``csrc/ftrl_common.cuh``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-O3",
    "-gencode=arch=compute_90a,code=sm_90a",
    "--fmad=false",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_P, _I, _LL, _F, _U = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
    ctypes.c_uint,
)
# library name -> (C function, argtypes)
_SIGNATURES = {
    "ftrl_dense": (
        "ftrl_dense_launch",
        [_P, _P, _I, _P, _P, _LL, _F, _F, _F, _F, _I, _U, _P],
    ),
    "ftrl_sparse": (
        "ftrl_sparse_launch",
        [_P, _P, _I, _P, _P, _P, _LL, _F, _F, _F, _F, _I, _U, _P],
    ),
    "quantize": ("quantize_launch", [_P, _P, _P, _P, _I, _LL, _U, _P]),
}

_lock = threading.Lock()
_libs: "dict[str, ctypes.CDLL]" = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> "dict[str, pathlib.Path]":
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all at once; raise with the compiler's output if one
    fails. Returns name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in _SIGNATURES}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with its C signature declared; builds
    every kernel on first use."""
    with _lock:
        if not _libs:
            for lib_name, path in build_all().items():
                fn_name, argtypes = _SIGNATURES[lib_name]
                lib = ctypes.CDLL(str(path))
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _libs[lib_name] = lib
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
