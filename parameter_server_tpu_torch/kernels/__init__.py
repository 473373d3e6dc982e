"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface and bound with ``ctypes`` (no PyTorch
headers, so a build takes seconds). All sources compile in parallel,
one ``nvcc`` process each, at the first CUDA call, never at import.
Libraries go to ``build/torch_kernels/`` at the repository root, named
by a hash of the sources and flags, so a changed source is rebuilt and
an unchanged one is reused.

``--fmad=false`` keeps multiplies and adds uncontracted, so the FTRL and
quantize kernels round exactly as their plain PyTorch versions do (see
``csrc/ftrl_common.cuh``). ``flash_fwd`` sums in another order than its
plain version in any case and is held to it within a tolerance, so it
is built with contraction on.
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
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]
_BIT_EXACT = ["--fmad=false"]

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
    "flash_fwd": (
        "flash_fwd_launch",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    ),
}
# library name -> flags beside NVCC_FLAGS
_FLAGS = {"ftrl_dense": _BIT_EXACT, "ftrl_sparse": _BIT_EXACT, "quantize": _BIT_EXACT,
          "flash_fwd": []}

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


def _flags(name: str, defines=()) -> "list[str]":
    return NVCC_FLAGS + _FLAGS[name] + [f"-D{d}" for d in defines]


def _lib_path(name: str, defines=()) -> pathlib.Path:
    h = hashlib.sha256(" ".join(_flags(name, defines)).encode())
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    tag = "".join(f"-{d.lower()}" for d in defines)
    return BUILD_DIR / f"{name}{tag}-{h.hexdigest()[:12]}.so"


def _build(jobs) -> None:
    """Compile each (name, defines, path) whose library is missing, one
    ``nvcc`` per source, all at once; raise with the compiler's output if
    one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, defines, path in jobs:
        if path.exists():
            continue
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *_flags(name, defines), "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs.append((name, path, tmp,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build_all() -> "dict[str, pathlib.Path]":
    """Compile every kernel library that is not built yet, all at once.
    Returns name -> library path."""
    paths = {name: _lib_path(name) for name in _SIGNATURES}
    _build([(name, (), path) for name, path in paths.items()])
    return paths


def _load(name: str, path: pathlib.Path) -> ctypes.CDLL:
    fn_name, argtypes = _SIGNATURES[name]
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with its C signature declared; builds
    every kernel on first use."""
    with _lock:
        if not _libs:
            for lib_name, path in build_all().items():
                _libs[lib_name] = _load(lib_name, path)
        return _libs[name]


def variant(name: str, *defines: str) -> ctypes.CDLL:
    """Library ``name`` built with the extra macros ``defines`` (a
    diagnostic build, such as ``flash_fwd`` with ``FLASH_FWD_RACE_PROBE``),
    its launch function declared as in the normal build. Nothing on the
    port's paths loads one."""
    path = _lib_path(name, defines)
    with _lock:
        _build([(name, defines, path)])
    return _load(name, path)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
