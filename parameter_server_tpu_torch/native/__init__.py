"""Build and load the port's native host library, ``psnative.cc``.

The library hashes feature keys into table slots and parses libsvm and
Criteo text (the reference's C++ data plane). It is built with ``g++ -O3
-fPIC -shared -std=c++17`` at the first call of :func:`library`, never at
import, into ``build/psnative/`` at the repository root, named by a hash
of the source and the flags: a changed source or flag builds a new
library, an unchanged one is reused. Builds are serialised by a file
lock (several test workers may build at once) and written under a
temporary name, then renamed into place.

A library that does not build raises with the compiler's output; there
is no quiet fallback to the NumPy or Python paths. ``ctypes`` releases
the GIL for each call, so parses run in parallel on threads.

Only the functions the port calls have their C signature declared here
(:data:`SIGNATURES`): the key hash, the two text parsers, ``ps_crc32c``
(the record files' checksum), the bit packers and the stream-wire encode
of the encoded wires, the LZ codec of the staging leg, and the count-min
sketch and key-heat folds.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

SOURCE = pathlib.Path(__file__).resolve().parent / "psnative.cc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "psnative"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_PARSE = ([ctypes.c_char_p, ctypes.c_int64, _f32p, _i64p, _u64p, _f32p, _i32p,
           ctypes.c_int64, ctypes.c_int64, _i64p], ctypes.c_int64)
# C function -> (argtypes, restype)
SIGNATURES = {
    "ps_hash_slots": ([_u64p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, _i32p], None),
    "ps_parse_libsvm": _PARSE,
    "ps_parse_criteo": _PARSE,
    "ps_crc32c": ([ctypes.c_char_p, ctypes.c_uint64], ctypes.c_uint32),
    # the encoded wires (utils/bitpack.py, learner/wire.py)
    "ps_pack_bits": ([_i32p, ctypes.c_uint64, ctypes.c_uint32, _u8p], None),
    "ps_hash_slots_packbits": ([_u64p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                                ctypes.c_uint32, _u8p], None),
    "ps_stream_encode": ([_u64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
                          ctypes.c_uint64, _u8p, ctypes.c_uint32, ctypes.c_uint32,
                          ctypes.c_int32, _i32p, _u8p, _u8p, _u8p], ctypes.c_int64),
    # the count-min sketch and the key heat (utils/sketch.py)
    "ps_cm_positions": ([_u64p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint64, _u32p], None),
    "ps_cm_insert": ([_u32p, _u32p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint64,
                      ctypes.c_uint32, _u32p], None),
    "ps_cm_query": ([_u32p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint64, _u32p, _u32p],
                    None),
    "ps_runs_u32": ([_u32p, ctypes.c_uint64, _u32p, _i64p], ctypes.c_uint64),
    "ps_add_by_range": ([_u32p, _i64p, ctypes.c_uint64, _i64p, ctypes.c_uint64, _f64p], None),
    # the LZ frame of utils/codec.py
    "ps_lz_max_compressed": ([ctypes.c_uint64], ctypes.c_uint64),
    "ps_lz_compress": ([_u8p, ctypes.c_uint64, _u8p, ctypes.c_uint64], ctypes.c_int64),
    "ps_lz_decompress": ([_u8p, ctypes.c_uint64, _u8p, ctypes.c_uint64], ctypes.c_int64),
}

_lock = threading.Lock()
_lib = None


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"psnative-{h.hexdigest()[:12]}.so"


def _build(path: pathlib.Path) -> None:
    """Compile the library to ``path`` unless another process has; raise
    with the compiler's output if it fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the native host library needs g++ to build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if out.returncode != 0:
            raise RuntimeError(f"native host library build failed: {cxx} exit "
                               f"{out.returncode}\n{out.stdout.decode(errors='replace')}")
        os.replace(tmp, path)


def library() -> ctypes.CDLL:
    """The loaded library with the main path's C signatures declared;
    built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib
