"""The native bulk encoder: ``encoder.cpp`` (a copy of ``pir_tpu``'s, held
equal by ``tests/test_torch_copies.py``) packs raw items into plaintext
coefficients in one pass, as ``pir_tpu``'s database ingest does.

At its first use in a process the source is compiled with ``g++ -O3
-shared -fPIC`` into ``pir_tpu_torch/_build/`` (the file name carries a hash
of the source and the flags, so an edited source is rebuilt) and loaded
with ``ctypes``.  A failed build raises with the compiler's output: there
is no numpy fallback (``pir/database.py::pack_items`` is the plain version
the tests hold this one to).  Nothing is built when the module is imported.

``encoder.cpp`` keeps the bit stream in a 64-bit accumulator, which before
taking a byte holds up to b - gcd(b, 8) bits: at 59, 61 and 62 bits a
coefficient it loses the top bits (``pir_tpu``'s copy gives wrong words
there).  :func:`pack_db` refuses those widths (:func:`exact`), and the
database packs them with ``pack_items``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import subprocess
import threading

import numpy as np

from pir_tpu_torch.kernels import BUILD

SOURCE = pathlib.Path(__file__).resolve().parent / "encoder.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def build(source: "pathlib.Path | None" = None,
          build_dir: "pathlib.Path | None" = None) -> pathlib.Path:
    """The shared library of `source` (SOURCE by default) in `build_dir`
    (BUILD), compiled with g++ if it is not there yet.  Raises RuntimeError
    with the compiler's output when the build fails."""
    source = SOURCE if source is None else source
    build_dir = BUILD if build_dir is None else build_dir
    digest = hashlib.sha256(source.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    so = build_dir / f"lib{source.stem}-{digest}.so"
    if not so.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(["g++", *GXX_FLAGS, str(source), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed to build {source.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.pack_db.restype = ctypes.c_int
            lib.pack_db.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
            _lib = lib
        return _lib


def exact(bits_per_coeff: int) -> bool:
    """Whether encoder.cpp packs this width exactly: its accumulator's
    b - gcd(b, 8) bits plus one byte fit 64 bits."""
    return 0 < bits_per_coeff and bits_per_coeff - math.gcd(bits_per_coeff, 8) + 8 <= 64


def available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _load() is not None


def pack_db(
    buffer: bytes, num_pt: int, bytes_per_pt: int, bits_per_coeff: int, n: int
) -> np.ndarray:
    """Pack a contiguous item buffer into u64[num_pt, n], MSB-first
    (``pack_items``' semantics).  Raises ValueError at a width that
    :func:`exact` refuses."""
    lib = _load()
    if 0 < bits_per_coeff <= 62 and not exact(bits_per_coeff):
        raise ValueError(f"encoder.cpp's accumulator cannot pack {bits_per_coeff} bits a "
                         "coefficient exactly; use pack_items")
    if len(buffer) != num_pt * bytes_per_pt:
        raise ValueError("buffer size does not match num_pt * bytes_per_pt")
    src = np.frombuffer(buffer, dtype=np.uint8)
    out = np.zeros((num_pt, n), dtype=np.uint64)
    rc = lib.pack_db(src.ctypes.data, num_pt, bytes_per_pt, bits_per_coeff, n, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"native pack_db failed with code {rc}")
    return out
