"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``pir_tpu_torch/csrc/`` with a
plain C interface.  At its first use in a process it is compiled with
``nvcc`` for ``sm_90a`` into ``pir_tpu_torch/_build/`` (the file name carries
a hash of the source and the flags, so an edited source is rebuilt) and
loaded with ``ctypes``.  A failed build raises.  Nothing is built when a
module is imported, so the CPU tests import every module freely.

Every C entry point launches on the stream it is handed and returns
``cudaGetLastError()``; :meth:`CudaKernel.launch` raises when that is not 0
and otherwise adds one to the kernel's ``launches`` count and to the count
of the variant it launched (``entry_point.variant``, e.g. ``pir_scan.u32``,
``pir_scan.hi.dyn`` for the runtime-moduli entry of a limb-sharded mesh, or
``pir_ntt.grow`` / ``pir_ntt.reduce`` for kernel A's two butterflies)
— the counts a run reads to show that its main path went through each
kernel and each of its variants.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the default toolkit location."""
    home = os.environ.get("CUDA_HOME")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


class CudaKernel:
    """One csrc/ source, its C entry points and a launch counter."""

    def __init__(self, name: str, source: str, entry_points: dict):
        self.name = name
        self.source = CSRC / source
        self._entry_points = entry_points  # C function -> argtypes
        self.launches = 0
        self.variant_launches: "dict[str, int]" = {}
        self.build_seconds: "float | None" = None
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()
        REGISTRY[name] = self

    def library_path(self) -> pathlib.Path:
        h = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        digest = h.hexdigest()[:16]
        return BUILD / f"lib{self.source.stem}-{digest}.so"

    def lib(self):
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def _load(self):
        so = self.library_path()
        t0 = time.perf_counter()
        if not so.exists():
            BUILD.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {self.source.name} "
                    f"(exit {proc.returncode}):\n{proc.stderr}"
                )
            self.build_log = proc.stderr
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for fn_name, argtypes in self._entry_points.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = _I32
        lib.cuda_error_string.argtypes = [_I32]
        lib.cuda_error_string.restype = ctypes.c_char_p
        self.build_seconds = time.perf_counter() - t0
        return lib

    def launch(self, fn_name: str, *args, variant: "str | None" = None) -> None:
        lib = self.lib()
        rc = getattr(lib, fn_name)(*args)
        if rc != 0:
            msg = lib.cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} ({rc})")
        self.launches += 1
        key = fn_name if variant is None else f"{fn_name}.{variant}"
        self.variant_launches[key] = self.variant_launches.get(key, 0) + 1


REGISTRY: "dict[str, CudaKernel]" = {}


def reset_launch_counts() -> None:
    for k in REGISTRY.values():
        k.launches = 0
        k.variant_launches.clear()


def launch_counts() -> "dict[str, int]":
    """Launches per kernel (per source)."""
    return {name: k.launches for name, k in REGISTRY.items()}


def variant_launch_counts() -> "dict[str, int]":
    """Launches per entry point and variant, e.g. ``pir_scan.hi``."""
    return {v: c for k in REGISTRY.values() for v, c in k.variant_launches.items()}


def stream_handle(t) -> int:
    """The current CUDA stream of tensor t's device, as a pointer int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


# in, out, scratch, batch, limbs, log_n, inverse, radix_bits, polys_per_block,
# blocks, top_bits, top_threads, top_blocks, grow, tw, tw_shoup, consts,
# n_inv, n_inv_shoup, stream
NTT_ARGS = [_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _I64, _I32, _I32, _I64, _I32,
            _P, _P, _P, _P, _P, _P]
NTT = CudaKernel("ntt", "ntt.cu", {"pir_ntt": NTT_ARGS})
# sv, db_hi, db_lo, consts, out, hi_bytes, P, S, L, d_total, j_begin, D, N, stream
_SCAN_ARGS = [_P, _P, _P, _P, _P, _I32, _I64, _I32, _I32, _I64, _I64, _I64, _I64, _P]
# kernel B's: the same, then prefix_groups, row_splits, prefix_tiles,
# coeff_tiles before the stream
SCAN = CudaKernel("scan", "scan.cu", {"pir_scan": _SCAN_ARGS[:-1] + [_I32] * 4 + [_P]})
SCAN_WIDE = CudaKernel("scan_wide", "scan_wide.cu", {"pir_scan_wide": _SCAN_ARGS})
# sv, db, db_shoup, consts, out, P, D, L, N, chunk, stream
SCAN_SHOUP = CudaKernel(
    "scan_shoup", "scan_shoup.cu",
    {"pir_scan_shoup": [_P, _P, _P, _P, _P, _I64, _I64, _I32, _I64, _I64, _P]},
)
