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
``pir_ntt.grow`` / ``pir_ntt.reduce`` for kernel A's two butterflies; a
kernel may count an entry point under a name of its own, e.g. kernel E's
``pir_ks.inner`` or kernel F's ``pir_upper.contract``) — the counts a run
reads to show that its main path went through each kernel and each of its
variants.  A CUDA graph's capture records its launches instead of counting
them (:func:`recorded_launches`), and each replay counts them
(:func:`add_launches`), so the counts stay those of the kernels that ran.
"""

from __future__ import annotations

import contextlib
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

    def __init__(self, name: str, source: str, entry_points: dict, counted_as=None):
        self.name = name
        self.source = CSRC / source
        self._entry_points = entry_points  # C function -> argtypes
        self._counted_as = counted_as or {}  # C function -> its name in the counts
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
        base = self._counted_as.get(fn_name, fn_name)
        key = base if variant is None else f"{base}.{variant}"
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


@contextlib.contextmanager
def recorded_launches():
    """Launches made inside are recorded, not counted: a CUDA graph's
    capture, whose kernels run only when the graph is replayed.  Yields a
    dict that holds them on exit, {kernel: (launches, {variant: count})},
    for :func:`add_launches` to count at each replay."""
    before = {name: (k.launches, dict(k.variant_launches)) for name, k in REGISTRY.items()}
    recorded: dict = {}
    try:
        yield recorded
    finally:
        for name, k in REGISTRY.items():
            launches, variants = before.get(name, (0, {}))
            made = {v: c - variants.get(v, 0) for v, c in k.variant_launches.items()
                    if c != variants.get(v, 0)}
            if made:
                recorded[name] = (k.launches - launches, made)
            k.launches = launches
            k.variant_launches.clear()
            k.variant_launches.update(variants)


def add_launches(recorded: dict) -> None:
    """Count the launches :func:`recorded_launches` recorded, once."""
    for name, (launches, variants) in recorded.items():
        k = REGISTRY[name]
        k.launches += launches
        for v, c in variants.items():
            k.variant_launches[v] = k.variant_launches.get(v, 0) + c


def require_cuda(x, name: str, kernel: str) -> None:
    """Raise unless x is an int64 CUDA tensor (the operands of kernel
    `kernel`'s entries)."""
    import torch

    if not x.is_cuda or x.dtype != torch.int64:
        raise ValueError(f"kernel {kernel} needs int64 CUDA tensors; {name} is {x.dtype} "
                         f"on {x.device}")


def stream_handle(t) -> int:
    """The current CUDA stream of tensor t's device, as a pointer int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


# in, out, batch, limbs, log_n, inverse, radix_bits, polys_per_block, blocks,
# cluster_ctas, grow, tw, tw_shoup, consts, n_inv, n_inv_shoup, stream
NTT_ARGS = [_P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _I64, _I32, _I32, _P, _P, _P, _P, _P, _P]
# log_n, inverse, grow, int* clusters: how many of a split ring's clusters
# the card holds at once
NTT = CudaKernel("ntt", "ntt.cu", {"pir_ntt": NTT_ARGS, "pir_ntt_max_active_clusters":
                                   [_I32, _I32, _I32, ctypes.POINTER(_I32)]})
# sv, db_hi, db_lo, consts, out, hi_bytes, P, S, L, d_total, j_begin, D, N, stream
_SCAN_ARGS = [_P, _P, _P, _P, _P, _I32, _I64, _I32, _I32, _I64, _I64, _I64, _I64, _P]
# kernel B's: the same, then prefix_groups, row_splits, prefix_tiles,
# coeff_tiles before the stream
SCAN = CudaKernel("scan", "scan.cu", {"pir_scan": _SCAN_ARGS[:-1] + [_I32] * 4 + [_P]})
# kernel C's: the same, then prefixes, columns, rows, stages, shared_bytes
# and the grid's three dimensions before the stream
SCAN_WIDE = CudaKernel("scan_wide", "scan_wide.cu",
                       {"pir_scan_wide": _SCAN_ARGS[:-1] + [_I32] * 8 + [_P]})
# sv, db, db_shoup, consts, out, P, D, L, N, chunk, stream
SCAN_SHOUP = CudaKernel(
    "scan_shoup", "scan_shoup.cu",
    {"pir_scan_shoup": [_P, _P, _P, _P, _P, _I64, _I64, _I32, _I64, _I64, _P]},
)
# The exact wide contraction of csrc/contract.cuh behind E2 and F2: x, w,
# moduli, out, R, I, J, N, chunk, then ops/scan_kernel.py::contract_plan's
# path, rows, terms, coeff_warps, splits, stages, shared_bytes and grid, and
# the stream
CONTRACT_ARGS = [_P, _P, _P, _P, _I64, _I32, _I32, _I64, _I64] + [_I32] * 7 + [_I64, _I32, _P]
# kernel E, the key switch and the expansion's combine step:
# in, in_row_stride, src, flip, q_in, qp, out, R, L, Lp, N, stream
# E2: CONTRACT_ARGS (digits, key, qp, out, R, L, Lp, N, chunk, ...)
# acc, lq, p_half_mod_q, p_inv, p_inv_shoup, add0, add1, add_row_stride, src, flip,
#   out, R, L, Lp, offset, N, P, p_half, stream
# cts, sub, lq, out, Q, B, polys, L, N, shift_a, shift_b, stream
KEYSWITCH = CudaKernel(
    "keyswitch", "keyswitch.cu",
    {"pir_ks_decompose": [_P, _I64, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I64, _P],
     "pir_ks_inner": CONTRACT_ARGS,
     "pir_ks_moddown": [_P] * 7 + [_I64, _P, _P, _P, _I64, _I32, _I32, _I32, _I64, _I64, _I64, _P],
     "pir_expand_combine": [_P] * 4 + [_I64, _I64, _I32, _I32, _I64, _I64, _I64, _P]},
    counted_as={"pir_ks_decompose": "pir_ks.decompose", "pir_ks_inner": "pir_ks.inner",
                "pir_ks_moddown": "pir_ks.moddown", "pir_expand_combine": "pir_ks.combine"},
)
# kernel F, the decomposition-mode scan's upper levels and the reply's mod
# switch:
# in, cols, out, lead_prefix, dim, C, L, N, c0, k, er2, stream
# F2: CONTRACT_ARGS (items, sv, lq, out, P, D, L, N, chunk, ...), D as int64
# in, consts, out, R, cur, keep, N, stream
# items, lo, hi, hi_bytes, P, D, L, N, stream
UPPER = CudaKernel(
    "upper", "upper.cu",
    {"pir_digits_lift": [_P, _P, _P, _I64, _I64, _I64, _I32, _I64, _I64, _I64, _I64, _P],
     "pir_contract": CONTRACT_ARGS[:5] + [_I64] + CONTRACT_ARGS[6:],
     "pir_mod_switch": [_P, _P, _P, _I64, _I32, _I32, _I64, _P],
     "pir_split_planes": [_P, _P, _P, _I32, _I64, _I64, _I32, _I64, _P]},
    counted_as={"pir_digits_lift": "pir_upper.lift", "pir_contract": "pir_upper.contract",
                "pir_mod_switch": "pir_upper.modswitch", "pir_split_planes": "pir_upper.split"},
)
# kernel G, the BEHZ multiply's RNS arithmetic (ciphertext-multiplication
# mode):
# in, in_row_stride, table, out, R, k, N, stream
# a_q, a_b, b_q, b_b, table, out_q, out_b, outer, inner, a_so, b_so, k, N, stream
# prod_q, prod_b, table, out, R, k, N, stream
BEHZ = CudaKernel(
    "behz", "behz.cu",
    {"pir_behz_lift": [_P, _I64, _P, _P, _I64, _I32, _I64, _P],
     "pir_behz_tensor": [_P] * 7 + [_I64] * 4 + [_I32, _I64, _P],
     "pir_behz_floor_sk": [_P] * 4 + [_I64, _I32, _I64, _P]},
    counted_as={"pir_behz_lift": "pir_behz.lift", "pir_behz_tensor": "pir_behz.tensor",
                "pir_behz_floor_sk": "pir_behz.floor_sk"},
)
