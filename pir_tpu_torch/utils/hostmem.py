"""Large transient host buffers in glibc's heap instead of fresh mappings.

glibc serves an allocation above its mmap threshold with a new ``mmap`` and
unmaps it when it is freed.  The threshold follows freed chunks upward only
as far as ``DEFAULT_MMAP_THRESHOLD_MAX`` (32 MiB on 64-bit), and
``M_MMAP_THRESHOLD`` refuses any value above that, so every larger buffer
arrives as zero pages faulted in one by one, each time it is made.  A
Request whose key blob is larger (ciphertext-multiplication mode from
N=8192, every mode from N=16384) makes two such buffers a request: the
parse's arena block and the ``bytes`` a blob field's read returns.

:func:`keep_large_buffers` stops glibc from mapping large chunks and raises
its trim threshold, so those buffers reuse heap pages the process has
already touched.  The server calls it once it has loaded a key set with a
blob above :data:`MMAP_CEILING`.  It only ever widens what the heap keeps,
and acts on glibc's main arena: a thread that allocates from an arena of
its own (64 MiB heaps) still maps any chunk too large for one.
"""

from __future__ import annotations

import ctypes
import threading

try:
    import resource
except ImportError:  # not a Unix
    resource = None

MMAP_CEILING = 32 << 20  # glibc's DEFAULT_MMAP_THRESHOLD_MAX on 64-bit
_M_TRIM_THRESHOLD = -1
_M_MMAP_MAX = -4
_INT_MAX = 2**31 - 1  # mallopt takes its value as an int
_NO_TRIM = 2**64 - 1  # glibc's threshold after mallopt(M_TRIM_THRESHOLD, -1)

_lock = threading.Lock()
_kept = 0  # the trim threshold this module set; 0 while not engaged


def _glibc():
    """The process's C library if it is glibc (has ``gnu_get_libc_version``
    and ``mallopt``), else None."""
    try:
        libc = ctypes.CDLL(None)
    except (OSError, TypeError):
        return None
    if not (hasattr(libc, "gnu_get_libc_version") and hasattr(libc, "mallopt")):
        return None
    libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    libc.mallopt.restype = ctypes.c_int
    return libc


def keep_large_buffers(nbytes: int) -> bool:
    """Serve large chunks from the heap and keep at least 4 × `nbytes` of
    freed heap mapped (about two parsed Requests and a field's copy of a
    key set that size are alive at once).  Past mallopt's int the heap is
    never trimmed (-1), so it keeps what it once held at its peak.  Never
    lowers a threshold set before.  Returns whether the policy is engaged:
    False off glibc, or where mallopt refuses."""
    global _kept
    with _lock:
        libc = _glibc()
        if libc is None:
            return False
        if not _kept and not libc.mallopt(_M_MMAP_MAX, 0):
            return False
        want = 4 * nbytes
        if want > _INT_MAX:
            want = _NO_TRIM
        if want > _kept:
            if not libc.mallopt(_M_TRIM_THRESHOLD, -1 if want == _NO_TRIM else want):
                return bool(_kept)
            _kept = want
        return True


def kept_bytes() -> int:
    """The trim threshold :func:`keep_large_buffers` set (2^64 - 1 where
    trimming is off), or 0 where the policy is not engaged."""
    return _kept


def thread_minor_faults() -> "int | None":
    """Minor page faults of the calling thread so far
    (``getrusage(RUSAGE_THREAD)``), or None where that is not available:
    no ``RUSAGE_THREAD``, or a kernel that counts no faults at all (the
    whole process reads 0, which a running interpreter never has; some
    kernels that emulate Linux count none)."""
    who = getattr(resource, "RUSAGE_THREAD", None)
    if who is None or not resource.getrusage(resource.RUSAGE_SELF).ru_minflt:
        return None
    return resource.getrusage(who).ru_minflt
