"""pir_tpu_torch.utils.hostmem: the allocator policy that keeps large
transient host buffers in glibc's heap.  The policy changes the whole
process's allocator, so its effect is measured in a subprocess; its logic is
checked here against a stand-in C library."""

import json
import subprocess
import sys

import pytest

from pir_tpu_torch.utils import hostmem

_CYCLES = r"""
import json, sys
from pir_tpu_torch.utils import hostmem
n = int(sys.argv[2])
engaged = hostmem.keep_large_buffers(n) if sys.argv[1] == "keep" else None
faults = []
for _ in range(11):
    before = hostmem.thread_minor_faults()
    buf = b"\x5a" * n  # malloc, then every byte written
    del buf
    faults.append(hostmem.thread_minor_faults() - before)
print(json.dumps({"engaged": engaged, "kept": hostmem.kept_bytes(), "faults": faults}))
"""


@pytest.mark.parametrize("keep", [True, False], ids=["kept", "mapped"])
def test_large_buffers_fault_once_when_kept(keep):
    """A 40 MiB bytes made and freed eleven times in the main thread: with
    the policy its pages are faulted in by the first cycle only (the next
    ten under 5% of the first's faults); without it, every cycle maps fresh
    zero pages and faults in about every page again."""
    if hostmem._glibc() is None or hostmem.thread_minor_faults() is None:
        pytest.skip("needs glibc and getrusage(RUSAGE_THREAD)")
    import resource

    n = 40 << 20
    out = subprocess.run([sys.executable, "-c", _CYCLES, "keep" if keep else "map", str(n)],
                         capture_output=True, text=True, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    pages = n // resource.getpagesize()
    faults = got["faults"]
    assert faults[0] >= 0.9 * pages
    if keep:
        assert got["engaged"] is True and got["kept"] == 4 * n
        assert sum(faults[1:]) < 0.05 * faults[0], faults
    else:
        assert got["kept"] == 0
        assert all(f >= 0.9 * pages for f in faults), faults


class _Libc:
    """Records mallopt calls; answers `ok`."""

    def __init__(self, ok=1):
        self.ok, self.calls = ok, []

    def mallopt(self, param, value):
        self.calls.append((param, value))
        return self.ok


@pytest.mark.parametrize(
    "libc,sizes,calls,kept,engaged",
    [(None, [40 << 20], [], 0, False),
     (_Libc(ok=0), [40 << 20], [(hostmem._M_MMAP_MAX, 0)], 0, False),
     (_Libc(), [40 << 20, 10 << 20, 50 << 20],
      [(hostmem._M_MMAP_MAX, 0), (hostmem._M_TRIM_THRESHOLD, 160 << 20),
       (hostmem._M_TRIM_THRESHOLD, 200 << 20)], 200 << 20, True),
     (_Libc(), [2 << 30, 40 << 20],
      [(hostmem._M_MMAP_MAX, 0), (hostmem._M_TRIM_THRESHOLD, -1)], 2**64 - 1, True)],
    ids=["not-glibc", "mallopt-refuses", "raises-only", "past-int-never-trims"],
)
def test_keep_large_buffers_policy(monkeypatch, libc, sizes, calls, kept, engaged):
    """M_MMAP_MAX set to 0 once; the trim threshold 4x the largest key set
    asked for, never lowered, and trimming off (-1) past mallopt's int;
    nothing engaged off glibc or where mallopt refuses."""
    monkeypatch.setattr(hostmem, "_glibc", lambda: libc)
    monkeypatch.setattr(hostmem, "_kept", 0)
    got = [hostmem.keep_large_buffers(n) for n in sizes]
    assert got == [engaged] * len(sizes)
    assert (libc.calls if libc else []) == calls
    assert hostmem.kept_bytes() == kept
