"""The yardstick's arithmetic: percentiles and rates over all requests, the
reduction of a device trace to busy time, kernel time and idle gaps, and
the bytes the database scan has to move, counted from a configuration.

Nothing here imports the program; tests run it on fixed inputs.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM, data sheet


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q <= 100) of all values, by linear
    interpolation between closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: int, seconds: float) -> float:
    """Work completed per second of a whole window."""
    if seconds <= 0:
        raise ValueError("empty window")
    return count / seconds


def merge(spans) -> list:
    """Sorted, disjoint (start, end) intervals covering the given ones."""
    out: list = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(s) for s in out]


def clip(spans, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi]


def busy(spans) -> float:
    """The time covered by at least one span."""
    return sum(e - s for s, e in merge(spans))


def gaps(spans, lo: float, hi: float) -> list:
    """(start, end) of the stretches of [lo, hi] that no span covers."""
    out = []
    cursor = lo
    for s, e in merge(clip(spans, lo, hi)):
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        out.append((cursor, hi))
    return out


def label_gaps(idle, host_events, prefix: str) -> dict:
    """Idle seconds summed by what the host was doing at each gap's middle:
    the benchmark's own span open then (a name starting with `prefix`),
    else the innermost host event open then, else "host: Python, no op recorded".
    host_events: (name, start, end) in the gaps' clock, seconds."""
    events = sorted(host_events, key=lambda ev: ev[1])
    active: "tuple[list, list]" = ([], [])  # open events: ours, the rest
    out: dict = defaultdict(float)
    j = 0
    for mid, length in sorted(((s + e) / 2, e - s) for s, e in idle):
        while j < len(events) and events[j][1] <= mid:
            active[not events[j][0].startswith(prefix)].append(events[j])
            j += 1
        label = None
        for k, tag in ((0, ""), (1, "host: ")):
            active[k][:] = [ev for ev in active[k] if ev[2] > mid]
            if label is None and active[k]:
                label = tag + max(active[k], key=lambda ev: ev[1])[0]
        out[label or "host: Python, no op recorded"] += length
    return dict(out)


def kernel_layers(kernel_files: dict) -> list:
    """[(compiled pattern, layer)] from the kernel-name files' contents."""
    return [(re.compile(r"(?<![A-Za-z0-9_])" + re.escape(spec["kernel"]) + r"(?![A-Za-z0-9_])"),
             spec["layer"]) for spec in kernel_files.values()]


def layer_of(name: str, layers) -> "str | None":
    for pattern, layer in layers:
        if pattern.search(name):
            return layer
    return None


def bytes_per_coefficient(ct_moduli) -> float:
    """Bytes of one coefficient across the ciphertext limbs, each at its
    modulus's own bit width."""
    return sum(int(q).bit_length() for q in ct_moduli) / 8


def scan_bytes(cfg: dict, params, queries: int) -> float:
    """The bytes the database scan of one request of `queries` queries has
    to move: the database's plaintexts in NTT form, read once; for every
    query each dimension's selection vector read once and its output
    ciphertexts written once; and in decomposition mode each upper
    dimension's operand, the digit plaintexts of the level below (2 * ER a
    ciphertext), read once.  In ciphertext-multiplication mode the upper
    dimensions are ciphertext products, which are no scan, so only the
    first dimension counts.  `params` gives the derived shape (dimensions,
    plaintexts, digits a limb)."""
    n = int(cfg["poly_modulus_degree"])
    dims = list(params.dimensions)
    d = len(dims)
    word = n * bytes_per_coefficient(params.ct_moduli)  # one polynomial, every limb
    total = params.num_pt * word
    inner_out = math.prod(dims[:-1])
    total += queries * (dims[-1] * 2 + inner_out * 2) * word
    if params.ct_mult:
        return total
    er2 = 2 * params.expansion_ratio()
    cts = inner_out
    for j in range(1, d):
        dim = dims[d - 1 - j]
        rows = cts * er2
        out = rows // dim
        total += queries * (rows + dim * 2 + out * 2) * word
        cts = out
    return total
