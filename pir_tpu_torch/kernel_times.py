"""Device times of kernels A (NTT), B (scan), C (wide scan), D
(Shoup-table scan), E (the key switch's entries E1-E4), F (the upper
level's and the mod switch's entries F1-F4) and G (the BEHZ multiply's
entries G1-G3) at the shapes one
request at the bench configuration
gives them (2^20 items of 288 B, d=2, N=4096, SEAL's chain; the tpu32
profile and one rank of the meshes for kernel B's other cases; a batched
request of 16 queries for kernel C), and at the rings above N=4096
(:func:`large_ring_shapes`, :func:`scan_cases`, :func:`wide_cases`,
:func:`shoup_cases`), and kernel A at every launch of a served request at
N=32768 in either mode (:func:`served_ntt_launches`), kernel E at
:func:`keyswitch_cases`, kernel F at :func:`upper_cases` and
:func:`modswitch_cases` and kernel G at :func:`behz_cases`, each checked
bit-equal to its plain version first.  ``chip_smoke.py`` makes its checks of
the seven kernels through :func:`time_ntt`, :func:`time_ntt_large`,
:func:`time_ntt_served`, :func:`time_scan`, :func:`time_wide`,
:func:`time_shoup`, :func:`time_keyswitch`, :func:`time_upper` and
:func:`time_behz`.

    python3 pir_tpu_torch/kernel_times.py --out chiprun_out/times.json
    python3 pir_tpu_torch/kernel_times.py --root build/parent --label parent

``--root`` imports ``pir_tpu_torch`` from another checkout with the same
entry points (a tree unpacked with ``git archive``), so that two designs are
timed by the same code on one card in one run.  Times come from CUDA events
around `reps` back-to-back launches queued behind ``torch.cuda._sleep``, so
they are the card's time, not the host's time to launch.  The last line of output is
the JSON result.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4  # 132 SMs x 64 INT32 lanes x 1.98 GHz
# 32-bit multiplies per Shoup product x w mod q: 4 for each 64-bit low
# product (x w, quotient q) and 8 for the quotient's 64-bit high product
MULS_SHOUP = 16
MULS_SHOUP_GROW = 12  # kernel A's growing butterflies: the quotient from 3 partial products
MULS_48BIT = 7   # per product with a hi plane (the three-word sum, modarith.cuh::mac96)
MULS_32BIT = 3   # without
# kernel E: a 64-bit product's low word 4, high word 8 (as above); a
# one-word Barrett reduction a high and a low product, a two-word one
# (modarith.cuh::barrett_reduce_128) three high and four low products
MULS_WIDE = 12  # E2's full 64 x 64 -> 128-bit product
MULS_BARRETT64 = 12
MULS_BARRETT128 = 40
POLY_DEGREE = 4096
PLAIN_BITS = 24
ITEMS, ITEM_BYTES, DIMS = 1 << 20, 288, 2  # the request the large rings' shapes come from
PLAIN_CHUNK_BYTES = 256 << 20  # the plain version compares this much input at a time


def ntt_request_shapes() -> "list[tuple[str, str, int, bool]]":
    """(label, chain, batch, inverse) of every kernel A launch of one
    single-query request: per expansion level j the key switch's NTT and
    INTT over QP on [2^(j+1), 3, N]; then the selection vector's NTT, the
    inner scan's INTT, the digit plaintexts' NTT and the upper scan's INTT
    over q."""
    shapes = []
    for j in range(9):
        for inverse in (False, True):
            shapes.append((f"expansion {j}", "qp", 2 ** (j + 1), inverse))
    shapes += [("selection vector", "q", 648, False), ("inner-scan INTT", "q", 324, True),
               ("digit plaintexts", "q", 1296, False), ("upper-scan INTT", "q", 16, True)]
    return shapes


def bound(nbytes: float, muls: float) -> dict:
    """The least time for the work on an H100 SXM, and which limit sets it."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = muls / IMAD_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def ntt_bound(x, n: int, limbs: int, grow: bool) -> dict:
    """Input read and output written once, both twiddle rows once;
    N/2 log2 N butterflies per polynomial limb, each one Shoup product —
    the growing butterflies' where the kernel runs them."""
    polys = x.numel() // n
    butterflies = polys * n // 2 * (n.bit_length() - 1)
    muls = MULS_SHOUP_GROW if grow else MULS_SHOUP
    return bound((2 * x.numel() + 2 * limbs * n) * 8, butterflies * muls)


def scan_bound(sv, hi, lo) -> dict:
    """sv [D, S, L, N] and the planes read once, [P, S, L, N] written once;
    one product per (prefix, row, column, limb, coefficient)."""
    P, L, D, N = lo.shape
    S = sv.shape[1]
    planes = (0 if hi is None else hi.numel() * hi.element_size()) + lo.numel() * 4
    muls = P * D * L * N * S * (MULS_32BIT if hi is None else MULS_48BIT)
    return bound(sv.numel() * 8 + planes + P * S * L * N * 8, muls)


def device_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` launches queued behind a
    device-side sleep, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * 1e-4 * reps))  # ~0.1 ms of launch time per rep
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    """max |a - b| of two int64 tensors of one shape (0 exactly when equal)."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a - b).abs().max().item()) if a.numel() else 0


def random_residues(moduli, shape_before, n, device, gen):
    """int64[*shape_before, L, n] uniform below each limb's modulus."""
    import torch

    cols = [torch.randint(0, int(q), (*shape_before, 1, n), generator=gen,
                          dtype=torch.int64, device=device) for q in moduli]
    return torch.cat(cols, dim=-2)


def encryption_params(profile: str = "seal", n: int = POLY_DEGREE):
    """SEAL's BFVDefault chain or tpu32's at ring n, with the bench's t."""
    from pir_tpu_torch.core.params import generate_encryption_params

    return generate_encryption_params(n, PLAIN_BITS, profile=profile)


def request_dims(ep, ct_mult: bool = False) -> "tuple[int, ...]":
    """The hypercube of the 2^20-item request under these parameters."""
    from pir_tpu_torch.core.params import create_pir_parameters

    return create_pir_parameters(ITEMS, ITEM_BYTES, DIMS, ep,
                                 use_ciphertext_multiplication=ct_mult).dimensions


def expansion_ratio(ep) -> int:
    """Digit plaintexts per ciphertext polynomial (ops.decompose's rule)."""
    bits = ep.plain_modulus.bit_length() - 1
    return sum(math.ceil(math.log2(q) / bits) for q in ep.ct_modulus)


def time_ntt(device, gen, plain=(), reps: int = 50) -> "list[dict]":
    """Kernel A at every request shape and at N=256 (K3's ring): bit-equal
    to plain and undone exactly by the opposite transform, then timed; the
    plain version is timed too at the (label, inverse) pairs in `plain`."""
    from pir_tpu_torch.core import primes
    from pir_tpu_torch.ops.ntt import NttTables, grows, ntt_cuda, ntt_plain

    chain = encryption_params().coeff_modulus
    tables = {"qp": NttTables(chain, POLY_DEGREE, device)}
    tables["q"] = tables["qp"].slice(2)
    tables["small"] = NttTables(primes.coeff_modulus_from_bits(256, [34, 36, 37]), 256, device)
    shapes = ntt_request_shapes() + [("N=256", "small", 64, False), ("N=256", "small", 64, True)]
    rows = []
    for label, chain_name, batch, inverse in shapes:
        t = tables[chain_name]
        x = random_residues(t.moduli, (batch,), t.n, device, gen)
        got = ntt_cuda(t, x, inverse)
        err = max_abs_err(got, ntt_plain(t, x, inverse))
        if err:
            raise AssertionError(f"kernel A differs from plain at {label} {tuple(x.shape)}: {err}")
        if max_abs_err(ntt_cuda(t, got, not inverse), x):
            raise AssertionError(f"kernel A's round trip fails at {label} {tuple(x.shape)}")
        row = {"label": label, "shape": list(x.shape), "inverse": inverse,
               "max_abs_err": err, "ms": device_ms(lambda: ntt_cuda(t, x, inverse), reps),
               **ntt_bound(x, t.n, len(t.moduli), grows(t.moduli, t.n))}
        if (label, inverse) in plain:
            row["plain_ms"] = device_ms(lambda: ntt_plain(t, x, inverse), 3)
        rows.append(row)
    return rows


def large_ring_shapes() -> "list[tuple[str, str, int, int]]":
    """(label, tables key, batch, n) of kernel A's launches at the rings
    above N=4096, from a request at each ring and chain serving 2^20 items
    of 288 B, d=2, t of 24 bits: the first and the last expansion level's
    key-switch NTT [2^j L, Lp, N] over QP; and on SEAL's chain in
    ciphertext-multiplication mode one upper-level step's BEHZ NTTs over
    the 60-bit base Bsk (:func:`behz_step_rows` rows a step): the lift of
    the step's ciphertexts and selection ciphertexts ([2 rows, L + 1, N]) and
    the tensor product ([3 rows, L + 1, N])."""
    from pir_tpu_torch.utils.math import ceil_log2

    shapes = []
    for n in (8192, 16384, 32768):
        for profile in ("seal", "tpu32"):
            if n == 8192 and profile == "tpu32":
                continue
            ep = encryption_params(profile, n)
            levels = ceil_log2(min(sum(request_dims(ep)), n))
            L = len(ep.ct_modulus)
            for j in (0, levels - 1):
                shapes.append((f"N={n} {profile} expansion {j}", f"{n} {profile}", (1 << j) * L, n))
    for n in (8192, 16384, 32768):
        ep = encryption_params("seal", n)
        rows = behz_step_rows(ep, request_dims(ep, ct_mult=True)[0])
        shapes += [(f"N={n} Bsk lift", f"{n} bsk", 2 * rows, n),
                   (f"N={n} Bsk product", f"{n} bsk", 3 * rows, n)]
    return shapes


def behz_step_rows(ep, dim: int) -> int:
    """Rows of a ciphertext-multiplication upper dimension of `dim` rows
    (prefix 1) that one step multiplies (ops.scan.ctmult_step_rows; the
    whole dimension in a tree from before the steps, for --root)."""
    from pir_tpu_torch.ops import scan as scan_mod

    step = getattr(scan_mod, "ctmult_step_rows", None)
    if step is None:
        return dim
    return min(dim, step(1, len(ep.ct_modulus), ep.poly_modulus_degree))


def large_ring_tables(device) -> dict:
    """NttTables of large_ring_shapes()'s keys: each ring's QP chain, and the
    BEHZ base of SEAL's chain at each ring."""
    from pir_tpu_torch.core.rns import RnsTool
    from pir_tpu_torch.ops.ntt import NttTables

    tables = {}
    for key in sorted({key for _, key, _, _ in large_ring_shapes()}):
        n, chain = key.split()
        n = int(n)
        if chain == "bsk":
            ep = encryption_params("seal", n)
            tables[key] = RnsTool(ep.ct_modulus, n, ep.plain_modulus, device=device).ntt_bsk
        else:
            tables[key] = NttTables(encryption_params(chain, n).coeff_modulus, n, device)
    return tables


def max_abs_err_plain(tables, x, got, inverse: bool) -> int:
    """max |got - ntt_plain(x)|, the plain version run on PLAIN_CHUNK_BYTES
    of the input at a time (the whole of a large shape's temporaries would
    not fit the card)."""
    from pir_tpu_torch.ops.ntt import ntt_plain

    step = max(1, PLAIN_CHUNK_BYTES // (x[0].numel() * 8))
    return max(max_abs_err(got[i : i + step], ntt_plain(tables, x[i : i + step], inverse))
               for i in range(0, x.shape[0], step))


def cluster_fields(n: int, inverse: bool, grow: bool) -> dict:
    """Above N=8192: kernel A's CTAs a cluster and how many of its clusters
    the card holds at once (ops.ntt.max_active_clusters, which raises where
    a cluster cannot be resident); nothing for a tree whose kernel A has no
    clusters (``--root`` of a commit before them)."""
    from pir_tpu_torch.ops import ntt as ntt_mod

    if n <= ntt_mod.BLOCK_MAX_N or not hasattr(ntt_mod, "max_active_clusters"):
        return {}
    return {"cluster_ctas": ntt_mod.ntt_plan(n, 1).cluster_ctas,
            "clusters_resident": ntt_mod.max_active_clusters(n, inverse, grow)}


def time_ntt_large(device, gen, plain=(), reps: int = 20) -> "list[dict]":
    """Kernel A at large_ring_shapes(), forward and inverse: bit-equal to
    the plain version, then timed (the plain version too at the (label,
    inverse) pairs in `plain`, on the whole shape); above N=8192 each row
    also carries its cluster's CTAs and the clusters the card holds at
    once (cluster_fields)."""
    import torch

    from pir_tpu_torch.ops.ntt import grows, ntt_cuda, ntt_plain

    tables = large_ring_tables(device)
    rows = []
    for label, key, batch, n in large_ring_shapes():
        t = tables[key]
        x = random_residues(t.moduli, (batch,), n, device, gen)
        for inverse in (False, True):
            got = ntt_cuda(t, x, inverse)
            err = max_abs_err_plain(t, x, got, inverse)
            if err:
                raise AssertionError(f"kernel A differs from plain at {label} {tuple(x.shape)}: {err}")
            del got
            big = x.numel() * 8 > PLAIN_CHUNK_BYTES
            grow = grows(t.moduli, n)
            row = {"label": label, "shape": list(x.shape), "inverse": inverse,
                   "max_abs_err": err, "grow": grow,
                   "ms": device_ms(lambda: ntt_cuda(t, x, inverse), 3 if big else reps),
                   **ntt_bound(x, n, len(t.moduli), grow), **cluster_fields(n, inverse, grow)}
            if (label, inverse) in plain:
                row["plain_ms"] = device_ms(lambda: ntt_plain(t, x, inverse), 1)
            rows.append(row)
        del x
        torch.cuda.empty_cache()
    return rows


SERVED_N = 32768  # the ring whose whole served request kernel A is timed at


def served_ntt_launches(n: int = SERVED_N, ct_mult: bool = False,
                        dims=None) -> "list[tuple[str, str, int, bool, int]]":
    """(label, chain, batch, inverse, launches) of every kernel A launch of
    one single-query request at ring n on SEAL's chain (the Shoup-table
    layout) over the hypercube `dims` (default: 2^20 items, d=2), as the
    server issues them: per expansion level j the key switch's NTT over QP
    on [rows, L, Lp, N] digits and INTT on [rows, 2, Lp, N], its 2^j
    ciphertexts in steps of keyswitch.SWITCH_CHUNK_BYTES.  In decomposition
    mode then the selection vector's NTT, the inner scan's INTT and, per
    ops.scan.upper_step_columns digit columns, the digit plaintexts' NTT and
    the upper scan's INTT.  In ciphertext-multiplication mode (d=2) the
    inner dimension's selection vector NTT, the inner scan's INTT, then per
    upper-level step of :func:`behz_step_rows` rows bfv_multiply's NTTs
    (each operand's lift over q and over Bsk, the tensor product's INTT over
    both) and relinearize's key switch."""
    from pir_tpu_torch.ops import keyswitch
    from pir_tpu_torch.ops import scan as scan_mod
    from pir_tpu_torch.utils.math import ceil_log2

    ep = encryption_params("seal", n)
    L, Lp = len(ep.ct_modulus), len(ep.coeff_modulus)
    d0, d1 = dims if dims is not None else request_dims(ep, ct_mult=ct_mult)
    counts: dict = {}

    def add(label, chain, batch, inverse, times=1):
        key = (label, chain, batch, inverse)
        counts[key] = counts.get(key, 0) + times

    step = max(1, keyswitch.SWITCH_CHUNK_BYTES // (L * 2 * Lp * n * 8))

    def switch(label, rows):
        for r0 in range(0, rows, step):
            k = min(step, rows - r0)
            add(f"{label} digits", "qp", k * L, False)
            add(f"{label} INTT", "qp", k * 2, True)

    for j in range(ceil_log2(min(d0 + d1, n))):
        switch(f"expansion {j}", 1 << j)
    if ct_mult:
        add("selection vector", "q", d1 * 2, False)
        add("inner-scan INTT", "q", d0 * 2, True)
        rows = behz_step_rows(ep, d0)
        for r0 in range(0, d0, rows):
            r = min(rows, d0 - r0)
            for chain in ("q", "bsk"):
                add("BEHZ lift", chain, 2 * r, False, times=2)
                add("BEHZ product", chain, 3 * r, True)
            switch("relinearization", r)
        return [(*key, c) for key, c in counts.items()]
    add("selection vector", "q", (d0 + d1) * 2, False)
    add("inner-scan INTT", "q", d0 * 2, True)
    new_c = 2 * expansion_ratio(ep)
    cols = scan_mod.upper_step_columns(d0, L, n)
    for c0 in range(0, new_c, cols):
        k = min(cols, new_c - c0)
        add("digit plaintexts", "q", k * d0, False)
        add("upper-scan INTT", "q", k * 2, True)
    return [(*key, c) for key, c in counts.items()]


def time_ntt_served(device, gen, plain=(), reps: int = 5, n: int = SERVED_N,
                    ct_mult: bool = False, dims=None) -> "list[dict]":
    """Kernel A at served_ntt_launches(n, ct_mult, dims): bit-equal to the
    plain version (a quarter GB of input at a time), then timed; each row
    carries its chain ("q", "qp" or "bsk"), its launches a request and
    cluster_fields.  The plain version is timed at the (label, inverse)
    pairs in `plain`."""
    import torch

    from pir_tpu_torch.core.rns import RnsTool
    from pir_tpu_torch.ops.ntt import NttTables, grows, ntt_cuda, ntt_plain

    ep = encryption_params("seal", n)
    tables = {"qp": NttTables(ep.coeff_modulus, n, device)}
    tables["q"] = tables["qp"].slice(len(ep.ct_modulus))
    if ct_mult:
        tables["bsk"] = RnsTool(ep.ct_modulus, n, ep.plain_modulus, device=device).ntt_bsk
    mode = "ct-mult " if ct_mult else ""
    rows = []
    for label, chain, batch, inverse, launches in served_ntt_launches(n, ct_mult, dims):
        t = tables[chain]
        x = random_residues(t.moduli, (batch,), n, device, gen)
        got = ntt_cuda(t, x, inverse)
        err = max_abs_err_plain(t, x, got, inverse)
        if err:
            raise AssertionError(f"kernel A differs from plain at {label} {tuple(x.shape)}: {err}")
        del got
        grow = grows(t.moduli, n)
        row = {"label": f"N={n} served {mode}{label}", "chain": chain, "shape": list(x.shape),
               "inverse": inverse, "max_abs_err": err, "grow": grow, "launches": launches,
               "ms": device_ms(lambda: ntt_cuda(t, x, inverse), reps),
               **ntt_bound(x, n, len(t.moduli), grow),
               **cluster_fields(n, inverse, grow)}
        if (label, inverse) in plain:
            row["plain_ms"] = device_ms(lambda: ntt_plain(t, x, inverse), 1)
        rows.append(row)
        del x
        torch.cuda.empty_cache()
    return rows


def served_sums(rows) -> "tuple[int, float, float]":
    """Launches, Σ time and Σ bound of kernel A over one served request
    (time_ntt_served's rows, each weighted by its launches)."""
    return (sum(r["launches"] for r in rows), sum(r["ms"] * r["launches"] for r in rows),
            sum(r["bound_ms"] * r["launches"] for r in rows))


def request_sums(ntt_rows) -> "tuple[float, float]":
    """Σ time and Σ bound of kernel A over one request's 22 launches."""
    request = [r for r in ntt_rows if r["label"] != "N=256"]
    return sum(r["ms"] for r in request), sum(r["bound_ms"] for r in request)


def scan_cases():
    """(label, profile, limb or None, P, D, n) of kernel B's main-path
    shapes: a single-query 2^20-item request's inner scan (P = D_0 prefixes
    over D = D_1 rows) and upper scan (P = 2·ER digit plaintexts over D_0
    rows) with a hi plane (K1: SEAL's chain, a u8 plane at N=4096, u16 at
    N=8192's 43/44-bit moduli) and without (K5: tpu32) at N=4096 and 8192,
    and one rank's shapes of each limb-sharded mesh at N=4096 (K6: limb 1
    of SEAL's chain on db=2 x limb=2, one limb of tpu32 on limb=3)."""
    cases = []
    for n in (POLY_DEGREE, 8192):
        ring = "" if n == POLY_DEGREE else f" N={n}"
        for kernel, profile in (("K1", "seal"), ("K5", "tpu32")):
            ep = encryption_params(profile, n)
            d0, d1 = request_dims(ep)
            cases += [(f"{kernel}{ring} inner", profile, None, d0, d1, n),
                      (f"{kernel}{ring} upper", profile, None, 2 * expansion_ratio(ep), d0, n)]
    d0, d1 = request_dims(encryption_params())
    return cases + [("K6 seal rank", "seal", 1, d0 // 2, d1, POLY_DEGREE),
                    ("K6 tpu32 rank", "tpu32", 2, d0, d1, POLY_DEGREE)]


def time_scan(device, gen, plain: bool = False, reps: int = 20) -> "list[dict]":
    """Kernel B at scan_cases(): the single-query scans (K1 with a hi plane,
    K5 without) and one rank's shapes of the limb-sharded meshes (K6),
    bit-equal to plain, then timed (the plain version too where `plain`)."""
    from pir_tpu_torch.ops import modular, scan_kernel

    rows = []
    for label, profile, limb, P, D, n in scan_cases():
        chain = encryption_params(profile, n).ct_modulus
        bits = max(q.bit_length() for q in chain)
        limbs = modular.LimbConstants(chain, device)
        if limb is not None:
            limbs = limbs.limb_range(limb, limb + 1)
        sv = random_residues(limbs.moduli, (D, 2), n, device, gen)
        db = random_residues(limbs.moduli, (P, D), n, device, gen)
        hi, lo = scan_kernel.split_planes(db.transpose(1, 2).contiguous(), bits=bits)
        del db
        if limb is None:
            def run():
                return scan_kernel.contract_cuda(sv, hi, lo, limbs)
        else:
            consts = scan_kernel.limb_consts(limbs.q, limbs.ratio_hi, limbs.ratio_lo)

            def run():
                return scan_kernel.contract_dim_raw_dyn(sv, hi, lo, consts, bits)
        err = max_abs_err(run(), scan_kernel.contract_plain(sv, hi, lo, limbs.table))
        if err:
            raise AssertionError(f"kernel B differs from plain at {label}: {err}")
        gb = ((0 if hi is None else hi.numel() * hi.element_size()) + lo.numel() * 4) / 1e9
        ms = device_ms(run, reps)
        row = {"label": label, "sv": list(sv.shape), "planes": list(lo.shape),
               "hi_plane": None if hi is None else str(hi.dtype), "max_abs_err": err,
               "ms": ms, "planes_gb_per_s": gb / ms * 1e3, **scan_bound(sv, hi, lo)}
        if plain:
            row["plain_ms"] = device_ms(lambda: scan_kernel.contract_plain(sv, hi, lo, limbs.table), 2)
        rows.append(row)
        del sv, hi, lo
    return rows


BATCH_COLUMNS = 32  # a batched pass of 16 lanes: two ciphertext halves a query


def wide_cases() -> "list[tuple[str, str, int]]":
    """(label, profile, n) of kernel C's main-path shapes: the inner scan of
    a 2^20-item batched request at 16 lanes (S = 32 columns; P = D_0
    prefixes over D = D_1 rows) with a hi plane (K4: SEAL's chain, u8 at
    N=4096, u16 at N=8192) and without (K4-u32: tpu32), at N=4096 and
    8192."""
    return [("K4", "seal", POLY_DEGREE), ("K4-u32", "tpu32", POLY_DEGREE),
            ("K4 N=8192", "seal", 8192), ("K4-u32 N=8192", "tpu32", 8192)]


def time_wide(device, gen, plain: bool = False, reps: int = 5) -> "list[dict]":
    """Kernel C at wide_cases(): bit-equal to plain and, on its first two
    column pairs, to kernel B; then timed, beside 16 calls of kernel B on
    the same columns (``b16_ms``), and the plain version where `plain`."""
    import torch

    from pir_tpu_torch.ops import modular, scan_kernel

    rows = []
    for label, profile, n in wide_cases():
        ep = encryption_params(profile, n)
        chain = ep.ct_modulus
        P, D = request_dims(ep)
        limbs = modular.LimbConstants(chain, device)
        sv = random_residues(chain, (D, BATCH_COLUMNS), n, device, gen)
        db = random_residues(chain, (P, D), n, device, gen)
        hi, lo = scan_kernel.split_planes(db.transpose(1, 2).contiguous(), chain)
        del db
        got = scan_kernel.contract_wide_cuda(sv, hi, lo, limbs)
        err = max_abs_err(got, scan_kernel.contract_wide_plain(sv, hi, lo, limbs.table))
        if err:
            raise AssertionError(f"kernel C differs from plain at {label}: {err}")
        pairs = [sv[:, c : c + 2].contiguous() for c in range(0, BATCH_COLUMNS, 2)]
        for c in (0, 2):
            if not torch.equal(scan_kernel.contract_cuda(pairs[c // 2], hi, lo, limbs),
                               got[:, c : c + 2]):
                raise AssertionError(f"kernel C's columns differ from kernel B's at {label}")
        del got
        gb = ((0 if hi is None else hi.numel() * hi.element_size()) + lo.numel() * 4) / 1e9
        ms = device_ms(lambda: scan_kernel.contract_wide_cuda(sv, hi, lo, limbs), reps)
        row = {"label": label, "sv": list(sv.shape), "planes": list(lo.shape),
               "hi_plane": None if hi is None else str(hi.dtype), "max_abs_err": err,
               "ms": ms, "planes_gb_per_s": gb / ms * 1e3,
               "b16_ms": device_ms(lambda: [scan_kernel.contract_cuda(x, hi, lo, limbs)
                                            for x in pairs], 3),
               **scan_bound(sv, hi, lo)}
        if plain:
            row["plain_ms"] = device_ms(
                lambda: scan_kernel.contract_wide_plain(sv, hi, lo, limbs.table), 1)
        rows.append(row)
        del sv, hi, lo, pairs
        torch.cuda.empty_cache()
    return rows


def shoup_cases() -> "list[tuple[str, tuple, int, int, int]]":
    """(label, moduli, P, D, n) of kernel D's main-path shapes, each a
    2^20-item single-query request's inner scan of the Shoup-table
    database (P = D_0 prefixes over D = D_1 rows): N=4096 on SEAL's chain
    and on two 60-bit moduli (only this layout serves them: its u64 sums
    fold every 8 rows); ciphertext-multiplication mode at N=8192 (SEAL's
    43/44-bit chain, db and companions 6.8 GB), and one rank's block of it
    on a db=2 mesh (D_0 split over 2 ranks); decomposition at N=16384
    (SEAL's 48/49-bit chain, above the planes' 48 bits) and at N=32768
    (SEAL's 55/56-bit chain, db and companions 25.5 GB: the plain version
    compares every prefix, a few at a time)."""
    from pir_tpu_torch.core import primes

    seal = encryption_params()
    ct8192 = encryption_params("seal", 8192)
    seal16384 = encryption_params("seal", 16384)
    seal32768 = encryption_params("seal", 32768)
    return [("K7 inner", seal.ct_modulus, *request_dims(seal), POLY_DEGREE),
            ("K7 60-bit inner", tuple(primes.coeff_modulus_from_bits(POLY_DEGREE, [60, 60])),
             *request_dims(seal), POLY_DEGREE),
            ("K7 N=8192 ct-mult inner", ct8192.ct_modulus, *request_dims(ct8192, True), 8192),
            ("K7 N=8192 ct-mult inner, a db=2 rank's block", ct8192.ct_modulus,
             -(-request_dims(ct8192, True)[0] // 2), request_dims(ct8192, True)[1], 8192),
            ("K7 N=16384 inner", seal16384.ct_modulus, *request_dims(seal16384), 16384),
            ("K7 N=32768 inner", seal32768.ct_modulus, *request_dims(seal32768), 32768)]


def shoup_bound(sv, db, out) -> dict:
    """sv, db, its companions and the output each moved once; one Shoup
    product per (prefix, row, size, limb, coefficient)."""
    return bound((sv.numel() + 2 * db.numel() + out.numel()) * 8,
                 db.numel() * sv.shape[1] * MULS_SHOUP)


def time_shoup(device, gen, cases=None, plain: bool = False, reps: int = 10) -> "list[dict]":
    """Kernel D at `cases` (default shoup_cases()), sv [D, 2, L, N] against
    db and companions [P, D, L, N]: bit-equal to plain, then timed (the
    plain version too where `plain`)."""
    import torch

    from pir_tpu_torch.ops import modular, scan_kernel

    rows = []
    for label, moduli, P, D, n in cases if cases is not None else shoup_cases():
        limbs = modular.LimbConstants(moduli, device)
        sv = random_residues(moduli, (D, 2), n, device, gen)
        db = random_residues(moduli, (P, D), n, device, gen)
        shoup = torch.empty_like(db)
        step = max(1, PLAIN_CHUNK_BYTES // (db[0].numel() * 8))  # its temporaries: a few prefixes
        for i in range(0, P, step):
            shoup[i : i + step] = modular.shoup_precompute_device(
                db[i : i + step], limbs.q, limbs.ratio_hi, limbs.ratio_lo)
        got = scan_kernel.contract_shoup_cuda(sv, db, shoup, limbs)
        err = max_abs_err(got, scan_kernel.contract_shoup_plain(sv, db, shoup, limbs))
        if err:
            raise AssertionError(f"kernel D differs from plain at {label}: {err}")
        gb = (sv.numel() + 2 * db.numel() + got.numel()) * 8 / 1e9
        ms = device_ms(lambda: scan_kernel.contract_shoup_cuda(sv, db, shoup, limbs), reps)
        row = {"label": label, "sv": list(sv.shape), "db": list(db.shape),
               "bits": max(int(q).bit_length() for q in moduli), "max_abs_err": err,
               "ms": ms, "gb_per_s": gb / ms * 1e3, **shoup_bound(sv, db, got)}
        if plain:
            row["plain_ms"] = device_ms(
                lambda: scan_kernel.contract_shoup_plain(sv, db, shoup, limbs), 1)
        rows.append(row)
        del sv, db, shoup, got
        torch.cuda.empty_cache()
    return rows


KS_LEVELS_N = POLY_DEGREE  # kernel E: each expansion level of a request at this ring
BATCH_LANES = 16  # kernel E: the batched request's lanes


def switch_step_rows(L: int, Lp: int, n: int) -> int:
    """Rows a key-switch step takes (ops.keyswitch.SWITCH_CHUNK_BYTES)."""
    from pir_tpu_torch.ops import keyswitch

    return max(1, keyswitch.SWITCH_CHUNK_BYTES // (L * 2 * Lp * n * 8))


def keyswitch_cases() -> "list[tuple[str, str, int, int, int | None, tuple | None]]":
    """(label, profile, n, rows, level, trees) of kernel E's served shapes:
    every expansion level j of a 2^20-item single-query request at N=4096 on
    SEAL's chain and on tpu32 (2^j rows, one step); the first step of a
    16-lane batched request's last level (its combine on the level's 16
    trees); one step of the last level at N=32768 (SEAL's chain; the combine
    on the whole level); one relinearization step of a ciphertext-
    multiplication request at N=32768 (level None: no permutation, the
    product's c0 and c1 added, no combine).  E1-E3 take `rows` rows; E4
    takes `trees` = (Q, B): Q trees of B ciphertexts (Q 0: one tree on
    axis 0)."""
    from pir_tpu_torch.utils.math import ceil_log2

    cases = []
    for profile in ("seal", "tpu32"):
        ep = encryption_params(profile)
        for j in range(ceil_log2(min(sum(request_dims(ep)), KS_LEVELS_N))):
            cases.append((f"N=4096 {profile} expansion {j}", profile, KS_LEVELS_N, 1 << j, j,
                          (0, 1 << j)))
    ep = encryption_params()
    j = ceil_log2(min(sum(request_dims(ep)), POLY_DEGREE)) - 1
    rows = min(BATCH_LANES << j, switch_step_rows(len(ep.ct_modulus), len(ep.coeff_modulus),
                                                  POLY_DEGREE))
    cases.append((f"N=4096 seal batched {BATCH_LANES} lanes, expansion {j}", "seal",
                  POLY_DEGREE, rows, j, (BATCH_LANES, 1 << j)))
    ep = encryption_params("seal", SERVED_N)
    L, Lp = len(ep.ct_modulus), len(ep.coeff_modulus)
    j = ceil_log2(min(sum(request_dims(ep)), SERVED_N)) - 1
    cases.append((f"N={SERVED_N} seal expansion {j}", "seal", SERVED_N,
                  min(1 << j, switch_step_rows(L, Lp, SERVED_N)), j, (0, 1 << j)))
    rows = behz_step_rows(ep, request_dims(ep, ct_mult=True)[0])
    cases.append((f"N={SERVED_N} seal relinearization", "seal", SERVED_N,
                  min(rows, switch_step_rows(L, Lp, SERVED_N)), None, None))
    return cases


def keyswitch_bounds(L: int, Lp: int, n: int, rows: int, galois: bool, addends: int,
                     ciphertexts: int) -> dict:
    """Each entry's bound: E1 reads rows x L words (and the permutation)
    and writes them reduced mod Lp primes, a one-word Barrett reduction
    each; E2 reads the digits and the key and writes [rows, 2, Lp, N], a
    wide product per (row, digit, output) and a two-word reduction per
    output; E3 reads the output limbs and P's of acc and the addends and
    writes [rows, 2, L, N], a one-word reduction and a Shoup product each;
    E4 reads `ciphertexts` ciphertexts and their substitutions and writes
    twice as many, no multiplies."""
    perm = (9 * n) if galois else 0
    return {
        "E1": bound(rows * L * n * 8 + perm + rows * L * Lp * n * 8,
                    rows * L * Lp * n * MULS_BARRETT64),
        "E2": bound((rows * L * Lp * n + L * 2 * Lp * n + rows * 2 * Lp * n) * 8,
                    rows * L * Lp * n * 2 * MULS_WIDE + rows * 2 * Lp * n * MULS_BARRETT128),
        "E3": bound((rows * 2 * (L + 1) * n + addends * rows * L * n + rows * 2 * L * n) * 8
                    + (perm if addends else 0),
                    rows * 2 * L * n * (MULS_BARRETT64 + MULS_SHOUP)),
        "E4": bound(ciphertexts * 2 * L * n * 8 * 4, 0),
    }


def time_keyswitch(device, gen, cases=None, plain: bool = True, reps: int = 10) -> "list[dict]":
    """Kernel E's four entries at `cases` (default keyswitch_cases()), each
    on random words of the case's shape: bit-equal to its plain version,
    then timed (and the plain version where `plain`), with its bound.  One
    row per (case, entry)."""
    import torch

    from pir_tpu_torch.core.context import PirContext
    from pir_tpu_torch.core.params import create_pir_parameters
    from pir_tpu_torch.ops import expand, keyswitch

    rows_out = []
    for label, profile, n, rows, level, trees in cases if cases is not None else keyswitch_cases():
        ep = encryption_params(profile, n)
        ctx = PirContext.for_params(create_pir_parameters(ITEMS, ITEM_BYTES, DIMS, ep), device)
        L, Lp = ctx.L, ctx.Lp
        galois = level is not None
        perm = ctx.galois_permutation((n >> level) + 1) if galois else None
        polys = 2 if galois else 3
        ct = random_residues(ctx.ct_moduli, (rows, polys), n, device, gen)
        addends = (ct[:, 0], None) if galois else (ct[:, 0], ct[:, 1])
        digits = random_residues(ctx.key_moduli, (rows, L), n, device, gen)
        key = random_residues(ctx.key_moduli, (L, 2), n, device, gen)
        acc = random_residues(ctx.key_moduli, (rows, 2), n, device, gen)
        entries = {
            "E1": (lambda: keyswitch.decompose_cuda(ctx, ct[:, polys - 1], perm),
                   lambda: keyswitch.decompose_plain(ctx, ct[:, polys - 1], perm)),
            "E2": (lambda: keyswitch.inner_product_cuda(ctx.limbs_qp, digits, key),
                   lambda: keyswitch.inner_product_plain(ctx, digits, key)),
            "E3": (lambda: keyswitch.mod_down_cuda(ctx, acc, addends, perm),
                   lambda: keyswitch.mod_down_plain(ctx, acc, addends, perm)),
        }
        count = 0
        if trees is not None:
            q, b = trees
            shape = (b, 2) if q == 0 else (q, b, 2)
            cts = random_residues(ctx.ct_moduli, shape, n, device, gen)
            sub = random_residues(ctx.ct_moduli, shape, n, device, gen)
            axis = 0 if q == 0 else 1
            count = max(q, 1) * b
            entries["E4"] = (lambda: expand.combine_cuda(ctx, cts, sub, level, axis),
                             lambda: expand.combine_plain(ctx, cts, sub, level, axis))
        bounds = keyswitch_bounds(L, Lp, n, rows, galois, sum(a is not None for a in addends),
                                  count)
        for entry, (kernel, reference) in entries.items():
            got = kernel()
            err = max_abs_err(got, reference())
            if err:
                raise AssertionError(f"kernel {entry} differs from plain at {label}: {err}")
            row = {"label": label, "entry": entry, "shape": list(got.shape), "max_abs_err": err,
                   "ms": device_ms(kernel, reps), **bounds[entry]}
            if plain:
                row["plain_ms"] = device_ms(reference, 1 if n == SERVED_N else 3)
            rows_out.append(row)
            del got
        del ct, addends, digits, key, acc, entries
        torch.cuda.empty_cache()
    return rows_out


def upper_cases() -> "list[tuple[str, str, int, int, int, int, tuple]]":
    """(label, profile, n, lanes, c0, c1, entries) of kernel F's upper-level
    shapes, a 2^20-item request on SEAL's chain (its first upper level:
    prefix 1, C = 1): the main path's step at N=4096 (F1, then F4 into
    kernel B's planes); a 16-lane batch's step (F1 over all lanes, F4 on one
    lane's items); the Shoup-table layout's step at N=4096 (F2); the first
    and the ragged last of the upper level's ops.scan.UPPER_STEP_BYTES steps
    at N=32768 (F1, F2).  lanes 0: no lane axis."""
    from pir_tpu_torch.ops import scan as scan_mod

    cases = []
    for n in (POLY_DEGREE, SERVED_N):
        ep = encryption_params("seal", n)
        d0 = request_dims(ep)[0]
        new_c = 2 * expansion_ratio(ep)
        step = min(new_c, scan_mod.upper_step_columns(d0, len(ep.ct_modulus), n))
        if n == POLY_DEGREE:
            cases += [(f"N={n} upper step", "seal", n, 0, 0, step, ("F1", "F4")),
                      (f"N={n} batched {BATCH_LANES} lanes, upper step", "seal", n, BATCH_LANES,
                       0, step, ("F1", "F4")),
                      (f"N={n} Shoup upper step", "seal", n, 0, 0, step, ("F2",))]
        else:
            last = (new_c - 1) // step * step
            cases += [(f"N={n} upper step", "seal", n, 0, 0, step, ("F1", "F2")),
                      (f"N={n} last upper step", "seal", n, 0, last, new_c, ("F1", "F2"))]
    return cases


def modswitch_cases() -> "list[tuple[str, str, int, int, int]]":
    """(label, profile, n, replies, keep) of kernel F3's reply mod switch at
    a 2^20-item single-query request: its (2·ER) reply ciphertexts from L
    limbs to reply_limbs_for's, at N=4096 and N=32768 on SEAL's chain."""
    from pir_tpu_torch.core.params import create_pir_parameters
    from pir_tpu_torch.pir.server import reply_limbs_for

    cases = []
    for n in (POLY_DEGREE, SERVED_N):
        ep = encryption_params("seal", n)
        keep = reply_limbs_for(create_pir_parameters(ITEMS, ITEM_BYTES, DIMS, ep))
        cases.append((f"N={n} reply", "seal", n, 2 * expansion_ratio(ep), keep))
    return cases


def upper_bounds(entry: str, **k) -> dict:
    """Kernel F's bounds.  F1 reads each source word its columns name once
    (`sources` words) and writes `items` x L words; F2 reads sv [D, 2, L, N]
    and items [P, D, L, N] and writes [P, 2, L, N], a wide product per
    (prefix, row, output) and a two-word reduction per output and chunk; F3
    reads [R, L', N] and writes [R, keep, N], a one-word reduction and a
    Shoup product per limb update (s updates to drop limb s); F4 reads
    [P, D, L, N] words and writes 4 bytes and the hi plane's per word."""
    if entry == "F1":
        return bound((k["sources"] + k["items"] * k["L"]) * 8, 0)
    if entry == "F2":
        P, D, L, N, chunks = k["P"], k["D"], k["L"], k["N"], k["chunks"]
        return bound((D * 2 * L * N + P * D * L * N + P * 2 * L * N) * 8,
                     P * D * L * N * 2 * MULS_WIDE + P * 2 * L * N * chunks * MULS_BARRETT128)
    if entry == "F3":
        R, cur, keep, N = k["R"], k["cur"], k["keep"], k["N"]
        updates = sum(range(keep, cur))
        return bound(R * (cur + keep) * N * 8, R * N * updates * (MULS_BARRETT64 + MULS_SHOUP))
    return bound(k["words"] * (8 + 4 + k["hi_bytes"]), 0)


def _plain_by_prefix(fn, items):
    """fn over items' leading rows PLAIN_CHUNK_BYTES at a time, concatenated
    (the plain versions' temporaries of a whole N=32768 step would not fit
    the card)."""
    import torch

    step = max(1, PLAIN_CHUNK_BYTES // (items[0].numel() * 8))
    return torch.cat([fn(items[i : i + step]) for i in range(0, items.shape[0], step)])


def time_upper(device, gen, labels=None, plain: bool = True, reps: int = 10) -> "list[dict]":
    """Kernel F at upper_cases() and modswitch_cases() (those whose label is
    in `labels`, where given), each entry on random words of the case's
    shape: bit-equal to its plain version, then timed (and the plain version
    where `plain`), with its bound.  One row per (case, entry)."""
    import torch

    from pir_tpu_torch.core.context import PirContext
    from pir_tpu_torch.core.params import create_pir_parameters
    from pir_tpu_torch.ops import decompose, modswitch, scan, scan_kernel

    rows_out = []

    def run(label, entry, kernel, reference, bounds, big):
        got = kernel()
        want = reference()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        err = max(0 if a is None and b is None else max_abs_err(a.to(torch.int64),
                                                                 b.to(torch.int64))
                  for a, b in pairs)
        if err:
            raise AssertionError(f"kernel {entry} differs from plain at {label}: {err}")
        shape = got[1].shape if isinstance(got, tuple) else got.shape
        row = {"label": label, "entry": entry, "shape": list(shape), "max_abs_err": err,
               "ms": device_ms(kernel, reps), **bounds}
        if plain:
            row["plain_ms"] = device_ms(reference, 1 if big else 3)
        rows_out.append(row)

    for label, profile, n, lanes, c0, c1, entries in upper_cases():
        if labels is not None and label not in labels:
            continue
        ep = encryption_params(profile, n)
        ctx = PirContext.for_params(create_pir_parameters(ITEMS, ITEM_BYTES, DIMS, ep), device)
        L, d0, k = ctx.L, request_dims(ep)[0], c1 - c0
        lead = (lanes,) if lanes else ()
        big = n == SERVED_N
        if "F1" in entries:
            result = random_residues(ctx.ct_moduli, (*lead, d0, 1, 2), n, device, gen)
            table = decompose.lift_table(ctx).tolist()
            er2 = len(table)
            sources = len({(c // er2, table[c % er2][0]) for c in range(c0, c1)})
            run(label, "F1", lambda: decompose.lift_columns_cuda(ctx, result, 1, d0, c0, c1),
                lambda: decompose.lift_columns_plain(ctx, result, 1, d0, c0, c1),
                upper_bounds("F1", sources=max(lanes, 1) * d0 * sources * n,
                             items=max(lanes, 1) * k * d0 * n, L=L), big)
            del result
        items = random_residues(ctx.ct_moduli, (k, d0), n, device, gen)
        if "F2" in entries:
            sv = random_residues(ctx.ct_moduli, (d0, 2), n, device, gen)
            chunks = -(-d0 // scan_kernel.contract_chunk(ctx.ct_moduli))
            run(label, "F2", lambda: scan.contract_dim_cuda(ctx.limbs_q, sv, items),
                lambda: _plain_by_prefix(lambda x: scan.contract_dim_plain(ctx, sv, x), items),
                upper_bounds("F2", P=k, D=d0, L=L, N=n, chunks=chunks), big)
            del sv
        if "F4" in entries:
            bits = max(int(q).bit_length() for q in ctx.ct_moduli)
            hi_bytes = 0 if bits <= 32 else scan_kernel.hi_plane_dtype(bits=bits).itemsize
            run(label, "F4", lambda: scan_kernel.items_to_planes_cuda(items, bits),
                lambda: scan_kernel.items_to_planes_plain(items, bits),
                upper_bounds("F4", words=items.numel(), hi_bytes=hi_bytes), big)
        del items
        torch.cuda.empty_cache()
    for label, profile, n, replies, keep in modswitch_cases():
        if labels is not None and label not in labels:
            continue
        ep = encryption_params(profile, n)
        ctx = PirContext.for_params(create_pir_parameters(ITEMS, ITEM_BYTES, DIMS, ep), device)
        ct = random_residues(ctx.ct_moduli, (replies, 2), n, device, gen)
        run(label, "F3", lambda: modswitch.mod_switch_cuda(ctx, ct, keep),
            lambda: modswitch.mod_switch_plain(ctx, ct, keep),
            upper_bounds("F3", R=replies * 2, cur=ctx.L, keep=keep, N=n), n == SERVED_N)
        del ct
        torch.cuda.empty_cache()
    return rows_out


def behz_cases() -> "list[tuple[str, int, int]]":
    """(label, n, rows) of kernel G's served shapes: one upper-level step of
    a 2^20-item ciphertext-multiplication request on SEAL's chain (prefix 1,
    :func:`behz_step_rows` rows) at N=8192, the benchmark's ct-mult cell,
    whose step is the whole dimension of 114 rows, and at N=32768."""
    cases = []
    for n in (8192, SERVED_N):
        ep = encryption_params("seal", n)
        rows = behz_step_rows(ep, request_dims(ep, ct_mult=True)[0])
        cases.append((f"N={n} ct-mult step", n, rows))
    return cases


def behz_bounds(k: int, n: int, rows: int) -> dict:
    """Kernel G's bounds at one step of `rows` ciphertexts multiplied by as
    many selection ciphertexts over k ciphertext primes (k + 1 in Bsk).  G1
    (one operand's lift) reads [rows, 2, k, N] and writes [rows, 2, k + 1,
    N]: a Shoup product a q limb, and a Bsk limb k wide products, a two-word
    reduction and two Shoup products; G2 reads both operands in both bases
    and writes [rows, 3, 2k + 1, N], four wide products and three two-word
    reductions a limb; G3 reads [rows, 3, 2k + 1, N] and writes [rows, 3,
    k, N]: a Shoup product a q limb, then per Bsk limb k wide products, a
    reduction and two Shoup products, m_sk's sum (k wide products, a
    reduction, a Shoup product) and per q limb k wide products, a reduction
    and a Shoup product.  "request": a multiply's four launches (G1 for
    each operand), their bytes and multiplies summed."""
    cols = rows * n
    b = k + 1
    sums = MULS_WIDE * k + MULS_BARRETT128
    work = {  # entry -> (bytes, 32-bit multiplies)
        "G1": (2 * cols * (k + b) * 8, 2 * cols * (k * MULS_SHOUP + b * (sums + 2 * MULS_SHOUP))),
        "G2": (cols * 7 * (k + b) * 8, cols * (k + b) * (4 * MULS_WIDE + 3 * MULS_BARRETT128)),
        "G3": (3 * cols * (k + b + k) * 8,
               3 * cols * (k * MULS_SHOUP + b * (sums + 2 * MULS_SHOUP) + sums + MULS_SHOUP
                           + k * (sums + MULS_SHOUP))),
    }
    work["request"] = (2 * work["G1"][0] + work["G2"][0] + work["G3"][0],
                       2 * work["G1"][1] + work["G2"][1] + work["G3"][1])
    return {entry: bound(*w) for entry, w in work.items()}


def time_behz(device, gen, cases=None, plain: bool = True, reps: int = 10) -> "list[dict]":
    """Kernel G's three entries at `cases` (default behz_cases()), each on
    random words of the case's shape (selection ciphertexts [1, rows],
    prefix 1, as the ct-mult scan multiplies them), and the whole
    bfv_multiply on them: bit-equal to the plain versions (the multiply's
    with kernel A's NTTs), then timed (and the plain version where `plain`),
    with the bound.  One row per (case, entry)."""
    import torch

    from pir_tpu_torch.bfv import multiply
    from pir_tpu_torch.core.context import PirContext
    from pir_tpu_torch.core.params import create_pir_parameters

    def plain_multiply(ctx, x, y):
        swapped = {name: getattr(multiply, name) for name in ("lift", "tensor_product", "floor_sk")}
        for name in swapped:
            setattr(multiply, name, getattr(multiply, f"{name}_plain"))
        try:
            return multiply.bfv_multiply(ctx, x, y)
        finally:
            for name, fn in swapped.items():
                setattr(multiply, name, fn)

    rows_out = []
    for label, n, rows in cases if cases is not None else behz_cases():
        ep = encryption_params("seal", n)
        ctx = PirContext.for_params(create_pir_parameters(
            ITEMS, ITEM_BYTES, DIMS, ep, use_ciphertext_multiplication=True), device)
        tool = multiply.rns_tool_for(ctx)
        q, bsk = tool.q_moduli, tool.bsk_moduli
        ct = random_residues(q, (1, rows, 2), n, device, gen)
        sel = random_residues(q, (1, rows, 2), n, device, gen)
        ops = [random_residues(m, (1, rows, 2), n, device, gen) for m in (q, bsk, q, bsk)]
        prod_q = random_residues(q, (1, rows, 3), n, device, gen)
        prod_b = random_residues(bsk, (1, rows, 3), n, device, gen)
        entries = {
            "G1": (lambda: multiply.lift_cuda(tool, ct), lambda: multiply.lift_plain(tool, ct)),
            "G2": (lambda: multiply.tensor_product_cuda(tool, *ops),
                   lambda: multiply.tensor_product_plain(tool, *ops)),
            "G3": (lambda: multiply.floor_sk_cuda(tool, prod_q, prod_b),
                   lambda: multiply.floor_sk_plain(tool, prod_q, prod_b)),
            "bfv_multiply": (lambda: multiply.bfv_multiply(ctx, ct, sel),
                             lambda: plain_multiply(ctx, ct, sel)),
        }
        bounds = behz_bounds(len(q), n, rows)
        for entry, (kernel, reference) in entries.items():
            got, want = kernel(), reference()
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            err = max(max_abs_err(a, b) for a, b in pairs)
            if err:
                raise AssertionError(f"kernel G {entry} differs from plain at {label}: {err}")
            shape = got[1].shape if isinstance(got, tuple) else got.shape
            work = "request" if entry == "bfv_multiply" else entry
            row = {"label": label, "entry": entry, "shape": list(shape), "max_abs_err": err,
                   "ms": device_ms(kernel, reps), **bounds[work]}
            if plain:
                row["plain_ms"] = device_ms(reference, 1 if n == SERVED_N else 3)
            rows_out.append(row)
            del got, want
        del ct, sel, ops, prod_q, prod_b, entries
        torch.cuda.empty_cache()
    return rows_out


def keyswitch_line(r) -> str:
    """A kernel E or F row (time_keyswitch's, time_upper's) as a log line."""
    return (f"kernel {r['entry']} {r['label']} -> {r['shape']}: bit-equal to plain "
            f"(max_abs_err {r['max_abs_err']}); {r['ms']:.4f} ms"
            + (f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r else "")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.1%} of bound)")


def behz_line(r) -> str:
    """A kernel G row (time_behz's) as a log line: an entry's as kernel E's,
    the whole multiply's beside the bound of its four G launches."""
    if r["entry"] != "bfv_multiply":
        return keyswitch_line(r)
    return (f"bfv_multiply (G1 twice, G2, G3 and kernel A's NTTs) {r['label']} -> {r['shape']}: "
            f"bit-equal to the plain steps with the same NTTs (max_abs_err {r['max_abs_err']}); "
            f"{r['ms']:.4f} ms" + (f", plain steps {r['plain_ms']:.4f} ms" if "plain_ms" in r
                                   else "")
            + f"; its G launches' bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def ntt_line(r) -> str:
    checks = "bit-equal to plain" + ("" if "grow" in r else ", round trip exact")
    if "launches" in r:
        checks += f", {r['launches']} launch(es) a request"
    butterflies = "" if "grow" not in r else (" (growing)" if r["grow"] else " (reducing)")
    clusters = ("" if "cluster_ctas" not in r else
                f"; clusters of {r['cluster_ctas']} CTAs, {r['clusters_resident']} resident")
    return (f"kernel A {r['label']} {r['shape']} {'inverse' if r['inverse'] else 'forward'}"
            f"{butterflies}: {checks} (max_abs_err {r['max_abs_err']}); "
            f"{r['ms']:.4f} ms" + (f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r else "")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.1%} of bound){clusters}")


def scan_line(r) -> str:
    return (f"kernel B {r['label']} sv {r['sv']} planes {r['planes']} (hi plane {r['hi_plane']}): "
            f"bit-equal to plain (max_abs_err {r['max_abs_err']}); {r['ms']:.4f} ms "
            f"({r['planes_gb_per_s']:.1f} GB/s of planes)"
            + (f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r else "")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def wide_line(r) -> str:
    return (f"kernel C ({r['label']}) sv {r['sv']} planes {r['planes']} (hi plane "
            f"{r['hi_plane']}): bit-equal to plain (max_abs_err {r['max_abs_err']}); "
            f"{r['ms']:.4f} ms ({r['planes_gb_per_s']:.1f} GB/s of planes, "
            f"{r['bound_ms'] / r['ms']:.1%} of bound); 16 x kernel B on the same columns "
            f"{r['b16_ms']:.4f} ms" + (f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r else "")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def shoup_line(r) -> str:
    return (f"kernel D {r['label']} sv {r['sv']} db+shoup {r['db']} ({r['bits']}-bit moduli): "
            f"bit-equal to plain (max_abs_err {r['max_abs_err']}); {r['ms']:.4f} ms "
            f"({r['gb_per_s']:.1f} GB/s)"
            + (f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r else "")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="import pir_tpu_torch from this checkout")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    if __spec__ is None:  # run as a file: its own directory must not shadow modules
        sys.path.pop(0)
    sys.path.insert(0, args.root or str(pathlib.Path(__file__).resolve().parents[1]))
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 1
    import pir_tpu_torch

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    from pir_tpu_torch import kernels

    for k in kernels.REGISTRY.values():
        k.lib()
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{args.label}] {k.name} ptxas: {line.strip()}", flush=True)
    ntt = time_ntt(device, gen)
    large = time_ntt_large(device, gen)
    served = time_ntt_served(device, gen)
    served_ct = time_ntt_served(device, gen, ct_mult=True)
    scan = time_scan(device, gen)
    wide = time_wide(device, gen)
    shoup = time_shoup(device, gen)
    keyswitch = time_keyswitch(device, gen) if hasattr(kernels, "KEYSWITCH") else []
    upper = time_upper(device, gen) if hasattr(kernels, "UPPER") else []
    behz = time_behz(device, gen) if hasattr(kernels, "BEHZ") else []
    request_ms, request_bound_ms = request_sums(ntt)
    result = {"label": args.label, "package": pir_tpu_torch.__file__, "card": card,
              "ntt": ntt, "ntt_large": large, "ntt_served": served,
              "ntt_served_ct_mult": served_ct, "scan": scan, "wide": wide, "shoup": shoup,
              "keyswitch": keyswitch, "upper": upper, "behz": behz,
              "ntt_request_ms": request_ms, "ntt_request_bound_ms": request_bound_ms}
    for line in ([ntt_line(r) for r in ntt + large + served + served_ct]
                 + [scan_line(r) for r in scan]
                 + [wide_line(r) for r in wide] + [shoup_line(r) for r in shoup]
                 + [keyswitch_line(r) for r in keyswitch + upper]
                 + [behz_line(r) for r in behz]):
        print(f"[{args.label}] {line}", flush=True)
    print(f"[{args.label}] kernel A over one request's 22 launches: "
          f"{request_ms:.4f} ms (bound {request_bound_ms:.4f}); {card}")
    for mode, rows in (("", served), ("ct-mult ", served_ct)):
        launches, served_ms, served_bound_ms = served_sums(rows)
        print(f"[{args.label}] kernel A over one N={SERVED_N} {mode}request's {launches} "
              f"launches: {served_ms:.4f} ms (bound {served_bound_ms:.4f}); {card}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
