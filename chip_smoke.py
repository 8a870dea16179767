"""Drive pir_tpu_torch on one CUDA card: build its kernels, check each against
its plain PyTorch version, then serve SealPIR requests at the benchmark
configuration — single and batched, on SEAL's chain and on the tpu32
profile, on the planes and on the Shoup-table database, and on meshes of
ranks that share the card — then in ciphertext-multiplication mode and at
the rings above N=4096, through process_stream, from a checkpoint, on a
mesh whose ranks load only their shard and at N=32768 in both modes, and
check every retrieved item.

    python3 chip_smoke.py               # 2^20 items of 288 B, d=2, N=4096

Phases, each of which raises on failure:

1. the card's name and power limit (nvidia-smi);
2. build kernels A (NTT), B (scan), C (wide scan) and D (Shoup-table scan)
   from pir_tpu_torch/csrc with nvcc and the native bulk encoder
   (pir_tpu_torch/native/encoder.cpp) with g++, all at once;
3. each kernel against its plain version on the card, bit for bit, at the
   shapes the main paths give it, with both times and the bound: A at each
   of the 22 launches of a single-query request (the per-request sums of
   time and bound on a line of their own) and at N=256 (K3's ring); B at a
   2^20-item request's inner and upper scans with a hi plane (K1: SEAL's
   chain, a u8 plane at N=4096 and a u16 plane at N=8192) and without (K5,
   tpu32, N=4096 and 8192); C at a 16-query batch's S = 32 columns with a
   hi plane (K4) and without (K4-u32), at N=4096 and 8192, beside 16 calls
   of kernel B on the same columns, with GB/s of database planes
   (kernel_times.time_wide); B's runtime-moduli entry
   (K6) at the shapes of one rank of the limb-sharded meshes below; D (K7)
   at the inner scan of the Shoup-table database at N=4096, on SEAL's chain
   and on a chain of 60-bit moduli (above the planes' 48 bits, where its
   sums fold), at phase 13's ct-mult inner scan (N=8192, db and companions
   6.8 GB; the plain version a few prefixes at a time), at N=16384
   (a 2^20-item request's inner scan and phase 14's) and at N=32768
   (phase 20's inner scan [57, 57, 15, 32768], db and companions 25.5 GB,
   every prefix compared, a few at a time), and at phase 19's rank block of
   the N=8192 ct-mult inner scan (57 of its 114 prefixes);
4. a small database (N=256) served on the card and on the CPU (plain
   versions): the Response bytes must be equal, and the card's request must
   have launched kernel A (the K3 row's launches);
5. the benchmark configuration (288-byte items, d=2, N=4096, 24-bit plain
   modulus, SEAL's BFVDefault chain, database from seed 42, client seed 7,
   seeded queries, replies mod-switched by reply_limbs_for): three requests
   through PirServer.process_request, each reply decoded and compared with
   the item; the kernels' launch counts over those requests must be > 0;
6. indexing at full size: the benchmark data repeats a pool of 4,096 items,
   so rows 512 plaintexts apart hold equal bytes and a wrong row could still
   decode to the right item.  A second database of the same size with each
   item's index stamped into its first 4 bytes serves three more requests
   (two of them 512 plaintexts apart), each of which must decode to its item;
7. batched serving on the stamped database: one process_request_batched
   request of 18 queries (a chunk of 16 lanes and a ragged tail of 2) must
   launch kernel C and decode every item; each of its first 16 queries, sent
   alone in a Request with the same keys, must give the same reply bytes.
   Latency and queries/s of a 16-query batch against those 16 single-query
   requests, and the batch's peak device memory;
8. the tpu32 profile (three 26-bit primes, a 30-bit special prime, no hi
   plane) on a stamped 2^20-item database: a batched request of 16 queries
   and the 16 single-query requests of its queries, every item decoded, the
   same bytes both ways; kernel B's and kernel C's single-word variants must
   have run.  The same latencies and peak memory;
9. the Shoup-table database (scan_impl="xla") of the stamped items: three
   requests, each Response byte-equal to the planes database's, every item
   decoded; kernel D must have run;
10. the mesh on the one card: 4 ranks (db=2 x batch=1 x limb=2, gloo, each
   its own process on cuda:0) serve one request of 2 queries on the stamped
   SEAL database; every rank's Response must equal the single-device
   server's byte for byte and decode; the ranks must have launched K6 and
   kernel A.  Then 3 ranks (limb=3) on the tpu32 database, through K6's
   single-word variant.  The latency is of co-located ranks over gloo on
   one card, not a multi-GPU figure.  Each rank's device memory once its
   server holds only its shard, and its peak over the build and requests;
11. kernel A at the rings above N=4096 (run right after phase 3, while the
   card holds nothing else), forward and inverse, bit-equal to its plain
   version (tolerance 0; the plain version run a quarter GB of input at a
   time) and timed with its bound, at the shapes a 2^20-item request gives
   it (kernel_times.large_ring_shapes): the first and the last expansion
   level's key-switch NTT at N=8192 (SEAL's chain), 16384 and 32768 (SEAL's
   chains and tpu32), and one ciphertext-multiplication step's NTTs over
   the 60-bit BEHZ base at N=8192, 16384 and 32768 (the lift [2 rows, L + 1,
   N] and the tensor product [3 rows, L + 1, N]); then at every launch of
   phase 20's served request (kernel_times.served_ntt_launches: each
   expansion level's key-switch NTT and INTT in its steps, the selection
   vector, the inner INTT, the digit plaintexts' NTT and the upper INTT in
   their steps), of phase 22's (the expansion, then per upper-level step
   bfv_multiply's lifts and products over q and Bsk and relinearize's key
   switch) and of a query of phase 14's N=16384 ciphertext-multiplication
   row, with the sums over a request beside their bounds.  Every row gives its time, bound and
   share of the bound; at N=16384 and 32768, where kernel A holds a limb in
   one thread-block cluster, also the cluster's CTAs and how many clusters
   the card holds at once (a cluster that cannot be resident fails);
12. ciphertext-multiplication mode at the reference's own rows
   (REFERENCE_MATRIX of tests/test_correctness.py: N=4096 d=1 and d=2,
   N=8192 d=2): every item decoded, each reply's invariant noise budget
   printed and > 0; the N=4096 d=2 row also served on the CPU (plain
   versions), its Response bytes equal to the card's.  Launches of kernel
   A's growing and reducing butterflies (the BEHZ base) and of kernel D;
13. ciphertext-multiplication mode at real size: N=8192, SEAL's chain, the
   bench's 24-bit t, 2^20 stamped items of 288 B, d=2 (dims 114 x 114,
   12,946 plaintexts in NTT form + Shoup companions on the card), replies
   mod-switched by reply_limbs_for: three requests, each decoded to its
   stamped item, with each reply's noise budget, the warm latency and the
   peak device memory;
14. decomposition mode at the larger rings, every item decoded: the
   TPU32_MATRIX N=8192 row (kernel B without a hi plane at N=8192), the same
   database on SEAL's N=8192 chain (planes with a u16 hi plane) and on
   SEAL's N=16384 chain (49-bit primes: the Shoup-table layout, kernel D);
   then the same N=16384 database in ciphertext-multiplication mode (8 ct
   limbs, a 9-limb BEHZ base: kernel A's 4-CTA clusters growing over q,
   reducing over Bsk), every item decoded, every reply's budget > 0, and
   kernel A's reducing launches the served count of phase 11 a query.
15. stream serving on phase 6's stamped 2^20-item server: 12 single-query
   requests at distinct indexes served one by one with process_request,
   then (after one untimed stream that sets up the streams and their
   pinned buffers) through process_stream at depth 4 and at depth 6, under
   torch.cuda.set_sync_debug_mode("error") (a synchronizing call on the
   request path fails the phase): the three Response sets byte-equal,
   every item decoded, the in-flight count at the depth; then 4 batched
   requests of 4 queries streamed at depth 3 (kernel C launched, every
   item decoded, byte-equal to process_request).  Sequential and streamed
   queries/s beside the card's name and power limit, and the streams' peak
   device memory.  Then the failure path: a stream whose third request has
   no Galois keys yields two Responses equal to the sequential ones and
   raises ValueError, and the server then serves a new stream correctly;
16. persistence: a 2^16-item stamped database at the benchmark
   configuration (cut from 2^20: compressing a 2^20-item checkpoint, ~2.6
   GB of which 1.7 GB are incompressible NTT words, takes minutes) saved
   with PirDatabase.save, then loaded into the planes layout and into the
   Shoup-table layout; one request each, Response byte-equal to the
   directly built database's, kernels B and D launched; the save and load
   seconds and the file size;
17. the shard-loaded mesh: PirDatabase.ingest_shards writes the stamped
   2^20-item database into 2 shard files, and 4 gloo ranks (db=2 x limb=2
   on the card, as phase 10) each load only their shard's rows
   (parallel.distributed.planes_from_shard_rows); every rank's Response
   equals the single-device server's, K6 launched, and each rank's peak
   device memory is below every phase-10 rank's (those build the whole
   database first);
18. the SEAL 3.5 wire at the benchmark configuration's shape (2^20 stamped
   items of 288 B, d=2, N=4096, SEAL's chain, replies at reply_limbs_for) on
   the reference's legacy re-encode digits (SEAL clients and servers refuse
   the bench's balanced digits for d > 1) and SEAL's default 20-bit t (at
   the bench's 24 bits the legacy digits leave the reply no noise budget),
   wire_format="auto", a
   PirClient(wire_format="seal"): three single-query SEAL requests (every
   reply blob a SEAL stream, every item decoded), a batched request of 16
   SEAL queries (kernel C; each reply byte-equal to its query alone), 6 SEAL
   requests streamed at depth 4 under set_sync_debug_mode("error")
   (byte-equal to sequential), and the same query arrays in the native
   codec (reply arrays equal to the SEAL ones); the first SEAL request's
   latency, which includes the SEAL key set's load (seeded c1 expanded with
   SEAL's BLAKE2 PRNG on the host), the warm SEAL and native latencies and
   both key loads' host seconds;
19. ciphertext-multiplication mode on meshes of gloo ranks sharing the
   card, every rank's Response byte-equal to the single-device server's:
   (b) CT_MULT_REFERENCE_ROWS' N=4096 d=2 row, both its indexes in one
   request, on db=2 x batch=2 (4 ranks); (a) phase 13's deployment (its
   server answers a 2-query request, then is freed) on db=2 (2 ranks, each
   its block of D0 = 57 of 114 rows through kernel D).  Kernel D and
   kernel A's growing and reducing butterflies must have run; latency
   (slowest rank) and each rank's held and peak device memory;
20. a served request at N=32768 (K3's ring on the TPU): 2^20 stamped items
   of 288 B, d=2 (dims 57 x 57, 3,207 plaintexts), the bench's 24-bit t on
   SEAL's 55/56-bit chain, so the Shoup-table layout, 25.55 GB of NTT words
   and companions on the card (not cut); database seed 42, client seed 7
   on the card, seeded queries, native wire, replies at reply_limbs_for.
   The items packed by the native encoder and by pack_items (equal), the
   database built (native pack, NTT and companions) with its set-up peak;
   client keygen, the Request's bytes (1.9 GB of Galois keys) and its
   serialize and parse seconds; 3 single-query requests, every item
   decoded, every reply budget and recomposed inner budget > 0, first and
   warm latency, a request's peak device memory, and the launches of
   kernel A (reducing butterflies: 3 x kernel_times.served_ntt_launches'
   count) and kernel D (one a request); then one more warm request in
   synchronized stages (profile_request.staged_request), byte-equal;
21. packed transfer on phase 6's stamped server: the same query arrays
   served with packed_transfer=True (the default: queries and replies as
   u32 lo + u8 hi words) and by a server with packed_transfer=False on the
   same database — 3 single-query, a 16-query batched (kernel C) and 6
   streamed requests (depth 4, under set_sync_debug_mode("error")) — the
   Responses byte-equal; each mode's warm latencies;
22. ciphertext-multiplication mode at N=32768, after phase 20's database
   is freed: the same 2^20 stamped items, d=2 (dims 57 x 57, from
   create_pir_parameters as in phase 20), SEAL's 15 x 55-bit chain, the
   bench's t, database seed 42, client seed 7, seeded queries, replies at
   reply_limbs_for; the database packed and built anew (25.55 GB of NTT
   words and companions, set-up peak), the client's keys, the native-wire
   Request's bytes (under protobuf's 2 GiB limit, or the phase fails) and
   its serialize/parse seconds; 3 requests at [2^20 // 3, 7, 2^20 - 1],
   every item decoded, every reply budget > 0, first and warm latency, a
   request's peak device memory above the database and keys held (the
   upper level multiplies in scan.CTMULT_STEP_BYTES steps), kernel A's
   reducing launches (3 x phase 11's served ct-mult count, the BEHZ base's
   among them) and kernel D's (one a request); then a warm request in
   synchronized stages (profile_request.staged_request: the BEHZ multiply
   and the relinearization apart), byte-equal.

Phase 5 also prints the invariant noise budget of each decomposition
reply at reply_limbs_for, which must be > 0, and of the inner ciphertexts
the client recomposes from it (PirClient.reply_noise_budgets; their noise
does not depend on reply_limbs, and the decoded items show that they
decrypt).

Bounds (pir_tpu_torch/kernel_times.py): the least time for a kernel's work
on an H100 SXM — the larger of its bytes (each input read once, each output
written once) at 3.35 TB/s and its 32-bit integer multiply instructions at
16.75 T/s (the on-chip guide's 67 TFLOP/s float32 rate is 128 lanes per SM;
Hopper has 64 INT32 lanes per SM), counted for the arithmetic the kernel
runs (12 multiplies a butterfly of kernel A where it grows, every modulus
below 2^min(50, 63 - log2 N); 16 where it reduces; 7 a scan product with a
hi plane, 3 without).  Kernel
times are device times of back-to-back launches queued behind a
device-side sleep.  No single PyTorch
call computes a modular contraction or a negacyclic NTT, so library_ms is
null for every kernel.

The line before the last is {"kernels": [...]}, one row per KERNEL_ROWS
entry (every TPU kernel body of pir_tpu/ops/pallas_*.py): its launches
summed over the served paths named in the row, its numbers from the named
check (K3's from phase 20's selection-vector NTT at N=32768, its
launches the N=256 path's and phases 20 and 22's: a check's launches are
not counted); the last line is
{"ok": true, "device": {...}}.  Without a CUDA card the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from pir_tpu_torch import kernel_times as kt

ITEM_SIZE = 288
DIMENSIONS = 2
POLY_DEGREE = 4096
PLAIN_BITS = 24
LOG2_ITEMS = 20
DB_SEED = 42
CLIENT_SEED = 7
POOL_ITEMS = 4096  # distinct random items the benchmark data repeats
BATCH_QUERIES = 18  # one chunk of 16 lanes and a ragged tail of 2
MESH_TIMEOUT_S = 420
STREAM_REQUESTS = 12  # phase 15: single-query requests a stream serves
STREAM_DEPTHS = (4, 6)
STREAM_BATCHES = 4  # phase 15: batched requests of STREAM_BATCH queries, at depth 3
STREAM_BATCH = 4
LOG2_CHECKPOINT_ITEMS = 16  # phase 16's database
# phase 18: SEAL's default plain modulus at N=4096 (0xFC001).  With the
# reference's legacy re-encode digits (5 bits wider than the balanced ones
# at 24 bits) the bench's 24-bit t leaves a 2^20-item reply no noise budget
SEAL_PLAIN_BITS = 20
PROTOBUF_LIMIT = 2**31 - 1  # bytes of one protobuf message


class KernelRow(NamedTuple):
    name: str
    source: str  # under pir_tpu_torch/csrc/
    replaces: "tuple[str, ...]"  # the TPU kernel bodies (file:line of their def)
    launches: "tuple[tuple[str, str], ...]"  # (served path, counted variant)
    check: str  # which kernel check gives its numbers


# One row per TPU kernel body that pl.pallas_call reaches in pir_tpu/ops/
# (tests/test_torch_kernel_table.py holds the table to the source).
KERNEL_ROWS = (
    KernelRow("scan (K1)", "scan.cu", ("pir_tpu/ops/pallas_scan.py:103",),
              (("single", "pir_scan.hi"), ("seal8192", "pir_scan.hi"),
               ("stream", "pir_scan.hi"), ("load_planes", "pir_scan.hi"),
               ("seal_single", "pir_scan.hi"), ("seal_batched", "pir_scan.hi"),
               ("seal_stream", "pir_scan.hi"), ("packed", "pir_scan.hi")), "K1"),
    KernelRow("ntt (K2)", "ntt.cu", ("pir_tpu/ops/pallas_mxu_ntt.py:252",),
              (("single", "pir_ntt.grow"), ("ctmult_ref", "pir_ntt.grow"),
               ("ctmult_ref", "pir_ntt.reduce"), ("ctmult", "pir_ntt.grow"),
               ("ctmult", "pir_ntt.reduce"), ("tpu32_8192", "pir_ntt.grow"),
               ("seal8192", "pir_ntt.grow"), ("seal16384", "pir_ntt.grow"),
               ("stream", "pir_ntt.grow"), ("stream_batched", "pir_ntt.grow"),
               ("load_planes", "pir_ntt.grow"), ("load_shoup", "pir_ntt.grow"),
               ("shard_mesh", "pir_ntt.grow"), ("seal_single", "pir_ntt.grow"),
               ("seal_batched", "pir_ntt.grow"), ("seal_stream", "pir_ntt.grow"),
               ("ctmult_ref_mesh", "pir_ntt.grow"), ("ctmult_ref_mesh", "pir_ntt.reduce"),
               ("ctmult_mesh", "pir_ntt.grow"), ("ctmult_mesh", "pir_ntt.reduce"),
               ("packed", "pir_ntt.grow"), ("ctmult16384", "pir_ntt.grow"),
               ("ctmult16384", "pir_ntt.reduce")), "K2"),
    KernelRow("ntt (K3; the N=256 and the served N=32768 paths)", "ntt.cu",
              ("pir_tpu/ops/pallas_ntt.py:147",),
              (("small", "pir_ntt.grow"), ("n32768", "pir_ntt.reduce"),
               ("n32768_ctmult", "pir_ntt.reduce")), "K3"),
    KernelRow("scan_wide (K4)", "scan_wide.cu", ("pir_tpu/ops/pallas_scan.py:397",),
              (("batched", "pir_scan_wide.hi"), ("seal8192", "pir_scan_wide.hi"),
               ("stream_batched", "pir_scan_wide.hi"), ("seal_batched", "pir_scan_wide.hi"),
               ("packed", "pir_scan_wide.hi")),
              "K4"),
    KernelRow("scan_wide u32 (K4-u32)", "scan_wide.cu", ("pir_tpu/ops/pallas_scan.py:422",),
              (("tpu32", "pir_scan_wide.u32"), ("tpu32_8192", "pir_scan_wide.u32")), "K4-u32"),
    KernelRow("scan u32 (K5)", "scan.cu", ("pir_tpu/ops/pallas_scan.py:167",),
              (("tpu32", "pir_scan.u32"), ("tpu32_8192", "pir_scan.u32")), "K5"),
    KernelRow("scan dyn (K6)", "scan.cu",
              ("pir_tpu/ops/pallas_scan.py:204", "pir_tpu/ops/pallas_scan.py:187"),
              (("mesh", "pir_scan.hi.dyn"), ("mesh32", "pir_scan.u32.dyn"),
               ("shard_mesh", "pir_scan.hi.dyn")), "K6"),
    KernelRow("scan_shoup (K7)", "scan_shoup.cu", ("pir_tpu/ops/pallas_scan.py:32",),
              (("shoup", "pir_scan_shoup"), ("ctmult_ref", "pir_scan_shoup"),
               ("ctmult", "pir_scan_shoup"), ("seal16384", "pir_scan_shoup"),
               ("load_shoup", "pir_scan_shoup"), ("ctmult_ref_mesh", "pir_scan_shoup"),
               ("ctmult_mesh", "pir_scan_shoup"), ("n32768", "pir_scan_shoup"),
               ("ctmult16384", "pir_scan_shoup"), ("n32768_ctmult", "pir_scan_shoup")), "K7"),
)

# ciphertext-multiplication rows of REFERENCE_MATRIX (tests/test_correctness.py):
# (N, plain-modulus bits, item bytes (0: a whole plaintext), bits per
# coefficient (0: the most), items, d, indexes)
CT_MULT_REFERENCE_ROWS = (
    (4096, 16, 289, 10, 1200, 1, [0, 47, 777, 1199]),
    (4096, 16, 0, 6, 500, 2, [9, 125]),
    (8192, 42, 0, 0, 87, 2, [5, 33, 86]),
)
CT_MULT_CPU_ROW = 1  # the N=4096 d=2 row, served on the CPU as well
CT_MULT_POLY_DEGREE = 8192  # phase 13: ciphertext-multiplication mode at real size
# phase 14: TPU32_MATRIX's N=8192 row (tests/test_correctness.py) on three
# chains and layouts, and in ciphertext-multiplication mode on SEAL's
# N=16384 chain: (path, N, profile, scan_impl, ct-mult, the variants it
# must launch)
LARGE_RING_ROW = (0, 0, 87, 2, [5, 33, 86])  # item bytes, bits per coeff, items, d, indexes
# (the 3-query requests' inner scans run kernel C, their upper scans kernel B)
LARGE_RING_CASES = (
    ("tpu32_8192", 8192, "tpu32", "auto", False,
     ("pir_ntt.grow", "pir_scan.u32", "pir_scan_wide.u32")),
    ("seal8192", 8192, "seal", "pallas", False,
     ("pir_ntt.grow", "pir_scan.hi", "pir_scan_wide.hi")),
    ("seal16384", 16384, "seal", "auto", False, ("pir_ntt.grow", "pir_scan_shoup")),
    ("ctmult16384", 16384, "seal", "auto", True,
     ("pir_ntt.grow", "pir_ntt.reduce", "pir_scan_shoup")),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def add_counts(total: dict, counts: dict) -> dict:
    """Add one run's launch counts into `total`."""
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


NUMBERS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")  # of a kernels-line row


def check_ntt(device, gen) -> dict:
    """Kernel A vs its plain version (tolerance 0), with its round trip, at
    every shape one single-query request launches it with
    (kernel_times.ntt_request_shapes: the key switch's NTT and INTT at each
    of the 9 expansion levels, the selection vector, both scans' INTTs and
    the digit plaintexts), timed on the card, and at N=256 (K3's ring, the
    small database served below).  Returns the K2 headline ([648, 2, 4096]
    forward, the selection vector)."""
    heads = {("selection vector", False): "K2"}
    rows = kt.time_ntt(device, gen, plain=heads)
    for r in rows:
        log(kt.ntt_line(r))
    request_ms, request_bound_ms = kt.request_sums(rows)
    log(f"kernel A over the 22 launches of one single-query request: sum of times "
        f"{request_ms:.4f} ms, sum of bounds {request_bound_ms:.4f} ms "
        f"({request_bound_ms / request_ms:.1%} of bound)")
    return {heads[r["label"], r["inverse"]]: {k: r[k] for k in NUMBERS}
            for r in rows if (r["label"], r["inverse"]) in heads}


def check_ntt_large(device, gen) -> "tuple[dict, dict]":
    """Kernel A above N=4096 (kernel_times.time_ntt_large, the BEHZ base's
    lift and tensor-product shapes at N=8192, 16384 and 32768 among them),
    at every launch of phase 20's served request and of phase 22's
    ciphertext-multiplication request (kernel_times.time_ntt_served), and at
    every launch of the N=16384 ciphertext-multiplication row of phase 14:
    every shape bit-equal to the plain version, timed with its bound, and
    each served request's sums.  Returns the K3 headline, the served
    selection vector's NTT [228, 15, 32768] on SEAL's chain, and kernel A's
    reducing launches a request by path: phase 20's ("n32768") and phase
    22's ("n32768_ctmult") every launch, the N=16384 row's ("ctmult16384",
    a query) those over the BEHZ base, the only chain there above the
    growing rule's 49 bits."""
    head = ("selection vector", False)
    rows = kt.time_ntt_large(device, gen)
    served = kt.time_ntt_served(device, gen, plain={head})
    served_ct = kt.time_ntt_served(device, gen, ct_mult=True)
    row16384 = large_ring_params(16384, "seal", ct_mult=True).dimensions
    served_16384 = kt.time_ntt_served(device, gen, n=16384, ct_mult=True, dims=row16384)
    for r in rows + served + served_ct + served_16384:
        log(kt.ntt_line(r))
    launches = {}
    for path, label, n, request in (
            ("n32768", "request", kt.SERVED_N, served),
            ("n32768_ctmult", "ciphertext-multiplication request (2^20 items)", kt.SERVED_N,
             served_ct),
            ("ctmult16384", f"ciphertext-multiplication query (dims {row16384})", 16384,
             served_16384)):
        count, ms, bound_ms = kt.served_sums(request)
        bsk = sum(r["launches"] for r in request if r["chain"] == "bsk")
        log(f"kernel A over the {count} launches of one N={n} {label}: sum of times "
            f"{ms:.4f} ms, sum of bounds {bound_ms:.4f} ms ({bound_ms / ms:.1%} of bound); "
            f"{bsk} of them over the BEHZ base Bsk")
        launches[path] = sum(r["launches"] for r in request if not r["grow"])
    name = f"N={kt.SERVED_N} served {head[0]}"
    return {"K3": next({k: r[k] for k in NUMBERS} for r in served
                       if (r["label"], r["inverse"]) == (name, head[1]))}, launches


def check_scan(device, gen) -> dict:
    """Kernel B vs its plain version (tolerance 0) at the main paths' shapes
    (kernel_times.scan_cases): the inner and upper scans with a hi plane
    (K1, SEAL's chain) and without (K5, tpu32) at N=4096 and 8192, and its
    runtime-moduli entry (K6) at one rank's shapes — limb 1 of SEAL's chain
    on a db=2 x limb=2 mesh (planes [81, 1, 162, 4096], a hi plane) and one
    limb of tpu32 on a limb=3 mesh (no hi plane).  Returns the K1, K5 and K6
    headlines (N=4096's inner scans)."""
    heads = {"K1 inner": "K1", "K5 inner": "K5", "K6 seal rank": "K6"}
    rows = kt.time_scan(device, gen, plain=True)
    for r in rows:
        log(kt.scan_line(r))
    return {heads[r["label"]]: {k: r[k] for k in NUMBERS} for r in rows if r["label"] in heads}


def check_scan_wide(device, gen) -> dict:
    """Kernel C vs its plain version (tolerance 0) at a 2^20-item batched
    request's inner scan (16 lanes: S = 32 columns), with a hi plane (K4)
    and without (K4-u32), at N=4096 and 8192 (kernel_times.time_wide),
    beside 16 calls of kernel B on the same columns.  Returns the N=4096
    headlines."""
    heads = {"K4": "K4", "K4-u32": "K4-u32"}
    rows = kt.time_wide(device, gen, plain=True)
    for r in rows:
        log(kt.wide_line(r))
    return {heads[r["label"]]: {k: r[k] for k in NUMBERS} for r in rows if r["label"] in heads}


def check_scan_shoup(device, gen) -> dict:
    """Kernel D (K7) vs its plain version (tolerance 0), timed with its
    bound, at kernel_times.shoup_cases() — the Shoup-table inner scan at
    N=4096 on SEAL's chain (the headline, served below) and on two 60-bit
    moduli, phase 13's ct-mult inner scan (N=8192) and a 2^20-item inner
    scan at N=16384 — and at phase 14's N=16384 inner scan."""
    params = large_ring_params(16384, "seal")
    served = ("K7 N=16384 inner, phase 14", params.encryption_params.ct_modulus,
              *params.dimensions, 16384)
    rows = kt.time_shoup(device, gen, cases=kt.shoup_cases() + [served], plain=True)
    for r in rows:
        log(kt.shoup_line(r))
    return next({k: r[k] for k in NUMBERS} for r in rows if r["label"] == "K7 inner")


def check_small_against_cpu(device) -> dict:
    """A small database (N=256, K3's ring) served on the card and on the CPU
    (plain versions of the kernels) must give byte-identical Responses.
    Returns the card server's launch counts."""
    import pir_tpu_torch as pt
    from pir_tpu_torch import kernels
    from pir_tpu_torch.core import primes

    n = 256
    ep = pt.EncryptionParams(
        poly_modulus_degree=n,
        plain_modulus=primes.get_prime(2 * n, 16),
        coeff_modulus=tuple(primes.coeff_modulus_from_bits(n, [34, 36, 37])),
    )
    params = pt.create_pir_parameters(60, 64, 2, ep)
    rng = np.random.default_rng(3)
    raw = [rng.integers(0, 256, 64, dtype=np.uint8).tobytes() for _ in range(60)]
    client = pt.PirClient(params, seed=5, compress_queries=True, device="cpu")
    req = client.create_request([0, 37])
    server = pt.PirServer(pt.PirDatabase.create(raw, params, device=device), params)
    kernels.reset_launch_counts()
    responses = [server.process_request(req)]
    counts = kernels.variant_launch_counts()
    responses.append(pt.PirServer(pt.PirDatabase.create(raw, params, device="cpu"), params)
                     .process_request(req))
    if responses[0].SerializeToString() != responses[1].SerializeToString():
        raise AssertionError("card and CPU Responses differ on the small database")
    if client.process_response([0, 37], responses[0]) != [raw[0], raw[37]]:
        raise AssertionError("small database retrieval failed on the card")
    log(f"small database (N=256, d=2): card Response bytes == CPU Response bytes; "
        f"items retrieved; card launches {counts}")
    require(counts, ("pir_ntt.grow",), "N=256")
    return counts


def serve_bench_config(device, log2_items: int):
    import pir_tpu_torch as pt
    from pir_tpu_torch import kernels

    db_size = 1 << log2_items
    t0 = time.perf_counter()
    params = pt.create_pir_parameters(
        db_size, ITEM_SIZE, DIMENSIONS,
        pt.generate_encryption_params(POLY_DEGREE, PLAIN_BITS),
    )
    rng = np.random.default_rng(DB_SEED)
    pool = [rng.integers(0, 256, ITEM_SIZE, dtype=np.uint8).tobytes()
            for _ in range(min(db_size, POOL_ITEMS))]
    raw = [pool[i % len(pool)] for i in range(db_size)]
    db = pt.PirDatabase.create(raw, params, device=device)
    torch.cuda.synchronize()
    log(f"database: {db_size} items of {ITEM_SIZE} B, dims {params.dimensions}, "
        f"{params.num_pt} plaintexts, planes on {device} in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    client = pt.PirClient(params, seed=CLIENT_SEED, compress_queries=True, device="cpu")
    reply_limbs = pt.reply_limbs_for(params)
    server = pt.PirServer(db, params, reply_limbs=reply_limbs)
    indexes = [db_size // 3, 7, db_size - 1]
    requests = [client.create_request([i]) for i in indexes]
    log(f"client keys + 3 seeded requests on the CPU in "
        f"{time.perf_counter() - t0:.2f} s; reply_limbs={reply_limbs}")

    kernels.reset_launch_counts()
    latencies = []
    responses = []
    for req in requests:
        t0 = time.perf_counter()
        responses.append(server.process_request(req))  # ends with a host copy
        latencies.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.variant_launch_counts()

    for idx, resp in zip(indexes, responses):
        if client.process_response([idx], resp)[0] != raw[idx]:
            raise AssertionError(f"retrieval of item {idx} failed")
    log(f"served 3/3 requests at indexes {indexes}: every item retrieved "
        f"correctly; reply {len(responses[0].reply[0].ct)} ciphertexts")
    budgets = [client.reply_noise_budgets(resp.reply[0]) for resp in responses]
    if min(b[0] for b in budgets) <= 0:
        raise AssertionError(f"a reply at reply_limbs={reply_limbs} has no noise budget left: "
                             f"{budgets}")
    log(f"noise budget (bits) of each reply at reply_limbs={reply_limbs}, [its ciphertexts, "
        f"the inner ciphertexts recomposed from them]: {budgets} (0: under one bit of margin, "
        f"still decrypting, as every retrieved item shows)")
    log(f"request latency: first {latencies[0]:.2f} ms, then "
        f"{', '.join(f'{x:.2f}' for x in latencies[1:])} ms")
    log(f"kernel launches during the 3 requests: {counts}")
    require(counts, ("pir_ntt.grow", "pir_scan.hi"), "single-query")
    return counts, params, client, raw


def stamped_items(raw) -> list:
    """The items with each one's index in its first 4 bytes: no two equal."""
    items = np.frombuffer(b"".join(raw), dtype=np.uint8).reshape(len(raw), ITEM_SIZE).copy()
    items[:, :4] = np.arange(len(raw), dtype="<u4").view(np.uint8).reshape(-1, 4)
    return [row.tobytes() for row in items]


def check_full_size_indexing(device, params, client, raw):
    """Serve a database in which no two items are equal, at the benchmark's
    size, and check three retrievals (two of them one period of the
    benchmark data's equal plaintexts apart).  Returns the server and items."""
    import pir_tpu_torch as pt

    stamped = stamped_items(raw)
    t0 = time.perf_counter()
    db = pt.PirDatabase.create(stamped, params, device=device)
    server = pt.PirServer(db, params, reply_limbs=pt.reply_limbs_for(params))
    torch.cuda.synchronize()
    log(f"stamped database (item index in bytes 0-3) built in "
        f"{time.perf_counter() - t0:.2f} s")
    # items this far apart fill equal plaintexts in the benchmark data
    period = math.lcm(POOL_ITEMS, params.items_per_plaintext)
    base = len(raw) // 3
    indexes = [base, (base + period) % len(raw), len(raw) - 1]
    for idx in indexes:
        got = client.process_response([idx], server.process_request(client.create_request([idx])))[0]
        if got != stamped[idx]:
            stamp = int.from_bytes(got[:4], "little")
            raise AssertionError(f"stamped retrieval of item {idx} returned item {stamp}")
    log(f"stamped database: 3/3 requests at indexes {indexes} retrieved their own item")
    return server, stamped


def single_query_request(request, qi):
    """A Request holding only query qi of `request`, with the same keys."""
    from pir_tpu_torch.proto import payload_pb2 as pb

    one = pb.Request(galois_keys=request.galois_keys, relin_keys=request.relin_keys)
    one.query.add().CopyFrom(request.query[qi])
    return one


def timed(fn):
    t0 = time.perf_counter()
    out = fn()  # every path ends with the replies' host copy
    return out, (time.perf_counter() - t0) * 1e3


def check_items(client, indexes, response, items, label) -> None:
    got = client.process_response(indexes, response)
    for idx, item in zip(indexes, got):
        if item != items[idx]:
            stamp = int.from_bytes(item[:4], "little")
            raise AssertionError(f"{label}: item {idx} came back as item {stamp}")


def serve_batched(server, client, items, indexes, label: str) -> dict:
    """One process_request_batched request of len(indexes) queries, every
    item checked; then each of its first 16 queries alone (same keys), whose
    reply bytes must equal the batch's, timed against a warm batch of those
    16.  Returns the batched request's launch counts, latencies and memory."""
    from pir_tpu_torch import kernels

    lanes = server.batch_lanes()
    request = client.create_request(indexes)
    torch.cuda.synchronize()
    base_mb = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    batched, first_ms = timed(lambda: server.process_request_batched(request))
    counts = kernels.variant_launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    check_items(client, indexes, batched, items, f"{label} batched")
    log(f"{label}: batched request of {len(indexes)} queries in lanes of {lanes} "
        f"({-(-len(indexes) // lanes)} passes, ragged tail {len(indexes) % lanes}): "
        f"every item retrieved; {first_ms:.2f} ms; launches {counts}")
    log(f"{label}: batched request peak device memory {peak_mb:.1f} MiB "
        f"({peak_mb - base_mb:.1f} MiB above the {base_mb:.1f} MiB held before)")

    n16 = min(16, len(indexes))
    singles_ms = []
    for qi in range(n16):
        resp, ms = timed(lambda: server.process_request(single_query_request(request, qi)))
        singles_ms.append(ms)
        if resp.reply[0].SerializeToString() != batched.reply[qi].SerializeToString():
            raise AssertionError(f"{label}: query {qi} alone differs from its batched reply")
        check_items(client, [indexes[qi]], resp, items, f"{label} single")
    request16 = client.create_request(indexes[:n16]) if n16 < len(indexes) else request
    _, batch16_ms = timed(lambda: server.process_request_batched(request16))
    seq_ms = sum(singles_ms)
    log(f"{label}: {n16} single-query requests, each byte-equal to its batched reply and "
        f"retrieved: {seq_ms:.2f} ms in all ({n16 / seq_ms * 1e3:.2f} queries/s; each "
        f"{min(singles_ms):.2f}-{max(singles_ms):.2f} ms)")
    log(f"{label}: warm batched request of {n16}: {batch16_ms:.2f} ms "
        f"({n16 / batch16_ms * 1e3:.2f} queries/s), {seq_ms / batch16_ms:.2f}x the "
        f"sequential rate")
    return counts


def serve_tpu32(device) -> dict:
    """The tpu32 profile on a stamped 2^20-item database: a batched request
    of 16 and the 16 single-query requests of its queries."""
    import pir_tpu_torch as pt

    db_size = 1 << LOG2_ITEMS
    ep = pt.generate_encryption_params(POLY_DEGREE, PLAIN_BITS, profile="tpu32")
    params = pt.create_pir_parameters(db_size, ITEM_SIZE, DIMENSIONS, ep)
    rng = np.random.default_rng(DB_SEED)
    pool = [rng.integers(0, 256, ITEM_SIZE, dtype=np.uint8).tobytes() for _ in range(POOL_ITEMS)]
    items = stamped_items([pool[i % POOL_ITEMS] for i in range(db_size)])
    t0 = time.perf_counter()
    db = pt.PirDatabase.create(items, params, device=device)
    torch.cuda.synchronize()
    if db.db_planes[0] is not None:
        raise AssertionError("the tpu32 database has a hi plane")
    reply_limbs = pt.reply_limbs_for(params)
    server = pt.PirServer(db, params, reply_limbs=reply_limbs)
    client = pt.PirClient(params, seed=CLIENT_SEED, compress_queries=True, device="cpu")
    log(f"tpu32 profile: ct moduli {[q.bit_length() for q in ep.ct_modulus]} bits, special "
        f"{ep.special_modulus.bit_length()} bits, reply_limbs={reply_limbs}; stamped "
        f"database of {db_size} items on {device} in {time.perf_counter() - t0:.2f} s")
    indexes = [(k * 65537 + 11) % db_size for k in range(15)] + [db_size - 1]
    return serve_batched(server, client, items, indexes, "tpu32"), (params, db, client, items)


def serve_shoup(device, params, client, items, planes_server) -> dict:
    """The Shoup-table layout (scan_impl="xla") of the stamped items: three
    requests, each Response equal to the planes server's, every item
    decoded.  Returns the launch counts of the three requests."""
    import pir_tpu_torch as pt
    from pir_tpu_torch import kernels

    t0 = time.perf_counter()
    db = pt.PirDatabase.create(items, params, scan_impl="xla", device=device)
    torch.cuda.synchronize()
    gb = (db.db_ntt.numel() + db.db_ntt_shoup.numel()) * 8 / 1e9
    log(f"Shoup-table database of the stamped items: db_ntt + db_ntt_shoup {gb:.2f} GB "
        f"on {device}, built in {time.perf_counter() - t0:.2f} s")
    server = pt.PirServer(db, params, reply_limbs=planes_server.reply_limbs)
    indexes = [5, len(items) // 2 + 3, len(items) - 2]
    requests = [client.create_request([i]) for i in indexes]
    kernels.reset_launch_counts()
    responses, latencies = [], []
    for req in requests:
        resp, ms = timed(lambda: server.process_request(req))
        responses.append(resp)
        latencies.append(ms)
    counts = kernels.variant_launch_counts()
    for idx, req, resp in zip(indexes, requests, responses):
        if resp.SerializeToString() != planes_server.process_request(req).SerializeToString():
            raise AssertionError(f"Shoup-table and planes Responses differ at item {idx}")
        check_items(client, [idx], resp, items, "Shoup-table layout")
    log(f"Shoup-table layout: 3/3 requests at {indexes} byte-equal to the planes "
        f"database's and retrieved; latency {', '.join(f'{x:.2f}' for x in latencies)} ms; "
        f"launches {counts}")
    require(counts, ("pir_ntt.grow", "pir_scan_shoup"), "Shoup-table")
    del server, db
    torch.cuda.empty_cache()
    return counts


def run_mesh(device, label, params, items, request, want, n_db, batch, limb,
             shard_dir=None, scan_impl="pallas", reply_limbs=None):
    """Serve `request` twice (first, then warm) on a mesh of gloo ranks that
    all run on `device` (one process each, pir_tpu_torch.parallel.mesh_worker):
    every rank's Response must equal `want` (the single-device server's
    bytes).  With shard_dir (an ingest_shards checkpoint of the
    items) each rank loads only its own rows.  Logs the latencies (slowest
    rank) and each rank's held and peak device memory; returns the warm
    request's launch counts summed over the ranks, and each rank's peak
    device memory in MiB."""
    import tempfile

    from pir_tpu_torch.parallel import mesh_worker
    from pir_tpu_torch.pir import wire

    world = n_db * batch * limb
    case = {
        "name": label, "params": wire.pir_params_to_proto(params).SerializeToString(),
        "scan_impl": scan_impl, "batch": batch, "limb": limb, "reply_limbs": reply_limbs,
        "requests": [request.SerializeToString()] * 2,
    }
    if shard_dir is None:
        case["items"] = b"".join(items)
    else:
        case["shard_dir"] = str(shard_dir)
    job = {"world": world, "backend": "gloo", "devices": [str(device)] * world,
           "timeout_s": MESH_TIMEOUT_S, "cases": [case]}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        results = mesh_worker.run_job(job, tmp, MESH_TIMEOUT_S)
    total_s = time.perf_counter() - t0
    counts = {}
    for rank, res in enumerate(results):
        got = res[label]
        if not res["replicate_ok"] or any(r != want for r in got["responses"]):
            raise AssertionError(f"{label} mesh: rank {rank}'s Response differs from single-device")
        add_counts(counts, got["counts"][-1])
    first = [res[label]["ms"][0] for res in results]
    warm = [res[label]["ms"][1] for res in results]
    held = ", ".join(f"{res[label]['held_mib']:.1f}" for res in results)
    peak = ", ".join(f"{res[label]['peak_mib']:.1f}" for res in results)
    log(f"{label} mesh: {world} ranks (db={n_db} x batch={batch} x "
        f"limb={limb}, gloo, co-located on one card — not a multi-GPU figure), request of "
        f"{len(request.query)} queries: every rank's Response byte-equal to the single-device "
        f"server's; latency first {max(first):.2f} ms, warm "
        f"{max(warm):.2f} ms (slowest rank); launches summed over ranks {counts}; "
        f"device memory per rank held after the build (its shard) [{held}] MiB, peak over "
        f"the build and the requests [{peak}] MiB; job {total_s:.2f} s with the ranks' "
        f"database {'loads' if shard_dir else 'builds'}")
    return counts, [res[label]["peak_mib"] for res in results]


def serve_mesh(device, label, params, client, items, db, indexes, n_db, batch, limb,
               shard_dir=None):
    """One request of len(indexes) queries on a mesh (run_mesh) against the
    single-device server of `db`, every item decoded.  Returns the launch
    counts summed over the ranks, and each rank's peak device memory."""
    import pir_tpu_torch as pt
    from pir_tpu_torch.proto import payload_pb2 as pb

    request = client.create_request(indexes)
    want = pt.PirServer(db, params).process_request(request).SerializeToString()
    out = run_mesh(device, label, params, items, request, want, n_db, batch, limb,
                   shard_dir=shard_dir)
    check_items(client, indexes, pb.Response.FromString(want), items, f"{label} mesh")
    return out


def serve_shard_mesh(device, params, client, items, db, indexes, whole_db_peaks) -> dict:
    """Phase 17: the stamped items ingested into 2 shard files, then 4 ranks
    (db=2 x limb=2) that each load only their shard's rows.  Every rank's
    peak device memory must be below every rank's of the whole-database
    mesh (`whole_db_peaks`).  Returns the launch counts summed over the
    ranks."""
    import tempfile

    import pir_tpu_torch as pt

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pt.PirDatabase.ingest_shards(iter(items), params, tmp, 2)
        sizes = sorted(f.stat().st_size for f in pathlib.Path(tmp).glob("shard_*.npy"))
        log(f"ingest_shards: {len(items)} stamped items into {len(sizes)} shard files of "
            f"{[round(x / 2**20, 1) for x in sizes]} MiB in {time.perf_counter() - t0:.2f} s")
        counts, peaks = serve_mesh(device, "shard-loaded", params, client, items, db, indexes,
                                   n_db=2, batch=1, limb=2, shard_dir=tmp)
    if max(peaks) >= min(whole_db_peaks):
        raise AssertionError(f"shard-loaded ranks peak at {peaks} MiB, not below the "
                             f"whole-database ranks' {whole_db_peaks} MiB")
    log(f"shard-loaded ranks' peak device memory {[round(x, 1) for x in peaks]} MiB against "
        f"{[round(x, 1) for x in whole_db_peaks]} MiB for the ranks that built the whole "
        f"database (phase 10)")
    return counts


def serve_stream(server, client, items, smi: str) -> dict:
    """Phase 15 on the stamped 2^20-item server.  Returns the launch counts
    of the depth-6 stream ("stream") and of the batched stream
    ("stream_batched")."""
    from pir_tpu_torch import kernels
    from pir_tpu_torch.proto import payload_pb2 as pb

    n = len(items)
    indexes = [(k * 87383 + 1001) % n for k in range(STREAM_REQUESTS)]
    requests = [client.create_request([i]) for i in indexes]
    server.process_request(requests[0])  # warm: the keys are cached on the device
    torch.cuda.synchronize()
    base_mb = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want = [server.process_request(r).SerializeToString() for r in requests]
    seq_s = time.perf_counter() - t0
    for idx, resp in zip(indexes, want):
        check_items(client, [idx], pb.Response.FromString(resp), items, "sequential")
    rates = [f"sequential {STREAM_REQUESTS / seq_s:.2f} queries/s"]
    list(server.process_stream(iter(requests), depth=max(STREAM_DEPTHS)))  # the streams' pools
    counts = {}
    for depth in STREAM_DEPTHS:
        kernels.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")  # a synchronizing call on the path raises
        try:
            t0 = time.perf_counter()
            got = [r.SerializeToString()
                   for r in server.process_stream(iter(requests), depth=depth)]
            dt = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
        counts = kernels.variant_launch_counts()
        if got != want:
            raise AssertionError(f"streamed Responses at depth {depth} differ from sequential")
        stats = server.stream_stats
        if stats["max_in_flight"] != depth:
            raise AssertionError(f"depth {depth}: at most {stats['max_in_flight']} in flight")
        rates.append(f"streamed depth {depth} {STREAM_REQUESTS / dt:.2f} queries/s "
                     f"(most reply copies pending {stats['max_device_pending']})")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    require(counts, ("pir_ntt.grow", "pir_scan.hi"), "stream")
    log(f"stream: {STREAM_REQUESTS} single-query requests at {indexes}, Responses byte-equal "
        f"sequential / depth {STREAM_DEPTHS[0]} / depth {STREAM_DEPTHS[1]}, every stamped item "
        f"retrieved, in-flight count at the depth; {'; '.join(rates)} ({smi}); peak device "
        f"memory {peak_mb:.1f} MiB ({peak_mb - base_mb:.1f} above the {base_mb:.1f} held); "
        f"depth-{STREAM_DEPTHS[1]} launches {counts}")

    groups = [[(k * 65599 + 17) % n for k in range(b * STREAM_BATCH, (b + 1) * STREAM_BATCH)]
              for b in range(STREAM_BATCHES)]
    batched = [client.create_request(g) for g in groups]
    want_b = [server.process_request(r).SerializeToString() for r in batched]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got_b = [r.SerializeToString() for r in server.process_stream(iter(batched), depth=3)]
    dt = time.perf_counter() - t0
    counts_b = kernels.variant_launch_counts()
    if got_b != want_b:
        raise AssertionError("batched streamed Responses differ from process_request's")
    for g, resp in zip(groups, got_b):
        check_items(client, g, pb.Response.FromString(resp), items, "batched stream")
    require(counts_b, ("pir_ntt.grow", "pir_scan_wide.hi"), "stream_batched")
    log(f"batched stream: {STREAM_BATCHES} requests of {STREAM_BATCH} queries at depth 3, "
        f"byte-equal to process_request, every item retrieved; "
        f"{STREAM_BATCHES * STREAM_BATCH / dt:.2f} queries/s ({smi}); launches {counts_b}")

    bad = pb.Request()
    bad.CopyFrom(requests[2])
    bad.galois_keys = b""
    got = []
    try:
        for resp in server.process_stream(iter([requests[0], requests[1], bad, requests[3]]),
                                          depth=3):
            got.append(resp.SerializeToString())
    except ValueError as e:
        failure = e
    else:
        raise AssertionError("a stream with a request without Galois keys did not raise")
    if got != want[:2]:
        raise AssertionError(f"the failing stream yielded {len(got)} Responses, not the 2 before it")
    again = [r.SerializeToString() for r in server.process_stream(iter(requests[:6]), depth=4)]
    if again != want[:6]:
        raise AssertionError("the server's next stream after a failure differs from sequential")
    log(f"stream failure path: 2 Responses equal to sequential, then ValueError({failure}); "
        f"the next stream of 6 byte-equal to sequential")
    return {"stream": counts, "stream_batched": counts_b}


def serve_packed(server, client, items, smi: str) -> dict:
    """Phase 21: the stamped server (packed_transfer=True) and a server
    with packed_transfer=False on the same database serve the same single,
    batched and streamed requests, in turns; the Responses must be equal.
    Returns the packed server's launch counts ("packed")."""
    import pir_tpu_torch as pt
    from pir_tpu_torch import kernels
    from pir_tpu_torch.proto import payload_pb2 as pb

    if server._hi_dtype is None:
        raise AssertionError("the bench server does not pack its transfers")
    unpacked = pt.PirServer(server.db, server.params, reply_limbs=server.reply_limbs,
                            packed_transfer=False)
    n = len(items)
    single_idx = [(k * 69997 + 123) % n for k in range(3)]
    singles = [client.create_request([i]) for i in single_idx]
    idx16 = [(k * 52711 + 29) % n for k in range(16)]
    batch = client.create_request(idx16)
    stream_idx = [(k * 31337 + 5) % n for k in range(6)]
    streamed = [client.create_request([i]) for i in stream_idx]
    for srv in (server, unpacked):  # keys cached, the streams' pinned buffers made
        srv.process_request(singles[0])
        list(srv.process_stream(iter(streamed), depth=4))

    def stream(srv):
        torch.cuda.set_sync_debug_mode("error")  # a synchronizing call on the path raises
        try:
            return [r.SerializeToString() for r in srv.process_stream(iter(streamed), depth=4)]
        finally:
            torch.cuda.set_sync_debug_mode("default")

    runs = {"single": lambda srv: [srv.process_request(r).SerializeToString() for r in singles],
            "batched": lambda srv: srv.process_request_batched(batch).SerializeToString(),
            "streamed": stream}
    counts, ms, outs = {}, {}, {}
    for kind, run in runs.items():
        got = {}
        for label, srv in (("packed", server), ("unpacked", unpacked),
                           ("unpacked", unpacked), ("packed", server)):
            kernels.reset_launch_counts()
            out, t = timed(lambda: run(srv))
            if label == "packed":
                add_counts(counts, kernels.variant_launch_counts())
            ms.setdefault((kind, label), []).append(t)
            if got.setdefault(label, out) != out:
                raise AssertionError(f"{kind}: the {label} server's two runs differ")
        if got["packed"] != got["unpacked"]:
            raise AssertionError(f"{kind}: packed and unpacked Responses differ")
        outs[kind] = got["packed"]
    for kind, idx, blobs in (("single", single_idx, outs["single"]),
                             ("streamed", stream_idx, outs["streamed"])):
        for i, blob in zip(idx, blobs):
            check_items(client, [i], pb.Response.FromString(blob), items, f"packed {kind}")
    check_items(client, idx16, pb.Response.FromString(outs["batched"]), items, "packed batched")
    require(counts, ("pir_ntt.grow", "pir_scan.hi", "pir_scan_wide.hi"), "packed")
    lines = [f"{kind} {label} {', '.join(f'{x:.2f}' for x in ms[kind, label])} ms"
             for kind in runs for label in ("packed", "unpacked")]
    log(f"packed transfer (u32 lo + {np.dtype(server._hi_dtype).name} hi words) against "
        f"u64 words on the stamped server ({smi}): 3 single-query, a 16-query batched and 6 "
        f"streamed requests (depth 4, sync debug \"error\"), Responses byte-equal, run in turns "
        f"packed, unpacked, unpacked, packed; {'; '.join(lines)}; packed launches {counts}")
    return {"packed": counts}


def serve_n32768(device, ct_mult: bool = False) -> dict:
    """Phase 20: 3 single-query requests at N=32768 on the 2^20-item
    database (the Shoup-table layout); with ct_mult phase 22, the same
    items in ciphertext-multiplication mode.  Returns their launch counts
    ("n32768" or "n32768_ctmult")."""
    import pir_tpu_torch as pt
    from pir_tpu_torch import kernels, native
    from pir_tpu_torch.pir import database
    from pir_tpu_torch.pir.encoders import StringEncoder
    from pir_tpu_torch.profile_request import staged_request
    from pir_tpu_torch.proto import payload_pb2 as pb

    n = kt.SERVED_N
    db_size = 1 << LOG2_ITEMS
    label = f"N={n} ct-mult" if ct_mult else f"N={n}"
    params = pt.create_pir_parameters(db_size, ITEM_SIZE, DIMENSIONS,
                                      pt.generate_encryption_params(n, PLAIN_BITS),
                                      use_ciphertext_multiplication=ct_mult)
    rng = np.random.default_rng(DB_SEED)
    pool = [rng.integers(0, 256, ITEM_SIZE, dtype=np.uint8).tobytes() for _ in range(POOL_ITEMS)]
    items = stamped_items([pool[i % POOL_ITEMS] for i in range(db_size)])
    packed = "packed anew by PirDatabase.create (phase 20's database freed first)"
    if not ct_mult:
        bytes_per_pt = params.items_per_plaintext * ITEM_SIZE
        buffer = b"".join(items) + b"\0" * (params.num_pt * bytes_per_pt - db_size * ITEM_SIZE)
        bits = StringEncoder(n, params.encryption_params.plain_modulus,
                             params.bits_per_coeff).bits_per_coeff
        pts, native_s = timed(lambda: native.pack_db(buffer, params.num_pt, bytes_per_pt, bits, n))
        plain, plain_s = timed(lambda: database.pack_items(buffer, params.num_pt, bytes_per_pt,
                                                           bits, n))
        if not np.array_equal(pts, plain):
            raise AssertionError("the native encoder and pack_items pack different plaintexts")
        del buffer, pts, plain
        packed = (f"packed by the native encoder in {native_s / 1e3:.3f} s, by pack_items in "
                  f"{plain_s / 1e3:.3f} s (equal)")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    db = pt.PirDatabase.create(items, params, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    setup_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    if db.db_ntt is None:
        raise AssertionError(f"the {label} database is not in the Shoup-table layout")
    gb = (db.db_ntt.numel() + db.db_ntt_shoup.numel()) * 8 / 1e9
    log(f"{label} database: {db_size} stamped items of {ITEM_SIZE} B, ct moduli "
        f"{[q.bit_length() for q in params.encryption_params.ct_modulus]} bits, dims "
        f"{params.dimensions}, {params.num_pt} plaintexts; {packed}; "
        f"PirDatabase.create (native pack, NTT, companions) {build_s:.2f} s; db_ntt + "
        f"db_ntt_shoup {gb:.2f} GB on {device}; set-up peak {setup_peak:.2f} GB above the "
        f"{base / 1e9:.2f} GB held")

    client, keygen_ms = timed(lambda: pt.PirClient(params, seed=CLIENT_SEED,
                                                   compress_queries=True, device=device))
    reply_limbs = pt.reply_limbs_for(params)
    server = pt.PirServer(db, params, reply_limbs=reply_limbs)
    indexes = [db_size // 3, 7, db_size - 1]
    requests = [client.create_request([i]) for i in indexes]
    blob, ser_ms = timed(requests[0].SerializeToString)
    requests[0], parse_ms = timed(lambda: pb.Request.FromString(blob))
    if len(blob) >= PROTOBUF_LIMIT:
        raise AssertionError(f"{label}: the Request's {len(blob)} bytes exceed protobuf's "
                             f"{PROTOBUF_LIMIT}-byte message limit")
    log(f"{label} client: keys on {device} in {keygen_ms / 1e3:.2f} s; native-wire Request "
        f"{len(blob)} bytes, {PROTOBUF_LIMIT - len(blob)} under protobuf's limit (Galois keys "
        f"{len(requests[0].galois_keys)}, relin {len(requests[0].relin_keys)}); serialize "
        f"{ser_ms / 1e3:.3f} s, parse {parse_ms / 1e3:.3f} s")
    del blob
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    responses, latencies = [], []
    for req in requests:
        resp, ms = timed(lambda: server.process_request(req))
        responses.append(resp)
        latencies.append(ms)
    counts = kernels.variant_launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    budgets = [client.reply_noise_budgets(resp.reply[0]) for resp in responses]
    for idx, resp in zip(indexes, responses):
        check_items(client, [idx], resp, items, label)
    if min(min(b) for b in budgets) <= 0:
        raise AssertionError(f"an {label} reply or recomposed inner ciphertext has no noise "
                             f"budget left: {budgets}")
    kinds = "[reply]" if ct_mult else "[reply, recomposed inner]"
    log(f"{label}: 3/3 requests at {indexes} retrieved their stamped item; replies at "
        f"{reply_limbs} limb(s), {len(responses[0].reply[0].ct)} ciphertext(s); noise budgets "
        f"(bits) {kinds} {budgets}; latency first {latencies[0]:.2f} ms, warm "
        f"{', '.join(f'{x:.2f}' for x in latencies[1:])} ms; a request's peak device memory "
        f"{peak:.2f} GB above the {base / 1e9:.2f} GB held; launches {counts}")
    require(counts, ("pir_ntt.reduce", "pir_scan_shoup"), label)
    stages, levels = {}, [0.0] * 16
    staged = staged_request(server, requests[1], stages, levels)
    if staged.SerializeToString() != responses[1].SerializeToString():
        raise AssertionError(f"{label}: the staged request's Response differs")
    log(f"{label}: a warm request in synchronized stages (profile_request.staged_request, "
        f"Response byte-equal): {', '.join(f'{k} {v:.2f} ms' for k, v in stages.items())}; "
        f"expansion levels {', '.join(f'{x:.2f}' for x in levels if x)} ms")
    del server, db, client
    torch.cuda.empty_cache()
    return {"n32768_ctmult" if ct_mult else "n32768": counts}


def reply_arrays(response, ctx) -> list:
    """Every reply of a Response loaded to its u64 ciphertext arrays."""
    from pir_tpu_torch.pir import wire

    return [wire.load_ciphertexts(reply, ctx) for reply in response.reply]


def serve_seal(device, items, smi: str) -> dict:
    """Phase 18: the SEAL 3.5 wire at the benchmark configuration's shape,
    on a stamped 2^20-item server with the reference's legacy re-encode
    digits (a SEAL client and server refuse balanced ones, the bench
    default, for d > 1) and SEAL's default 20-bit t (SEAL_PLAIN_BITS), and
    its default wire_format="auto": a SEAL client's single-query, batched and
    streamed requests, and the same query arrays sent natively.  Returns
    the launch counts of the single ("seal_single"), batched
    ("seal_batched") and streamed ("seal_stream") requests."""
    import pir_tpu_torch as pt
    from pir_tpu_torch import kernels
    from pir_tpu_torch.pir import seal_compat, wire
    from pir_tpu_torch.proto import payload_pb2 as pb

    n = len(items)
    seal_params = pt.create_pir_parameters(
        n, ITEM_SIZE, DIMENSIONS, pt.generate_encryption_params(POLY_DEGREE, SEAL_PLAIN_BITS),
        reencode_digits="legacy",
    )
    t0 = time.perf_counter()
    db = pt.PirDatabase.create(items, seal_params, device=device)
    server = pt.PirServer(db, seal_params, reply_limbs=pt.reply_limbs_for(seal_params))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    client = pt.PirClient(seal_params, seed=CLIENT_SEED, device="cpu", wire_format="seal")
    keygen_s = time.perf_counter() - t0
    ep = seal_params.encryption_params
    log(f"SEAL wire: t = {seal_params.encryption_params.plain_modulus:#x}, dims "
        f"{seal_params.dimensions}, replies at {server.reply_limbs} limb(s); stamped database "
        f"with legacy digits built in {build_s:.2f} s; SEAL "
        f"client keys (seeded Galois and relin keys) on the CPU in {keygen_s:.2f} s; Galois "
        f"key blob {len(client._galois_bytes) / 2**20:.1f} MiB, relin "
        f"{len(client._relin_bytes) / 2**20:.1f} MiB")

    def check_seal(response, indexes, label):
        for reply in response.reply:
            for ct in reply.ct:
                if not seal_compat.looks_like_seal_stream(ct):
                    raise AssertionError(f"{label}: a reply blob is not a SEAL stream")
        check_items(client, indexes, response, items, label)

    indexes = [n // 3 + 1, n // 2 + 7, n - 1]
    requests = [client.create_request([i]) for i in indexes]
    kernels.reset_launch_counts()
    responses, latencies = [], []
    for req in requests:
        resp, ms = timed(lambda: server.process_request(req))
        responses.append(resp)
        latencies.append(ms)
    single = kernels.variant_launch_counts()
    for idx, resp in zip(indexes, responses):
        check_seal(resp, [idx], "SEAL single-query")
    require(single, ("pir_ntt.grow", "pir_scan.hi"), "seal_single")
    budgets = [client.reply_noise_budgets(resp.reply[0]) for resp in responses]
    if min(b[0] for b in budgets) <= 0:
        raise AssertionError(f"a SEAL reply has no noise budget left: {budgets}")
    t0 = time.perf_counter()
    wire.deserialize_galois_keys(requests[0].galois_keys, "cpu", ep)
    seal_load_s = time.perf_counter() - t0
    native_gal = wire.serialize_galois_keys(client.galois_keys)
    t0 = time.perf_counter()
    wire.deserialize_galois_keys(native_gal, "cpu")
    native_load_s = time.perf_counter() - t0

    idx16 = [(k * 40503 + 333) % n for k in range(16)]
    request16 = client.create_request(idx16)
    kernels.reset_launch_counts()
    batched, batch_ms = timed(lambda: server.process_request_batched(request16))
    counts_b = kernels.variant_launch_counts()
    check_seal(batched, idx16, "SEAL batched")
    require(counts_b, ("pir_ntt.grow", "pir_scan_wide.hi", "pir_scan.hi"), "seal_batched")
    for qi in range(16):
        one = server.process_request(single_query_request(request16, qi))
        if one.reply[0].SerializeToString() != batched.reply[qi].SerializeToString():
            raise AssertionError(f"SEAL batched: query {qi} alone differs from its batched reply")

    stream_idx = [(k * 77773 + 91) % n for k in range(6)]
    stream_reqs = [client.create_request([i]) for i in stream_idx]
    want = [server.process_request(r).SerializeToString() for r in stream_reqs]
    list(server.process_stream(iter(stream_reqs), depth=4))  # the streams' pools
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")  # a synchronizing call on the path raises
    try:
        got, stream_ms = timed(lambda: [r.SerializeToString()
                                        for r in server.process_stream(iter(stream_reqs), depth=4)])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts_s = kernels.variant_launch_counts()
    if got != want:
        raise AssertionError("streamed SEAL Responses differ from sequential")
    for idx, resp in zip(stream_idx, got):
        check_seal(pb.Response.FromString(resp), [idx], "SEAL stream")
    require(counts_s, ("pir_ntt.grow", "pir_scan.hi"), "seal_stream")

    # the same query arrays and keys in the native codec, on the same server
    native_relin = wire.serialize_relin_keys(client.relin_keys)
    native_ms = []
    for req, seal_resp in zip(requests + requests[:1], responses + responses[:1]):
        nat = pb.Request(galois_keys=native_gal, relin_keys=native_relin)
        for q in req.query:
            wire.save_ciphertexts(wire.load_ciphertexts(q, server.ctx), nat.query.add())
        resp, ms = timed(lambda: server.process_request(nat))
        native_ms.append(ms)
        if seal_compat.looks_like_seal_stream(resp.reply[0].ct[0]):
            raise AssertionError("a native request was answered with SEAL streams")
        for a, b in zip(reply_arrays(resp, server.ctx), reply_arrays(seal_resp, server.ctx)):
            if not np.array_equal(a, b):
                raise AssertionError("native and SEAL replies to the same queries differ")
    log(f"SEAL wire ({smi}): 3/3 single-query SEAL requests at {indexes}, every reply blob a "
        f"SEAL stream, every stamped item retrieved; latency first {latencies[0]:.2f} ms (with "
        f"the key set's load: SEAL Galois keys {seal_load_s:.3f} s on the host, their seeded c1 "
        f"expanded with SEAL's BLAKE2 PRNG, against {native_load_s:.3f} s for the same keys "
        f"native), warm {', '.join(f'{x:.2f}' for x in latencies[1:])} ms; native requests of "
        f"the same query arrays on the same server, warm "
        f"{', '.join(f'{x:.2f}' for x in native_ms[1:])} ms (first {native_ms[0]:.2f} ms, its "
        f"key load included), reply arrays equal to the SEAL ones; noise budgets (bits) [reply, "
        f"recomposed inner] {budgets}; launches {single}")
    log(f"SEAL wire: batched request of 16 SEAL queries {batch_ms:.2f} ms, each reply byte-equal "
        f"to its query alone, every item retrieved, launches {counts_b}; 6 SEAL requests streamed "
        f"at depth 4 in {stream_ms:.2f} ms ({6 / stream_ms * 1e3:.2f} queries/s), byte-equal to "
        f"sequential, launches {counts_s}")
    del server, db
    torch.cuda.empty_cache()
    return {"seal_single": single, "seal_batched": counts_b, "seal_stream": counts_s}


def serve_checkpoint(device) -> dict:
    """Phase 16: save a 2^16-item stamped database, load it into both
    layouts, one request each.  Returns each load's launch counts
    ("load_planes", "load_shoup")."""
    import tempfile

    import pir_tpu_torch as pt
    from pir_tpu_torch import kernels

    db_size = 1 << LOG2_CHECKPOINT_ITEMS
    params = pt.create_pir_parameters(
        db_size, ITEM_SIZE, DIMENSIONS, pt.generate_encryption_params(POLY_DEGREE, PLAIN_BITS))
    rng = np.random.default_rng(DB_SEED)
    pool = [rng.integers(0, 256, ITEM_SIZE, dtype=np.uint8).tobytes() for _ in range(POOL_ITEMS)]
    items = stamped_items([pool[i % POOL_ITEMS] for i in range(db_size)])
    db = pt.PirDatabase.create(items, params, device=device)
    client = pt.PirClient(params, seed=CLIENT_SEED, compress_queries=True, device="cpu")
    reply_limbs = pt.reply_limbs_for(params)
    indexes = [db_size // 3 + 5, db_size - 2]
    request = client.create_request(indexes)
    want = pt.PirServer(db, params, reply_limbs=reply_limbs).process_request(request)
    check_items(client, indexes, want, items, "checkpoint source")
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "db.npz"
        t0 = time.perf_counter()
        db.save(path)
        save_s = time.perf_counter() - t0
        del db
        torch.cuda.empty_cache()
        lines = []
        for label, scan_impl, variant in (("load_planes", "pallas", "pir_scan.hi"),
                                          ("load_shoup", "xla", "pir_scan_shoup")):
            t0 = time.perf_counter()
            loaded = pt.PirDatabase.load(path, params, scan_impl=scan_impl, device=device)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            server = pt.PirServer(loaded, params, reply_limbs=reply_limbs)
            kernels.reset_launch_counts()
            got = server.process_request(request)
            paths[label] = kernels.variant_launch_counts()
            if got.SerializeToString() != want.SerializeToString():
                raise AssertionError(f"{label}: Response differs from the directly built database's")
            require(paths[label], ("pir_ntt.grow", variant), label)
            lines.append(f"{label} {load_s:.2f} s (launches {paths[label]})")
            del server, loaded
            torch.cuda.empty_cache()
        size_mb = path.stat().st_size / 2**20
    log(f"checkpoint: {db_size} stamped items ({params.num_pt} plaintexts, dims "
        f"{params.dimensions}): save {save_s:.2f} s, {size_mb:.1f} MiB; "
        f"{'; '.join(lines)}; each Response byte-equal to the directly built database's")
    return paths


def seeded_items(count: int, size: int, seed: int = DB_SEED) -> list:
    """`count` random items of `size` bytes (pir_tpu.testing.fixtures.
    generate_test_db's, the reference test matrices' data)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=size, dtype=np.uint8).tobytes() for _ in range(count)]


def reply_budgets(client, response) -> list:
    """Each reply's invariant noise budget in bits (the least over its
    ciphertexts), read with the client's secret key."""
    from pir_tpu_torch.bfv.encrypt import invariant_noise_budget
    from pir_tpu_torch.ops.modular import tensor_u64
    from pir_tpu_torch.pir import wire

    budgets = []
    for reply in response.reply:
        cts = wire.load_ciphertexts(reply, client.ctx)
        budgets.append(min(invariant_noise_budget(client.ctx, client.sk,
                                                  tensor_u64(ct, client.ctx.device))
                           for ct in cts))
    if min(budgets) <= 0:
        raise AssertionError(f"a reply has no noise budget left: {budgets}")
    return budgets


def serve_ctmult_reference(device) -> dict:
    """Ciphertext-multiplication mode at the reference's rows
    (CT_MULT_REFERENCE_ROWS), each on the card with the reference tests'
    data and client seed; the N=4096 d=2 row on the CPU too, byte-equal.
    Returns the launch counts summed over the rows."""
    import pir_tpu_torch as pt
    from pir_tpu_torch import kernels

    total = {}
    for i, (n, t_bits, elem, bpc, dbsize, d, indexes) in enumerate(CT_MULT_REFERENCE_ROWS):
        params = pt.create_pir_parameters(
            dbsize, elem, d, pt.generate_encryption_params(n, t_bits),
            use_ciphertext_multiplication=True, bits_per_coeff=bpc,
        )
        label = f"ct-mult N={n} t={t_bits} bits d={d} {dbsize} items"
        raw = seeded_items(params.num_items, params.bytes_per_item)
        client = pt.PirClient(params, seed=CLIENT_SEED, compress_queries=True, device=device)
        request = client.create_request(indexes)
        server = pt.PirServer(pt.PirDatabase.create(raw, params, device=device), params)
        kernels.reset_launch_counts()
        response, ms = timed(lambda: server.process_request(request))
        counts = kernels.variant_launch_counts()
        check_items(client, indexes, response, raw, label)
        budgets = reply_budgets(client, response)
        same = ""
        if i == CT_MULT_CPU_ROW:
            cpu = pt.PirServer(pt.PirDatabase.create(raw, params, device="cpu"), params)
            if cpu.process_request(request).SerializeToString() != response.SerializeToString():
                raise AssertionError(f"{label}: card and CPU Responses differ")
            same = "; Response bytes equal to the CPU server's (plain versions)"
        log(f"{label}, dims {params.dimensions}: {len(indexes)} queries in {ms:.2f} ms, every "
            f"item retrieved; noise budgets {budgets} bits{same}; launches {counts}")
        require(counts, ("pir_ntt.grow", "pir_scan_shoup") + (("pir_ntt.reduce",) if d > 1 else ()),
                label)
        add_counts(total, counts)
    return total


def serve_ctmult_full(device) -> "tuple[dict, dict]":
    """Ciphertext-multiplication mode at real size: 2^20 stamped items of
    288 B, d=2, N=8192, SEAL's chain, the bench's t, replies mod-switched by
    reply_limbs_for; three requests.  Then phase 19 (a): one request of 2
    queries on this server, which is freed before a db=2 mesh of 2 gloo
    ranks serves the same request (each rank byte-equal to it).  Returns
    the three requests' launch counts and the mesh's."""
    import pir_tpu_torch as pt
    from pir_tpu_torch import kernels

    db_size = 1 << LOG2_ITEMS
    params = pt.create_pir_parameters(
        db_size, ITEM_SIZE, DIMENSIONS,
        pt.generate_encryption_params(CT_MULT_POLY_DEGREE, PLAIN_BITS),
        use_ciphertext_multiplication=True,
    )
    rng = np.random.default_rng(DB_SEED)
    pool = [rng.integers(0, 256, ITEM_SIZE, dtype=np.uint8).tobytes() for _ in range(POOL_ITEMS)]
    items = stamped_items([pool[i % POOL_ITEMS] for i in range(db_size)])
    t0 = time.perf_counter()
    db = pt.PirDatabase.create(items, params, device=device)
    torch.cuda.synchronize()
    gb = (db.db_ntt.numel() + db.db_ntt_shoup.numel()) * 8 / 1e9
    log(f"ct-mult database: {db_size} stamped items of {ITEM_SIZE} B, N={CT_MULT_POLY_DEGREE}, "
        f"ct moduli {[q.bit_length() for q in params.encryption_params.ct_modulus]} bits, dims "
        f"{params.dimensions}, {params.num_pt} plaintexts; db_ntt + db_ntt_shoup {gb:.2f} GB on "
        f"{device}, built in {time.perf_counter() - t0:.2f} s")
    client = pt.PirClient(params, seed=CLIENT_SEED, compress_queries=True, device=device)
    reply_limbs = pt.reply_limbs_for(params)
    server = pt.PirServer(db, params, reply_limbs=reply_limbs)
    indexes = [db_size // 3, 7, db_size - 1]
    requests = [client.create_request([i]) for i in indexes]
    torch.cuda.synchronize()
    base_mb = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    responses, latencies = [], []
    for req in requests:
        resp, ms = timed(lambda: server.process_request(req))
        responses.append(resp)
        latencies.append(ms)
    counts = kernels.variant_launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    budgets = []
    for idx, resp in zip(indexes, responses):
        check_items(client, [idx], resp, items, "ct-mult at 2^20 items")
        budgets += reply_budgets(client, resp)
    log(f"ct-mult at 2^20 items: 3/3 requests at {indexes} retrieved their stamped item; "
        f"replies mod-switched to {reply_limbs} limb(s), noise budgets {budgets} bits; latency "
        f"first {latencies[0]:.2f} ms, warm {', '.join(f'{x:.2f}' for x in latencies[1:])} ms; "
        f"peak device memory {peak_mb:.1f} MiB ({peak_mb - base_mb:.1f} MiB above the "
        f"{base_mb:.1f} MiB held); launches {counts}")
    require(counts, ("pir_ntt.grow", "pir_ntt.reduce", "pir_scan_shoup"), "ct-mult at 2^20 items")

    mesh_indexes = [db_size // 5 + 3, db_size - 2]
    request = client.create_request(mesh_indexes)
    want, ms = timed(lambda: server.process_request(request))
    check_items(client, mesh_indexes, want, items, "ct-mult mesh reference")
    log(f"ct-mult at 2^20 items: the mesh's request of 2 queries on this single-device server "
        f"in {ms:.2f} ms")
    del server, db
    torch.cuda.empty_cache()
    mesh, _ = run_mesh(device, "ct-mult N=8192 2^20 items", params, items, request,
                       want.SerializeToString(), n_db=2, batch=1, limb=1, scan_impl="auto",
                       reply_limbs=reply_limbs)
    require(mesh, ("pir_ntt.grow", "pir_ntt.reduce", "pir_scan_shoup"), "ct-mult mesh")
    return counts, mesh


def serve_ctmult_mesh_reference(device) -> dict:
    """Phase 19 (b): CT_MULT_REFERENCE_ROWS' N=4096 d=2 row with its two
    indexes as one request on a db=2 x batch=2 mesh of 4 gloo ranks, each
    rank byte-equal to the single-device server.  Returns the mesh's launch
    counts."""
    import pir_tpu_torch as pt

    n, t_bits, elem, bpc, dbsize, d, indexes = CT_MULT_REFERENCE_ROWS[CT_MULT_CPU_ROW]
    params = pt.create_pir_parameters(
        dbsize, elem, d, pt.generate_encryption_params(n, t_bits),
        use_ciphertext_multiplication=True, bits_per_coeff=bpc,
    )
    raw = seeded_items(params.num_items, params.bytes_per_item)
    client = pt.PirClient(params, seed=CLIENT_SEED, compress_queries=True, device=device)
    request = client.create_request(indexes)
    server = pt.PirServer(pt.PirDatabase.create(raw, params, device=device), params)
    server.process_request(request)  # the keys cached
    want, ms = timed(lambda: server.process_request(request))
    check_items(client, indexes, want, raw, "ct-mult reference-row mesh")
    log(f"ct-mult N={n} d={d} {dbsize} items: the mesh's request of {len(indexes)} queries on "
        f"one device, warm, in {ms:.2f} ms")
    del server
    torch.cuda.empty_cache()
    mesh, _ = run_mesh(device, f"ct-mult N={n} d={d} {dbsize} items", params, raw, request,
                       want.SerializeToString(), n_db=2, batch=2, limb=1, scan_impl="auto")
    require(mesh, ("pir_ntt.grow", "pir_ntt.reduce", "pir_scan_shoup"), "ct-mult reference mesh")
    return mesh


def large_ring_params(n: int, profile: str, ct_mult: bool = False):
    """LARGE_RING_ROW's PirParams at ring n under `profile`."""
    import pir_tpu_torch as pt

    elem, bpc, dbsize, d, _ = LARGE_RING_ROW
    return pt.create_pir_parameters(
        dbsize, elem, d, pt.generate_encryption_params(n, PLAIN_BITS, profile=profile),
        bits_per_coeff=bpc, use_ciphertext_multiplication=ct_mult,
    )


def serve_large_rings(device, reduce_launches: dict) -> dict:
    """Decomposition mode above N=4096, and ciphertext-multiplication mode
    at N=16384 (LARGE_RING_CASES), every item decoded and every reply's
    noise budget > 0; the ct-mult row's reducing launches of kernel A (its
    BEHZ base's) must be one request's count in `reduce_launches` a query.
    Returns each case's launch counts by its path name."""
    import pir_tpu_torch as pt
    from pir_tpu_torch import kernels

    *_, indexes = LARGE_RING_ROW
    paths = {}
    for path, n, profile, scan_impl, ct_mult, variants in LARGE_RING_CASES:
        params = large_ring_params(n, profile, ct_mult)
        raw = seeded_items(params.num_items, params.bytes_per_item)
        db = pt.PirDatabase.create(raw, params, scan_impl=scan_impl, device=device)
        layout = ("Shoup table" if not db._use_planes else "planes, hi plane "
                  + ("none" if db.db_planes[0] is None else str(db.db_planes[0].dtype)))
        client = pt.PirClient(params, seed=CLIENT_SEED, compress_queries=True, device=device)
        request = client.create_request(indexes)
        server = pt.PirServer(db, params)
        kernels.reset_launch_counts()
        response, ms = timed(lambda: server.process_request(request))
        counts = kernels.variant_launch_counts()
        check_items(client, indexes, response, raw, path)
        budgets = reply_budgets(client, response)
        mode = "ciphertext-multiplication" if ct_mult else "decomposition"
        log(f"{mode} N={n} {profile} ({layout}), d={len(params.dimensions)}, "
            f"{params.num_items} items, dims "
            f"{params.dimensions}: {len(indexes)} queries in {ms:.2f} ms, every item retrieved; "
            f"noise budgets {budgets} bits; launches {counts}")
        require(counts, variants, path)
        if path in reduce_launches:
            want = len(indexes) * reduce_launches[path]
            if counts["pir_ntt.reduce"] != want:
                raise AssertionError(f"{path}: {counts['pir_ntt.reduce']} reducing launches of "
                                     f"kernel A, kernel_times.served_ntt_launches says {want}")
        paths[path] = counts
        del server, db
    torch.cuda.empty_cache()
    return paths


def build_kernels() -> None:
    """nvcc for every kernel source and g++ for the native encoder, all at
    once."""
    from concurrent.futures import ThreadPoolExecutor

    from pir_tpu_torch import kernels, native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels.REGISTRY) + 1) as ex:
        encoder = ex.submit(native.available)
        list(ex.map(lambda k: k.lib(), kernels.REGISTRY.values()))
        encoder.result()
    log(f"kernels and the native encoder ({native.build().name}) built/loaded in "
        f"{time.perf_counter() - t0:.2f} s (in parallel)")
    for k in kernels.REGISTRY.values():
        log(f"kernel {k.name}: {k.library_path().name} ({k.build_seconds:.2f} s)")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")


def require(counts: dict, keys, path: str) -> None:
    for key in keys:
        if counts.get(key, 0) <= 0:
            raise AssertionError(f"{key} was not launched by the {path} path")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    log(smi.stdout.strip())
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    build_kernels()

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ntt = check_ntt(device, gen)
    scan = check_scan(device, gen)
    wide = check_scan_wide(device, gen)
    shoup = check_scan_shoup(device, gen)
    ntt_large, reduce_launches = check_ntt_large(device, gen)
    small = check_small_against_cpu(device)
    single, params, client, raw = serve_bench_config(device, LOG2_ITEMS)
    server, stamped = check_full_size_indexing(device, params, client, raw)
    del raw
    indexes = [(k * 58271 + 5) % len(stamped) for k in range(BATCH_QUERIES - 1)] + [len(stamped) - 1]
    batched = serve_batched(server, client, stamped, indexes, "SEAL chain")
    require(batched, ("pir_ntt.grow", "pir_scan_wide.hi", "pir_scan.hi"), "batched")
    streams = serve_stream(server, client, stamped, smi.stdout.strip())
    packed = serve_packed(server, client, stamped, smi.stdout.strip())
    seal = serve_seal(device, stamped, smi.stdout.strip())
    shoup_counts = serve_shoup(device, params, client, stamped, server)
    mesh_indexes = [len(stamped) // 5, len(stamped) - 3]
    mesh, whole_db_peaks = serve_mesh(device, "SEAL chain", params, client, stamped, server.db,
                                      mesh_indexes, n_db=2, batch=1, limb=2)
    require(mesh, ("pir_ntt.grow", "pir_scan.hi.dyn"), "SEAL-chain mesh")
    shard_mesh = serve_shard_mesh(device, params, client, stamped, server.db, mesh_indexes,
                                  whole_db_peaks)
    require(shard_mesh, ("pir_ntt.grow", "pir_scan.hi.dyn"), "shard-loaded mesh")
    del server, stamped
    torch.cuda.empty_cache()
    checkpoint = serve_checkpoint(device)
    torch.cuda.empty_cache()
    tpu32, (params32, db32, client32, items32) = serve_tpu32(device)
    require(tpu32, ("pir_ntt.grow", "pir_scan_wide.u32", "pir_scan.u32"), "tpu32")
    mesh32, _ = serve_mesh(device, "tpu32", params32, client32, items32, db32,
                           [17, len(items32) - 5], n_db=1, batch=1, limb=3)
    require(mesh32, ("pir_ntt.grow", "pir_scan.u32.dyn"), "tpu32 mesh")
    del db32, items32
    torch.cuda.empty_cache()
    ctmult_ref = serve_ctmult_reference(device)
    ctmult_ref_mesh = serve_ctmult_mesh_reference(device)
    ctmult, ctmult_mesh = serve_ctmult_full(device)
    large = serve_large_rings(device, reduce_launches)
    n32768 = serve_n32768(device)
    n32768.update(serve_n32768(device, ct_mult=True))
    for path, counts in n32768.items():
        want = {"pir_ntt.reduce": 3 * reduce_launches[path], "pir_scan_shoup": 3}
        got = {k: counts.get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"{path}: launches {got}, kernel_times.served_ntt_launches and "
                                 f"one kernel D a request say {want}")

    paths = {"single": single, "small": small, "batched": batched, "tpu32": tpu32,
             "mesh": mesh, "mesh32": mesh32, "shoup": shoup_counts,
             "ctmult_ref": ctmult_ref, "ctmult": ctmult, **large, **streams,
             "shard_mesh": shard_mesh, **checkpoint, **seal,
             "ctmult_ref_mesh": ctmult_ref_mesh, "ctmult_mesh": ctmult_mesh, **packed,
             **n32768}
    checks = {**scan, **ntt, **ntt_large, **wide, "K7": shoup}
    for row in KERNEL_ROWS:  # every (path, variant) a row counts was launched
        for path, variant in row.launches:
            require(paths[path], (variant,), path)
    print(json.dumps({"kernels": [
        {"name": row.name, "route": "cuda", "source": "pir_tpu_torch/csrc/" + row.source,
         "replaces": ", ".join(row.replaces),
         "launches": sum(paths[path][variant] for path, variant in row.launches),
         **checks[row.check], "library_ms": None}
        for row in KERNEL_ROWS
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
