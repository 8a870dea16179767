"""Drive pir_tpu_torch on one CUDA card: build its kernels, check each against
its plain PyTorch version, then serve SealPIR requests at the benchmark
configuration, single and batched, on SEAL's chain and on the tpu32 profile,
and check every retrieved item.

    python3 chip_smoke.py               # 2^20 items of 288 B, d=2, N=4096

Phases, each of which raises on failure:

1. the card's name and power limit (nvidia-smi);
2. build kernels A (NTT), B (scan) and C (wide scan) from pir_tpu_torch/csrc
   with nvcc, all three at once;
3. each kernel against its plain version on the card, bit for bit, at the
   shapes the main paths give it, with both times: A; B with a hi plane (K1)
   and without (K5, tpu32); C at S = 32 columns with a hi plane (K4) and
   without (K4-u32), beside 16 calls of kernel B on the same columns, with
   GB/s of database planes;
4. a small database served on the card and on the CPU (plain versions):
   the Response bytes must be equal;
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
   have run.  The same latencies and peak memory.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA card the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

ITEM_SIZE = 288
DIMENSIONS = 2
POLY_DEGREE = 4096
PLAIN_BITS = 24
LOG2_ITEMS = 20
DB_SEED = 42
CLIENT_SEED = 7
POOL_ITEMS = 4096  # distinct random items the benchmark data repeats
BATCH_QUERIES = 18  # one chunk of 16 lanes and a ragged tail of 2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a - b).abs().max().item()) if a.numel() else 0


def random_residues(moduli, shape_before, n, device, gen) -> torch.Tensor:
    """int64[*shape_before, L, n] uniform below each limb's modulus."""
    cols = [
        torch.randint(0, int(q), (*shape_before, 1, n), generator=gen,
                      dtype=torch.int64, device=device)
        for q in moduli
    ]
    return torch.cat(cols, dim=-2)


def check_ntt(device, gen) -> dict:
    """Kernel A vs its plain version at the main path's shapes (tolerance 0)."""
    from pir_tpu_torch.core import primes
    from pir_tpu_torch.core.params import generate_encryption_params
    from pir_tpu_torch.ops.ntt import NttTables, ntt_cuda, ntt_plain

    chain = generate_encryption_params(POLY_DEGREE, PLAIN_BITS).coeff_modulus
    qp = NttTables(chain, POLY_DEGREE, device)
    small = NttTables(primes.coeff_modulus_from_bits(256, [36, 36, 37]), 256, device)
    cases = [
        # the selection vector [324, 2, L, N] flattened (q chain)
        ("q chain [648, 2, 4096]", qp.slice(2), (648,)),
        # the last expansion level's key-switch digits: 256 cts x L (QP chain)
        ("QP chain [512, 3, 4096]", qp, (512,)),
        ("N=256 [64, 3, 256]", small, (64,)),
    ]
    headline = None
    for label, tables, batch in cases:
        x = random_residues(tables.moduli, batch, tables.n, device, gen)
        for inverse in (False, True):
            got = ntt_cuda(tables, x, inverse)
            want = ntt_plain(tables, x, inverse)
            err = max_abs_err(got, want)
            if err != 0 or not torch.equal(got, want):
                raise AssertionError(f"kernel A differs from plain at {label}")
            ms = cuda_ms(lambda: ntt_cuda(tables, x, inverse), 20)
            plain_ms = cuda_ms(lambda: ntt_plain(tables, x, inverse), 3)
            name = "inverse" if inverse else "forward"
            log(f"kernel A {name} {label}: bit-equal to plain (max_abs_err 0); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if headline is None:
                headline = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        back = ntt_cuda(tables, ntt_cuda(tables, x, False), True)
        if not torch.equal(back, x):
            raise AssertionError(f"kernel A round trip fails at {label}")
    return headline


def planes_gb(hi, lo) -> float:
    return ((0 if hi is None else hi.numel() * hi.element_size()) + lo.numel() * 4) / 1e9


def random_planes(chain, P, D, device, gen):
    """(hi, lo) planes [P, L, D, N] of random residues."""
    from pir_tpu_torch.ops import scan_kernel

    db = random_residues(chain, (P, D), POLY_DEGREE, device, gen)  # [P, D, L, N]
    return scan_kernel.split_planes(db.transpose(1, 2).contiguous(), chain)


def chains():
    from pir_tpu_torch.core.params import generate_encryption_params

    return {
        "seal": generate_encryption_params(POLY_DEGREE, PLAIN_BITS),
        "tpu32": generate_encryption_params(POLY_DEGREE, PLAIN_BITS, profile="tpu32"),
    }


def check_scan(device, gen) -> dict:
    """Kernel B vs its plain version at the main paths' shapes (tolerance 0):
    with a hi plane (K1, SEAL's chain) and without (K5, tpu32)."""
    import pir_tpu_torch as pt
    from pir_tpu_torch.ops import decompose, modular, scan_kernel

    headline = {}
    for profile, ep in chains().items():
        chain = ep.ct_modulus
        L = len(chain)
        limbs = modular.LimbConstants(chain, device)
        params = pt.create_pir_parameters(1 << LOG2_ITEMS, ITEM_SIZE, DIMENSIONS, ep)
        upper = 2 * decompose.expansion_ratio(pt.PirContext(params, "cpu"))
        for label, P, D in (
            (f"inner scan sv [162,2,{L},4096] planes [162,{L},162,4096]", 162, 162),
            (f"upper scan sv [162,2,{L},4096] planes [{upper},{L},162,4096]", upper, 162),
        ):
            sv = random_residues(chain, (D, 2), POLY_DEGREE, device, gen)
            hi, lo = random_planes(chain, P, D, device, gen)
            got = scan_kernel.contract_cuda(sv, hi, lo, limbs)
            want = scan_kernel.contract_plain(sv, hi, lo, limbs)
            err = max_abs_err(got, want)
            if err != 0 or not torch.equal(got, want):
                raise AssertionError(f"kernel B differs from plain at {profile} {label}")
            ms = cuda_ms(lambda: scan_kernel.contract_cuda(sv, hi, lo, limbs), 10)
            plain_ms = cuda_ms(lambda: scan_kernel.contract_plain(sv, hi, lo, limbs), 2)
            variant = "K1" if hi is not None else "K5"
            log(f"kernel B ({variant}) {profile} {label}: bit-equal to plain (max_abs_err 0); "
                f"kernel {ms:.4f} ms ({planes_gb(hi, lo) / ms * 1e3:.1f} GB/s of planes), "
                f"plain {plain_ms:.4f} ms")
            headline.setdefault(variant, {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    return headline


def check_scan_wide(device, gen) -> dict:
    """Kernel C vs its plain version at the batched inner scan's shape
    (16 lanes: S = 32 columns; tolerance 0), with a hi plane (K4) and
    without (K4-u32), beside 16 calls of kernel B on the same columns."""
    from pir_tpu_torch.ops import modular, scan_kernel

    headline = {}
    for profile, ep in chains().items():
        chain = ep.ct_modulus
        L = len(chain)
        limbs = modular.LimbConstants(chain, device)
        S = 32
        sv = random_residues(chain, (162, S), POLY_DEGREE, device, gen)
        hi, lo = random_planes(chain, 162, 162, device, gen)
        got = scan_kernel.contract_wide_cuda(sv, hi, lo, limbs)
        want = scan_kernel.contract_wide_plain(sv, hi, lo, limbs)
        err = max_abs_err(got, want)
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"kernel C differs from plain at {profile}")
        pairs = [sv[:, 2 * k : 2 * k + 2].contiguous() for k in range(S // 2)]
        for k, x in enumerate(pairs[:2]):
            if not torch.equal(scan_kernel.contract_cuda(x, hi, lo, limbs), got[:, 2 * k : 2 * k + 2]):
                raise AssertionError(f"kernel C columns differ from kernel B at {profile}")
        ms = cuda_ms(lambda: scan_kernel.contract_wide_cuda(sv, hi, lo, limbs), 5)
        b16_ms = cuda_ms(lambda: [scan_kernel.contract_cuda(x, hi, lo, limbs) for x in pairs], 3)
        plain_ms = cuda_ms(lambda: scan_kernel.contract_wide_plain(sv, hi, lo, limbs), 1)
        gb = planes_gb(hi, lo)
        variant = "K4" if hi is not None else "K4-u32"
        log(f"kernel C ({variant}) {profile} sv [162,{S},{L},4096] planes [162,{L},162,4096]: "
            f"bit-equal to plain (max_abs_err 0); kernel {ms:.4f} ms "
            f"({gb / ms * 1e3:.1f} GB/s of planes); 16 x kernel B on the same columns "
            f"{b16_ms:.4f} ms ({gb / (b16_ms / 16) * 1e3:.1f} GB/s each); plain {plain_ms:.4f} ms")
        headline[variant] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return headline


def check_small_against_cpu(device) -> None:
    """A small database served on the card and on the CPU (plain versions of
    both kernels) must give byte-identical Responses."""
    import pir_tpu_torch as pt
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
    client = pt.PirClient(params, seed=5, compress_queries=True)
    req = client.create_request([0, 37])
    responses = [
        pt.PirServer(pt.PirDatabase.create(raw, params, dev), params).process_request(req)
        for dev in (device, "cpu")
    ]
    if responses[0].SerializeToString() != responses[1].SerializeToString():
        raise AssertionError("card and CPU Responses differ on the small database")
    if client.process_response([0, 37], responses[0]) != [raw[0], raw[37]]:
        raise AssertionError("small database retrieval failed on the card")
    log("small database (N=256, d=2): card Response bytes == CPU Response bytes; "
        "items retrieved")


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
    db = pt.PirDatabase.create(raw, params, device)
    torch.cuda.synchronize()
    log(f"database: {db_size} items of {ITEM_SIZE} B, dims {params.dimensions}, "
        f"{params.num_pt} plaintexts, planes on {device} in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    client = pt.PirClient(params, seed=CLIENT_SEED, compress_queries=True)
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
    log(f"request latency: first {latencies[0]:.2f} ms, then "
        f"{', '.join(f'{x:.2f}' for x in latencies[1:])} ms")
    log(f"kernel launches during the 3 requests: {counts}")
    require(counts, ("pir_ntt", "pir_scan.hi"), "single-query")
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
    db = pt.PirDatabase.create(stamped, params, device)
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
    db = pt.PirDatabase.create(items, params, device)
    torch.cuda.synchronize()
    if db.db_planes[0] is not None:
        raise AssertionError("the tpu32 database has a hi plane")
    reply_limbs = pt.reply_limbs_for(params)
    server = pt.PirServer(db, params, reply_limbs=reply_limbs)
    client = pt.PirClient(params, seed=CLIENT_SEED, compress_queries=True)
    log(f"tpu32 profile: ct moduli {[q.bit_length() for q in ep.ct_modulus]} bits, special "
        f"{ep.special_modulus.bit_length()} bits, reply_limbs={reply_limbs}; stamped "
        f"database of {db_size} items on {device} in {time.perf_counter() - t0:.2f} s")
    indexes = [(k * 65537 + 11) % db_size for k in range(15)] + [db_size - 1]
    return serve_batched(server, client, items, indexes, "tpu32")


def build_kernels() -> None:
    """nvcc for every kernel source at once."""
    from concurrent.futures import ThreadPoolExecutor

    from pir_tpu_torch import kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels.REGISTRY)) as ex:
        list(ex.map(lambda k: k.lib(), kernels.REGISTRY.values()))
    log(f"kernels built/loaded in {time.perf_counter() - t0:.2f} s")
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
    check_small_against_cpu(device)
    single, params, client, raw = serve_bench_config(device, LOG2_ITEMS)
    server, stamped = check_full_size_indexing(device, params, client, raw)
    del raw
    indexes = [(k * 58271 + 5) % len(stamped) for k in range(BATCH_QUERIES - 1)] + [len(stamped) - 1]
    batched = serve_batched(server, client, stamped, indexes, "SEAL chain")
    require(batched, ("pir_ntt", "pir_scan_wide.hi", "pir_scan.hi"), "batched")
    del server, stamped
    tpu32 = serve_tpu32(device)
    require(tpu32, ("pir_ntt", "pir_scan_wide.u32", "pir_scan.u32"), "tpu32")

    src = "pir_tpu_torch/csrc/"
    rows = [
        ("scan (K1)", "scan.cu", "pir_tpu/ops/pallas_scan.py:103", single["pir_scan.hi"], scan["K1"]),
        ("ntt (K2)", "ntt.cu", "pir_tpu/ops/pallas_mxu_ntt.py:252", single["pir_ntt"], ntt),
        ("scan_wide (K4)", "scan_wide.cu", "pir_tpu/ops/pallas_scan.py:397",
         batched["pir_scan_wide.hi"], wide["K4"]),
        ("scan_wide u32 (K4-u32)", "scan_wide.cu", "pir_tpu/ops/pallas_scan.py:422",
         tpu32["pir_scan_wide.u32"], wide["K4-u32"]),
        ("scan u32 (K5)", "scan.cu", "pir_tpu/ops/pallas_scan.py:167",
         tpu32["pir_scan.u32"], scan["K5"]),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + file, "replaces": replaces,
         "launches": launches, **numbers}
        for name, file, replaces, launches, numbers in rows
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
