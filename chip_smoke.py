"""Drive pir_tpu_torch on one CUDA card: build its kernels, check each against
its plain PyTorch version, then serve SealPIR requests at the benchmark
configuration and check every retrieved item.

    python3 chip_smoke.py               # 2^20 items of 288 B, d=2, N=4096

Phases, each of which raises on failure:

1. the card's name and power limit (nvidia-smi);
2. build kernels A (NTT) and B (scan) from pir_tpu_torch/csrc with nvcc;
3. each kernel against its plain version on the card, bit for bit, at the
   shapes the main path gives it, with both times;
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
   (two of them 512 plaintexts apart), each of which must decode to its item.

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


def check_scan(device, gen) -> dict:
    """Kernel B vs its plain version at the main path's shapes (tolerance 0)."""
    from pir_tpu_torch.core.params import generate_encryption_params
    from pir_tpu_torch.ops import modular, scan_kernel

    chain = generate_encryption_params(POLY_DEGREE, PLAIN_BITS).ct_modulus
    limbs = modular.LimbConstants(chain, device)
    cases = [
        ("inner scan sv [162,2,2,4096] planes [162,2,162,4096]", 162, 162),
        ("upper scan sv [162,2,2,4096] planes [8,2,162,4096]", 8, 162),
    ]
    headline = None
    for label, P, D in cases:
        sv = random_residues(chain, (D, 2), POLY_DEGREE, device, gen)
        db = random_residues(chain, (P, D), POLY_DEGREE, device, gen)  # [P, D, L, N]
        hi, lo = scan_kernel.split_planes(db.transpose(1, 2).contiguous(), chain)
        del db
        got = scan_kernel.contract_cuda(sv, hi, lo, limbs)
        want = scan_kernel.contract_plain(sv, hi, lo, limbs)
        err = max_abs_err(got, want)
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"kernel B differs from plain at {label}")
        ms = cuda_ms(lambda: scan_kernel.contract_cuda(sv, hi, lo, limbs), 10)
        plain_ms = cuda_ms(lambda: scan_kernel.contract_plain(sv, hi, lo, limbs), 2)
        gbytes = (hi.numel() * hi.element_size() + lo.numel() * 4) / 1e9
        log(f"kernel B {label}: bit-equal to plain (max_abs_err 0); "
            f"kernel {ms:.4f} ms ({gbytes / ms * 1e3:.1f} GB/s of planes), "
            f"plain {plain_ms:.4f} ms")
        if headline is None:
            headline = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
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
    counts = kernels.launch_counts()

    for idx, resp in zip(indexes, responses):
        if client.process_response([idx], resp)[0] != raw[idx]:
            raise AssertionError(f"retrieval of item {idx} failed")
    log(f"served 3/3 requests at indexes {indexes}: every item retrieved "
        f"correctly; reply {len(responses[0].reply[0].ct)} ciphertexts")
    log(f"request latency: first {latencies[0]:.2f} ms, then "
        f"{', '.join(f'{x:.2f}' for x in latencies[1:])} ms")
    log(f"kernel launches during the 3 requests: {counts}")
    for name in ("ntt", "scan"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    return counts, params, client, raw


def check_full_size_indexing(device, params, client, raw) -> None:
    """Serve a database in which no two items are equal, at the benchmark's
    size, and check three retrievals (two of them one period of the
    benchmark data's equal plaintexts apart)."""
    import pir_tpu_torch as pt

    items = np.frombuffer(b"".join(raw), dtype=np.uint8).reshape(len(raw), ITEM_SIZE).copy()
    items[:, :4] = np.arange(len(raw), dtype="<u4").view(np.uint8).reshape(-1, 4)
    stamped = [row.tobytes() for row in items]
    del items
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from pir_tpu_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    log(smi.stdout.strip())
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    for k in (kernels.NTT, kernels.SCAN):
        k.lib()
        log(f"kernel {k.name}: built/loaded {k.library_path().name} in "
            f"{k.build_seconds:.2f} s")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ntt = check_ntt(device, gen)
    scan = check_scan(device, gen)
    check_small_against_cpu(device)
    counts, params, client, raw = serve_bench_config(device, LOG2_ITEMS)
    check_full_size_indexing(device, params, client, raw)

    print(json.dumps({"kernels": [
        {"name": "ntt", "route": "cuda", "source": "pir_tpu_torch/csrc/ntt.cu",
         "replaces": "pir_tpu/ops/pallas_mxu_ntt.py:252",
         "launches": counts["ntt"], **ntt},
        {"name": "scan", "route": "cuda", "source": "pir_tpu_torch/csrc/scan.cu",
         "replaces": "pir_tpu/ops/pallas_scan.py:103",
         "launches": counts["scan"], **scan},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
