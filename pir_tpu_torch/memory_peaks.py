"""Peak transient device memory of the three stages whose steps bound the
N=32768 path's memory, at a 2^20-item request's shapes on SEAL's chain (15 ×
55-bit primes and a 56-bit special prime): one key switch over 2^j
ciphertexts in a single step (``ops/keyswitch.py::apply_galois`` with
SWITCH_CHUNK_BYTES lifted: kernels E and A, its transients per ciphertext
beside its digit products'), one upper-level step of k digit columns over
D_0 rows (``ops/scan.py::_upper_level``'s step on the card: kernel F1's
lift, kernel A's forward, kernel F2's contraction and kernel A's inverse,
beside the bytes of the lifted digits), and one
ciphertext-multiplication step over r rows of the upper dimension
(``bfv/multiply.py::bfv_multiply`` of r ciphertexts by r selection
ciphertexts, then ``ops/keyswitch.py::relinearize``), each beside the
bytes of its products (for the multiply, of its widest BEHZ sum product,
[r, 3, L + 1, L, N]).  Then the whole upper level's device time in steps of
each of UPPER_STEP_CANDIDATES bytes.  The measurements behind
``keyswitch.SWITCH_CHUNK_BYTES``, ``scan.UPPER_STEP_BYTES`` and
``scan.CTMULT_STEP_BYTES``.

    python3 -m pir_tpu_torch.memory_peaks --out peaks.json

A shape that does not fit the card is reported as out of memory.  The last
line of output is the JSON result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

SWITCH_CIPHERTEXTS = (8, 16, 32, 64)
UPPER_COLUMNS = (1, 2, 4, 8, 16, 32)
UPPER_STEP_CANDIDATES = (1 << 30, 1 << 31, 1 << 32)
CTMULT_ROWS = (1, 2, 4, 8)


def _transient(fn, device) -> dict:
    """Peak device memory of fn() above what was held before it, in GB."""
    import torch

    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    try:
        fn()
        torch.cuda.synchronize(device)
    except torch.cuda.OutOfMemoryError:
        return {"out_of_memory": True,
                "gb_before_failing": (torch.cuda.max_memory_allocated(device) - base) / 1e9}
    finally:
        torch.cuda.empty_cache()
    return {"transient_gb": (torch.cuda.max_memory_allocated(device) - base) / 1e9}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("memory_peaks: no CUDA device available", file=sys.stderr)
        return 1
    from pir_tpu_torch import kernel_times as kt
    from pir_tpu_torch.bfv.multiply import bfv_multiply, rns_tool_for
    from pir_tpu_torch.core.context import PirContext
    from pir_tpu_torch.core.params import create_pir_parameters
    from pir_tpu_torch.ops import decompose, keyswitch, scan

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    n = kt.SERVED_N
    ep = kt.encryption_params("seal", n)
    ctx = PirContext(create_pir_parameters(kt.ITEMS, kt.ITEM_BYTES, kt.DIMS, ep), device)
    L, Lp, d0 = ctx.L, len(ep.coeff_modulus), kt.request_dims(ep)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    result = {"card": card, "n": n, "switch": [], "upper": [], "ctmult": []}

    key = {3: kt.random_residues(ep.coeff_modulus, (L, 2), n, device, gen)}
    step_bytes = keyswitch.SWITCH_CHUNK_BYTES
    keyswitch.SWITCH_CHUNK_BYTES = 1 << 62  # one step: the unchunked switch
    try:
        for count in SWITCH_CIPHERTEXTS:
            cts = kt.random_residues(ep.ct_modulus, (count, 2), n, device, gen)
            row = {"ciphertexts": count, "products_gb": count * L * 2 * Lp * n * 8 / 1e9,
                   **_transient(lambda: keyswitch.apply_galois(ctx, key, cts, 3), device)}
            if "transient_gb" in row:
                row["transient_gb_per_ciphertext"] = row["transient_gb"] / count
            result["switch"].append(row)
            print(f"key switch of {count} ciphertexts in one step at N={n}: {row} ({card})",
                  flush=True)
            del cts
    finally:
        keyswitch.SWITCH_CHUNK_BYTES = step_bytes
    del key

    sv = kt.random_residues(ep.ct_modulus, (d0, 2), n, device, gen)
    lower = kt.random_residues(ep.ct_modulus, (d0, 1, 2), n, device, gen)  # lower ciphertexts

    def upper_step(cols):
        items = ctx.ntt_q.forward(decompose.lift_columns(ctx, lower, 1, d0, 0, cols))
        return ctx.ntt_q.inverse(scan.contract_dim(ctx, sv, items))

    for cols in UPPER_COLUMNS:
        row = {"columns": cols, "lifted_gb": cols * d0 * L * n * 8 / 1e9,
               **_transient(lambda: upper_step(cols), device)}
        if "transient_gb" in row:
            row["transient_per_lifted"] = row["transient_gb"] / row["lifted_gb"]
        result["upper"].append(row)
        print(f"upper-level step of {cols} digit column(s) over {d0} rows at N={n}: {row} "
              f"({card})", flush=True)
    result["upper_level_ms"] = []
    step_bytes = scan.UPPER_STEP_BYTES
    try:
        for candidate in UPPER_STEP_CANDIDATES:
            scan.UPPER_STEP_BYTES = candidate
            ms = kt.device_ms(lambda: scan._upper_level(
                ctx, lower, 1, d0, lambda items: scan.contract_dim(ctx, sv, items)), 3)
            row = {"step_bytes": candidate, "columns": scan.upper_step_columns(d0, L, n),
                   "ms": ms}
            result["upper_level_ms"].append(row)
            print(f"the whole upper level at N={n} in steps of {candidate} bytes: {row} ({card})",
                  flush=True)
    finally:
        scan.UPPER_STEP_BYTES = step_bytes
    del sv, lower

    rns_tool_for(ctx)  # the BEHZ tool's tables are held, not transient
    relin = kt.random_residues(ep.coeff_modulus, (L, 2), n, device, gen)
    for rows in CTMULT_ROWS:
        cts = kt.random_residues(ep.ct_modulus, (1, rows, 2), n, device, gen)
        sel = kt.random_residues(ep.ct_modulus, (1, rows, 2), n, device, gen)
        row = {"rows": rows, "products_gb": rows * 3 * (L + 1) * L * n * 8 / 1e9,
               **_transient(lambda: keyswitch.relinearize(ctx, relin, bfv_multiply(ctx, cts, sel)),
                            device)}
        result["ctmult"].append(row)
        print(f"ct-mult multiply + relinearize of {rows} row(s) in one step at N={n}: {row} "
              f"({card})", flush=True)
        del cts, sel
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
