"""Device times of kernels A (NTT) and B (scan) at the shapes one
single-query request at the bench configuration gives them (2^20 items of
288 B, d=2, N=4096, SEAL's chain; the tpu32 profile and one rank of the
meshes for kernel B's other cases), each checked bit-equal to its plain
version first.  ``chip_smoke.py`` makes its checks of both kernels through
:func:`time_ntt` and :func:`time_scan`.

    python3 pir_tpu_torch/kernel_times.py --out chiprun_out/times.json
    python3 pir_tpu_torch/kernel_times.py --root build/parent --label parent

``--root`` imports ``pir_tpu_torch`` from another checkout (an older tree
unpacked with ``git archive``), so that two designs are timed by the same
code on one card in one run.  Times come from CUDA events around `reps`
back-to-back launches queued behind ``torch.cuda._sleep``, so they are the
card's time, not the host's time to launch.  The last line of output is
the JSON result.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4  # 132 SMs x 64 INT32 lanes x 1.98 GHz
# 32-bit multiplies per Shoup product x w mod q: 4 for each 64-bit low
# product (x w, quotient q) and 8 for the quotient's 64-bit high product
MULS_SHOUP = 16
MULS_SHOUP_GROW = 12  # kernel A's growing butterflies: the quotient from 3 partial products
MULS_48BIT = 8   # per product with a hi plane (kernel B's three-word sum)
MULS_32BIT = 3   # without
POLY_DEGREE = 4096
PLAIN_BITS = 24


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


def chains():
    from pir_tpu_torch.core.params import generate_encryption_params

    return {"seal": generate_encryption_params(POLY_DEGREE, PLAIN_BITS),
            "tpu32": generate_encryption_params(POLY_DEGREE, PLAIN_BITS, profile="tpu32")}


def time_ntt(device, gen, plain=(), reps: int = 50) -> "list[dict]":
    """Kernel A at every request shape and at N=256 (K3's ring): bit-equal
    to plain and undone exactly by the opposite transform, then timed; the
    plain version is timed too at the (label, inverse) pairs in `plain`."""
    from pir_tpu_torch.core import primes
    from pir_tpu_torch.ops import ntt as ntt_mod
    from pir_tpu_torch.ops.ntt import NttTables, ntt_cuda, ntt_plain

    # a tree from before the growing butterflies reduces at every stage
    grows = getattr(ntt_mod, "grows", lambda moduli: False)
    chain = chains()["seal"].coeff_modulus
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
               **ntt_bound(x, t.n, len(t.moduli), grows(t.moduli))}
        if (label, inverse) in plain:
            row["plain_ms"] = device_ms(lambda: ntt_plain(t, x, inverse), 3)
        rows.append(row)
    return rows


def request_sums(ntt_rows) -> "tuple[float, float]":
    """Σ time and Σ bound of kernel A over one request's 22 launches."""
    request = [r for r in ntt_rows if r["label"] != "N=256"]
    return sum(r["ms"] for r in request), sum(r["bound_ms"] for r in request)


def scan_cases():
    """(label, profile, limb or None, P, D) of kernel B's main-path shapes."""
    return [("K1 inner", "seal", None, 162, 162), ("K1 upper", "seal", None, 8, 162),
            ("K5 inner", "tpu32", None, 162, 162), ("K5 upper", "tpu32", None, 12, 162),
            ("K6 seal rank", "seal", 1, 81, 162), ("K6 tpu32 rank", "tpu32", 2, 162, 162)]


def time_scan(device, gen, plain: bool = False, reps: int = 20) -> "list[dict]":
    """Kernel B at the single-query scans (K1 with a hi plane, K5 without)
    and at one rank's shapes of the limb-sharded meshes (K6), bit-equal to
    plain, then timed (the plain version too where `plain`)."""
    from pir_tpu_torch.ops import modular, scan_kernel

    rows = []
    for label, profile, limb, P, D in scan_cases():
        chain = chains()[profile].ct_modulus
        bits = max(q.bit_length() for q in chain)
        limbs = modular.LimbConstants(chain, device)
        if limb is not None:
            limbs = limbs.limb_range(limb, limb + 1)
        sv = random_residues(limbs.moduli, (D, 2), POLY_DEGREE, device, gen)
        db = random_residues(limbs.moduli, (P, D), POLY_DEGREE, device, gen)
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


def ntt_line(r) -> str:
    return (f"kernel A {r['label']} {r['shape']} {'inverse' if r['inverse'] else 'forward'}: "
            f"bit-equal to plain (max_abs_err {r['max_abs_err']}), round trip exact; "
            f"{r['ms']:.4f} ms" + (f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r else "")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def scan_line(r) -> str:
    return (f"kernel B {r['label']} sv {r['sv']} planes {r['planes']} (hi plane {r['hi_plane']}): "
            f"bit-equal to plain (max_abs_err {r['max_abs_err']}); {r['ms']:.4f} ms "
            f"({r['planes_gb_per_s']:.1f} GB/s of planes)"
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

    for k in (kernels.NTT, kernels.SCAN):
        k.lib()
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{args.label}] {k.name} ptxas: {line.strip()}", flush=True)
    ntt = time_ntt(device, gen)
    scan = time_scan(device, gen)
    request_ms, request_bound_ms = request_sums(ntt)
    result = {"label": args.label, "package": pir_tpu_torch.__file__, "card": card,
              "ntt": ntt, "scan": scan,
              "ntt_request_ms": request_ms, "ntt_request_bound_ms": request_bound_ms}
    for line in [ntt_line(r) for r in ntt] + [scan_line(r) for r in scan]:
        print(f"[{args.label}] {line}", flush=True)
    print(f"[{args.label}] kernel A over one request's 22 launches: "
          f"{request_ms:.4f} ms (bound {request_bound_ms:.4f}); {card}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
