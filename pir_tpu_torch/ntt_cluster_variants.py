"""What bounds kernel A's split rings (csrc/ntt.cu::ntt_cluster_kernel, one
thread-block cluster a polynomial limb at N=16384 and 32768): its device
time at the served N=32768 request's largest shapes and at the N=16384
request's largest key-switch shape, with parts of the kernel taken out and
at another cluster size.

    python3 pir_tpu_torch/ntt_cluster_variants.py --out variants.json

Source variants, each built with nvcc from a text edit of csrc/ntt.cu and
called through ctypes:

* ``as built``: the source itself (its output checked bit-equal to
  ``ntt_cuda``'s);
* ``no DSMEM exchange``: the words crossing between the top stages and
  the sub-blocks come from the CTA's own shared memory (the same count of
  conflict-free loads) instead of its siblings'; the cluster barriers
  stay;
* ``no butterflies``: every radix-2 stage taken out, the inverse's last
  one with n^-1 folded in too (the twiddle loads, now unused, go with
  them): the loads, exchanges, barriers and stores;
* ``half the CTAs``: 8,192-word sub-blocks, so half as many CTAs of 1,024
  threads a cluster (4 at N=32768, 2 at 16384), 68 KB of shared memory a
  CTA (checked bit-equal too).

Each row carries the variant's clusters resident
(``pir_ntt_max_active_clusters``) beside the build's register and spill
lines.  Times are device times of back-to-back launches behind a
``torch.cuda._sleep`` (``kernel_times.device_ms``).  The last line of
output is the JSON result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ntt.cu"
# name -> [(text of the source, its replacement)]
EDITS = {
    "as built": [],
    "no DSMEM exchange": [
        ("a[k] = cluster_load(cluster_map(xs + (((k >> kTop) * kM + rank) * S::kT + t),\n"
         "                                      k & (kM - 1)));",
         "a[k] = xs[((k >> kTop) * kM + rank) * S::kT + t];"),
        ("top[h][m] = cluster_load(cluster_map(xs + padded(h * kTopThreads + g), m));",
         "top[h][m] = xs[padded(((h << kTop) | m) * S::kT + t)];"),
    ],
    "no butterflies": [("  if constexpr (kStep < kBits) {", "  if constexpr (false && kStep < kBits) {"),
                       ("  for (int k = 0; k < kSpan; ++k) {\n    const uint64_t x = a[k], y = a[k + kSpan];\n"
                        "    const uint64_t s = mul_shoup_lazy",
                        "  for (int k = 0; k < 0; ++k) {\n    const uint64_t x = a[k], y = a[k + kSpan];\n"
                        "    const uint64_t s = mul_shoup_lazy"),
                       ("      stage<true, kGrow, kTop, kSubLog + kBl, kBl>(top[h], w, ws, q, q << 1);", "")],
    "half the CTAs": [
        ("constexpr int kSubLog = 12;", "constexpr int kSubLog = 13;"),
        ("case 3: return launch_cluster<kInv, kGrow, 3>(a, in, out, max_clusters);",
         "case 1: return launch_cluster<kInv, kGrow, 1>(a, in, out, max_clusters);"),
    ],
}
SUB_LOG = {"half the CTAs": 13}  # a variant's sub-block, where not 4,096 words
CHECKED = ("as built", "half the CTAs")  # the variants that compute the transform


def variant_source(name: str) -> str:
    src = SOURCE.read_text()
    for old, new in EDITS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old!r} is not in the source once")
        src = src.replace(old, new)
    return src


def build(out_dir: pathlib.Path) -> dict:
    """nvcc for every variant at once -> {name: (ctypes library, ptxas lines)}."""
    from pir_tpu_torch import kernels

    procs = {}
    for i, name in enumerate(EDITS):
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(variant_source(name))
        procs[name] = (out_dir / f"libvariant{i}.so", subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, f"-I{SOURCE.parent}", "-o",
             str(out_dir / f"libvariant{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in kernels.NTT._entry_points.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        ptxas, entry = [], ""
        for line in log.splitlines():  # the cluster kernels' registers and spills
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "ntt_cluster_kernel" in entry and ("registers" in line or "spill" in line):
                ptxas.append(f"{entry}: {line.strip()}")
        libs[name] = (lib, ptxas)
    return libs


def shapes() -> "list[tuple[str, str, int, int, bool]]":
    """(label, chain, batch, n, inverse): the served N=32768 selection
    vector [228, 15, N] both ways and key-switch digits [120, 16, N]
    forward (kernel_times.served_ntt_launches), and the N=16384 SEAL
    request's largest key-switch NTT (kernel_times.large_ring_shapes) both
    ways."""
    from pir_tpu_torch import kernel_times as kt

    served = {label: (chain, batch) for label, chain, batch, _, _ in kt.served_ntt_launches()}
    out = [("N=32768 selection vector", *served["selection vector"], kt.SERVED_N, False),
           ("N=32768 selection vector", *served["selection vector"], kt.SERVED_N, True),
           ("N=32768 key-switch digits", *served["expansion 6 digits"], kt.SERVED_N, False)]
    batch16 = max(b for label, key, b, n in kt.large_ring_shapes() if key == "16384 seal")
    out += [("N=16384 key-switch NTT", "16384 seal", batch16, 16384, inv) for inv in (False, True)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    if __spec__ is None:  # run as a file: its own directory must not shadow modules
        sys.path.pop(0)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import torch

    if not torch.cuda.is_available():
        print("ntt_cluster_variants: no CUDA device available", file=sys.stderr)
        return 1
    from pir_tpu_torch import kernel_times as kt
    from pir_tpu_torch.ops.ntt import NttTables, grows, ntt_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ep = kt.encryption_params("seal", kt.SERVED_N)
    tables = {"qp": NttTables(ep.coeff_modulus, kt.SERVED_N, device),
              "16384 seal": NttTables(kt.encryption_params("seal", 16384).coeff_modulus, 16384,
                                      device)}
    tables["q"] = tables["qp"].slice(len(ep.ct_modulus))
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))
        for name, (_, ptxas) in libs.items():
            for line in ptxas:
                print(f"{name}: {line}", flush=True)
        for label, chain, batch, n, inverse in shapes():
            t = tables[chain]
            L, log_n = len(t.moduli), n.bit_length() - 1
            x = kt.random_residues(t.moduli, (batch,), n, device, gen)
            want = ntt_cuda(t, x, inverse)
            got = torch.empty_like(x)
            grow = grows(t.moduli, n)
            tw, tws = ((t.psi_inv_rev, t.psi_inv_rev_shoup) if inverse
                       else (t.psi_rev, t.psi_rev_shoup))
            for name, (lib, _) in libs.items():
                ctas = n >> SUB_LOG.get(name, 12)
                resident = ctypes.c_int(0)
                rc = lib.pir_ntt_max_active_clusters(log_n, int(inverse), int(grow),
                                                     ctypes.byref(resident))
                if rc or resident.value < 1:
                    raise RuntimeError(f"{name}: a cluster of {ctas} CTAs cannot be resident")
                clusters = batch * L  # one a polynomial
                call = (x.data_ptr(), got.data_ptr(), batch, L, log_n, int(inverse), 3, 1,
                        clusters * ctas, ctas, int(grow), tw.data_ptr(), tws.data_ptr(),
                        t.limbs.table.data_ptr(), t.n_inv.data_ptr(), t.n_inv_shoup.data_ptr(),
                        torch.cuda.current_stream(device).cuda_stream)

                def run():
                    rc = lib.pir_ntt(*call)
                    if rc:
                        raise RuntimeError(f"{name} refused at {label}: {rc}")

                got.fill_(-1)
                run()
                if name in CHECKED and not torch.equal(got, want):
                    raise AssertionError(f"{label}: the {name!r} variant differs from ntt_cuda")
                row = {"label": label, "shape": list(x.shape), "inverse": inverse,
                       "variant": name, "cluster_ctas": ctas, "clusters": clusters,
                       "clusters_resident": resident.value, "ms": kt.device_ms(run, 5),
                       **kt.ntt_bound(x, n, L, grow)}
                rows.append(row)
                print(f"kernel A {label} {row['shape']} {'inverse' if inverse else 'forward'}, "
                      f"{name}: {row['ms']:.4f} ms ({row['bound_ms'] / row['ms']:.1%} of "
                      f"its {row['bound_ms']:.4f} ms bound); {clusters} clusters of {ctas} CTAs, "
                      f"{resident.value} resident", flush=True)
            del x, want, got
            torch.cuda.empty_cache()
    result = {"card": card, "ptxas": {k: v[1] for k, v in libs.items()}, "rows": rows}
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
