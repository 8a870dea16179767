"""What bounds kernel C (csrc/scan_wide.cu): its device time at the four
batched shapes of :func:`kernel_times.wide_cases`, under other launch
layouts than :func:`scan_kernel.scan_wide_plan`'s and with parts of the
kernel taken out.

    python3 pir_tpu_torch/scan_wide_variants.py --out variants.json

Source variants, each built with nvcc from a text edit of the source and
called through ctypes with the plan's layout:

* ``as built``: the source itself (its output checked bit-equal to
  ``contract_wide_cuda``'s, at every layout below too);
* ``no multiply-adds``: the copies, the barriers and the stores only;
* ``no copies``: the multiply-adds on whatever the ring holds;
* ``cached rows``: every stage copies the tile's first rows again, so every
  byte comes from cache: what is left of the time is not device memory or
  L2.

Layouts (``as built``): the plan's; 3 stages against 2 and 4; a block of
32 prefixes x 8 columns against 16 x 16.  Times are device times of 5
back-to-back launches behind a ``torch.cuda._sleep``
(``kernel_times.device_ms``).  The last line of output is the JSON result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "scan_wide.cu"
# name -> [(text of the source, its replacement)]
EDITS = {
    "as built": [],
    "no multiply-adds": [("const int nrows = !computes ? 0 :", "const int nrows = true ? 0 :")],
    "no copies": [("to += pc.row) pc.copy(to, from);", "to += pc.row) {}")],
    "cached rows": [("const unsigned char* from = pc.src + j0 * pc.stride;",
                     "const unsigned char* from = pc.src;")],
}


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
        lib.pir_scan_wide.argtypes = kernels.SCAN_WIDE._entry_points["pir_scan_wide"]
        lib.pir_scan_wide.restype = ctypes.c_int
        libs[name] = (lib, [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln])
    return libs


# (label, plan fields that differ from the plan's) of the layouts timed
LAYOUTS = [("plan", {}), ("2 stages", {"stages": 2}), ("4 stages", {"stages": 4}),
           ("32 x 8 block", {"prefixes": 32, "columns": 8})]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    if __spec__ is None:  # run as a file: its own directory must not shadow modules
        sys.path.pop(0)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("scan_wide_variants: no CUDA device available", file=sys.stderr)
        return 1
    from pir_tpu_torch import kernel_times as kt
    from pir_tpu_torch.ops import modular, scan_kernel

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))
        for name, (_, ptxas) in libs.items():
            for line in ptxas:
                print(f"{name}: {line}", flush=True)
        for label, profile, n in kt.wide_cases():
            ep = kt.encryption_params(profile, n)
            chain = ep.ct_modulus
            P, D = kt.request_dims(ep)
            S, L = kt.BATCH_COLUMNS, len(chain)
            limbs = modular.LimbConstants(chain, device)
            sv = kt.random_residues(chain, (D, S), n, device, gen)
            db = kt.random_residues(chain, (P, D), n, device, gen)
            hi, lo = scan_kernel.split_planes(db.transpose(1, 2).contiguous(), chain)
            del db
            hb = 0 if hi is None else hi.element_size()
            want = scan_kernel.contract_wide_cuda(sv, hi, lo, limbs)
            got = torch.empty_like(want)
            plan = scan_kernel.scan_wide_plan(P, S, L, n, D, hb)
            runs = []
            for name, change in LAYOUTS:
                p = dataclasses.replace(plan, **change)
                row_bytes = p.coeffs * (p.columns * 8 + p.prefixes * (4 + hb))
                p = dataclasses.replace(p, shared_bytes=p.stages * p.rows * row_bytes, grid=(
                    -(-S // p.columns), -(-P // p.prefixes), plan.grid[2]))
                if p.shared_bytes <= scan_kernel.SHARED_MAX_BYTES:
                    runs.append(("as built", name, p))
            runs += [(v, "plan", plan) for v in EDITS if v != "as built"]
            for variant, name, p in runs:
                lib = libs[variant][0]
                call = (sv.data_ptr(), 0 if hi is None else hi.data_ptr(), lo.data_ptr(),
                        limbs.table.data_ptr(), got.data_ptr(), hb, P, S, L, D, 0, D, n,
                        p.prefixes, p.columns, p.rows, p.stages, p.shared_bytes, *p.grid,
                        torch.cuda.current_stream(device).cuda_stream)

                def run():
                    rc = lib.pir_scan_wide(*call)
                    if rc:
                        raise RuntimeError(f"{variant} {name} refused: {rc}")

                got.zero_()
                run()
                if variant == "as built" and not torch.equal(got, want):
                    raise AssertionError(f"{label}: the {name} layout differs from the plan's")
                row = {"label": label, "variant": variant, "layout": name,
                       "block": [p.prefixes, p.columns], "rows": p.rows, "stages": p.stages,
                       "shared_bytes": p.shared_bytes,
                       "ms": kt.device_ms(run, 5)}
                rows.append(row)
                print(f"kernel C ({label}) {variant}, {name} ({p.prefixes} x {p.columns} block, "
                      f"{p.stages} stages of {p.rows} rows): "
                      f"{row['ms']:.4f} ms", flush=True)
            del sv, hi, lo, want, got
            torch.cuda.empty_cache()
    result = {"card": card, "rows": rows}
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
