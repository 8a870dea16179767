"""What bounds the exact wide contraction behind kernels E2 and F2
(csrc/contract.cuh): device times at the served shapes of
:func:`kernel_times.keyswitch_cases` (E2) and :func:`kernel_times.upper_cases`
(F2), with parts of the kernel taken out, under other launch layouts than
:func:`scan_kernel.contract_plan`'s, and, with ``--parent``, the same parts
taken out of another checkout's E2 and F2 (the designs of
``csrc/keyswitch.cu`` and ``csrc/upper.cu`` before csrc/contract.cuh).

    python3 pir_tpu_torch/contract_variants.py --out variants.json
    python3 pir_tpu_torch/contract_variants.py --parent build/parent

Source variants, each built with nvcc from a text edit of the source and
called through ctypes:

* ``as built``: the source itself (its output checked bit-equal to the
  wrapper's, at every layout below too);
* ``no reduction epilogue``: each Barrett reduction of a sum returns the
  sum's low word;
* ``no multiply-adds``: the operands of each product are added, not
  multiplied into the sums;
* ``cached rows``: every row tile copies (reads) the first row tile's words
  again, so x comes from cache: what is left of the time is not x's
  device-memory traffic;
* ``2 blocks an SM``, ``4 blocks an SM``: a register budget of 128 or 64 a
  thread (``__launch_bounds__`` for two or four blocks of 8 warps an SM) in
  place of 80 (three);
* ``no earlier i-block words``: a later i-block adds its sums to 0, not to
  the words the earlier ones stored (F2 at N=4096: the cost of reading
  them back);
* ``64-bit products``: the 64-bit path's products as a 64-bit low and a
  64-bit high product added into the sum in place of four 32-bit products
  on the carry chain (modarith.cuh::mac128w).

Layouts (``as built``): the plan's; 3 stages; one row group, and twice the
plan's; half the plan's rows a tile.  Times are device times of 10 back-to-back launches behind a
``torch.cuda._sleep`` (``kernel_times.device_ms``); with ``--parent``,
each shape is timed parent, change, change, parent.  The last line of
output is the JSON result.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
HEADER = "contract.cuh"
ENTRIES = {"E2": ("keyswitch.cu", "pir_ks_inner"), "F2": ("upper.cu", "pir_contract")}
# name -> [(text of csrc/contract.cuh, its replacement)]
EDITS = {
    "as built": [],
    "no reduction epilogue": [
        ("if (m.above32) return barrett_reduce_96_short(a2, lo, m.q, m.ratio96);\n"
         "    return barrett_reduce_96(a2, lo, m.q, m.ratio_hi, m.ratio_lo);", "return lo;"),
        ("return barrett_reduce_128(hi(), lo(), m.q, m.ratio_hi, m.ratio_lo);", "return lo();")],
    "no multiply-adds": [
        ("acc[t][0].add(v, wk[m][0]);\n            acc[t][1].add(v, wk[m][1]);",
         "res[t][0] += v + wk[m][0];\n            res[t][1] += v + wk[m][1];")],
    "cached rows": [("const uint64_t* from = src + (r * a.I + i) * plane;",
                     "const uint64_t* from = src + ((r - st.r0) * a.I + i) * plane;")],
    "2 blocks an SM": [("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 2;")],
    "4 blocks an SM": [("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 4;")],
    "no earlier i-block words": [("prev[u] = o != nullptr ? load_word(o) : 0;", "prev[u] = 0;")],
    "64-bit products": [
        ("    mac128w(a0, a1, a2, a3, static_cast<uint32_t>(x), static_cast<uint32_t>(x >> 32),\n"
         "            static_cast<uint32_t>(w), static_cast<uint32_t>(w >> 32));",
         "    uint64_t l = lo(), h = hi();\n    const uint64_t p = x * w;\n    l += p;\n"
         "    h += __umul64hi(x, w) + (l < p ? 1 : 0);\n"
         "    a0 = static_cast<uint32_t>(l);\n    a1 = static_cast<uint32_t>(l >> 32);\n"
         "    a2 = static_cast<uint32_t>(h);\n    a3 = static_cast<uint32_t>(h >> 32);")],
}
# the same parts taken out of the designs before csrc/contract.cuh, by file
PARENT_EDITS = {
    "as built": {},
    "no reduction epilogue": {
        "keyswitch.cu": [
            ("o[0] = barrett_reduce_128(hi0[t], lo0[t], q, ratio_hi, ratio_lo);", "o[0] = lo0[t];"),
            ("o[plane] = barrett_reduce_128(hi1[t], lo1[t], q, ratio_hi, ratio_lo);",
             "o[plane] = lo1[t];")],
        "upper.cu": [
            ("acc0[t] = add_mod(acc0[t], barrett_reduce_128(hi0[t], lo0[t], q, ratio_hi, ratio_lo), q);",
             "acc0[t] += lo0[t];"),
            ("acc1[t] = add_mod(acc1[t], barrett_reduce_128(hi1[t], lo1[t], q, ratio_hi, ratio_lo), q);",
             "acc1[t] += lo1[t];")]},
    "no multiply-adds": {
        "keyswitch.cu": [("mac128(lo0[t], hi0[t], x, k0);\n        mac128(lo1[t], hi1[t], x, k1);",
                          "lo0[t] += x + k0;\n        lo1[t] += x + k1;")],
        "upper.cu": [("mac128(lo0[t], hi0[t], w, k0);\n          mac128(lo1[t], hi1[t], w, k1);",
                      "lo0[t] += w + k0;\n          lo1[t] += w + k1;")]},
    "cached rows": {
        "keyswitch.cu": [("const uint64_t* d = digits + (r0 * L + i) * plane + col;",
                          "const uint64_t* d = digits + i * plane + col;")],
        "upper.cu": [("const uint64_t* x = items + (p0 * D + d) * plane + col;",
                      "const uint64_t* x = items + d * plane + col;")]},
}
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# the parent's entries: digits, key, qp, out, R, L, Lp, N, stream and sv,
# items, lq, out, P, D, L, N, chunk, stream
PARENT_ARGS = {"pir_ks_inner": [_P, _P, _P, _P, _I64, _I32, _I32, _I64, _P],
               "pir_contract": [_P, _P, _P, _P, _I64, _I64, _I32, _I64, _I64, _P]}
# (label, plan fields that differ from the plan's) of the layouts timed
LAYOUTS = ["plan", "3 stages", "1 row group", "2x row groups", "half the rows"]


def _edited(text: str, edits, what: str) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"variant {what!r}: {old!r} is not in the source once")
        text = text.replace(old, new)
    return text


def variant_source(name: str) -> str:
    """csrc/contract.cuh with variant `name`'s edits."""
    return _edited((CSRC / HEADER).read_text(), EDITS[name], name)


def _nvcc(src_dir: pathlib.Path, cu: str, so: pathlib.Path):
    from pir_tpu_torch import kernels

    return subprocess.Popen([kernels.nvcc_path(), *kernels.NVCC_FLAGS, f"-I{src_dir}", "-o",
                             str(so), str(src_dir / cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_lines(log: str) -> "list[str]":
    """nvcc's -Xptxas -v lines on each kernel's registers and spills, each
    after the kernel's name (the contraction's as contract_kernel<path,
    rows, terms, later i-blocks>)."""
    out = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"contract_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E", line)
            name = (f"contract_kernel<{m[1]}, {m[2]}, {m[3]}, {bool(int(m[4]))}>" if m else
                    line.split("'")[1] if "'" in line else line)
            out.append(f"kernel {name}")
        elif "registers" in line or "spill" in line:
            out.append(line.strip())
    return out


def build(out_dir: pathlib.Path, parent: "pathlib.Path | None") -> dict:
    """nvcc for every (side, variant, entry file) at once -> {(side, variant,
    entry): (ctypes function, ptxas lines)}."""
    from pir_tpu_torch import kernels

    procs = {}
    for i, name in enumerate(EDITS):
        d = out_dir / f"change{i}"
        shutil.copytree(CSRC, d)
        (d / HEADER).write_text(variant_source(name))
        for entry, (cu, _) in ENTRIES.items():
            procs[("change", name, entry)] = (d / f"lib{entry}.so", _nvcc(d, cu, d / f"lib{entry}.so"))
        if parent is None or name not in PARENT_EDITS:
            continue
        d = out_dir / f"parent{i}"
        shutil.copytree(parent / "pir_tpu_torch" / "csrc", d)
        for entry, (cu, _) in ENTRIES.items():
            (d / cu).write_text(_edited((d / cu).read_text(), PARENT_EDITS[name].get(cu, []),
                                        f"parent {name}"))
            procs[("parent", name, entry)] = (d / f"lib{entry}.so", _nvcc(d, cu, d / f"lib{entry}.so"))
    fns = {}
    for key, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        fn_name = ENTRIES[key[2]][1]
        fn = getattr(ctypes.CDLL(str(so)), fn_name)
        fn.argtypes = (kernels.KEYSWITCH if key[2] == "E2" else kernels.UPPER)._entry_points[
            fn_name] if key[0] == "change" else PARENT_ARGS[fn_name]
        fn.restype = ctypes.c_int
        fns[key] = (fn, ptxas_lines(log))
    return fns


def layout(plan, name: str, R: int, I: int):
    """The plan with layout `name`'s fields, or None where it is the plan's."""
    from pir_tpu_torch.ops import scan_kernel

    rows = max(1, plan.rows // 2) if name == "half the rows" else plan.rows
    row_tiles = -(-R // rows)
    groups = {"1 row group": 1, "2x row groups": min(row_tiles, 2 * plan.grid[1])}.get(
        name, plan.grid[1])
    steps = -(-I // (plan.splits * plan.terms)) * -(-row_tiles // groups)
    stages = min(3 if name == "3 stages" else scan_kernel.CONTRACT_STAGES, steps)
    if name != "plan" and (rows, groups, stages) == (plan.rows, plan.grid[1], plan.stages):
        return None
    return dataclasses.replace(plan, rows=rows, stages=stages, grid=(plan.grid[0], groups),
                               shared_bytes=scan_kernel.contract_shared_bytes(
                                   rows, plan.terms, plan.coeff_warps, plan.splits, stages))


def cases(device, gen):
    """(label, entry, x, w, limbs, chunk, reference, bound) at every E2
    shape of keyswitch_cases() and F2 shape of upper_cases(), one at a
    time."""
    from pir_tpu_torch import kernel_times as kt
    from pir_tpu_torch.core.context import PirContext
    from pir_tpu_torch.core.params import create_pir_parameters
    from pir_tpu_torch.ops import keyswitch, scan, scan_kernel

    for label, profile, n, rows, level, _ in kt.keyswitch_cases():
        ep = kt.encryption_params(profile, n)
        ctx = PirContext.for_params(create_pir_parameters(kt.ITEMS, kt.ITEM_BYTES, kt.DIMS, ep),
                                    device)
        digits = kt.random_residues(ctx.key_moduli, (rows, ctx.L), n, device, gen)
        key = kt.random_residues(ctx.key_moduli, (ctx.L, 2), n, device, gen)
        yield (label, "E2", digits, key, ctx.limbs_qp,
               min(ctx.L, scan_kernel.contract_chunk(ctx.key_moduli)),
               keyswitch.inner_product_cuda(ctx.limbs_qp, digits, key),
               kt.keyswitch_bounds(ctx.L, ctx.Lp, n, rows, level is not None, 0, 0)["E2"])
    for label, profile, n, _, c0, c1, entries in kt.upper_cases():
        if "F2" not in entries:
            continue
        ep = kt.encryption_params(profile, n)
        ctx = PirContext.for_params(create_pir_parameters(kt.ITEMS, kt.ITEM_BYTES, kt.DIMS, ep),
                                    device)
        d0 = kt.request_dims(ep)[0]
        items = kt.random_residues(ctx.ct_moduli, (c1 - c0, d0), n, device, gen)
        sv = kt.random_residues(ctx.ct_moduli, (d0, 2), n, device, gen)
        chunks = -(-d0 // scan_kernel.contract_chunk(ctx.ct_moduli))
        yield (label, "F2", items, sv, ctx.limbs_q,
               min(d0, scan_kernel.contract_chunk(ctx.ct_moduli)),
               scan.contract_dim_cuda(ctx.limbs_q, sv, items),
               kt.upper_bounds("F2", P=c1 - c0, D=d0, L=ctx.L, N=n, chunks=chunks))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="also time this checkout's E2 and F2 (from before "
                    "csrc/contract.cuh) with the same parts taken out")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    if __spec__ is None:  # run as a file: its own directory must not shadow modules
        sys.path.pop(0)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import torch

    if not torch.cuda.is_available():
        print("contract_variants: no CUDA device available", file=sys.stderr)
        return 1
    from pir_tpu_torch import kernel_times as kt
    from pir_tpu_torch.ops import scan_kernel

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    parent = pathlib.Path(args.parent).resolve() if args.parent else None
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(pathlib.Path(tmp), parent)
        for (side, name, entry), (_, ptxas) in fns.items():
            for line in ptxas:
                print(f"{side} {name} {entry}: {line}", flush=True)
        for label, entry, x, w, limbs, chunk, want, bound in cases(device, gen):
            I, J, N = w.shape[0], w.shape[2], w.shape[3]
            R = x.numel() // (I * J * N)
            plan = scan_kernel.contract_plan(R, I, J, N, max(limbs.moduli).bit_length())
            got = torch.empty_like(want)
            stream = torch.cuda.current_stream(device).cuda_stream
            runs = []  # (side, variant, layout name, plan or None, repeat)
            if parent is not None:
                runs += [("parent", v, "-", None, 1) for v in PARENT_EDITS]
            runs += [("change", "as built", name, p, 1) for name in LAYOUTS
                     if (p := layout(plan, name, R, I)) is not None]
            runs += [("change", v, "plan", plan, 1) for v in EDITS if v != "as built"]
            runs += [("change", "as built", "plan", plan, 2)]
            if parent is not None:
                runs += [("parent", "as built", "-", None, 2)]
            for side, variant, name, p, repeat in runs:
                fn = fns[(side, variant, entry)][0]
                if side == "change":
                    call = (x.data_ptr(), w.data_ptr(), limbs.table.data_ptr(), got.data_ptr(),
                            R, I, J, N, chunk, p.path, p.rows, p.terms, p.coeff_warps,
                            p.splits, p.stages, p.shared_bytes, *p.grid, stream)
                elif entry == "E2":
                    call = (x.data_ptr(), w.data_ptr(), limbs.table.data_ptr(), got.data_ptr(),
                            R, I, J, N, stream)
                else:
                    old_chunk = max(1, ((1 << 127) - 1) // (max(limbs.moduli) - 1) ** 2)
                    call = (w.data_ptr(), x.data_ptr(), limbs.table.data_ptr(), got.data_ptr(),
                            R, I, J, N, old_chunk, stream)

                def run():
                    rc = fn(*call)
                    if rc:
                        raise RuntimeError(f"{side} {variant} {name} refused: {rc}")

                got.fill_(-1)
                run()
                if variant == "as built" and not torch.equal(got, want):
                    raise AssertionError(f"{label}: {side}'s {entry} ({name}) differs")
                row = {"label": label, "entry": entry, "side": side, "variant": variant,
                       "layout": name, "repeat": repeat, "ms": kt.device_ms(run, 10), **bound}
                if p is not None:
                    row["plan"] = dataclasses.asdict(p)
                rows.append(row)
                print(f"{entry} {label}: {side} {variant}, {name}"
                      + (f" (rows {p.rows}, terms {p.terms}, {p.coeff_warps} x {p.splits} warps, "
                         f"{p.stages} stages, grid {p.grid})" if p is not None else "")
                      + (" again" if repeat > 1 else "")
                      + f": {row['ms']:.4f} ms, bound {bound['bound_ms']:.4f} ms "
                        f"({bound['bound_ms'] / row['ms']:.1%})", flush=True)
            del x, w, want, got
            torch.cuda.empty_cache()
    result = {"card": card, "rows": rows}
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
