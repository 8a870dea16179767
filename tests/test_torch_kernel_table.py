"""chip_smoke.py's kernel table names every TPU kernel of pir_tpu, and its
table of kernels for work pir_tpu leaves to XLA (kernels E, F and G) names
what each entry replaces.

Every kernel body that a ``pl.pallas_call`` in ``pir_tpu/ops/pallas_*.py``
reaches is found by reading the sources as text (``ast``, no JAX import) and
must be named, by file and line of its ``def``, in exactly one row of
``chip_smoke.KERNEL_ROWS`` — the table whose rows ``chip_smoke.main`` prints
as its ``kernels`` line.
"""

import ast
import pathlib

import chip_smoke

REPO = pathlib.Path(__file__).resolve().parents[1]


def _names(node) -> "set[str]":
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _is_pallas_call(node) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "pallas_call")


def pallas_kernels(path: pathlib.Path) -> "tuple[int, set[tuple[str, int]]]":
    """(number of pallas_call sites, {(function name, def line)}) of the
    module-level functions the sites' kernel argument names, following one
    local assignment (``kernel = functools.partial(_raw_kernel, ...)``)."""
    tree = ast.parse(path.read_text())
    top = {f.name: f.lineno for f in tree.body if isinstance(f, ast.FunctionDef)}
    sites, found = set(), set()
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        assigned = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        assigned.setdefault(target.id, []).append(node)
        for call in ast.walk(fn):
            if not _is_pallas_call(call) or not call.args:
                continue
            sites.add(call.lineno)  # a nested function's site is walked twice
            names = _names(call.args[0])
            for name in list(names):
                for a in assigned.get(name, []):
                    if a.lineno < call.lineno:
                        names |= _names(a.value)
            found |= {(n, top[n]) for n in names if n in top}
    return len(sites), found


def test_every_pallas_kernel_has_a_row():
    files = sorted((REPO / "pir_tpu" / "ops").glob("pallas_*.py"))
    assert [f.name for f in files] == ["pallas_mxu_ntt.py", "pallas_ntt.py", "pallas_scan.py"]
    kernels = {}
    sites = 0
    for f in files:
        n, found = pallas_kernels(f)
        assert n >= 1 and found, f.name
        sites += n
        for name, line in found:
            kernels[f"pir_tpu/ops/{f.name}:{line}"] = name
    assert sites == 9
    assert sorted(kernels.values()) == sorted([
        "_make_kernel", "_ntt_kernel", "_raw_kernel", "_raw_kernel_dyn",
        "_raw_kernel_u32", "_raw_kernel_u32_dyn", "_raw_kernel_wide",
        "_raw_kernel_wide_u32", "_scan_kernel",
    ])
    named = [r for row in chip_smoke.KERNEL_ROWS for r in row.replaces]
    assert len(named) == len(set(named))
    assert set(named) == set(kernels)


def test_kernel_rows_are_complete():
    rows = chip_smoke.KERNEL_ROWS
    assert len(rows) == 8
    assert len({r.name for r in rows}) == 8
    for row in rows:
        assert (REPO / "pir_tpu_torch" / "csrc" / row.source).exists()
        assert row.launches and all(path and variant for path, variant in row.launches)
    assert {r.check for r in rows} == {"K1", "K2", "K3", "K4", "K4-u32", "K5", "K6", "K7"}


def _names_existing_lines(row) -> bool:
    for ref in row.replaces:
        path, line = ref.split(":")
        assert path.startswith("pir_tpu/ops/")
        assert (REPO / path).read_text().splitlines()[int(line) - 1].strip(), ref
    return True


def test_xla_kernel_rows_name_kernel_e():
    """Kernel E's rows, a table of their own (they replace code pir_tpu
    leaves to XLA, not Pallas bodies): one row per entry, each naming lines
    of pir_tpu's key switch, Galois permutation or expansion that exist,
    counted on every served path."""
    rows = chip_smoke.XLA_KERNEL_ROWS[:4]
    assert [r.check for r in rows] == ["E1", "E2", "E3", "E4"]
    assert not {r.name for r in rows} & {r.name for r in chip_smoke.KERNEL_ROWS}
    for row in rows:
        assert (REPO / "pir_tpu_torch" / "csrc" / row.source).exists()
        assert [path for path, _ in row.launches] == ["*"]
        assert _names_existing_lines(row)
    assert {v for r in rows for _, v in r.launches} == set(chip_smoke.KEYSWITCH_VARIANTS)


def test_xla_kernel_rows_name_kernel_f():
    """Kernel F's rows follow kernel E's: one row per entry (F1 lift, F2
    contraction, F3 mod switch, F4 plane split) in csrc/upper.cu, each
    naming the lines of pir_tpu's decomposition, upper level, contraction,
    plane split or mod switch it replaces (the functions' defs, and the
    upper level's decomposition block), counted
    under its own name on the served paths chip_smoke.py drives, every path
    with an upper level lifting (F1) and splitting (F4, planes) or
    contracting (F2, Shoup table), and a headline case for each."""
    import ast

    rows = chip_smoke.XLA_KERNEL_ROWS[4:8]
    assert [r.check for r in rows] == ["F1", "F2", "F3", "F4"]
    variants = ["pir_upper.lift", "pir_upper.contract", "pir_upper.modswitch", "pir_upper.split"]
    assert [{v for _, v in r.launches} for r in rows] == [{v} for v in variants]
    for row in rows:
        assert row.source == "upper.cu"
        assert _names_existing_lines(row)
        for ref in row.replaces:
            path, line = ref.split(":")
            defs = {f.lineno for f in ast.walk(ast.parse((REPO / path).read_text()))
                    if isinstance(f, ast.FunctionDef)}
            # F1's second line is the upper level's decomposition block
            assert int(line) in defs or ref == "pir_tpu/ops/scan.py:206", ref
        paths = [p for p, _ in row.launches]
        assert paths and "*" not in paths and len(paths) == len(set(paths))
    lift, contract, _, split = ({p for p, _ in r.launches} for r in rows)
    assert contract <= lift and lift == (split - {"mesh", "mesh32", "shard_mesh"}) | contract
    assert not split & contract
    assert set(chip_smoke.UPPER_HEAD) == {"F1", "F2", "F3", "F4"}
    import pir_tpu_torch.kernel_times as kt

    labels = {c[0] for c in kt.upper_cases()} | {c[0] for c in kt.modswitch_cases()}
    assert set(chip_smoke.UPPER_HEAD.values()) <= labels


def test_xla_kernel_rows_name_kernel_g():
    """Kernel G's rows close the table: one row per entry (G1 lift, G2
    tensor product, G3 floor and Shenoy-Kumaresan conversion) in
    csrc/behz.cu, each naming the defs of pir_tpu's BEHZ steps it replaces
    (RnsTool's conversions, bfv_multiply's tensor product), counted under its
    own name on every ciphertext-multiplication path chip_smoke.py drives."""
    import ast

    rows = chip_smoke.XLA_KERNEL_ROWS[8:]
    assert [r.check for r in rows] == ["G1", "G2", "G3"]
    assert [{v for _, v in r.launches} for r in rows] == [{v} for v in chip_smoke.BEHZ_VARIANTS]
    for row in rows:
        assert row.source == "behz.cu"
        assert (REPO / "pir_tpu_torch" / "csrc" / row.source).exists()
        for ref in row.replaces:
            path, line = ref.split(":")
            assert path in ("pir_tpu/core/rns.py", "pir_tpu/bfv/multiply.py"), ref
            defs = {f.lineno for f in ast.walk(ast.parse((REPO / path).read_text()))
                    if isinstance(f, ast.FunctionDef)}
            assert int(line) in defs, ref
        assert [p for p, _ in row.launches] == list(chip_smoke._CT_MULTIPLIED)
