"""The launch plans of kernels A (register-radix NTT), B (the scan) and C
(the wide scan) on the CPU: ops/ntt.py::ntt_plan,
ops/scan_kernel.py::scan_plan and ::scan_wide_plan, whose grids the kernels
launch as given (and refuse where they do not cover the work).

The blocks of kernel A's plan hold every polynomial (above N=8192 one
thread-block cluster a limb, a 4,096-word sub-block a block), and its
words per thread follow N; the tiles of kernel B's grid cover every prefix and
coefficient, with a row split of 1, 2, 4 or 8 that never exceeds the rows
(a ragged tail where it does not divide them).  That kernel A's passes
cover every stage once, in order, is checked where the passes are defined,
at compile time (csrc/ntt.cu::windows_cover_every_stage_once, see
tests/test_torch_kernel_emulation.py); that the kernels compute the plain
versions' words under every layout, by the emulation and CUDA tests."""

import pytest

from pir_tpu_torch.ops import scan_kernel
from pir_tpu_torch.ops import ntt as tntt

NS = [64, 128, 256, 512, 1024, 2048, 4096]


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("polys", [1, 5, 6, 32, 384, 648, 1296, 3000])
def test_ntt_plan_threads_cover_every_polynomial(n, polys):
    plan = tntt.ntt_plan(n, polys)
    # 8 words a thread, unless a polynomial would get fewer than two warps
    assert plan.radix_bits == (2 if n < 512 else 3)
    assert plan.threads_per_poly == n >> plan.radix_bits >= min(n // 4, tntt.MIN_POLY_THREADS)
    assert 1 <= plan.polys_per_block <= polys
    assert plan.threads_per_block <= max(tntt.BLOCK_THREADS, plan.threads_per_poly) <= 1024
    assert (plan.blocks - 1) * plan.polys_per_block < polys <= plan.blocks * plan.polys_per_block
    # shared memory: each polynomial's words plus one pad word in 16
    assert plan.polys_per_block * (n + n // 16) * 8 <= 48 * 1024


def test_ntt_plan_at_the_request_shapes():
    """Every N=4096 launch of a request takes 8 words a thread (512 threads a
    polynomial); the N=256 ring 4 words (64 threads a polynomial, 4 to a
    block)."""
    plan = tntt.ntt_plan
    for polys in (2 * 3, 16 * 2, 324 * 2, 648 * 2, 512 * 3, 1296 * 2):
        p = plan(4096, polys)
        assert (p.radix_bits, p.threads_per_block, p.blocks) == (3, 512, polys)
    small = plan(256, 64 * 3)  # the N=256 database
    assert (small.radix_bits, small.threads_per_poly, small.polys_per_block) == (2, 64, 4)
    assert small.blocks == 48
    assert plan(64, 1).threads_per_block == 16
    with pytest.raises(ValueError, match="N=65536"):
        plan(65536, 4)
    with pytest.raises(ValueError, match="N=12288"):
        plan(12288, 4)
    with pytest.raises(ValueError, match="no polynomials"):
        plan(4096, 0)


def test_ntt_grows_below_50_bits():
    assert tntt.grows([0xffffee001, 0xffffc4001, 0x1ffffe0001], 4096)  # SEAL's 36/37-bit chain
    assert tntt.grows([(1 << 50) - 27], 4096)
    assert not tntt.grows([(1 << 36) - 1, (1 << 50) + 55], 4096)
    # above N=8192 the inverse's growth, 2^(log2 N + 1) q, lowers the edge
    assert tntt.grows([(1 << 50) - 27], 8192)
    assert [tntt.grow_max_bits(n) for n in (64, 4096, 8192, 16384, 32768)] == [50, 50, 50, 49, 48]
    assert tntt.grows([(1 << 49) - 1], 16384) and not tntt.grows([(1 << 49) + 1], 16384)
    assert tntt.grows([(1 << 48) - 1], 32768) and not tntt.grows([(1 << 48) + 1], 32768)


@pytest.mark.parametrize("n", [8192, 16384, 32768])
@pytest.mark.parametrize("polys", [1, 5, 15, 448, 1792])
def test_ntt_plan_above_4096(n, polys):
    """N=8192: one 1,024-thread block a limb, 68 KB of shared memory (above
    the 48 KB default; the launch raises the limit).  N=16384, 32768: one
    thread-block cluster of N/4096 CTAs a limb (4 and 8, within the
    portable cluster size), the grid a whole number of clusters, one a
    polynomial; each CTA 512 threads of 8 words holding one 4,096-word
    sub-block, so the cluster covers the limb's words once, in under 48 KB
    of shared memory a CTA (no attribute needed)."""
    plan = tntt.ntt_plan(n, polys)
    assert plan.radix_bits == 3 and plan.polys_per_block == 1  # 8 words a thread
    if n == 8192:
        assert (plan.cluster_ctas, plan.clusters) == (1, polys)
        assert plan.threads_per_block == 1024 and plan.blocks == polys
        assert 48 * 1024 < plan.shared_bytes == (n + n // 16) * 8 <= 227 * 1024
        return
    top_bits = n.bit_length() - 13
    assert plan.cluster_ctas == 1 << top_bits == n // tntt.SUB_BLOCK_N <= 8
    assert plan.blocks % plan.cluster_ctas == 0 and plan.clusters == polys
    assert plan.threads_per_block == 512
    assert plan.cluster_ctas * plan.threads_per_block << plan.radix_bits == n  # each word once
    assert plan.shared_bytes == (4096 + 256) * 8 == 34816 <= 48 * 1024


@pytest.mark.parametrize(
    "P,L,N,D",
    [(162, 2, 4096, 162), (8, 2, 4096, 162), (81, 1, 4096, 162), (162, 1, 4096, 162),
     (12, 3, 4096, 162), (162, 3, 4096, 162), (5, 2, 256, 7), (3, 2, 256, 40),
     (1, 1, 64, 1), (9, 1, 256, 3), (2, 3, 64, 16)],
)
def test_scan_plan_covers_prefixes_coefficients_and_rows(P, L, N, D):
    plan = scan_kernel.scan_plan(P, L, N, D)
    g, r = plan.prefix_groups, plan.row_splits
    assert g * r == scan_kernel.SCAN_WARPS and r in (1, 2, 4, 8)
    assert r <= D  # every split has a row; a ragged tail where r does not divide D
    per_block = g * scan_kernel.SCAN_PREFIXES
    assert (plan.grid[0] - 1) * per_block < P <= plan.grid[0] * per_block
    tile = 32 * scan_kernel.SCAN_VEC
    assert (plan.grid[1] - 1) * tile < N <= plan.grid[1] * tile
    assert plan.grid[2] == L


@pytest.mark.parametrize(
    "label,P,L,D,splits,grid",
    [("K1 inner", 162, 2, 162, 2, (21, 32, 2)), ("K1 upper", 8, 2, 162, 8, (4, 32, 2)),
     ("K5 inner", 162, 3, 162, 2, (21, 32, 3)), ("K5 upper", 12, 3, 162, 8, (6, 32, 3)),
     ("K6 SEAL rank", 81, 1, 162, 8, (41, 32, 1)), ("K6 tpu32 rank", 162, 1, 162, 4, (41, 32, 1))],
)
def test_scan_plan_at_the_request_shapes(label, P, L, D, splits, grid):
    """The inner scans split their rows 2 ways; a small contraction (the
    upper scans, one SEAL rank of a db=2 x limb=2 mesh) over all 8 warps of
    a block; one tpu32 limb 4 ways."""
    plan = scan_kernel.scan_plan(P, L, 4096, D)
    assert (plan.row_splits, plan.grid) == (splits, grid), label


@pytest.mark.parametrize("D,splits", [(1, 1), (2, 2), (3, 2), (4, 4), (7, 4), (8, 8), (162, 8)])
def test_scan_plan_splits_at_most_the_rows(D, splits):
    """A small grid splits as far as its rows allow: 1, 2, 4 or 8 ways."""
    assert scan_kernel.scan_plan(5, 2, 256, D).row_splits == splits
    with pytest.raises(ValueError, match="empty"):
        scan_kernel.scan_plan(0, 2, 4096, D)


@pytest.mark.parametrize("n,profile", [(4096, "seal"), (4096, "tpu32"), (8192, "seal"),
                                       (8192, "tpu32"), (16384, "seal")])
def test_kernel_times_shapes_follow_the_served_request(n, profile):
    """kernel_times derives its checks' scan shapes from a 2^20-item
    request's parameters: its digit count is the server's (ops.decompose),
    and its hypercube and NTT chain are the database's."""
    from pir_tpu_torch import kernel_times as kt
    from pir_tpu_torch.core.context import PirContext
    from pir_tpu_torch.core.params import create_pir_parameters
    from pir_tpu_torch.ops import decompose

    ep = kt.encryption_params(profile, n)
    params = create_pir_parameters(kt.ITEMS, kt.ITEM_BYTES, kt.DIMS, ep)
    assert kt.expansion_ratio(ep) == decompose.expansion_ratio(PirContext(params, "cpu"))
    assert kt.request_dims(ep) == params.dimensions
    cases = {c[0]: c for c in kt.scan_cases() + kt.shoup_cases()}
    if n == 4096 and profile == "seal":
        assert cases["K1 inner"][3:5] == params.dimensions and cases["K1 upper"][3] == 8
    if n == 8192:
        label = "K1 N=8192" if profile == "seal" else "K5 N=8192"
        assert cases[f"{label} inner"][3:] == (*params.dimensions, n)
        assert cases[f"{label} upper"][3:] == (2 * kt.expansion_ratio(ep), params.dimensions[0], n)
    if n == 16384:
        assert cases["K7 N=16384 inner"][1:] == (ep.ct_modulus, *params.dimensions, n)


@pytest.fixture
def one_thread():
    """torch on one thread: the N=4096 transforms below otherwise spin
    every core's worth of threads in each of the suite's workers."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("ct_mult", [False, True], ids=["decomp", "ct_mult"])
def test_served_ntt_launches_are_the_servers(monkeypatch, one_thread, ct_mult):
    """kernel_times.served_ntt_launches, which chip_smoke.py holds kernel A's
    launch counts to, lists every NTT a served request runs: a request at
    N=4096 on SEAL's chain over a small hypercube (the Shoup-table layout),
    its key-switch and ciphertext-multiplication steps cut to 2 rows, served
    on the CPU with each transform recorded by chain, polynomial count and
    direction."""
    import pir_tpu_torch as pt
    from pir_tpu_torch import kernel_times as kt
    from pir_tpu_torch.bfv.multiply import rns_tool_for
    from pir_tpu_torch.ops import keyswitch, scan

    n = 4096
    ep = kt.encryption_params("seal", n)
    params = pt.create_pir_parameters(300, 288, 2, ep, use_ciphertext_multiplication=ct_mult)
    L, Lp = len(ep.ct_modulus), len(ep.coeff_modulus)
    monkeypatch.setattr(keyswitch, "SWITCH_CHUNK_BYTES", 2 * L * 2 * Lp * n * 8)
    monkeypatch.setattr(scan, "CTMULT_STEP_BYTES", 2 * 3 * (L + 1) * L * n * 8)
    items = [bytes([i % 251]) * 288 for i in range(params.num_items)]
    db = pt.PirDatabase.create(items, params, scan_impl="xla", device="cpu")
    client = pt.PirClient(params, seed=1, compress_queries=True, device="cpu")
    server = pt.PirServer(db, params)
    request = client.create_request([params.num_items - 1])
    chains = {tuple(ep.ct_modulus): "q", tuple(ep.coeff_modulus): "qp"}
    if ct_mult:
        chains[rns_tool_for(db.ctx).bsk_moduli] = "bsk"
    seen = {}

    def recorder(fn, inverse):
        def run(self, x):
            key = (chains[self.moduli], x.numel() // (len(self.moduli) * n), inverse)
            seen[key] = seen.get(key, 0) + 1
            return fn(self, x)
        return run

    monkeypatch.setattr(tntt.NttTables, "forward", recorder(tntt.NttTables.forward, False))
    monkeypatch.setattr(tntt.NttTables, "inverse", recorder(tntt.NttTables.inverse, True))
    want = {}
    for _, chain, batch, inverse, launches in kt.served_ntt_launches(n, ct_mult,
                                                                     params.dimensions):
        want[chain, batch, inverse] = want.get((chain, batch, inverse), 0) + launches
    response = server.process_request(request)
    monkeypatch.undo()
    assert params.dimensions == (3, 3) and seen == want
    if ct_mult:
        # (the bench's 24-bit t leaves a ct-mult product at N=4096 no noise
        # budget, so only the decomposition reply is decoded)
        assert any(chain == "bsk" for chain, _, _ in seen)
    else:
        assert client.process_response([params.num_items - 1], response) == [items[-1]]


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 8, 9, 16, 32, 33, 64])
@pytest.mark.parametrize(
    "P,L,N,D,hi_bytes",
    [(162, 2, 4096, 162, 1), (162, 3, 4096, 162, 0), (114, 4, 8192, 114, 2), (114, 6, 8192, 114, 0),
     (5, 1, 64, 3, 2), (65, 2, 70, 40, 1), (1, 1, 1, 1, 0), (16, 2, 96, 9, 2)],
)
def test_scan_wide_plan_covers_columns_prefixes_coefficients_and_limbs(S, P, L, N, D, hi_bytes):
    """Kernel C's grid covers every column, prefix, coefficient and limb;
    the column group is its fastest axis (blocks that read the same
    database slab run side by side), prefix tiles the next; 16 warps of
    4 x 4 tiles a block, at least 16 prefixes a block, at most one 16-byte
    piece of a staged row a thread; the ring of stages fits an H100 block's
    232,448 bytes of shared memory."""
    plan = scan_kernel.scan_wide_plan(P, S, L, N, D, hi_bytes)
    cols, prefix_tiles, z = plan.grid
    assert cols == -(-S // plan.columns) and prefix_tiles == -(-P // plan.prefixes)
    assert (cols - 1) * plan.columns < S <= cols * plan.columns
    assert (prefix_tiles - 1) * plan.prefixes < P <= prefix_tiles * plan.prefixes
    assert z % L == 0 and (z // L - 1) * plan.coeffs < N <= z // L * plan.coeffs
    tile = scan_kernel.SCAN_WIDE_TILE
    assert plan.prefixes * plan.columns == tile * tile * scan_kernel.SCAN_WIDE_WARPS
    assert plan.prefixes >= 16 and plan.columns == (8 if S <= 8 else 16)
    assert 16 * plan.columns + (8 + 2 * hi_bytes) * plan.prefixes <= 32 * scan_kernel.SCAN_WIDE_WARPS
    row_bytes = plan.coeffs * (plan.columns * 8 + plan.prefixes * (4 + hi_bytes))
    assert plan.shared_bytes == plan.stages * plan.rows * row_bytes <= scan_kernel.SHARED_MAX_BYTES
    assert plan.shared_bytes <= 232448 and 2 <= plan.stages <= 4
    assert 1 <= plan.rows <= min(scan_kernel.SCAN_WIDE_ROWS, 1 << (D - 1).bit_length())


@pytest.mark.parametrize(
    "label,P,S,L,N,D,hi_bytes,layout",
    [("K4", 162, 32, 2, 4096, 162, 1, (16, 16, 8, 159744, (2, 11, 256))),
     ("K4-u32", 162, 32, 3, 4096, 162, 0, (16, 16, 8, 147456, (2, 11, 384))),
     ("K4 N=8192", 114, 32, 4, 8192, 114, 2, (16, 16, 8, 172032, (2, 8, 1024))),
     ("K4-u32 N=8192", 114, 32, 6, 8192, 114, 0, (16, 16, 8, 147456, (2, 8, 1536))),
     ("3 queries", 162, 6, 2, 4096, 162, 1, (32, 8, 8, 172032, (1, 6, 256))),
     ("1 query, u16", 114, 2, 4, 8192, 114, 2, (32, 8, 8, 196608, (1, 4, 1024)))],
)
def test_scan_wide_plan_at_the_request_shapes(label, P, S, L, N, D, hi_bytes, layout):
    """A 16-lane batch (S = 32): 16 prefixes x 16 columns a block, two
    column groups, 3 stages of 8 rows; a batch of up to 4 queries 32 x 8."""
    p = scan_kernel.scan_wide_plan(P, S, L, N, D, hi_bytes)
    assert (p.prefixes, p.columns, p.rows, p.shared_bytes, p.grid) == layout, label
    assert p.stages == 3 and p.coeffs == 32


def test_scan_wide_plan_refuses_empty_work():
    with pytest.raises(ValueError, match="empty"):
        scan_kernel.scan_wide_plan(0, 32, 2, 4096, 162, 1)
    with pytest.raises(ValueError, match="hi plane"):
        scan_kernel.scan_wide_plan(162, 32, 2, 4096, 162, 4)
