"""The launch plans of kernels A (register-radix NTT) and B (the scan) on the
CPU: ops/ntt.py::ntt_plan and ops/scan_kernel.py::scan_plan, whose grids
the kernels launch as given.

The blocks of kernel A's plan hold every polynomial, and its words per
thread follow N; the tiles of kernel B's grid cover every prefix and
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
    with pytest.raises(ValueError, match="N=8192"):
        plan(8192, 4)
    with pytest.raises(ValueError, match="no polynomials"):
        plan(4096, 0)


def test_ntt_grows_below_50_bits():
    assert tntt.grows([0xffffee001, 0xffffc4001, 0x1ffffe0001])  # SEAL's 36/37-bit chain
    assert tntt.grows([(1 << 50) - 27])
    assert not tntt.grows([(1 << 36) - 1, (1 << 50) + 55])


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
