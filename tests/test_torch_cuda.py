"""Kernels A (NTT, N=64..32768, and over the BEHZ base at the large rings'
ciphertext-multiplication shapes), B (scan, with and without a hi plane, and
its runtime-moduli entry K6), C (the wide scan of batched serving, both
variants) and D (the Shoup-table scan, K7) on the card against their plain
PyTorch versions, bit for bit (tolerance 0); the port's server on the card
(both layouts, ciphertext-multiplication mode, and SEAL-stream requests),
negacyclic_polymul and the noise-budget probe against the same on the CPU;
and meshes of two gloo ranks sharing the card (decomposition and
ciphertext-multiplication mode) against the single-device server.

These tests need an NVIDIA GPU and carry the ``cuda`` marker; without a card
they skip.  This file imports no JAX, so it also runs on a machine that has
none:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import pir_tpu_torch as pt
from pir_tpu_torch import kernels
from pir_tpu_torch.core import primes
from pir_tpu_torch.ops import modular, scan_kernel
from pir_tpu_torch.ops.ntt import NttTables, ntt_cuda, ntt_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def residues(moduli, shape_before, n, device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cols = [
        torch.randint(0, int(q), (*shape_before, 1, n), generator=gen,
                      dtype=torch.int64, device=device)
        for q in moduli
    ]
    return torch.cat(cols, dim=-2)


@pytest.mark.parametrize(
    "n,bits,batch",
    [(64, (26, 27), 3), (256, (36, 36, 37), 5), (1024, (45, 50), 2),
     (4096, (36, 36, 37), 7), (4096, (58, 60), 1)],
)
def test_ntt_kernel_matches_plain(dev, n, bits, batch):
    tables = NttTables(primes.coeff_modulus_from_bits(n, list(bits)), n, dev)
    x = residues(tables.moduli, (batch,), n, dev, seed=n)
    for inverse in (False, True):
        got = ntt_cuda(tables, x, inverse)
        torch.cuda.synchronize()
        assert torch.equal(got, ntt_plain(tables, x, inverse))
    assert torch.equal(tables.inverse(tables.forward(x)), x)


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("bits", [(26, 27), (36, 37), (58, 60)], ids=["q26", "q37", "q60"])
def test_ntt_kernel_every_radix_matches_plain(dev, n, bits):
    """Every N, and so both of kernel A's layouts (4 words a thread below
    N=512, 8 from there), at one polynomial and at more than one wave of
    blocks, with moduli of 26, 37 and 60 bits (growing butterflies below
    2^50, lazy reducing ones above)."""
    from pir_tpu_torch.ops.ntt import ntt_plan

    assert ntt_plan(n, 1).radix_bits == (2 if n < 512 else 3)
    tables = NttTables(primes.coeff_modulus_from_bits(n, list(bits)), n, dev)
    for batch in (1, 400):
        x = residues(tables.moduli, (batch,), n, dev, seed=batch + n)
        x[0, 0, :4] = torch.tensor([0, 1, tables.moduli[0] - 1, tables.moduli[0] - 2])
        for inverse in (False, True):
            assert torch.equal(ntt_cuda(tables, x, inverse), ntt_plain(tables, x, inverse))
    torch.cuda.synchronize()


def test_ntt_kernel_rejects_what_it_cannot_take(dev):
    tables = NttTables(primes.coeff_modulus_from_bits(65536, [43, 43]), 65536, dev)
    with pytest.raises(ValueError, match="N=65536"):
        tables.forward(torch.zeros((2, 65536), dtype=torch.int64, device=dev))
    small = NttTables(primes.coeff_modulus_from_bits(64, [26, 27]), 64, dev)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda(small, torch.zeros((64, 2), dtype=torch.int64, device=dev).t(), False)


@pytest.mark.parametrize(
    "n,bits",
    [(8192, (43, 43, 44, 44, 44)), (8192, (60, 60, 60, 60, 60)), (16384, (48, 49, 49)),
     (16384, (30, 30)), (32768, (55, 56)), (32768, (30, 30, 30))],
    ids=["8192-seal", "8192-bsk", "16384-seal", "16384-tpu32", "32768-seal", "32768-tpu32"],
)
def test_ntt_kernel_above_4096_matches_plain(dev, n, bits):
    """Kernel A at N = 8192 (one 1,024-thread block a limb, 68 KB of shared
    memory), 16384 and 32768 (one cluster of 4 or 8 CTAs a limb), on
    SEAL's chains, the 60-bit BEHZ base and 30-bit tpu32 primes: one
    polynomial and more than one wave of blocks, the residue range's
    edges, growing or reducing butterflies as grows() picks them."""
    from pir_tpu_torch.ops.ntt import grows

    tables = NttTables(primes.coeff_modulus_from_bits(n, list(bits)), n, dev)
    variant = "pir_ntt." + ("grow" if grows(tables.moduli, n) else "reduce")
    for batch in (1, 96):
        x = residues(tables.moduli, (batch,), n, dev, seed=batch + n)
        x[0, 0, :3] = torch.tensor([0, tables.moduli[0] - 1, tables.moduli[0] - 2])
        for inverse in (False, True):
            before = kernels.NTT.variant_launches.get(variant, 0)
            got = ntt_cuda(tables, x, inverse)
            torch.cuda.synchronize()
            assert kernels.NTT.variant_launches[variant] == before + 1
            assert torch.equal(got, ntt_plain(tables, x, inverse)), (batch, inverse)
    assert torch.equal(tables.inverse(tables.forward(x)), x)


@pytest.mark.parametrize("chain,batch", [("qp", 120), ("q", 228)],
                         ids=["key-switch digits [120,16,32768]", "selection vector [228,15,32768]"])
def test_ntt_kernel_served_n32768_shapes_in_one_launch(dev, chain, batch):
    """The served N=32768 request's largest shapes on SEAL's 55/56-bit chain
    (reducing butterflies), forward and inverse: bit-equal to the plain
    version (a quarter GB of input at a time), each transform one launch of
    kernel A, and nothing allocated on the card beyond the output (the
    peak over the call, so a scratch freed before it returns shows too)."""
    from pir_tpu_torch import kernel_times as kt

    ep = kt.encryption_params("seal", 32768)
    tables = NttTables(ep.coeff_modulus, 32768, dev)
    if chain == "q":
        tables = tables.slice(len(ep.ct_modulus))
    x = residues(tables.moduli, (batch,), 32768, dev, seed=batch)
    for inverse in (False, True):
        torch.cuda.synchronize()
        before, launches = torch.cuda.memory_allocated(dev), kernels.NTT.launches
        torch.cuda.reset_peak_memory_stats(dev)
        got = ntt_cuda(tables, x, inverse)
        torch.cuda.synchronize()
        assert kernels.NTT.launches == launches + 1
        assert torch.cuda.max_memory_allocated(dev) - before <= got.nbytes + (2 << 20)
        assert kt.max_abs_err_plain(tables, x, got, inverse) == 0, inverse
        del got


@pytest.mark.parametrize("n", [16384, 32768])
def test_ntt_kernel_at_behz_base_shapes_matches_plain(dev, n):
    """Kernel A over the BEHZ base of SEAL's chain (RnsTool's Bsk, L + 1
    primes of 60 bits: 9 at N=16384, 16 at 32768, reducing butterflies) at
    a served ciphertext-multiplication step's lift and tensor-product
    shapes (kernel_times.large_ring_shapes), forward and inverse: each one
    launch, bit-equal to the plain version."""
    from pir_tpu_torch import kernel_times as kt
    from pir_tpu_torch.core.rns import RnsTool

    ep = kt.encryption_params("seal", n)
    tables = RnsTool(ep.ct_modulus, n, ep.plain_modulus, device=dev).ntt_bsk
    assert len(tables.moduli) == len(ep.ct_modulus) + 1
    shapes = [batch for _, key, batch, ring in kt.large_ring_shapes() if key == f"{n} bsk"]
    assert len(shapes) == 2
    for batch in shapes:
        x = residues(tables.moduli, (batch,), n, dev, seed=batch)
        x[0, -1, :2] = torch.tensor([0, tables.moduli[-1] - 1])
        for inverse in (False, True):
            before = kernels.NTT.variant_launches.get("pir_ntt.reduce", 0)
            got = ntt_cuda(tables, x, inverse)
            torch.cuda.synchronize()
            assert kernels.NTT.variant_launches["pir_ntt.reduce"] == before + 1
            assert kt.max_abs_err_plain(tables, x, got, inverse) == 0, (batch, inverse)


@pytest.mark.parametrize("n,bits", [(4096, (36, 36, 37)), (16384, (60, 60))])
def test_negacyclic_polymul_on_card_matches_cpu(dev, n, bits):
    """NttTables.negacyclic_polymul on the card (kernel A's three
    transforms, growing or reducing) and pointwise_mul against the same
    tables on the CPU (the plain versions), with broadcast batch axes."""
    moduli = primes.coeff_modulus_from_bits(n, list(bits))
    card, host = NttTables(moduli, n, dev), NttTables(moduli, n, "cpu")
    a = residues(moduli, (2,), n, dev, seed=1)
    b = residues(moduli, (1,), n, dev, seed=2)
    launches = kernels.NTT.launches
    got = card.negacyclic_polymul(a, b)
    torch.cuda.synchronize()
    assert kernels.NTT.launches == launches + 3 and got.is_cuda
    assert torch.equal(got.cpu(), host.negacyclic_polymul(a.cpu(), b.cpu()))
    assert torch.equal(card.pointwise_mul(a, b).cpu(), host.pointwise_mul(a.cpu(), b.cpu()))


@pytest.mark.parametrize("dims", [2, 3])
def test_noise_budget_probe_on_card_matches_cpu(dev, capsys, dims):
    """PirDatabase.multiply(decryptor=) on the card prints the CPU's lines
    (the probe decrypts on the card) and returns the CPU's words."""
    from pir_tpu_torch.bfv.encrypt import encrypt, invariant_noise_budget
    from pir_tpu_torch.pir.database import calculate_indices

    n = 128
    ep = pt.EncryptionParams(
        poly_modulus_degree=n,
        plain_modulus=primes.get_prime(2 * n, 13),
        coeff_modulus=tuple(primes.coeff_modulus_from_bits(n, [34, 36, 37])),
    )
    params = pt.create_pir_parameters(60, 8, dims, ep)
    rng = np.random.default_rng(dims)
    raw = [rng.integers(0, 256, 8, dtype=np.uint8).tobytes() for _ in range(60)]
    cpu_client = pt.PirClient(params, seed=3, device="cpu")
    card_client = pt.PirClient(params, seed=3, device=dev)
    hot, off = set(), 0
    for dim, i in zip(params.dimensions, calculate_indices(params, 41)):
        hot.add(off + i)
        off += dim
    sv = torch.stack([encrypt(cpu_client.ctx, cpu_client.pk,
                              np.array([int(r in hot)] + [0] * (n - 1), dtype=np.uint64), rng)
                      for r in range(params.dimensions_sum)])
    lines, words = [], []
    for client, where in ((cpu_client, "cpu"), (card_client, dev)):
        db = pt.PirDatabase.create(raw, params, device=where)
        words.append(db.multiply(
            sv.to(where), decryptor=lambda ct, c=client: invariant_noise_budget(c.ctx, c.sk, ct)
        ).cpu())
        lines.append(capsys.readouterr().out.splitlines())
    assert len(lines[0]) == dims and lines[1] == lines[0]
    assert torch.equal(words[1], words[0])


@pytest.mark.parametrize("bits,P,D", [((34, 36), 5, 7), ((36, 36), 162, 162), ((44, 46), 3, 40)])
def test_scan_kernel_matches_plain(dev, bits, P, D):
    moduli = primes.coeff_modulus_from_bits(1024, list(bits))
    limbs = modular.LimbConstants(moduli, dev)
    n = 256
    sv = residues(moduli, (D, 2), n, dev, seed=P)
    db = residues(moduli, (P, D), n, dev, seed=D).transpose(1, 2).contiguous()
    hi, lo = scan_kernel.split_planes(db, moduli)
    got = scan_kernel.contract_dim_auto(sv, hi, lo, limbs)  # 46-bit: 3 chunks
    torch.cuda.synchronize()
    want = scan_kernel.contract_dim_auto(sv.cpu(), hi.cpu(), lo.cpu(), modular.LimbConstants(moduli, "cpu"))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize(
    "bits,P,D,j_begin,n,splits",
    [((26, 26), 5, 7, 0, 256, 4), ((26, 26), 8, 162, 0, 4096, 8), ((34, 36), 17, 7, 3, 256, 4),
     ((34, 36), 8, 162, 0, 4096, 8), ((34, 36), 3, 13, 1, 64, 8), ((44, 46), 9, 16, 4, 256, 8),
     ((44, 46), 1, 5, 11, 128, 4), ((34, 36), 4, 1, 2, 256, 1), ((44, 46), 6, 3, 0, 128, 2),
     ((34, 36), 162, 162, 0, 4096, 2)],
)
def test_scan_kernel_plan_edges(dev, bits, P, D, j_begin, n, splits):
    """Kernel B where P is no multiple of its prefix tile, D no multiple of
    its row split (the upper scan's 8-way split at P = 8, and a ragged
    tail at D = 7, 13), rows from j_begin > 0, N below one warp's 128
    coefficients, hi planes of 0, 1 and 2 bytes, and shapes at which its
    plan splits the rows 1, 2, 4 and 8 ways (2 at the inner scan's)."""
    moduli = primes.coeff_modulus_from_bits(1024, list(bits))
    limbs = modular.LimbConstants(moduli, dev)
    assert scan_kernel.scan_plan(P, len(moduli), n, D).row_splits == splits
    d_total = j_begin + D + 2
    sv = residues(moduli, (D, 2), n, dev, seed=P + D)
    db = residues(moduli, (P, d_total), n, dev, seed=j_begin).transpose(1, 2).contiguous()
    hi, lo = scan_kernel.split_planes(db, moduli)
    assert {None: 0, torch.uint8: 1, torch.uint16: 2}[None if hi is None else hi.dtype] == (
        0 if max(bits) <= 32 else 1 if max(bits) <= 40 else 2)
    cpu = modular.LimbConstants(moduli, "cpu")
    want = scan_kernel.contract_plain(sv.cpu(), None if hi is None else hi.cpu(), lo.cpu(),
                                      cpu.table, j_begin)
    assert torch.equal(scan_kernel.contract_dim_raw(sv, hi, lo, limbs, j_begin).cpu(), want)


def test_scan_kernel_without_hi_plane_matches_plain(dev):
    """Kernel B's single-word variant (K5) at moduli below 2^32."""
    moduli = primes.coeff_modulus_from_bits(1024, [26, 26, 26])
    limbs = modular.LimbConstants(moduli, dev)
    sv = residues(moduli, (162, 2), 256, dev, seed=1)
    hi, lo = scan_kernel.split_planes(residues(moduli, (9, 162), 256, dev, 2).transpose(1, 2).contiguous(), moduli)
    assert hi is None
    before = kernels.SCAN.variant_launches.get("pir_scan.u32", 0)
    got = scan_kernel.contract_dim_auto(sv, hi, lo, limbs)
    torch.cuda.synchronize()
    assert kernels.SCAN.variant_launches["pir_scan.u32"] == before + 1
    want = scan_kernel.contract_plain(sv.cpu(), None, lo.cpu(), modular.LimbConstants(moduli, "cpu").table)
    assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="need a hi plane"):
        wide = modular.LimbConstants(primes.coeff_modulus_from_bits(1024, [34, 36]), dev)
        scan_kernel.contract_cuda(sv[:, :, :2].contiguous(), None, lo[:, :2].contiguous(), wide)


@pytest.mark.parametrize(
    "bits,P,D,S,j_begin,n",
    [((34, 36), 5, 7, 1, 0, 256), ((36, 36), 162, 162, 32, 0, 256), ((44, 46), 3, 40, 5, 0, 256),
     ((26, 26, 26), 162, 162, 32, 0, 256), ((26, 27), 9, 20, 3, 0, 256), ((30, 30), 4, 33, 34, 0, 256),
     ((26, 26), 5, 3, 1, 0, 64), ((34, 36), 64, 40, 2, 1, 64), ((41, 42), 33, 12, 5, 2, 64),
     ((26, 27), 16, 17, 16, 0, 64), ((36, 36), 17, 9, 32, 3, 64), ((34, 36), 7, 12, 33, 0, 70),
     ((41, 42), 20, 30, 32, 0, 96), ((30, 30), 9, 11, 2, 5, 70), ((26, 26), 40, 9, 32, 2, 64),
     ((36, 36), 162, 162, 4, 0, 4096), ((26, 26, 26), 162, 162, 32, 0, 512),
     ((43, 44), 114, 114, 32, 0, 512)],
)
def test_scan_wide_kernel_matches_plain(dev, bits, P, D, S, j_begin, n):
    """Kernel C (K4 with a hi plane of 1 or 2 bytes, K4-u32 without) at the
    edges of scan_wide_plan (the emulation test's shapes): S from 1 to 34
    (8 and 16 columns a block, up
    to three column groups), P below, at and above the prefix tile, D within
    one stage, over two and around the ring, in exactness chunks (46 bits:
    16 rows), rows from j_begin, N = 64, and ragged coefficient tiles (N =
    70, whose plane rows are not 16-byte aligned, and 96)."""
    moduli = primes.coeff_modulus_from_bits(1024, list(bits))
    limbs = modular.LimbConstants(moduli, dev)
    cpu = modular.LimbConstants(moduli, "cpu")
    sv = residues(moduli, (D, S), n, dev, seed=P + S)
    d_total = j_begin + D + (2 if j_begin else 0)
    db = residues(moduli, (P, d_total), n, dev, seed=D).transpose(1, 2).contiguous()
    hi, lo = scan_kernel.split_planes(db, moduli)
    assert (hi is None) == (max(bits) <= 32)
    hi_cpu = None if hi is None else hi.cpu()
    variant = "pir_scan_wide." + ("u32" if hi is None else "hi")
    before = kernels.SCAN_WIDE.variant_launches.get(variant, 0)
    if j_begin:
        got = scan_kernel.contract_dim_raw_wide(sv, hi, lo, limbs, j_begin)
        want = scan_kernel.contract_wide_plain(sv.cpu(), hi_cpu, lo.cpu(), cpu.table, j_begin)
    else:
        got = scan_kernel.contract_dim_wide_auto(sv, hi, lo, limbs)  # 46-bit: 3 chunks
        want = scan_kernel.contract_dim_wide_auto(sv.cpu(), hi_cpu, lo.cpu(), cpu)
    torch.cuda.synchronize()
    assert kernels.SCAN_WIDE.variant_launches[variant] > before
    assert torch.equal(got.cpu(), want)


def test_launch_counts(dev):
    tables = NttTables(primes.coeff_modulus_from_bits(64, [26, 27]), 64, dev)
    x = residues(tables.moduli, (2,), 64, dev, seed=3)
    before = kernels.NTT.launches
    tables.forward(x)
    tables.inverse(x)
    assert kernels.NTT.launches == before + 2
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {"ntt": 0, "scan": 0, "scan_wide": 0, "scan_shoup": 0}
    assert kernels.variant_launch_counts() == {}
    limbs = modular.LimbConstants(tables.moduli[:1], dev)
    sv = residues(tables.moduli[:1], (3, 4), 64, dev, seed=4)
    _, lo = scan_kernel.split_planes(residues(tables.moduli[:1], (2, 3), 64, dev, 5).transpose(1, 2).contiguous(), tables.moduli[:1])
    scan_kernel.contract_dim_raw(sv[:, :2], None, lo, limbs)
    scan_kernel.contract_dim_raw_wide(sv, None, lo, limbs)
    assert kernels.launch_counts() == {"ntt": 0, "scan": 1, "scan_wide": 1, "scan_shoup": 0}
    assert kernels.variant_launch_counts() == {"pir_scan.u32": 1, "pir_scan_wide.u32": 1}


@pytest.mark.parametrize("dims", [1, 2])
def test_server_on_card_matches_cpu(dev, dims):
    n = 128
    ep = pt.EncryptionParams(
        poly_modulus_degree=n,
        plain_modulus=primes.get_prime(2 * n, 13),
        coeff_modulus=tuple(primes.coeff_modulus_from_bits(n, [34, 36, 37])),
    )
    params = pt.create_pir_parameters(50, 8, dims, ep)
    rng = np.random.default_rng(dims)
    raw = [rng.integers(0, 256, 8, dtype=np.uint8).tobytes() for _ in range(50)]
    client = pt.PirClient(params, seed=6, compress_queries=True, device="cpu")
    req = client.create_request([2, 49])
    kernels.reset_launch_counts()
    on_card = pt.PirServer(pt.PirDatabase.create(raw, params, device=dev), params).process_request(req)
    counts = kernels.launch_counts()
    on_cpu = pt.PirServer(pt.PirDatabase.create(raw, params, device="cpu"), params).process_request(req)
    # two queries take the batched path: kernel C, and kernel B above d=1
    assert counts["ntt"] > 0 and counts["scan_wide"] > 0
    assert (counts["scan"] > 0) == (dims > 1)
    assert on_card.SerializeToString() == on_cpu.SerializeToString()
    assert client.process_response([2, 49], on_card) == [raw[2], raw[49]]


@pytest.mark.parametrize("bits", [(30, 30, 32), (34, 36, 37)], ids=["q32", "q36"])
def test_multi_query_server_on_card_matches_cpu(dev, bits, monkeypatch):
    """A 3-query request in lanes of 2 (the batched path, a ragged tail),
    through kernel C and kernel B, with and without a hi plane."""
    monkeypatch.setenv("PIR_BATCH_LANES", "2")
    n = 128
    ep = pt.EncryptionParams(
        poly_modulus_degree=n,
        plain_modulus=primes.get_prime(2 * n, 13),
        coeff_modulus=tuple(primes.coeff_modulus_from_bits(n, list(bits))),
    )
    params = pt.create_pir_parameters(50, 8, 2, ep)
    rng = np.random.default_rng(7)
    raw = [rng.integers(0, 256, 8, dtype=np.uint8).tobytes() for _ in range(50)]
    client = pt.PirClient(params, seed=8, compress_queries=True, device="cpu")
    indexes = [2, 49, 17]
    req = client.create_request(indexes)
    variant = "u32" if max(bits) <= 32 else "hi"
    kernels.reset_launch_counts()
    on_card = pt.PirServer(pt.PirDatabase.create(raw, params, device=dev), params).process_request(req)
    counts = kernels.variant_launch_counts()
    on_cpu = pt.PirServer(pt.PirDatabase.create(raw, params, device="cpu"), params).process_request(req)
    assert counts[f"pir_scan_wide.{variant}"] == 2 and counts[f"pir_scan.{variant}"] == 4
    assert on_card.SerializeToString() == on_cpu.SerializeToString()
    assert client.process_response(indexes, on_card) == [raw[i] for i in indexes]


@pytest.mark.parametrize("bits,P,D", [((36, 36), 162, 162), ((50, 52), 5, 40), ((58, 60), 3, 20)])
def test_scan_shoup_kernel_matches_plain(dev, bits, P, D):
    """Kernel D (K7); at 60 bits its u64 sums fold every 8 rows."""
    moduli = primes.coeff_modulus_from_bits(1024, list(bits))
    limbs = modular.LimbConstants(moduli, dev)
    n = 256
    sv = residues(moduli, (D, 2), n, dev, seed=P)
    db = residues(moduli, (P, D), n, dev, seed=D)
    shoup = modular.shoup_precompute_device(db, limbs.q, limbs.ratio_hi, limbs.ratio_lo)
    before = kernels.SCAN_SHOUP.launches
    got = scan_kernel.contract_dim_shoup(sv, db, shoup, limbs)
    torch.cuda.synchronize()
    assert kernels.SCAN_SHOUP.launches == before + 1
    want = scan_kernel.contract_shoup_plain(
        sv.cpu(), db.cpu(), shoup.cpu(), modular.LimbConstants(moduli, "cpu")
    )
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("bits,limb", [((26, 34), 0), ((26, 34), 1), ((26, 27), 1)])
def test_scan_dyn_entry_matches_plain(dev, bits, limb):
    """K6: one rank's limb slice with its moduli as a runtime table, the
    plane form set by the whole chain (a 26-bit limb of a 34-bit chain reads
    a hi plane)."""
    chain = primes.coeff_modulus_from_bits(1024, list(bits))
    max_bits = max(q.bit_length() for q in chain)
    limbs = modular.LimbConstants(chain, dev).limb_range(limb, limb + 1)
    sv = residues(limbs.moduli, (162, 2), 256, dev, seed=limb)
    db = residues(limbs.moduli, (9, 162), 256, dev, seed=5).transpose(1, 2).contiguous()
    hi, lo = scan_kernel.split_planes(db, bits=max_bits)
    consts = scan_kernel.limb_consts(limbs.q, limbs.ratio_hi, limbs.ratio_lo)
    variant = "pir_scan." + ("u32" if hi is None else "hi") + ".dyn"
    before = kernels.SCAN.variant_launches.get(variant, 0)
    got = scan_kernel.contract_dim_auto_dyn(sv, hi, lo, consts, limbs.q, max_bits)
    torch.cuda.synchronize()
    assert kernels.SCAN.variant_launches[variant] == before + 1
    cpu = modular.LimbConstants(limbs.moduli, "cpu")
    want = scan_kernel.contract_plain(sv.cpu(), None if hi is None else hi.cpu(), lo.cpu(), cpu.table)
    assert torch.equal(got.cpu(), want)


def _small_params(bits, dims=2):
    n = 128
    ep = pt.EncryptionParams(
        poly_modulus_degree=n,
        plain_modulus=primes.get_prime(2 * n, 13),
        coeff_modulus=tuple(primes.coeff_modulus_from_bits(n, list(bits))),
    )
    return pt.create_pir_parameters(50, 8, dims, ep)


@pytest.mark.parametrize("bits", [(34, 36, 37), (50, 52, 54)], ids=["q36", "q52"])
def test_shoup_layout_server_on_card_matches_cpu(dev, bits):
    """scan_impl="xla" on the card (kernel D for the inner scan), query by
    query for a 2-query request; at 50-52 bits it is the only layout."""
    params = _small_params(bits)
    rng = np.random.default_rng(4)
    raw = [rng.integers(0, 256, 8, dtype=np.uint8).tobytes() for _ in range(50)]
    client = pt.PirClient(params, seed=3, compress_queries=True, device="cpu")
    req = client.create_request([1, 48])
    kernels.reset_launch_counts()
    db = pt.PirDatabase.create(raw, params, scan_impl="xla", device=dev)
    on_card = pt.PirServer(db, params).process_request(req)
    counts = kernels.variant_launch_counts()
    on_cpu = pt.PirServer(
        pt.PirDatabase.create(raw, params, scan_impl="xla", device="cpu"), params
    ).process_request(req)
    assert counts["pir_scan_shoup"] == 2
    assert on_card.SerializeToString() == on_cpu.SerializeToString()
    assert client.process_response([1, 48], on_card) == [raw[1], raw[48]]


@pytest.mark.parametrize("dims", [1, 2])
def test_ctmult_server_on_card_matches_cpu(dev, dims):
    """Ciphertext-multiplication mode on the card (kernel D for the inner
    scan; above d=1 the BEHZ multiply's NTTs over the 60-bit base, kernel
    A's reducing butterflies) against the same server on the CPU: equal
    Response bytes, every item decoded, a positive noise budget."""
    from pir_tpu_torch.bfv.encrypt import invariant_noise_budget
    from pir_tpu_torch.ops.modular import tensor_u64
    from pir_tpu_torch.pir import wire

    n = 128
    ep = pt.EncryptionParams(
        poly_modulus_degree=n,
        plain_modulus=primes.get_prime(2 * n, 13),
        coeff_modulus=tuple(primes.coeff_modulus_from_bits(n, [34, 36, 37])),
    )
    params = pt.create_pir_parameters(50, 8, dims, ep, use_ciphertext_multiplication=True)
    rng = np.random.default_rng(dims + 10)
    raw = [rng.integers(0, 256, 8, dtype=np.uint8).tobytes() for _ in range(50)]
    client = pt.PirClient(params, seed=5, compress_queries=True, device=dev)
    req = client.create_request([3, 47])
    kernels.reset_launch_counts()
    on_card = pt.PirServer(pt.PirDatabase.create(raw, params, device=dev), params).process_request(req)
    counts = kernels.variant_launch_counts()
    on_cpu = pt.PirServer(pt.PirDatabase.create(raw, params, device="cpu"), params).process_request(req)
    assert counts["pir_scan_shoup"] == 2 and counts["pir_ntt.grow"] > 0
    assert (counts.get("pir_ntt.reduce", 0) > 0) == (dims > 1)
    assert on_card.SerializeToString() == on_cpu.SerializeToString()
    assert client.process_response([3, 47], on_card) == [raw[3], raw[47]]
    ct = wire.load_ciphertexts(on_card.reply[0], client.ctx)[0]
    assert invariant_noise_budget(client.ctx, client.sk, tensor_u64(ct, dev)) > 0


def _mesh_job(params, raw, request, backend, world=2, limb=2):
    from pir_tpu_torch.pir import wire

    case = {
        "name": "mesh", "params": wire.pir_params_to_proto(params).SerializeToString(),
        "items": b"".join(raw), "scan_impl": "pallas", "batch": 1, "limb": limb,
        "requests": [request.SerializeToString()],
    }
    return {"world": world, "backend": backend, "devices": ["cuda:0"] * world,
            "timeout_s": 120, "cases": [case]}


def test_mesh_of_two_ranks_on_card(dev, tmp_path):
    """A limb=2 mesh of two gloo ranks sharing the card: each rank's Response
    equals the single-device server's, through K6 and kernel A."""
    from pir_tpu_torch.parallel import mesh_worker

    params = _small_params((34, 36, 37))
    rng = np.random.default_rng(5)
    raw = [rng.integers(0, 256, 8, dtype=np.uint8).tobytes() for _ in range(50)]
    client = pt.PirClient(params, seed=6, compress_queries=True, device="cpu")
    req = client.create_request([4, 40])
    want = pt.PirServer(pt.PirDatabase.create(raw, params, device=dev), params).process_request(req)
    results = mesh_worker.run_job(_mesh_job(params, raw, req, "gloo"), tmp_path, 600)
    for r in results:
        assert r["mesh"]["responses"] == [want.SerializeToString()]
        assert r["mesh"]["counts"][0]["pir_scan.hi.dyn"] > 0
        assert r["mesh"]["counts"][0]["pir_ntt.grow"] > 0
    assert client.process_response([4, 40], want) == [raw[4], raw[40]]


def test_nccl_refuses_two_ranks_on_one_card(dev, tmp_path):
    from pir_tpu_torch.parallel import mesh_worker

    params = _small_params((34, 36, 37))
    raw = [bytes(8)] * 50
    req = pt.PirClient(params, seed=6, device="cpu").create_request([4])
    with pytest.raises(RuntimeError, match="share the card"):
        mesh_worker.run_job(_mesh_job(params, raw, req, "nccl"), tmp_path, 300)


@pytest.mark.parametrize("indexes", [[[4], [40], [0], [17], [49], [23]], [[4, 40, 9], [0, 17, 49]]],
                         ids=["single", "multi"])
def test_stream_on_card_equals_sequential(dev, indexes):
    """process_stream at depth 4 on the card: Responses in order, each
    byte-equal to process_request's, no synchronizing call (the keys are
    cached by the first process_request), the in-flight count at the depth
    (or the request count), the kernels launched, no worker left."""
    import threading

    params = _small_params((34, 36, 37))
    rng = np.random.default_rng(5)
    raw = [rng.integers(0, 256, 8, dtype=np.uint8).tobytes() for _ in range(50)]
    client = pt.PirClient(params, seed=6, compress_queries=True, device="cpu")
    server = pt.PirServer(pt.PirDatabase.create(raw, params, device=dev), params)
    reqs = [client.create_request(ix) for ix in indexes]
    want = [server.process_request(r).SerializeToString() for r in reqs]
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")  # nothing on the path may synchronize
    try:
        got = [r.SerializeToString() for r in server.process_stream(iter(reqs), depth=4)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = kernels.variant_launch_counts()
    assert got == want
    assert server.stream_stats["max_in_flight"] == min(4, len(reqs))
    assert len(server._stream_slots) == min(4, len(reqs))
    assert counts["pir_ntt.grow"] > 0
    assert counts["pir_scan_wide.hi" if len(indexes[0]) > 1 else "pir_scan.hi"] > 0
    assert not [t for t in threading.enumerate() if t.name.startswith("pir-stream")]
    for ix, resp in zip(indexes, server.process_stream(iter(reqs), depth=2)):
        assert client.process_response(ix, resp) == [raw[i] for i in ix]


def test_shard_loaded_mesh_of_two_ranks_on_card(dev, tmp_path):
    """Two gloo ranks (db=2) sharing the card, each loading only its shard
    of an ingest_shards checkpoint: each rank's Response equals the
    single-device server's."""
    from pir_tpu_torch.parallel import mesh_worker
    from pir_tpu_torch.pir import wire

    params = _small_params((34, 36, 37))
    rng = np.random.default_rng(7)
    raw = [rng.integers(0, 256, 8, dtype=np.uint8).tobytes() for _ in range(50)]
    pt.PirDatabase.ingest_shards(iter(raw), params, tmp_path / "shards", 2)
    client = pt.PirClient(params, seed=6, compress_queries=True, device="cpu")
    req = client.create_request([4, 40])
    want = pt.PirServer(pt.PirDatabase.create(raw, params, device=dev), params).process_request(req)
    case = {"name": "mesh", "params": wire.pir_params_to_proto(params).SerializeToString(),
            "shard_dir": str(tmp_path / "shards"), "scan_impl": "pallas",
            "requests": [req.SerializeToString()]}
    job = {"world": 2, "backend": "gloo", "devices": ["cuda:0"] * 2, "timeout_s": 120,
           "cases": [case]}
    for r in mesh_worker.run_job(job, tmp_path / "job", 600):
        assert r["mesh"]["responses"] == [want.SerializeToString()]
        assert r["mesh"]["counts"][0]["pir_scan.hi"] > 0
    assert client.process_response([4, 40], want) == [raw[4], raw[40]]


def _ctmult_params(items=50, dims=2):
    n = 128
    ep = pt.EncryptionParams(
        poly_modulus_degree=n,
        plain_modulus=primes.get_prime(2 * n, 13),
        coeff_modulus=tuple(primes.coeff_modulus_from_bits(n, [34, 36, 37])),
    )
    return pt.create_pir_parameters(items, 8, dims, ep, use_ciphertext_multiplication=True)


def test_seal_request_on_card_matches_cpu(dev):
    """A SEAL-stream request (full ciphertexts, seeded keys, legacy digits)
    served on the card: SEAL replies byte-equal to the CPU server's, every
    item decoded; a batched 3-query SEAL request through kernel C."""
    from pir_tpu_torch.pir import seal_compat

    n = 128
    ep = pt.EncryptionParams(
        poly_modulus_degree=n,
        plain_modulus=primes.get_prime(2 * n, 13),
        coeff_modulus=tuple(primes.coeff_modulus_from_bits(n, [34, 36, 37])),
    )
    params = pt.create_pir_parameters(50, 8, 2, ep, reencode_digits="legacy")
    rng = np.random.default_rng(11)
    raw = [rng.integers(0, 256, 8, dtype=np.uint8).tobytes() for _ in range(50)]
    client = pt.PirClient(params, seed=6, device="cpu", wire_format="seal")
    card = pt.PirServer(pt.PirDatabase.create(raw, params, device=dev), params, reply_limbs=2)
    cpu = pt.PirServer(pt.PirDatabase.create(raw, params, device="cpu"), params, reply_limbs=2)
    for indexes in ([7], [2, 49, 17]):
        req = client.create_request(indexes)
        kernels.reset_launch_counts()
        on_card = card.process_request_batched(req)
        counts = kernels.variant_launch_counts()
        assert on_card.SerializeToString() == cpu.process_request(req).SerializeToString()
        assert all(seal_compat.looks_like_seal_stream(ct) for r in on_card.reply for ct in r.ct)
        assert counts["pir_scan_wide.hi"] > 0 and counts["pir_ntt.grow"] > 0
        assert client.process_response(indexes, on_card) == [raw[i] for i in indexes]


def test_ctmult_mesh_of_two_ranks_on_card(dev, tmp_path):
    """Ciphertext-multiplication mode on a db=2 mesh of two gloo ranks
    sharing the card (an odd D0: each rank's block through kernel D, the
    BEHZ NTTs through kernel A's reducing butterflies): each rank's
    Response equals the single-device server's."""
    from pir_tpu_torch.parallel import mesh_worker
    from pir_tpu_torch.pir import wire

    params = _ctmult_params(items=120)
    assert params.dimensions[0] % 2
    rng = np.random.default_rng(9)
    raw = [rng.integers(0, 256, 8, dtype=np.uint8).tobytes() for _ in range(120)]
    client = pt.PirClient(params, seed=6, compress_queries=True, device="cpu")
    req = client.create_request([4, 119])
    want = pt.PirServer(pt.PirDatabase.create(raw, params, device=dev), params).process_request(req)
    case = {"name": "mesh", "params": wire.pir_params_to_proto(params).SerializeToString(),
            "items": b"".join(raw), "scan_impl": "auto", "batch": 1, "limb": 1,
            "requests": [req.SerializeToString()]}
    job = {"world": 2, "backend": "gloo", "devices": ["cuda:0"] * 2, "timeout_s": 120,
           "cases": [case]}
    for r in mesh_worker.run_job(job, tmp_path, 600):
        assert r["mesh"]["responses"] == [want.SerializeToString()]
        counts = r["mesh"]["counts"][0]
        assert counts["pir_scan_shoup"] > 0 and counts["pir_ntt.reduce"] > 0
    assert client.process_response([4, 119], want) == [raw[4], raw[119]]


def test_scan_shoup_kernel_at_a_rank_block_matches_plain(dev):
    """Kernel D at a db=2 rank's block of an odd D0 (the last prefix a
    zero-padded row block, zero companions): bit-equal to the plain version
    and exact zeros in the padded prefix."""
    from pir_tpu_torch.parallel import sharded

    moduli = primes.coeff_modulus_from_bits(1024, [43, 43, 44])
    limbs = modular.LimbConstants(moduli, dev)
    d0, d1, n = 7, 12, 256
    sv = residues(moduli, (d1, 2), n, dev, seed=3)
    whole = residues(moduli, (d0, d1), n, dev, seed=4)
    db = sharded._block(whole, 0, 2, 2, 1)  # rows 4..7 of 8: the last one padding
    shoup = modular.shoup_precompute_device(db, limbs.q, limbs.ratio_hi, limbs.ratio_lo)
    got = scan_kernel.contract_dim_shoup(sv, db, shoup, limbs)
    want = scan_kernel.contract_shoup_plain(
        sv.cpu(), db.cpu(), shoup.cpu(), modular.LimbConstants(moduli, "cpu"))
    assert torch.equal(got.cpu(), want)
    assert not got[-1].any()


def test_scan_shoup_kernel_at_n32768_inner_scan_matches_plain(dev):
    """Kernel D at the served N=32768 inner scan, sv [57, 2, 15, 32768]
    against db and companions [57, 57, 15, 32768] (25.5 GB) on SEAL's
    55-bit chain: every output prefix equal to the plain version's, which
    runs on the card a few prefixes at a time."""
    from pir_tpu_torch import kernel_times as kt

    (_, moduli, P, D, n), = [c for c in kt.shoup_cases() if c[0] == "K7 N=32768 inner"]
    assert (P, D, len(moduli), n) == (57, 57, 15, 32768)
    limbs = modular.LimbConstants(moduli, dev)
    sv = residues(moduli, (D, 2), n, dev, seed=1)
    db = torch.empty((P, D, len(moduli), n), dtype=torch.int64, device=dev)
    shoup = torch.empty_like(db)
    for p in range(P):
        db[p] = residues(moduli, (D,), n, dev, seed=100 + p)
        shoup[p] = modular.shoup_precompute_device(db[p], limbs.q, limbs.ratio_hi, limbs.ratio_lo)
    before = kernels.SCAN_SHOUP.launches
    got = scan_kernel.contract_dim_shoup(sv, db, shoup, limbs)
    torch.cuda.synchronize()
    assert kernels.SCAN_SHOUP.launches == before + 1
    for p0 in range(0, P, 8):
        want = scan_kernel.contract_shoup_plain(sv, db[p0 : p0 + 8], shoup[p0 : p0 + 8], limbs)
        assert torch.equal(got[p0 : p0 + 8], want), f"prefixes {p0}.."


@pytest.mark.parametrize("bits", [(30, 30, 32), (34, 36, 37), (42, 44, 46)],
                         ids=["q32", "q36", "q44"])
def test_packed_and_unpacked_responses_equal_on_card(dev, bits):
    """packed_transfer=True (u32 lo + u8/u16 hi words) and False on the
    card: single, multi-query (the batched reroute, kernel C) and streamed
    requests give the same Response bytes as each other and as the CPU
    server; the stream runs under sync debug "error" either way."""
    params = _small_params(bits)
    rng = np.random.default_rng(9)
    raw = [rng.integers(0, 256, 8, dtype=np.uint8).tobytes() for _ in range(50)]
    client = pt.PirClient(params, seed=2, compress_queries=True, device="cpu")
    reqs = [client.create_request(ix) for ix in ([4], [40, 0, 17], [49])]
    cpu = pt.PirServer(pt.PirDatabase.create(raw, params, device="cpu"), params, reply_limbs=1)
    want = [cpu.process_request(r).SerializeToString() for r in reqs]
    db = pt.PirDatabase.create(raw, params, device=dev)
    for packed in (True, False):
        server = pt.PirServer(db, params, reply_limbs=1, packed_transfer=packed)
        assert (server._hi_dtype is not None) == packed
        assert [server.process_request(r).SerializeToString() for r in reqs] == want
        list(server.process_stream(iter(reqs), depth=3))  # the streams' pinned buffers
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = [r.SerializeToString() for r in server.process_stream(iter(reqs), depth=3)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert got == want
