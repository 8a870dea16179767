"""Kernels A (NTT), B (scan, with and without a hi plane) and C (the wide
scan of batched serving, both variants) on the card against their plain
PyTorch versions, bit for bit (tolerance 0), and the port's server on the
card against the same server on the CPU.

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


def test_ntt_kernel_rejects_what_it_cannot_take(dev):
    tables = NttTables(primes.coeff_modulus_from_bits(8192, [43, 43]), 8192, dev)
    with pytest.raises(ValueError, match="N=8192"):
        tables.forward(torch.zeros((2, 8192), dtype=torch.int64, device=dev))
    small = NttTables(primes.coeff_modulus_from_bits(64, [26, 27]), 64, dev)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda(small, torch.zeros((64, 2), dtype=torch.int64, device=dev).t(), False)


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
    want = scan_kernel.contract_dim_auto(sv.cpu(), hi.cpu(), lo.cpu(), modular.LimbConstants(moduli))
    assert torch.equal(got.cpu(), want)


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
    want = scan_kernel.contract_plain(sv.cpu(), None, lo.cpu(), modular.LimbConstants(moduli))
    assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="need a hi plane"):
        wide = modular.LimbConstants(primes.coeff_modulus_from_bits(1024, [34, 36]), dev)
        scan_kernel.contract_cuda(sv[:, :, :2].contiguous(), None, lo[:, :2].contiguous(), wide)


@pytest.mark.parametrize(
    "bits,P,D,S",
    [((34, 36), 5, 7, 1), ((36, 36), 162, 162, 32), ((44, 46), 3, 40, 5),
     ((26, 26, 26), 162, 162, 32), ((26, 27), 9, 20, 3), ((30, 30), 4, 33, 34)],
)
def test_scan_wide_kernel_matches_plain(dev, bits, P, D, S):
    """Kernel C (K4 with a hi plane, K4-u32 without) at odd S, S=32 and a
    width beyond one block pass (S=34)."""
    moduli = primes.coeff_modulus_from_bits(1024, list(bits))
    limbs = modular.LimbConstants(moduli, dev)
    n = 256
    sv = residues(moduli, (D, S), n, dev, seed=P + S)
    db = residues(moduli, (P, D), n, dev, seed=D).transpose(1, 2).contiguous()
    hi, lo = scan_kernel.split_planes(db, moduli)
    assert (hi is None) == (max(bits) <= 32)
    variant = "pir_scan_wide." + ("u32" if hi is None else "hi")
    before = kernels.SCAN_WIDE.variant_launches.get(variant, 0)
    got = scan_kernel.contract_dim_wide_auto(sv, hi, lo, limbs)  # 46-bit: 3 chunks
    torch.cuda.synchronize()
    assert kernels.SCAN_WIDE.variant_launches[variant] > before
    want = scan_kernel.contract_dim_wide_auto(
        sv.cpu(), None if hi is None else hi.cpu(), lo.cpu(), modular.LimbConstants(moduli)
    )
    assert torch.equal(got.cpu(), want)


def test_launch_counts(dev):
    tables = NttTables(primes.coeff_modulus_from_bits(64, [26, 27]), 64, dev)
    x = residues(tables.moduli, (2,), 64, dev, seed=3)
    before = kernels.NTT.launches
    tables.forward(x)
    tables.inverse(x)
    assert kernels.NTT.launches == before + 2
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {"ntt": 0, "scan": 0, "scan_wide": 0}
    assert kernels.variant_launch_counts() == {}
    limbs = modular.LimbConstants(tables.moduli[:1], dev)
    sv = residues(tables.moduli[:1], (3, 4), 64, dev, seed=4)
    _, lo = scan_kernel.split_planes(residues(tables.moduli[:1], (2, 3), 64, dev, 5).transpose(1, 2).contiguous(), tables.moduli[:1])
    scan_kernel.contract_dim_raw(sv[:, :2], None, lo, limbs)
    scan_kernel.contract_dim_raw_wide(sv, None, lo, limbs)
    assert kernels.launch_counts() == {"ntt": 0, "scan": 1, "scan_wide": 1}
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
    client = pt.PirClient(params, seed=6, compress_queries=True)
    req = client.create_request([2, 49])
    kernels.reset_launch_counts()
    on_card = pt.PirServer(pt.PirDatabase.create(raw, params, dev), params).process_request(req)
    counts = kernels.launch_counts()
    on_cpu = pt.PirServer(pt.PirDatabase.create(raw, params, "cpu"), params).process_request(req)
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
    client = pt.PirClient(params, seed=8, compress_queries=True)
    indexes = [2, 49, 17]
    req = client.create_request(indexes)
    variant = "u32" if max(bits) <= 32 else "hi"
    kernels.reset_launch_counts()
    on_card = pt.PirServer(pt.PirDatabase.create(raw, params, dev), params).process_request(req)
    counts = kernels.variant_launch_counts()
    on_cpu = pt.PirServer(pt.PirDatabase.create(raw, params, "cpu"), params).process_request(req)
    assert counts[f"pir_scan_wide.{variant}"] == 2 and counts[f"pir_scan.{variant}"] == 4
    assert on_card.SerializeToString() == on_cpu.SerializeToString()
    assert client.process_response(indexes, on_card) == [raw[i] for i in indexes]
