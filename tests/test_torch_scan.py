"""The port's scan path against pir_tpu: split planes, the contraction
(kernel B's CPU counterpart) against K1 and K5 under the Pallas interpreter,
its runtime-moduli entry against K6, kernel D's counterpart against K7, the
full planes scan, the Shoup-table layout end to end, digit decomposition in
both re-encode modes, mod-switching and the database's plaintexts and
planes.  Tolerance 0."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pir_tpu.core.context import PirContext as JCtx
from pir_tpu.ops import decompose as jdec
from pir_tpu.ops import modular as jmod
from pir_tpu.ops import modswitch as jms
from pir_tpu.ops import pallas_scan
from pir_tpu.ops import scan as jscan
from pir_tpu.pir.database import PirDatabase as JDB
from pir_tpu.pir.encoders import StringEncoder
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params
from pir_tpu_torch.core.context import PirContext as TCtx
from pir_tpu_torch.ops import decompose as tdec
from pir_tpu_torch.ops import modswitch as tms
from pir_tpu_torch.ops import scan as tscan
from pir_tpu_torch.ops import scan_kernel
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64
from pir_tpu_torch.pir import database as tdb


def contexts(q_bits, n=128, reencode="balanced", t_bits=13):
    params = tiny_pir_params(n=n, t_bits=t_bits, q_bits=q_bits, reencode_digits=reencode)
    return JCtx(params), TCtx(params, "cpu")


def residues(rng, moduli, shape_before, n):
    out = np.zeros(shape_before + (len(moduli), n), dtype=np.uint64)
    for li, q in enumerate(moduli):
        out[..., li, :] = rng.integers(0, q, size=shape_before + (n,), dtype=np.uint64)
    return out


@pytest.mark.parametrize("q_bits", [(26, 27, 28), (26, 34, 36), (40, 44, 46)])
def test_split_planes_and_chunk_bound(q_bits):
    jc, tc = contexts(q_bits)
    x = residues(np.random.default_rng(1), jc.ct_moduli, (3, 5), 128)
    jh, jl = pallas_scan.split_planes(jnp.asarray(x), jc.ct_moduli)
    th, tl = scan_kernel.split_planes(tensor_u64(x), tc.ct_moduli)
    assert np.array_equal(tl.numpy().view(np.uint32), np.asarray(jl))
    if jh is None:
        assert th is None
    else:
        wide = np.asarray(jh).dtype == np.uint16
        assert th.dtype == (torch.uint16 if wide else torch.uint8)
        assert np.array_equal(th.to(torch.int64).numpy(), np.asarray(jh).astype(np.int64))
    assert np.array_equal(numpy_u64(scan_kernel.join_planes(th, tl)), x)
    for b in (20, 32, 36, 40, 46, 48):
        assert scan_kernel.max_raw_chunk(bits=b) == pallas_scan.max_raw_chunk(bits=b)


@pytest.mark.parametrize("q_bits", [(26, 27, 28), (26, 34, 36)])
def test_contract_matches_pallas_interpret(q_bits):
    """K1 (and, for moduli of at most 32 bits, K5) under the interpreter."""
    jc, tc = contexts(q_bits)
    P, D, N = 3, 7, 128
    rng = np.random.default_rng(2)
    sv = residues(rng, jc.ct_moduli, (D, 2), N)
    db = residues(rng, jc.ct_moduli, (P, D), N).transpose(0, 2, 1, 3).copy()
    jh, jl = pallas_scan.split_planes(jnp.asarray(db), jc.ct_moduli)
    lq = jc.limbs_q
    ref = pallas_scan.contract_dim_raw(
        jnp.asarray(sv), jh, jl, lq.moduli,
        tuple(int(x) for x in lq.ratio_hi[:, 0]),
        tuple(int(x) for x in lq.ratio_lo[:, 0]),
        block_n=128, interpret=True,
    )
    th, tl = scan_kernel.split_planes(tensor_u64(db), tc.ct_moduli)
    got = scan_kernel.contract_dim_raw(tensor_u64(sv), th, tl, tc.limbs_q)
    assert np.array_equal(numpy_u64(got), np.asarray(ref))


def test_contract_auto_chunks_wide_moduli():
    """46-bit moduli: the exactness bound is 16 rows, so D=40 takes 3 chunks."""
    jc, tc = contexts((44, 46, 47))
    P, D, N = 2, 40, 128
    rng = np.random.default_rng(3)
    sv = residues(rng, jc.ct_moduli, (D, 2), N)
    db = residues(rng, jc.ct_moduli, (P, D), N)
    ref = jscan.contract_dim(jc, jnp.asarray(sv), jnp.asarray(db))
    th, tl = scan_kernel.split_planes(
        tensor_u64(db.transpose(0, 2, 1, 3).copy()), tc.ct_moduli
    )
    assert th.dtype.itemsize == 2
    got = scan_kernel.contract_dim_auto(tensor_u64(sv), th, tl, tc.limbs_q)
    assert np.array_equal(numpy_u64(got), np.asarray(ref))


@pytest.mark.parametrize(
    "q_bits,dims", [((26, 27, 28), (3, 4)), ((26, 34, 36), (3, 4)),
                    ((26, 34, 36), (12,)), ((26, 34, 36), (2, 2, 3))]
)
def test_database_scan_decomp_matches_interpret(q_bits, dims):
    jc, tc = contexts(q_bits, n=64)
    total = int(np.prod(dims))
    rng = np.random.default_rng(4)
    db = residues(rng, jc.ct_moduli, (total,), jc.n)
    sv = residues(rng, jc.ct_moduli, (sum(dims), 2), jc.n)
    grouped = db.reshape(total // dims[-1], dims[-1], jc.L, jc.n).transpose(0, 2, 1, 3)
    jplanes = pallas_scan.split_planes(jnp.asarray(grouped), jc.ct_moduli)
    ref = jax.jit(
        lambda v, planes: jscan.database_scan_decomp(
            jc, None, dims, v, db_planes=planes, interpret=True
        )
    )(jnp.asarray(sv), jplanes)
    tplanes = scan_kernel.split_planes(tensor_u64(grouped.copy()), tc.ct_moduli)
    got = tscan.database_scan_decomp(tc, dims, tensor_u64(sv), tplanes)
    assert got.shape == ref.shape
    assert np.array_equal(numpy_u64(got), np.asarray(ref))


@pytest.mark.parametrize("reencode", ["balanced", "legacy"])
def test_decompose_compose(reencode):
    jc, tc = contexts((26, 27, 28), n=64, reencode=reencode, t_bits=12)
    assert tdec.digit_widths(tc) == jdec.digit_widths(jc)
    assert tdec.local_expansion_ratios(tc) == jdec.local_expansion_ratios(jc)
    assert tdec.expansion_ratio(tc) == jdec.expansion_ratio(jc)
    ct = residues(np.random.default_rng(5), jc.ct_moduli, (3, 2), 64)
    ref = np.asarray(jdec.decompose_ct(jc, jnp.asarray(ct)))
    got = numpy_u64(tdec.decompose_ct(tc, tensor_u64(ct)))
    assert np.array_equal(got, ref)
    back = tdec.compose_ct(tc, got[0], 2)
    assert np.array_equal(back, jdec.compose_ct(jc, ref[0], 2))
    assert np.array_equal(back, ct[0])


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_mod_switch_to(keep):
    jc, tc = contexts((26, 27, 28, 29), n=64, t_bits=12)
    ct = residues(np.random.default_rng(keep), jc.ct_moduli, (2, 2), 64)
    ref = jms.mod_switch_to(jc, jnp.asarray(ct), keep)
    got = tms.mod_switch_to(tc, tensor_u64(ct), keep)
    assert np.array_equal(numpy_u64(got), np.asarray(ref))
    with pytest.raises(ValueError):
        tms.mod_switch_to(tc, tensor_u64(ct), 0)


@pytest.mark.parametrize("cur", [2, 3, 4, 5])
def test_mod_switch_from_every_level_to_every_keep(cur):
    """A ciphertext at L' = cur of the chain's 5 limbs, switched to every
    keep (keep = cur: unchanged), equals pir_tpu's."""
    jc, tc = contexts((26, 27, 28, 29, 30, 31), n=64, t_bits=12)
    ct = residues(np.random.default_rng(cur), jc.ct_moduli[:cur], (2, 2), 64)
    for keep in range(1, cur + 1):
        ref = jms.mod_switch_to(jc, jnp.asarray(ct), keep)
        got = tms.mod_switch_to(tc, tensor_u64(ct), keep)
        assert np.array_equal(numpy_u64(got), np.asarray(ref))


@pytest.mark.parametrize("q_bits", [(26, 27, 28), (26, 34, 36), (40, 44, 46)])
def test_items_to_planes_matches_pir_tpu(q_bits):
    """An upper level's [P, D, L, N] items as transposed planes of the
    chain's width, equal to pir_tpu's items_to_planes."""
    jc, tc = contexts(q_bits, n=64)
    items = residues(np.random.default_rng(7), jc.ct_moduli, (3, 5), 64)
    jh, jl = jscan.items_to_planes(jc, jnp.asarray(items))
    th, tl = tscan.items_to_planes(tc, tensor_u64(items))
    assert tl.shape == (3, len(jc.ct_moduli), 5, 64)
    assert np.array_equal(tl.numpy().view(np.uint32), np.asarray(jl))
    assert (th is None) == (jh is None)
    if jh is not None:
        assert np.array_equal(th.to(torch.int64).numpy(), np.asarray(jh).astype(np.int64))


@pytest.mark.parametrize(
    "dbsize,item,dims,q_bits",
    [(40, 8, 2, (26, 34, 36)), (90, 88, 1, (26, 27, 28)), (33, 5, 2, (26, 34, 36))],
)
def test_database_plaintexts_and_planes(dbsize, item, dims, q_bits):
    params = tiny_pir_params(dbsize=dbsize, bytes_per_item=item, dimensions=dims,
                             n=64, q_bits=q_bits)
    raw = generate_test_db(dbsize, item, seed=dbsize)
    jdb = JDB.create(raw, params, scan_impl="pallas")
    tdbase = tdb.PirDatabase.create(raw, params, device="cpu")
    assert np.array_equal(tdbase.db_pts, jdb.db_pts)
    jh, jl = jdb.db_planes
    th, tl = tdbase.db_planes
    assert np.array_equal(tl.numpy().view(np.uint32), np.asarray(jl))
    if jh is None:
        assert th is None
    else:
        assert np.array_equal(th.to(torch.int64).numpy(), np.asarray(jh).astype(np.int64))
    for idx in (0, dbsize // 2, dbsize - 1):
        assert tdb.calculate_indices(params, idx) == jdb.calculate_indices(idx)
        assert tdb.calculate_item_offset(params, idx) == jdb.calculate_item_offset(idx)


@pytest.mark.parametrize("bits_per_coeff,bytes_per_pt", [(23, 288 * 3), (7, 40), (55, 97), (62, 64)])
def test_pack_items_matches_string_encoder(bits_per_coeff, bytes_per_pt):
    n = 2048
    rng = np.random.default_rng(bits_per_coeff)
    buf = rng.integers(0, 256, 3 * bytes_per_pt, dtype=np.uint8).tobytes()
    got = tdb.pack_items(buf, 3, bytes_per_pt, bits_per_coeff, n)
    enc = StringEncoder(n, (1 << 62) + 135, bits_per_coeff)  # t only bounds bpc
    for i in range(3):
        ref = enc.encode(buf[i * bytes_per_pt : (i + 1) * bytes_per_pt])
        assert np.array_equal(got[i], ref)


@pytest.mark.parametrize("q_bits,D", [((26, 34, 36), 7), ((50, 52, 54), 40), ((58, 60, 61), 9)])
def test_contract_shoup_matches_pallas_interpret(q_bits, D):
    """Kernel D's CPU counterpart against K7 under the interpreter and
    scan.contract_dim with companions; at 58-60 bits the u64 sums fold every
    8 rows, so D=9 crosses a fold."""
    jc, tc = contexts(q_bits)
    P, N = 3, 128
    rng = np.random.default_rng(6)
    sv = residues(rng, jc.ct_moduli, (D, 2), N)
    db = residues(rng, jc.ct_moduli, (P, D), N)
    lq = jc.limbs_q
    shoup = np.asarray(jmod.shoup_precompute(db, np.asarray(lq.q)))
    want = np.asarray(jscan.contract_dim(jc, jnp.asarray(sv), jnp.asarray(db), jnp.asarray(shoup)))
    got = scan_kernel.contract_shoup_plain(
        tensor_u64(sv), tensor_u64(db), tensor_u64(shoup), tc.limbs_q
    )
    assert np.array_equal(numpy_u64(got), want)
    assert np.array_equal(
        numpy_u64(tscan.contract_dim(tc, tensor_u64(sv), tensor_u64(db), tensor_u64(shoup))), want
    )
    if D * max(jc.ct_moduli) < 2**64:  # K7 never folds: exact only below this
        ref = pallas_scan.contract_dim_pallas(
            jnp.asarray(sv), jnp.asarray(db), jnp.asarray(shoup), lq.moduli,
            tuple(int(x) for x in lq.ratio_hi[:, 0]), block_n=128, interpret=True,
        )
        assert np.array_equal(numpy_u64(got), np.asarray(ref))


@pytest.mark.parametrize("q_bits", [(26, 27, 28), (50, 52, 54)])
def test_contract_dim_without_companions(q_bits):
    """The upper levels' contraction of the Shoup layout (no companions)."""
    jc, tc = contexts(q_bits)
    rng = np.random.default_rng(7)
    sv = residues(rng, jc.ct_moduli, (5, 2), 128)
    items = residues(rng, jc.ct_moduli, (4, 5), 128)
    want = jscan.contract_dim(jc, jnp.asarray(sv), jnp.asarray(items))
    got = tscan.contract_dim(tc, tensor_u64(sv), tensor_u64(items))
    assert np.array_equal(numpy_u64(got), np.asarray(want))


@pytest.mark.parametrize(
    "q_bits,limb", [((26, 27, 28, 29, 30), 1), ((26, 34, 36), 0), ((26, 34, 36), 1)]
)
def test_contract_dim_auto_dyn_matches_pallas_interpret(q_bits, limb):
    """K6 for one rank's limb slice: the runtime moduli are the slice's,
    the plane form and exactness bound the whole chain's — at (26, 34) the
    rank holding the 26-bit limb still reads a uint8 hi plane."""
    jc, tc = contexts(q_bits)
    L = 2 if len(jc.ct_moduli) == 4 else 1
    sl = slice(limb * L, (limb + 1) * L)
    moduli = jc.ct_moduli[sl]
    bits = max(q.bit_length() for q in jc.ct_moduli)
    P, D, N = 3, 7, 128
    rng = np.random.default_rng(8)
    sv = residues(rng, moduli, (D, 2), N)
    db = residues(rng, moduli, (P, D), N).transpose(0, 2, 1, 3).copy()
    jh, jl = pallas_scan.split_planes(jnp.asarray(db), bits=bits)
    lq = jc.limbs_q
    cols = [jnp.asarray(np.asarray(a)[sl]) for a in (lq.q, lq.ratio_hi, lq.ratio_lo)]
    ref = pallas_scan.contract_dim_auto_dyn(
        jnp.asarray(sv), jh, jl, pallas_scan.limb_consts(*cols), cols[0], bits,
        interpret=True,
    )
    th, tl = scan_kernel.split_planes(tensor_u64(db), bits=bits)
    assert (th is None) == (bits <= 32)
    tlq = tc.limbs_q.limb_range(sl.start, sl.stop)
    consts = scan_kernel.limb_consts(tlq.q, tlq.ratio_hi, tlq.ratio_lo)
    got = scan_kernel.contract_dim_auto_dyn(tensor_u64(sv), th, tl, consts, tlq.q, bits)
    assert np.array_equal(numpy_u64(got), np.asarray(ref))


@pytest.mark.parametrize(
    "q_bits,dims", [((26, 34, 36), 2), ((50, 52, 54), 2), ((50, 52, 54), 1)]
)
def test_shoup_layout_serving_equals_pir_tpu(q_bits, dims):
    """scan_impl="xla": the database's NTT form and companions, and the
    Response bytes, equal pir_tpu's; at 50-52-bit moduli (above the planes'
    48 bits) "auto" picks this layout in both packages."""
    from pir_tpu.pir.client import PirClient as JClient
    from pir_tpu.pir.server import PirServer as JServer
    import pir_tpu_torch as pt

    params = tiny_pir_params(dbsize=40, bytes_per_item=8, dimensions=dims, n=64,
                             q_bits=q_bits)
    raw = generate_test_db(40, 8, seed=3)
    jdb = JDB.create(raw, params, scan_impl="xla")
    tdbase = tdb.PirDatabase.create(raw, params, scan_impl="auto" if q_bits[0] > 48 else "xla",
                                    device="cpu")
    assert tdbase.scan_impl == "xla" and tdbase.db_planes is None
    assert np.array_equal(numpy_u64(tdbase.db_ntt), np.asarray(jdb.db_ntt))
    assert np.array_equal(numpy_u64(tdbase.db_ntt_shoup), np.asarray(jdb.db_ntt_shoup))
    client = JClient(params, seed=4)
    req = client.create_request([2, 39])
    want = JServer(jdb, params).process_request(req)
    server = pt.PirServer(tdbase, params)
    for got in (server.process_request(req), server.process_request_batched(req)):
        assert got.SerializeToString() == want.SerializeToString()
    assert client.process_response([2, 39], want) == [raw[2], raw[39]]
    if q_bits[0] > 48:  # the planes cannot hold these moduli
        with pytest.raises(ValueError, match="48"):
            tdb.PirDatabase(params, scan_impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="unknown scan_impl"):
        tdb.PirDatabase(params, scan_impl="cpu", device="cpu")
