"""Wire codec: arrays/keys/params <-> bytes <-> protobuf messages.

Port of ``pir_tpu/pir/wire.py``, byte for byte.  The native codecs: PTP1
arrays (magic, dtype code, rank, shape, little-endian u64 data), PTS1
seeded ciphertexts (c0 plus the 16-byte seed that regenerates the second
polynomial), Galois/relinearization key blobs and PTPE parameters.  The
SEAL 3.5 streams the reference's clients send (pir/cpp/serialization.h:
81-138) go through :mod:`pir_tpu_torch.pir.seal_compat`: ciphertexts with
``seal_ep=``, seeded Galois and relinearization keys (their c1 expanded on
the host with SEAL's BLAKE2 PRNG when loaded), and SEAL encryption
parameters; the loaders accept either format.  Arrays here are host numpy
u64; the key loaders put their tensors on ``device``.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from pir_tpu_torch.bfv.keys import GaloisKeys, KSwitchKey, RelinKeys
from pir_tpu_torch.core.params import EncryptionParams, PirParams
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64
from pir_tpu_torch.pir import seal_compat
from pir_tpu_torch.proto import payload_pb2 as pb

_MAGIC = b"PTP1"
_SEEDED_MAGIC = b"PTS1"


# ---------------------------------------------------------------------------
# array codec
# ---------------------------------------------------------------------------


def pack_array(a) -> bytes:
    a = np.asarray(a)
    if a.dtype != np.uint64:
        raise ValueError(f"only u64 arrays cross the wire, got {a.dtype}")
    header = struct.pack("<4sBB", _MAGIC, 1, a.ndim) + struct.pack(
        f"<{a.ndim}q", *a.shape
    )
    return header + a.astype("<u8").tobytes()


def unpack_array(b: bytes) -> np.ndarray:
    magic, _ver, ndim = struct.unpack_from("<4sBB", b, 0)
    if magic != _MAGIC:
        raise ValueError("bad magic in serialized array")
    shape = struct.unpack_from(f"<{ndim}q", b, 6)
    off = 6 + 8 * ndim
    return np.frombuffer(b, dtype="<u8", offset=off).reshape(shape).copy()


# ---------------------------------------------------------------------------
# ciphertexts
# ---------------------------------------------------------------------------


def save_ciphertexts(
    cts, msg: "pb.Ciphertexts | None" = None, seal_ep: "EncryptionParams | None" = None
) -> pb.Ciphertexts:
    """cts: u64 arrays [size, L, N] (or one stacked [k, size, L, N]).

    seal_ep: when given, every entry is a SEAL 3.5 Ciphertext stream at the
    chain level of its limb count, instead of the native PTP1 codec."""
    out = msg if msg is not None else pb.Ciphertexts()
    arr = np.asarray(cts)
    if arr.ndim == 3:
        arr = arr[None]
    for i in range(arr.shape[0]):
        if seal_ep is not None:
            out.ct.append(seal_compat.save_ciphertext(arr[i], seal_ep))
        else:
            out.ct.append(pack_array(arr[i]))
    return out


def save_seeded_ciphertexts(
    c0s, seeds, msg: "pb.Ciphertexts | None" = None
) -> pb.Ciphertexts:
    """Seeded fresh ciphertexts: each entry carries c0 plus the 16-byte PRG
    seed that regenerates the second polynomial.  c0s: u64[k, L, N]."""
    out = msg if msg is not None else pb.Ciphertexts()
    arr = np.asarray(c0s)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.shape[0] != len(seeds):
        raise ValueError("one seed per seeded ciphertext required")
    for i, seed in enumerate(seeds):
        if len(seed) != 16:
            raise ValueError("seeded ciphertexts use 16-byte seeds")
        out.ct.append(_SEEDED_MAGIC + bytes(seed) + pack_array(arr[i]))
    return out


def load_ciphertexts(msg: pb.Ciphertexts, ctx=None) -> np.ndarray:
    """-> u64[k, size, L, N] (all ciphertexts in one proto share a shape).

    Seeded (PTS1) entries are re-expanded to full ciphertexts and SEAL
    streams are checked against the parameters, which needs the parameter
    context (`ctx`).
    """
    cts = []
    for b in msg.ct:
        if b[:4] == _SEEDED_MAGIC:
            if ctx is None:
                raise ValueError(
                    "seeded ciphertext requires a context to re-expand"
                )
            from pir_tpu_torch.bfv.encrypt import expand_a_from_seed

            seed, c0 = b[4:20], unpack_array(b[20:])
            cts.append(np.stack([c0, expand_a_from_seed(ctx, seed)]))
        elif seal_compat.looks_like_seal_stream(b):
            if ctx is None:
                raise ValueError(
                    "SEAL-stream ciphertext requires a context to validate"
                )
            cts.append(seal_compat.load_ciphertext(b, ctx.enc))
        else:
            cts.append(unpack_array(b))
    return np.stack(cts)


# ---------------------------------------------------------------------------
# keys (tensors on `device` on the way in, host numpy on the way out)
# ---------------------------------------------------------------------------


def serialize_galois_keys(
    gk: GaloisKeys, seal_ep: "EncryptionParams | None" = None, n: "int | None" = None
) -> bytes:
    """Native blob, or with seal_ep a SEAL GaloisKeys stream (row
    (elt - 1) / 2 for element elt, over n rows; seeded where the keys carry
    their seeds)."""
    if seal_ep is not None:
        if n is None:
            n = seal_ep.poly_modulus_degree
        arrays = {e: numpy_u64(k.data) for e, k in gk.keys.items()}
        return seal_compat.save_kswitch_keys(
            seal_compat.galois_rows_from_dict(arrays, n),
            seal_ep,
            seeds=seal_compat.galois_seed_rows(gk.keys, n),
        )
    elts = sorted(gk.keys)
    blob = struct.pack("<I", len(elts))
    for e in elts:
        payload = pack_array(numpy_u64(gk.keys[e].data))
        blob += struct.pack("<IQ", e, len(payload)) + payload
    return blob


def deserialize_galois_keys(b: bytes, device=None, ep=None) -> GaloisKeys:
    """A native or SEAL Galois key blob -> keys on `device`.  A SEAL stream
    needs the encryption parameters `ep`; its seeded c1 polynomials are
    expanded on the host here."""
    if len(b) < 4:
        raise ValueError("request carries no galois keys")
    if seal_compat.looks_like_seal_stream(b):
        if ep is None:
            raise ValueError(
                "SEAL-stream galois keys require encryption parameters"
            )
        rows = seal_compat.galois_dict_from_rows(seal_compat.load_kswitch_keys(b, ep))
        return GaloisKeys(
            keys={e: KSwitchKey(data=tensor_u64(v, device)) for e, v in rows.items()}
        )
    (count,) = struct.unpack_from("<I", b, 0)
    off = 4
    keys = {}
    for _ in range(count):
        e, ln = struct.unpack_from("<IQ", b, off)
        off += 12
        keys[e] = KSwitchKey(data=tensor_u64(unpack_array(b[off : off + ln]), device))
        off += ln
    return GaloisKeys(keys=keys)


def serialize_relin_keys(rk: RelinKeys, seal_ep: "EncryptionParams | None" = None) -> bytes:
    if seal_ep is not None:
        data = numpy_u64(rk.key.data)  # [L, 2, Lp, N]
        seeds = rk.key.seeds
        return seal_compat.save_kswitch_keys(
            [[data[i] for i in range(data.shape[0])]],
            seal_ep,
            seeds=[list(seeds)] if seeds is not None else None,
        )
    return pack_array(numpy_u64(rk.key.data))


def deserialize_relin_keys(b: bytes, device=None, ep=None) -> RelinKeys:
    """A native or SEAL relinearization key blob -> the key on `device`
    (a SEAL stream needs `ep`, as :func:`deserialize_galois_keys`)."""
    if seal_compat.looks_like_seal_stream(b):
        if ep is None:
            raise ValueError(
                "SEAL-stream relin keys require encryption parameters"
            )
        rows = seal_compat.load_kswitch_keys(b, ep)
        if len(rows) != 1 or not rows[0]:
            raise ValueError("relin keys stream must carry exactly one row")
        return RelinKeys(key=KSwitchKey(data=tensor_u64(np.stack(rows[0]), device)))
    return RelinKeys(key=KSwitchKey(data=tensor_u64(unpack_array(b), device)))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def serialize_encryption_params(ep: EncryptionParams, seal: bool = False) -> bytes:
    if seal:
        return seal_compat.save_encryption_params(ep)
    return b"PTPE" + json.dumps(ep.to_dict(), sort_keys=True).encode()


def deserialize_encryption_params(b: bytes) -> EncryptionParams:
    if not b.startswith(b"PTPE"):
        raise ValueError("bad magic in serialized encryption parameters")
    return EncryptionParams.from_dict(json.loads(b[4:].decode()))


def deserialize_encryption_params_any(b: bytes) -> EncryptionParams:
    """Accept either the native PTPE encoding or a SEAL 3.5 stream."""
    if b.startswith(b"PTPE"):
        return deserialize_encryption_params(b)
    if seal_compat.looks_like_seal_stream(b):
        return seal_compat.load_encryption_params(b)
    raise ValueError("unrecognized encryption-parameters encoding")


def pir_params_to_proto(p: PirParams, wire_format: str = "native") -> pb.PIRParameters:
    """wire_format="seal" serializes the embedded encryption parameters as
    a SEAL 3.5 stream, which the reference's binary reads."""
    if wire_format not in ("native", "seal"):
        raise ValueError(f"unknown wire format {wire_format!r}")
    msg = pb.PIRParameters()
    msg.num_items = p.num_items
    msg.num_pt = p.num_pt
    msg.dimensions.extend(p.dimensions)
    msg.encryption_parameters = serialize_encryption_params(
        p.encryption_params, seal=wire_format == "seal"
    )
    msg.bytes_per_item = p.bytes_per_item
    msg.items_per_plaintext = p.items_per_plaintext
    msg.bits_per_coeff = p.bits_per_coeff
    msg.use_ciphertext_multiplication = p.use_ciphertext_multiplication
    msg.reencode_mode = p.reencode_mode
    return msg


def pir_params_from_proto(msg: pb.PIRParameters) -> PirParams:
    return PirParams(
        num_items=msg.num_items,
        num_pt=msg.num_pt,
        dimensions=tuple(msg.dimensions),
        encryption_params=deserialize_encryption_params_any(msg.encryption_parameters),
        bytes_per_item=msg.bytes_per_item,
        items_per_plaintext=msg.items_per_plaintext,
        bits_per_coeff=msg.bits_per_coeff,
        use_ciphertext_multiplication=msg.use_ciphertext_multiplication,
        reencode_mode=msg.reencode_mode,
    )


# ---------------------------------------------------------------------------
# request assembly
# ---------------------------------------------------------------------------


def save_request(queries, galois_keys_bytes: bytes, relin_keys_bytes: bytes,
                 seal_ep: "EncryptionParams | None" = None) -> pb.Request:
    """queries: list (per query) of u64[k, size, L, N] ciphertext stacks,
    SEAL streams with seal_ep (as :func:`save_ciphertexts`)."""
    req = pb.Request()
    for q in queries:
        save_ciphertexts(q, req.query.add(), seal_ep=seal_ep)
    req.galois_keys = galois_keys_bytes
    req.relin_keys = relin_keys_bytes
    return req
