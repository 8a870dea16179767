"""Wire codec: arrays/keys/params <-> bytes <-> protobuf messages.

Port of the native codecs of ``pir_tpu/pir/wire.py``, byte for byte:
PTP1 arrays (magic, dtype code, rank, shape, little-endian u64 data), PTS1
seeded ciphertexts (c0 plus the 16-byte seed that regenerates the second
polynomial), Galois/relinearization key blobs and PTPE parameters.  Arrays
here are host numpy u64; the server moves them to its device.

SEAL 3.5 streams are not decoded yet (ROADMAP.md, queue 1, item 1): a
blob that carries one raises ``ValueError`` (see :data:`SEAL_WIRE_TODO`).
"""

from __future__ import annotations

import json
import struct

import numpy as np

from pir_tpu_torch.bfv.keys import GaloisKeys, KSwitchKey, RelinKeys
from pir_tpu_torch.core.params import EncryptionParams, PirParams
from pir_tpu_torch.ops.modular import numpy_u64, tensor_u64
from pir_tpu_torch.proto import payload_pb2 as pb

_MAGIC = b"PTP1"
_SEEDED_MAGIC = b"PTS1"
_SEAL_MAGIC = 0xA15E  # SEAL 3.5 serialization header magic (little-endian u16)
SEAL_WIRE_TODO = (
    "SEAL 3.5 stream payloads are not ported to pir_tpu_torch yet "
    "(ROADMAP.md, queue 1, item 1: SEAL wire)"
)


def looks_like_seal_stream(b: bytes) -> bool:
    return len(b) >= 2 and struct.unpack_from("<H", b, 0)[0] == _SEAL_MAGIC


def _reject_seal(b: bytes) -> None:
    if looks_like_seal_stream(b):
        raise ValueError(SEAL_WIRE_TODO)


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


def save_ciphertexts(cts, msg: "pb.Ciphertexts | None" = None) -> pb.Ciphertexts:
    """cts: u64 arrays [size, L, N] (or one stacked [k, size, L, N])."""
    out = msg if msg is not None else pb.Ciphertexts()
    arr = np.asarray(cts)
    if arr.ndim == 3:
        arr = arr[None]
    for i in range(arr.shape[0]):
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

    Seeded (PTS1) entries are re-expanded to full ciphertexts, which needs
    the parameter context (`ctx`).
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
        else:
            _reject_seal(b)
            cts.append(unpack_array(b))
    return np.stack(cts)


# ---------------------------------------------------------------------------
# keys (tensors on `device` on the way in, host numpy on the way out)
# ---------------------------------------------------------------------------


def serialize_galois_keys(gk: GaloisKeys) -> bytes:
    elts = sorted(gk.keys)
    blob = struct.pack("<I", len(elts))
    for e in elts:
        payload = pack_array(numpy_u64(gk.keys[e].data))
        blob += struct.pack("<IQ", e, len(payload)) + payload
    return blob


def deserialize_galois_keys(b: bytes, device=None) -> GaloisKeys:
    if len(b) < 4:
        raise ValueError("request carries no galois keys")
    _reject_seal(b)
    (count,) = struct.unpack_from("<I", b, 0)
    off = 4
    keys = {}
    for _ in range(count):
        e, ln = struct.unpack_from("<IQ", b, off)
        off += 12
        keys[e] = KSwitchKey(data=tensor_u64(unpack_array(b[off : off + ln]), device))
        off += ln
    return GaloisKeys(keys=keys)


def serialize_relin_keys(rk: RelinKeys) -> bytes:
    return pack_array(numpy_u64(rk.key.data))


def deserialize_relin_keys(b: bytes, device=None) -> RelinKeys:
    _reject_seal(b)
    return RelinKeys(key=KSwitchKey(data=tensor_u64(unpack_array(b), device)))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def serialize_encryption_params(ep: EncryptionParams) -> bytes:
    return b"PTPE" + json.dumps(ep.to_dict(), sort_keys=True).encode()


def deserialize_encryption_params(b: bytes) -> EncryptionParams:
    _reject_seal(b)
    if not b.startswith(b"PTPE"):
        raise ValueError("bad magic in serialized encryption parameters")
    return EncryptionParams.from_dict(json.loads(b[4:].decode()))


def pir_params_to_proto(p: PirParams) -> pb.PIRParameters:
    msg = pb.PIRParameters()
    msg.num_items = p.num_items
    msg.num_pt = p.num_pt
    msg.dimensions.extend(p.dimensions)
    msg.encryption_parameters = serialize_encryption_params(p.encryption_params)
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
        encryption_params=deserialize_encryption_params(msg.encryption_parameters),
        bytes_per_item=msg.bytes_per_item,
        items_per_plaintext=msg.items_per_plaintext,
        bits_per_coeff=msg.bits_per_coeff,
        use_ciphertext_multiplication=msg.use_ciphertext_multiplication,
        reencode_mode=msg.reencode_mode,
    )


# ---------------------------------------------------------------------------
# request assembly
# ---------------------------------------------------------------------------


def save_request(queries, galois_keys_bytes: bytes, relin_keys_bytes: bytes
                 ) -> pb.Request:
    """queries: list (per query) of u64[k, size, L, N] ciphertext stacks."""
    req = pb.Request()
    for q in queries:
        save_ciphertexts(q, req.query.add())
    req.galois_keys = galois_keys_bytes
    req.relin_keys = relin_keys_bytes
    return req
