"""The native wire codec: PTP1 arrays, Galois and relinearization key
blobs, Requests and Responses.

Frozen from ``pir_tpu_torch/pir/wire.py`` (the native codec only; no SEAL
streams, no seeded ciphertexts), with imports rewritten.
"""

from __future__ import annotations

import struct

import numpy as np

from portbench.reference import payload_pb2 as pb

_MAGIC = b"PTP1"


def pack_array(a) -> bytes:
    a = np.asarray(a)
    if a.dtype != np.uint64:
        raise ValueError(f"only u64 arrays cross the wire, got {a.dtype}")
    header = struct.pack("<4sBB", _MAGIC, 1, a.ndim) + struct.pack(f"<{a.ndim}q", *a.shape)
    return header + a.astype("<u8").tobytes()


def unpack_array(b: bytes) -> np.ndarray:
    magic, _ver, ndim = struct.unpack_from("<4sBB", b, 0)
    if magic != _MAGIC:
        raise ValueError("bad magic in serialized array")
    shape = struct.unpack_from(f"<{ndim}q", b, 6)
    return np.frombuffer(b, dtype="<u8", offset=6 + 8 * ndim).reshape(shape)


def galois_blob(keys: dict) -> bytes:
    """{galois_elt: u64[L, 2, Lp, N]} -> the native Galois key blob."""
    blob = [struct.pack("<I", len(keys))]
    for e in sorted(keys):
        payload = pack_array(keys[e])
        blob.append(struct.pack("<IQ", e, len(payload)) + payload)
    return b"".join(blob)


def request_bytes(queries, galois: bytes, relin: bytes) -> bytes:
    """A Request of queries (each u64[k, 2, L, N]) and key blobs."""
    req = pb.Request(galois_keys=galois, relin_keys=relin)
    for q in queries:
        req.query.add().ct.extend(pack_array(ct) for ct in q)
    return req.SerializeToString()


def response_replies(data: bytes) -> list:
    """A Response's replies, each u64[k, size, l, N] (None for a reply whose
    ciphertexts do not share one shape)."""
    out = []
    for reply in pb.Response.FromString(data).reply:
        cts = [unpack_array(b) for b in reply.ct]
        out.append(np.stack(cts) if cts and len({c.shape for c in cts}) == 1 else None)
    return out
