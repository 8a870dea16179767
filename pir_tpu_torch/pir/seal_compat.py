"""Best-effort SEAL 3.5 binary stream compatibility layer.

The reference serializes everything that crosses the wire with SEAL's
stream format: `EncryptionParameters` into the proto params field
(pir/cpp/parameters.cpp:99-100), and ciphertexts / Galois keys / relin
keys via the templated `SEALSerialize`/`SEALDeserialize`
(pir/cpp/serialization.h:81-138).  Full proto-level interop therefore
needs this codec for all four object kinds.

Layout implemented (SEAL 3.5.x, compression mode "none") — the complete
field-by-field derivation, including how each framing question was
resolved, lives in SEAL_STREAM.md at the repo root; byte goldens in
tests/test_seal_compat.py freeze it:

  SEALHeader (16 bytes, seal/serialization.h):
      u16  magic          = 0xA15E
      u8   header_size    = 0x10
      u8   version_major  = 3
      u8   version_minor  = 5
      u8   compr_mode     = 0 (none)
      u16  reserved       = 0
      u64  size           (total stream size incl. header)
  SmallModulus stream (seal/smallmodulus.h save -> Serialization::Save):
      SEALHeader + u64 value                       (24 bytes total)
  EncryptionParameters payload (encryptionparams.cpp save_members):
      u8   scheme         (1 = BFV)
      u64  poly_modulus_degree
      u64  coeff_modulus_count
      SmallModulus stream ×count   (nested 24-byte streams, NOT raw u64s)
      SmallModulus stream          (plain modulus; BFV only)
  IntArray stream (seal/intarray.h save -> Serialization::Save):
      SEALHeader + u64 word count + raw u64 words
  Ciphertext payload (ciphertext.cpp save_members):
      parms_id (4 × u64 — blake2xb of the params, see parms_id_for)
      u8   is_ntt_form
      u64  size  (number of polynomials)
      u64  poly_modulus_degree
      u64  coeff_mod_count
      f64  scale          (IEEE double; always 1.0 for BFV — the CKKS
                           member is written unconditionally)
      IntArray stream     (nested header + count + words,
                           [poly][limb][coeff] — the memory layout the
                           re-encoder reads at pir/cpp/ct_reencoder.cpp:61)
  KSwitchKeys payload (GaloisKeys/RelinKeys, kswitchkeys.cpp):
      parms_id (4 × u64, key level — full modulus chain)
      u64  number of key rows
      per row: u64 count, then `count` nested Ciphertext streams
      (PublicKey::save forwards to Ciphertext::save — one header each,
       not two)

**Validation caveat**: this container has zero egress and the reference
(and SEAL) cannot be built here, so this codec is checked for
self-consistency, structure, and hand-derived byte goldens, not against
live SEAL streams.  The protocol does not depend on it:
`pir_tpu_torch.pir.wire` uses the native PTP1 codec by default, and the
`*_any` loaders accept either format, so SEAL-generated protos parse if
this layout is right, while everything else keeps working if it is not.
Known interop limit (documented in SEAL_STREAM.md): the reference client
sends *seeded* evaluation keys (KeyGenerator::galois_keys returns
Serializable — client.cpp:47-54); seeded ciphertext payloads carry a
0xFFFF..FF marker word and a PRNG seed in place of c1 and are rejected
here with a clear error (expanding them needs SEAL's BLAKE2 PRNG).
Full (non-seeded) streams, which SEAL loads equally, are emitted.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

from pir_tpu_torch.core.params import EncryptionParams

SEAL_MAGIC = 0xA15E
COMPR_NONE = 0
SCHEME_BFV = 1


def _small_modulus_stream(value: int) -> bytes:
    """SmallModulus::save: a full nested stream around one u64 value."""
    header = struct.pack(
        "<HBBBBHQ", SEAL_MAGIC, 0x10, 3, 5, COMPR_NONE, 0, 16 + 8
    )
    return header + struct.pack("<Q", value)


def _read_small_modulus(b: bytes, off: int) -> tuple[int, int]:
    hdr = parse_header(b[off:])
    if hdr["size"] != 24:
        raise ValueError("malformed SmallModulus stream")
    (value,) = struct.unpack_from("<Q", b, off + 16)
    return value, off + 24


def save_encryption_params(ep: EncryptionParams) -> bytes:
    payload = struct.pack("<B", SCHEME_BFV)
    payload += struct.pack("<Q", ep.poly_modulus_degree)
    payload += struct.pack("<Q", len(ep.coeff_modulus))
    for m in ep.coeff_modulus:
        payload += _small_modulus_stream(m)
    payload += _small_modulus_stream(ep.plain_modulus)  # BFV only
    total = 16 + len(payload)
    header = struct.pack("<HBBBBHQ", SEAL_MAGIC, 0x10, 3, 5, COMPR_NONE, 0, total)
    return header + payload


COMPR_DEFLATE = 1


def parse_header(b: bytes, allow_compressed: bool = False) -> dict:
    if len(b) < 16:
        raise ValueError("stream shorter than a SEAL header")
    magic, hsize, major, minor, compr, _res, size = struct.unpack_from(
        "<HBBBBHQ", b, 0
    )
    if magic != SEAL_MAGIC:
        raise ValueError(f"bad SEAL magic 0x{magic:04x}")
    if hsize != 0x10:
        raise ValueError(f"unsupported SEAL header size {hsize}")
    if compr not in (COMPR_NONE, COMPR_DEFLATE) or (
        compr == COMPR_DEFLATE and not allow_compressed
    ):
        raise ValueError(
            "compressed SEAL streams are not supported here (compr_mode="
            f"{compr}); re-serialize with compr_mode none"
        )
    return {
        "version": (major, minor),
        "compr_mode": compr,
        "size": size,
    }


def _unwrap(b: bytes) -> bytes:
    """Top-level stream -> save_members payload bytes.

    SEAL 3.5's default compr_mode is deflate when zlib is available
    (seal/serialization.h compr_mode_default), so incoming top-level
    streams may be compressed; nested streams (SmallModulus, IntArray,
    key ciphertexts) are always saved with compr_mode none by their
    enclosing save_members.  Accepts both the zlib wrapper and a raw
    deflate body (covers either windowBits convention)."""
    hdr = parse_header(b, allow_compressed=True)
    if hdr["size"] > len(b):
        raise ValueError("SEAL stream header claims more bytes than present")
    body = bytes(b[16 : hdr["size"]])
    if hdr["compr_mode"] == COMPR_DEFLATE:
        import zlib

        try:
            body = zlib.decompress(body)
        except zlib.error:
            try:
                body = zlib.decompressobj(-15).decompress(body)
            except zlib.error as e:
                raise ValueError(f"bad deflate stream: {e}") from e
    return body


def load_encryption_params(b: bytes) -> EncryptionParams:
    try:
        return _load_encryption_params(b)
    except struct.error as e:
        raise ValueError(f"truncated SEAL stream: {e}") from e


def _load_encryption_params(b: bytes) -> EncryptionParams:
    b = _unwrap(b)
    off = 0
    (scheme,) = struct.unpack_from("<B", b, off)
    off += 1
    if scheme != SCHEME_BFV:
        raise ValueError(f"unsupported SEAL scheme {scheme} (only BFV)")
    (degree,) = struct.unpack_from("<Q", b, off)
    off += 8
    (count,) = struct.unpack_from("<Q", b, off)
    off += 8
    if not 1 <= count <= 64:
        raise ValueError("implausible coeff modulus count")
    moduli = []
    for _ in range(count):
        value, off = _read_small_modulus(b, off)
        moduli.append(value)
    plain, off = _read_small_modulus(b, off)
    params = EncryptionParams(
        poly_modulus_degree=int(degree),
        plain_modulus=int(plain),
        coeff_modulus=tuple(int(m) for m in moduli),
    )
    params.validate()
    return params


def looks_like_seal_stream(b: bytes) -> bool:
    return len(b) >= 2 and struct.unpack_from("<H", b, 0)[0] == SEAL_MAGIC


# ---------------------------------------------------------------------------
# parms_id: blake2xb over the packed parameter words (seal/util/hash.h)
# ---------------------------------------------------------------------------


_B2_IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)
_B2_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
)
_M64 = (1 << 64) - 1


def _b2_compress(h, block, t, last):
    m = struct.unpack("<16Q", block)
    v = list(h) + list(_B2_IV)
    v[12] ^= t & _M64
    v[13] ^= (t >> 64) & _M64
    if last:
        v[14] ^= _M64

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & _M64
        v[d] = ((v[d] ^ v[a]) >> 32 | (v[d] ^ v[a]) << 32) & _M64
        v[c] = (v[c] + v[d]) & _M64
        v[b] = ((v[b] ^ v[c]) >> 24 | (v[b] ^ v[c]) << 40) & _M64
        v[a] = (v[a] + v[b] + y) & _M64
        v[d] = ((v[d] ^ v[a]) >> 16 | (v[d] ^ v[a]) << 48) & _M64
        v[c] = (v[c] + v[d]) & _M64
        v[b] = ((v[b] ^ v[c]) >> 63 | (v[b] ^ v[c]) << 1) & _M64

    for r in range(12):
        s = _B2_SIGMA[r]
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def _blake2b_raw(data: bytes, param_block: bytes) -> bytes:
    """BLAKE2b with an explicit 64-byte parameter block (hashlib cannot
    express the BLAKE2X blocks: it rejects depth=0).  Full 64-byte state
    returned; caller truncates to the block's digest_length."""
    h = [
        _B2_IV[i] ^ w
        for i, w in enumerate(struct.unpack("<8Q", param_block))
    ]
    data = bytes(data)
    if len(data) == 0:
        h = _b2_compress(h, b"\x00" * 128, 0, True)
    else:
        off = 0
        while len(data) - off > 128:
            h = _b2_compress(h, data[off : off + 128], off + 128, False)
            off += 128
        tail = data[off:]
        h = _b2_compress(
            h, tail + b"\x00" * (128 - len(tail)), len(data), True
        )
    return struct.pack("<8Q", *h)


def _b2x_params(
    digest_length: int,
    fanout: int,
    depth: int,
    leaf_length: int,
    node_offset: int,
    xof_length: int,
    node_depth: int,
    inner_length: int,
    key_length: int = 0,
) -> bytes:
    return struct.pack(
        "<BBBBIIIBB14x16x16x",
        digest_length, key_length, fanout, depth, leaf_length,
        node_offset, xof_length, node_depth, inner_length,
    )


def blake2xb(data: bytes, out_len: int, key: bytes = b"") -> bytes:
    """BLAKE2Xb XOF per the BLAKE2X spec — SEAL's HashFunction
    (seal/util/hash.h wraps the vendored reference blake2xb).

    Root hash H0: digest_length 64, fanout 1, depth 1, xof_length field =
    out_len.  Output block i: digest_length min(64, remaining), fanout 0,
    depth 0, leaf_length 64, node_offset i, inner_length 64.

    key: optional BLAKE2 key (<= 64 bytes) — keyed hashing pads the key
    to one 128-byte block prepended to the message, with the root param
    block's key_length set.  SEAL's stream PRNG keys blake2xb with the
    512-bit PRNG seed (see BlakePrng).
    """
    if not 0 < out_len < (1 << 32):
        raise ValueError("blake2xb output length out of range")
    if len(key) > 64:
        raise ValueError("blake2 key longer than 64 bytes")
    msg = bytes(data)
    if key:
        msg = key + b"\x00" * (128 - len(key)) + msg
    h0 = _blake2b_raw(
        msg, _b2x_params(64, 1, 1, 0, 0, out_len, 0, 0, key_length=len(key))
    )
    n_full = out_len // 64
    out = _b2x_blocks_np(h0, out_len, n_full) if n_full else b""
    i = n_full
    while len(out) < out_len:
        take = min(64, out_len - len(out))
        out += _blake2b_raw(
            h0, _b2x_params(take, 0, 0, 64, i, out_len, 0, 64)
        )[:take]
        i += 1
    return out


def _b2_compress_np(h: np.ndarray, m: np.ndarray, t: int, last: bool):
    """_b2_compress vectorized over K independent lanes (numpy u64 wrap).

    h: u64[K, 8] states; m: u64[K, 16] message words; same t/last for all.
    The BLAKE2X output stage hashes many 64-byte blocks that differ only
    in node_offset — one vectorized compression replaces K Python ones.
    """
    K = h.shape[0]
    v = np.concatenate(
        [h, np.tile(np.array(_B2_IV, dtype=np.uint64), (K, 1))], axis=1
    )
    v[:, 12] ^= np.uint64(t & _M64)
    v[:, 13] ^= np.uint64((t >> 64) & _M64)
    if last:
        v[:, 14] ^= np.uint64(_M64)

    def rotr(x, r):
        return (x >> np.uint64(r)) | (x << np.uint64(64 - r))

    def g(a, b, c, d, x, y):
        v[:, a] += v[:, b] + x
        v[:, d] = rotr(v[:, d] ^ v[:, a], 32)
        v[:, c] += v[:, d]
        v[:, b] = rotr(v[:, b] ^ v[:, c], 24)
        v[:, a] += v[:, b] + y
        v[:, d] = rotr(v[:, d] ^ v[:, a], 16)
        v[:, c] += v[:, d]
        v[:, b] = rotr(v[:, b] ^ v[:, c], 63)

    for r in range(12):
        s = _B2_SIGMA[r]
        g(0, 4, 8, 12, m[:, s[0]], m[:, s[1]])
        g(1, 5, 9, 13, m[:, s[2]], m[:, s[3]])
        g(2, 6, 10, 14, m[:, s[4]], m[:, s[5]])
        g(3, 7, 11, 15, m[:, s[6]], m[:, s[7]])
        g(0, 5, 10, 15, m[:, s[8]], m[:, s[9]])
        g(1, 6, 11, 12, m[:, s[10]], m[:, s[11]])
        g(2, 7, 8, 13, m[:, s[12]], m[:, s[13]])
        g(3, 4, 9, 14, m[:, s[14]], m[:, s[15]])
    return h ^ v[:, :8] ^ v[:, 8:]


def _b2x_blocks_np(h0: bytes, out_len: int, n_blocks: int) -> bytes:
    """The first n_blocks full 64-byte BLAKE2X output blocks, vectorized."""
    # per-block init: IV ^ param words; only word 1's low half (node_offset
    # = block index) varies across blocks
    base = np.array(
        struct.unpack(
            "<8Q", _b2x_params(64, 0, 0, 64, 0, out_len, 0, 64)
        ),
        dtype=np.uint64,
    )
    iv = np.array(_B2_IV, dtype=np.uint64)
    h = np.tile(iv ^ base, (n_blocks, 1))
    h[:, 1] ^= np.arange(n_blocks, dtype=np.uint64)
    # message: h0 padded to one 128-byte block, same for every lane
    m = np.tile(
        np.frombuffer(h0 + b"\x00" * 64, dtype="<u8"), (n_blocks, 1)
    ).astype(np.uint64)
    out = _b2_compress_np(h, m, 64, True)
    return out.astype("<u8").tobytes()


def parms_id_for(
    ep: EncryptionParams, level_limbs: "int | None" = None
) -> tuple[int, int, int, int]:
    """SEAL parms_id: blake2xb-256 of the packed u64 parameter words
    (scheme, degree, coeff moduli, plain modulus) —
    EncryptionParameters::compute_parms_id semantics.

    level_limbs selects the SEALContext chain level: the key level hashes
    the full modulus chain (level_limbs=None), while a data-level object
    with L limbs hashes only the first L primes (SEALContext drops one
    prime per chain step, special prime first — data-level ciphertexts on
    the wire carry the L-prime level's id, not the key level's).
    """
    moduli = ep.coeff_modulus
    if level_limbs is not None:
        if not 1 <= level_limbs <= len(moduli):
            raise ValueError("level_limbs outside the modulus chain")
        moduli = moduli[:level_limbs]
    words = [SCHEME_BFV, ep.poly_modulus_degree]
    words += [int(m) for m in moduli]
    words += [ep.plain_modulus]
    digest = blake2xb(struct.pack(f"<{len(words)}Q", *words), 32)
    return struct.unpack("<4Q", digest)


# ---------------------------------------------------------------------------
# SEAL 3.5 stream PRNG (BlakePRNG) + uniform poly sampling — the machinery
# behind *seeded* ciphertext payloads (Serializable<GaloisKeys> etc.).
#
# Derivation (seal/randomgen.{h,cpp}, seal/util/rlwe.cpp — reconstructed
# from the SEAL 3.5 API; see SEAL_STREAM.md "Seeded streams" for the exact
# assumptions and the offline-validation caveat):
#   * prng_seed_type = array<uint64_t, 8> (512-bit seed).
#   * BlakePRNG refills a 4096-byte buffer per request:
#       blake2xb(buffer, 4096, in=&counter_ (8 bytes LE), key=seed (64 B))
#     with counter_ starting at 0 and incremented per refill.
#   * RandomToStandardAdapter yields uint32 draws = 4 consecutive buffer
#     bytes, little-endian.
#   * sample_poly_uniform: per modulus q, per coefficient:
#       do { rand = (u64(draw()) << 32) | draw(); } while (rand >= max_mult)
#       dest = rand % q,   max_mult = 2^64-1 - ((2^64-1) mod q) - 1
#     (first draw is the HIGH word — C++ evaluation order assumption).
# ---------------------------------------------------------------------------

PRNG_SEED_BYTES = 64  # prng_seed_uint64_count (8) * 8
_PRNG_BUFFER = 4096


class BlakePrng:
    """SEAL 3.5's buffered blake2xb counter PRNG."""

    def __init__(self, seed_words):
        seed_words = [int(w) for w in seed_words]
        if len(seed_words) != 8:
            raise ValueError("PRNG seed must be 8 u64 words")
        self._key = struct.pack("<8Q", *seed_words)
        self._counter = 0
        self._buf = b""
        self._pos = 0

    def generate(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            if self._pos >= len(self._buf):
                self._buf = blake2xb(
                    struct.pack("<Q", self._counter), _PRNG_BUFFER,
                    key=self._key,
                )
                self._counter += 1
                self._pos = 0
            take = min(n - len(out), len(self._buf) - self._pos)
            out += self._buf[self._pos : self._pos + take]
            self._pos += take
        return bytes(out)


def sample_poly_uniform(seed_words, moduli, n: int) -> np.ndarray:
    """Uniform RNS poly u64[L, N] from a PRNG seed — SEAL 3.5's
    sample_poly_uniform consuming a BlakePRNG (the c1/"a" expansion of a
    seeded ciphertext).  Bulk path with an exact sequential fallback when
    a rejection occurs (probability ~ q/2^64 per coefficient)."""
    prng = BlakePrng(seed_words)
    L = len(moduli)
    out = np.zeros((L, n), dtype=np.uint64)
    max_random = (1 << 64) - 1
    for j, q in enumerate(moduli):
        q = int(q)
        max_mult = max_random - (max_random % q) - 1
        raw = np.frombuffer(prng.generate(8 * n), dtype="<u4").astype(
            np.uint64
        )
        rand = (raw[0::2] << np.uint64(32)) | raw[1::2]
        reject = rand >= np.uint64(max_mult)
        if reject.any():
            # exact sequential redraw from the stream for rejected coeffs
            vals = rand.copy()
            for i in np.nonzero(reject)[0]:
                r = int(vals[i])
                while r >= max_mult:
                    w = np.frombuffer(prng.generate(8), dtype="<u4")
                    r = (int(w[0]) << 32) | int(w[1])
                vals[i] = r
            rand = vals
        out[j] = rand % np.uint64(q)
    return out


def random_prng_seed(rng: "np.random.Generator") -> tuple:
    """A fresh 512-bit PRNG seed as 8 u64 words."""
    return tuple(int(x) for x in rng.integers(0, 1 << 64, 8, dtype=np.uint64))


# ---------------------------------------------------------------------------
# Ciphertext streams
# ---------------------------------------------------------------------------


def _wrap(payload: bytes) -> bytes:
    header = struct.pack(
        "<HBBBBHQ", SEAL_MAGIC, 0x10, 3, 5, COMPR_NONE, 0, 16 + len(payload)
    )
    return header + payload


SEED_MARKER = 0xFFFFFFFFFFFFFFFF  # seeded-ciphertext indicator word


def _ct_payload(
    ct: np.ndarray, ep: EncryptionParams, is_ntt: bool, seed=None
) -> bytes:
    ct = np.ascontiguousarray(ct, dtype=np.uint64)
    if ct.ndim != 3:
        raise ValueError("ciphertext must be [size, L, N]")
    size, L, n = ct.shape
    if seed is not None:
        # seeded form (SEAL 3.5 encrypt_zero_symmetric save_seed): the c1
        # poly slot carries the marker word + the 8-word PRNG seed, the
        # rest zeros — the data array keeps its full length (3.5 relies on
        # deflate for the size win; explicit short streams arrived in 3.6)
        if size != 2:
            raise ValueError("seeded serialization needs a size-2 ciphertext")
        seed = [int(w) for w in seed]
        if len(seed) != 8:
            raise ValueError("PRNG seed must be 8 u64 words")
        ct = ct.copy()
        flat1 = ct[1].reshape(-1)
        flat1[:] = 0
        flat1[0] = SEED_MARKER
        flat1[1:9] = np.array(seed, dtype=np.uint64)
    # a ct with L limbs lives at the L-prime chain level; key-level objects
    # (L == full chain) naturally hash the whole chain
    payload = struct.pack("<4Q", *parms_id_for(ep, int(L)))
    payload += struct.pack("<B", 1 if is_ntt else 0)
    payload += struct.pack("<QQQ", size, n, L)
    # scale_: CKKS member, written unconditionally by save_members; 1.0
    # in BFV (SEAL_STREAM.md "the scale double")
    payload += struct.pack("<d", 1.0)
    # data_ is an IntArray saved through Serialization::Save: a full
    # nested stream (header + count + words), not bare words
    words = struct.pack("<Q", size * L * n) + ct.astype("<u8").tobytes()
    payload += _wrap(words)
    return payload


def _parse_ct_payload(b: bytes, off: int, ep: EncryptionParams):
    """Parse one Ciphertext save_members payload at `off`.

    Returns (array u64[size, L, N], is_ntt, parms_id, next offset).
    Every length field is bounds-checked against the buffer before use —
    these bytes come off the wire.
    """
    if off + 32 + 1 + 24 + 8 > len(b):
        raise ValueError("truncated SEAL ciphertext stream")
    pid = struct.unpack_from("<4Q", b, off)
    off += 32
    (is_ntt,) = struct.unpack_from("<B", b, off)
    off += 1
    size, n, L = struct.unpack_from("<QQQ", b, off)
    off += 24
    (scale,) = struct.unpack_from("<d", b, off)
    off += 8
    if scale != 1.0:
        raise ValueError(f"BFV ciphertexts require scale 1.0, got {scale}")
    if n != ep.poly_modulus_degree:
        raise ValueError("ciphertext degree does not match the parameters")
    if not 1 <= L <= len(ep.coeff_modulus):
        raise ValueError("ciphertext limb count outside the modulus chain")
    if not 1 <= size <= 16:
        raise ValueError("implausible ciphertext size")
    # nested IntArray stream
    arr_hdr = parse_header(b[off:])
    if off + arr_hdr["size"] > len(b):
        raise ValueError("IntArray stream exceeds the enclosing buffer")
    (words,) = struct.unpack_from("<Q", b, off + 16)
    if words != size * L * n:
        raise ValueError("ciphertext data length mismatch")
    if arr_hdr["size"] != 16 + 8 + 8 * words:
        raise ValueError("IntArray stream size inconsistent with word count")
    data = np.frombuffer(b, dtype="<u8", offset=off + 24, count=words)
    end = off + arr_hdr["size"]
    ct = data.reshape(int(size), int(L), int(n)).copy()
    if size == 2 and ct[1].flat[0] == SEED_MARKER:
        # seeded stream: c1 was replaced by [marker, 8-word PRNG seed];
        # regenerate it with SEAL's blake2xb stream PRNG (the reference
        # client sends its evaluation keys in exactly this form —
        # Serializable<GaloisKeys>, pir/cpp/client.cpp:47-54)
        if L * n < 9:
            raise ValueError("seeded ciphertext too small to hold a seed")
        seed = ct[1].reshape(-1)[1:9]
        ct[1] = sample_poly_uniform(seed, ep.coeff_modulus[: int(L)], int(n))
    elif size > 2 and ct[1].flat[0] == SEED_MARKER:
        raise ValueError("seeded serialization is only defined for size 2")
    return ct, bool(is_ntt), tuple(int(x) for x in pid), end


def save_ciphertext(
    ct: np.ndarray, ep: EncryptionParams, is_ntt_form: bool = False
) -> bytes:
    """u64[size, L, N] -> SEAL 3.5 Ciphertext stream."""
    return _wrap(_ct_payload(ct, ep, is_ntt_form))


def load_ciphertext(b: bytes, ep: EncryptionParams) -> np.ndarray:
    """SEAL 3.5 Ciphertext stream -> u64[size, L, N] (coeff form expected)."""
    body = _unwrap(b)
    ct, is_ntt, pid, _end = _parse_ct_payload(body, 0, ep)
    if pid != tuple(parms_id_for(ep, int(ct.shape[1]))):
        raise ValueError("ciphertext parms_id does not match the parameters")
    if is_ntt:
        raise ValueError(
            "NTT-form SEAL ciphertexts are not accepted on the wire "
            "(the protocol exchanges coefficient-form ciphertexts only)"
        )
    return ct


# ---------------------------------------------------------------------------
# KSwitchKeys streams (GaloisKeys / RelinKeys)
# ---------------------------------------------------------------------------


def save_kswitch_keys(
    rows: "list[list[np.ndarray]]", ep: EncryptionParams, seeds=None
) -> bytes:
    """rows[i] = list of [2, Lp, N] key ciphertexts (NTT form) for row i.

    GaloisKeys rows are indexed by (galois_elt - 1) / 2 — empty rows are
    allowed; RelinKeys have a single row for s².

    seeds: optional parallel structure (seeds[i][j] = 8-word PRNG seed or
    None) — components whose c1 was derived from a SEAL stream PRNG seed
    are emitted in seeded form (Serializable semantics, ~2x smaller after
    deflate), exactly what the reference client sends (client.cpp:47-54).
    """
    payload = struct.pack("<4Q", *parms_id_for(ep))
    payload += struct.pack("<Q", len(rows))
    for ri, row in enumerate(rows):
        payload += struct.pack("<Q", len(row))
        for ci, ct in enumerate(row):
            seed = None
            if seeds is not None and seeds[ri] is not None:
                seed = seeds[ri][ci]
            payload += _wrap(
                _ct_payload(np.asarray(ct), ep, is_ntt=True, seed=seed)
            )
    return _wrap(payload)


def load_kswitch_keys(
    b: bytes, ep: EncryptionParams
) -> "list[list[np.ndarray]]":
    """SEAL 3.5 KSwitchKeys stream -> rows of [2, Lp, N] NTT-form arrays.

    Every nested ciphertext's parms_id is validated against the key level
    (full modulus chain) and every length field is bounds-checked — the
    reference's status-checked loaders (serialization.cpp:32-55) reject
    malformed streams the same way.
    """
    b = _unwrap(b)
    off = 0
    if off + 40 > len(b):
        raise ValueError("truncated KSwitchKeys stream")
    pid = struct.unpack_from("<4Q", b, off)
    off += 32
    key_pid = tuple(parms_id_for(ep))
    if tuple(pid) != key_pid:
        raise ValueError("kswitch keys parms_id does not match the parameters")
    (nrows,) = struct.unpack_from("<Q", b, off)
    off += 8
    if nrows > ep.poly_modulus_degree:
        raise ValueError("implausible KSwitchKeys row count")
    lp = len(ep.coeff_modulus)
    rows = []
    for _ in range(nrows):
        if off + 8 > len(b):
            raise ValueError("truncated KSwitchKeys stream")
        (count,) = struct.unpack_from("<Q", b, off)
        off += 8
        if count > 64:
            raise ValueError("implausible key-row ciphertext count")
        row = []
        for _ in range(count):
            sub_hdr = parse_header(b[off:])
            if off + sub_hdr["size"] > len(b):
                raise ValueError("nested key stream exceeds the buffer")
            ct, is_ntt, sub_pid, end = _parse_ct_payload(b, off + 16, ep)
            if end != off + sub_hdr["size"]:
                raise ValueError("nested key stream size mismatch")
            if sub_pid != key_pid:
                raise ValueError(
                    "key ciphertext parms_id does not match the key level"
                )
            if not is_ntt or ct.shape[1] != lp:
                raise ValueError(
                    "key ciphertexts must be NTT form over the full chain"
                )
            row.append(ct)
            off += sub_hdr["size"]
        rows.append(row)
    return rows


def galois_rows_from_dict(keys: dict, n: int) -> "list[list[np.ndarray]]":
    """{galois_elt: KSwitchKey} -> SEAL GaloisKeys row layout.

    SEAL stores the key for element g at row (g - 1) / 2 (galoiskeys.h
    get_index); rows up to the largest element present are emitted, the
    rest empty.
    """
    if not keys:
        return []
    rows = [[] for _ in range(n)]
    for elt, key in keys.items():
        if elt % 2 == 0 or not (1 <= (elt - 1) // 2 < n):
            raise ValueError(f"invalid galois element {elt}")
        data = np.asarray(key.data if hasattr(key, "data") else key)
        # our KSwitchKey packs component ciphertexts [L, 2, Lp, N]
        rows[(elt - 1) // 2] = [data[i] for i in range(data.shape[0])]
    while rows and not rows[-1]:
        rows.pop()
    return rows


def galois_seed_rows(keys: dict, n: int) -> "list | None":
    """The per-component PRNG seeds of galois_rows_from_dict's layout, or
    None when any key lacks them (keys not generated with seeded_wire)."""
    if not keys:
        return None
    if any(getattr(k, "seeds", None) is None for k in keys.values()):
        return None
    rows = [None] * n
    last = 0
    for elt, key in keys.items():
        rows[(elt - 1) // 2] = list(key.seeds)
        last = max(last, (elt - 1) // 2)
    return rows[: last + 1]


def galois_dict_from_rows(rows: "list[list[np.ndarray]]") -> dict:
    """Inverse of galois_rows_from_dict: row i -> element 2i + 1."""
    out = {}
    for i, row in enumerate(rows):
        if row:
            out[2 * i + 1] = np.stack(row)
    return out
