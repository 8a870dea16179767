// Native database ingest: MSB-first bitstream packing of raw items into
// plaintext coefficients.  The C++ counterpart of pir_tpu/pir/encoders.py's
// StringEncoder.encode_many (semantics of the reference's
// pir/cpp/string_encoder.cpp:58-80), built for bulk ingestion: packing a
// 16M-item database through the Python/numpy path costs minutes; this loop
// is memory-bound and one-pass.
//
// Exposed as a plain C ABI for ctypes; see pir_tpu/native/__init__.py.

#include <cstdint>
#include <cstring>

extern "C" {

// Pack `num_pt` plaintexts of `bytes_per_pt` bytes each (contiguous in
// `data`) into `out` coefficients, `n` coefficients per plaintext,
// `bits_per_coeff` data bits per coefficient, MSB-first.
// Returns 0 on success, nonzero on parameter errors.
int pack_db(const uint8_t* data, int64_t num_pt, int64_t bytes_per_pt,
            int bits_per_coeff, int64_t n, uint64_t* out) {
  if (bits_per_coeff <= 0 || bits_per_coeff > 62) return 1;
  const int64_t total_bits = bytes_per_pt * 8;
  const int64_t num_coeff = (total_bits + bits_per_coeff - 1) / bits_per_coeff;
  if (num_coeff > n) return 2;

  for (int64_t p = 0; p < num_pt; ++p) {
    const uint8_t* src = data + p * bytes_per_pt;
    uint64_t* dst = out + p * n;
    std::memset(dst, 0, sizeof(uint64_t) * n);

    uint64_t acc = 0;   // bit accumulator, MSB-first
    int acc_bits = 0;   // bits currently in acc
    int64_t ci = 0;     // coefficient index
    for (int64_t b = 0; b < bytes_per_pt; ++b) {
      acc = (acc << 8) | src[b];
      acc_bits += 8;
      while (acc_bits >= bits_per_coeff) {
        acc_bits -= bits_per_coeff;
        dst[ci++] = (acc >> acc_bits) & ((1ULL << bits_per_coeff) - 1);
      }
    }
    if (acc_bits > 0) {
      // terminate(): left-justify the trailing partial coefficient
      dst[ci++] = (acc << (bits_per_coeff - acc_bits)) &
                  ((1ULL << bits_per_coeff) - 1);
    }
  }
  return 0;
}

// Inverse: extract `length` bytes starting at byte_offset of the bitstream
// of one plaintext (decode path; parity with string_encoder.cpp:124-158).
int unpack_pt(const uint64_t* pt, int64_t n, int bits_per_coeff,
              int64_t byte_offset, int64_t length, uint8_t* out) {
  if (bits_per_coeff <= 0 || bits_per_coeff > 62) return 1;
  if ((byte_offset + length) * 8 > n * (int64_t)bits_per_coeff) return 2;
  int64_t bit = byte_offset * 8;
  for (int64_t i = 0; i < length; ++i) {
    uint8_t v = 0;
    for (int k = 0; k < 8; ++k, ++bit) {
      const int64_t ci = bit / bits_per_coeff;
      const int off = bits_per_coeff - 1 - (int)(bit % bits_per_coeff);
      v = (uint8_t)((v << 1) | ((pt[ci] >> off) & 1ULL));
    }
    out[i] = v;
  }
  return 0;
}

}  // extern "C"
