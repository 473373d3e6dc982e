// Native host library of the PyTorch/CUDA port (parameter_server_tpu_torch).
//
// Plays the role of the reference's C++ data plane (src/util/crc32c.cc,
// murmurhash3.cc, src/data/text_parser.cc): checksums, hashing and text
// parsing are host-CPU bound, so they live here, while the step runs on
// the GPU. The same source as the JAX package's cpp/psnative.cc, so every
// ps_* function gives the same bits in both packages. Exposed with a plain
// C ABI and bound with ctypes by native/__init__.py, which builds it with
// g++ -O3 -fPIC -shared -std=c++17 at first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cstdio>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli, poly 0x82F63B78), slicing-by-8.
// Same polynomial/masking as the reference's util/crc32c.{h,cc} so
// signatures agree with the Python fallback.
// ---------------------------------------------------------------------------

static uint32_t kCrcTable[8][256];
static bool crc_init_done = false;

static void crc_init() {
  if (crc_init_done) return;
  for (int i = 0; i < 256; ++i) {
    uint32_t c = (uint32_t)i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0);
    kCrcTable[0][i] = c;
  }
  for (int t = 1; t < 8; ++t) {
    for (int i = 0; i < 256; ++i) {
      uint32_t c = kCrcTable[t - 1][i];
      kCrcTable[t][i] = (c >> 8) ^ kCrcTable[0][c & 0xFF];
    }
  }
  crc_init_done = true;
}

uint32_t ps_crc32c(const uint8_t* data, uint64_t n) {
  crc_init();
  uint32_t crc = 0xFFFFFFFFu;
  uint64_t i = 0;
  while (i + 8 <= n) {
    uint64_t word;
    memcpy(&word, data + i, 8);
    word ^= (uint64_t)crc;
    crc = kCrcTable[7][word & 0xFF] ^ kCrcTable[6][(word >> 8) & 0xFF] ^
          kCrcTable[5][(word >> 16) & 0xFF] ^ kCrcTable[4][(word >> 24) & 0xFF] ^
          kCrcTable[3][(word >> 32) & 0xFF] ^ kCrcTable[2][(word >> 40) & 0xFF] ^
          kCrcTable[1][(word >> 48) & 0xFF] ^ kCrcTable[0][(word >> 56) & 0xFF];
    i += 8;
  }
  for (; i < n; ++i) crc = (crc >> 8) ^ kCrcTable[0][(crc ^ data[i]) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// 64-bit mixing hash — must match utils/murmur.py (splitmix64 finalizer).
// ---------------------------------------------------------------------------

// The one definition of the mix — static inline so the hot loops below
// inline (and auto-vectorize) it while every entry point stays bit-exact
// with the others and with utils/murmur.py.
static inline uint64_t mix64(uint64_t z, uint64_t seed) {
  z += seed + 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

uint64_t ps_mix64(uint64_t z, uint64_t seed) { return mix64(z, seed); }

void ps_mix64_array(const uint64_t* keys, uint64_t n, uint64_t seed,
                    uint64_t* out) {
  for (uint64_t i = 0; i < n; ++i) out[i] = ps_mix64(keys[i], seed);
}

// Fused key→slot mapping for hashed directories (KeyDirectory.slots): hash
// and reduce into [0, num_slots) in one pass, int32 out — saves the numpy
// uint64 temporaries and the second masking pass on the prep critical path.
void ps_hash_slots(const uint64_t* keys, uint64_t n, uint64_t seed,
                   uint64_t num_slots, int32_t* out) {
  if ((num_slots & (num_slots - 1)) == 0) {
    const uint64_t mask = num_slots - 1;
    for (uint64_t i = 0; i < n; ++i)  // inlined mix: auto-vectorizes
      out[i] = (int32_t)(mix64(keys[i], seed) & mask);
  } else {
    for (uint64_t i = 0; i < n; ++i)
      out[i] = (int32_t)(mix64(keys[i], seed) % num_slots);
  }
}

// ---------------------------------------------------------------------------
// MurmurHash3 x64 128-bit (Austin Appleby's public-domain algorithm; the
// reference's util/murmurhash3.cc uses the same function — criteo
// categorical tokens are keyed by h[0]^h[1] with seed 512927377, so this
// must be the real thing, bit-for-bit).
// ---------------------------------------------------------------------------

static inline uint64_t rotl64(uint64_t x, int8_t r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ull;
  k ^= k >> 33;
  return k;
}

void ps_murmur3_x64_128(const uint8_t* data, uint64_t len, uint32_t seed,
                        uint64_t* out) {
  const uint64_t nblocks = len / 16;
  uint64_t h1 = seed, h2 = seed;
  const uint64_t c1 = 0x87c37b91114253d5ull;
  const uint64_t c2 = 0x4cf5ad432745937full;

  for (uint64_t i = 0; i < nblocks; ++i) {
    uint64_t k1, k2;
    memcpy(&k1, data + i * 16, 8);
    memcpy(&k2, data + i * 16 + 8, 8);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729ull;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5ull;
  }

  const uint8_t* tail = data + nblocks * 16;
  uint64_t k1 = 0, k2 = 0;
  switch (len & 15) {
    case 15: k2 ^= (uint64_t)tail[14] << 48;  // fallthrough
    case 14: k2 ^= (uint64_t)tail[13] << 40;  // fallthrough
    case 13: k2 ^= (uint64_t)tail[12] << 32;  // fallthrough
    case 12: k2 ^= (uint64_t)tail[11] << 24;  // fallthrough
    case 11: k2 ^= (uint64_t)tail[10] << 16;  // fallthrough
    case 10: k2 ^= (uint64_t)tail[9] << 8;    // fallthrough
    case 9:
      k2 ^= (uint64_t)tail[8];
      k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
      // fallthrough
    case 8: k1 ^= (uint64_t)tail[7] << 56;  // fallthrough
    case 7: k1 ^= (uint64_t)tail[6] << 48;  // fallthrough
    case 6: k1 ^= (uint64_t)tail[5] << 40;  // fallthrough
    case 5: k1 ^= (uint64_t)tail[4] << 32;  // fallthrough
    case 4: k1 ^= (uint64_t)tail[3] << 24;  // fallthrough
    case 3: k1 ^= (uint64_t)tail[2] << 16;  // fallthrough
    case 2: k1 ^= (uint64_t)tail[1] << 8;   // fallthrough
    case 1:
      k1 ^= (uint64_t)tail[0];
      k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }

  h1 ^= len; h2 ^= len;
  h1 += h2; h2 += h1;
  h1 = fmix64(h1); h2 = fmix64(h2);
  h1 += h2; h2 += h1;
  out[0] = h1;
  out[1] = h2;
}

// ---------------------------------------------------------------------------
// Bit-packed wire format for slot-id streams. The host→device link is the
// pipeline's scarce resource; slot ids for a table of S entries need only
// ceil(log2 S) bits each, so we ship a little-endian bitstream instead of
// int32 (e.g. 22 bits/feature for a 4M-slot table = 31% fewer bytes than
// int32, 8% fewer than u24). Same byte-economy instinct as the reference's
// fixing_float filter (src/filter/fixing_float.h), applied to keys.
// ---------------------------------------------------------------------------

// Flush whole 32-bit words from the accumulator (single unaligned store
// instead of a per-byte loop — the packer's inner loop is on the prep
// critical path), then drain the <32-bit tail bytewise.
static inline uint8_t* flush32(uint8_t* w, uint64_t* acc, uint32_t* accbits) {
  if (*accbits >= 32) {
    uint32_t lo = (uint32_t)*acc;
    memcpy(w, &lo, 4);
    w += 4;
    *acc >>= 32;
    *accbits -= 32;
  }
  return w;
}

static inline uint8_t* drain_tail(uint8_t* w, uint64_t acc, uint32_t accbits) {
  while (accbits > 0) {
    *w++ = (uint8_t)acc;
    acc >>= 8;
    accbits = accbits >= 8 ? accbits - 8 : 0;
  }
  return w;
}

// Pack n b-bit values (b <= 31) into a little-endian bitstream. out must
// hold ceil(n*b/8) bytes.
void ps_pack_bits(const int32_t* vals, uint64_t n, uint32_t bits,
                  uint8_t* out) {
  const uint64_t vmask = (1ull << bits) - 1;  // truncate like pack_bits_np
  uint64_t acc = 0;
  uint32_t accbits = 0;
  uint8_t* w = out;
  for (uint64_t i = 0; i < n; ++i) {
    acc |= ((uint64_t)(uint32_t)vals[i] & vmask) << accbits;
    accbits += bits;
    w = flush32(w, &acc, &accbits);
  }
  drain_tail(w, acc, accbits);
}

// Fused hash → slot → bit-pack, tiled: the hash tile below is a plain
// elementwise loop with no loop-carried state, so -march=native
// vectorizes it (8-lane vpmullq on AVX-512DQ); the sequential pack
// accumulator then drains the cache-hot tile. One pass over the key
// stream, no full-size int32 temporary — the localization hot path for
// hashed directories (prep_batch_ell_bits).
void ps_hash_slots_packbits(const uint64_t* keys, uint64_t n, uint64_t seed,
                            uint64_t num_slots, uint32_t bits, uint8_t* out) {
  const int pow2 = (num_slots & (num_slots - 1)) == 0;
  const uint64_t mask = num_slots - 1;
  enum { TILE = 2048 };
  uint32_t tile[TILE];
  uint64_t acc = 0;
  uint32_t accbits = 0;
  uint8_t* w = out;
  for (uint64_t start = 0; start < n; start += TILE) {
    const uint64_t m = n - start < TILE ? n - start : TILE;
    const uint64_t* k = keys + start;
    if (pow2) {
      for (uint64_t j = 0; j < m; ++j)  // inlined mix: auto-vectorized
        tile[j] = (uint32_t)(mix64(k[j], seed) & mask);
    } else {
      for (uint64_t j = 0; j < m; ++j)
        tile[j] = (uint32_t)(mix64(k[j], seed) % num_slots);
    }
    for (uint64_t j = 0; j < m; ++j) {
      acc |= ((uint64_t)tile[j]) << accbits;
      accbits += bits;
      w = flush32(w, &acc, &accbits);
    }
  }
  drain_tail(w, acc, accbits);
}

// ---------------------------------------------------------------------------
// Fused stream-once wire prep: hash → per-lane unique → remap → bit-pack in
// ONE pass over a parsed shard (the "Localizer prep" host stage, fused).
//
// The stream-once (single-epoch) wire cannot win through the upload key
// cache — nothing repeats — so it wins through per-FIELD structure instead:
// a lane whose per-batch vocabulary is small (criteo's 13 integer count
// fields hash to ~90 distinct slots per 16k batch) ships a per-lane sorted
// unique-slot table ("uslots") plus per-row table indices ("ucols") at
// code_bits ≈ ceil(log2 vocab) bits, while high-vocabulary lanes (hashed
// categorical tokens, ~98% unique — incompressible past the hash) keep the
// raw ceil(log2 S)-bit stream. The caller pins the static widths
// (dict_mask/code_bits/dict_pad) from its first batch; this call verifies
// the batch fits them and returns -1 so the caller falls back to the raw
// bits wire (never wrong bytes, only fat ones).
//
// Output layout (must stay bit-identical to the NumPy fallback in the JAX
// package's learner/wire.py — parity is tier-1 tested there):
//   raw_stream:   row-major (row, raw lanes in lane order), raw_bits each
//   code_stream:  row-major (row, dict lanes in lane order), code_bits each
//   table_stream: concatenated per-lane sorted unique slots, raw_bits each
//   lane_starts:  [n_dict + 1] table start offsets (last = total entries)
// All three byte buffers must arrive ZEROED at full capacity: the packers
// write only the live prefix and the zero tail is part of the wire bytes.
// ---------------------------------------------------------------------------

int64_t ps_stream_encode(const uint64_t* keys, int64_t nsub, int32_t lanes,
                         uint64_t seed, uint64_t num_slots,
                         const uint8_t* dict_mask, uint32_t raw_bits,
                         uint32_t code_bits, int32_t dict_pad,
                         int32_t* lane_starts, uint8_t* raw_stream,
                         uint8_t* code_stream, uint8_t* table_stream) {
  const int64_t n = nsub * (int64_t)lanes;
  const int pow2 = (num_slots & (num_slots - 1)) == 0;
  const uint64_t mask = num_slots - 1;
  int32_t* slots = new int32_t[n > 0 ? n : 1];
  if (pow2) {
    for (int64_t i = 0; i < n; ++i) slots[i] = (int32_t)(mix64(keys[i], seed) & mask);
  } else {
    for (int64_t i = 0; i < n; ++i) slots[i] = (int32_t)(mix64(keys[i], seed) % num_slots);
  }

  int32_t n_dict = 0;
  for (int32_t j = 0; j < lanes; ++j) n_dict += dict_mask[j] ? 1 : 0;

  // per-lane unique + remap via LSD radix sort over (slot << 32 | row)
  // composite keys: one linear walk over the sorted pairs assigns each
  // row its sorted-unique position — semantically np.unique +
  // return_inverse, but with no per-entry binary search (the
  // lower_bound variant measured ~2x SLOWER than the NumPy path; this
  // one beats it). Only ceil(raw_bits/8) counting passes run, since
  // the row half never needs ordering.
  int32_t* table = new int32_t[dict_pad > 0 ? dict_pad : 1];
  int32_t* codes = new int32_t[nsub * (int64_t)(n_dict ? n_dict : 1)];
  uint64_t* pairs = new uint64_t[nsub > 0 ? nsub : 1];
  uint64_t* aux = new uint64_t[nsub > 0 ? nsub : 1];
  int32_t total = 0;
  int32_t di = 0;
  int64_t rc = 0;
  const int64_t code_cap = 1ll << code_bits;
  const int slot_passes = (int)((raw_bits + 7) / 8);
  for (int32_t j = 0; j < lanes && rc == 0; ++j) {
    if (!dict_mask[j]) continue;
    for (int64_t r = 0; r < nsub; ++r)
      pairs[r] = ((uint64_t)(uint32_t)slots[r * lanes + j] << 32) |
                 (uint32_t)r;
    uint64_t* src = pairs;
    uint64_t* dst = aux;
    for (int p = 0; p < slot_passes; ++p) {
      const int shift = 32 + 8 * p;
      int64_t count[256] = {0};
      for (int64_t r = 0; r < nsub; ++r)
        ++count[(src[r] >> shift) & 0xFF];
      int64_t pos = 0;
      for (int b = 0; b < 256; ++b) {
        int64_t c = count[b];
        count[b] = pos;
        pos += c;
      }
      for (int64_t r = 0; r < nsub; ++r)
        dst[count[(src[r] >> shift) & 0xFF]++] = src[r];
      uint64_t* t = src;
      src = dst;
      dst = t;
    }
    lane_starts[di] = total;
    int32_t u = 0;
    uint32_t prev = 0;
    for (int64_t r = 0; r < nsub; ++r) {
      const uint32_t slot = (uint32_t)(src[r] >> 32);
      if (r == 0 || slot != prev) {
        if (total + u >= dict_pad || u >= code_cap) { rc = -1; break; }
        table[total + u] = (int32_t)slot;
        ++u;
        prev = slot;
      }
      codes[(int64_t)(uint32_t)src[r] * n_dict + di] = u - 1;
    }
    if (rc != 0) break;
    total += u;
    ++di;
  }
  if (rc == 0) {
    lane_starts[n_dict] = total;
    // raw lanes, row-major, packed sequentially at raw_bits
    {
      uint64_t acc = 0;
      uint32_t accbits = 0;
      uint8_t* w = raw_stream;
      const uint64_t vmask = (1ull << raw_bits) - 1;
      for (int64_t r = 0; r < nsub; ++r) {
        for (int32_t j = 0; j < lanes; ++j) {
          if (dict_mask[j]) continue;
          acc |= ((uint64_t)(uint32_t)slots[r * lanes + j] & vmask) << accbits;
          accbits += raw_bits;
          w = flush32(w, &acc, &accbits);
        }
      }
      drain_tail(w, acc, accbits);
    }
    // dict codes, row-major, packed at code_bits
    {
      uint64_t acc = 0;
      uint32_t accbits = 0;
      uint8_t* w = code_stream;
      const uint64_t vmask = (1ull << code_bits) - 1;
      for (int64_t i = 0; i < nsub * (int64_t)n_dict; ++i) {
        acc |= ((uint64_t)(uint32_t)codes[i] & vmask) << accbits;
        accbits += code_bits;
        w = flush32(w, &acc, &accbits);
      }
      drain_tail(w, acc, accbits);
    }
    ps_pack_bits(table, (uint64_t)total, raw_bits, table_stream);
    rc = total;
  }
  delete[] aux;
  delete[] pairs;
  delete[] codes;
  delete[] table;
  delete[] slots;
  return rc;
}

// ---------------------------------------------------------------------------
// Text parsers (libsvm / criteo). Parse a buffer of newline-separated
// examples into CSR arrays. Caller supplies output buffers sized by
// ps_parse_* return contract: returns #examples parsed (NEGATED minus one,
// i.e. -(rows+1), when the value-capacity budget was hit mid-stream so the
// caller can retry with a bigger buffer), fills nnz via out_nnz (rolled
// back to the last complete row on a capacity stop). `slots` (nullable)
// receives the per-entry feature-group id, matching the reference Example
// proto's Slot.id (data/text_parser.cc: libsvm features live in slot 1;
// criteo int feature i → slot i+1, categorical i → slot i+14).
// ---------------------------------------------------------------------------

static inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// libsvm: "label idx:val idx:val ..." (ref data/text_parser.cc ParseLibsvm
// + util/strtonum.h). Reference-STRICT: the label and every value must be
// a full decimal-float token, every feature token needs ':', indices use
// strtou64 semantics (sign wraps modulo 2^64, clamp at ULLONG_MAX) and
// must be non-decreasing in uint64 order, and ANY malformed token drops
// the WHOLE line (the reference returns false — no partial rows). An
// empty value ("idx:") is 0.0 (strtof("") succeeds with 0). Deliberate
// narrowing vs strtof, mirrored by the Python parser: hex floats / inf /
// nan are rejected (a decimal-only grammar both paths implement
// identically — real libsvm data never contains the exotic forms).

// validate [s, e) as [+-]?(digits[.digits*]? | .digits)([eE][+-]?digits)?
static int is_decfloat(const char* s, const char* e) {
  if (s >= e) return 0;
  if (*s == '+' || *s == '-') ++s;
  int mant = 0;
  while (s < e && *s >= '0' && *s <= '9') { ++s; mant = 1; }
  if (s < e && *s == '.') {
    ++s;
    while (s < e && *s >= '0' && *s <= '9') { ++s; mant = 1; }
  }
  if (!mant) return 0;
  if (s < e && (*s == 'e' || *s == 'E')) {
    ++s;
    if (s < e && (*s == '+' || *s == '-')) ++s;
    int ex = 0;
    while (s < e && *s >= '0' && *s <= '9') { ++s; ex = 1; }
    if (!ex) return 0;
  }
  return s == e;
}

// parse a VALIDATED decimal-float token (bounded copy so strtod never
// reads past the caller's buffer; tokens longer than the scratch are
// treated as malformed — no real data has 63-char numbers)
static int parse_decfloat(const char* s, const char* e, double* out) {
  // fast path: plain short integers (the binary-feature ":1" case and
  // small counts) — exact in double, no strtod call
  if (e - s >= 1 && e - s <= 15) {
    uint64_t acc = 0;
    const char* q = s;
    while (q < e && *q >= '0' && *q <= '9') acc = acc * 10 + (uint64_t)(*q++ - '0');
    if (q == e) { *out = (double)acc; return 1; }
  }
  char tmp[64];
  size_t n = (size_t)(e - s);
  if (n == 0 || n >= sizeof(tmp) || !is_decfloat(s, e)) return 0;
  memcpy(tmp, s, n);
  tmp[n] = 0;
  *out = strtod(tmp, NULL);
  return 1;
}

// strtou64 semantics over [s, e): optional sign (negation wraps modulo
// 2^64), clamp at ULLONG_MAX, all bytes must be consumed. An EMPTY
// range succeeds with 0 — strtoull("") performs no conversion and
// leaves end at the terminator, which strtonum.h counts as success
// (so ":val" is feature id 0). A bare sign still fails (end != NUL).
static int parse_u64_tok(const char* s, const char* e, uint64_t* out) {
  if (s == e) { *out = 0; return 1; }
  int neg = 0;
  if (s < e && (*s == '+' || *s == '-')) { neg = (*s == '-'); ++s; }
  if (s >= e) return 0;
  uint64_t v = 0;
  int clamped = 0;
  while (s < e) {
    if (*s < '0' || *s > '9') return 0;
    unsigned d = (unsigned)(*s++ - '0');
    if (v > (0xFFFFFFFFFFFFFFFFull - d) / 10) clamped = 1;
    v = v * 10 + d;
  }
  if (clamped) v = 0xFFFFFFFFFFFFFFFFull;
  *out = neg ? (0ull - v) : v;
  return 1;
}

static inline const char* tok_end(const char* p, const char* line_end) {
  while (p < line_end && *p != ' ' && *p != '\t' && *p != '\r') ++p;
  return p;
}

int64_t ps_parse_libsvm(const char* buf, int64_t len,
                        float* y, int64_t* indptr, uint64_t* indices,
                        float* values, int32_t* slots, int64_t max_rows,
                        int64_t max_nnz, int64_t* out_nnz) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t row = 0, nnz = 0;
  indptr[0] = 0;
  while (p < end && row < max_rows) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    const char* next = line_end + 1;
    p = skip_ws(p, line_end);
    if (p >= line_end) { p = next; continue; }
    // label: strict full token (fast path for the ubiquitous one-digit
    // labels, identical grammar)
    const char* te = tok_end(p, line_end);
    double label;
    if (te - p == 1 && *p >= '0' && *p <= '9') {
      label = (double)(*p - '0');
    } else if (te - p == 2 && (*p == '+' || *p == '-') &&
               p[1] >= '0' && p[1] <= '9') {
      label = (*p == '-') ? -(double)(p[1] - '0') : (double)(p[1] - '0');
    } else if (!parse_decfloat(p, te, &label)) {
      p = next;  // ref: strtofloat(label) false -> drop line
      continue;
    }
    p = te;
    int64_t row_start = nnz;
    uint64_t last_idx = 0;
    int ok = 1;
    while (1) {
      p = skip_ws(p, line_end);
      if (p >= line_end) break;
      te = tok_end(p, line_end);
      const char* colon = p;
      while (colon < te && *colon != ':') ++colon;
      uint64_t idx;
      if (colon >= te ||                       // no ':' in token
          !parse_u64_tok(p, colon, &idx) ||    // bad index
          last_idx > idx) {                    // unordered (uint64)
        ok = 0;
        break;
      }
      last_idx = idx;
      double val;
      if (colon + 1 == te) {
        val = 0.0;  // ref: strtofloat("") succeeds with 0
      } else if (!parse_decfloat(colon + 1, te, &val)) {
        ok = 0;
        break;
      }
      if (nnz >= max_nnz) { *out_nnz = indptr[row]; return -(row + 1); }
      indices[nnz] = idx;
      values[nnz] = (float)val;
      if (slots) slots[nnz] = 1;
      ++nnz;
      p = te;
    }
    if (!ok) { nnz = row_start; p = next; continue; }  // drop the WHOLE line
    y[row] = (float)(label <= 0 ? -1.0 : 1.0);
    indptr[++row] = nnz;
    p = next;
  }
  *out_nnz = nnz;
  return row;
}

// criteo tsv: "label \t i1..i13 ints \t c14..c39 categorical tokens".
// Reference semantics (data/text_parser.cc ParseCriteo): ALL features are
// BINARY keys — integer slot i with count c becomes key kMaxKey/13*i + c
// (one-hot by count), and a categorical token longer than 4 chars hashes
// through MurmurHash3_x64_128(seed 512927377) to h[0]^h[1]. Lines missing
// the integer-field tabs are dropped, as the reference returns false; a
// tab missing before the 25th categorical field likewise drops the line
// (ParseCriteo: `if (pp == NULL) { if (i != 25) return false; }`).
// criteo fields are a handful of bytes: an inline scan beats memchr's
// call + SIMD-setup overhead at these lengths (~40 fields/row), and a
// manual digit loop beats locale-aware strtol. Together ~1.8x parse
// throughput on the single-core host (the real-data pipeline is
// parse-bound there).
static inline const char* find_tab(const char* p, const char* line_end) {
  while (p < line_end && *p != '\t') ++p;
  return p < line_end ? p : NULL;
}

int64_t ps_parse_criteo(const char* buf, int64_t len,
                        float* y, int64_t* indptr, uint64_t* indices,
                        float* values, int32_t* slots, int64_t max_rows,
                        int64_t max_nnz, int64_t* out_nnz) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t row = 0, nnz = 0;
  indptr[0] = 0;
  const uint64_t kStripe = 0xFFFFFFFFFFFFFFFFull / 13;  // kMaxKey / 13
  while (p < end && row < max_rows) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    if (p >= line_end) { p = line_end + 1; continue; }
    int64_t row_nnz_start = nnz;
    double label;
    const char* f = find_tab(p, line_end);
    if (!f) { p = line_end + 1; continue; }
    if (f == p + 1 && (p[0] == '0' || p[0] == '1')) {
      // the overwhelmingly common criteo case: a bare 0/1 label
      label = p[0] - '0';
    } else if (f == p) {
      // empty label field: strtofloat("") is a successful
      // no-conversion in the reference -> label 0 (negative class)
      label = 0.0;
    } else {
      // ref strtofloat: leading spaces, then a full decimal-float
      // field (same strict grammar as the libsvm paths)
      const char* ls = p;
      while (ls < f && *ls == ' ') ++ls;
      if (!parse_decfloat(ls, f, &label)) { p = line_end + 1; continue; }
    }
    p = f + 1;
    int ok = 1;
    for (int i = 0; i < 13; ++i) {  // integer count features
      f = find_tab(p, line_end);
      if (!f) { ok = 0; break; }  // ref: missing int tab drops the line
      if (f == p) {
        // EMPTY int field (how real criteo marks a missing value):
        // strtoi32("") succeeds with 0 in the reference, so it emits
        // key stripe*i + 0 — an empty field is NOT a skip
        if (nnz >= max_nnz) { *out_nnz = indptr[row]; return -(row + 1); }
        indices[nnz] = kStripe * (uint64_t)i;
        values[nnz] = 1.0f;
        if (slots) slots[nnz] = i + 1;
        ++nnz;
      } else {
        // ref strtoi32 (strtonum.h): strtol must consume the WHOLE field
        // (leading spaces ok, then sign + digits, nothing after — a
        // partial parse like "4bb3f55c" SKIPS the field), the long
        // clamps at +/-2^63-ish on overflow, and the int32 assignment
        // truncates mod 2^32
        const char* e = p;
        while (e < f && *e == ' ') ++e;
        int neg = 0;
        if (e < f && (*e == '-' || *e == '+')) { neg = (*e == '-'); ++e; }
        unsigned long long acc = 0;
        int clamped = 0;
        const char* digits_start = e;
        while (e < f && *e >= '0' && *e <= '9') {
          unsigned d = (unsigned)(*e++ - '0');
          if (acc > (0x7FFFFFFFFFFFFFFFull - d) / 10) { clamped = 1; }
          acc = acc * 10 + d;
        }
        if (e != digits_start && e == f) {
          int64_t cnt64;
          if (clamped) cnt64 = neg ? (-0x7FFFFFFFFFFFFFFFll - 1) : 0x7FFFFFFFFFFFFFFFll;
          else cnt64 = neg ? -(int64_t)acc : (int64_t)acc;
          int64_t cnt = (int64_t)(int32_t)(uint32_t)(uint64_t)cnt64;
          if (nnz >= max_nnz) { *out_nnz = indptr[row]; return -(row + 1); }
          indices[nnz] = kStripe * (uint64_t)i + (uint64_t)cnt;
          values[nnz] = 1.0f;
          if (slots) slots[nnz] = i + 1;
          ++nnz;
        }
      }
      p = f + 1;
    }
    if (!ok) { nnz = row_nnz_start; p = line_end + 1; continue; }
    for (int i = 0; i < 26; ++i) {  // categorical tokens
      f = (p <= line_end) ? find_tab(p, line_end) : NULL;
      if (!f && i != 25) { ok = 0; break; }  // ref: missing cat tab drops line
      const char* tok_end = f ? f : line_end;
      int64_t n = tok_end - p;
      if (n > 4) {  // ref: short/empty tokens are skipped
        if (nnz >= max_nnz) { *out_nnz = indptr[row]; return -(row + 1); }
        uint64_t h[2];
        ps_murmur3_x64_128((const uint8_t*)p, (uint64_t)n, 512927377u, h);
        indices[nnz] = h[0] ^ h[1];
        values[nnz] = 1.0f;
        if (slots) slots[nnz] = i + 14;
        ++nnz;
      }
      p = tok_end + 1;
    }
    if (!ok) { nnz = row_nnz_start; p = line_end + 1; continue; }
    y[row] = label > 0 ? 1.0f : -1.0f;
    indptr[++row] = nnz;
    p = line_end + 1;
  }
  *out_nnz = nnz;
  return row;
}

// ---------------------------------------------------------------------------
// Fast byte-level LZ wire codec — the role of the reference's snappy
// message compression (src/util/shared_array_inl.h:245 CompressTo /
// UncompressFrom, used by src/filter/compressing.h on every filtered
// message). snappy/LZ4 aren't in this environment, so this is an
// LZ4-style block codec of our own: greedy 4-byte-hash matcher, 16-bit
// offsets, token = (literal_len:4 | match_len-4:4) with 255-run length
// extensions, stream ends with a literals-only tail. Both ends are this
// library, so the format only needs to be self-consistent + safe: the
// decompressor bounds-checks every read/write and rejects malformed
// input with -1 (wire payloads are untrusted); -2 means the output
// buffer is too small (retry with a bigger one — distinct from -1 so
// callers never grow buffers for garbage input).

static inline uint32_t lz_hash32(uint32_t v) {
  return (v * 2654435761u) >> 19;  // 13-bit table index
}

uint64_t ps_lz_max_compressed(uint64_t n) {
  // worst case: pure literals = n + one length-extension byte per 255
  // literals + token + terminator slack
  return n + n / 255 + 16;
}

int64_t ps_lz_compress(const uint8_t* src, uint64_t n,
                       uint8_t* dst, uint64_t cap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + n;
  const uint8_t* anchor = src;
  // matches must leave >= 5 bytes of tail literals and stop match
  // extension 5 bytes early (mirrors LZ4's endgame margins; keeps the
  // decoder's overlap copy away from buffer ends)
  const uint8_t* mflimit = (n > 12) ? iend - 12 : src;
  const uint8_t* matchlimit = iend - 5;
  uint8_t* op = dst;
  uint8_t* oend = dst + cap;
  uint32_t table[1u << 13];  // position+1 into src; 0 = empty
  memset(table, 0, sizeof(table));

  if (n > 12) {
    // skip acceleration (the LZ4 trick): on incompressible stretches
    // the step between probes grows, so pure-noise input costs ~1
    // probe per 2 bytes instead of per byte
    uint32_t miss = 0;
    while (ip < mflimit) {
      uint32_t seq;
      memcpy(&seq, ip, 4);
      uint32_t h = lz_hash32(seq);
      uint32_t prev = table[h];
      table[h] = (uint32_t)(ip - src) + 1;
      uint32_t cand4;
      if (prev && (uint64_t)(ip - src) + 1 - prev <= 0xFFFF &&
          (memcpy(&cand4, src + prev - 1, 4), cand4 == seq)) {
        miss = 0;
        const uint8_t* match = src + prev - 1;
        const uint8_t* q = ip + 4;
        const uint8_t* m = match + 4;
        while (q < matchlimit && *q == *m) { ++q; ++m; }
        uint64_t mlen = (uint64_t)(q - ip) - 4;  // stored as len-4
        uint64_t lit = (uint64_t)(ip - anchor);
        // token + worst-case length extensions + literals + offset
        if ((uint64_t)(oend - op) < 1 + lit + lit / 255 + 1 + 2 + mlen / 255 + 1)
          return -1;
        uint8_t* tok = op++;
        if (lit >= 15) {
          *tok = (uint8_t)(15u << 4);
          uint64_t rest = lit - 15;
          while (rest >= 255) { *op++ = 255; rest -= 255; }
          *op++ = (uint8_t)rest;
        } else {
          *tok = (uint8_t)(lit << 4);
        }
        memcpy(op, anchor, lit);
        op += lit;
        uint32_t off = (uint32_t)(ip - match);
        *op++ = (uint8_t)(off & 0xFF);
        *op++ = (uint8_t)(off >> 8);
        if (mlen >= 15) {
          *tok |= 15;
          uint64_t rest = mlen - 15;
          while (rest >= 255) { *op++ = 255; rest -= 255; }
          *op++ = (uint8_t)rest;
        } else {
          *tok |= (uint8_t)mlen;
        }
        ip += mlen + 4;
        anchor = ip;
      } else {
        ip += 1 + (miss++ >> 6);
      }
    }
  }
  // literals-only tail
  {
    uint64_t lit = (uint64_t)(iend - anchor);
    if ((uint64_t)(oend - op) < 1 + lit + lit / 255 + 1) return -1;
    uint8_t* tok = op++;
    if (lit >= 15) {
      *tok = (uint8_t)(15u << 4);
      uint64_t rest = lit - 15;
      while (rest >= 255) { *op++ = 255; rest -= 255; }
      *op++ = (uint8_t)rest;
    } else {
      *tok = (uint8_t)(lit << 4);
    }
    memcpy(op, anchor, lit);
    op += lit;
  }
  return (int64_t)(op - dst);
}

int64_t ps_lz_decompress(const uint8_t* src, uint64_t n,
                         uint8_t* dst, uint64_t cap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + n;
  uint8_t* op = dst;
  uint8_t* oend = dst + cap;
  while (ip < iend) {
    uint8_t tok = *ip++;
    uint64_t lit = tok >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (lit > (uint64_t)(iend - ip)) return -1;
    if (lit > (uint64_t)(oend - op)) return -2;
    memcpy(op, ip, lit);
    op += lit;
    ip += lit;
    if (ip >= iend) {
      // literals-only tail: a match-nibble here would be malformed
      if ((tok & 15) != 0) return -1;
      break;
    }
    if ((uint64_t)(iend - ip) < 2) return -1;
    uint32_t off = (uint32_t)ip[0] | ((uint32_t)ip[1] << 8);
    ip += 2;
    uint64_t mlen = (uint64_t)(tok & 15);
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (off == 0 || off > (uint64_t)(op - dst)) return -1;
    if (mlen > (uint64_t)(oend - op)) return -2;
    const uint8_t* m = op - off;
    if (off >= mlen) {
      memcpy(op, m, mlen);  // disjoint
    } else if (off >= 8 && mlen + 8 <= (uint64_t)(oend - op)) {
      // overlapping but period >= 8: 8-byte strided copies are safe
      // (each copies bytes written >= 8 positions back); may write up
      // to 7 bytes past mlen, bounded above
      for (uint64_t i = 0; i < mlen; i += 8) memcpy(op + i, m + i, 8);
    } else {
      // short period (e.g. RLE, off=1): byte-wise is required
      for (uint64_t i = 0; i < mlen; ++i) op[i] = m[i];
    }
    op += mlen;
  }
  return (int64_t)(op - dst);
}


}  // extern "C"
