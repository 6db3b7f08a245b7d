// Native host-side I/O runtime: FASTQ -> fixed-shape device batch encoder.
//
// The device engine consumes (B, L) uint8 base-code arrays plus per-read k-mer
// counts and per-kmer-index quality bytes (see io/fastq.py). Python-level
// parsing tops out well below device throughput, so this C++ path does the
// byte scanning and 2-bit encoding; Python keeps orchestration. The
// counterpart of the reference's fgets loop (src/qv.cc:760-763), built for
// batch feeding instead of one-read-at-a-time.
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// base -> code table: A/a=0 C/c=1 G/g=2 T/t=3 N/n=4 other=7
struct CodeTable {
  uint8_t t[256];
  CodeTable() {
    std::memset(t, 7, sizeof(t));
    t[(unsigned)'A'] = 0; t[(unsigned)'a'] = 0;
    t[(unsigned)'C'] = 1; t[(unsigned)'c'] = 1;
    t[(unsigned)'G'] = 2; t[(unsigned)'g'] = 2;
    t[(unsigned)'T'] = 3; t[(unsigned)'t'] = 3;
    t[(unsigned)'N'] = 4; t[(unsigned)'n'] = 4;
  }
};
const CodeTable kCodes;

inline const char* find_nl(const char* p, const char* end) {
  const void* nl = std::memchr(p, '\n', end - p);
  return nl ? static_cast<const char*>(nl) : end;
}

}  // namespace

extern "C" {

// Parse up to `batch` COMPLETE FASTQ records from buf[*cursor:len].
// Outputs (caller-allocated):
//   codes:   batch*L uint8, prefilled is NOT required (fully written)
//   n_kmers: batch int32
//   qual:    batch*K uint8
// Returns number of reads parsed; advances *cursor past them. A record
// whose four lines are not all newline-terminated inside the buffer is
// NOT consumed (cursor stays at its '@' line), so callers can stream the
// file in bounded windows and carry the incomplete tail into the next
// window (native.fastq_batches).
// max_slen (in/out): running maximum raw sequence length seen, so callers
// can detect reads longer than the configured L (silent truncation would
// diverge from the reference, which handles reads up to 1023 bases --
// BUF_SIZE at src/qv.cc:700).
// qlen_mismatch (in/out): count of records whose quality-line length
// differs from the sequence length (spec violation; quality is indexed by
// k-mer slot, qv.cc:836, so a short line silently mis-gates the neighbor
// search -- callers surface a warning). A trailing '\r' is stripped from
// sequence and quality lines, so CRLF FASTQs parse identically to LF ones
// (the reference would silently drop every read of a CRLF file as
// containing a non-ACGT base).
int64_t vgt_fastq_batch(const char* buf, int64_t len, int64_t* cursor,
                        int64_t batch, int64_t L, int64_t K,
                        uint8_t* codes, int32_t* n_kmers, uint8_t* qual,
                        int64_t* max_slen, int64_t* qlen_mismatch) {
  const char* p = buf + *cursor;
  const char* end = buf + len;
  int64_t filled = 0;
  while (filled < batch && p < end) {
    const char* rec = p;
    // @id line
    const char* nl = find_nl(p, end);
    if (nl == end) break;
    p = nl + 1;
    // sequence line
    const char* seq = p;
    nl = find_nl(p, end);
    int64_t slen = nl - seq;
    if (nl == end) { p = rec; break; }
    if (slen > 0 && seq[slen - 1] == '\r') --slen;
    p = nl + 1;
    // + line
    nl = find_nl(p, end);
    if (nl == end) { p = rec; break; }
    p = nl + 1;
    // quality line
    const char* q = p;
    nl = find_nl(p, end);
    int64_t qlen = nl - q;
    if (nl == end) { p = rec; break; }
    if (qlen > 0 && q[qlen - 1] == '\r') --qlen;
    p = nl + 1;

    if (qlen != slen) ++*qlen_mismatch;
    if (slen > *max_slen) *max_slen = slen;
    uint8_t* crow = codes + filled * L;
    int64_t ln = slen < L ? slen : L;
    for (int64_t i = 0; i < ln; ++i)
      crow[i] = kCodes.t[(unsigned char)seq[i]];
    if (ln < L) std::memset(crow + ln, 4, L - ln);
    int64_t k = ln / 32;
    if (k > K) k = K;
    n_kmers[filled] = (int32_t)k;
    uint8_t* qrow = qual + filled * K;
    int64_t nq = qlen < K ? qlen : K;
    for (int64_t i = 0; i < nq; ++i) qrow[i] = (uint8_t)q[i];
    if (nq < K) std::memset(qrow + nq, 0, K - nq);
    ++filled;
  }
  *cursor = p - buf;
  return filled;
}

// Batch k-mer pre-encoder: (B, L) uint8 base codes -> per-slot kmer words
// (hi, lo) plus validity, exactly mirroring the device-side encode
// (engine/batch.py encode_batch; reference semantics src/qv.cc:810-828:
// a non-ACGT base anywhere in the read's in-use windows drops the whole
// read in that orientation). Shipping the packed words instead of raw
// codes cuts per-batch host->device transfer ~3.6x.
void vgt_encode_batch(const uint8_t* codes, const int32_t* n_kmers,
                      int64_t B, int64_t L, int64_t K,
                      uint32_t* hi, uint32_t* lo, uint8_t* kvalid,
                      uint8_t* read_ok) {
  for (int64_t b = 0; b < B; ++b) {
    const uint8_t* row = codes + b * L;
    int nk = n_kmers[b];
    if (nk > K) nk = (int)K;
    int ok = 1;
    for (int64_t k = 0; k < K; ++k) {
      const uint8_t* w = row + k * 32;
      uint32_t l = 0, h = 0;
      int bad = 0;
      for (int i = 0; i < 16; ++i) {
        uint8_t c = w[i];
        bad |= (c > 3);
        l |= (uint32_t)(c > 3 ? 0 : c) << (2 * i);
      }
      for (int i = 0; i < 16; ++i) {
        uint8_t c = w[16 + i];
        bad |= (c > 3);
        h |= (uint32_t)(c > 3 ? 0 : c) << (2 * i);
      }
      hi[b * K + k] = h;
      lo[b * K + k] = l;
      if (bad && k < nk) ok = 0;
      kvalid[b * K + k] = (k < nk);
    }
    read_ok[b] = (uint8_t)ok;
    if (!ok)
      for (int64_t k = 0; k < K; ++k) kvalid[b * K + k] = 0;
  }
}

// Reverse-complement retry compaction: gather the selected reads, reverse-
// complement their in-use bases (reference semantics src/qv.cc:787-806:
// length = n_kmers*32; the quality string is NOT reversed), pad the tail
// with 4. Replaces a chain of numpy mask/gather/where ops that cost
// ~20 ms/batch on the host dispatch loop's critical path.
void vgt_revcomp_select(const uint8_t* codes, const int32_t* n_kmers,
                        const uint8_t* qual, int64_t L, int64_t K,
                        const int32_t* sel, int64_t n_sel,
                        uint8_t* out_codes, int32_t* out_nk,
                        uint8_t* out_qual) {
  for (int64_t s = 0; s < n_sel; ++s) {
    int64_t b = sel[s];
    const uint8_t* row = codes + b * L;
    uint8_t* orow = out_codes + s * L;
    int64_t len = (int64_t)n_kmers[b] * 32;
    if (len > L) len = L;
    for (int64_t i = 0; i < len; ++i) {
      uint8_t c = row[len - 1 - i];
      orow[i] = c < 4 ? (uint8_t)(3 - c) : c;
    }
    if (len < L) std::memset(orow + len, 4, L - len);
    out_nk[s] = n_kmers[b];
    std::memcpy(out_qual + s * K, qual + b * K, K);
  }
}

// Rolling 32-mer extraction for index build: writes one uint64 per window
// and a validity byte (window free of non-ACGT). codes: n uint8.
// Returns number of windows (n-31) or 0.
int64_t vgt_rolling_kmers(const uint8_t* codes, int64_t n,
                          uint64_t* kmers, uint8_t* valid) {
  if (n < 32) return 0;
  int64_t nw = n - 31;
  uint64_t k = 0;
  int bad = 0;  // count of invalid bases in current window
  for (int64_t i = 0; i < 31; ++i) {
    uint8_t c = codes[i];
    if (c > 3) { bad++; c = 0; }
    k |= (uint64_t)(c & 3) << (2 * i);
  }
  // window w covers [w, w+31]
  for (int64_t w = 0; w < nw; ++w) {
    uint8_t c = codes[w + 31];
    int in_bad = (c > 3);
    bad += in_bad;
    k |= (uint64_t)(c & 3) << 62;
    kmers[w] = k;
    valid[w] = (bad == 0);
    // slide: drop base w
    uint8_t drop_bad = (codes[w] > 3);
    bad -= drop_bad;
    k >>= 2;
  }
  return nw;
}

// Set bits in an LSB-first uint64 bitmap. numpy's bitwise_or.at tops out
// around ~10M updates/s; this runs at memory speed, which matters when
// inserting ~3G whole-genome k-mers into the 9.6 Gbit reference filter.
void vgt_bf_set_bits(uint64_t* words, const uint64_t* bit_idx, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t b = bit_idx[i];
    words[b >> 6] |= (uint64_t)1 << (b & 63);
  }
}

// Test bits (1 byte out per index).
void vgt_bf_test_bits(const uint64_t* words, const uint64_t* bit_idx,
                      int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t b = bit_idx[i];
    out[i] = (words[b >> 6] >> (b & 63)) & 1;
  }
}

// Reduce precomputed 64-bit hash values modulo the filter size and set the
// bits, in one pass (numpy's u64 modulo is a scalar fallback; this is the
// index build's hot loop at whole-genome scale).
void vgt_bf_mod_set(uint64_t* words, const uint64_t* hashes, int64_t n,
                    uint64_t mod) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t b = hashes[i] % mod;
    words[b >> 6] |= (uint64_t)1 << (b & 63);
  }
}

// Bucketized hash-table build (layout of engine/hashtable.py): sequential
// insertion with linear probing over `slots`-wide buckets; one contiguous
// (nb, slots*4) uint32 row per bucket. Returns the lookup chain bound
// (max displacement + 1). `table` must be zeroed, `cap` a zeroed (nb,)
// uint8 scratch. Replaces the numpy round-based placement (80 s at 48M
// keys) with a single pass at memory speed.
static inline uint32_t vgt_hash32(uint32_t x) {
  x = ((x >> 16) ^ x) * 0x45d9f3bu;
  x = ((x >> 16) ^ x) * 0x45d9f3bu;
  return (x >> 16) ^ x;
}

int64_t vgt_ht_build(const uint32_t* hi, const uint32_t* lo,
                     const uint32_t* pos, const uint8_t* flag,
                     const uint8_t* info, int64_t n, int64_t nb,
                     int64_t slots, uint32_t* table, uint8_t* cap) {
  uint64_t maxd = 0;
  const uint32_t kMix = 0x9E3779B9u;
  const uint32_t mask = (uint32_t)(nb - 1);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t h = vgt_hash32(lo[i]) ^ (vgt_hash32(hi[i]) * kMix);
    int64_t b = (int64_t)(h & mask);
    uint64_t d = 0;
    while (cap[b] >= slots) { b = (b + 1) & mask; ++d; }
    int64_t col = cap[b]++;
    // FIELD-BLOCKED row: [hi x slots | lo x slots | pos x slots |
    // meta x slots] -- field extraction on device is a contiguous lane
    // slice of the gathered row instead of a strided (slots, 4) reshape,
    // which XLA lowered as a whole-result relayout copy per lookup
    uint32_t* row = table + b * slots * 4;
    row[col] = hi[i];
    row[slots + col] = lo[i];
    row[2 * slots + col] = pos[i];
    uint32_t meta = 0x80000000u | (uint32_t)flag[i];
    if (info) meta |= ((uint32_t)info[i]) << 16;
    row[3 * slots + col] = meta;
    if (d > maxd) maxd = d;
  }
  return (int64_t)maxd + 1;
}

// Stable LSD radix argsort of u64 keys: 4 passes of 16 bits, each pass a
// threaded histogram + stable scatter of (key, index) pairs. The index
// build's dictionary sort (dictgen.c:53-61 uses glibc qsort) is the
// dominant host cost at whole-genome scale; numpy's stable argsort runs
// ~16 s at 48M keys, this runs at memory speed. Indices are u32 (the
// reference's own 2^32-rows-per-dict limit, qv.cc:523-526).
// Returns 0 on success, -1 on allocation failure.
int64_t vgt_radix_argsort_u64(const uint64_t* keys, int64_t n,
                              uint32_t* idx_out) {
  if (n <= 0) return 0;
  const int kBits = 16, kBins = 1 << kBits;
  uint64_t* ka = static_cast<uint64_t*>(std::malloc(n * sizeof(uint64_t)));
  uint64_t* kb = static_cast<uint64_t*>(std::malloc(n * sizeof(uint64_t)));
  uint32_t* ib = static_cast<uint32_t*>(std::malloc(n * sizeof(uint32_t)));
  if (!ka || !kb || !ib) {
    std::free(ka); std::free(kb); std::free(ib);
    return -1;
  }
  std::memcpy(ka, keys, n * sizeof(uint64_t));
  for (int64_t i = 0; i < n; ++i) idx_out[i] = (uint32_t)i;

  unsigned hw = std::thread::hardware_concurrency();
  int T = (int)(hw ? hw : 1);
  if ((int64_t)T > n / (1 << 16) + 1) T = (int)(n / (1 << 16) + 1);
  if (T < 1) T = 1;
  std::vector<int64_t> bounds(T + 1);
  for (int t = 0; t <= T; ++t) bounds[t] = n * t / T;
  std::vector<std::vector<int64_t>> hist((size_t)T);

  uint64_t* src_k = ka; uint64_t* dst_k = kb;
  uint32_t* src_i = idx_out; uint32_t* dst_i = ib;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * kBits;
    // phase 1: per-thread digit histograms
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t) {
      th.emplace_back([&, t]() {
        auto& h = hist[t];
        h.assign(kBins, 0);
        for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i)
          ++h[(src_k[i] >> shift) & (kBins - 1)];
      });
    }
    for (auto& x : th) x.join();
    // single-digit pass: nothing moves, skip the scatter
    int nz = 0, last = -1;
    {
      std::vector<int64_t> tot(kBins, 0);
      for (int t = 0; t < T; ++t)
        for (int b = 0; b < kBins; ++b) tot[b] += hist[t][b];
      for (int b = 0; b < kBins && nz < 2; ++b)
        if (tot[b]) { ++nz; last = b; }
      (void)last;
      if (nz < 2) continue;
      // bin-major, thread-minor exclusive offsets (stability)
      int64_t run = 0;
      for (int b = 0; b < kBins; ++b)
        for (int t = 0; t < T; ++t) {
          int64_t c = hist[t][b];
          hist[t][b] = run;
          run += c;
        }
    }
    // phase 2: stable scatter
    th.clear();
    for (int t = 0; t < T; ++t) {
      th.emplace_back([&, t]() {
        auto& off = hist[t];
        for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i) {
          int64_t d = (int64_t)((src_k[i] >> shift) & (kBins - 1));
          int64_t o = off[d]++;
          dst_k[o] = src_k[i];
          dst_i[o] = src_i[i];
        }
      });
    }
    for (auto& x : th) x.join();
    std::swap(src_k, dst_k);
    std::swap(src_i, dst_i);
  }
  if (src_i != idx_out)
    std::memcpy(idx_out, src_i, n * sizeof(uint32_t));
  std::free(ka); std::free(kb); std::free(ib);
  return 0;
}

// In-place stable key-value radix sort: sorts keys[0..n) ascending and
// carries vals along. Peak extra memory = ONE key buffer + ONE val buffer
// (n*12 B), vs argsort's n*36 B of temporaries PLUS the caller's two
// fancy-index applications -- the difference OOM'd the 3 Gb whole-genome
// index build (3G k-mers) on a 125 GB host twice.
int64_t vgt_radix_sort_kv_u64u32(uint64_t* keys, uint32_t* vals,
                                 int64_t n) {
  if (n <= 0) return 0;
  const int kBits = 16, kBins = 1 << kBits;
  uint64_t* kb = static_cast<uint64_t*>(std::malloc(n * sizeof(uint64_t)));
  uint32_t* vb = static_cast<uint32_t*>(std::malloc(n * sizeof(uint32_t)));
  if (!kb || !vb) { std::free(kb); std::free(vb); return -1; }

  unsigned hw = std::thread::hardware_concurrency();
  int T = (int)(hw ? hw : 1);
  if ((int64_t)T > n / (1 << 16) + 1) T = (int)(n / (1 << 16) + 1);
  if (T < 1) T = 1;
  std::vector<int64_t> bounds(T + 1);
  for (int t = 0; t <= T; ++t) bounds[t] = n * t / T;
  std::vector<std::vector<int64_t>> hist((size_t)T);

  uint64_t* src_k = keys; uint64_t* dst_k = kb;
  uint32_t* src_v = vals; uint32_t* dst_v = vb;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * kBits;
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t) {
      th.emplace_back([&, t]() {
        auto& h = hist[t];
        h.assign(kBins, 0);
        for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i)
          ++h[(src_k[i] >> shift) & (kBins - 1)];
      });
    }
    for (auto& x : th) x.join();
    int nz = 0;
    {
      std::vector<int64_t> tot(kBins, 0);
      for (int t = 0; t < T; ++t)
        for (int b = 0; b < kBins; ++b) tot[b] += hist[t][b];
      for (int b = 0; b < kBins && nz < 2; ++b)
        if (tot[b]) ++nz;
      if (nz < 2) continue;  // single digit: nothing moves
      int64_t run = 0;
      for (int b = 0; b < kBins; ++b)
        for (int t = 0; t < T; ++t) {
          int64_t c = hist[t][b];
          hist[t][b] = run;
          run += c;
        }
    }
    th.clear();
    for (int t = 0; t < T; ++t) {
      th.emplace_back([&, t]() {
        auto& off = hist[t];
        for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i) {
          int64_t d = (int64_t)((src_k[i] >> shift) & (kBins - 1));
          int64_t o = off[d]++;
          dst_k[o] = src_k[i];
          dst_v[o] = src_v[i];
        }
      });
    }
    for (auto& x : th) x.join();
    std::swap(src_k, dst_k);
    std::swap(src_v, dst_v);
  }
  if (src_k != keys) {
    std::memcpy(keys, src_k, n * sizeof(uint64_t));
    std::memcpy(vals, src_v, n * sizeof(uint32_t));
  }
  std::free(kb); std::free(vb);
  return 0;
}

}  // extern "C"
