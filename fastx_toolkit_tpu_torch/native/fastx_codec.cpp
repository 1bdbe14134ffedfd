// Native host codec hot loops for fastx_toolkit_tpu.
//
// The Python/numpy codec (fastx_toolkit_tpu/core/codec.py) does record
// framing and validation vectorized, but the two memory-movement loops --
// scattering variable-length lines into padded [B, W] matrices and
// assembling the final FASTA/FASTQ byte stream -- are fancy-indexing
// bound in numpy.  These are plain memcpy loops in C++, parallelized
// over record ranges (each record's output span is precomputed, so
// threads never touch overlapping bytes).
//
// Built as a plain shared library (no pybind11); called via ctypes with
// raw pointers from numpy arrays.  The reference's analogous code is the
// fgets/fprintf record loop in FASTX-Toolkit src/libfastx/fastx.c
// (fastx_read_next_record / fastx_write_record).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int pick_threads(int64_t n, int requested) {
  int hw = (int)std::thread::hardware_concurrency();
  int t = requested > 0 ? requested : (hw > 0 ? hw : 1);
  if (n < 4096) t = 1;
  return t;
}

template <typename F>
void parallel_ranges(int64_t n, int nthreads, F&& body) {
  if (nthreads <= 1) {
    body((int64_t)0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int i = 0; i < nthreads; i++) {
    int64_t s = i * chunk;
    int64_t e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    ts.emplace_back([&, s, e] { body(s, e); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Scatter variable-length byte slices into a zero-padded [n, width]
// matrix.
void fx_gather_rows(const uint8_t* buf, const int64_t* starts,
                    const int64_t* lens, int64_t n, int64_t width,
                    uint8_t* out, int nthreads) {
  parallel_ranges(n, pick_threads(n, nthreads), [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++) {
      uint8_t* dst = out + i * width;
      int64_t len = lens[i];
      if (len > width) len = width;
      memcpy(dst, buf + starts[i], (size_t)len);
      memset(dst + len, 0, (size_t)(width - len));
    }
  });
}

// Validate sequence bytes against an allowed[256] table; returns the
// index of the first invalid record, or -1.  Rows are (starts, lens)
// into buf.
int64_t fx_validate_rows(const uint8_t* buf, const int64_t* starts,
                         const int64_t* lens, int64_t n,
                         const uint8_t* allowed) {
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* p = buf + starts[i];
    int64_t len = lens[i];
    for (int64_t j = 0; j < len; j++) {
      if (!allowed[p[j]]) return i;
    }
  }
  return -1;
}

// ASCII quality line -> numeric values, with range check.
// Returns -1 on success, else the failing record index.
int64_t fx_quals_from_ascii(const uint8_t* buf, const int64_t* starts,
                            const int64_t* lens, int64_t n, int64_t width,
                            int q_offset, int8_t* out, int nthreads) {
  std::vector<int64_t> bad((size_t)pick_threads(n, nthreads), -1);
  int nt = pick_threads(n, nthreads);
  std::vector<int64_t> bads(nt, -1);
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t s = t * chunk;
    int64_t e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    ts.emplace_back([&, t, s, e] {
      for (int64_t i = s; i < e; i++) {
        const uint8_t* p = buf + starts[i];
        int8_t* dst = out + i * width;
        int64_t len = lens[i];
        if (len > width) len = width;
        for (int64_t j = 0; j < len; j++) {
          int v = (int)p[j] - q_offset;
          if (v < -15 || v > 93) {
            if (bads[t] < 0 || i < bads[t]) bads[t] = i;
            v = 0;
          }
          dst[j] = (int8_t)v;
        }
        memset(dst + len, 0, (size_t)(width - len));
      }
    });
  }
  for (auto& th : ts) th.join();
  int64_t first = -1;
  for (int t = 0; t < nt; t++)
    if (bads[t] >= 0 && (first < 0 || bads[t] < first)) first = bads[t];
  return first;
}

// Per-record output sizes for FASTQ rendering (ASCII quals):
// 1 + name + 1 + len + 1 + 1 + name2 + 1 + len + 1
void fx_fastq_sizes(const int64_t* name_lens, const int64_t* name2_lens,
                    const int32_t* lens, int64_t n, int64_t* out_sizes) {
  for (int64_t i = 0; i < n; i++)
    out_sizes[i] = 6 + name_lens[i] + name2_lens[i] + 2 * (int64_t)lens[i];
}

void fx_fasta_sizes(const int64_t* name_lens, const int32_t* lens, int64_t n,
                    int64_t* out_sizes) {
  for (int64_t i = 0; i < n; i++)
    out_sizes[i] = 3 + name_lens[i] + (int64_t)lens[i];
}

// Assemble FASTQ bytes.  rec_offs[i] is the output offset of record i
// (exclusive cumsum of fx_fastq_sizes with dropped records at size 0),
// so threads write disjoint spans.  Records with keep[i]==0 are skipped
// (keep==NULL keeps everything); when mask_enable!=0, bases with quality
// < mask_thr are replaced by mask_char during the copy (the fastq_masker
// fused into rendering).
void fx_render_fastq(const uint8_t* bases, const int8_t* quals,
                     const int32_t* lens, int64_t n, int64_t width,
                     const uint8_t* name_buf, const int64_t* name_offs,
                     const uint8_t* name2_buf, const int64_t* name2_offs,
                     const int64_t* rec_offs, int q_offset, uint8_t* out,
                     const uint8_t* keep, int mask_enable, int mask_thr,
                     uint8_t mask_char, int nthreads) {
  parallel_ranges(n, pick_threads(n, nthreads), [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++) {
      if (keep && !keep[i]) continue;
      uint8_t* p = out + rec_offs[i];
      int64_t len = lens[i];
      *p++ = '@';
      int64_t nl = name_offs[i + 1] - name_offs[i];
      memcpy(p, name_buf + name_offs[i], (size_t)nl);
      p += nl;
      *p++ = '\n';
      const int8_t* q = quals + i * width;
      if (mask_enable) {
        const uint8_t* b = bases + i * width;
        for (int64_t j = 0; j < len; j++)
          p[j] = q[j] < mask_thr ? mask_char : b[j];
      } else {
        memcpy(p, bases + i * width, (size_t)len);
      }
      p += len;
      *p++ = '\n';
      *p++ = '+';
      int64_t n2 = name2_offs[i + 1] - name2_offs[i];
      memcpy(p, name2_buf + name2_offs[i], (size_t)n2);
      p += n2;
      *p++ = '\n';
      for (int64_t j = 0; j < len; j++) p[j] = (uint8_t)(q[j] + q_offset);
      p += len;
      *p++ = '\n';
    }
  });
}

void fx_render_fasta(const uint8_t* bases, const int32_t* lens, int64_t n,
                     int64_t width, const uint8_t* name_buf,
                     const int64_t* name_offs, const int64_t* rec_offs,
                     uint8_t* out, const uint8_t* keep, int nthreads) {
  parallel_ranges(n, pick_threads(n, nthreads), [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++) {
      if (keep && !keep[i]) continue;
      uint8_t* p = out + rec_offs[i];
      int64_t len = lens[i];
      *p++ = '>';
      int64_t nl = name_offs[i + 1] - name_offs[i];
      memcpy(p, name_buf + name_offs[i], (size_t)nl);
      p += nl;
      *p++ = '\n';
      memcpy(p, bases + i * width, (size_t)len);
      p += len;
      *p++ = '\n';
    }
  });
}

}  // extern "C"

extern "C" {

// Single-pass line indexing: fills starts[] (offset of each line's first
// byte) and returns the line count; *has_cr is set if any CR byte exists
// (so the Python codec can skip its chomp pass entirely on normal
// files).  starts must have room for n/2+2 entries (every line needs at
// least 1 byte + newline, except a final unterminated line).
int64_t fx_index_lines(const uint8_t* buf, int64_t n, int64_t* starts,
                       int32_t* has_cr) {
  int64_t count = 0;
  int64_t pos = 0;
  int hc = 0;
  starts[count++] = 0;
  const uint8_t* base = buf;
  while (pos < n) {
    const uint8_t* nl = (const uint8_t*)memchr(base + pos, '\n', (size_t)(n - pos));
    if (!nl) break;
    int64_t at = nl - base;
    starts[count++] = at + 1;
    pos = at + 1;
  }
  // CR detection in one extra scan only if the file might have them;
  // memchr is ~memory-bandwidth so this is cheap
  hc = memchr(buf, '\r', (size_t)n) != nullptr;
  *has_cr = hc;
  if (count > 0 && starts[count - 1] == n) count--;  // trailing newline
  return count;
}

// Concatenate variable-length slices into a flat buffer at precomputed
// offsets (exclusive cumsum of lens).
void fx_gather_flat(const uint8_t* buf, const int64_t* starts,
                    const int64_t* lens, const int64_t* out_offs, int64_t n,
                    uint8_t* out, int nthreads) {
  parallel_ranges(n, pick_threads(n, nthreads), [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++) {
      memcpy(out + out_offs[i], buf + starts[i], (size_t)lens[i]);
    }
  });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused device-upload packing (engine/pipeline.py pack_batch/pack_batch2).
// One pass over the chunk instead of numpy's LUT-gather + shift + packbits
// chain (~6 passes); threaded over rows.
// ---------------------------------------------------------------------------

extern "C" {

// One fast scan: bit0 set iff every byte is PAD/A/C/G/T/N (2-bit domain),
// bit1 set iff any byte is 'N'.
namespace {
// function-local `static const` objects use C++11 magic statics, so
// first-call initialization is thread-safe (two concurrent streams may
// race a plain bool guard)
struct AcgtnTable {
  bool t[256] = {false};
  explicit AcgtnTable(bool with_pad) {
    if (with_pad) t[0] = true;
    t['A'] = t['C'] = t['G'] = t['T'] = t['N'] = true;
  }
};
struct Code2Table {
  uint8_t t[256] = {0};
  Code2Table() { t['C'] = 1; t['G'] = 2; t['T'] = 3; t['N'] = 3; }
};
struct Code4Table {
  uint8_t t[256] = {0};
  Code4Table() {
    const char* alpha = "ACGTNUacgtnu";
    for (int i = 0; alpha[i]; i++) t[(uint8_t)alpha[i]] = (uint8_t)(i + 1);
  }
};
}  // namespace

int32_t fx_scan_alphabet(const uint8_t* bases, int64_t total) {
  bool pure = true, has_n = false;
  static const AcgtnTable kTab(true);
  const bool* is_acgtn = kTab.t;
  for (int64_t i = 0; i < total; i++) {
    uint8_t b = bases[i];
    pure &= is_acgtn[b];
    has_n |= (b == 'N');
  }
  return (pure ? 1 : 0) | (has_n ? 2 : 0);
}

// 2-bit pack (pure-ACGTN chunks): bases[n,L] -> b2[n,ceil(L/4)] with
// A=0 C=1 G=2 T=3 (others 0); planes[n, P, ceil(L/8)] with optional
// plane 0 = (base=='N') then one `qual < t` plane per threshold,
// MSB-first like np.packbits.
void fx_pack2(const uint8_t* bases, const int8_t* quals, int64_t n,
              int64_t L, const int8_t* thr, int n_thr, int include_nplane,
              uint8_t* b2, uint8_t* planes, int nthreads) {
  // matches the numpy fallback's clip(code-1, 0, 3): A/PAD->0, C->1,
  // G->2, T->3; N (a don't-care, overridden by its bit-plane) -> 3
  static const Code2Table kCode2;
  const uint8_t* code2 = kCode2.t;
  const int64_t w2 = (L + 3) / 4;
  const int64_t w8 = (L + 7) / 8;
  const int64_t n_planes = n_thr + (include_nplane ? 1 : 0);
  parallel_ranges(n, pick_threads(n, nthreads), [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++) {
      const uint8_t* brow = bases + i * L;
      const int8_t* qrow = quals + i * L;
      uint8_t* orow = b2 + i * w2;
      for (int64_t j4 = 0; j4 < w2; j4++) {
        uint8_t v = 0;
        int64_t j = j4 * 4;
        int64_t lim = (j + 4 <= L) ? 4 : L - j;
        for (int64_t k = 0; k < lim; k++) v |= code2[brow[j + k]] << (6 - 2 * k);
        orow[j4] = v;
      }
      uint8_t* prow = planes + i * n_planes * w8;
      int p = 0;
      if (include_nplane) {
        for (int64_t j8 = 0; j8 < w8; j8++) {
          uint8_t v = 0;
          int64_t j = j8 * 8;
          int64_t lim = (j + 8 <= L) ? 8 : L - j;
          for (int64_t k = 0; k < lim; k++) v |= (brow[j + k] == 'N') << (7 - k);
          prow[j8] = v;
        }
        p = 1;
      }
      for (int t = 0; t < n_thr; t++, p++) {
        int8_t tv = thr[t];
        uint8_t* pr = prow + p * w8;
        for (int64_t j8 = 0; j8 < w8; j8++) {
          uint8_t v = 0;
          int64_t j = j8 * 8;
          int64_t lim = (j + 8 <= L) ? 8 : L - j;
          for (int64_t k = 0; k < lim; k++) v |= (qrow[j + k] < tv) << (7 - k);
          pr[j8] = v;
        }
      }
    }
  });
}

// 4-bit pack (full alphabet): codes 1..12 for "ACGTNUacgtnu", 0 = PAD /
// unknown; two codes per byte, high nibble first.
void fx_pack4(const uint8_t* bases, const int8_t* quals, int64_t n,
              int64_t L, const int8_t* thr, int n_thr, uint8_t* b4,
              uint8_t* planes, int nthreads) {
  static const Code4Table kCode4;
  const uint8_t* code4 = kCode4.t;
  const int64_t w4 = (L + 1) / 2;
  const int64_t w8 = (L + 7) / 8;
  parallel_ranges(n, pick_threads(n, nthreads), [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++) {
      const uint8_t* brow = bases + i * L;
      const int8_t* qrow = quals + i * L;
      uint8_t* orow = b4 + i * w4;
      for (int64_t j2 = 0; j2 < w4; j2++) {
        int64_t j = j2 * 2;
        uint8_t hi = code4[brow[j]];
        uint8_t lo = (j + 1 < L) ? code4[brow[j + 1]] : 0;
        orow[j2] = (uint8_t)((hi << 4) | lo);
      }
      uint8_t* prow = planes + i * (int64_t)n_thr * w8;
      for (int t = 0; t < n_thr; t++) {
        int8_t tv = thr[t];
        uint8_t* pr = prow + t * w8;
        for (int64_t j8 = 0; j8 < w8; j8++) {
          uint8_t v = 0;
          int64_t j = j8 * 8;
          int64_t lim = (j + 8 <= L) ? 8 : L - j;
          for (int64_t k = 0; k < lim; k++) v |= (qrow[j + k] < tv) << (7 - k);
          pr[j8] = v;
        }
      }
    }
  });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host-native quality-stats accumulation (link-aware path for
// fastx_quality_stats).  The reference walks every base once, adding to a
// per-cycle counting-sort histogram (FASTX-Toolkit src/
// fastx_quality_stats/fastx_quality_stats.c:166-216).  For FASTQ the
// collapsed multiplicity is always 1 (fastx.c:479-481), so count/sum/min/
// max are exact functions of the per-(cycle, nucleotide, quality)
// histogram -- one int64 increment per base here, everything else derived
// on the Python side (ops/stats.py derive_from_hist).  Threaded with
// per-thread private histograms merged at the end.
// ---------------------------------------------------------------------------

namespace {

// byte -> stats nucleotide slot: ALL=0 (unknown), A=1 C=2 G=3 T=4 N=5
// (mirrors fastx_quality_stats.c:139-153 nuc_to_index and
// core/records.py BaseCode.STATS_INDEX)
struct StatsIdx {
  uint8_t idx[256];
  StatsIdx() {
    memset(idx, 0, sizeof(idx));
    const char* pairs[5] = {"Aa", "Cc", "Gg", "Tt", "Nn"};
    for (int i = 0; i < 5; i++)
      for (int k = 0; k < 2; k++) idx[(uint8_t)pairs[i][k]] = (uint8_t)(i + 1);
  }
};
const StatsIdx kStatsIdx;

}  // namespace

extern "C" {

// FASTQ: pernuc[j, nuc, bin] += 1 per base (nuc slot only; the ALL slot
// is derived as sum+slot0 by the caller).  pernuc is caller-zeroed
// int64 [width, 6, 109]; bin = quality + 15 clamped to 0..108.
void fx_stats_hist_q(const uint8_t* bases, const int8_t* quals,
                     const int32_t* lens, int64_t n, int64_t width,
                     int64_t* pernuc, int nthreads) {
  const int64_t stride = 6 * 109;
  const int64_t total = width * stride;
  int nt = pick_threads(n, nthreads);
  if (nt <= 1) {
    for (int64_t i = 0; i < n; i++) {
      const uint8_t* b = bases + i * width;
      const int8_t* q = quals + i * width;
      int64_t len = lens[i];
      for (int64_t j = 0; j < len; j++) {
        int nuc = kStatsIdx.idx[b[j]];
        int bin = (int)q[j] + 15;
        if (bin < 0) bin = 0; else if (bin > 108) bin = 108;
        pernuc[j * stride + nuc * 109 + bin]++;
      }
    }
    return;
  }
  std::vector<std::vector<int64_t>> priv((size_t)nt);
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t s = t * chunk, e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    ts.emplace_back([&, t, s, e] {
      priv[(size_t)t].assign((size_t)total, 0);
      int64_t* acc = priv[(size_t)t].data();
      for (int64_t i = s; i < e; i++) {
        const uint8_t* b = bases + i * width;
        const int8_t* q = quals + i * width;
        int64_t len = lens[i];
        for (int64_t j = 0; j < len; j++) {
          int nuc = kStatsIdx.idx[b[j]];
          int bin = (int)q[j] + 15;
          if (bin < 0) bin = 0; else if (bin > 108) bin = 108;
          acc[j * stride + nuc * 109 + bin]++;
        }
      }
    });
  }
  for (auto& th : ts) th.join();
  for (auto& p : priv) {
    if (p.empty()) continue;
    const int64_t* src = p.data();
    for (int64_t k = 0; k < total; k++) pernuc[k] += src[k];
  }
}

// FASTA: pernuc_count[j, nuc] += counts[i] per base (nuc slot only; the
// reference weighs by the collapsed reads_count).  pernuc_count is
// caller-zeroed int64 [width, 6].
void fx_stats_counts(const uint8_t* bases, const int32_t* lens,
                     const int32_t* counts, int64_t n, int64_t width,
                     int64_t* pernuc_count, int nthreads) {
  const int64_t total = width * 6;
  int nt = pick_threads(n, nthreads);
  std::vector<std::vector<int64_t>> priv((size_t)nt);
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t s = t * chunk, e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    ts.emplace_back([&, t, s, e] {
      int64_t* acc;
      if (nt > 1) {
        priv[(size_t)t].assign((size_t)total, 0);
        acc = priv[(size_t)t].data();
      } else {
        acc = pernuc_count;
      }
      for (int64_t i = s; i < e; i++) {
        const uint8_t* b = bases + i * width;
        int64_t len = lens[i];
        int64_t w = counts[i];
        for (int64_t j = 0; j < len; j++)
          acc[j * 6 + kStatsIdx.idx[b[j]]] += w;
      }
    });
  }
  for (auto& th : ts) th.join();
  if (nt > 1)
    for (auto& p : priv) {
      if (p.empty()) continue;
      const int64_t* src = p.data();
      for (int64_t k = 0; k < total; k++) pernuc_count[k] += src[k];
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host-native sequence dedup (link-aware path for fastx_collapser).  The
// reference is a hash map sequence -> reads_count
// (FASTX-Toolkit src/fastx_collapser/fastx_collapser.cpp:112-114); this
// is an open-addressing table with the key bytes in a growing arena,
// sharded by hash so inserts parallelize without locks.  The table
// persists across streamed chunks (chunk-order inserts keep the
// first-appearance index minimal by construction).
// ---------------------------------------------------------------------------

namespace {

inline uint64_t hash_mix(uint64_t a, uint64_t b) {
  a ^= b;
  a *= 0x9E3779B97F4A7C15ull;
  a ^= a >> 29;
  a *= 0xBF58476D1CE4E5B9ull;
  return a;
}

inline uint64_t hash_bytes(const uint8_t* p, size_t len) {
  uint64_t h = 0x2545F4914F6CDD1Dull ^ (uint64_t)len;
  while (len >= 8) {
    uint64_t v;
    memcpy(&v, p, 8);
    h = hash_mix(h, v);
    p += 8;
    len -= 8;
  }
  if (len) {
    uint64_t v = 0;
    memcpy(&v, p, len);
    h = hash_mix(h, v);
  }
  h ^= h >> 32;
  return h;
}

struct DedupEntry {
  uint64_t hash;
  int64_t key_off;
  int32_t key_len;
  int64_t count;
  int64_t first;
};

struct DedupShard {
  std::vector<int64_t> slots;  // entry index + 1; 0 = empty
  std::vector<DedupEntry> entries;
  std::vector<uint8_t> arena;
  uint64_t mask = 0;

  DedupShard() {
    slots.assign(1 << 12, 0);
    mask = slots.size() - 1;
  }

  void grow() {
    std::vector<int64_t> ns(slots.size() * 2, 0);
    uint64_t nm = ns.size() - 1;
    for (size_t i = 0; i < entries.size(); i++) {
      uint64_t pos = entries[i].hash & nm;
      while (ns[pos]) pos = (pos + 1) & nm;
      ns[pos] = (int64_t)i + 1;
    }
    slots.swap(ns);
    mask = nm;
  }

  void insert(const uint8_t* key, int32_t len, int64_t cnt, int64_t first,
              uint64_t h) {
    uint64_t pos = h & mask;
    for (;;) {
      int64_t s = slots[pos];
      if (s == 0) {
        if (entries.size() * 10 >= slots.size() * 7) {
          grow();
          insert(key, len, cnt, first, h);
          return;
        }
        DedupEntry e;
        e.hash = h;
        e.key_off = (int64_t)arena.size();
        e.key_len = len;
        e.count = cnt;
        e.first = first;
        arena.insert(arena.end(), key, key + len);
        entries.push_back(e);
        slots[pos] = (int64_t)entries.size();
        return;
      }
      DedupEntry& e = entries[(size_t)s - 1];
      if (e.hash == h && e.key_len == len &&
          memcmp(arena.data() + e.key_off, key, (size_t)len) == 0) {
        e.count += cnt;
        if (first < e.first) e.first = first;
        return;
      }
      pos = (pos + 1) & mask;
    }
  }
};

struct FxDedup {
  std::vector<DedupShard> shards;
  int shard_bits;
  explicit FxDedup(int nshards_log2) : shard_bits(nshards_log2) {
    shards.resize((size_t)1 << nshards_log2);
  }
};

}  // namespace

extern "C" {

void* fx_dedup_new(int nshards_log2) {
  if (nshards_log2 < 0) nshards_log2 = 0;
  if (nshards_log2 > 6) nshards_log2 = 6;
  return new FxDedup(nshards_log2);
}

void fx_dedup_free(void* p) { delete (FxDedup*)p; }

// Insert a chunk: row i's key is bases[i, :lens[i]] (raw bytes), its
// multiplicity counts[i] (NULL => 1), its first-appearance index
// first_base + i.  Hashes are precomputed in parallel ranges; then one
// thread per shard group performs the inserts lock-free.
void fx_dedup_insert(void* p, const uint8_t* bases, int64_t n, int64_t width,
                     const int32_t* lens, const int32_t* counts,
                     int64_t first_base, int nthreads) {
  FxDedup* d = (FxDedup*)p;
  int nshards = (int)d->shards.size();
  std::vector<uint64_t> hashes((size_t)n);
  int nt = pick_threads(n, nthreads);
  parallel_ranges(n, nt, [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++)
      hashes[(size_t)i] = hash_bytes(bases + i * width, (size_t)lens[i]);
  });
  int insert_threads = nt < nshards ? nt : nshards;
  std::vector<std::thread> ts;
  for (int t = 0; t < insert_threads; t++) {
    ts.emplace_back([&, t] {
      for (int64_t i = 0; i < n; i++) {
        uint64_t h = hashes[(size_t)i];
        int shard = (int)(h >> (64 - 6)) & (nshards - 1);
        if (shard % insert_threads != t) continue;
        d->shards[(size_t)shard].insert(bases + i * width, lens[i],
                                        counts ? (int64_t)counts[i] : 1,
                                        first_base + i, h);
      }
    });
  }
  for (auto& th : ts) th.join();
}

int64_t fx_dedup_count(void* p) {
  FxDedup* d = (FxDedup*)p;
  int64_t total = 0;
  for (auto& s : d->shards) total += (int64_t)s.entries.size();
  return total;
}

int64_t fx_dedup_key_bytes(void* p) {
  FxDedup* d = (FxDedup*)p;
  int64_t total = 0;
  for (auto& s : d->shards) total += (int64_t)s.arena.size();
  return total;
}

// Extract all entries (shard-major, insert order within a shard; the
// caller orders by count/first).  key_offs has room for count+1 entries.
void fx_dedup_extract(void* p, int64_t* key_offs, int32_t* key_lens,
                      int64_t* counts, int64_t* firsts, uint8_t* keys_out) {
  FxDedup* d = (FxDedup*)p;
  int64_t k = 0;
  int64_t off = 0;
  key_offs[0] = 0;
  for (auto& s : d->shards) {
    for (auto& e : s.entries) {
      memcpy(keys_out + off, s.arena.data() + e.key_off, (size_t)e.key_len);
      off += e.key_len;
      key_offs[k + 1] = off;
      key_lens[k] = e.key_len;
      counts[k] = e.count;
      firsts[k] = e.first;
      k++;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused raw-line fast paths: operate straight on the chunk byte buffer
// via (start, len) line spans, skipping the padded-matrix build entirely.
// Used by the stats/collapser host engines; any validation failure makes
// the caller re-parse the chunk with the full codec for the reference's
// exact error text (fastx.c:314-404 semantics).
// ---------------------------------------------------------------------------

extern "C" {

// Validate framed FASTQ/FASTA records from raw line spans: sequence
// non-empty + every byte allowed[]; with qual_starts != NULL also every
// quality byte in [qmin_byte, qmax_byte] (ASCII quals of the same
// length, callers verified the framing).  Returns the first bad record
// index, or -1.
int64_t fx_validate_records(const uint8_t* buf, const int64_t* seq_starts,
                            const int64_t* lens, const int64_t* qual_starts,
                            int64_t n, const uint8_t* allowed, int qmin_byte,
                            int qmax_byte, int nthreads) {
  int nt = pick_threads(n, nthreads);
  std::vector<int64_t> bads((size_t)nt, -1);
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t s = t * chunk, e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    auto body = [&, t, s, e] {
      for (int64_t i = s; i < e; i++) {
        int64_t len = lens[i];
        if (len == 0) { bads[(size_t)t] = i; return; }
        const uint8_t* p = buf + seq_starts[i];
        for (int64_t j = 0; j < len; j++)
          if (!allowed[p[j]]) { bads[(size_t)t] = i; return; }
        if (qual_starts) {
          const uint8_t* q = buf + qual_starts[i];
          for (int64_t j = 0; j < len; j++)
            if ((int)q[j] < qmin_byte || (int)q[j] > qmax_byte) {
              bads[(size_t)t] = i;
              return;
            }
        }
      }
    };
    if (nt > 1) ts.emplace_back(body); else body();
  }
  for (auto& th : ts) th.join();
  int64_t first = -1;
  for (int t = 0; t < nt; t++)
    if (bads[(size_t)t] >= 0 && (first < 0 || bads[(size_t)t] < first))
      first = bads[(size_t)t];
  return first;
}

// FASTQ stats histogram from raw line spans (validated records):
// pernuc[j, nuc, qbyte - (q_offset - 15)] += 1 per base.
void fx_stats_lines_q(const uint8_t* buf, const int64_t* seq_starts,
                      const int64_t* qual_starts, const int64_t* lens,
                      int64_t n, int64_t width, int q_offset,
                      int64_t* pernuc, int nthreads) {
  const int64_t stride = 6 * 109;
  const int64_t total = width * stride;
  const int bias = q_offset - 15;
  int nt = pick_threads(n, nthreads);
  std::vector<std::vector<int64_t>> priv((size_t)nt);
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t s = t * chunk, e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    auto body = [&, t, s, e] {
      int64_t* acc;
      if (nt > 1) {
        priv[(size_t)t].assign((size_t)total, 0);
        acc = priv[(size_t)t].data();
      } else {
        acc = pernuc;
      }
      for (int64_t i = s; i < e; i++) {
        const uint8_t* b = buf + seq_starts[i];
        const uint8_t* q = buf + qual_starts[i];
        int64_t len = lens[i];
        for (int64_t j = 0; j < len; j++) {
          int nuc = kStatsIdx.idx[b[j]];
          int bin = (int)q[j] - bias;
          if (bin < 0) bin = 0; else if (bin > 108) bin = 108;
          acc[j * stride + nuc * 109 + bin]++;
        }
      }
    };
    if (nt > 1) ts.emplace_back(body); else body();
  }
  for (auto& th : ts) th.join();
  if (nt > 1)
    for (auto& p : priv) {
      if (p.empty()) continue;
      const int64_t* src = p.data();
      for (int64_t k = 0; k < total; k++) pernuc[k] += src[k];
    }
}

// Dedup insert from raw line spans (validated records); counts NULL
// means multiplicity 1 (FASTQ), else the per-record collapsed counts
// parsed from FASTA ids (fx_counts_from_names).
void fx_dedup_insert_lines(void* p, const uint8_t* buf,
                           const int64_t* seq_starts, const int64_t* lens,
                           const int32_t* counts,
                           int64_t n, int64_t first_base, int nthreads) {
  FxDedup* d = (FxDedup*)p;
  int nshards = (int)d->shards.size();
  std::vector<uint64_t> hashes((size_t)n);
  int nt = pick_threads(n, nthreads);
  parallel_ranges(n, nt, [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++)
      hashes[(size_t)i] = hash_bytes(buf + seq_starts[i], (size_t)lens[i]);
  });
  int insert_threads = nt < nshards ? nt : nshards;
  std::vector<std::thread> ts;
  for (int t = 0; t < insert_threads; t++) {
    auto body = [&, t] {
      for (int64_t i = 0; i < n; i++) {
        uint64_t h = hashes[(size_t)i];
        int shard = (int)(h >> (64 - 6)) & (nshards - 1);
        if (shard % insert_threads != t) continue;
        d->shards[(size_t)shard].insert(buf + seq_starts[i],
                                        (int32_t)lens[i],
                                        counts ? (int64_t)counts[i] : 1,
                                        first_base + i, h);
      }
    };
    if (insert_threads > 1) ts.emplace_back(body); else body();
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Raw-line fast paths for the full preprocessing pipeline: pack the
// device upload and render the final FASTA/FASTQ bytes straight from the
// chunk buffer via line spans — no padded matrices, no quality
// conversion (ASCII qualities compare against byte cutoffs, memcpy back
// out verbatim).  Used by the headline bench loop and the pipeline CLI.
// ---------------------------------------------------------------------------

extern "C" {

// Alphabet scan over line spans: bit0 = every sequence byte is A/C/G/T/N,
// bit1 = any 'N'.
int32_t fx_scan_lines(const uint8_t* buf, const int64_t* seq_starts,
                      const int64_t* lens, int64_t n) {
  static const AcgtnTable kTab(false);
  const bool* is_acgtn = kTab.t;
  bool pure = true, has_n = false;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* p = buf + seq_starts[i];
    int64_t len = lens[i];
    for (int64_t j = 0; j < len; j++) {
      uint8_t b = p[j];
      pure &= is_acgtn[b];
      has_n |= (b == 'N');
    }
  }
  return (pure ? 1 : 0) | (has_n ? 2 : 0);
}

// 2-bit pack from line spans (pure-ACGTN records): layout identical to
// fx_pack2 over a padded [n, L] matrix whose rows are the spans
// zero-padded to L.  Quality planes compare the raw ASCII byte against
// thr_byte[t] (= numeric threshold + q_offset); padding bits are 0.
// b2/planes point at the destination rows (callers offset for chunk
// assembly).
void fx_pack2_lines(const uint8_t* buf, const int64_t* seq_starts,
                    const int64_t* qual_starts, const int64_t* lens,
                    int64_t n, int64_t L, const int32_t* thr_byte,
                    int n_thr, int include_nplane, uint8_t* b2,
                    uint8_t* planes, int nthreads) {
  static const Code2Table kCode2;
  const uint8_t* code2 = kCode2.t;
  const int64_t w2 = (L + 3) / 4;
  const int64_t w8 = (L + 7) / 8;
  const int64_t n_planes = n_thr + (include_nplane ? 1 : 0);
  parallel_ranges(n, pick_threads(n, nthreads), [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++) {
      const uint8_t* brow = buf + seq_starts[i];
      const uint8_t* qrow = buf + qual_starts[i];
      int64_t len = lens[i];
      uint8_t* orow = b2 + i * w2;
      for (int64_t j4 = 0; j4 < w2; j4++) {
        uint8_t v = 0;
        int64_t j = j4 * 4;
        int64_t lim = j + 4 <= len ? 4 : (j < len ? len - j : 0);
        for (int64_t k = 0; k < lim; k++) v |= code2[brow[j + k]] << (6 - 2 * k);
        orow[j4] = v;
      }
      uint8_t* prow = planes + i * n_planes * w8;
      int p = 0;
      if (include_nplane) {
        for (int64_t j8 = 0; j8 < w8; j8++) {
          uint8_t v = 0;
          int64_t j = j8 * 8;
          int64_t lim = j + 8 <= len ? 8 : (j < len ? len - j : 0);
          for (int64_t k = 0; k < lim; k++) v |= (brow[j + k] == 'N') << (7 - k);
          prow[j8] = v;
        }
        p = 1;
      }
      for (int t = 0; t < n_thr; t++, p++) {
        int32_t tb = thr_byte[t];
        uint8_t* pr = prow + p * w8;
        for (int64_t j8 = 0; j8 < w8; j8++) {
          uint8_t v = 0;
          int64_t j = j8 * 8;
          int64_t lim = j + 8 <= len ? 8 : (j < len ? len - j : 0);
          for (int64_t k = 0; k < lim; k++) v |= ((int32_t)qrow[j + k] < tb) << (7 - k);
          pr[j8] = v;
        }
      }
    }
  });
}

// Render FASTQ straight from line spans + device decisions.  Per kept
// record: '@' name '\n' seq[:new_len] (masked) '\n' '+' name2 '\n'
// qual[:new_len] '\n'; qualities are the original ASCII bytes, masking
// compares them against mask_thr_byte (numeric threshold + offset).
// rec_offs are precomputed output offsets (0-sized for dropped rows).
void fx_render_fastq_lines(const uint8_t* buf, const int64_t* name_starts,
                           const int64_t* name_lens,
                           const int64_t* seq_starts,
                           const int64_t* qual_starts,
                           const int64_t* name2_starts,
                           const int64_t* name2_lens,
                           const int32_t* new_lens, int64_t n,
                           const int64_t* rec_offs, uint8_t* out,
                           const uint8_t* keep, int mask_enable,
                           int mask_thr_byte, uint8_t mask_char,
                           int nthreads) {
  parallel_ranges(n, pick_threads(n, nthreads), [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++) {
      if (keep && !keep[i]) continue;
      uint8_t* p = out + rec_offs[i];
      int64_t len = new_lens[i];
      *p++ = '@';
      memcpy(p, buf + name_starts[i], (size_t)name_lens[i]);
      p += name_lens[i];
      *p++ = '\n';
      const uint8_t* sq = buf + seq_starts[i];
      const uint8_t* ql = buf + qual_starts[i];
      if (mask_enable) {
        for (int64_t j = 0; j < len; j++)
          p[j] = (int32_t)ql[j] < mask_thr_byte ? mask_char : sq[j];
      } else {
        memcpy(p, sq, (size_t)len);
      }
      p += len;
      *p++ = '\n';
      *p++ = '+';
      memcpy(p, buf + name2_starts[i], (size_t)name2_lens[i]);
      p += name2_lens[i];
      *p++ = '\n';
      memcpy(p, ql, (size_t)len);
      p += len;
      *p++ = '\n';
    }
  });
}

// FASTA variant: '>' name '\n' seq[:new_len] (masked) '\n'.
void fx_render_fasta_lines(const uint8_t* buf, const int64_t* name_starts,
                           const int64_t* name_lens,
                           const int64_t* seq_starts,
                           const int64_t* qual_starts,
                           const int32_t* new_lens, int64_t n,
                           const int64_t* rec_offs, uint8_t* out,
                           const uint8_t* keep, int mask_enable,
                           int mask_thr_byte, uint8_t mask_char,
                           int nthreads) {
  parallel_ranges(n, pick_threads(n, nthreads), [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++) {
      if (keep && !keep[i]) continue;
      uint8_t* p = out + rec_offs[i];
      int64_t len = new_lens[i];
      *p++ = '>';
      memcpy(p, buf + name_starts[i], (size_t)name_lens[i]);
      p += name_lens[i];
      *p++ = '\n';
      const uint8_t* sq = buf + seq_starts[i];
      if (mask_enable) {
        const uint8_t* ql = buf + qual_starts[i];
        for (int64_t j = 0; j < len; j++)
          p[j] = (int32_t)ql[j] < mask_thr_byte ? mask_char : sq[j];
      } else {
        memcpy(p, sq, (size_t)len);
      }
      p += len;
      *p++ = '\n';
    }
  });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Per-record decision kernels over raw line spans: the quality-family
// filters (fastq_quality_filter / fastq_quality_trimmer / fastq_masker
// tallies), N detection (fastq_to_fasta) and the artifacts rule — the
// tool CLIs' raw-line fast paths call these instead of building padded
// matrices and converting qualities.
// ---------------------------------------------------------------------------

extern "C" {

// Quality decisions from ASCII quality lines.  Cutoffs are in BYTE
// space (numeric threshold + offset).  Per record:
//  * do_filter: keep iff |{q < f_cut}| <= len*(100-p)/100 (the
//    reference's percentile-by-counting-sort reformulated as an order
//    statistic, fastq_quality_filter.c:78-129)
//  * do_trim: truncate the 3' run of q < t_cut; keep iff the result is
//    non-empty and >= trim_minlen (fastq_quality_trimmer.c:93-102)
//  * masked != NULL: masked[i] = |{q < m_cut}| within the (possibly
//    trimmed) length (fastq_masker tallies)
void fx_quality_decide(const uint8_t* buf, const int64_t* qual_starts,
                       const int64_t* lens, int64_t n, int do_filter,
                       int f_cut_byte, int f_percent, int do_trim,
                       int t_cut_byte, int64_t trim_minlen, int m_cut_byte,
                       int32_t* new_lens, uint8_t* keep, int64_t* masked,
                       int nthreads) {
  parallel_ranges(n, pick_threads(n, nthreads), [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++) {
      const uint8_t* q = buf + qual_starts[i];
      int64_t len = lens[i];
      bool k = true;
      if (do_filter) {
        int64_t below = 0;
        for (int64_t j = 0; j < len; j++) below += (int32_t)q[j] < f_cut_byte;
        k &= below <= len * (100 - f_percent) / 100;
      }
      int64_t nl = len;
      if (do_trim) {
        while (nl > 0 && (int32_t)q[nl - 1] < t_cut_byte) nl--;
        k &= nl > 0 && nl >= trim_minlen;
      }
      if (masked) {
        int64_t m = 0;
        for (int64_t j = 0; j < nl; j++) m += (int32_t)q[j] < m_cut_byte;
        masked[i] = m;
      }
      new_lens[i] = (int32_t)nl;
      keep[i] = k ? 1 : 0;
    }
  });
}

// Per-record 'N' presence (fastq_to_fasta.c:81-82 strchr semantics:
// uppercase N only, matching ops/transforms.contains_n).
void fx_rows_with_n(const uint8_t* buf, const int64_t* seq_starts,
                    const int64_t* lens, int64_t n, uint8_t* has_n,
                    int nthreads) {
  parallel_ranges(n, pick_threads(n, nthreads), [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++) {
      const uint8_t* p = buf + seq_starts[i];
      int64_t len = lens[i];
      uint8_t h = 0;
      for (int64_t j = 0; j < len; j++) h |= (p[j] == 'N');
      has_n[i] = h;
    }
  });
}

// Artifacts rule (fastx_artifacts_filter.c:56-112): discard iff any
// single A/C/G/T letter covers all but <= 3 positions.
void fx_artifacts_rows(const uint8_t* buf, const int64_t* seq_starts,
                       const int64_t* lens, int64_t n, uint8_t* keep,
                       int nthreads) {
  parallel_ranges(n, pick_threads(n, nthreads), [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++) {
      const uint8_t* p = buf + seq_starts[i];
      int64_t len = lens[i];
      int64_t a = 0, c = 0, g = 0, t = 0;
      for (int64_t j = 0; j < len; j++) {
        uint8_t b = p[j];
        a += b == 'A';
        c += b == 'C';
        g += b == 'G';
        t += b == 'T';
      }
      int64_t worst = a > c ? a : c;
      if (g > worst) worst = g;
      if (t > worst) worst = t;
      keep[i] = worst >= len - 3 ? 0 : 1;
    }
  });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Collapsed-read multiplicity from FASTA id spans: the reference takes
// atoi() of everything after the first '-' in the id and uses it when
// > 0, else 1 (get_reads_count, FASTX-Toolkit src/libfastx/
// fastx.c:475-495).  Mirrors core/codec.py parse_counts_from_names
// exactly (incl. the int32 clamp).
// ---------------------------------------------------------------------------

extern "C" {

void fx_counts_from_names(const uint8_t* buf, const int64_t* name_starts,
                          const int64_t* name_lens, int64_t n,
                          int32_t* out, int nthreads) {
  parallel_ranges(n, pick_threads(n, nthreads), [&](int64_t s, int64_t e) {
    for (int64_t i = s; i < e; i++) {
      out[i] = 1;
      const uint8_t* p = buf + name_starts[i];
      int64_t len = name_lens[i];
      int64_t d = 0;
      while (d < len && p[d] != '-') d++;
      if (d >= len) continue;
      // atoi semantics: skip whitespace, optional single '+', then an
      // optionally-'-'-signed digit run (codec._ATOI_RE)
      int64_t j = d + 1;
      while (j < len && (p[j] == ' ' || p[j] == '\t' || p[j] == '\n' ||
                         p[j] == '\v' || p[j] == '\f' || p[j] == '\r'))
        j++;
      if (j < len && p[j] == '+') j++;
      bool neg = false;
      if (j < len && p[j] == '-') { neg = true; j++; }
      if (j >= len || p[j] < '0' || p[j] > '9') continue;
      int64_t v = 0;
      while (j < len && p[j] >= '0' && p[j] <= '9') {
        v = v * 10 + (p[j] - '0');
        if (v > 2147483647) v = 2147483647;  // int32 clamp like the codec
        j++;
      }
      if (neg) v = -v;
      if (v > 0) out[i] = (int32_t)v;
    }
  });
}

}  // extern "C"

extern "C" {

// Float32 half-local clipper DP for tie-fragile subsets: a faithful
// transcription of the reference engine's float arithmetic and fill
// order (FASTX-Toolkit src/libfastx/sequence_alignment.cpp — gap -5,
// match +1, mismatch -1, neutral +0.1, target border (y<=3)?0:gap*(y-3),
// from-left ban when y-3 > x, priority UPPER_LEFT > UPPER > LEFT, global
// max tracked cell-by-cell with strict >).  Path statistics are carried
// forward per cell — the forward decisions are exactly the traceback the
// C would walk.  All score ops are float additions (no multiply-add
// pairs), so -ffp-contract cannot perturb them.
// out: [n, 8] int32 = m, mm, g, nm, qs, qe, ts, te per read.
void fx_clip_float(const uint8_t* bases, const int32_t* dp_lens,
                   int64_t n, int64_t W, const uint8_t* adapter, int64_t H,
                   int32_t* out, int nthreads) {
  nthreads = pick_threads(n * H, nthreads);
  parallel_ranges(n, nthreads, [&](int64_t s, int64_t e) {
    std::vector<float> psc(H), cur(H);
    // forward stats per row of the previous / current column
    struct St { int32_t m, mm, g, nm, qs, ts; };
    std::vector<St> pst(H), cst(H);
    std::vector<float> tb(H);
    for (int64_t y = 0; y < H; y++)
      tb[y] = y <= 3 ? 0.0f : -5.0f * (float)(y - 3);
    const float gap = -5.0f;
    for (int64_t i = s; i < e; i++) {
      const uint8_t* q = bases + i * W;
      int64_t L = dp_lens[i];
      float best = -1000000.0f;
      St bst{0, 0, 0, 0, 0, 0};
      int32_t bx = 0, by = 0;
      for (int64_t x = 0; x < L; x++) {
        float up_sc = 0.0f;  // query border above row 0
        for (int64_t y = 0; y < H; y++) {
          uint8_t qc = q[x], tc = adapter[y];
          bool qn = qc == 'N', tn = tc == 'N';
          float delta = (qn && tn) ? 0.0f
                        : (qn || tn) ? 0.1f
                        : (qc == tc) ? 1.0f : -1.0f;
          float ul_src = (x == 0) ? (y > 0 ? tb[y - 1] : 0.0f)
                                  : (y > 0 ? psc[y - 1] : 0.0f);
          float upleft = ul_src + delta;
          float left = ((x == 0) ? tb[y] : psc[y]) + gap;
          if (y > 3 && y - 3 > x) left = -100000.0f;
          float up = up_sc + gap;
          // priority: UL first, then UP, then LEFT (strict >)
          float sc = -100000000.0f;
          int o = 2;  // LEFT
          if (upleft > sc) { sc = upleft; o = 0; }
          if (up > sc) { sc = up; o = 1; }
          if (left > sc) { sc = left; o = 2; }
          St st;
          if (o == 0) {
            bool fresh = (x == 0) || (y == 0);
            St src = fresh ? St{0, 0, 0, 0, (int32_t)x, (int32_t)y}
                           : pst[y - 1];
            st = src;
            if (qn || tn) st.nm++;
            else if (qc == tc) st.m++;
            else st.mm++;
          } else if (o == 1) {
            st = (y == 0) ? St{0, 0, 0, 0, (int32_t)x, 0} : cst[y - 1];
            st.g++;
          } else {
            st = (x == 0) ? St{0, 0, 0, 0, (int32_t)x, (int32_t)y} : pst[y];
            st.g++;
          }
          cur[y] = sc;
          cst[y] = st;
          if (sc > best) {
            best = sc;
            bst = st;
            bx = (int32_t)x;
            by = (int32_t)y;
          }
          up_sc = sc;
        }
        std::swap(psc, cur);
        std::swap(pst, cst);
      }
      int32_t* o8 = out + i * 8;
      o8[0] = bst.m; o8[1] = bst.mm; o8[2] = bst.g; o8[3] = bst.nm;
      o8[4] = bst.qs; o8[5] = bx; o8[6] = bst.ts; o8[7] = by;
    }
  });
}

}  // extern "C"
