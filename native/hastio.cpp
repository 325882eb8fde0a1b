// hastio — native host IO for the hast_jax framework.
//
// The native analog of the reference's C++ runtime layer
// (gzstream + producer/consumer threads in
// /root/reference/01.classify_stlfr_reads/classify.cpp:129-278): a
// pipelined fastq/fasta reader that decodes (optionally gzip'd)
// records, packs sequences into fixed-shape zero-padded uint8 batches,
// flags N-containing reads, and dictionary-encodes stLFR barcodes to
// dense int ids — everything the device pipeline needs, produced off
// the Python GIL.
//
// Pipeline: an IO thread streams the file (and inflates gzip) into
// raw byte chunks; a parse thread scans records IN PLACE (no per-line
// string copies), 2-bit packs sequences, and resolves barcodes through
// an open-addressing dictionary with an integer fast path for the
// canonical `a_b_c` stLFR barcode shape; finished batches flow through
// a small bounded queue to the Python consumer.  On a 222 MB fastq
// this parses ~4M reads/s vs ~0.27M for the previous
// string-based single-thread design (the barcode dictionary was 47%
// of that wall time; std::string churn most of the rest).
//
// C ABI (ctypes-friendly), see hast_jax/io/native.py for the wrapper.

#include <algorithm>
#include <array>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>
#include <stdio.h>

namespace {

constexpr size_t kChunk = 4u << 20;   // raw bytes per IO chunk
constexpr int kChunkQueueDepth = 4;
constexpr int kBatchQueueDepth = 3;

// ---------------------------------------------------------------------------
// byte source: plain or gzip file -> fixed-size raw chunks
// ---------------------------------------------------------------------------

class ByteSource {
 public:
  explicit ByteSource(const std::string& path) {
    gz_ = path.size() > 3 && path.compare(path.size() - 3, 3, ".gz") == 0;
    if (gz_) {
      gzf_ = gzopen(path.c_str(), "rb");
      ok_ = gzf_ != nullptr;
      if (ok_) gzbuffer(gzf_, 1 << 20);
    } else {
      f_ = fopen(path.c_str(), "rb");
      ok_ = f_ != nullptr;
    }
  }
  ~ByteSource() {
    if (gz_ && gzf_) gzclose(gzf_);
    if (!gz_ && f_) fclose(f_);
  }
  bool ok() const { return ok_; }
  size_t read(char* dst, size_t n) {
    if (gz_) {
      int got = gzread(gzf_, dst, static_cast<unsigned>(n));
      return got > 0 ? static_cast<size_t>(got) : 0;
    }
    return fread(dst, 1, n, f_);
  }

 private:
  bool gz_ = false, ok_ = false;
  gzFile gzf_ = nullptr;
  FILE* f_ = nullptr;
};

struct Chunk {
  std::vector<char> data;
  size_t len = 0;
};

// bounded chunk queue (single producer / single consumer)
struct ChunkQueue {
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<Chunk> q;
  bool eof = false, stop = false;

  void push(Chunk&& c) {
    std::unique_lock<std::mutex> lk(mu);
    cv_push.wait(lk, [&] { return (int)q.size() < kChunkQueueDepth || stop; });
    if (stop) return;
    q.push_back(std::move(c));
    cv_pop.notify_one();
  }
  void finish() {
    std::unique_lock<std::mutex> lk(mu);
    eof = true;
    cv_pop.notify_all();
  }
  bool pop(Chunk* out) {
    std::unique_lock<std::mutex> lk(mu);
    cv_pop.wait(lk, [&] { return !q.empty() || eof || stop; });
    if (stop || q.empty()) return false;
    *out = std::move(q.front());
    q.pop_front();
    cv_push.notify_one();
    return true;
  }
  void shutdown() {
    std::unique_lock<std::mutex> lk(mu);
    stop = true;
    cv_push.notify_all();
    cv_pop.notify_all();
  }
};

// ---------------------------------------------------------------------------
// barcode dictionary: open addressing, insertion-order dense ids.
//
// stLFR barcodes are almost always `a_b_c` digit triples
// (classify.cpp:112-119 extracts the text between the last '#' and
// last '/'); those pack into a 63-bit integer key and resolve through
// a flat (key, id) table — one cache line per lookup, no string
// allocation.  Anything else (lib-marked barcodes, degenerate heads)
// goes through a byte-arena table keyed by a 64-bit hash.
// ---------------------------------------------------------------------------

struct BarcodeDict {
  // integer path: slot = {key+1 (0 = empty), id}
  struct IntSlot { uint64_t key1; uint32_t id; uint32_t pad; };
  std::vector<IntSlot> islots;
  size_t icount = 0;

  // generic path: slot = {hash (0 = empty -> remapped to 1), id}
  struct StrSlot { uint64_t hash; uint32_t id; uint32_t pad; };
  std::vector<StrSlot> sslots;
  size_t scount = 0;

  // id -> barcode bytes (insertion order), shared by both paths
  std::vector<char> arena;
  std::vector<uint32_t> offs;  // offs[id], length = offs[id+1]-offs[id]
  // per-entry stored hash for generic rehash (0 for int-path entries)
  std::vector<uint64_t> entry_hash;

  BarcodeDict() {
    islots.resize(1u << 16);
    sslots.resize(1u << 10);
    offs.push_back(0);
  }

  size_t size() const { return offs.size() - 1; }

  uint32_t new_entry(const char* s, size_t n, uint64_t h) {
    arena.insert(arena.end(), s, s + n);
    offs.push_back(static_cast<uint32_t>(arena.size()));
    entry_hash.push_back(h);
    return static_cast<uint32_t>(offs.size() - 2);
  }

  // 63-bit pack of `a_b_c` (each < 2^20, no leading-zero ambiguity:
  // the textual form is preserved in the arena; the key only needs to
  // be injective, and digit strings with values < 2^20 and length
  // <= 7 are — leading zeros change the value? no. "01_2_3" and
  // "1_2_3" would collide, so leading zeros force the generic path.
  static bool int_key(const char* s, size_t n, uint64_t* out) {
    uint64_t key = 0;
    int field = 0;
    size_t i = 0;
    while (i < n && field < 3) {
      if (s[i] == '0' && i + 1 < n && s[i + 1] >= '0' && s[i + 1] <= '9')
        return false;  // leading zero: textual form not canonical
      uint64_t v = 0;
      size_t start = i;
      while (i < n && s[i] >= '0' && s[i] <= '9') {
        v = v * 10 + (s[i] - '0');
        if (v >= (1u << 20)) return false;
        i++;
      }
      if (i == start) return false;  // empty field
      key |= v << (20 * field);
      field++;
      if (i < n) {
        if (s[i] != '_' || field == 3) return false;
        i++;
        if (i == n) return false;  // trailing '_'
      }
    }
    if (i != n || field == 0) return false;
    *out = key | (uint64_t)field << 60;  // distinguish "1" / "1_0" shapes
    return true;
  }

  static uint64_t hash_bytes(const char* s, size_t n) {
    uint64_t h = 1469598103934665603ull;
    for (size_t i = 0; i < n; i++) {
      h ^= static_cast<unsigned char>(s[i]);
      h *= 1099511628211ull;
    }
    h ^= h >> 32;
    h *= 0xd6e8feb86659fd93ull;
    h ^= h >> 32;
    return h ? h : 1;
  }

  static uint64_t hash_u64(uint64_t x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdull;
    x ^= x >> 33;
    return x;
  }

  void grow_int() {
    std::vector<IntSlot> ns(islots.size() * 2);
    size_t mask = ns.size() - 1;
    for (const IntSlot& sl : islots) {
      if (!sl.key1) continue;
      size_t b = hash_u64(sl.key1 - 1) & mask;
      while (ns[b].key1) b = (b + 1) & mask;
      ns[b] = sl;
    }
    islots.swap(ns);
  }

  void grow_str() {
    std::vector<StrSlot> ns(sslots.size() * 2);
    size_t mask = ns.size() - 1;
    for (const StrSlot& sl : sslots) {
      if (!sl.hash) continue;
      size_t b = sl.hash & mask;
      while (ns[b].hash) b = (b + 1) & mask;
      ns[b] = sl;
    }
    sslots.swap(ns);
  }

  int32_t lookup_or_insert(const char* s, size_t n) {
    uint64_t key;
    if (int_key(s, n, &key)) {
      uint64_t key1 = key + 1;
      size_t mask = islots.size() - 1;
      size_t b = hash_u64(key) & mask;
      while (true) {
        IntSlot& sl = islots[b];
        if (sl.key1 == key1) return static_cast<int32_t>(sl.id);
        if (!sl.key1) {
          uint32_t id = new_entry(s, n, 0);
          sl.key1 = key1;
          sl.id = id;
          if (++icount * 2 > islots.size()) grow_int();  // invalidates sl
          return static_cast<int32_t>(id);
        }
        b = (b + 1) & mask;
      }
    }
    uint64_t h = hash_bytes(s, n);
    size_t mask = sslots.size() - 1;
    size_t b = h & mask;
    while (true) {
      StrSlot& sl = sslots[b];
      if (sl.hash == h) {
        uint32_t off = offs[sl.id], len = offs[sl.id + 1] - off;
        if (len == n && memcmp(arena.data() + off, s, n) == 0)
          return static_cast<int32_t>(sl.id);
      } else if (!sl.hash) {
        uint32_t id = new_entry(s, n, h);
        sl.hash = h;
        sl.id = id;
        if (++scount * 2 > sslots.size()) grow_str();  // invalidates sl
        return static_cast<int32_t>(id);
      }
      b = (b + 1) & mask;
    }
  }
};

// ---------------------------------------------------------------------------
// batch assembly
// ---------------------------------------------------------------------------

struct Batch {
  std::vector<uint8_t> seqs;    // n_rows * stride, zero padded
  std::vector<uint8_t> good;    // ACGT-validity bitmask (counting mode)
  std::vector<int32_t> lengths;
  std::vector<uint8_t> has_n;
  std::vector<int32_t> barcode_ids;
  int n = 0;
  int max_len = 0;  // padded row stride in BASES (multiple of 16)
};

// ACGT/acgt validity per byte (jellyfish window rule); bit j of good
// byte m covers base m*8+j, matching ops/kmer_count.pack_good_np
static const std::array<uint8_t, 256> kAcgt = [] {
  std::array<uint8_t, 256> t{};
  for (unsigned char c : {'A', 'C', 'G', 'T', 'a', 'c', 'g', 't'})
    t[c] = 1;
  return t;
}();

inline void good_row(const char* s, int L, uint8_t* row) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(s);
  for (int j = 0; j < L; j++)
    if (kAcgt[p[j]]) row[j >> 3] |= static_cast<uint8_t>(1u << (j & 7));
}

inline int round128(int x) { return ((x + 127) / 128) * 128; }
// batch row strides round to 16 bases (4 packed bytes): finer than 128
// keeps the device from probing pad windows (100 bp reads: 92 windows
// instead of 108, ~15% of the gather-bound probe kernel), while coarse
// enough that mixed-length inputs produce few distinct compile shapes
inline int round16(int x) { return ((x + 15) / 16) * 16; }

// 2-bit pack: the reference encoding (c>>1)&3 on every byte
// (kmer/kmer.h:11-12), matching ops/encode.pack_codes_np bit-for-bit.
inline void pack_row(const char* s, int L, uint8_t* row) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(s);
  int j = 0;
  for (; j + 4 <= L; j += 4) {
    row[j >> 2] = static_cast<uint8_t>(
        ((p[j] >> 1) & 3) | (((p[j + 1] >> 1) & 3) << 2) |
        (((p[j + 2] >> 1) & 3) << 4) | (((p[j + 3] >> 1) & 3) << 6));
  }
  uint8_t last = 0;
  for (; j < L; j++)
    last |= static_cast<uint8_t>(((p[j] >> 1) & 3) << ((j & 3) * 2));
  if (L & 3) row[L >> 2] = last;
}

struct Reader {
  std::string path;
  int batch_size;
  int len_cap;        // max bases kept per read
  int cap_stride;     // round128(len_cap): staging row stride in bases
  bool fastq;
  bool packed = false;
  bool emit_good = false;  // counting mode: per-base ACGT bitmask rows

  BarcodeDict dict;
  std::atomic<long> truncated{0};
  std::atomic<long> bad_fasta{0};  // multi-line fasta detected

  // staging buffers for the batch under construction (parse thread)
  Batch cur;
  int cur_rows = 0;
  int cur_maxlen = 1;

  // pipeline
  ChunkQueue chunks;
  std::thread io_thread, parse_thread;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::deque<Batch> ready;
  bool eof = false, stop = false;
  bool open_ok = false;

  Reader(const std::string& p, int bs, int cap, bool fq)
      : path(p), batch_size(bs), len_cap(cap),
        cap_stride(round128(cap)), fastq(fq) {}

  void start() {
    io_thread = std::thread([this] { io_main(); });
    parse_thread = std::thread([this] { parse_main(); });
  }

  void io_main() {
    ByteSource src(path);
    while (true) {
      Chunk c;
      c.data.resize(kChunk);
      c.len = src.read(c.data.data(), kChunk);
      if (c.len == 0) break;
      chunks.push(std::move(c));
      std::unique_lock<std::mutex> lk(mu);
      if (stop) break;
    }
    chunks.finish();
  }

  void begin_batch() {
    const size_t stride = packed ? cap_stride / 4 : cap_stride;
    cur.seqs.assign(static_cast<size_t>(batch_size) * stride, 0);
    if (emit_good)
      cur.good.assign(static_cast<size_t>(batch_size) * (cap_stride / 8), 0);
    cur.lengths.assign(batch_size, 0);
    cur.has_n.assign(batch_size, 0);
    cur.barcode_ids.assign(batch_size, 0);
    cur_rows = 0;
    cur_maxlen = 1;
  }

  // move the staged batch (stride cap_stride) into a compact batch
  // with stride round16(max seq len) and queue it for the consumer
  bool emit_batch() {
    if (cur_rows == 0) return true;
    int out_len = round16(std::min(cur_maxlen, len_cap));
    const size_t div = packed ? 4 : 1;
    const size_t in_stride = cap_stride / div;
    const size_t out_stride = out_len / div;
    Batch b;
    b.n = cur_rows;
    b.max_len = out_len;
    b.lengths = std::move(cur.lengths);
    b.has_n = std::move(cur.has_n);
    b.barcode_ids = std::move(cur.barcode_ids);
    if (out_stride == in_stride) {
      b.seqs = std::move(cur.seqs);
      if (emit_good) b.good = std::move(cur.good);
    } else {
      b.seqs.resize(static_cast<size_t>(batch_size) * out_stride);
      const uint8_t* src = cur.seqs.data();
      uint8_t* dst = b.seqs.data();
      for (int i = 0; i < cur_rows; i++)
        memcpy(dst + i * out_stride, src + i * in_stride, out_stride);
      memset(dst + static_cast<size_t>(cur_rows) * out_stride, 0,
             (batch_size - cur_rows) * out_stride);
      if (emit_good) {
        const size_t gi = cap_stride / 8, go = static_cast<size_t>(out_len) / 8;
        b.good.resize(static_cast<size_t>(batch_size) * go);
        const uint8_t* gsrc = cur.good.data();
        uint8_t* gdst = b.good.data();
        for (int i = 0; i < cur_rows; i++)
          memcpy(gdst + i * go, gsrc + i * gi, go);
        memset(gdst + static_cast<size_t>(cur_rows) * go, 0,
               (batch_size - cur_rows) * go);
      }
    }
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_empty.wait(lk, [&] {
        return (int)ready.size() < kBatchQueueDepth || stop;
      });
      if (stop) return false;
      ready.push_back(std::move(b));
      cv_full.notify_all();
    }
    begin_batch();
    return true;
  }

  // one record: head + seq lines (in place, no copies)
  bool add_record(const char* head, size_t hlen,
                  const char* seq, size_t slen) {
    int L = static_cast<int>(slen);
    if (L > len_cap) {
      L = len_cap;
      truncated.fetch_add(1, std::memory_order_relaxed);
    }
    if (static_cast<int>(slen) > cur_maxlen)
      cur_maxlen = static_cast<int>(slen);
    const int i = cur_rows;
    if (packed) {
      pack_row(seq, L, &cur.seqs[static_cast<size_t>(i) * (cap_stride / 4)]);
    } else {
      memcpy(&cur.seqs[static_cast<size_t>(i) * cap_stride], seq, L);
    }
    if (emit_good)
      good_row(seq, L, &cur.good[static_cast<size_t>(i) * (cap_stride / 8)]);
    cur.lengths[i] = L;
    cur.has_n[i] = memchr(seq, 'N', slen) != nullptr;
    if (emit_good) {
      // counting mode: barcodes are never consumed (jellyfish counts
      // sequence only) — skip the dict work entirely
      cur.barcode_ids[i] = 0;
    } else {
      // classify.cpp:112-119 parseName: between LAST '#' and LAST '/'
      int s = -1, e = -1;
      for (size_t j = 0; j < hlen; j++) {
        if (head[j] == '#') s = static_cast<int>(j);
        if (head[j] == '/') e = static_cast<int>(j);
      }
      const char* b = head + s + 1;
      size_t bl = (e > s) ? static_cast<size_t>(e - s - 1) : hlen - s - 1;
      cur.barcode_ids[i] = dict.lookup_or_insert(b, bl);
    }
    cur_rows++;
    if (cur_rows == batch_size) return emit_batch();
    return true;
  }

  void parse_main() {
    begin_batch();
    const int lines_per_rec = fastq ? 4 : 2;
    int line_idx = 0;            // within the current record
    std::vector<char> carry;     // partial line across chunk boundary
    std::vector<char> head_buf;  // pending head line (record spans lines)
    const char* head = nullptr;
    size_t hlen = 0;
    bool ok = true;

    auto handle_line = [&](const char* p, size_t n) -> bool {
      if (n && p[n - 1] == '\r') n--;  // getline strips \r
      if (line_idx == 0) {
        // multi-line fasta: a continuation line lands where a head is
        // expected; flag it so the caller falls back to the python
        // reader (this parser is strictly 2-line-per-record fasta)
        if (!fastq && n && p[0] != '>')
          bad_fasta.fetch_add(1, std::memory_order_relaxed);
        // stash the head: the seq line may arrive in another chunk,
        // invalidating this pointer — copy (heads are ~40 bytes)
        head_buf.assign(p, p + n);
        head = head_buf.data();
        hlen = n;
        line_idx = 1;
      } else if (line_idx == 1) {
        if (!add_record(head, hlen, p, n)) return false;
        line_idx = lines_per_rec == 2 ? 0 : 2;
      } else {
        line_idx = (line_idx + 1) % lines_per_rec;
      }
      return true;
    };

    Chunk c;
    while (ok && chunks.pop(&c)) {
      const char* p = c.data.data();
      const char* end = p + c.len;
      if (!carry.empty()) {
        // finish the line that straddles the boundary
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', end - p));
        if (!nl) {
          carry.insert(carry.end(), p, end);
          continue;
        }
        carry.insert(carry.end(), p, nl);
        if (!handle_line(carry.data(), carry.size())) { ok = false; }
        carry.clear();
        p = nl + 1;
      }
      while (ok && p < end) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', end - p));
        if (!nl) {
          carry.assign(p, end);
          break;
        }
        if (!handle_line(p, nl - p)) ok = false;
        p = nl + 1;
      }
    }
    if (ok && !carry.empty())  // final line without trailing newline
      ok = handle_line(carry.data(), carry.size());
    // NB: a trailing head with no seq line is dropped, like the
    // previous reader (produce(): `if (!in.getline(&seq)) break`)
    if (ok) emit_batch();
    std::unique_lock<std::mutex> lk(mu);
    eof = true;
    cv_full.notify_all();
  }

  bool next(Batch* out) {
    std::unique_lock<std::mutex> lk(mu);
    cv_full.wait(lk, [&] { return !ready.empty() || eof; });
    if (ready.empty()) return false;
    *out = std::move(ready.front());
    ready.pop_front();
    cv_empty.notify_all();
    return true;
  }

  ~Reader() {
    {
      std::unique_lock<std::mutex> lk(mu);
      stop = true;
      cv_empty.notify_all();
      cv_full.notify_all();
    }
    chunks.shutdown();
    if (io_thread.joinable()) io_thread.join();
    if (parse_thread.joinable()) parse_thread.join();
  }
};

}  // namespace

extern "C" {

void* hastio_open(const char* path, int batch_size, int len_cap,
                  int fastq) {
  auto* r = new Reader(path, batch_size, len_cap, fastq != 0);
  ByteSource probe(path);
  if (!probe.ok()) {
    delete r;
    return nullptr;
  }
  r->start();
  return r;
}

// packed != 0: seqs rows are 2-bit packed, stride = max_len/4 bytes
// (*max_len_out from hastio_next_batch still reports BASES).
void* hastio_open_packed(const char* path, int batch_size, int len_cap,
                         int fastq, int packed) {
  auto* r = new Reader(path, batch_size, len_cap, fastq != 0);
  r->packed = packed != 0;
  ByteSource probe(path);
  if (!probe.ok()) {
    delete r;
    return nullptr;
  }
  r->start();
  return r;
}

// Fills caller buffers sized batch_size*round128(len_cap) / batch_size.
// Returns #reads (0 on EOF).  *max_len_out is the padded row stride
// actually used (<= round128(len_cap), multiple of 16).
long hastio_next_batch(void* handle, uint8_t* seqs, int32_t* lengths,
                       uint8_t* has_n, int32_t* barcode_ids,
                       int32_t* max_len_out) {
  auto* r = static_cast<Reader*>(handle);
  Batch b;
  if (!r->next(&b)) return 0;
  memcpy(seqs, b.seqs.data(), b.seqs.size());
  memcpy(lengths, b.lengths.data(), b.lengths.size() * sizeof(int32_t));
  memcpy(has_n, b.has_n.data(), b.has_n.size());
  memcpy(barcode_ids, b.barcode_ids.data(),
         b.barcode_ids.size() * sizeof(int32_t));
  *max_len_out = b.max_len;
  return b.n;
}

long hastio_num_barcodes(void* handle) {
  return static_cast<Reader*>(handle)->dict.size();
}

// reads whose sequence exceeded len_cap so far (capped, not dropped)
long hastio_truncated(void* handle) {
  return static_cast<Reader*>(handle)->truncated.load();
}

// counting mode: 2-bit packed rows + per-base ACGT-validity bitmask
void* hastio_open_count(const char* path, int batch_size, int len_cap,
                        int fastq) {
  auto* r = new Reader(path, batch_size, len_cap, fastq != 0);
  r->packed = true;
  r->emit_good = true;
  ByteSource probe(path);
  if (!probe.ok()) {
    delete r;
    return nullptr;
  }
  r->start();
  return r;
}

long hastio_next_batch_count(void* handle, uint8_t* seqs,
                             int32_t* lengths, uint8_t* has_n,
                             int32_t* barcode_ids, uint8_t* good,
                             int32_t* max_len_out) {
  auto* r = static_cast<Reader*>(handle);
  Batch b;
  if (!r->next(&b)) return 0;
  memcpy(seqs, b.seqs.data(), b.seqs.size());
  memcpy(good, b.good.data(), b.good.size());
  memcpy(lengths, b.lengths.data(), b.lengths.size() * sizeof(int32_t));
  memcpy(has_n, b.has_n.data(), b.has_n.size());
  memcpy(barcode_ids, b.barcode_ids.data(),
         b.barcode_ids.size() * sizeof(int32_t));
  *max_len_out = b.max_len;
  return b.n;
}

// nonzero when the input was multi-line fasta (parser unsupported)
long hastio_bad_fasta(void* handle) {
  return static_cast<Reader*>(handle)->bad_fasta.load();
}

// newline-joined barcode strings in id order; returns bytes written
// (or required size if buf == nullptr)
long hastio_get_barcodes(void* handle, char* buf, long cap) {
  auto* r = static_cast<Reader*>(handle);
  const auto& d = r->dict;
  long need = static_cast<long>(d.arena.size()) +
              static_cast<long>(d.size());
  if (!buf) return need;
  if (need > cap) return -1;
  long off = 0;
  for (size_t id = 0; id < d.size(); id++) {
    uint32_t a = d.offs[id], n = d.offs[id + 1] - a;
    memcpy(buf + off, d.arena.data() + a, n);
    off += n;
    buf[off++] = '\n';
  }
  return off;
}

// longest barcode string seen (for fixed-width export)
long hastio_max_barcode_len(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  const auto& d = r->dict;
  uint32_t m = 0;
  for (size_t id = 0; id < d.size(); id++) {
    uint32_t n = d.offs[id + 1] - d.offs[id];
    if (n > m) m = n;
  }
  return m;
}

// NUL-padded fixed-width rows in id order (numpy S<width> layout);
// returns number of rows written, or -1 if the buffer is too small.
long hastio_get_barcodes_fixed(void* handle, char* buf, long cap,
                               int width) {
  auto* r = static_cast<Reader*>(handle);
  const auto& d = r->dict;
  long n = static_cast<long>(d.size());
  if (n * (long)width > cap) return -1;
  memset(buf, 0, n * (long)width);
  for (long id = 0; id < n; id++) {
    uint32_t a = d.offs[id], len = d.offs[id + 1] - a;
    if ((int)len > width) return -1;
    memcpy(buf + id * width, d.arena.data() + a, len);
  }
  return n;
}

void hastio_close(void* handle) { delete static_cast<Reader*>(handle); }

}  // extern "C"

// ---------------------------------------------------------------------------
// line reader used by the quartering path (small inputs, clarity over
// throughput)
// ---------------------------------------------------------------------------

namespace {

class LineReader {
 public:
  explicit LineReader(const std::string& path) : src_(path) {
    ok_ = src_.ok();
    buf_.resize(1 << 20);
  }
  bool ok() const { return ok_; }

  // returns false at EOF; line excludes trailing \n (and \r)
  bool getline(std::string* line) {
    line->clear();
    while (true) {
      if (pos_ >= len_) {
        if (!fill()) return !line->empty();
      }
      char* nl = static_cast<char*>(
          memchr(buf_.data() + pos_, '\n', len_ - pos_));
      if (nl) {
        size_t n = nl - (buf_.data() + pos_);
        line->append(buf_.data() + pos_, n);
        pos_ += n + 1;
        if (!line->empty() && line->back() == '\r') line->pop_back();
        return true;
      }
      line->append(buf_.data() + pos_, len_ - pos_);
      pos_ = len_;
    }
  }

 private:
  bool fill() {
    pos_ = 0;
    len_ = src_.read(buf_.data(), buf_.size());
    return len_ > 0;
  }
  ByteSource src_;
  bool ok_ = false;
  std::vector<char> buf_;
  size_t pos_ = 0, len_ = 0;
};

}  // namespace

// ---------------------------------------------------------------------------
// quartering: route fastq records into 4 bins by barcode class
// (quartering_fastq.awk semantics, see hast_jax/pipeline/partition.py)
// ---------------------------------------------------------------------------

#include <unordered_set>

namespace {

bool load_set(const char* path, std::unordered_set<std::string>* out) {
  LineReader in(path);
  if (!in.ok()) return false;
  std::string line;
  while (in.getline(&line)) {
    // strip whitespace-only lines like the python loader
    size_t a = line.find_first_not_of(" \t");
    if (a == std::string::npos) continue;
    out->insert(line);
  }
  return true;
}

}  // namespace

extern "C" {

// Returns 0 on success.  stats_out: total, no, pa, ma, ho, un.
// Unknown barcodes are reported on stderr exactly like the awk.
int hastio_quarter(const char* fastq_path, const char* prefix,
                   const char* pat_list, const char* mat_list,
                   const char* homo_list, const char* log_path,
                   long* stats_out) {
  std::unordered_set<std::string> pat, mat, homo;
  if (!load_set(pat_list, &pat) || !load_set(mat_list, &mat) ||
      !load_set(homo_list, &homo))
    return 1;
  LineReader in(fastq_path);
  if (!in.ok()) return 2;

  std::string pfx(prefix);
  FILE* outs[4] = {nullptr, nullptr, nullptr, nullptr};
  const char* suffix[4] = {".nobarcode.fastq", ".paternal.fastq",
                           ".maternal.fastq", ".homozygous.fastq"};
  long total = 0, no = 0, pa = 0, ma = 0, ho = 0, un = 0;

  FILE* log = fopen(log_path, "ab");
  if (!log) return 3;
  // awk sees FILENAME="-" when fed from `gzip -dc |`
  size_t n = strlen(fastq_path);
  bool gz = n > 3 && strcmp(fastq_path + n - 3, ".gz") == 0;
  fprintf(log, "%s\n", gz ? "-" : fastq_path);

  std::string head, seq, plus, qual;
  while (in.getline(&head)) {
    if (!in.getline(&seq)) break;
    in.getline(&plus);
    in.getline(&qual);
    total++;
    // awk -F '#|/': fields split on single '#' or '/', empties kept
    size_t s1 = head.find_first_of("#/");
    int rt;  // 0 nobarcode, 1 pat, 2 mat, 3 homo, -1 unknown
    std::string bc;
    if (s1 == std::string::npos) {
      rt = 0;  // NF == 1
      no++;
    } else {
      size_t s2 = head.find_first_of("#/", s1 + 1);
      bc = head.substr(s1 + 1, (s2 == std::string::npos ? head.size() : s2)
                                   - s1 - 1);
      if (bc == "0_0_0") {
        rt = 0;
        no++;
      } else if (pat.count(bc)) {
        rt = 1;
        pa++;
      } else if (mat.count(bc)) {
        rt = 2;
        ma++;
      } else if (homo.count(bc)) {
        rt = 3;
        ho++;
      } else {
        fprintf(stderr, "ERROR : unclassify barcode : %s\n", bc.c_str());
        un++;
        rt = -1;
      }
    }
    if (rt >= 0) {
      if (!outs[rt]) {
        std::string name = pfx + suffix[rt];
        outs[rt] = fopen(name.c_str(), "wb");
        if (!outs[rt]) {
          fclose(log);
          return 4;
        }
        setvbuf(outs[rt], nullptr, _IOFBF, 1 << 20);
      }
      FILE* f = outs[rt];
      fwrite(head.data(), 1, head.size(), f);
      fputc('\n', f);
      fwrite(seq.data(), 1, seq.size(), f);
      fputc('\n', f);
      fwrite(plus.data(), 1, plus.size(), f);
      fputc('\n', f);
      fwrite(qual.data(), 1, qual.size(), f);
      fputc('\n', f);
    }
  }
  fprintf(log, "#Total reads                : %ld \n", total);
  fprintf(log, "#Reads without barcode      : %ld \n", no);
  fprintf(log, "#Paternal reads             : %ld \n", pa);
  fprintf(log, "#Maternal reads             : %ld \n", ma);
  fprintf(log, "#Homozygous reads           : %ld \n", ho);
  fclose(log);
  for (FILE* f : outs)
    if (f) fclose(f);
  if (stats_out) {
    stats_out[0] = total;
    stats_out[1] = no;
    stats_out[2] = pa;
    stats_out[3] = ma;
    stats_out[4] = ho;
    stats_out[5] = un;
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// phased.barcodes formatter: bulk "bc\thap\tc0\tc1\n" rows
// (the print loop of classify.cpp:93-102; rows arrive pre-sorted)
// ---------------------------------------------------------------------------

namespace {

inline char* put_i64(char* p, long long v) {
  if (v < 0) { *p++ = '-'; v = -v; }
  char tmp[24];
  int n = 0;
  do { tmp[n++] = char('0' + v % 10); v /= 10; } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

}  // namespace

extern "C" {

// Multithreaded argsort of n fixed-width (w <= 16) NUL-padded byte
// keys (numpy S dtype) into order_out (int64 indices).  Bytewise
// lexicographic — matches std::map<std::string> iteration order in
// the reference's print loop (classify.cpp:93-102).  Keys are packed
// into two big-endian u64 words so the comparator is two integer
// compares; per-thread std::sort + pairwise merges.
long hastio_sort_fixed(const char* keys, long n, int w,
                       int64_t* order_out) {
  if (w > 16 || n < 0) return -1;
  if (n == 0) return 0;
  struct Item { uint64_t hi, lo; int64_t idx; };
  std::vector<Item> items(n);
  int nt = (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > 16) nt = 16;
  if (n < 65536) nt = 1;
  auto pack = [&](long lo_i, long hi_i) {
    for (long i = lo_i; i < hi_i; ++i) {
      unsigned char b[16] = {0};
      memcpy(b, keys + i * w, w);
      uint64_t a, c;
      memcpy(&a, b, 8);
      memcpy(&c, b + 8, 8);
      items[i].hi = __builtin_bswap64(a);
      items[i].lo = __builtin_bswap64(c);
      items[i].idx = i;
    }
  };
  auto cmp = [](const Item& a, const Item& b) {
    if (a.hi != b.hi) return a.hi < b.hi;
    if (a.lo != b.lo) return a.lo < b.lo;
    return a.idx < b.idx;  // stable tie-break
  };
  std::vector<long> bounds(nt + 1);
  for (int t = 0; t <= nt; ++t) bounds[t] = n * t / nt;
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t)
      ths.emplace_back([&, t] {
        pack(bounds[t], bounds[t + 1]);
        std::sort(items.begin() + bounds[t], items.begin() + bounds[t + 1],
                  cmp);
      });
    for (auto& th : ths) th.join();
  }
  // pairwise parallel merges until one run remains
  std::vector<Item> tmp(n);
  std::vector<long> runs(bounds.begin(), bounds.end());
  Item* src = items.data();
  Item* dst = tmp.data();
  while (runs.size() > 2) {
    std::vector<long> next;
    std::vector<std::thread> ths;
    next.push_back(0);
    for (size_t r = 0; r + 2 < runs.size(); r += 2) {
      long a = runs[r], b = runs[r + 1],
           c = (r + 2 < runs.size()) ? runs[r + 2] : runs.back();
      ths.emplace_back([src, dst, a, b, c, &cmp] {
        std::merge(src + a, src + b, src + b, src + c, dst + a, cmp);
      });
      next.push_back(c);
    }
    if (runs.size() % 2 == 0) {  // odd run count: copy the tail through
      long a = runs[runs.size() - 2], b = runs.back();
      memcpy(dst + a, src + a, (b - a) * sizeof(Item));
      if (next.back() != b) next.push_back(b);
    }
    for (auto& th : ths) th.join();
    std::swap(src, dst);
    runs = std::move(next);
  }
  for (long i = 0; i < n; ++i) order_out[i] = src[i].idx;
  return n;
}

// Decide + format phased.barcodes rows in one pass (the reference's
// print loop, classify.cpp:93-102, with getHap classify.cpp:66-86).
// bcs/c0/c1 are UNSORTED; `order` (from hastio_sort_fixed) gives the
// emit order.  The decision is IEEE double math identical to the
// python decide_haps: hap = 0/1/-1 from (c/size)*w strict compares,
// null barcodes ("0", "0_0", "0_0_0") forced to -1.  Two threads:
// each formats its half into place after a length pre-pass.
long hastio_decide_format(const char* bcs, long n, int w,
                          const int64_t* order, const int64_t* c0,
                          const int64_t* c1, double size0, double size1,
                          double w0, double w1, char* out, long cap) {
  if (n == 0) return 0;
  auto row_hap = [&](long j) -> int {
    const char* bc = bcs + j * w;
    int len = 0;
    while (len < w && bc[len]) ++len;
    bool null_bc =
        (len == 1 && bc[0] == '0') ||
        (len == 3 && memcmp(bc, "0_0", 3) == 0) ||
        (len == 5 && memcmp(bc, "0_0_0", 5) == 0);
    if (null_bc) return -1;
    long long a = c0[j], b = c1[j];
    if (a > 0 && b > 0) {
      double df0 = ((double)a / size0) * w0;
      double df1 = ((double)b / size1) * w1;
      if (df0 > df1) return 0;
      if (df1 > df0) return 1;
      return -1;
    }
    if (a > 0) return 0;
    if (b > 0) return 1;
    return -1;
  };
  auto dec_len = [](long long v) {
    int d = (v < 0) ? 2 : 1;
    if (v < 0) v = -v;
    while (v >= 10) { v /= 10; ++d; }
    return d;
  };
  int nt = n >= 65536 ? 2 : 1;
  std::vector<long> bounds(nt + 1);
  for (int t = 0; t <= nt; ++t) bounds[t] = n * t / nt;
  std::vector<long> part_bytes(nt, 0);
  auto measure = [&](int t) {
    long bytes = 0;
    for (long i = bounds[t]; i < bounds[t + 1]; ++i) {
      long j = order[i];
      const char* bc = bcs + j * w;
      int len = 0;
      while (len < w && bc[len]) ++len;
      int hap = row_hap(j);
      bytes += len + 4 + dec_len(hap) + dec_len(c0[j]) + dec_len(c1[j]);
    }
    part_bytes[t] = bytes;
  };
  {
    std::vector<std::thread> ths;
    for (int t = 1; t < nt; ++t) ths.emplace_back(measure, t);
    measure(0);
    for (auto& th : ths) th.join();
  }
  long total = 0;
  std::vector<long> offs(nt);
  for (int t = 0; t < nt; ++t) { offs[t] = total; total += part_bytes[t]; }
  if (total > cap) return -1;
  auto emit = [&](int t) {
    char* p = out + offs[t];
    for (long i = bounds[t]; i < bounds[t + 1]; ++i) {
      long j = order[i];
      const char* bc = bcs + j * w;
      int len = 0;
      while (len < w && bc[len]) ++len;
      memcpy(p, bc, len);
      p += len;
      *p++ = '\t';
      p = put_i64(p, row_hap(j));
      *p++ = '\t';
      p = put_i64(p, c0[j]);
      *p++ = '\t';
      p = put_i64(p, c1[j]);
      *p++ = '\n';
    }
  };
  {
    std::vector<std::thread> ths;
    for (int t = 1; t < nt; ++t) ths.emplace_back(emit, t);
    emit(0);
    for (auto& th : ths) th.join();
  }
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// 2-choice bucket placement for the probe-table build
// (ops/hashtable._assign_2choice's hot loop in native code: the numpy
// formulation needs two full argsorts of the key array per attempt and
// dominated table build at 2e8 keys — the greedy fill is a single
// O(n) pass with an occupancy byte per bucket, and the cuckoo
// random-walk tail touches only the straggler keys.)
// ---------------------------------------------------------------------------

extern "C" {

// Place each key i into bucket b1[i] or b2[i] (capacity `bucket`
// slots).  Writes row_out[i] (int64 bucket) and slot_out[i] (int8).
// Returns 0 on success, or the number of keys that could not be
// placed after `max_kicks` evictions each (caller doubles the table
// and retries, matching the numpy path's contract).  Deterministic:
// the eviction slot choice comes from an LCG seeded with `seed`.
static long long place2_impl(const uint32_t* b1, const uint32_t* b2,
                             long long n, long long n_buckets, int bucket,
                             unsigned long long seed,
                             long long* row_out, signed char* slot_out) {
  if (bucket <= 0 || bucket > 8) return -1;
  std::vector<unsigned char> occupancy((size_t)n_buckets, 0);
  // occupant key index per slot, for evictions
  std::vector<long long> occ((size_t)n_buckets * bucket, -1);
  // Greedy rounds are parallelized by BUCKET RANGE: thread t owns
  // buckets [t*nb/nt, (t+1)*nb/nt) and scans the whole key stream,
  // touching only its range — state is disjoint (no locks) and each
  // bucket fills in global key order, so the outcome is bit-identical
  // to the sequential pass.
  int nt = (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > 16) nt = 16;
  if (n < (1 << 22)) nt = 1;
  std::vector<std::vector<long long>> pend1((size_t)nt);
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) {
      long long blo = n_buckets * t / nt, bhi = n_buckets * (t + 1) / nt;
      ths.emplace_back([&, t, blo, bhi] {
        for (long long i = 0; i < n; ++i) {
          uint32_t b = b1[i];
          if ((long long)b < blo || (long long)b >= bhi) continue;
          unsigned char& c = occupancy[b];
          if (c < bucket) {
            occ[(size_t)b * bucket + c] = i;
            row_out[i] = b;
            slot_out[i] = (signed char)c;
            ++c;
          } else {
            pend1[t].push_back(i);
          }
        }
      });
    }
    for (auto& th : ths) th.join();
  }
  // restore global key order for round 2 (each pend1[t] is already
  // ascending; merge by concatenate + sort of the small overflow set)
  std::vector<long long> pending;
  for (auto& p : pend1) pending.insert(pending.end(), p.begin(), p.end());
  std::sort(pending.begin(), pending.end());
  std::vector<std::vector<long long>> pend2((size_t)nt);
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) {
      long long blo = n_buckets * t / nt, bhi = n_buckets * (t + 1) / nt;
      ths.emplace_back([&, t, blo, bhi] {
        for (long long i : pending) {
          uint32_t b = b2[i];
          if ((long long)b < blo || (long long)b >= bhi) continue;
          unsigned char& c = occupancy[b];
          if (c < bucket) {
            occ[(size_t)b * bucket + c] = i;
            row_out[i] = b;
            slot_out[i] = (signed char)c;
            ++c;
          } else {
            pend2[t].push_back(i);
          }
        }
      });
    }
    for (auto& th : ths) th.join();
  }
  pending.clear();
  for (auto& p : pend2) pending.insert(pending.end(), p.begin(), p.end());
  std::sort(pending.begin(), pending.end());
  // cuckoo random walk for the stragglers
  unsigned long long rng = seed * 6364136223846793005ULL + 1442695040888963407ULL;
  const int max_kicks = 4096;
  long long failed = 0;
  for (long long i : pending) {
    long long cur = i;
    uint32_t tgt = b2[cur];  // greedy rounds tried b1 then b2
    bool placed = false;
    for (int kick = 0; kick < max_kicks; ++kick) {
      unsigned char& c = occupancy[tgt];
      if (c < bucket) {
        occ[(size_t)tgt * bucket + c] = cur;
        row_out[cur] = tgt;
        slot_out[cur] = (signed char)c;
        ++c;
        placed = true;
        break;
      }
      rng = rng * 6364136223846793005ULL + 1442695040888963407ULL;
      int s = (int)((rng >> 33) % bucket);
      long long victim = occ[(size_t)tgt * bucket + s];
      occ[(size_t)tgt * bucket + s] = cur;
      row_out[cur] = tgt;
      slot_out[cur] = (signed char)s;
      cur = victim;
      tgt = (b1[cur] == (uint32_t)row_out[cur]) ? b2[cur] : b1[cur];
    }
    if (!placed) {
      row_out[cur] = -1;
      slot_out[cur] = -1;
      ++failed;
    }
  }
  return failed;
}

long long hastio_place2(const uint32_t* b1, const uint32_t* b2,
                        long long n, long long n_buckets, int bucket,
                        unsigned long long seed,
                        long long* row_out, signed char* slot_out) {
  // the occ/occupancy tables are multi-GB at human scale: a bad_alloc
  // must surface as the numpy-fallback return code, not a crash
  try {
    return place2_impl(b1, b2, n, n_buckets, bucket, seed, row_out,
                       slot_out);
  } catch (...) {
    return -1;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full quot-format table build: fused feistel/quotient + greedy 2-choice
// placement + slot fill.  The numpy formulation of the 4-round Feistel
// permutation alone makes ~30 full-array passes (168 s at 2e8 keys on a
// 2-core host); here it is one fused pass per key, threaded.
// Mirrors ops/hashtable.{_feistel_halves,_quot_bucket_q,_quot_alt}
// bit-for-bit so native- and numpy-built tables probe identically.
// ---------------------------------------------------------------------------

namespace {

inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16; h *= 0x85EBCA6BU;
  h ^= h >> 13; h *= 0xC2B2AE35U;
  h ^= h >> 16;
  return h;
}

inline void quot_key(uint32_t hi, uint32_t lo, int k, int bbits,
                     uint32_t* b1_out, uint32_t* q_out) {
  const uint32_t kmask = (k == 32) ? 0xFFFFFFFFU : ((1U << k) - 1U);
  uint32_t A = (((uint64_t)hi << (32 - k)) | (lo >> k)) & kmask;
  uint32_t B = lo & kmask;
  static const uint32_t FC[4] = {0x9E3779B9U, 0x85EBCA6BU,
                                 0xC2B2AE35U, 0x27D4EB2FU};
  for (int i = 0; i < 4; ++i) {
    uint32_t f = (i % 2 == 0)
        ? (fmix32(B * 0x85EBCA6BU + FC[i]) & kmask)
        : (fmix32(A * 0x85EBCA6BU + FC[i]) & kmask);
    if (i % 2 == 0) A ^= f; else B ^= f;
  }
  uint32_t b1, q;
  const uint32_t bmask = (bbits >= 32) ? 0xFFFFFFFFU : ((1U << bbits) - 1U);
  if (bbits <= k) {
    b1 = B & bmask;
    q = (bbits == k) ? A : ((B >> bbits) | (A << (k - bbits)));
  } else {
    b1 = (B | (A << k)) & bmask;
    q = A >> (bbits - k);
  }
  *b1_out = b1;
  *q_out = q;
}

inline uint32_t quot_alt(uint32_t b1, uint32_t q, int bbits) {
  const uint32_t bmask = (bbits >= 32) ? 0xFFFFFFFFU : ((1U << bbits) - 1U);
  uint32_t g = (fmix32(q * 0x9E3779B9U) | 1U) & bmask;
  return b1 ^ g;
}

}  // namespace

extern "C" {

// Sort (hi, lo) pairs ascending carrying pay, OR pays of duplicate
// keys, compact in place.  Returns the number of distinct keys, or -1.
static long long sort_dedup_or_impl(uint32_t* hi, uint32_t* lo,
                                    uint32_t* pay, long long n) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  struct Key { uint64_t w; uint32_t p; };
  std::vector<Key> ks((size_t)n);
  int nt = (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > 16) nt = 16;
  if (n < 65536) nt = 1;
  std::vector<long long> bounds(nt + 1);
  for (int t = 0; t <= nt; ++t) bounds[t] = n * t / nt;
  auto cmp = [](const Key& a, const Key& b) { return a.w < b.w; };
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t)
      ths.emplace_back([&, t] {
        for (long long i = bounds[t]; i < bounds[t + 1]; ++i)
          ks[i] = Key{((uint64_t)hi[i] << 32) | lo[i], pay[i]};
        std::sort(ks.begin() + bounds[t], ks.begin() + bounds[t + 1], cmp);
      });
    for (auto& th : ths) th.join();
  }
  std::vector<Key> tmp((size_t)n);
  std::vector<long long> runs(bounds.begin(), bounds.end());
  Key* src = ks.data();
  Key* dst = tmp.data();
  while (runs.size() > 2) {
    std::vector<long long> next;
    std::vector<std::thread> ths;
    next.push_back(runs[0]);
    size_t r = 0;
    for (; r + 2 < runs.size(); r += 2) {
      long long a = runs[r], b = runs[r + 1], c = runs[r + 2];
      ths.emplace_back([src, dst, a, b, c, &cmp] {
        std::merge(src + a, src + b, src + b, src + c, dst + a, cmp);
      });
      next.push_back(c);
    }
    if (r + 1 < runs.size()) {  // leftover single run: copy through
      long long a = runs[r], b = runs[r + 1];
      memcpy(dst + a, src + a, (size_t)(b - a) * sizeof(Key));
      if (next.back() != b) next.push_back(b);
    }
    for (auto& th : ths) th.join();
    std::swap(src, dst);
    runs = next;
  }
  // linear dedupe with payload OR
  long long m = 0;
  for (long long i = 0; i < n; ++i) {
    if (m && src[m - 1].w == src[i].w) {
      src[m - 1].p |= src[i].p;
    } else {
      src[m++] = src[i];
    }
  }
  for (long long i = 0; i < m; ++i) {
    hi[i] = (uint32_t)(src[i].w >> 32);
    lo[i] = (uint32_t)src[i].w;
    pay[i] = src[i].p;
  }
  return m;
}

long long hastio_sort_dedup_or(uint32_t* hi, uint32_t* lo, uint32_t* pay,
                               long long n) {
  try {
    return sort_dedup_or_impl(hi, lo, pay, n);
  } catch (...) {
    return -1;
  }
}

// Build the quot-format table in one call: per-key fused
// feistel/quotient/alt (threaded), greedy 2-choice placement + cuckoo
// walk (sequential, deterministic), threaded slot fill.  data_out must
// be (1<<bbits)*4 uint32 zeros.  Returns 0 ok, >0 unplaced keys
// (caller doubles the table), <0 error.
static long long build_quot_impl(const uint32_t* hi, const uint32_t* lo,
                                 const uint32_t* pay, long long n, int k,
                                 int bbits, unsigned long long seed,
                                 uint32_t* data_out) {
  if (k < 1 || k > 31 || bbits < 1 || bbits > 31 || n < 0) return -1;
  if (2 * k - bbits > 29) return -2;
  const long long n_buckets = 1LL << bbits;
  const int bucket = 4;
  std::vector<uint32_t> b1v((size_t)n), b2v((size_t)n), qv((size_t)n);
  int nt = (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > 16) nt = 16;
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) {
      long long a = n * t / nt, b = n * (t + 1) / nt;
      ths.emplace_back([&, a, b] {
        for (long long i = a; i < b; ++i) {
          uint32_t bb, qq;
          quot_key(hi[i], lo[i], k, bbits, &bb, &qq);
          b1v[i] = bb;
          qv[i] = qq;
          b2v[i] = quot_alt(bb, qq, bbits);
        }
      });
    }
    for (auto& th : ths) th.join();
  }
  std::vector<long long> row((size_t)n);
  std::vector<signed char> slot((size_t)n);
  long long failed = place2_impl(b1v.data(), b2v.data(), n, n_buckets,
                                 bucket, seed, row.data(), slot.data());
  if (failed != 0) return failed;
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) {
      long long a = n * t / nt, b = n * (t + 1) / nt;
      ths.emplace_back([&, a, b] {
        for (long long i = a; i < b; ++i) {
          uint32_t which = (row[i] != (long long)b1v[i]) ? 1U : 0U;
          data_out[row[i] * bucket + slot[i]] =
              (qv[i] & ((1U << 29) - 1U)) | (which << 29) | (pay[i] << 30);
        }
      });
    }
    for (auto& th : ths) th.join();
  }
  return 0;
}

long long hastio_build_quot(const uint32_t* hi, const uint32_t* lo,
                            const uint32_t* pay, long long n, int k,
                            int bbits, unsigned long long seed,
                            uint32_t* data_out) {
  try {
    return build_quot_impl(hi, lo, pay, n, k, bbits, seed, data_out);
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
