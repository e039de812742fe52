// Native host runtime: string-ID -> table-row mapping.
//
// The device only ever sees int32 rows + segment ids (SURVEY.md §7); this
// map is where string document/passage IDs are resolved.  The reference
// keeps python dicts rebuilt by a python loop (reference:
// index/memory.py:86-95, index/disk.py:400-417) — at MS MARCO scale that
// loop dominates index load time and the per-call lookups sit on the
// scoring path, so both run natively here (GIL-free batch calls over
// fixed-width numpy 'S' arrays via ctypes).  The per-pair passes of a call
// run on a worker pool of the host's cores (below).
//
// Build: see build.py (g++ -O3 -shared -fPIC -pthread).

#include <pthread.h>
#include <sched.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---- the worker pool ---------------------------------------------------
//
// The per-pair passes below (the resolve and its fill, the id numbering and
// string gather, the streamed layout, the per-query sort) split their items
// into contiguous parts and run them at once on one persistent pool, part k
// on thread k, the calling thread taking part 0.  The pool is as wide as the
// process's CPU affinity mask and starts on the first pass large enough to
// use it.  A pass of fewer than kGrain items has one part and runs on the
// calling thread alone.  The pool takes one pass at a time: a pass that finds
// it busy runs its parts one after another on its own thread, so no caller
// waits for another.  A pass's parts depend on its size and the width alone,
// and each pass combines them in part order, so every output is the same at
// any width and whether or not the parts ran at once.

constexpr int64_t kGrain = int64_t{1} << 15;

std::atomic<int> g_width{0};  // 0 until first read
std::atomic<int64_t> g_wide_passes{0};
std::atomic<int64_t> g_serial_passes{0};

void drop_pool_in_child();

int pool_width() {
  static const bool forks_drop_the_pool =
      pthread_atfork(nullptr, nullptr, drop_pool_in_child) == 0;
  (void)forks_drop_the_pool;
  int w = g_width.load(std::memory_order_relaxed);
  if (w == 0) {
    cpu_set_t set;
    w = sched_getaffinity(0, sizeof(set), &set) == 0
            ? CPU_COUNT(&set)
            : static_cast<int>(std::thread::hardware_concurrency());
    w = std::max(w, 1);
    g_width.store(w, std::memory_order_relaxed);
  }
  return w;
}

class Pool {
 public:
  explicit Pool(int width) {
    for (int w = 1; w < width; ++w) threads_.emplace_back([this, w] { serve(w); });
  }

  // Runs body(k) for k in [0, parts) at once, part 0 on the calling thread;
  // false, having run nothing, when another pass holds the pool.
  bool run(int parts, const std::function<void(int)>& body) {
    if (busy_.exchange(true, std::memory_order_acquire)) return false;
    {
      std::lock_guard<std::mutex> lock(mu_);
      body_ = &body;
      parts_ = parts;
      pending_ = parts - 1;
      ++generation_;
    }
    wake_.notify_all();
    body(0);
    {
      std::unique_lock<std::mutex> lock(mu_);
      done_.wait(lock, [this] { return pending_ == 0; });
    }
    busy_.store(false, std::memory_order_release);
    return true;
  }

 private:
  void serve(int w) {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lock(mu_);
    for (;;) {
      wake_.wait(lock, [&] { return generation_ != seen; });
      seen = generation_;
      if (w >= parts_) continue;
      const std::function<void(int)>* body = body_;
      lock.unlock();
      (*body)(w);
      lock.lock();
      if (--pending_ == 0) done_.notify_one();
    }
  }

  std::vector<std::thread> threads_;
  std::mutex mu_;
  std::condition_variable wake_, done_;
  std::atomic<bool> busy_{false};
  const std::function<void(int)>* body_ = nullptr;
  int parts_ = 0;
  int pending_ = 0;
  uint64_t generation_ = 0;
};

// Never freed (its threads wait for the next pass); a forked child holds
// none of the parent's threads, so it drops the pool, reads its own width
// and starts its own pool.
Pool* g_pool = nullptr;
pthread_mutex_t g_pool_mu = PTHREAD_MUTEX_INITIALIZER;

void drop_pool_in_child() {
  g_pool = nullptr;
  g_width.store(0, std::memory_order_relaxed);
  pthread_mutex_init(&g_pool_mu, nullptr);
}

Pool& the_pool() {
  pthread_mutex_lock(&g_pool_mu);
  if (g_pool == nullptr) g_pool = new Pool(pool_width());
  Pool* pool = g_pool;
  pthread_mutex_unlock(&g_pool_mu);
  return *pool;
}

// Parts of a pass over n items: one below the grain, else the pool's width
// (at most n).
int pass_parts(int64_t n, int64_t grain) {
  if (n < grain) return 1;
  return static_cast<int>(std::min<int64_t>(pool_width(), n));
}

// fn(lo, hi, part) over the pass_parts(n, grain) contiguous parts of
// [0, n), part k being [n k / parts, n (k + 1) / parts).  Returns whether
// the parts ran at once on the pool.
template <typename Fn>
bool parallel_for(int64_t n, int64_t grain, Fn&& fn) {
  const int parts = pass_parts(n, grain);
  const std::function<void(int)> part = [&](int k) {
    fn(n * k / parts, n * (k + 1) / parts, k);
  };
  if (parts > 1 && the_pool().run(parts, part)) return true;
  for (int k = 0; k < parts; ++k) part(k);
  return false;
}

// Counts one pass as run wide (any of its loops on the pool) or serially.
void count_pass(bool wide) {
  (wide ? g_wide_passes : g_serial_passes).fetch_add(1, std::memory_order_relaxed);
}

// Heterogeneous (allocation-free) lookup for the string-keyed maps.
struct SvHash {
  using is_transparent = void;
  size_t operator()(std::string_view sv) const {
    return std::hash<std::string_view>{}(sv);
  }
  size_t operator()(const std::string& s) const {
    return std::hash<std::string_view>{}(std::string_view(s));
  }
};
struct SvEq {
  using is_transparent = void;
  bool operator()(std::string_view a, std::string_view b) const { return a == b; }
};

template <typename V>
using StrMap = std::unordered_map<std::string, V, SvHash, SvEq>;

// IDs of <= 8 bytes (the common IR case) pack into a uint64 key; lookups
// then skip string hashing/allocation entirely.
inline uint64_t mix_u64(uint64_t k) {
  // splitmix64 finalizer
  k += 0x9e3779b97f4a7c15ULL;
  k = (k ^ (k >> 30)) * 0xbf58476d1ce4e5b9ULL;
  k = (k ^ (k >> 27)) * 0x94d049bb133111ebULL;
  return k ^ (k >> 31);
}

inline bool pack_u64(std::string_view key, uint64_t* out) {
  if (key.size() > 8 || key.empty()) return false;
  uint64_t v = 0;
  std::memcpy(&v, key.data(), key.size());
  *out = v;
  return true;
}

// Open-addressing u64 -> value table with linear probing.  Lookup batches
// software-prefetch the probe slot ~16 keys ahead, hiding the DRAM latency
// that dominates std::unordered_map on large maps.
template <typename V>
struct FlatU64Map {
  struct Slot {
    uint64_t key;  // 0 = empty (packed keys of non-empty ids are never 0)
    V value;
  };
  std::vector<Slot> slots;
  size_t mask = 0;
  size_t count = 0;

  FlatU64Map() { resize(1 << 12); }

  void resize(size_t cap) {
    std::vector<Slot> old = std::move(slots);
    slots.assign(cap, Slot{0, V{}});
    mask = cap - 1;
    count = 0;
    for (const Slot& s : old) {
      if (s.key) insert(s.key, s.value);
    }
  }

  void insert(uint64_t key, V value) {
    if ((count + 1) * 10 > slots.size() * 7) resize(slots.size() * 2);
    size_t i = mix_u64(key) & mask;
    while (slots[i].key && slots[i].key != key) i = (i + 1) & mask;
    if (!slots[i].key) ++count;
    slots[i] = Slot{key, value};
  }

  void prefetch(uint64_t key) const {
    __builtin_prefetch(&slots[mix_u64(key) & mask]);
  }

  const V* find(uint64_t key) const {
    size_t i = mix_u64(key) & mask;
    while (slots[i].key) {
      if (slots[i].key == key) return &slots[i].value;
      i = (i + 1) & mask;
    }
    return nullptr;
  }
};

struct IdMap {
  // doc id -> rows (documents may span multiple passages, in add order)
  StrMap<std::vector<int32_t>> doc_rows;
  // psg id -> unique row
  StrMap<int32_t> psg_row;
  // u64 shadow maps for short ids (mirrors of the string maps)
  FlatU64Map<const std::vector<int32_t>*> doc_rows64;
  FlatU64Map<int32_t> psg_row64;
  // insertion order (needed to enumerate ids deterministically)
  std::vector<const StrMap<std::vector<int32_t>>::value_type*> doc_order;
  std::vector<const StrMap<int32_t>::value_type*> psg_order;
};

inline std::string_view make_view(const char* data, int64_t width) {
  // fixed-width field, right-padded with NULs (numpy 'S' layout)
  int64_t len = width;
  while (len > 0 && data[len - 1] == '\0') --len;
  return std::string_view(data, static_cast<size_t>(len));
}

inline std::string make_key(const char* data, int64_t width) {
  return std::string(make_view(data, width));
}

// Gather the strings of an Arrow UTF-8 array (data buffer + offsets) at
// positions idx into a new one: out_offsets holds m + 1 entries and
// out_data room for the strings, at most the input's bytes for distinct
// positions.  Returns the bytes written.
// A wide pass sums each part's bytes first and copies each part at the
// prefix sum of those before it.
template <typename Off>
int64_t gather_strings(const char* data, const Off* offsets, const int64_t* idx,
                       int64_t m, Off* out_offsets, char* out_data) {
  constexpr int64_t kPrefetch = 16;
  const int parts = pass_parts(m, kGrain);
  std::vector<Off> at(static_cast<size_t>(parts) + 1, 0);
  bool wide = false;
  if (parts > 1) {
    wide = parallel_for(m, kGrain, [&](int64_t lo, int64_t hi, int k) {
      Off bytes = 0;
      for (int64_t j = lo; j < hi; ++j) {
        if (j + kPrefetch < hi) __builtin_prefetch(&offsets[idx[j + kPrefetch]]);
        bytes += offsets[idx[j] + 1] - offsets[idx[j]];
      }
      at[k + 1] = bytes;
    });
    for (int k = 0; k < parts; ++k) at[k + 1] += at[k];
  }
  out_offsets[0] = 0;
  wide |= parallel_for(m, kGrain, [&](int64_t lo, int64_t hi, int k) {
    Off pos = at[k];
    for (int64_t j = lo; j < hi; ++j) {
      if (j + kPrefetch < hi) {
        __builtin_prefetch(&offsets[idx[j + kPrefetch]]);
        __builtin_prefetch(data + offsets[idx[j + kPrefetch / 2]]);
      }
      const Off start = offsets[idx[j]];
      const Off len = offsets[idx[j] + 1] - start;
      std::memcpy(out_data + pos, data + start, static_cast<size_t>(len));
      pos += len;
      out_offsets[j + 1] = pos;
    }
  });
  count_pass(wide);
  return static_cast<int64_t>(out_offsets[m]);
}

}  // namespace

extern "C" {

void* idmap_create() { return new IdMap(); }

void idmap_destroy(void* handle) { delete static_cast<IdMap*>(handle); }

// Register a batch of ids starting at table row `start_row`.
// Empty (all-NUL) fields mean "no id for this vector".  Passing nullptr for
// either array means no ids of that kind.  Returns -(i+1) if psg id i is a
// duplicate (nothing before i is rolled back - caller validates first via
// idmap_check_new), else 0.
int64_t idmap_add(void* handle, const char* doc_ids, const char* psg_ids,
                  int64_t n, int64_t width, int64_t start_row) {
  IdMap* m = static_cast<IdMap*>(handle);
  for (int64_t i = 0; i < n; ++i) {
    if (psg_ids != nullptr) {
      std::string key = make_key(psg_ids + i * width, width);
      if (!key.empty()) {
        auto [it, inserted] =
            m->psg_row.emplace(std::move(key), static_cast<int32_t>(start_row + i));
        if (!inserted) return -(i + 1);
        m->psg_order.push_back(&*it);
        uint64_t k64;
        if (pack_u64(it->first, &k64)) m->psg_row64.insert(k64, it->second);
      }
    }
    if (doc_ids != nullptr) {
      std::string key = make_key(doc_ids + i * width, width);
      if (!key.empty()) {
        auto [it, inserted] = m->doc_rows.emplace(
            std::move(key), std::vector<int32_t>{});
        if (inserted) m->doc_order.push_back(&*it);
        it->second.push_back(static_cast<int32_t>(start_row + i));
        uint64_t k64;
        if (inserted && pack_u64(it->first, &k64)) {
          m->doc_rows64.insert(k64, &it->second);
        }
      }
    }
  }
  return 0;
}

// Pre-validate a psg-id batch: returns -(i+1) for the first id already
// present (or duplicated within the batch), else 0.
int64_t idmap_check_new(void* handle, const char* psg_ids, int64_t n,
                        int64_t width) {
  IdMap* m = static_cast<IdMap*>(handle);
  StrMap<int64_t> batch;
  for (int64_t i = 0; i < n; ++i) {
    std::string_view key = make_view(psg_ids + i * width, width);
    if (key.empty()) continue;
    if (m->psg_row.find(key) != m->psg_row.end()) return -(i + 1);
    auto [it, inserted] = batch.emplace(std::string(key), i);
    if (!inserted) return -(i + 1);
  }
  return 0;
}

int64_t idmap_num_docs(void* handle) {
  return static_cast<IdMap*>(handle)->doc_rows.size();
}

int64_t idmap_num_psgs(void* handle) {
  return static_cast<IdMap*>(handle)->psg_row.size();
}

// Copy all ids (insertion order) into `out`, a (count, width) 'S' buffer.
void idmap_doc_ids(void* handle, char* out, int64_t width) {
  IdMap* m = static_cast<IdMap*>(handle);
  for (size_t i = 0; i < m->doc_order.size(); ++i) {
    const std::string& key = m->doc_order[i]->first;
    std::memset(out + i * width, 0, static_cast<size_t>(width));
    std::memcpy(out + i * width, key.data(), key.size());
  }
}

void idmap_psg_ids(void* handle, char* out, int64_t width) {
  IdMap* m = static_cast<IdMap*>(handle);
  for (size_t i = 0; i < m->psg_order.size(); ++i) {
    const std::string& key = m->psg_order[i]->first;
    std::memset(out + i * width, 0, static_cast<size_t>(width));
    std::memcpy(out + i * width, key.data(), key.size());
  }
}

// Resolve ids to row counts, caching the hash-lookup results so the row
// fill pass needs no second lookup.  mode: 0 = PASSAGE, 1 = doc all rows
// (MAXP/AVEP), 2 = doc first row (FIRSTP).  Fills counts[n] and cache[n];
// returns the total number of rows, or -(i+1) if id i is missing.
int64_t idmap_resolve(void* handle, const char* ids, int64_t n, int64_t width,
                      int32_t mode, int32_t* counts, const void** cache);

// ---- streamed-layout builder (no strings; see ops.build_streamed_layout) --
//
// Buckets candidate rows into the streaming kernel's (virtual tile, slot)
// grid in two O(P) passes with no sorting.

}  // extern "C"

namespace {

// counts[t] = the pairs of [lo, hi) in base tile t.
void count_tiles(const int32_t* rows, int64_t lo, int64_t hi, int64_t tile_rows,
                 int64_t num_tiles, int64_t* counts) {
  std::fill(counts, counts + num_tiles, 0);
  for (int64_t i = lo; i < hi; ++i) counts[rows[i] / tile_rows] += 1;
}

}  // namespace

extern "C" {

// Pass 1: per-base-tile candidate counts; returns the number of virtual
// tiles (ceil(count / cap) summed).  A wide pass counts each part's pairs
// apart and sums the counts.
int64_t stream_count(const int32_t* rows, int64_t p, int64_t tile_rows,
                     int64_t num_tiles, int64_t cap, int64_t* tile_counts) {
  const int parts = pass_parts(p, kGrain);
  std::vector<int64_t> part_counts(parts > 1 ? parts * num_tiles : 0);
  const bool wide = parallel_for(p, kGrain, [&](int64_t lo, int64_t hi, int k) {
    count_tiles(rows, lo, hi, tile_rows, num_tiles,
                parts == 1 ? tile_counts : part_counts.data() + k * num_tiles);
  });
  count_pass(wide);
  if (parts > 1) {
    std::fill(tile_counts, tile_counts + num_tiles, 0);
    for (size_t at = 0; at < part_counts.size(); at += num_tiles) {
      for (int64_t t = 0; t < num_tiles; ++t) tile_counts[t] += part_counts[at + t];
    }
  }
  int64_t virtual_tiles = 0;
  for (int64_t t = 0; t < num_tiles; ++t) {
    virtual_tiles += (tile_counts[t] + cap - 1) / cap;
  }
  return virtual_tiles;
}

// Pass 2: fill cand's cand_slots slots with the padding value, then place
// each pair: cand, tile_idx and the per-pair output slot.  Pairs fill each
// tile's slots in pair order: in a wide pass a part's cursor in a tile
// starts past the pairs the parts before it hold there.
void stream_fill(const int32_t* rows, const int32_t* qno, int64_t p,
                 int64_t tile_rows, int64_t num_tiles, int64_t cap,
                 int64_t qb, const int64_t* tile_counts, int32_t* cand,
                 int64_t cand_slots, int32_t pad_value, int32_t* tile_idx,
                 int64_t* slot_of_pair) {
  // vt_base[t] = first virtual tile of base tile t; also fill tile_idx
  std::vector<int64_t> vt_base(static_cast<size_t>(num_tiles) + 1, 0);
  int64_t vt = 0;
  for (int64_t t = 0; t < num_tiles; ++t) {
    vt_base[t] = vt;
    int64_t n_vt = (tile_counts[t] + cap - 1) / cap;
    for (int64_t j = 0; j < n_vt; ++j) tile_idx[vt + j] = static_cast<int32_t>(t);
    vt += n_vt;
  }
  vt_base[num_tiles] = vt;

  const int parts = pass_parts(p, kGrain);
  std::vector<int64_t> cursors(static_cast<size_t>(parts * num_tiles), 0);
  bool wide = parallel_for(p, kGrain, [&](int64_t lo, int64_t hi, int k) {
    std::fill(cand + cand_slots * k / parts, cand + cand_slots * (k + 1) / parts,
              pad_value);
    if (parts > 1) {
      count_tiles(rows, lo, hi, tile_rows, num_tiles, cursors.data() + k * num_tiles);
    }
  });
  if (parts > 1) {  // each part's counts -> the counts of the parts before it
    std::vector<int64_t> before(static_cast<size_t>(num_tiles), 0);
    for (size_t at = 0; at < cursors.size(); at += num_tiles) {
      for (int64_t t = 0; t < num_tiles; ++t) {
        const int64_t here = cursors[at + t];
        cursors[at + t] = before[t];
        before[t] += here;
      }
    }
  }
  wide |= parallel_for(p, kGrain, [&](int64_t lo, int64_t hi, int k) {
    int64_t* cursor = cursors.data() + k * num_tiles;
    for (int64_t i = lo; i < hi; ++i) {
      int64_t t = rows[i] / tile_rows;
      int64_t c = cursor[t]++;
      int64_t flat = (vt_base[t] + c / cap) * cap + (c % cap);
      cand[flat] = static_cast<int32_t>(
          static_cast<int64_t>(rows[i] % tile_rows) * qb + qno[i]);
      slot_of_pair[i] = flat;
    }
  });
  count_pass(wide);
}

// LSD radix argsort over uint64 keys (11-bit digits, 6 passes).  Returns the
// permutation that sorts `keys` ascending — the result-ordering hot path
// (numpy's comparison argsort costs ~3x more on one core).
void radix_argsort_u64(const uint64_t* keys, int64_t n, int64_t* out) {
  constexpr int kBits = 11;
  constexpr int kBuckets = 1 << kBits;
  constexpr uint64_t kMask = kBuckets - 1;
  std::vector<int64_t> a(static_cast<size_t>(n)), b(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) a[static_cast<size_t>(i)] = i;
  std::vector<int64_t> count(kBuckets);
  int64_t* src = a.data();
  int64_t* dst = b.data();
  for (int shift = 0; shift < 64; shift += kBits) {
    std::fill(count.begin(), count.end(), 0);
    for (int64_t i = 0; i < n; ++i) {
      count[(keys[src[i]] >> shift) & kMask] += 1;
    }
    // skip passes where every key shares the digit
    bool trivial = false;
    for (int64_t c : count) {
      if (c == n) {
        trivial = true;
        break;
      }
    }
    if (trivial) continue;
    int64_t total = 0;
    for (int64_t bkt = 0; bkt < kBuckets; ++bkt) {
      int64_t c = count[bkt];
      count[bkt] = total;
      total += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      dst[count[(keys[src[i]] >> shift) & kMask]++] = src[i];
    }
    std::swap(src, dst);
  }
  std::memcpy(out, src, static_cast<size_t>(n) * sizeof(int64_t));
}

// Segmented descending argsort of fp32 scores: segment q (input rows
// [seg_starts[q], seg_starts[q+1])) is sorted by score descending (stable)
// and written to out[out_starts[q]...].  Segments are per-query candidate
// blocks (~1e3 rows), so the 8-bit-digit LSD radix runs entirely in cache —
// ~10x faster than the global composite-u64 radix it replaces on the
// result-ordering hot path.  A wide pass gives each part a run of as many
// segments and its own scratch.
void segmented_rank_argsort_f32(const float* scores, const int64_t* seg_starts,
                                const int64_t* out_starts, int64_t num_q,
                                int64_t* out) {
  const auto sort = [&](int64_t q_lo, int64_t q_hi, int) {
    std::vector<uint32_t> keys, keys2;
    std::vector<int64_t> idx, idx2;
    int64_t count[256];
    for (int64_t q = q_lo; q < q_hi; ++q) {
      const int64_t s = seg_starts[q];
      const int64_t m = seg_starts[q + 1] - s;
      if (m <= 0) continue;
      keys.resize(static_cast<size_t>(m));
      keys2.resize(static_cast<size_t>(m));
      idx.resize(static_cast<size_t>(m));
      idx2.resize(static_cast<size_t>(m));
      for (int64_t i = 0; i < m; ++i) {
        uint32_t b;
        std::memcpy(&b, &scores[s + i], sizeof(b));
        // map float bits to an ascending-sortable u32, then invert: an
        // ascending radix sort then yields descending score order
        const uint32_t asc = (b >> 31) ? ~b : (b | 0x80000000u);
        keys[static_cast<size_t>(i)] = ~asc;
        idx[static_cast<size_t>(i)] = s + i;
      }
      uint32_t* ksrc = keys.data();
      uint32_t* kdst = keys2.data();
      int64_t* isrc = idx.data();
      int64_t* idst = idx2.data();
      for (int shift = 0; shift < 32; shift += 8) {
        std::fill(count, count + 256, 0);
        for (int64_t i = 0; i < m; ++i) count[(ksrc[i] >> shift) & 255] += 1;
        bool trivial = false;
        for (int64_t c : count) {
          if (c == m) {
            trivial = true;
            break;
          }
        }
        if (trivial) continue;
        int64_t total = 0;
        for (int bkt = 0; bkt < 256; ++bkt) {
          const int64_t c = count[bkt];
          count[bkt] = total;
          total += c;
        }
        for (int64_t i = 0; i < m; ++i) {
          const int64_t pos = count[(ksrc[i] >> shift) & 255]++;
          kdst[pos] = ksrc[i];
          idst[pos] = isrc[i];
        }
        std::swap(ksrc, kdst);
        std::swap(isrc, idst);
      }
      std::memcpy(out + out_starts[q], isrc,
                  static_cast<size_t>(m) * sizeof(int64_t));
    }
  };
  if (num_q <= 0) {
    count_pass(false);
    return;
  }
  // the grain in segments: as many as hold kGrain rows on average
  const int64_t rows = std::max<int64_t>(seg_starts[num_q] - seg_starts[0], 1);
  const int64_t grain = std::max<int64_t>(2, (kGrain * num_q + rows - 1) / rows);
  count_pass(parallel_for(num_q, grain, sort));
}

// Number int32 rows by their ids' byte order: codes[i] is the place of
// rows[i]'s id among the distinct ids of `rows` sorted in byte order, the
// order of pd.Categorical's categories, and pos[c] the first position where
// code c appears (pos holds n entries; the first `returned` are written).
// rank holds the id map's rank of each of n_ranks table rows
// (idmap_rank_rows).  The rows' ranks mark a bitmap of n_ranks bits; a
// rank's place among the marked ones is the count of marked bits below it,
// a running count per 64-bit word plus one popcount, so no hash table and
// no sort is needed, and the bitmap (a bit a table row) stays in cache.
// A call's resolved rows number its distinct candidate ids this way without
// hashing or comparing a string.  A wide pass gives each part of the pairs
// a bitmap of its own, ORs them over the words and keeps in each part's the
// marks of the parts before it: a part then writes the first position of
// the codes no earlier part holds, so no two threads write one word or one
// position.  The running count stays serial (a word for 64 table rows).
// Returns the number of distinct rows, or -1 if a row has no rank.
int64_t number_rows_i32(const int32_t* rows, int64_t n, const int32_t* rank,
                        int64_t n_ranks, int32_t* codes, int64_t* pos) {
  constexpr int64_t kPrefetch = 16;
  const size_t words = static_cast<size_t>((n_ranks + 63) / 64);
  const int parts = pass_parts(n, kGrain);
  // part k's marks at [k * words, (k + 1) * words), each part zeroing its own
  std::unique_ptr<uint64_t[]> bits(new uint64_t[parts * words]);
  std::atomic<bool> unranked{false};
  bool wide = parallel_for(n, kGrain, [&](int64_t lo, int64_t hi, int k) {
    uint64_t* mine = bits.get() + k * words;
    std::fill(mine, mine + words, 0);
    for (int64_t i = lo; i < hi; ++i) {
      if (i + kPrefetch < hi) __builtin_prefetch(&rank[rows[i + kPrefetch]]);
      const int32_t row = rows[i];
      if (row < 0 || row >= n_ranks || rank[row] < 0) {
        unranked.store(true, std::memory_order_relaxed);
        return;
      }
      const int32_t r = rank[row];
      codes[i] = r;
      mine[r >> 6] |= uint64_t{1} << (r & 63);
    }
  });
  if (unranked.load(std::memory_order_relaxed)) {
    count_pass(wide);
    return -1;
  }
  const uint64_t* marked = bits.get();
  std::vector<uint64_t> all;
  if (parts > 1) {  // part k's marks -> the marks of the parts before it
    all.resize(words);
    wide |= parallel_for(words, kGrain, [&](int64_t lo, int64_t hi, int) {
      for (int64_t w = lo; w < hi; ++w) {
        uint64_t before = 0;
        for (int k = 0; k < parts; ++k) {
          const uint64_t here = bits[k * words + w];
          bits[k * words + w] = before;
          before |= here;
        }
        all[w] = before;
      }
    });
    marked = all.data();
  }
  std::vector<int32_t> below(words);
  int32_t total = 0;
  for (size_t w = 0; w < words; ++w) {
    below[w] = total;
    total += __builtin_popcountll(marked[w]);
  }
  // backwards, so that each code's last write in a part is its first
  // position there
  wide |= parallel_for(n, kGrain, [&](int64_t lo, int64_t hi, int k) {
    const uint64_t* earlier = k == 0 ? nullptr : bits.get() + k * words;
    for (int64_t i = hi - 1; i >= lo; --i) {
      const int32_t r = codes[i];
      const uint64_t bit = uint64_t{1} << (r & 63);
      const int32_t c = below[r >> 6] + __builtin_popcountll(marked[r >> 6] & (bit - 1));
      codes[i] = c;
      if (earlier == nullptr || !(earlier[r >> 6] & bit)) pos[c] = i;
    }
  });
  count_pass(wide);
  return total;
}

int64_t gather_strings32(const char* data, const int32_t* offsets,
                         const int64_t* idx, int64_t m, int32_t* out_offsets,
                         char* out_data) {
  return gather_strings(data, offsets, idx, m, out_offsets, out_data);
}

int64_t gather_strings64(const char* data, const int64_t* offsets,
                         const int64_t* idx, int64_t m, int64_t* out_offsets,
                         char* out_data) {
  return gather_strings(data, offsets, idx, m, out_offsets, out_data);
}

}  // extern "C"

namespace {

// Shared resolve body over any id-view generator.  A wide pass resolves
// its parts at once; a missing id is reported at the least position of any
// part's first missing one, the one a single loop stops at.
template <typename GetView>
int64_t resolve_views(IdMap* m, GetView get_view, int64_t n, int32_t mode,
                      int32_t* counts, const void** cache) {
  constexpr int64_t kPrefetch = 16;
  const int parts = pass_parts(n, kGrain);
  std::vector<int64_t> totals(static_cast<size_t>(parts), 0);
  std::vector<int64_t> missing(static_cast<size_t>(parts), n);
  const bool wide = parallel_for(n, kGrain, [&](int64_t lo, int64_t hi, int k) {
    int64_t total = 0;
    for (int64_t i = lo; i < hi; ++i) {
      if (i + kPrefetch < hi) {
        uint64_t ahead;
        if (pack_u64(get_view(i + kPrefetch), &ahead)) {
          if (mode == 0) {
            m->psg_row64.prefetch(ahead);
          } else {
            m->doc_rows64.prefetch(ahead);
          }
        }
      }
      std::string_view key = get_view(i);
      uint64_t k64;
      const bool short_key = pack_u64(key, &k64);
      if (mode == 0) {
        int32_t row;
        if (short_key) {
          const int32_t* found = m->psg_row64.find(k64);
          if (found == nullptr) {
            missing[k] = i;
            return;
          }
          row = *found;
        } else {
          auto it = m->psg_row.find(key);
          if (it == m->psg_row.end()) {
            missing[k] = i;
            return;
          }
          row = it->second;
        }
        counts[i] = 1;
        cache[i] = reinterpret_cast<const void*>(static_cast<intptr_t>(row));
        total += 1;
      } else {
        const std::vector<int32_t>* rows;
        if (short_key) {
          auto found = m->doc_rows64.find(k64);
          if (found == nullptr) {
            missing[k] = i;
            return;
          }
          rows = *found;
        } else {
          auto it = m->doc_rows.find(key);
          if (it == m->doc_rows.end()) {
            missing[k] = i;
            return;
          }
          rows = &it->second;
        }
        if (rows->empty()) {
          missing[k] = i;
          return;
        }
        counts[i] = mode == 2 ? 1 : static_cast<int32_t>(rows->size());
        cache[i] = rows;
        total += counts[i];
      }
    }
    totals[k] = total;
  });
  count_pass(wide);
  int64_t total = 0;
  for (int k = 0; k < parts; ++k) {
    if (missing[k] < n) return -(missing[k] + 1);
    total += totals[k];
  }
  return total;
}

// The permutation that sorts ids in byte order: an LSD radix sort on each
// id's first 8 bytes, read big-endian so that the integer order is the byte
// order (the keys travel with their indices, so each pass reads and writes
// in sequence), then a full comparison inside each run of ids that share
// those bytes.
std::vector<int64_t> byte_order(const std::vector<std::string_view>& ids) {
  constexpr int kBits = 11;
  constexpr uint64_t kMask = (uint64_t{1} << kBits) - 1;
  const size_t n = ids.size();
  std::vector<uint64_t> key(n), key2(n);
  std::vector<int64_t> perm(n), perm2(n);
  for (size_t i = 0; i < n; ++i) {
    unsigned char b[8] = {0};
    std::memcpy(b, ids[i].data(), std::min<size_t>(8, ids[i].size()));
    uint64_t k = 0;
    for (unsigned char c : b) k = (k << 8) | c;
    key[i] = k;
    perm[i] = static_cast<int64_t>(i);
  }
  std::vector<size_t> count(size_t{1} << kBits);
  for (int shift = 0; shift < 64; shift += kBits) {
    std::fill(count.begin(), count.end(), 0);
    for (size_t i = 0; i < n; ++i) ++count[(key[i] >> shift) & kMask];
    if (std::find(count.begin(), count.end(), n) != count.end()) continue;
    size_t total = 0;
    for (size_t& c : count) {
      const size_t here = c;
      c = total;
      total += here;
    }
    for (size_t i = 0; i < n; ++i) {
      const size_t pos = count[(key[i] >> shift) & kMask]++;
      key2[pos] = key[i];
      perm2[pos] = perm[i];
    }
    key.swap(key2);
    perm.swap(perm2);
  }
  for (size_t i = 0; i < n;) {
    size_t j = i + 1;
    while (j < n && key[j] == key[i]) ++j;
    if (j - i > 1) {
      std::sort(perm.begin() + i, perm.begin() + j,
                [&ids](int64_t a, int64_t b) { return ids[a] < ids[b]; });
    }
    i = j;
  }
  return perm;
}

}  // namespace

extern "C" {

// Definition of the fixed-width resolve declared above.
int64_t idmap_resolve(void* handle, const char* ids, int64_t n, int64_t width,
                      int32_t mode, int32_t* counts, const void** cache) {
  return resolve_views(
      static_cast<IdMap*>(handle),
      [&](int64_t i) { return make_view(ids + i * width, width); }, n, mode,
      counts, cache);
}

// Resolve ids given as an Arrow UTF-8 string array (data buffer + int32
// offsets) — zero-copy from pandas/pyarrow string columns.
int64_t idmap_resolve_offsets32(void* handle, const char* data,
                                const int32_t* offsets, int64_t n,
                                int32_t mode, int32_t* counts,
                                const void** cache) {
  return resolve_views(
      static_cast<IdMap*>(handle),
      [&](int64_t i) {
        return std::string_view(
            data + offsets[i], static_cast<size_t>(offsets[i + 1] - offsets[i]));
      },
      n, mode, counts, cache);
}

// Same for Arrow large_string (int64 offsets).
int64_t idmap_resolve_offsets64(void* handle, const char* data,
                                const int64_t* offsets, int64_t n,
                                int32_t mode, int32_t* counts,
                                const void** cache) {
  return resolve_views(
      static_cast<IdMap*>(handle),
      [&](int64_t i) {
        return std::string_view(
            data + offsets[i], static_cast<size_t>(offsets[i + 1] - offsets[i]));
      },
      n, mode, counts, cache);
}

// Fill the flat row array from the cache built by idmap_resolve, with its
// per-id row counts.  A wide pass writes each part at the sum of the counts
// before it.
int64_t idmap_fill_cached(void* handle, const void** cache,
                          const int32_t* counts, int64_t n, int32_t mode,
                          int32_t* rows) {
  (void)handle;
  const int parts = pass_parts(n, kGrain);
  std::vector<int64_t> at(static_cast<size_t>(parts) + 1, 0);
  bool wide = false;
  if (mode == 1 && parts > 1) {
    wide = parallel_for(n, kGrain, [&](int64_t lo, int64_t hi, int k) {
      int64_t sum = 0;
      for (int64_t i = lo; i < hi; ++i) sum += counts[i];
      at[k + 1] = sum;
    });
    for (int k = 0; k < parts; ++k) at[k + 1] += at[k];
  }
  wide |= parallel_for(n, kGrain, [&](int64_t lo, int64_t hi, int k) {
    int64_t pos = mode == 1 ? at[k] : lo;  // one row an id in modes 0 and 2
    for (int64_t i = lo; i < hi; ++i) {
      if (mode == 0) {
        rows[pos++] =
            static_cast<int32_t>(reinterpret_cast<intptr_t>(cache[i]));
      } else {
        const auto* vec = static_cast<const std::vector<int32_t>*>(cache[i]);
        if (mode == 2) {
          rows[pos++] = vec->front();
        } else {
          for (int32_t r : *vec) rows[pos++] = r;
        }
      }
    }
    if (k == parts - 1) at[parts] = pos;
  });
  count_pass(wide);
  return at[parts];
}

// Bulk-load from parallel fixed-width id arrays (the OnDiskIndex.load path:
// row i gets doc_ids[i] / psg_ids[i] unless empty).  Duplicate psg ids keep
// the *last* row, matching the reference load semantics (disk.py:417).
void idmap_bulk_load(void* handle, const char* doc_ids, const char* psg_ids,
                     int64_t n, int64_t width) {
  IdMap* m = static_cast<IdMap*>(handle);
  m->doc_rows.reserve(static_cast<size_t>(n));
  m->psg_row.reserve(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    if (doc_ids != nullptr) {
      std::string key = make_key(doc_ids + i * width, width);
      if (!key.empty()) {
        auto [it, inserted] =
            m->doc_rows.emplace(std::move(key), std::vector<int32_t>{});
        if (inserted) m->doc_order.push_back(&*it);
        it->second.push_back(static_cast<int32_t>(i));
        uint64_t k64;
        if (inserted && pack_u64(it->first, &k64)) {
          m->doc_rows64.insert(k64, &it->second);
        }
      }
    }
    if (psg_ids != nullptr) {
      std::string key = make_key(psg_ids + i * width, width);
      if (!key.empty()) {
        auto [it, inserted] =
            m->psg_row.emplace(std::move(key), static_cast<int32_t>(i));
        if (inserted) {
          m->psg_order.push_back(&*it);
        } else {
          it->second = static_cast<int32_t>(i);
        }
        uint64_t k64;
        if (pack_u64(it->first, &k64)) m->psg_row64.insert(k64, it->second);
      }
    }
  }
}

// Look up one id's rows (for _get_vectors-style single queries).
// Returns count (0 if missing); writes up to max_out rows.
int64_t idmap_lookup(void* handle, const char* id, int64_t width,
                     int32_t mode, int32_t* out, int64_t max_out) {
  IdMap* m = static_cast<IdMap*>(handle);
  std::string key = make_key(id, width);
  if (mode == 0) {
    auto it = m->psg_row.find(key);
    if (it == m->psg_row.end()) return 0;
    if (max_out > 0) out[0] = it->second;
    return 1;
  }
  auto it = m->doc_rows.find(key);
  if (it == m->doc_rows.end()) return 0;
  const auto& rows = it->second;
  int64_t count = mode == 2 ? 1 : static_cast<int64_t>(rows.size());
  for (int64_t i = 0; i < count && i < max_out; ++i) out[i] = rows[i];
  return count;
}

// The pool's width and the passes run wide and serially so far in this
// process, in out[0..2].  Reading them starts no thread.
void pool_stats(int64_t* out) {
  out[0] = pool_width();
  out[1] = g_wide_passes.load(std::memory_order_relaxed);
  out[2] = g_serial_passes.load(std::memory_order_relaxed);
}

// Rank of each table row's id among all ids of one kind (0 = passage ids,
// 1 = document ids, every row of a document sharing its rank) in byte order,
// the order pandas sorts str categories in: out[row], -1 for a row without
// such an id; out holds n_rows entries.  A call that needs its ids sorted
// then sorts these integers instead of the strings.
void idmap_rank_rows(void* handle, int32_t kind, int32_t* out, int64_t n_rows) {
  IdMap* m = static_cast<IdMap*>(handle);
  std::fill(out, out + n_rows, -1);
  const auto put = [&](int32_t row, size_t rank) {
    if (row >= 0 && row < n_rows) out[row] = static_cast<int32_t>(rank);
  };
  std::vector<std::string_view> ids;
  if (kind == 0) {
    ids.reserve(m->psg_order.size());
    for (const auto* e : m->psg_order) ids.emplace_back(e->first);
    const std::vector<int64_t> perm = byte_order(ids);
    for (size_t r = 0; r < perm.size(); ++r) put(m->psg_order[perm[r]]->second, r);
  } else {
    ids.reserve(m->doc_order.size());
    for (const auto* e : m->doc_order) ids.emplace_back(e->first);
    const std::vector<int64_t> perm = byte_order(ids);
    for (size_t r = 0; r < perm.size(); ++r) {
      for (int32_t row : m->doc_order[perm[r]]->second) put(row, r);
    }
  }
}

}  // extern "C"
