// Native host runtime: string-ID -> table-row mapping.
//
// The device only ever sees int32 rows + segment ids (SURVEY.md §7); this
// map is where string document/passage IDs are resolved.  The reference
// keeps python dicts rebuilt by a python loop (reference:
// index/memory.py:86-95, index/disk.py:400-417) — at MS MARCO scale that
// loop dominates index load time and the per-call lookups sit on the
// scoring path, so both run natively here (GIL-free batch calls over
// fixed-width numpy 'S' arrays via ctypes).
//
// Build: see build.py (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

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
  std::vector<const std::string*> doc_order;
  std::vector<const std::string*> psg_order;
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
        m->psg_order.push_back(&it->first);
        uint64_t k64;
        if (pack_u64(it->first, &k64)) m->psg_row64.insert(k64, it->second);
      }
    }
    if (doc_ids != nullptr) {
      std::string key = make_key(doc_ids + i * width, width);
      if (!key.empty()) {
        auto [it, inserted] = m->doc_rows.emplace(
            std::move(key), std::vector<int32_t>{});
        if (inserted) m->doc_order.push_back(&it->first);
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
    const std::string& key = *m->doc_order[i];
    std::memset(out + i * width, 0, static_cast<size_t>(width));
    std::memcpy(out + i * width, key.data(), key.size());
  }
}

void idmap_psg_ids(void* handle, char* out, int64_t width) {
  IdMap* m = static_cast<IdMap*>(handle);
  for (size_t i = 0; i < m->psg_order.size(); ++i) {
    const std::string& key = *m->psg_order[i];
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

// Pass 1: per-base-tile candidate counts; returns the number of virtual
// tiles (ceil(count / cap) summed).
int64_t stream_count(const int32_t* rows, int64_t p, int64_t tile_rows,
                     int64_t num_tiles, int64_t cap, int64_t* tile_counts) {
  for (int64_t t = 0; t < num_tiles; ++t) tile_counts[t] = 0;
  for (int64_t i = 0; i < p; ++i) tile_counts[rows[i] / tile_rows] += 1;
  int64_t virtual_tiles = 0;
  for (int64_t t = 0; t < num_tiles; ++t) {
    virtual_tiles += (tile_counts[t] + cap - 1) / cap;
  }
  return virtual_tiles;
}

// Pass 2: fill cand (pre-initialized to the padding value), tile_idx and
// the per-pair output slot.
void stream_fill(const int32_t* rows, const int32_t* qno, int64_t p,
                 int64_t tile_rows, int64_t num_tiles, int64_t cap,
                 int64_t qb, const int64_t* tile_counts, int32_t* cand,
                 int32_t* tile_idx, int64_t* slot_of_pair) {
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

  std::vector<int64_t> cursor(static_cast<size_t>(num_tiles), 0);
  for (int64_t i = 0; i < p; ++i) {
    int64_t t = rows[i] / tile_rows;
    int64_t c = cursor[t]++;
    int64_t flat = (vt_base[t] + c / cap) * cap + (c % cap);
    cand[flat] = static_cast<int32_t>(
        static_cast<int64_t>(rows[i] % tile_rows) * qb + qno[i]);
    slot_of_pair[i] = flat;
  }
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
// result-ordering hot path.
void segmented_rank_argsort_f32(const float* scores, const int64_t* seg_starts,
                                const int64_t* out_starts, int64_t num_q,
                                int64_t* out) {
  std::vector<uint32_t> keys, keys2;
  std::vector<int64_t> idx, idx2;
  int64_t count[256];
  for (int64_t q = 0; q < num_q; ++q) {
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
}

}  // extern "C"

namespace {

// Shared resolve body over any id-view generator.
template <typename GetView>
int64_t resolve_views(IdMap* m, GetView get_view, int64_t n, int32_t mode,
                      int32_t* counts, const void** cache) {
  constexpr int64_t kPrefetch = 16;
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i + kPrefetch < n) {
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
        if (found == nullptr) return -(i + 1);
        row = *found;
      } else {
        auto it = m->psg_row.find(key);
        if (it == m->psg_row.end()) return -(i + 1);
        row = it->second;
      }
      counts[i] = 1;
      cache[i] = reinterpret_cast<const void*>(static_cast<intptr_t>(row));
      total += 1;
    } else {
      const std::vector<int32_t>* rows;
      if (short_key) {
        auto found = m->doc_rows64.find(k64);
        if (found == nullptr) return -(i + 1);
        rows = *found;
      } else {
        auto it = m->doc_rows.find(key);
        if (it == m->doc_rows.end()) return -(i + 1);
        rows = &it->second;
      }
      if (rows->empty()) return -(i + 1);
      counts[i] = mode == 2 ? 1 : static_cast<int32_t>(rows->size());
      cache[i] = rows;
      total += counts[i];
    }
  }
  return total;
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

// Fill the flat row array from the cache built by idmap_resolve.
int64_t idmap_fill_cached(void* handle, const void** cache, int64_t n,
                          int32_t mode, int32_t* rows) {
  (void)handle;
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
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
  return pos;
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
        if (inserted) m->doc_order.push_back(&it->first);
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
          m->psg_order.push_back(&it->first);
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

}  // extern "C"
