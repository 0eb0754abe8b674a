// Native resident-id map: open-addressing hash map int64 -> int32 with batch
// numpy-array operations, exposed through a C ABI for ctypes.
//
// A copy of quake_tpu/native/idmap.cpp (same C ABI), the host-side id
// bookkeeping of the reference (resident_ids_ set in
// partition_manager.cpp:163-184 and the per-partition linear find_id in
// index_partition.cpp:129-145): the card owns the vector data; this map
// routes mutations (add validation, remove/get targeting) to the right
// partition rows in O(1) per id instead of Python-dict overhead or the
// reference's O(ntotal) scans.
//
// Built at first use by quake_tpu_torch/native/idmap.py:
//   g++ -O3 -shared -fPIC -o quake_tpu_torch/_build/libquake_idmap_<hash>.so idmap.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int64_t kEmpty = -1;   // empty slot marker (ids are validated >= 0)
constexpr int64_t kTombstone = -2;

struct IdMap {
  int64_t* keys = nullptr;
  int32_t* values = nullptr;
  size_t capacity = 0;  // power of two
  size_t size = 0;
  size_t used = 0;  // size + tombstones

  explicit IdMap(size_t initial) {
    capacity = 64;
    while (capacity < initial * 2) capacity <<= 1;
    alloc();
  }
  ~IdMap() {
    std::free(keys);
    std::free(values);
  }

  void alloc() {
    keys = static_cast<int64_t*>(std::malloc(capacity * sizeof(int64_t)));
    values = static_cast<int32_t*>(std::malloc(capacity * sizeof(int32_t)));
    for (size_t i = 0; i < capacity; ++i) keys[i] = kEmpty;
  }

  static inline size_t hash(int64_t k) {
    uint64_t h = static_cast<uint64_t>(k);
    h ^= h >> 33;
    h *= 0xff51afd7ed558ccdULL;
    h ^= h >> 33;
    h *= 0xc4ceb9fe1a85ec53ULL;
    h ^= h >> 33;
    return static_cast<size_t>(h);
  }

  void grow() {
    int64_t* old_keys = keys;
    int32_t* old_values = values;
    size_t old_cap = capacity;
    capacity <<= 1;
    alloc();
    used = size;
    size_t n = 0;
    for (size_t i = 0; i < old_cap; ++i) {
      if (old_keys[i] >= 0) {
        insert_fresh(old_keys[i], old_values[i]);
        ++n;
      }
    }
    size = n;
    used = n;
    std::free(old_keys);
    std::free(old_values);
  }

  // Insert assuming key is absent (used during rehash).
  void insert_fresh(int64_t k, int32_t v) {
    size_t mask = capacity - 1;
    size_t i = hash(k) & mask;
    while (keys[i] >= 0) i = (i + 1) & mask;
    keys[i] = k;
    values[i] = v;
  }

  // Insert or update. Returns 1 if newly inserted, 0 if updated.
  int set(int64_t k, int32_t v) {
    if ((used + 1) * 10 >= capacity * 7) grow();
    size_t mask = capacity - 1;
    size_t i = hash(k) & mask;
    size_t first_tomb = SIZE_MAX;
    while (true) {
      int64_t cur = keys[i];
      if (cur == k) {
        values[i] = v;
        return 0;
      }
      if (cur == kTombstone && first_tomb == SIZE_MAX) first_tomb = i;
      if (cur == kEmpty) {
        size_t slot = (first_tomb != SIZE_MAX) ? first_tomb : i;
        if (slot == i) ++used;
        keys[slot] = k;
        values[slot] = v;
        ++size;
        return 1;
      }
      i = (i + 1) & mask;
    }
  }

  // Returns value or -1.
  int32_t get(int64_t k) const {
    size_t mask = capacity - 1;
    size_t i = hash(k) & mask;
    while (true) {
      int64_t cur = keys[i];
      if (cur == k) return values[i];
      if (cur == kEmpty) return -1;
      i = (i + 1) & mask;
    }
  }

  // Returns 1 if removed.
  int erase(int64_t k) {
    size_t mask = capacity - 1;
    size_t i = hash(k) & mask;
    while (true) {
      int64_t cur = keys[i];
      if (cur == k) {
        keys[i] = kTombstone;
        --size;
        return 1;
      }
      if (cur == kEmpty) return 0;
      i = (i + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

void* idmap_create(int64_t initial_capacity) {
  return new IdMap(initial_capacity > 0 ? static_cast<size_t>(initial_capacity) : 64);
}

void idmap_destroy(void* h) { delete static_cast<IdMap*>(h); }

int64_t idmap_size(void* h) {
  return static_cast<int64_t>(static_cast<IdMap*>(h)->size);
}

// Batch insert/update: returns number of NEW keys inserted.
int64_t idmap_set_batch(void* h, const int64_t* ks, const int32_t* vs, int64_t n) {
  IdMap* m = static_cast<IdMap*>(h);
  int64_t inserted = 0;
  for (int64_t i = 0; i < n; ++i) inserted += m->set(ks[i], vs[i]);
  return inserted;
}

// Batch lookup into out (missing -> -1).
void idmap_get_batch(void* h, const int64_t* ks, int32_t* out, int64_t n) {
  const IdMap* m = static_cast<IdMap*>(h);
  for (int64_t i = 0; i < n; ++i) out[i] = m->get(ks[i]);
}

// Batch membership test into out (1/0).
void idmap_contains_batch(void* h, const int64_t* ks, uint8_t* out, int64_t n) {
  const IdMap* m = static_cast<IdMap*>(h);
  for (int64_t i = 0; i < n; ++i) out[i] = m->get(ks[i]) >= 0 ? 1 : 0;
}

// Batch erase: returns number actually removed.
int64_t idmap_erase_batch(void* h, const int64_t* ks, int64_t n) {
  IdMap* m = static_cast<IdMap*>(h);
  int64_t removed = 0;
  for (int64_t i = 0; i < n; ++i) removed += m->erase(ks[i]);
  return removed;
}

// Dump all (key, value) pairs; out_keys/out_values must hold size() entries.
// Returns the number written.
int64_t idmap_items(void* h, int64_t* out_keys, int32_t* out_values) {
  const IdMap* m = static_cast<IdMap*>(h);
  int64_t n = 0;
  for (size_t i = 0; i < m->capacity; ++i) {
    if (m->keys[i] >= 0) {
      out_keys[n] = m->keys[i];
      out_values[n] = m->values[i];
      ++n;
    }
  }
  return n;
}

// Collect the distinct values (partition rows) of the given keys into
// out_rows (caller-sized to n); returns count of distinct rows found.
int64_t idmap_rows_of(void* h, const int64_t* ks, int64_t n, int32_t* out_rows) {
  const IdMap* m = static_cast<IdMap*>(h);
  int64_t cnt = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t v = m->get(ks[i]);
    if (v < 0) continue;
    bool seen = false;
    for (int64_t j = 0; j < cnt; ++j) {
      if (out_rows[j] == v) {
        seen = true;
        break;
      }
    }
    if (!seen) out_rows[cnt++] = v;
  }
  return cnt;
}

}  // extern "C"
