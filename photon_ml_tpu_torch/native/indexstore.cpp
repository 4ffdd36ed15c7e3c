// Off-heap immutable feature index store ("PHIX" format).
//
// Reference parity: the role of PalDB in photon-ml — an mmap'd off-heap
// string->int store for feature index maps too large for the driver heap
// (util/PalDBIndexMap.scala:43: partitioned read-only stores opened per
// executor; PalDBIndexMapBuilder.scala:27). This is a from-scratch
// implementation: one file per partition holding two open-addressing hash
// tables (forward name->index and reverse index->name) plus the key blob,
// all accessed zero-copy through mmap so any number of processes share one
// page-cache copy.
//
// File layout (little-endian, 8-byte aligned):
//   Header   { magic "PHIX", u32 version=1, u64 num_slots (pow2),
//              u64 num_entries, u64 fwd_off, u64 rev_off, u64 keys_off,
//              u64 keys_len }
//   FwdSlot  [num_slots] { u64 key_off, u32 key_len, u32 index }
//            (empty slot: key_off == EMPTY)
//   RevSlot  [num_slots] { u64 index_plus1 (0 = empty), u64 key_off,
//              u32 key_len, u32 _pad }
//   keys blob
//
// Exposed as a plain C ABI consumed via ctypes; the plain Python writer
// and reader of the same format (indexmap/offheap.py) hold it byte for byte.
// Beyond the reference's entry points, the port's builder sorts and
// deduplicates packed keys (phix_sort_unique) and packs one partition's
// keys itself (phix_build_members), so that a store of ~10^7 keys is built
// without a Python object per key.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <string_view>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t EMPTY = ~0ULL;

#pragma pack(push, 1)
struct Header {
  char magic[4];
  uint32_t version;
  uint64_t num_slots;
  uint64_t num_entries;
  uint64_t fwd_off;
  uint64_t rev_off;
  uint64_t keys_off;
  uint64_t keys_len;
};
struct FwdSlot {
  uint64_t key_off;
  uint32_t key_len;
  uint32_t index;
};
struct RevSlot {
  uint64_t index_plus1;
  uint64_t key_off;
  uint32_t key_len;
  uint32_t pad;
};
#pragma pack(pop)

uint64_t fnv1a(const char* s, uint64_t n) {
  uint64_t h = 14695981039346656037ULL;
  for (uint64_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(s[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

uint64_t pow2_slots(uint64_t n) {
  // load factor <= 0.7, minimum 16 slots
  uint64_t want = (n * 10) / 7 + 1;
  uint64_t s = 16;
  while (s < want) s <<= 1;
  return s;
}

struct Store {
  void* map;
  uint64_t map_len;
  const Header* header;
  const FwdSlot* fwd;
  const RevSlot* rev;
  const char* keys;
};

}  // namespace

extern "C" {

// Build one partition file. keys: concatenated UTF-8 bytes; key_offs[i] is
// the byte offset of key i; key_lens[i] its length; indices[i] its (global)
// feature index. Returns 0 on success, negative errno-style codes otherwise.
int phix_build(const char* path, const char* keys, const uint64_t* key_offs,
               const uint32_t* key_lens, const uint32_t* indices, uint64_t n) {
  const uint64_t slots = pow2_slots(n);
  const uint64_t mask = slots - 1;

  // zeroed, so an empty slot's key_len and index are 0 and a store's bytes
  // are a function of its keys alone (the plain Python writer's bytes)
  FwdSlot* fwd = static_cast<FwdSlot*>(calloc(slots, sizeof(FwdSlot)));
  RevSlot* rev = static_cast<RevSlot*>(calloc(slots, sizeof(RevSlot)));
  if (!fwd || !rev) {
    free(fwd);
    free(rev);
    return -12;  // ENOMEM
  }
  for (uint64_t i = 0; i < slots; ++i) fwd[i].key_off = EMPTY;

  uint64_t keys_len = 0;
  for (uint64_t i = 0; i < n; ++i) {
    const char* k = keys + key_offs[i];
    const uint64_t klen = key_lens[i];
    if (key_offs[i] + klen > keys_len) keys_len = key_offs[i] + klen;

    uint64_t slot = fnv1a(k, klen) & mask;
    while (fwd[slot].key_off != EMPTY) {
      if (fwd[slot].key_len == klen &&
          memcmp(keys + fwd[slot].key_off, k, klen) == 0) {
        free(fwd);
        free(rev);
        return -17;  // EEXIST: duplicate key
      }
      slot = (slot + 1) & mask;
    }
    fwd[slot].key_off = key_offs[i];
    fwd[slot].key_len = static_cast<uint32_t>(klen);
    fwd[slot].index = indices[i];

    uint64_t rslot = splitmix64(indices[i]) & mask;
    while (rev[rslot].index_plus1 != 0) rslot = (rslot + 1) & mask;
    rev[rslot].index_plus1 = static_cast<uint64_t>(indices[i]) + 1;
    rev[rslot].key_off = key_offs[i];
    rev[rslot].key_len = static_cast<uint32_t>(klen);
  }

  Header h;
  memcpy(h.magic, "PHIX", 4);
  h.version = 1;
  h.num_slots = slots;
  h.num_entries = n;
  h.fwd_off = sizeof(Header);
  h.rev_off = h.fwd_off + slots * sizeof(FwdSlot);
  h.keys_off = h.rev_off + slots * sizeof(RevSlot);
  h.keys_len = keys_len;

  FILE* f = fopen(path, "wb");
  if (!f) {
    free(fwd);
    free(rev);
    return -2;  // ENOENT-ish: cannot open for write
  }
  int rc = 0;
  if (fwrite(&h, sizeof(Header), 1, f) != 1 ||
      fwrite(fwd, sizeof(FwdSlot), slots, f) != slots ||
      fwrite(rev, sizeof(RevSlot), slots, f) != slots ||
      (keys_len > 0 && fwrite(keys, 1, keys_len, f) != keys_len)) {
    rc = -5;  // EIO
  }
  if (fclose(f) != 0) rc = rc ? rc : -5;
  free(fwd);
  free(rev);
  return rc;
}

void* phix_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  close(fd);  // mapping keeps the file alive
  if (map == MAP_FAILED) return nullptr;

  const Header* h = static_cast<const Header*>(map);
  if (memcmp(h->magic, "PHIX", 4) != 0 || h->version != 1) {
    munmap(map, st.st_size);
    return nullptr;
  }
  Store* s = new Store;
  s->map = map;
  s->map_len = st.st_size;
  s->header = h;
  s->fwd = reinterpret_cast<const FwdSlot*>(static_cast<char*>(map) + h->fwd_off);
  s->rev = reinterpret_cast<const RevSlot*>(static_cast<char*>(map) + h->rev_off);
  s->keys = static_cast<char*>(map) + h->keys_off;
  return s;
}

int64_t phix_get(void* handle, const char* key, uint32_t key_len) {
  const Store* s = static_cast<const Store*>(handle);
  const uint64_t mask = s->header->num_slots - 1;
  uint64_t slot = fnv1a(key, key_len) & mask;
  while (s->fwd[slot].key_off != EMPTY) {
    if (s->fwd[slot].key_len == key_len &&
        memcmp(s->keys + s->fwd[slot].key_off, key, key_len) == 0) {
      return static_cast<int64_t>(s->fwd[slot].index);
    }
    slot = (slot + 1) & mask;
  }
  return -1;
}

// Batch lookup: m packed keys -> out[i] = index or -1.
void phix_get_batch(void* handle, const char* keys, const uint64_t* offs,
                    const uint32_t* lens, int64_t* out, uint64_t m) {
  for (uint64_t i = 0; i < m; ++i) {
    out[i] = phix_get(handle, keys + offs[i], lens[i]);
  }
}

// Reverse lookup: copy the name for `index` into buf (truncated to buflen);
// returns the full name length, or -1 if the index is absent.
int64_t phix_name_at(void* handle, uint32_t index, char* buf, uint32_t buflen) {
  const Store* s = static_cast<const Store*>(handle);
  const uint64_t mask = s->header->num_slots - 1;
  uint64_t slot = splitmix64(index) & mask;
  const uint64_t want = static_cast<uint64_t>(index) + 1;
  while (s->rev[slot].index_plus1 != 0) {
    if (s->rev[slot].index_plus1 == want) {
      const uint32_t n = s->rev[slot].key_len;
      const uint32_t c = n < buflen ? n : buflen;
      memcpy(buf, s->keys + s->rev[slot].key_off, c);
      return static_cast<int64_t>(n);
    }
    slot = (slot + 1) & mask;
  }
  return -1;
}

uint64_t phix_num_entries(void* handle) {
  return static_cast<const Store*>(handle)->header->num_entries;
}

// FNV-1a over m packed keys (partition routing done vectorized host-side).
void phix_hash_batch(const char* keys, const uint64_t* offs,
                     const uint32_t* lens, uint64_t* out, uint64_t m) {
  for (uint64_t i = 0; i < m; ++i) {
    out[i] = fnv1a(keys + offs[i], lens[i]);
  }
}

// Sort m packed keys by their bytes (unsigned, shorter prefix first: the
// order of Python's sorted() over the UTF-8 keys, i.e. over the str keys)
// and drop repeats. order[0..k) receives the index of the first key of
// each distinct value, in sorted order; returns k. Keys sort by an 8-byte
// big-endian prefix first (the rest only breaks ties), in up to 8 chunks
// on threads of their own, merged after.
uint64_t phix_sort_unique(const char* keys, const uint64_t* offs,
                          const uint32_t* lens, uint64_t m, uint64_t* order) {
  struct Item {
    uint64_t prefix;
    uint64_t index;
  };
  std::vector<Item> items(m);
  for (uint64_t i = 0; i < m; ++i) {
    uint64_t p = 0;
    for (uint32_t j = 0; j < 8; ++j) {
      p = (p << 8) | (j < lens[i] ? static_cast<unsigned char>(keys[offs[i] + j]) : 0u);
    }
    items[i] = {p, i};
  }
  auto less = [&](const Item& a, const Item& b) {
    if (a.prefix != b.prefix) return a.prefix < b.prefix;
    int c = std::string_view(keys + offs[a.index], lens[a.index])
                .compare(std::string_view(keys + offs[b.index], lens[b.index]));
    return c < 0 || (c == 0 && a.index < b.index);
  };
  const uint64_t chunks = m < (1u << 16) ? 1 : 8;
  std::vector<uint64_t> cut(chunks + 1);
  for (uint64_t c = 0; c <= chunks; ++c) cut[c] = m * c / chunks;
  std::vector<std::thread> workers;
  for (uint64_t c = 0; c < chunks; ++c) {
    workers.emplace_back([&, c] { std::sort(items.begin() + cut[c], items.begin() + cut[c + 1], less); });
  }
  for (auto& w : workers) w.join();
  for (uint64_t width = 1; width < chunks; width *= 2) {
    for (uint64_t c = 0; c + width < chunks; c += 2 * width) {
      uint64_t hi = std::min(c + 2 * width, chunks);
      std::inplace_merge(items.begin() + cut[c], items.begin() + cut[c + width],
                         items.begin() + cut[hi], less);
    }
  }
  auto same = [&](uint64_t a, uint64_t b) {
    return lens[a] == lens[b] && memcmp(keys + offs[a], keys + offs[b], lens[a]) == 0;
  };
  uint64_t k = 0;
  for (uint64_t j = 0; j < m; ++j) {
    if (k == 0 || !same(order[k - 1], items[j].index)) order[k++] = items[j].index;
  }
  return k;
}

// Build one partition file from the keys members[0..n) of a packed key set,
// in that order, with indices first_index, first_index + 1, ...: the keys
// are packed back to back first, so the file is phix_build's over them.
int phix_build_members(const char* path, const char* keys, const uint64_t* offs,
                       const uint32_t* lens, const uint64_t* members, uint64_t n,
                       uint32_t first_index) {
  std::vector<uint64_t> poffs(n);
  std::vector<uint32_t> plens(n), pidx(n);
  uint64_t total = 0;
  for (uint64_t i = 0; i < n; ++i) {
    poffs[i] = total;
    plens[i] = lens[members[i]];
    pidx[i] = first_index + static_cast<uint32_t>(i);
    total += plens[i];
  }
  std::vector<char> packed(total);
  for (uint64_t i = 0; i < n; ++i) {
    if (plens[i]) memcpy(packed.data() + poffs[i], keys + offs[members[i]], plens[i]);
  }
  return phix_build(path, packed.data(), poffs.data(), plens.data(), pidx.data(), n);
}

void phix_close(void* handle) {
  Store* s = static_cast<Store*>(handle);
  munmap(s->map, s->map_len);
  delete s;
}

}  // extern "C"
