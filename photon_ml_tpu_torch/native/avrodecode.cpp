// Columnar Avro record decoder for the training-data hot path.
//
// The reference reads TrainingExampleAvro through Spark's JVM Avro readers;
// this framework's portable fallback is the pure-Python codec in
// io/avro.py (~2e4 records/s). This decoder walks the SAME binary record
// stream natively and emits columnar buffers — numeric columns, string
// columns (arena + offsets), and per-bag feature streams whose keys
// ("name\x01term", the index-map key format) land in one byte arena — so
// Python touches O(unique features) strings instead of O(nnz).
//
// The schema is compiled (in Python, io/native_reader.py) to a flat field
// program; anything outside the supported shapes falls back to the Python
// codec. Supported field shapes, matching every schema in io/schemas.py:
//   double | float | long | int | boolean | string | bytes
//   union [null, X] / [X, null] of the above
//   array<record{name:string, term:string, value:double}>   (feature bags)
//   map<string>                                              (metadataMap)
//
// C ABI only (ctypes); no exceptions across the boundary. Bounds-checked:
// malformed input yields a null handle, never UB.

#include <algorithm>
#include <cstdint>
#include <memory>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

#include <zlib.h>

namespace {

enum Kind {
  K_DOUBLE = 0,
  K_FLOAT = 1,
  K_LONG = 2,
  K_INT = 3,
  K_BOOL = 4,
  K_STRING = 5,
  K_BYTES = 6,
  K_FEATURES = 7,
  K_STRMAP = 8,
};

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  int64_t read_long() {
    uint64_t acc = 0;
    int shift = 0;
    while (true) {
      if (p >= end || shift > 63) {
        ok = false;
        return 0;
      }
      uint8_t b = *p++;
      acc |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
    }
    return static_cast<int64_t>(acc >> 1) ^ -static_cast<int64_t>(acc & 1);
  }

  double read_double() {
    if (end - p < 8) {
      ok = false;
      return 0.0;
    }
    double v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }

  float read_float() {
    if (end - p < 4) {
      ok = false;
      return 0.0f;
    }
    float v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }

  // Returns (offset into buffer, length); content stays in the input.
  std::string_view read_str() {
    int64_t n = read_long();
    if (!ok || n < 0 || end - p < n) {
      ok = false;
      return {};
    }
    std::string_view sv(reinterpret_cast<const char*>(p),
                        static_cast<size_t>(n));
    p += n;
    return sv;
  }

  bool read_bool() {
    if (p >= end) {
      ok = false;
      return false;
    }
    return *p++ != 0;
  }
};

struct StrCol {
  std::vector<int64_t> off;
  std::vector<int32_t> len;  // -1 = absent
};

struct Bag {
  std::vector<int32_t> rec;
  std::vector<float> val;
  std::vector<int64_t> key_off;
  std::vector<int32_t> key_len;
};

struct Result {
  int64_t n_rows = 0;
  std::vector<std::vector<double>> num_cols;
  std::vector<std::vector<uint8_t>> num_present;
  std::vector<StrCol> str_cols;
  std::vector<uint8_t> str_arena;
  std::vector<Bag> bags;
  std::vector<uint8_t> key_arena;
};

void append_str(Result& r, int32_t col, std::string_view sv) {
  r.str_cols[col].off.push_back(static_cast<int64_t>(r.str_arena.size()));
  r.str_cols[col].len.push_back(static_cast<int32_t>(sv.size()));
  r.str_arena.insert(r.str_arena.end(), sv.begin(), sv.end());
}

void append_absent(Result& r, int32_t col) {
  r.str_cols[col].off.push_back(0);
  r.str_cols[col].len.push_back(-1);
}

// Raw-deflate (Avro "deflate" codec: no zlib header, windowBits -15) one
// payload, appending to `out`. Returns false on any corruption.
bool inflate_raw(const uint8_t* src, int64_t len, std::vector<uint8_t>& out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(len);
  int ret = Z_OK;
  bool good = true;
  while (ret != Z_STREAM_END) {
    size_t old = out.size();
    size_t grow = std::max<size_t>(static_cast<size_t>(len) * 3 + 4096,
                                   size_t{1} << 16);
    out.resize(old + grow);
    zs.next_out = out.data() + old;
    zs.avail_out = static_cast<uInt>(grow);
    ret = inflate(&zs, Z_NO_FLUSH);
    out.resize(old + grow - zs.avail_out);
    if (ret == Z_STREAM_END) break;
    if (ret == Z_OK) continue;
    // Z_BUF_ERROR with output space left means the input ran dry
    // (truncated payload); everything else is corruption
    good = false;
    break;
  }
  inflateEnd(&zs);
  return good;
}

}  // namespace

extern "C" {

// program: n_fields * 3 int32s — (kind, nullmode, capture).
//   nullmode: 0 = plain, 1 = union with null as branch 0, 2 = null branch 1.
//   capture: kinds 0-4 -> numeric column id; 5-6 -> string column id;
//            7 -> bag id; 8 ignored (tags define string columns
//            tag_col_base + i). -1 = skip.
// tags: concatenated tag key bytes with lengths; matched map entries are
// captured into string columns tag_col_base..tag_col_base+n_tags-1.
static void* avro_decode_impl(const uint8_t* buf, int64_t len,
                              int64_t n_records, const int32_t* program,
                              int32_t n_fields, int32_t n_num_cols,
                              int32_t n_str_cols, int32_t n_bags,
                              const uint8_t* tag_bytes,
                              const int32_t* tag_lens, int32_t n_tags,
                              int32_t tag_col_base) {
  // A record is at least one byte, so a count beyond the payload size is
  // corrupt; rejecting here also bounds the reserve() below.
  if (n_records < 0 || n_records > len) return nullptr;
  // unique_ptr so a mid-decode bad_alloc (huge corrupt payloads) unwinds
  // the partially-built result instead of leaking it past the catch
  auto res_owner = std::make_unique<Result>();
  Result* res = res_owner.get();
  res->num_cols.resize(n_num_cols);
  res->num_present.resize(n_num_cols);
  for (auto& c : res->num_cols) c.reserve(n_records);
  for (auto& c : res->num_present) c.reserve(n_records);
  res->str_cols.resize(n_str_cols);
  res->bags.resize(n_bags);

  std::vector<std::string_view> tags(n_tags);
  {
    int64_t off = 0;
    for (int32_t i = 0; i < n_tags; ++i) {
      tags[i] = std::string_view(reinterpret_cast<const char*>(tag_bytes) + off,
                                 static_cast<size_t>(tag_lens[i]));
      off += tag_lens[i];
    }
  }

  Cursor c{buf, buf + len};
  for (int64_t rec = 0; rec < n_records && c.ok; ++rec) {
    // per-record bookkeeping so absent nullable captures stay aligned
    std::vector<int8_t> num_seen(n_num_cols, 0);
    std::vector<int8_t> str_seen(n_str_cols, 0);

    for (int32_t f = 0; f < n_fields && c.ok; ++f) {
      int32_t kind = program[f * 3];
      int32_t nullmode = program[f * 3 + 1];
      int32_t capture = program[f * 3 + 2];
      bool absent = false;
      if (nullmode) {
        int64_t branch = c.read_long();
        if (!c.ok) break;
        int64_t null_branch = (nullmode == 1) ? 0 : 1;
        if (branch == null_branch) absent = true;
      }
      switch (kind) {
        case K_DOUBLE:
        case K_FLOAT:
        case K_LONG:
        case K_INT:
        case K_BOOL: {
          double v = 0.0;
          if (!absent) {
            if (kind == K_DOUBLE) v = c.read_double();
            else if (kind == K_FLOAT) v = c.read_float();
            else if (kind == K_BOOL) v = c.read_bool() ? 1.0 : 0.0;
            else v = static_cast<double>(c.read_long());
          }
          if (capture >= 0) {
            res->num_cols[capture].push_back(v);
            res->num_present[capture].push_back(absent ? 0 : 1);
            num_seen[capture] = 1;
          }
          break;
        }
        case K_STRING:
        case K_BYTES: {
          if (absent) {
            if (capture >= 0) {
              append_absent(*res, capture);
              str_seen[capture] = 1;
            }
            break;
          }
          std::string_view sv = c.read_str();
          if (!c.ok) break;
          if (capture >= 0) {
            append_str(*res, capture, sv);
            str_seen[capture] = 1;
          }
          break;
        }
        case K_FEATURES: {
          if (absent) break;
          Bag* bag = capture >= 0 ? &res->bags[capture] : nullptr;
          while (c.ok) {
            int64_t n = c.read_long();
            if (!c.ok || n == 0) break;
            if (n < 0) {
              n = -n;
              c.read_long();  // block byte size, unused
            }
            for (int64_t i = 0; i < n && c.ok; ++i) {
              std::string_view name = c.read_str();
              std::string_view term = c.read_str();
              double value = c.read_double();
              if (!c.ok) break;
              if (bag) {
                bag->rec.push_back(static_cast<int32_t>(rec));
                bag->val.push_back(static_cast<float>(value));
                bag->key_off.push_back(
                    static_cast<int64_t>(res->key_arena.size()));
                // index-map key: name, or name + '\x01' + term
                int32_t klen = static_cast<int32_t>(name.size());
                res->key_arena.insert(res->key_arena.end(), name.begin(),
                                      name.end());
                if (!term.empty()) {
                  res->key_arena.push_back(0x01);
                  res->key_arena.insert(res->key_arena.end(), term.begin(),
                                        term.end());
                  klen += 1 + static_cast<int32_t>(term.size());
                }
                bag->key_len.push_back(klen);
              }
            }
          }
          break;
        }
        case K_STRMAP: {
          if (absent) break;
          const bool match_tags = capture >= 0;
          while (c.ok) {
            int64_t n = c.read_long();
            if (!c.ok || n == 0) break;
            if (n < 0) {
              n = -n;
              c.read_long();
            }
            for (int64_t i = 0; i < n && c.ok; ++i) {
              std::string_view key = c.read_str();
              std::string_view val = c.read_str();
              if (!c.ok) break;
              if (!match_tags) continue;
              for (int32_t t = 0; t < n_tags; ++t) {
                if (key == tags[t]) {
                  int32_t col = tag_col_base + t;
                  if (str_seen[col]) {  // duplicate key: last wins
                    res->str_cols[col].off.pop_back();
                    res->str_cols[col].len.pop_back();
                  }
                  append_str(*res, col, val);
                  str_seen[col] = 1;
                }
              }
            }
          }
          break;
        }
        default:
          c.ok = false;
      }
    }
    if (!c.ok) break;
    // align every captured column to rec+1 entries
    for (int32_t i = 0; i < n_num_cols; ++i) {
      if (!num_seen[i]) {
        res->num_cols[i].push_back(0.0);
        res->num_present[i].push_back(0);
      }
    }
    for (int32_t i = 0; i < n_str_cols; ++i) {
      if (!str_seen[i]) append_absent(*res, i);
    }
    res->n_rows = rec + 1;
  }
  if (!c.ok || res->n_rows != n_records) {
    return nullptr;
  }
  return res_owner.release();
}

void* avro_decode(const uint8_t* buf, int64_t len, int64_t n_records,
                  const int32_t* program, int32_t n_fields,
                  int32_t n_num_cols, int32_t n_str_cols, int32_t n_bags,
                  const uint8_t* tag_bytes, const int32_t* tag_lens,
                  int32_t n_tags, int32_t tag_col_base) {
  // No exception may cross the C ABI: corrupt counts can still drive
  // allocations past memory; surface that as a null handle, not terminate.
  try {
    return avro_decode_impl(buf, len, n_records, program, n_fields,
                            n_num_cols, n_str_cols, n_bags, tag_bytes,
                            tag_lens, n_tags, tag_col_base);
  } catch (...) {
    return nullptr;
  }
}

// Whole-file fast path: inflate + columnar-decode in ONE native call.
//
// `file_buf` is the raw container file; (p_off[i], p_len[i]) frame payload
// i (p_count[i] records), `deflate` selects the Avro raw-deflate codec.
// Because ctypes releases the GIL for the duration of a foreign call, the
// ENTIRE inflate+decode window for a file runs GIL-free — decode-pool
// threads working on different files genuinely overlap, where the old
// path bounced through Python (zlib slice + b"".join) between payloads
// and serialized every worker on the interpreter lock.
void* avro_decode_packed(const uint8_t* file_buf, int64_t file_len,
                         const int64_t* p_off, const int64_t* p_len,
                         const int64_t* p_count, int32_t n_payloads,
                         int32_t deflate, const int32_t* program,
                         int32_t n_fields, int32_t n_num_cols,
                         int32_t n_str_cols, int32_t n_bags,
                         const uint8_t* tag_bytes, const int32_t* tag_lens,
                         int32_t n_tags, int32_t tag_col_base) {
  try {
    std::vector<uint8_t> blob;
    int64_t n_records = 0;
    int64_t total_payload = 0;
    for (int32_t i = 0; i < n_payloads; ++i) {
      if (p_off[i] < 0 || p_len[i] < 0 || p_count[i] < 0 ||
          p_off[i] + p_len[i] > file_len)
        return nullptr;
      n_records += p_count[i];
      total_payload += p_len[i];
    }
    blob.reserve(static_cast<size_t>(deflate ? total_payload * 3
                                             : total_payload));
    for (int32_t i = 0; i < n_payloads; ++i) {
      const uint8_t* src = file_buf + p_off[i];
      if (deflate) {
        if (!inflate_raw(src, p_len[i], blob)) return nullptr;
      } else {
        blob.insert(blob.end(), src, src + p_len[i]);
      }
    }
    return avro_decode_impl(blob.data(), static_cast<int64_t>(blob.size()),
                            n_records, program, n_fields, n_num_cols,
                            n_str_cols, n_bags, tag_bytes, tag_lens, n_tags,
                            tag_col_base);
  } catch (...) {
    return nullptr;
  }
}

int64_t res_n_rows(void* h) { return static_cast<Result*>(h)->n_rows; }

const double* res_num_col(void* h, int32_t i) {
  return static_cast<Result*>(h)->num_cols[i].data();
}
const uint8_t* res_num_present(void* h, int32_t i) {
  return static_cast<Result*>(h)->num_present[i].data();
}
const uint8_t* res_str_arena(void* h, int64_t* len) {
  auto* r = static_cast<Result*>(h);
  *len = static_cast<int64_t>(r->str_arena.size());
  return r->str_arena.data();
}
const int64_t* res_str_off(void* h, int32_t i) {
  return static_cast<Result*>(h)->str_cols[i].off.data();
}
const int32_t* res_str_len(void* h, int32_t i) {
  return static_cast<Result*>(h)->str_cols[i].len.data();
}
int64_t res_bag_count(void* h, int32_t b) {
  return static_cast<int64_t>(static_cast<Result*>(h)->bags[b].rec.size());
}
const int32_t* res_bag_rec(void* h, int32_t b) {
  return static_cast<Result*>(h)->bags[b].rec.data();
}
const float* res_bag_val(void* h, int32_t b) {
  return static_cast<Result*>(h)->bags[b].val.data();
}
const int64_t* res_bag_key_off(void* h, int32_t b) {
  return static_cast<Result*>(h)->bags[b].key_off.data();
}
const int32_t* res_bag_key_len(void* h, int32_t b) {
  return static_cast<Result*>(h)->bags[b].key_len.data();
}
const uint8_t* res_key_arena(void* h, int64_t* len) {
  auto* r = static_cast<Result*>(h);
  *len = static_cast<int64_t>(r->key_arena.size());
  return r->key_arena.data();
}
void res_free(void* h) { delete static_cast<Result*>(h); }

// ---- key dedup: ids[i] = dense id of key i; unique keys listed by first
// appearance (the same order DefaultIndexMap assigns) ----

struct Dedup {
  std::vector<int32_t> ids;
  std::vector<int64_t> u_off;
  std::vector<int32_t> u_len;
};

void* key_dedup(const uint8_t* arena, const int64_t* offs,
                const int32_t* lens, int64_t n) {
  auto* d = new Dedup();
  d->ids.resize(n);
  std::unordered_map<std::string_view, int32_t> seen;
  seen.reserve(static_cast<size_t>(n) / 4 + 16);
  for (int64_t i = 0; i < n; ++i) {
    std::string_view sv(reinterpret_cast<const char*>(arena) + offs[i],
                        static_cast<size_t>(lens[i]));
    auto it = seen.find(sv);
    if (it == seen.end()) {
      int32_t id = static_cast<int32_t>(d->u_off.size());
      seen.emplace(sv, id);
      d->u_off.push_back(offs[i]);
      d->u_len.push_back(lens[i]);
      d->ids[i] = id;
    } else {
      d->ids[i] = it->second;
    }
  }
  return d;
}

int64_t dedup_n_unique(void* h) {
  return static_cast<int64_t>(static_cast<Dedup*>(h)->u_off.size());
}
const int32_t* dedup_ids(void* h) { return static_cast<Dedup*>(h)->ids.data(); }
const int64_t* dedup_u_off(void* h) {
  return static_cast<Dedup*>(h)->u_off.data();
}
const int32_t* dedup_u_len(void* h) {
  return static_cast<Dedup*>(h)->u_len.data();
}
void dedup_free(void* h) { delete static_cast<Dedup*>(h); }

}  // extern "C"
