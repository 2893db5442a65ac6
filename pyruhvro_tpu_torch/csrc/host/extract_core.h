// Copy of pyruhvro_tpu/runtime/native/extract_core.h, unchanged but for a
// comment that cited the reference's own issue numbers.
//
// Arrow-native encode extraction: walk a RecordBatch's buffers through
// the Arrow C data interface and emit the encode VM's plan-buffer
// layout directly — no Python/numpy per-path materialization between
// the Arrow memory and the wire writer (Zerrow-style
// zero-copy discipline, arxiv 2504.06151).
//
// Shared (header-only) between the generic extractor module
// (extract.cpp, table-driven over any HostProgram) and the
// schema-SPECIALIZED modules hostpath/specialize.py generates (which
// embed their opcode + aux tables as static data and fuse this
// extraction with their straight-line encoder in one GIL-released
// call). The walk mirrors ops/encode.py run_extractor(host_mode=True)
// node for node; anything outside the supported surface returns a
// FALLBACK status and the Python extractor serves the call, so the
// native lane can only ever be a fast path, never a behavior change.
//
// Offset semantics follow Arrow C++'s importer: a struct/union child is
// element-aligned with its parent's PHYSICAL start, so the parent's
// accumulated logical offset is added when indexing children; list/map
// offsets index the child's logical elements (child's own offset
// applies, the parent's does not).
#ifndef PYRUHVRO_EXTRACT_CORE_H_
#define PYRUHVRO_EXTRACT_CORE_H_

#include "host_vm_core.h"

#include <chrono>
#include <cstdio>
#include <cstring>
#include <deque>
#include <string>
#include <vector>

namespace pyr {

// ---- Arrow C data interface ABI (stable layout per the Arrow spec) ---
struct ArrowSchemaC {
  const char* format;
  const char* name;
  const char* metadata;
  int64_t flags;
  int64_t n_children;
  ArrowSchemaC** children;
  ArrowSchemaC* dictionary;
  void (*release)(ArrowSchemaC*);
  void* private_data;
};

struct ArrowArrayC {
  int64_t length;
  int64_t null_count;
  int64_t offset;
  int64_t n_buffers;
  int64_t n_children;
  const void** buffers;
  ArrowArrayC** children;
  ArrowArrayC* dictionary;
  void (*release)(ArrowArrayC*);
  void* private_data;
};

// Takes ownership of the exported pair (the C-data "move": copy the
// structs, then mark the source released) and releases at scope exit.
struct ArrowOwner {
  ArrowArrayC arr{};
  ArrowSchemaC sch{};
  bool have_a = false, have_s = false;
  void adopt(uintptr_t addr_arr, uintptr_t addr_sch) {
    ArrowArrayC* a = reinterpret_cast<ArrowArrayC*>(addr_arr);
    ArrowSchemaC* s = reinterpret_cast<ArrowSchemaC*>(addr_sch);
    arr = *a;
    sch = *s;
    a->release = nullptr;
    s->release = nullptr;
    have_a = arr.release != nullptr;
    have_s = sch.release != nullptr;
  }
  ~ArrowOwner() {
    if (have_a && arr.release) arr.release(&arr);
    if (have_s && sch.release) sch.release(&sch);
  }
};

// ---- per-op auxiliary info the opcode table cannot carry -------------
enum AuxLane : int8_t {
  AUX_NONE = 0,
  AUX_UUID = 1,      // OP_STRING with uuid logical (Arrow w:16 → text)
  AUX_DURATION = 2,  // OP_FIXED duration (Arrow tDm → 12B wire triple)
  AUX_ENUM = 3,      // OP_ENUM: symbol table for utf8 → index matching
  AUX_BINARY = 4,    // OP_STRING that is Avro bytes (no UTF-8 contract)
  AUX_DECIMAL = 5,   // OP_DEC_*: declared precision (in ``nsyms``)
};

struct OpAux {
  int8_t lane = AUX_NONE;
  const char* const* syms = nullptr;  // AUX_ENUM: utf8 symbol bytes
  const int32_t* symlens = nullptr;
  int32_t nsyms = 0;                  // AUX_ENUM: count; AUX_DECIMAL: precision
};

// Parsed aux tables (the Python ``op_aux`` tuple — one entry per op:
// None, ("uuid",), ("binary",), ("duration",), ("decimal", precision)
// or ("enum", symbol_bytes...)). Symbol bytes are BORROWED from the aux
// tuple, which the caller keeps alive for the duration of the call.
// Shared by the generic extractor module (extract.cpp) and the generic
// fused-decode entry (host_codec.cpp); specialized modules embed their
// tables as static data instead.
struct AuxTables {
  std::vector<OpAux> aux;
  std::vector<std::vector<const char*>> syms;
  std::vector<std::vector<int32_t>> symlens;

  bool parse(PyObject* aux_obj, size_t nops) {
    aux.resize(nops);
    syms.resize(nops);
    symlens.resize(nops);
    if (aux_obj == Py_None) return true;
    if (!PyTuple_Check(aux_obj) || (size_t)PyTuple_GET_SIZE(aux_obj) != nops) {
      PyErr_SetString(PyExc_ValueError, "aux must be a tuple of len(ops)");
      return false;
    }
    for (size_t i = 0; i < nops; i++) {
      PyObject* e = PyTuple_GET_ITEM(aux_obj, i);
      if (e == Py_None) continue;
      if (!PyTuple_Check(e) || PyTuple_GET_SIZE(e) < 1) {
        PyErr_SetString(PyExc_ValueError, "bad aux entry");
        return false;
      }
      PyObject* tag = PyTuple_GET_ITEM(e, 0);
      const char* t = PyUnicode_AsUTF8(tag);
      if (t == nullptr) return false;
      if (std::strcmp(t, "uuid") == 0) {
        aux[i].lane = AUX_UUID;
      } else if (std::strcmp(t, "binary") == 0) {
        aux[i].lane = AUX_BINARY;
      } else if (std::strcmp(t, "duration") == 0) {
        aux[i].lane = AUX_DURATION;
      } else if (std::strcmp(t, "decimal") == 0) {
        aux[i].lane = AUX_DECIMAL;
        if (PyTuple_GET_SIZE(e) < 2) {
          PyErr_SetString(PyExc_ValueError, "decimal aux needs precision");
          return false;
        }
        long prec = PyLong_AsLong(PyTuple_GET_ITEM(e, 1));
        if (PyErr_Occurred()) return false;
        aux[i].nsyms = (int32_t)prec;
      } else if (std::strcmp(t, "enum") == 0) {
        aux[i].lane = AUX_ENUM;
        Py_ssize_t ns = PyTuple_GET_SIZE(e) - 1;
        for (Py_ssize_t k = 0; k < ns; k++) {
          PyObject* sb = PyTuple_GET_ITEM(e, (Py_ssize_t)(k + 1));
          if (!PyBytes_Check(sb)) {
            PyErr_SetString(PyExc_ValueError, "enum symbols must be bytes");
            return false;
          }
          syms[i].push_back(PyBytes_AS_STRING(sb));
          symlens[i].push_back((int32_t)PyBytes_GET_SIZE(sb));
        }
        aux[i].syms = syms[i].data();
        aux[i].symlens = symlens[i].data();
        aux[i].nsyms = (int32_t)syms[i].size();
      } else {
        PyErr_Format(PyExc_ValueError, "unknown aux tag %s", t);
        return false;
      }
    }
    return true;
  }
};

// ---- extraction output -----------------------------------------------

// One plan buffer: borrowed zero-copy from the Arrow buffers where the
// layouts already agree (#v64 values, string bodies, #dec words, #fix
// runs) or owned when computed (#valid, #len, #count, #tid, bools,
// enum indices, uuid text). Owned storage must never move after the
// pointer is taken — outs is pre-sized once, never resized.
struct OutBuf {
  const void* ptr = nullptr;
  size_t nbytes = 0;
  std::vector<uint8_t> own;

  inline void borrow(const void* p, size_t n) {
    ptr = p;
    nbytes = n;
  }
  inline uint8_t* alloc(size_t n) {
    own.resize(n);
    ptr = own.data();
    nbytes = n;
    return own.data();
  }
};

enum ExtractStatus : int {
  EXTRACT_OK = 0,
  // schema/arrow shape outside the native surface: Python extractor
  // serves the call (counted as extract.fallback)
  EXTRACT_FALLBACK = 1,
  // a data error the Python extractor reports with a precise message
  // (null at a non-nullable position, unknown enum symbol, union
  // type_id out of range, duration component overflow): Python re-runs
  // its extractor to raise exactly
  EXTRACT_DATA_ERROR = 2,
};

// One Arrow node with its resolved logical window: ``pos`` is the
// absolute element index into the node's buffers (offset + accumulated
// struct/union parent offsets), ``len`` the window length.
struct AView {
  const ArrowArrayC* a;
  const ArrowSchemaC* s;
  int64_t pos;
  int64_t len;
};

inline bool fmt_eq(const char* f, const char* want) {
  return f != nullptr && std::strcmp(f, want) == 0;
}

inline bool fmt_pre(const char* f, const char* pre) {
  return f != nullptr && std::strncmp(f, pre, std::strlen(pre)) == 0;
}

class ArrowExtractor {
 public:
  ArrowExtractor(const Op* ops, const OpAux* aux, const int32_t* coltypes,
                 size_t ncols)
      : ops_(ops), aux_(aux) {
    slot_.resize(ncols);
    size_t pos = 0;
    for (size_t c = 0; c < ncols; c++) {
      slot_[c] = pos;
      pos += coltypes[c] == COL_STR ? 2 : 1;
    }
    outs.resize(pos);
  }

  std::vector<OutBuf> outs;
  int64_t bound = 0;
  int status = EXTRACT_OK;

  // Walk the subtree at ``pc`` against the Arrow node ``v``; returns
  // the pc past the subtree. ``parent`` is the live-lane mask over the
  // window (nullptr = all live). Mirrors _Extractor.extract().
  size_t walk(size_t pc, AView v, const uint8_t* parent) {
    const Op& op = ops_[pc];
    if (status != EXTRACT_OK) return pc + op.nops;
    PYR_PROF_OP(pyr::prof::DOM_EXT, op.kind);
    const char* f = v.s->format;
    switch (op.kind) {
      case OP_NULLABLE: {
        // ["null", T]: validity of THIS node → #valid, inner on the
        // same node with the chain narrowed
        uint8_t* vbuf = out(op.col, 0).alloc((size_t)v.len);
        fill_valid(v, vbuf);
        bound += v.len;
        const uint8_t* sub = and_mask(vbuf, parent, v.len);
        return walk(pc + 1, v, sub);
      }
      case OP_RECORD: {
        if (!fmt_eq(f, "+s")) return fail(pc);
        if (!require_valid(v, parent)) return pc + op.nops;
        size_t p = pc + 1, stop = pc + op.nops;
        int64_t ci = 0;
        while (p < stop) {
          if (ci >= v.a->n_children) return fail(pc);
          p = walk(p, child_of(v, ci), parent);
          ci++;
          if (status != EXTRACT_OK) return stop;
        }
        if (ci != v.a->n_children) return fail(pc);
        return p;
      }
      case OP_INT: {
        if (!(fmt_eq(f, "i") || fmt_eq(f, "tdD") || fmt_eq(f, "ttm")))
          return fail(pc);
        if (!require_valid(v, parent)) return pc + 1;
        borrow_fixed(op.col, v, 4);
        bound += 5 * v.len;
        return pc + 1;
      }
      case OP_LONG: {
        if (!(fmt_eq(f, "l") || fmt_pre(f, "ts") || fmt_eq(f, "ttu") ||
              fmt_eq(f, "ttn")))
          return fail(pc);
        if (!require_valid(v, parent)) return pc + 1;
        borrow_fixed(op.col, v, 8);
        bound += 10 * v.len;
        return pc + 1;
      }
      case OP_FLOAT: {
        if (!fmt_eq(f, "f")) return fail(pc);
        if (!require_valid(v, parent)) return pc + 1;
        borrow_fixed(op.col, v, 4);
        bound += 4 * v.len;
        return pc + 1;
      }
      case OP_DOUBLE: {
        if (!fmt_eq(f, "g")) return fail(pc);
        if (!require_valid(v, parent)) return pc + 1;
        borrow_fixed(op.col, v, 8);
        bound += 8 * v.len;
        return pc + 1;
      }
      case OP_BOOL: {
        if (!fmt_eq(f, "b")) return fail(pc);
        if (!require_valid(v, parent)) return pc + 1;
        uint8_t* o = out(op.col, 0).alloc((size_t)v.len);
        const uint8_t* bits = buf8(v, 1);
        const uint8_t* valid = v.a->n_buffers > 0 ? buf8(v, 0) : nullptr;
        if (!has_nulls(v)) valid = nullptr;
        for (int64_t i = 0; i < v.len; i++) {
          uint8_t b = bits ? bit_at(bits, v.pos + i) : 0;
          // match the Python path's fill_null(0): a null slot reads 0
          if (valid && !bit_at(valid, v.pos + i)) b = 0;
          o[i] = b;
        }
        bound += v.len;
        return pc + 1;
      }
      case OP_STRING: {
        bool uuid = aux_ != nullptr && aux_[pc].lane == AUX_UUID;
        if (uuid) {
          if (!fmt_eq(f, "w:16")) return fail(pc);
          if (!require_valid(v, parent)) return pc + 1;
          extract_uuid(op.col, v);
          return pc + 1;
        }
        if (!(fmt_eq(f, "u") || fmt_eq(f, "z"))) return fail(pc);
        if (!require_valid(v, parent)) return pc + 1;
        extract_string(op.col, v);
        return pc + 1;
      }
      case OP_ENUM: {
        if (!fmt_eq(f, "u")) return fail(pc);
        if (aux_ == nullptr || aux_[pc].lane != AUX_ENUM) return fail(pc);
        if (!require_valid(v, parent)) return pc + 1;
        extract_enum(op.col, v, aux_[pc], parent);
        bound += 5 * v.len;
        return pc + 1;
      }
      case OP_FIXED: {
        if (aux_ != nullptr && aux_[pc].lane == AUX_DURATION) {
          if (!fmt_eq(f, "tDm")) return fail(pc);
          if (!require_valid(v, parent)) return pc + 1;
          extract_duration(op.col, v, parent);
          bound += 12 * v.len;
          return pc + 1;
        }
        char want[16];
        std::snprintf(want, sizeof(want), "w:%d", (int)op.a);
        if (!fmt_eq(f, want)) return fail(pc);
        if (!require_valid(v, parent)) return pc + 1;
        borrow_fixed(op.col, v, (size_t)op.a);
        bound += (int64_t)op.a * v.len;
        return pc + 1;
      }
      case OP_DEC_BYTES:
      case OP_DEC_FIXED: {
        // "d:p,s" = decimal128; a third component means another width
        if (!fmt_pre(f, "d:")) return fail(pc);
        int commas = 0;
        for (const char* q = f; *q; q++) commas += *q == ',';
        if (commas != 1) return fail(pc);
        if (!require_valid(v, parent)) return pc + op.nops;
        borrow_fixed(op.col, v, 16);
        bound += 18 * v.len;
        return pc + 1;
      }
      case OP_UNION: {
        if (!fmt_pre(f, "+us:")) return fail(pc);
        if (!union_codes_canonical(f + 4, op.a)) return fail(pc);
        if (v.a->n_children != op.a) return fail(pc);
        if (!require_valid(v, parent)) return pc + op.nops;
        const int8_t* tids8 =
            static_cast<const int8_t*>(v.a->n_buffers > 0 ? v.a->buffers[0]
                                                          : nullptr);
        int32_t* tids =
            reinterpret_cast<int32_t*>(out(op.col, 0).alloc(4 * v.len));
        for (int64_t i = 0; i < v.len; i++) {
          int32_t t = tids8 ? (int32_t)tids8[v.pos + i] : 0;
          if ((t < 0 || t >= op.a) && live(parent, i)) {
            status = EXTRACT_DATA_ERROR;  // ValueError: type_id range
            return pc + op.nops;
          }
          tids[i] = t;
        }
        bound += 5 * v.len;
        size_t p = pc + 1;
        for (int32_t k = 0; k < op.a; k++) {
          const Op& arm = ops_[p];
          if (arm.kind == OP_NULL) {
            p += 1;
            continue;
          }
          uint8_t* sel = arena_alloc(v.len);
          for (int64_t i = 0; i < v.len; i++)
            sel[i] = (uint8_t)(tids[i] == k && live(parent, i));
          p = walk(p, child_of(v, k), sel);
          if (status != EXTRACT_OK) return pc + op.nops;
        }
        return p;
      }
      case OP_ARRAY: {
        if (!fmt_eq(f, "+l")) return fail(pc);
        if (!require_valid(v, parent)) return pc + op.nops;
        int64_t o0, oN;
        extract_counts(op.col, v, &o0, &oN);
        bound += 7 * v.len;
        const uint8_t* ip = item_parent(v, parent, o0, oN);
        if (status != EXTRACT_OK) return pc + op.nops;
        AView items = list_child(v, 0, o0, oN);
        return walk(pc + 1, items, ip);
      }
      case OP_MAP: {
        if (!fmt_eq(f, "+m")) return fail(pc);
        if (v.a->n_children != 1) return fail(pc);
        if (!require_valid(v, parent)) return pc + op.nops;
        int64_t o0, oN;
        extract_counts(op.col, v, &o0, &oN);
        bound += 7 * v.len;
        const uint8_t* ip = item_parent(v, parent, o0, oN);
        if (status != EXTRACT_OK) return pc + op.nops;
        // entries struct, element-aligned with the offsets window
        const ArrowArrayC* ent = v.a->children[0];
        const ArrowSchemaC* ent_s = v.s->children[0];
        if (!fmt_eq(ent_s->format, "+s") || ent->n_children != 2)
          return fail(pc);
        AView entries{ent, ent_s, ent->offset + o0, oN - o0};
        AView keys = child_of(entries, 0);
        if (!fmt_eq(keys.s->format, "u")) return fail(pc);
        if (!require_valid(keys, ip)) return pc + op.nops;
        extract_string(op.b, keys);
        if (status != EXTRACT_OK) return pc + op.nops;
        AView vals = child_of(entries, 1);
        return walk(pc + 1, vals, ip);
      }
      case OP_NULL:
      default:
        // a bare null-type field (or an op this walker does not know):
        // let the Python extractor decide — it owns those semantics
        return fail(pc);
    }
  }

 private:
  const Op* ops_;
  const OpAux* aux_;
  std::vector<size_t> slot_;
  std::deque<std::vector<uint8_t>> arena_;  // stable storage for masks

  inline OutBuf& out(int32_t col, int which) {
    return outs[slot_[(size_t)col] + (size_t)which];
  }

  inline size_t fail(size_t pc) {
    status = EXTRACT_FALLBACK;
    return pc + ops_[pc].nops;
  }

  inline uint8_t* arena_alloc(int64_t n) {
    arena_.emplace_back((size_t)n);
    return arena_.back().data();
  }

  static inline bool live(const uint8_t* parent, int64_t i) {
    return parent == nullptr || parent[i] != 0;
  }

  static inline uint8_t bit_at(const uint8_t* bits, int64_t i) {
    return (bits[i >> 3] >> (i & 7)) & 1;
  }

  inline const uint8_t* buf8(const AView& v, int idx) const {
    if (idx >= v.a->n_buffers) return nullptr;
    return static_cast<const uint8_t*>(v.a->buffers[idx]);
  }

  inline bool has_nulls(const AView& v) const {
    if (v.a->null_count == 0) return false;
    return v.a->n_buffers > 0 && v.a->buffers[0] != nullptr;
  }

  // Child of a struct/sparse-union: element-aligned with the parent's
  // physical start (Arrow C++ import semantics), so the parent's
  // resolved pos accumulates into the child's.
  inline AView child_of(const AView& v, int64_t k) const {
    const ArrowArrayC* c = v.a->children[k];
    return AView{c, v.s->children[k], c->offset + v.pos, v.len};
  }

  inline AView list_child(const AView& v, int64_t k, int64_t o0,
                          int64_t oN) const {
    const ArrowArrayC* c = v.a->children[k];
    return AView{c, v.s->children[k], c->offset + o0, oN - o0};
  }

  // 0/1 per window lane from the validity bitmap (1s when absent).
  inline void fill_valid(const AView& v, uint8_t* o) const {
    const uint8_t* bits = has_nulls(v) ? buf8(v, 0) : nullptr;
    if (bits == nullptr) {
      std::memset(o, 1, (size_t)v.len);
      return;
    }
    for (int64_t i = 0; i < v.len; i++) o[i] = bit_at(bits, v.pos + i);
  }

  inline const uint8_t* and_mask(const uint8_t* a, const uint8_t* b,
                                 int64_t n) {
    if (b == nullptr) return a;
    uint8_t* m = arena_alloc(n);
    for (int64_t i = 0; i < n; i++) m[i] = a[i] & b[i];
    return m;
  }

  // Error on nulls the encoder would actually read (≙ _require_valid:
  // ValueError "null value for non-nullable Avro position").
  inline bool require_valid(const AView& v, const uint8_t* parent) {
    if (!has_nulls(v)) return true;
    const uint8_t* bits = buf8(v, 0);
    for (int64_t i = 0; i < v.len; i++) {
      if (!bit_at(bits, v.pos + i) && live(parent, i)) {
        status = EXTRACT_DATA_ERROR;
        return false;
      }
    }
    return true;
  }

  inline void borrow_fixed(int32_t col, const AView& v, size_t width) {
    const uint8_t* p = buf8(v, 1);
    out(col, 0).borrow(p == nullptr ? nullptr : p + (size_t)v.pos * width,
                       p == nullptr ? 0 : (size_t)v.len * width);
    if (p == nullptr && v.len > 0) {
      // a missing values buffer is legal only for an all-null window;
      // the VM still consumes entries, so materialize zeros
      std::memset(out(col, 0).alloc((size_t)v.len * width), 0,
                  (size_t)v.len * width);
    }
  }

  // Utf8/Binary: #bytes = zero-copy window of the values buffer,
  // #len = one tight diff pass over the offsets.
  inline void extract_string(int32_t col, const AView& v) {
    const int32_t* offs =
        reinterpret_cast<const int32_t*>(buf8(v, 1));
    int32_t* lens = reinterpret_cast<int32_t*>(out(col, 1).alloc(4 * v.len));
    if (offs == nullptr) {
      std::memset(lens, 0, 4 * (size_t)v.len);
      out(col, 0).borrow(nullptr, 0);
      bound += 5 * v.len;
      return;
    }
    int64_t o0 = offs[v.pos], oN = offs[v.pos + v.len];
    const int32_t* w = offs + v.pos;
    for (int64_t i = 0; i < v.len; i++) lens[i] = w[i + 1] - w[i];
    const uint8_t* vals = buf8(v, 2);
    out(col, 0).borrow(vals == nullptr ? nullptr : vals + o0,
                       (size_t)(oN - o0));
    bound += 5 * v.len + (oN - o0);
  }

  // FixedSizeBinary(16) → canonical lowercase uuid text (the oracle's
  // str(UUID(bytes=v))) in the string column layout.
  inline void extract_uuid(int32_t col, const AView& v) {
    static const int kPos[32] = {0,  1,  2,  3,  4,  5,  6,  7,
                                 9,  10, 11, 12, 14, 15, 16, 17,
                                 19, 20, 21, 22, 24, 25, 26, 27,
                                 28, 29, 30, 31, 32, 33, 34, 35};
    static const char HC[] = "0123456789abcdef";
    uint8_t* o = out(col, 0).alloc((size_t)v.len * 36);
    int32_t* lens = reinterpret_cast<int32_t*>(out(col, 1).alloc(4 * v.len));
    const uint8_t* raw = buf8(v, 1);
    for (int64_t i = 0; i < v.len; i++) {
      lens[i] = 36;
      uint8_t* d = o + i * 36;
      d[8] = d[13] = d[18] = d[23] = '-';
      if (raw == nullptr) {
        for (int k = 0; k < 16; k++) {
          d[kPos[2 * k]] = '0';
          d[kPos[2 * k + 1]] = '0';
        }
        continue;
      }
      const uint8_t* sp = raw + (v.pos + i) * 16;
      for (int k = 0; k < 16; k++) {
        d[kPos[2 * k]] = (uint8_t)HC[sp[k] >> 4];
        d[kPos[2 * k + 1]] = (uint8_t)HC[sp[k] & 0xF];
      }
    }
    bound += 37 * v.len;
  }

  // Duration(ms) int64 → the wire's (months, days, ms) u32-LE triple
  // with the oracle's divmod arithmetic; component overflow is a
  // ValueError the Python extractor words precisely → DATA_ERROR.
  inline void extract_duration(int32_t col, const AView& v,
                               const uint8_t* parent) {
    const int64_t* ms64 = reinterpret_cast<const int64_t*>(buf8(v, 1));
    uint8_t* o = out(col, 0).alloc((size_t)v.len * 12);
    const uint8_t* bits = has_nulls(v) ? buf8(v, 0) : nullptr;
    for (int64_t i = 0; i < v.len; i++) {
      int64_t ms = ms64 ? ms64[v.pos + i] : 0;
      if (bits && !bit_at(bits, v.pos + i)) ms = 0;  // fill_null(0)
      // Python divmod semantics (floor) match C++ for ms >= 0; negative
      // totals floor-divide differently — defer those to Python
      int64_t days_total = ms / 86400000, ms_r = ms % 86400000;
      if (ms_r < 0) {
        days_total -= 1;
        ms_r += 86400000;
      }
      int64_t months = days_total / 30, days = days_total % 30;
      if (days < 0) {
        months -= 1;
        days += 30;
      }
      bool lv = live(parent, i) && (bits == nullptr || bit_at(bits, v.pos + i));
      if (lv && (months < 0 || months >= (1LL << 32) || days < 0 ||
                 days >= (1LL << 32) || ms_r < 0 || ms_r >= (1LL << 32))) {
        status = EXTRACT_DATA_ERROR;
        return;
      }
      uint32_t m32 = (uint32_t)months, d32 = (uint32_t)days,
               r32 = (uint32_t)ms_r;
      std::memcpy(o + i * 12, &m32, 4);
      std::memcpy(o + i * 12 + 4, &d32, 4);
      std::memcpy(o + i * 12 + 8, &r32, 4);
    }
  }

  // Utf8 → symbol index (≙ _extract_enum's vectorized match): missing
  // live symbols are a ValueError; dead lanes (nulls, masked arms)
  // render 0, byte-identical to the Python path.
  inline void extract_enum(int32_t col, const AView& v, const OpAux& aux,
                           const uint8_t* parent) {
    const int32_t* offs = reinterpret_cast<const int32_t*>(buf8(v, 1));
    const uint8_t* vals = buf8(v, 2);
    const uint8_t* bits = has_nulls(v) ? buf8(v, 0) : nullptr;
    int32_t* o = reinterpret_cast<int32_t*>(out(col, 0).alloc(4 * v.len));
    for (int64_t i = 0; i < v.len; i++) {
      int32_t idx = -1;
      if (offs != nullptr) {
        int32_t a = offs[v.pos + i], b = offs[v.pos + i + 1];
        int32_t L = b - a;
        for (int32_t k = 0; k < aux.nsyms; k++) {
          if (aux.symlens[k] != L) continue;
          if (L == 0 || std::memcmp(vals + a, aux.syms[k], (size_t)L) == 0) {
            idx = k;
            break;
          }
        }
      }
      bool valid_i = bits == nullptr || bit_at(bits, v.pos + i);
      if (idx < 0 && valid_i && live(parent, i)) {
        status = EXTRACT_DATA_ERROR;  // unknown symbol, worded by Python
        return;
      }
      if (!valid_i) idx = 0;  // null slots render 0 like the oracle
      o[i] = idx < 0 ? 0 : idx;
    }
  }

  // list/map offsets → per-row #count (diff in one pass); returns the
  // item window [o0, oN).
  inline void extract_counts(int32_t col, const AView& v, int64_t* o0,
                             int64_t* oN) {
    const int32_t* offs = reinterpret_cast<const int32_t*>(buf8(v, 1));
    int32_t* counts =
        reinterpret_cast<int32_t*>(out(col, 0).alloc(4 * v.len));
    if (offs == nullptr) {
      std::memset(counts, 0, 4 * (size_t)v.len);
      *o0 = *oN = 0;
      return;
    }
    const int32_t* w = offs + v.pos;
    for (int64_t i = 0; i < v.len; i++) counts[i] = w[i + 1] - w[i];
    *o0 = w[0];
    *oN = w[v.len];
  }

  // lift the row-live chain onto the item axis (repeat by counts);
  // nullptr parent with no row nulls stays nullptr (all live)
  inline const uint8_t* item_parent(const AView& v, const uint8_t* parent,
                                    int64_t o0, int64_t oN) {
    bool nulls = has_nulls(v);
    if (parent == nullptr && !nulls) return nullptr;
    const int32_t* offs = reinterpret_cast<const int32_t*>(buf8(v, 1));
    int64_t total = oN - o0;
    uint8_t* m = arena_alloc(total > 0 ? total : 1);
    const uint8_t* bits = nulls ? buf8(v, 0) : nullptr;
    for (int64_t i = 0; i < v.len; i++) {
      uint8_t lv = (uint8_t)(live(parent, i) &&
                             (bits == nullptr || bit_at(bits, v.pos + i)));
      if (offs == nullptr) continue;
      int64_t a = offs[v.pos + i] - o0, b = offs[v.pos + i + 1] - o0;
      for (int64_t j = a; j < b; j++) m[j] = lv;
    }
    return m;
  }

  inline bool union_codes_canonical(const char* codes, int32_t n) const {
    // expect "0,1,...,n-1"
    int32_t k = 0;
    const char* q = codes;
    while (*q) {
      char* endp;
      long id = std::strtol(q, &endp, 10);
      if (endp == q || id != k) return false;
      k++;
      q = endp;
      if (*q == ',') q++;
    }
    return k == n;
  }
};

// ---- plan buffers → InCol cursors (the encode VM's input) ------------

inline void fill_incols(const std::vector<OutBuf>& outs,
                        const int32_t* coltypes, size_t ncols,
                        std::vector<InCol>& cols) {
  cols.resize(ncols);
  size_t bi = 0;
  for (size_t c = 0; c < ncols; c++) {
    InCol& col = cols[c];
    if (coltypes[c] == COL_STR) {
      col.bytes = static_cast<const uint8_t*>(outs[bi].ptr);
      col.i32 = static_cast<const int32_t*>(outs[bi + 1].ptr);
      bi += 2;
    } else {
      const void* p = outs[bi].ptr;
      col.u8 = static_cast<const uint8_t*>(p);
      col.i32 = static_cast<const int32_t*>(p);
      col.i64 = static_cast<const int64_t*>(p);
      col.f32 = static_cast<const float*>(p);
      col.f64 = static_cast<const double*>(p);
      bi += 1;
    }
  }
}

// ---- sharded fused encode: the shard-runner fan-out ------------------
//
// Each shard runs its OWN extractor over a row window of the same
// adopted Arrow batch (a windowed root AView — exactly how a nonzero
// ArrowArray.offset is already handled) and encodes into a private
// VecWriter; the merge under the GIL is a blob concat + offsets rebase.
// Serial semantics are preserved exactly: the FIRST failing shard in
// row order reports (what a one-pass encode would have raised first),
// and checked mode verifies each shard's writer against its own
// extractor bound. Returned timings are per-shard busy SUMS (the
// callers' host.extract_native_s / host.encode_vm_s split measures
// work, not wall).
template <class Rec>
inline PyObject* encode_arrow_sharded(Rec rec, const Op* ops,
                                      const OpAux* aux,
                                      const int32_t* coltypes, size_t ncols,
                                      ArrowOwner& owner, Py_ssize_t n,
                                      int checked, int nt) {
  struct EncShard {
    int64_t a = 0, b = 0;
    int status = EXTRACT_OK;
    bool overflow = false, vm_err = false, oom = false;
    size_t over_by = 0;
    int64_t bound = 0;
    std::vector<uint8_t> out;
    std::vector<int32_t> sizes;  // shard-local offsets, leading 0
    double t_extract = 0.0, t_encode = 0.0, busy = 0.0;
  };
  std::vector<EncShard> shards((size_t)nt);
  int64_t per = n / nt;
  for (int t = 0; t < nt; t++) {
    shards[(size_t)t].a = per * t;
    shards[(size_t)t].b = t == nt - 1 ? (int64_t)n : per * (t + 1);
  }
  double wall0 = 0.0, wall1 = 0.0;
  Py_BEGIN_ALLOW_THREADS;
  wall0 = shard::now_s();
  shard::Pool::instance().run(nt, [&](int t) {
    EncShard& sh = shards[(size_t)t];  // distinct index per shard
    double s0 = shard::now_s();
    try {
      ArrowExtractor ex(ops, aux, coltypes, ncols);
      AView root{&owner.arr, &owner.sch, owner.arr.offset + sh.a,
                 sh.b - sh.a};
      double e0 = shard::now_s();
      ex.walk(0, root, nullptr);
      sh.t_extract = shard::now_s() - e0;
      sh.status = ex.status;
      sh.bound = ex.bound;
      if (sh.status == EXTRACT_OK) {
        std::vector<InCol> cols;
        fill_incols(ex.outs, coltypes, ncols, cols);
        Py_ssize_t ns = (Py_ssize_t)(sh.b - sh.a);
        sh.sizes.resize((size_t)ns + 1);
        try {  // best-effort presize; VecWriter grows if it misses
          sh.out.reserve((size_t)(sh.bound < 16 ? 16 : sh.bound));
        } catch (const std::bad_alloc&) {
        }
        VecWriter w{&sh.out};
        double c0 = shard::now_s();
        run_encode_t(rec, cols, w, ns, sh.sizes.data(), &sh.overflow,
                     &sh.vm_err);
        sh.t_encode = shard::now_s() - c0;
        if (checked && (int64_t)sh.out.size() > sh.bound)
          sh.over_by = sh.out.size() - (size_t)sh.bound;
      }
    } catch (const std::bad_alloc&) {
      sh.oom = true;
    }
    PYR_PROF_FLUSH();
    sh.busy = shard::now_s() - s0;
  });
  wall1 = shard::now_s();
  Py_END_ALLOW_THREADS;

  std::vector<double> busy((size_t)nt);
  double t_extract = 0.0, t_encode = 0.0;
  for (int t = 0; t < nt; t++) {
    busy[(size_t)t] = shards[(size_t)t].busy;
    t_extract += shards[(size_t)t].t_extract;
    t_encode += shards[(size_t)t].t_encode;
  }
  shard::Stats::instance().record(nt, wall1 - wall0, busy.data(), nt);

  for (auto& sh : shards) {  // first failure in row order = serial report
    if (sh.oom) {
      PyErr_NoMemory();
      return nullptr;
    }
    if (sh.status != EXTRACT_OK) return PyLong_FromLong(sh.status);
    if (sh.over_by != 0) {
      PyErr_Format(PyExc_RuntimeError,
                   "encode bound violated: writer overran the extractor's "
                   "%lld-byte bound by %zu bytes (PYRUHVRO_DEBUG_BOUNDS)",
                   (long long)sh.bound, sh.over_by);
      return nullptr;
    }
    if (sh.overflow || sh.vm_err) {
      PyErr_SetString(PyExc_OverflowError,
                      sh.overflow
                          ? "encoded batch exceeds int32 binary offsets"
                          : "decimal value does not fit its fixed size");
      return nullptr;
    }
  }

  int64_t total = 0;
  for (auto& sh : shards) total += (int64_t)sh.out.size();
  if (total > (int64_t)INT32_MAX) {
    PyErr_SetString(PyExc_OverflowError,
                    "encoded batch exceeds int32 binary offsets");
    return nullptr;
  }
  PyObject* blob = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)total);
  if (!blob) return nullptr;
  uint8_t* dst = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(blob));
  std::vector<int32_t> sizes;
  try {
    sizes.resize((size_t)n + 1);
  } catch (const std::bad_alloc&) {
    Py_DECREF(blob);
    PyErr_NoMemory();
    return nullptr;
  }
  sizes[0] = 0;
  int64_t base = 0;
  for (auto& sh : shards) {
    if (!sh.out.empty())
      std::memcpy(dst + base, sh.out.data(), sh.out.size());
    int64_t ns = sh.b - sh.a;
    for (int64_t i = 1; i <= ns; i++)
      sizes[(size_t)(sh.a + i)] = (int32_t)(base + sh.sizes[(size_t)i]);
    base += (int64_t)sh.out.size();
  }
  PyObject* szb = bytes_from(sizes.data(), sizes.size() * 4);
  if (!szb) {
    Py_DECREF(blob);
    return nullptr;
  }
  PyObject* res = Py_BuildValue("(OOdd)", blob, szb, t_extract, t_encode);
  Py_DECREF(blob);
  Py_DECREF(szb);
  return res;
}

// ---- fused boundary: extract + encode in one GIL-released call -------
//
// encode_arrow(…) -> (blob, offsets[n+1], t_extract_s, t_encode_s)
//                  | int status (EXTRACT_FALLBACK / EXTRACT_DATA_ERROR)
// The caller (hostpath/codec.py) maps an int result back onto the
// Python extractor path; timings feed the host.extract_native_s /
// host.encode_vm_s telemetry split. ``nshards > 1`` requests the
// sharded fan-out above (subject to pick_threads' rows-per-shard floor
// and the PYRUHVRO_TPU_SHARD_THREADS cap).
template <class Rec>
inline PyObject* encode_arrow_boundary(Rec rec, const Op* ops,
                                       const OpAux* aux,
                                       PyObject* coltypes_obj,
                                       uintptr_t addr_arr,
                                       uintptr_t addr_sch, Py_ssize_t n,
                                       int checked, int nshards = 1) {
  BufferGuard ct_b;
  if (!ct_b.acquire(coltypes_obj, "coltypes")) return nullptr;
  const int32_t* coltypes = static_cast<const int32_t*>(ct_b.view.buf);
  size_t ncols = (size_t)(ct_b.view.len / sizeof(int32_t));

  ArrowOwner owner;
  owner.adopt(addr_arr, addr_sch);
  if (owner.arr.length != n) {
    PyErr_SetString(PyExc_ValueError, "arrow length != row count");
    return nullptr;
  }

  if (nshards > 1) {
    int nt = pick_threads(n, nshards);
    int cap = shard::env_threads_cap();  // PYRUHVRO_TPU_SHARD_THREADS
    if (cap > 0 && nt > cap) nt = cap;
    if (nt > 1)
      return encode_arrow_sharded(rec, ops, aux, coltypes, ncols, owner, n,
                                  checked, nt);
  }

  ArrowExtractor ex(ops, aux, coltypes, ncols);
  AView root{&owner.arr, &owner.sch, owner.arr.offset, owner.arr.length};
  double t_extract = 0.0;
  Py_BEGIN_ALLOW_THREADS;
  auto t0 = std::chrono::steady_clock::now();
  ex.walk(0, root, nullptr);
  PYR_PROF_FLUSH();
  t_extract = std::chrono::duration<double>(
                  std::chrono::steady_clock::now() - t0)
                  .count();
  Py_END_ALLOW_THREADS;
  if (ex.status != EXTRACT_OK) return PyLong_FromLong(ex.status);

  std::vector<InCol> cols;
  std::vector<int32_t> sizes;
  try {
    fill_incols(ex.outs, coltypes, ncols, cols);
    sizes.resize((size_t)n + 1);  // Arrow offsets: n+1 slots, leading 0
  } catch (const std::bad_alloc&) {
    PyErr_NoMemory();
    return nullptr;
  }

  bool overflow = false, vm_err = false, bound_violated = false;
  size_t over_by = 0;
  double t_encode = 0.0;
  // same capacity policy as the buffer-fed boundary: the bound is a
  // strict upper bound → one eager allocation + unchecked stores; past
  // 1 GiB (or failed alloc) the capacity-checked vector writer runs
  PyObject* blob = nullptr;
  int64_t hint = ex.bound <= (int64_t)1 << 30 ? (ex.bound < 16 ? 16 : ex.bound)
                                              : 0;
  if (hint > 0) blob = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)hint);
  if (blob != nullptr) {
    uint8_t* base = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(blob));
    size_t endpos = 0;
    Py_BEGIN_ALLOW_THREADS;
    auto t0 = std::chrono::steady_clock::now();
    if (checked) {
      CheckedRawWriter w{base, base, base + hint};
      run_encode_t(rec, cols, w, n, sizes.data(), &overflow, &vm_err);
      bound_violated = w.over != 0;
      over_by = w.over;
      endpos = w.pos();
    } else {
      RawWriter w{base, base};
      run_encode_t(rec, cols, w, n, sizes.data(), &overflow, &vm_err);
      endpos = w.pos();
    }
    t_encode = std::chrono::duration<double>(
                   std::chrono::steady_clock::now() - t0)
                   .count();
    Py_END_ALLOW_THREADS;
    if (bound_violated) {
      Py_DECREF(blob);
      PyErr_Format(PyExc_RuntimeError,
                   "encode bound violated: writer overran the extractor's "
                   "%lld-byte bound by %zu bytes (PYRUHVRO_DEBUG_BOUNDS)",
                   (long long)hint, over_by);
      return nullptr;
    }
    if (overflow || vm_err) {
      Py_DECREF(blob);
      PyErr_SetString(PyExc_OverflowError,
                      overflow ? "encoded batch exceeds int32 binary offsets"
                               : "decimal value does not fit its fixed size");
      return nullptr;
    }
    if (_PyBytes_Resize(&blob, (Py_ssize_t)endpos) != 0) return nullptr;
  } else {
    PyErr_Clear();
    std::vector<uint8_t> outv;
    bool oom = false;
    Py_BEGIN_ALLOW_THREADS;
    auto t0 = std::chrono::steady_clock::now();
    try {
      try {
        outv.reserve((size_t)n * 32);
      } catch (const std::bad_alloc&) {
      }
      VecWriter w{&outv};
      run_encode_t(rec, cols, w, n, sizes.data(), &overflow, &vm_err);
    } catch (const std::bad_alloc&) {
      oom = true;
    }
    t_encode = std::chrono::duration<double>(
                   std::chrono::steady_clock::now() - t0)
                   .count();
    Py_END_ALLOW_THREADS;
    if (oom) {
      PyErr_NoMemory();
      return nullptr;
    }
    if (overflow || vm_err) {
      PyErr_SetString(PyExc_OverflowError,
                      overflow ? "encoded batch exceeds int32 binary offsets"
                               : "decimal value does not fit its fixed size");
      return nullptr;
    }
    blob = bytes_from(outv.data(), outv.size());
    if (!blob) return nullptr;
  }

  PyObject* szb = bytes_from(sizes.data(), sizes.size() * 4);
  if (!szb) {
    Py_DECREF(blob);
    return nullptr;
  }
  PyObject* res = Py_BuildValue("(OOdd)", blob, szb, t_extract, t_encode);
  Py_DECREF(blob);
  Py_DECREF(szb);
  return res;
}

// extract-only boundary (differential tests): the plan buffers as a
// list of bytes copies + the byte bound, or int status.
inline PyObject* extract_arrow_boundary(const Op* ops, const OpAux* aux,
                                        PyObject* coltypes_obj,
                                        uintptr_t addr_arr,
                                        uintptr_t addr_sch, Py_ssize_t n) {
  BufferGuard ct_b;
  if (!ct_b.acquire(coltypes_obj, "coltypes")) return nullptr;
  const int32_t* coltypes = static_cast<const int32_t*>(ct_b.view.buf);
  size_t ncols = (size_t)(ct_b.view.len / sizeof(int32_t));

  ArrowOwner owner;
  owner.adopt(addr_arr, addr_sch);
  if (owner.arr.length != n) {
    PyErr_SetString(PyExc_ValueError, "arrow length != row count");
    return nullptr;
  }
  ArrowExtractor ex(ops, aux, coltypes, ncols);
  AView root{&owner.arr, &owner.sch, owner.arr.offset, owner.arr.length};
  Py_BEGIN_ALLOW_THREADS;
  ex.walk(0, root, nullptr);
  PYR_PROF_FLUSH();
  Py_END_ALLOW_THREADS;
  if (ex.status != EXTRACT_OK) return PyLong_FromLong(ex.status);
  PyObject* bufs = PyList_New(0);
  if (!bufs) return nullptr;
  for (auto& o : ex.outs) {
    PyObject* b = bytes_from(o.ptr == nullptr ? "" : o.ptr, o.nbytes);
    if (!b || PyList_Append(bufs, b) != 0) {
      Py_XDECREF(b);
      Py_DECREF(bufs);
      return nullptr;
    }
    Py_DECREF(b);
  }
  PyObject* res = Py_BuildValue("(OL)", bufs, (long long)ex.bound);
  Py_DECREF(bufs);
  return res;
}

}  // namespace pyr

#endif  // PYRUHVRO_EXTRACT_CORE_H_
