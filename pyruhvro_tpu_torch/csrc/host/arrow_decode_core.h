// Copy of pyruhvro_tpu/runtime/native/arrow_decode_core.h, unchanged but for a
// comment that cited the reference's own issue numbers.
//
// Fused decode finalize: shard builders → Arrow-LAYOUT buffers in C.
//
// The decode mirror of the fused encode in extract_core.h. The VM's wire walk already produces dense columnar
// builders; historically Python's ``ops/arrow_build._Assembler`` then
// spent ~2.5x the VM's own time re-shaping them into Arrow arrays
// (validity packbits, offset prefix sums, enum/uuid/duration
// conversion, union masking — all numpy round trips). This pass does
// that whole assembly inside the SAME native call that ran the VM:
// walking the opcode/aux tables against the shard builders, threading
// the parent-validity chain exactly like ``_Assembler.build``, and
// emitting per-node tuples of finished buffers — validity bitmaps,
// int32 offsets with the leading 0, value blobs, int8 union type ids —
// that ``hostpath/codec.py`` hands straight to
// ``pa.Array.from_buffers`` (zero-copy over the returned bytes
// objects; Zerrow-style builder handoff, PAPERS.md).
//
// Fallback contract: anything this pass cannot reproduce bit-for-bit
// (non-canonical uuid text, invalid UTF-8, decimal precision overflow,
// duration overflow, 2 GiB column capacity, unknown shapes) returns
// the legacy plan buffers instead, tagged "plan" — the Python
// ``_Assembler`` oracle then serves the call and raises its exact
// error classes/messages. The fused lane is a fast path, never a
// behavior change; ``tests/test_fused_decode.py`` holds the two
// engines buffer-identical.
//
// Node emission order is the pre-order walk of the schema tree — the
// SAME recursion ``_Assembler.build`` / the Python-side
// ``build_fused_record_batch`` perform — so the flat node list needs
// no keys: both sides consume it positionally.
#ifndef PYRUHVRO_ARROW_DECODE_CORE_H_
#define PYRUHVRO_ARROW_DECODE_CORE_H_

#include "extract_core.h"

#include <deque>

namespace pyr {

// strict UTF-8 validation over a whole buffer — the exact accept set of
// CPython's bytes.decode("utf-8"): rejects continuation starts,
// overlongs, surrogates and anything past U+10FFFF. The all-ASCII
// column (overwhelmingly common) is settled by a wide OR scan.
inline bool utf8_ascii_only(const uint8_t* s, size_t n) {
  size_t i = 0;
  uint64_t acc = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t w;
    std::memcpy(&w, s + i, 8);
    acc |= w;
  }
  if (acc & 0x8080808080808080ULL) return false;
  for (; i < n; i++)
    if (s[i] & 0x80) return false;
  return true;
}

inline bool utf8_valid(const uint8_t* s, size_t n) {
  size_t i = 0;
  while (i < n) {
    uint8_t c = s[i];
    if (c < 0x80) {
      i++;
      continue;
    }
    if (c < 0xC2) return false;  // continuation byte or overlong C0/C1
    if (c < 0xE0) {              // 2-byte sequence
      if (i + 1 >= n || (s[i + 1] & 0xC0) != 0x80) return false;
      i += 2;
      continue;
    }
    if (c < 0xF0) {  // 3-byte sequence
      if (i + 2 >= n) return false;
      uint8_t c1 = s[i + 1], c2 = s[i + 2];
      if ((c1 & 0xC0) != 0x80 || (c2 & 0xC0) != 0x80) return false;
      if (c == 0xE0 && c1 < 0xA0) return false;   // overlong
      if (c == 0xED && c1 >= 0xA0) return false;  // surrogate range
      i += 3;
      continue;
    }
    if (c < 0xF5) {  // 4-byte sequence
      if (i + 3 >= n) return false;
      uint8_t c1 = s[i + 1], c2 = s[i + 2], c3 = s[i + 3];
      if ((c1 & 0xC0) != 0x80 || (c2 & 0xC0) != 0x80 ||
          (c3 & 0xC0) != 0x80)
        return false;
      if (c == 0xF0 && c1 < 0x90) return false;   // overlong
      if (c == 0xF4 && c1 >= 0x90) return false;  // past U+10FFFF
      i += 4;
      continue;
    }
    return false;
  }
  return true;
}

class ArrowFinalize {
 public:
  ArrowFinalize(const Op* ops, const OpAux* aux, const int32_t* coltypes,
                size_t ncols, const std::vector<ShardResult>& shards,
                int64_t nrows)
      : ops_(ops), aux_(aux), coltypes_(coltypes), ncols_(ncols),
        shards_(shards), nrows_(nrows) {}

  // 0 = OK (nodes appended to out_list), 1 = fall back to the plan
  // buffers (exotic shape/data — the Python oracle serves the call and
  // words any error precisely), -1 = Python error set.
  int run(PyObject* out_list) {
    try {
      if (ops_[0].kind != OP_RECORD) return 1;
      size_t p = 1, stop = (size_t)ops_[0].nops;
      while (p < stop && st_ == 0) p = node(p, nrows_, nullptr, out_list);
      return st_;
    } catch (const std::bad_alloc&) {
      PyErr_NoMemory();
      return -1;
    }
  }

 private:
  const Op* ops_;
  const OpAux* aux_;
  const int32_t* coltypes_;
  size_t ncols_;
  const std::vector<ShardResult>& shards_;
  int64_t nrows_;
  int st_ = 0;
  std::deque<std::vector<uint8_t>> arena_;  // stable mask storage

  size_t fallback(size_t pc) {
    if (st_ == 0) st_ = 1;
    return pc + (size_t)ops_[pc].nops;
  }

  size_t pyfail(size_t pc) {
    st_ = -1;
    return pc + (size_t)ops_[pc].nops;
  }

  uint8_t* arena_alloc(int64_t n) {
    arena_.emplace_back((size_t)(n > 0 ? n : 1));
    return arena_.back().data();
  }

  static bool live(const uint8_t* m, int64_t i) {
    return m == nullptr || m[i] != 0;
  }

  // ---- merged-column access -----------------------------------------

  // total element bytes of column c's part ``which`` across shards
  size_t col_total(size_t c, int32_t ty, int which) const {
    size_t total = 0, nb = 0;
    for (auto& s : shards_) {
      col_data(s.cols[c], ty, which, &nb);
      total += nb;
    }
    return total;
  }

  // contiguous copy of a column part into caller storage
  void merged(size_t c, int32_t ty, int which,
              std::vector<uint8_t>& out) const {
    out.resize(col_total(c, ty, which));
    uint8_t* dst = out.data();
    size_t nb = 0;
    for (auto& s : shards_) {
      const void* src = col_data(s.cols[c], ty, which, &nb);
      if (nb) std::memcpy(dst, src, nb);
      dst += nb;
    }
  }

  // ---- output helpers ------------------------------------------------

  static PyObject* none_ref() {
    Py_INCREF(Py_None);
    return Py_None;
  }

  // validity bitmap from a 0/1 byte mask: (buffer, null_count); no
  // bitmap (Py_None) when the lane is all-valid — matching
  // ``_Assembler._validity`` exactly.
  bool validity(const uint8_t* m, int64_t count, PyObject** vbuf,
                int64_t* nulls) {
    *vbuf = nullptr;
    *nulls = 0;
    if (m == nullptr) {
      *vbuf = none_ref();
      return true;
    }
    int64_t ones = 0;
    for (int64_t i = 0; i < count; i++) ones += m[i] != 0;
    if (ones == count) {
      *vbuf = none_ref();
      return true;
    }
    *nulls = count - ones;
    PyObject* b = PyBytes_FromStringAndSize(nullptr, (count + 7) / 8);
    if (!b) return false;
    uint8_t* bits = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(b));
    std::memset(bits, 0, (size_t)((count + 7) / 8));
    for (int64_t i = 0; i < count; i++)
      if (m[i]) bits[i >> 3] |= (uint8_t)(1u << (i & 7));
    *vbuf = b;
    return true;
  }

  bool emit(PyObject* out, PyObject* entry) {
    if (!entry) return false;
    int rc = PyList_Append(out, entry);
    Py_DECREF(entry);
    return rc == 0;
  }

  // ---- the walk ------------------------------------------------------

  // Build the subtree at ``pc`` over ``count`` elements under the
  // parent-validity byte mask ``mask`` (nullptr = all live); appends
  // this subtree's node entries to ``out``. Mirrors _Assembler.build.
  size_t node(size_t pc, int64_t count, const uint8_t* mask,
              PyObject* out) {
    const Op& op = ops_[pc];
    switch (op.kind) {
      case OP_NULLABLE: {
        // ["null", T]: narrow the chain, no node of its own
        std::vector<uint8_t> own;
        merged((size_t)op.col, COL_U8, 0, own);
        if ((int64_t)own.size() != count) return fallback(pc);
        const uint8_t* sub;
        if (mask == nullptr) {
          uint8_t* m = arena_alloc(count);
          std::memcpy(m, own.data(), (size_t)count);
          sub = m;
        } else {
          uint8_t* m = arena_alloc(count);
          for (int64_t i = 0; i < count; i++) m[i] = own[i] & mask[i];
          sub = m;
        }
        return node(pc + 1, count, sub, out);
      }
      case OP_RECORD: {
        PyObject *vb;
        int64_t nc;
        if (!validity(mask, count, &vb, &nc)) return pyfail(pc);
        if (!emit(out, Py_BuildValue("(LN)", (long long)nc, vb)))
          return pyfail(pc);
        size_t p = pc + 1, stop = pc + (size_t)op.nops;
        while (p < stop && st_ == 0) p = node(p, count, mask, out);
        return p;
      }
      case OP_FIXED_RUN: {
        // optimizer header: no Arrow node of its own — members
        // finalize exactly as in the raw program (same count/mask)
        size_t p = pc + 1, stop = pc + (size_t)op.nops;
        while (p < stop && st_ == 0) p = node(p, count, mask, out);
        return p;
      }
      case OP_INT:
        return prim_node(pc, count, mask, out, COL_I32, 4);
      case OP_LONG:
        return prim_node(pc, count, mask, out, COL_I64, 8);
      case OP_FLOAT:
        return prim_node(pc, count, mask, out, COL_F32, 4);
      case OP_DOUBLE:
        return prim_node(pc, count, mask, out, COL_F64, 8);
      case OP_BOOL:
        return bool_node(pc, count, mask, out);
      case OP_STRING: {
        int8_t lane = aux_ ? aux_[pc].lane : AUX_NONE;
        if (lane == AUX_UUID) return uuid_node(pc, count, mask, out);
        return string_node(pc, count, mask, out,
                           /*check_utf8=*/lane != AUX_BINARY);
      }
      case OP_ENUM:
        return enum_node(pc, count, mask, out);
      case OP_FIXED: {
        if (aux_ && aux_[pc].lane == AUX_DURATION)
          return duration_node(pc, count, mask, out);
        return prim_node(pc, count, mask, out, COL_U8, (size_t)op.a);
      }
      case OP_DEC_BYTES:
      case OP_DEC_FIXED:
        return decimal_node(pc, count, mask, out);
      case OP_NULL:
        return pc + 1;  // Python emits pa.nulls(count), no entry
      case OP_UNION:
        return union_node(pc, count, mask, out);
      case OP_ARRAY:
      case OP_MAP:
        return repeated_node(pc, count, mask, out);
    }
    return fallback(pc);
  }

  // fixed-width value column: the merged builder bytes ARE the Arrow
  // values buffer (dead rows already carry the VM's zero defaults)
  size_t prim_node(size_t pc, int64_t count, const uint8_t* mask,
                   PyObject* out, int32_t ty, size_t width) {
    const Op& op = ops_[pc];
    if (col_total((size_t)op.col, ty, 0) != (size_t)count * width)
      return fallback(pc);
    PyObject *vb;
    int64_t nc;
    if (!validity(mask, count, &vb, &nc)) return pyfail(pc);
    PyObject* data = build_col_buffer(shards_, (size_t)op.col, ty, 0);
    if (!data) {
      Py_DECREF(vb);
      return pyfail(pc);
    }
    if (!emit(out, Py_BuildValue("(LNN)", (long long)nc, vb, data)))
      return pyfail(pc);
    return pc + 1;
  }

  size_t bool_node(size_t pc, int64_t count, const uint8_t* mask,
                   PyObject* out) {
    const Op& op = ops_[pc];
    std::vector<uint8_t> v;
    merged((size_t)op.col, COL_U8, 0, v);
    if ((int64_t)v.size() != count) return fallback(pc);
    PyObject *vb;
    int64_t nc;
    if (!validity(mask, count, &vb, &nc)) return pyfail(pc);
    PyObject* b = PyBytes_FromStringAndSize(nullptr, (count + 7) / 8);
    if (!b) {
      Py_DECREF(vb);
      return pyfail(pc);
    }
    uint8_t* bits = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(b));
    std::memset(bits, 0, (size_t)((count + 7) / 8));
    for (int64_t i = 0; i < count; i++)
      if (v[i]) bits[i >> 3] |= (uint8_t)(1u << (i & 7));
    if (!emit(out, Py_BuildValue("(LNN)", (long long)nc, vb, b)))
      return pyfail(pc);
    return pc + 1;
  }

  // lens → int32 offsets (leading 0) in one pass; past-int32 totals
  // fall back (the oracle raises its ArrowCapacityError wording)
  PyObject* string_offsets(size_t col, int64_t count, int64_t* total) {
    std::vector<uint8_t> raw;
    merged(col, COL_STR, 1, raw);
    if ((int64_t)raw.size() != count * 4) return nullptr;
    const int32_t* lens = reinterpret_cast<const int32_t*>(raw.data());
    PyObject* b = PyBytes_FromStringAndSize(nullptr, (count + 1) * 4);
    if (!b) {
      st_ = -1;
      return nullptr;
    }
    int32_t* dst = reinterpret_cast<int32_t*>(PyBytes_AS_STRING(b));
    int64_t acc = 0;
    dst[0] = 0;
    for (int64_t i = 0; i < count; i++) {
      acc += lens[i];
      if (acc > INT32_MAX) {
        Py_DECREF(b);
        return nullptr;  // st_ stays 0: caller falls back
      }
      dst[i + 1] = (int32_t)acc;
    }
    *total = acc;
    return b;
  }

  // One string-column entry (offsets + values + validity) for column
  // ``col`` — shared by OP_STRING nodes and map KEY columns (op.b).
  // Returns false with st_ set (1 = fallback, -1 = Python error).
  bool string_entry(size_t col, int64_t count, const uint8_t* mask,
                    PyObject* out, bool check_utf8) {
    int64_t total = 0;
    PyObject* offs = string_offsets(col, count, &total);
    if (!offs) {
      if (st_ == 0) st_ = 1;
      return false;
    }
    PyObject* vals = build_col_buffer(shards_, col, COL_STR, 0);
    if (!vals) {
      Py_DECREF(offs);
      st_ = -1;
      return false;
    }
    if ((int64_t)PyBytes_GET_SIZE(vals) != total) {
      Py_DECREF(offs);
      Py_DECREF(vals);
      st_ = 1;
      return false;
    }
    if (check_utf8 && total) {
      const uint8_t* s =
          reinterpret_cast<const uint8_t*>(PyBytes_AS_STRING(vals));
      if (!utf8_ascii_only(s, (size_t)total)) {
        // non-ASCII bytes present: full validation + the oracle's
        // continuation-start rule ((a) ∧ (b) ⟺ every string valid)
        bool ok = utf8_valid(s, (size_t)total);
        if (ok) {
          const int32_t* o =
              reinterpret_cast<const int32_t*>(PyBytes_AS_STRING(offs));
          for (int64_t i = 0; i < count && ok; i++)
            if (o[i + 1] > o[i] && (s[o[i]] & 0xC0) == 0x80) ok = false;
        }
        if (!ok) {
          Py_DECREF(offs);
          Py_DECREF(vals);
          st_ = 1;  // oracle raises the exact MalformedAvro wording
          return false;
        }
      }
    }
    PyObject *vb;
    int64_t nc;
    if (!validity(mask, count, &vb, &nc)) {
      Py_DECREF(offs);
      Py_DECREF(vals);
      st_ = -1;
      return false;
    }
    if (!emit(out, Py_BuildValue("(LNNN)", (long long)nc, vb, offs, vals))) {
      st_ = -1;
      return false;
    }
    return true;
  }

  size_t string_node(size_t pc, int64_t count, const uint8_t* mask,
                     PyObject* out, bool check_utf8) {
    const Op& op = ops_[pc];
    if (!string_entry((size_t)op.col, count, mask, out, check_utf8))
      return pc + 1;  // st_ set; every caller loop checks it
    return pc + 1;
  }

  size_t uuid_node(size_t pc, int64_t count, const uint8_t* mask,
                   PyObject* out) {
    static const int kPos[32] = {0,  1,  2,  3,  4,  5,  6,  7,
                                 9,  10, 11, 12, 14, 15, 16, 17,
                                 19, 20, 21, 22, 24, 25, 26, 27,
                                 28, 29, 30, 31, 32, 33, 34, 35};
    struct Lut {
      uint8_t t[256];
      Lut() {
        std::memset(t, 0xFF, 256);
        for (int k = 0; k < 10; k++) t['0' + k] = (uint8_t)k;
        for (int k = 0; k < 6; k++) {
          t['a' + k] = (uint8_t)(10 + k);
          t['A' + k] = (uint8_t)(10 + k);
        }
      }
    };
    static const Lut lut;
    const Op& op = ops_[pc];
    std::vector<uint8_t> lens_raw, vals;
    merged((size_t)op.col, COL_STR, 1, lens_raw);
    merged((size_t)op.col, COL_STR, 0, vals);
    if ((int64_t)lens_raw.size() != count * 4) return fallback(pc);
    const int32_t* lens = reinterpret_cast<const int32_t*>(lens_raw.data());
    PyObject* b = PyBytes_FromStringAndSize(nullptr, count * 16);
    if (!b) return pyfail(pc);
    uint8_t* o = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(b));
    int64_t off = 0;
    for (int64_t i = 0; i < count; i++) {
      uint8_t* dst = o + i * 16;
      int64_t L = lens[i];
      if (!live(mask, i)) {  // dead rows emit zeros, whatever parsed
        std::memset(dst, 0, 16);
        off += L;
        continue;
      }
      // only the canonical 36-char form converts here; anything else
      // (live) is the stdlib parser's jurisdiction — oracle fallback
      if (L != 36 || off + 36 > (int64_t)vals.size()) {
        Py_DECREF(b);
        return fallback(pc);
      }
      const uint8_t* sp = vals.data() + off;
      if (sp[8] != '-' || sp[13] != '-' || sp[18] != '-' || sp[23] != '-') {
        Py_DECREF(b);
        return fallback(pc);
      }
      uint8_t badacc = 0;
      for (int j = 0; j < 16; j++) {
        uint8_t h = lut.t[sp[kPos[2 * j]]];
        uint8_t l = lut.t[sp[kPos[2 * j + 1]]];
        badacc |= (uint8_t)((h | l) & 0xF0);
        dst[j] = (uint8_t)((uint8_t)(h << 4) | (l & 0xF));
      }
      if (badacc != 0) {
        Py_DECREF(b);
        return fallback(pc);
      }
      off += 36;
    }
    PyObject *vb;
    int64_t nc;
    if (!validity(mask, count, &vb, &nc)) {
      Py_DECREF(b);
      return pyfail(pc);
    }
    if (!emit(out, Py_BuildValue("(LNN)", (long long)nc, vb, b)))
      return pyfail(pc);
    return pc + 1;
  }

  size_t enum_node(size_t pc, int64_t count, const uint8_t* mask,
                   PyObject* out) {
    const Op& op = ops_[pc];
    if (aux_ == nullptr || aux_[pc].lane != AUX_ENUM ||
        aux_[pc].nsyms != op.a)
      return fallback(pc);
    const OpAux& a = aux_[pc];
    std::vector<uint8_t> raw;
    merged((size_t)op.col, COL_I32, 0, raw);
    if ((int64_t)raw.size() != count * 4) return fallback(pc);
    const int32_t* idx = reinterpret_cast<const int32_t*>(raw.data());
    int64_t total = 0;
    for (int64_t i = 0; i < count; i++) {
      int32_t k = idx[i];
      if (k < 0 || k >= a.nsyms) return fallback(pc);
      total += a.symlens[k];
      if (total >= ((int64_t)1 << 31)) return fallback(pc);  // 2 GiB cap
    }
    PyObject* offs = PyBytes_FromStringAndSize(nullptr, (count + 1) * 4);
    PyObject* vals = PyBytes_FromStringAndSize(nullptr, total);
    if (!offs || !vals) {
      Py_XDECREF(offs);
      Py_XDECREF(vals);
      return pyfail(pc);
    }
    int32_t* od = reinterpret_cast<int32_t*>(PyBytes_AS_STRING(offs));
    uint8_t* vd = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(vals));
    int64_t acc = 0;
    od[0] = 0;
    for (int64_t i = 0; i < count; i++) {
      int32_t k = idx[i];
      int32_t L = a.symlens[k];
      if (L) std::memcpy(vd + acc, a.syms[k], (size_t)L);
      acc += L;
      od[i + 1] = (int32_t)acc;
    }
    PyObject *vb;
    int64_t nc;
    if (!validity(mask, count, &vb, &nc)) {
      Py_DECREF(offs);
      Py_DECREF(vals);
      return pyfail(pc);
    }
    if (!emit(out, Py_BuildValue("(LNNN)", (long long)nc, vb, offs, vals)))
      return pyfail(pc);
    return pc + 1;
  }

  size_t duration_node(size_t pc, int64_t count, const uint8_t* mask,
                       PyObject* out) {
    const Op& op = ops_[pc];
    std::vector<uint8_t> raw;
    merged((size_t)op.col, COL_U8, 0, raw);
    if ((int64_t)raw.size() != count * 12) return fallback(pc);
    PyObject* b = PyBytes_FromStringAndSize(nullptr, count * 8);
    if (!b) return pyfail(pc);
    int64_t* o = reinterpret_cast<int64_t*>(PyBytes_AS_STRING(b));
    for (int64_t i = 0; i < count; i++) {
      uint32_t m, d, ms;
      std::memcpy(&m, raw.data() + i * 12, 4);
      std::memcpy(&d, raw.data() + i * 12 + 4, 4);
      std::memcpy(&ms, raw.data() + i * 12 + 8, 4);
      // uint64 holds the wire maximum (see the oracle's comment);
      // values past int64 overflow Duration(ms) → oracle OverflowError
      uint64_t total = ((uint64_t)m * 30 + d) * 86400000ULL + ms;
      if (total > (uint64_t)INT64_MAX) {
        Py_DECREF(b);
        return fallback(pc);
      }
      o[i] = (int64_t)total;
    }
    PyObject *vb;
    int64_t nc;
    if (!validity(mask, count, &vb, &nc)) {
      Py_DECREF(b);
      return pyfail(pc);
    }
    if (!emit(out, Py_BuildValue("(LNN)", (long long)nc, vb, b)))
      return pyfail(pc);
    return pc + 1;
  }

  size_t decimal_node(size_t pc, int64_t count, const uint8_t* mask,
                      PyObject* out) {
    const Op& op = ops_[pc];
    if (aux_ == nullptr || aux_[pc].lane != AUX_DECIMAL)
      return fallback(pc);  // no declared precision: oracle checks it
    int prec = (int)aux_[pc].nsyms;
    if (prec < 1 || prec > 38) return fallback(pc);
    if (col_total((size_t)op.col, COL_U8, 0) != (size_t)count * 16)
      return fallback(pc);
    PyObject* data = build_col_buffer(shards_, (size_t)op.col, COL_U8, 0);
    if (!data) return pyfail(pc);
    unsigned __int128 bound = 1;
    for (int k = 0; k < prec; k++) bound *= 10;
    const uint8_t* raw =
        reinterpret_cast<const uint8_t*>(PyBytes_AS_STRING(data));
    for (int64_t i = 0; i < count; i++) {
      uint64_t lo, hi;
      std::memcpy(&lo, raw + i * 16, 8);
      std::memcpy(&hi, raw + i * 16 + 8, 8);
      unsigned __int128 v = ((unsigned __int128)hi << 64) | lo;
      bool neg = (hi >> 63) != 0;
      unsigned __int128 a = neg ? (unsigned __int128)(~v + 1) : v;
      // dead rows carry all-zero words, which trivially fit
      if (a >= bound) {
        Py_DECREF(data);
        return fallback(pc);  // oracle raises its exact ArrowInvalid
      }
    }
    PyObject *vb;
    int64_t nc;
    if (!validity(mask, count, &vb, &nc)) {
      Py_DECREF(data);
      return pyfail(pc);
    }
    if (!emit(out, Py_BuildValue("(LNN)", (long long)nc, vb, data)))
      return pyfail(pc);
    return pc + 1;
  }

  size_t union_node(size_t pc, int64_t count, const uint8_t* mask,
                    PyObject* out) {
    const Op& op = ops_[pc];
    std::vector<uint8_t> raw;
    merged((size_t)op.col, COL_I32, 0, raw);
    if ((int64_t)raw.size() != count * 4) return fallback(pc);
    const int32_t* tid = reinterpret_cast<const int32_t*>(raw.data());
    // a null parent renders as branch 0 + null child, like the oracle
    PyObject* tb = PyBytes_FromStringAndSize(nullptr, count);
    if (!tb) return pyfail(pc);
    int8_t* t8 = reinterpret_cast<int8_t*>(PyBytes_AS_STRING(tb));
    for (int64_t i = 0; i < count; i++)
      t8[i] = (int8_t)(live(mask, i) ? tid[i] : 0);
    if (!emit(out, Py_BuildValue("(N)", tb))) return pyfail(pc);
    size_t p = pc + 1;
    for (int32_t k = 0; k < op.a && st_ == 0; k++) {
      if (ops_[p].kind == OP_NULL) {
        p += 1;  // Python emits pa.nulls for the null arm
        continue;
      }
      uint8_t* sel = arena_alloc(count);
      for (int64_t i = 0; i < count; i++)
        sel[i] = (uint8_t)(live(mask, i) && t8[i] == (int8_t)k);
      p = node(p, count, sel, out);
    }
    return p;
  }

  size_t repeated_node(size_t pc, int64_t count, const uint8_t* mask,
                       PyObject* out) {
    const Op& op = ops_[pc];
    // COL_OFFS running totals → leading-0 offsets, rebased across
    // shards; overflow keeps the legacy OverflowError contract
    size_t entries = 0;
    for (auto& s : shards_) entries += s.cols[(size_t)op.col].i32.size();
    if ((int64_t)entries != count) return fallback(pc);
    PyObject* offs = PyBytes_FromStringAndSize(nullptr, (count + 1) * 4);
    if (!offs) return pyfail(pc);
    int32_t* dst = reinterpret_cast<int32_t*>(PyBytes_AS_STRING(offs));
    dst[0] = 0;
    int64_t base = 0, k = 1;
    for (auto& s : shards_) {
      const Col& col = s.cols[(size_t)op.col];
      for (int32_t v : col.i32) {
        int64_t val = base + (int64_t)v;
        if (val > INT32_MAX) {
          Py_DECREF(offs);
          PyErr_SetString(PyExc_OverflowError,
                          "item total exceeds int32 offsets");
          return pyfail(pc);
        }
        dst[k++] = (int32_t)val;
      }
      base += (int64_t)col.running;
    }
    int64_t item_total = base;
    PyObject *vb;
    int64_t nc;
    if (!validity(mask, count, &vb, &nc)) {
      Py_DECREF(offs);
      return pyfail(pc);
    }
    if (!emit(out, Py_BuildValue("(LNNL)", (long long)nc, vb, offs,
                                 (long long)item_total)))
      return pyfail(pc);
    if (op.kind == OP_MAP) {
      // keys: one string entry over the item axis, no parent mask,
      // UTF-8 checked (Avro map keys are strings) — then the values
      if (!string_entry((size_t)op.b, item_total, nullptr, out, true))
        return pc + (size_t)op.nops;
    }
    return node(pc + 1, item_total, nullptr, out);
  }
};

// fused decode boundary: (coltypes, data, nthreads) with the per-record
// decoder + opcode/aux tables supplied by the caller
//   -> (payload, err_record, err_bits)
// payload = ("arrow", [node_entry, ...])  — finished Arrow-layout
//            buffers in _Assembler pre-order, consumed positionally by
//            ``ops.arrow_build.build_fused_record_batch``; or
//           ("plan", [plan_buffer, ...])  — the legacy buffers, when
//            the finalize pass declined (counted decode.fused_fallback
//            by the caller; the Python oracle serves the call).
// ``data`` is a list[bytes] or the zero-copy ("arrowbuf", ...) lane —
// exactly like ``decode_boundary``.
template <class RecFn>
inline PyObject* decode_arrow_boundary(RecFn rec, const Op* ops,
                                       const OpAux* aux,
                                       PyObject* coltypes_obj,
                                       PyObject* data_obj, int nthreads) {
  BufferGuard ct_b;
  if (!ct_b.acquire(coltypes_obj, "coltypes")) return nullptr;
  const int32_t* coltypes = static_cast<const int32_t*>(ct_b.view.buf);
  size_t ncols = (size_t)(ct_b.view.len / sizeof(int32_t));

  SpanCollection sc;
  PYR_PROF_OP(pyr::prof::DOM_VM, pyr::prof::P_COLLECT);
  bool spans_ok = collect_input(data_obj, sc);
  PYR_PROF_STOP();
  if (!spans_ok) return nullptr;

  std::vector<ShardResult> shards;
  run_all_shards(rec, coltypes, ncols, sc, nthreads, shards);
  PyObject* err = shard_error_result(shards);
  if (err != nullptr || PyErr_Occurred()) return err;

  // the finalize is the fused pass's merge stage: attribute it to the
  // profiler's merge pseudo-op so vm.op.* still decomposes host.vm_s
  PYR_PROF_OP(pyr::prof::DOM_VM, pyr::prof::P_MERGE);
  PyObject* nodes = PyList_New(0);
  if (!nodes) return nullptr;
  ArrowFinalize fin(ops, aux, coltypes, ncols, shards, sc.n);
  int st = fin.run(nodes);
  PYR_PROF_STOP();
  PyObject* payload = nullptr;
  if (st == -1) {
    Py_DECREF(nodes);
    return nullptr;
  } else if (st == 0) {
    payload = Py_BuildValue("(sN)", "arrow", nodes);
  } else {
    Py_DECREF(nodes);
    PyObject* bufs = build_plan_buffers(shards, coltypes, ncols);
    if (!bufs) return nullptr;
    payload = Py_BuildValue("(sN)", "plan", bufs);
  }
  if (!payload) return nullptr;
  PyObject* out = Py_BuildValue("(NLi)", payload, (long long)-1, 0);
  PYR_PROF_FLUSH();
  return out;
}

}  // namespace pyr

#endif  // PYRUHVRO_ARROW_DECODE_CORE_H_
