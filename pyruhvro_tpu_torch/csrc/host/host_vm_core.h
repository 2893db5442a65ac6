// Copy of pyruhvro_tpu/runtime/native/host_vm_core.h, unchanged.
//
// Shared core of the native host codec: wire reader, columnar
// builders, shard runner and the Python decode boundary — everything
// that is identical between the generic bytecode VM
// (host_codec.cpp) and the schema-SPECIALIZED decoders that
// hostpath/specialize.py generates (straight-line C++ per schema,
// compiled on demand and cached). Keeping one definition here is what
// makes the specializer trustworthy: both engines read the wire and
// fill columns through these exact helpers, so the differential suite
// covers them jointly.
//
// Everything is header-only (inline / template): each extension module
// (the interpreter's and every generated one) compiles its own copy.
//
// Behavior parity anchors (see host_codec.cpp's header comment):
// zigzag varints ≙ ruhvro/src/fast_decode.rs:855-869; block protocol
// ≙ fast_decode.rs:689-700; error bits ≙ ops/varint.py ERR_*.
#ifndef PYRUHVRO_HOST_VM_CORE_H_
#define PYRUHVRO_HOST_VM_CORE_H_

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <thread>
#include <utility>
#include <vector>

#include "shard_runner.h"

#ifdef PYRUHVRO_NATIVE_PROF
#include <atomic>
#include <chrono>
#include <cstdio>
#endif

namespace pyr {

// ---- native-tier profiler (compiled in only under -DPYRUHVRO_NATIVE_PROF,
// selected at JIT-build time by PYRUHVRO_TPU_NATIVE_PROF=1) --------------
//
// Per-opcode hit/time counters with WATERMARK attribution: every dispatch
// point stamps the clock and charges the elapsed interval to the opcode
// that was executing, so the per-op times are self-times that sum to the
// instrumented region's wall clock — no double counting across the
// recursive exec() tree. Two pseudo-slots cover the decode boundary's
// non-dispatch work (span collection under the GIL, shard-buffer merge)
// so the sum decomposes ~all of host.vm_s, not just the exec loop.
//
// Worker threads accumulate in a thread_local block and publish to the
// process-wide atomics when their shard ends (run_shard_t), so the
// multi-threaded VM needs no locks on the hot path. ``prof_drain_py``
// (GIL held) snapshots-and-clears the atomics into a dict keyed by the
// telemetry names Python feeds straight into metrics.inc:
// ``vm.op.<name>`` (decode VM), ``vm.encop.<name>`` (encode VM),
// ``extract.op.<name>`` (Arrow-native extraction walk).
#ifdef PYRUHVRO_NATIVE_PROF
namespace prof {

enum Domain : int { DOM_VM = 0, DOM_ENC = 1, DOM_EXT = 2, N_DOM = 3 };
// slots 0..16 mirror OpKind; 17..19 are the boundary pseudo-ops
// (span collection, shard-buffer merge, shard fan-out orchestration)
enum : int { P_COLLECT = 17, P_MERGE = 18, P_SHARD = 19, N_SLOT = 20 };

inline const char* const kSlotName[N_SLOT] = {
    "record", "int",  "long",     "float", "double",    "bool",
    "string", "enum", "null",     "nullable", "union",  "array",
    "map",    "fixed", "dec_bytes", "dec_fixed", "fixed_run",
    "collect", "merge", "shard",
};
inline const char* const kDomPrefix[N_DOM] = {"vm.op.", "vm.encop.",
                                              "extract.op."};

inline std::atomic<unsigned long long> g_hits[N_DOM][N_SLOT];
inline std::atomic<unsigned long long> g_ns[N_DOM][N_SLOT];

struct Tls {
  unsigned long long hits[N_DOM][N_SLOT] = {};
  unsigned long long ns[N_DOM][N_SLOT] = {};
  int dom = 0;
  int slot = -1;  // -1 = no open attribution interval
  unsigned long long last = 0;
};
inline thread_local Tls t;

inline unsigned long long now_ns() {
  return (unsigned long long)std::chrono::duration_cast<
             std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// dispatch: close the previous interval, open one charged to (dom, slot)
inline void op(int dom, int slot) {
  unsigned long long n = now_ns();
  if (t.slot >= 0) t.ns[t.dom][t.slot] += n - t.last;
  t.dom = dom;
  t.slot = slot;
  t.last = n;
  t.hits[dom][slot]++;
}

inline void stop() {  // close the open interval without opening another
  if (t.slot >= 0) {
    t.ns[t.dom][t.slot] += now_ns() - t.last;
    t.slot = -1;
  }
}

inline void flush() {  // publish this thread's block (call on that thread)
  stop();
  for (int d = 0; d < N_DOM; d++) {
    for (int s = 0; s < N_SLOT; s++) {
      if (t.hits[d][s]) {
        g_hits[d][s].fetch_add(t.hits[d][s], std::memory_order_relaxed);
        t.hits[d][s] = 0;
      }
      if (t.ns[d][s]) {
        g_ns[d][s].fetch_add(t.ns[d][s], std::memory_order_relaxed);
        t.ns[d][s] = 0;
      }
    }
  }
}

// snapshot-and-clear -> {"vm.op.string": (hits, ns), ...} (GIL held)
inline PyObject* drain_py() {
  PyObject* out = PyDict_New();
  if (!out) return nullptr;
  char key[48];
  for (int d = 0; d < N_DOM; d++) {
    for (int s = 0; s < N_SLOT; s++) {
      unsigned long long h = g_hits[d][s].exchange(0, std::memory_order_relaxed);
      unsigned long long n = g_ns[d][s].exchange(0, std::memory_order_relaxed);
      if (!h && !n) continue;
      std::snprintf(key, sizeof(key), "%s%s", kDomPrefix[d], kSlotName[s]);
      PyObject* v = Py_BuildValue("(KK)", h, n);
      if (!v || PyDict_SetItemString(out, key, v) != 0) {
        Py_XDECREF(v);
        Py_DECREF(out);
        return nullptr;
      }
      Py_DECREF(v);
    }
  }
  return out;
}

}  // namespace prof
#define PYR_PROF_OP(dom, slot) ::pyr::prof::op((dom), (slot))
#define PYR_PROF_STOP() ::pyr::prof::stop()
#define PYR_PROF_FLUSH() ::pyr::prof::flush()
#else
#define PYR_PROF_OP(dom, slot) ((void)0)
#define PYR_PROF_STOP() ((void)0)
#define PYR_PROF_FLUSH() ((void)0)
#endif

// ---- op kinds (keep in sync with hostpath/program.py) ----------------
enum OpKind : int32_t {
  OP_RECORD = 0,
  OP_INT = 1,
  OP_LONG = 2,
  OP_FLOAT = 3,
  OP_DOUBLE = 4,
  OP_BOOL = 5,
  OP_STRING = 6,
  OP_ENUM = 7,
  OP_NULL = 8,
  OP_NULLABLE = 9,
  OP_UNION = 10,
  OP_ARRAY = 11,
  OP_MAP = 12,
  OP_FIXED = 13,      // a = byte size; col = raw bytes (size per entry)
  OP_DEC_BYTES = 14,  // decimal over bytes; col = 16B LE words
  OP_DEC_FIXED = 15,  // a = byte size; decimal over fixed; col = 16B LE
  // optimizer-emitted (hostpath/optimize.py; never lowered directly):
  // header over a run of >= 2 consecutive fixed-layout leaf members of
  // one record. a = 1 iff every member is exact-width (bulk-lane
  // eligible), b = total member min-wire bytes, nops = 1 + members.
  // Members follow unchanged, so dropping headers recovers the raw
  // program byte-for-byte — the equivalence oracle's invariant.
  OP_FIXED_RUN = 16,
};

// Op::pad flag bits, optimizer-set and proof-carried (the irverify
// oracle re-derives each claim before an optimized program ever runs;
// keep in sync with hostpath/program.py)
enum OpFlag : int32_t {
  // on OP_FIXED_RUN: every ancestor is a record/fused header, so the
  // walk can never reach this op with present=false
  FLAG_ALWAYS_PRESENT = 1,
  // on OP_ARRAY/OP_MAP: the item subtree is exactly one string leaf —
  // take the block loop's read-len/bulk-copy lane unconditionally
  FLAG_STR_ITEMS = 2,
};

// ---- column types (keep in sync with hostpath/program.py) ------------
enum ColType : int32_t {
  COL_I32 = 0,   // one int32 buffer
  COL_I64 = 1,   // one int64 buffer
  COL_F32 = 2,
  COL_F64 = 3,
  COL_U8 = 4,
  COL_STR = 5,   // two buffers: value bytes uint8, len int32
  COL_OFFS = 6,  // one int32 buffer of running totals (no leading 0)
};

// ---- error bits (keep in sync with ops/varint.py) --------------------
enum Err : int32_t {
  ERR_VARINT = 1 << 0,
  ERR_NEG_LEN = 1 << 1,
  ERR_OVERRUN = 1 << 2,
  ERR_BAD_BRANCH = 1 << 3,
  ERR_BAD_ENUM = 1 << 4,
  ERR_TRAILING = 1 << 5,
  ERR_BAD_BOOL = 1 << 6,
  ERR_DEC_RANGE = 1 << 8,  // decimal outside decimal128's 128-bit range
  ERR_INT_RANGE = 1 << 9,  // an Avro int whose varint lies past int32
};

struct Op {
  int32_t kind;
  int32_t a;     // kind-specific: null_idx / n_variants / n_symbols
  int32_t b;     // kind-specific: map key col
  int32_t col;   // primary output column (-1 = none)
  int32_t nops;  // ops in this subtree, self included
  int32_t pad;
};

// Growable byte buffer for the u8 builders (string values, validity,
// fixed, decimal words). Replaces std::vector<uint8_t> for two wins
// measured on the kafka workload: (a) a guaranteed 16-byte headroom
// past ``n`` lets short appends compile to ONE fixed-size 16-byte copy
// (two SIMD moves, no libc memmove call) — most real string fields are
// under 16 bytes; (b) growth uses realloc, which commonly extends in
// place where vector must allocate+copy+free.
struct ByteBuf {
  uint8_t* p = nullptr;
  size_t n = 0;
  size_t cap = 0;  // usable bytes; allocation is cap + 16 headroom

  ByteBuf() = default;
  ByteBuf(const ByteBuf&) = delete;
  ByteBuf& operator=(const ByteBuf&) = delete;
  ByteBuf(ByteBuf&& o) noexcept : p(o.p), n(o.n), cap(o.cap) {
    o.p = nullptr;
    o.n = o.cap = 0;
  }
  ByteBuf& operator=(ByteBuf&& o) noexcept {
    if (this != &o) {
      std::free(p);
      p = o.p;
      n = o.n;
      cap = o.cap;
      o.p = nullptr;
      o.n = o.cap = 0;
    }
    return *this;
  }
  ~ByteBuf() { std::free(p); }

  inline size_t size() const { return n; }
  inline const uint8_t* data() const { return p; }

  void grow(size_t need) {  // out of line of the hot paths
    size_t nc = cap ? cap : 64;
    while (nc < need) nc *= 2;
    void* np = std::realloc(p, nc + 16);
    if (np == nullptr) throw std::bad_alloc();
    p = static_cast<uint8_t*>(np);
    cap = nc;
  }
  inline void reserve(size_t want) {
    if (want > cap) grow(want);
  }
  inline void ensure(size_t extra) {
    if (n + extra > cap) grow(n + extra);
  }
  inline void push_back(uint8_t b) {
    ensure(1);
    p[n++] = b;
  }
  // caller guarantees 16 readable bytes at ``s`` (len <= 16): one wide
  // copy into the headroom, no branch on len
  inline void append_wide16(const uint8_t* s, size_t len) {
    ensure(len);
    std::memcpy(p + n, s, 16);
    n += len;
  }
  inline void append(const uint8_t* s, size_t len) {
    ensure(len);
    std::memcpy(p + n, s, len);
    n += len;
  }
  inline void append_fill(size_t len, uint8_t v) {
    ensure(len);
    std::memset(p + n, v, len);
    n += len;
  }
};

struct Col {
  int32_t type = 0;
  ByteBuf u8;
  std::vector<int32_t> i32;
  std::vector<int64_t> i64;  // COL_I64 values / COL_STR starts
  std::vector<float> f32;
  std::vector<double> f64;
  int32_t running = 0;  // COL_OFFS running item total
};

// Hostile-input cap on zero-width array/map items per record: null /
// empty-record elements consume no wire bytes, so a claimed block count
// is the one quantity the remaining-bytes bound cannot limit (a 3-byte
// block header may demand 2^60 items). Items of any other shape consume
// >= 1 byte each, which bounds their counts by the record length. Keep
// in sync with fallback/io.py MAX_ZERO_WIDTH_ITEMS so all tiers agree
// on accept-vs-reject.
constexpr int64_t kMaxZeroWidthItems = 1 << 20;

struct Reader {
  const uint8_t* base;  // flat buffer start
  int64_t cur;          // global cursor
  int64_t end;          // record end (global)
  int32_t err = 0;
  int64_t zw = 0;       // zero-width items consumed by this record

  inline uint64_t read_raw_varint() {
    // 1-byte fast path: the overwhelmingly common case on real data
    // (branch indices, block counts, short lengths, small ints)
    if (cur < end) {
      uint8_t b0 = base[cur];
      if (b0 < 0x80) {
        cur++;
        return b0;
      }
      if (end - cur >= 8) {
        // SFVInt-style multi-byte peel (arxiv 2403.06898): load 8 wire
        // bytes at once, find the terminator byte with one ctz over the
        // continuation-bit lane, then compact the 7-bit groups with the
        // classic 3-step pairwise fold — no loop-carried per-byte
        // dependency for every varint up to 56 bits (all lengths,
        // counts, ints and all but astronomically large longs)
        uint64_t w;
        std::memcpy(&w, base + cur, 8);
        uint64_t stops = ~w & 0x8080808080808080ULL;
        if (stops) {
          int nb = (__builtin_ctzll(stops) >> 3) + 1;  // 1..8 bytes
          cur += nb;
          if (nb < 8) w &= (1ULL << (nb * 8)) - 1;
          w &= 0x7F7F7F7F7F7F7F7FULL;
          w = (w & 0x007F007F007F007FULL) |
              ((w & 0x7F007F007F007F00ULL) >> 1);
          w = (w & 0x00003FFF00003FFFULL) |
              ((w & 0x3FFF00003FFF0000ULL) >> 2);
          w = (w & 0x000000000FFFFFFFULL) |
              ((w & 0x0FFFFFFF00000000ULL) >> 4);
          return w;
        }
        if (end - cur >= 10) {  // 9-10 wire bytes in-span: rare giants
          const uint8_t* p = base + cur;
          uint64_t v = b0 & 0x7F;
          int shift = 7;
          for (int k = 1; k < 10; k++) {
            uint8_t byte = p[k];
            v |= (uint64_t)(byte & 0x7F) << shift;
            if (byte < 0x80) {
              cur += k + 1;
              return v;
            }
            shift += 7;
          }
          err |= ERR_VARINT;
          return 0;
        }
      }
    }
    // tail path: per-byte bounds near the record end
    uint64_t v = 0;
    int shift = 0;
    for (int k = 0; k < 10; k++) {
      if (cur >= end) {
        err |= ERR_OVERRUN;
        return 0;
      }
      uint8_t byte = base[cur++];
      v |= (uint64_t)(byte & 0x7F) << shift;
      if (byte < 0x80) return v;
      shift += 7;
    }
    err |= ERR_VARINT;
    return 0;
  }

  inline int64_t read_zigzag() {
    uint64_t u = read_raw_varint();
    return (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
  }

  // An Avro int: a zigzag varint that must lie in int32, as the oracle
  // and the device walks hold it (ERR_INT_RANGE past it, value 0).
  inline int32_t read_int() {
    int64_t v = read_zigzag();
    if (v < INT32_MIN || v > INT32_MAX) {
      err |= ERR_INT_RANGE;
      return 0;
    }
    return (int32_t)v;
  }

  inline bool read_fixed(void* dst, size_t nbytes) {
    if (cur + (int64_t)nbytes > end) {
      err |= ERR_OVERRUN;
      return false;
    }
    std::memcpy(dst, base + cur, nbytes);
    cur += (int64_t)nbytes;
    return true;
  }
};

// ---- per-field decode leaves (shared by VM and generated code) -------

// String: length varint + raw bytes copied into the column's byte
// buffer while they are cache-hot (the Python assembler would
// otherwise re-gather them with a 3-pass numpy fancy-index).
inline void rd_string(Col& c, Reader& r, bool present) {
  int64_t len = 0;
  if (present) {
    len = r.read_zigzag();
    if (len < 0) {
      r.err |= ERR_NEG_LEN;
      len = 0;
    }
    // compare against the REMAINING span: `cur + len` would overflow
    // int64 for a crafted ~2^63 length and dodge the check
    if (len > r.end - r.cur) {
      r.err |= ERR_OVERRUN;
      len = 0;
    }
    // the length lands in the int32 lens lane below: with no datum cap
    // (PYRUHVRO_TPU_MAX_DATUM_BYTES=0) a >2GiB record could otherwise
    // pass the span check and silently wrap the cast — surfaced by the
    // IR verifier's overflow pass (irverify.overflow: string_len_i32;
    // fallback/io.py read_bytes applies the same bound so every tier
    // agrees on accept-vs-reject)
    if (len > (int64_t)INT32_MAX) {
      r.err |= ERR_OVERRUN;
      len = 0;
    }
    if (len) {
      if (len <= 16 && r.end - r.cur >= 16)
        c.u8.append_wide16(r.base + r.cur, (size_t)len);
      else
        c.u8.append(r.base + r.cur, (size_t)len);
      r.cur += len;
    }
  }
  c.i32.push_back((int32_t)len);
}

inline void rd_fixed(Col& c, Reader& r, bool present, int64_t nsz) {
  if (present && nsz <= r.end - r.cur) {
    c.u8.append(r.base + r.cur, (size_t)nsz);
    r.cur += nsz;
  } else {
    if (present) r.err |= ERR_OVERRUN;
    c.u8.append_fill((size_t)nsz, 0);  // keep lengths aligned
  }
}

// Decimal over bytes (fixed_size < 0: length-prefixed) or over fixed
// (fixed_size = wire size): big-endian two's complement of any length
// (non-minimal and over-long sign-extended forms accepted like the
// oracle's int.from_bytes) -> one 16-byte LE decimal128 word.
inline void rd_decimal(Col& c, Reader& r, bool present, int64_t fixed_size) {
  int64_t len = 0;
  if (present) {
    if (fixed_size < 0) {
      len = r.read_zigzag();
      if (len < 0) {
        r.err |= ERR_NEG_LEN;
        len = 0;
      }
    } else {
      len = fixed_size;
    }
    if (len > r.end - r.cur) {
      r.err |= ERR_OVERRUN;
      len = 0;
    }
  }
  uint8_t out16[16];
  uint8_t fill = (len > 0 && (r.base[r.cur] & 0x80)) ? 0xFF : 0x00;
  std::memset(out16, fill, 16);
  int64_t take = len < 16 ? len : 16;
  for (int64_t i = 0; i < take; i++)
    out16[i] = r.base[r.cur + len - 1 - i];
  if (len > 16) {
    for (int64_t i = 0; i + 16 < len; i++)
      if (r.base[r.cur + i] != fill) r.err |= ERR_DEC_RANGE;
    if (((out16[15] & 0x80) ? 0xFF : 0x00) != fill) r.err |= ERR_DEC_RANGE;
  }
  r.cur += present ? len : 0;
  c.u8.append(out16, 16);
}

// ---- Python list[bytes] span collection (GIL held) -------------------

struct Span {
  const uint8_t* ptr;
  Py_ssize_t len;
};

inline bool collect_spans(PyObject* seq, std::vector<Span>& spans,
                          std::vector<Py_buffer>& views,
                          std::vector<PyObject*>& pins) {
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  spans.reserve((size_t)n);
  PyObject** items = PySequence_Fast_ITEMS(seq);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* item = items[i];
    if (PyBytes_Check(item)) {
      // pin the bytes object: the caller's list can be mutated by
      // another Python thread while the GIL is released below, and the
      // list is the only thing keeping these borrowed pointers alive
      Py_INCREF(item);
      pins.push_back(item);
      spans.push_back({reinterpret_cast<const uint8_t*>(
                           PyBytes_AS_STRING(item)),
                       PyBytes_GET_SIZE(item)});
    } else {
      Py_buffer view;  // holds its own reference until released
      if (PyObject_GetBuffer(item, &view, PyBUF_SIMPLE) != 0) {
        PyErr_Format(PyExc_TypeError, "record %zd is not bytes-like", i);
        return false;
      }
      views.push_back(view);
      spans.push_back({static_cast<const uint8_t*>(view.buf), view.len});
    }
  }
  return true;
}

inline void release_spans(std::vector<Py_buffer>& views,
                          std::vector<PyObject*>& pins) {
  for (auto& v : views) PyBuffer_Release(&v);
  for (auto* p : pins) Py_DECREF(p);
}

// ---- zero-copy Arrow-buffer ingestion lane ---------------------------
//
// The Python side may hand the datum batch as the tuple
//   ("arrowbuf", offsets_bufferlike, values_bufferlike, start, n, width)
// (hostpath/codec.py builds it from a pyarrow Binary/LargeBinaryArray's
// own buffers) instead of a list of bytes objects: spans then point
// STRAIGHT into the Arrow values buffer — no per-datum Python object is
// created or touched anywhere on the ingest boundary. ``width`` is the
// offset element width (4 = BinaryArray int32, 8 = LargeBinaryArray
// int64); ``start`` is the array's logical offset into the offsets
// buffer (a sliced array ships the same buffers with a shifted start).
inline bool is_arrowbuf_tuple(PyObject* obj) {
  if (!PyTuple_Check(obj) || PyTuple_GET_SIZE(obj) != 6) return false;
  PyObject* tag = PyTuple_GET_ITEM(obj, 0);
  if (!PyUnicode_Check(tag)) return false;
  const char* t = PyUnicode_AsUTF8(tag);
  if (t == nullptr) {
    PyErr_Clear();
    return false;
  }
  return std::strcmp(t, "arrowbuf") == 0;
}

inline bool collect_spans_arrowbuf(PyObject* tup, std::vector<Span>& spans,
                                   std::vector<Py_buffer>& views,
                                   Py_ssize_t* n_out) {
  PyObject* offs_obj = PyTuple_GET_ITEM(tup, 1);
  PyObject* vals_obj = PyTuple_GET_ITEM(tup, 2);
  Py_ssize_t start = PyLong_AsSsize_t(PyTuple_GET_ITEM(tup, 3));
  Py_ssize_t n = PyLong_AsSsize_t(PyTuple_GET_ITEM(tup, 4));
  long width = PyLong_AsLong(PyTuple_GET_ITEM(tup, 5));
  if (PyErr_Occurred()) return false;
  if (n < 0 || start < 0 || (width != 4 && width != 8)) {
    PyErr_SetString(PyExc_ValueError, "bad arrowbuf descriptor");
    return false;
  }
  Py_buffer ob, vb;
  if (PyObject_GetBuffer(offs_obj, &ob, PyBUF_SIMPLE) != 0) return false;
  views.push_back(ob);
  if (PyObject_GetBuffer(vals_obj, &vb, PyBUF_SIMPLE) != 0) return false;
  views.push_back(vb);
  if ((Py_ssize_t)((start + n + 1) * width) > ob.len) {
    PyErr_SetString(PyExc_ValueError, "arrowbuf offsets buffer too short");
    return false;
  }
  const uint8_t* base = static_cast<const uint8_t*>(vb.buf);
  const int64_t vlen = (int64_t)vb.len;
  spans.reserve((size_t)n);
  if (width == 4) {
    const int32_t* off = static_cast<const int32_t*>(ob.buf) + start;
    for (Py_ssize_t i = 0; i < n; i++) {
      int64_t a = off[i], b = off[i + 1];
      if (a < 0 || b < a || b > vlen) {
        PyErr_Format(PyExc_ValueError,
                     "arrowbuf offsets corrupt at record %zd", i);
        return false;
      }
      spans.push_back({base + a, (Py_ssize_t)(b - a)});
    }
  } else {
    const int64_t* off = static_cast<const int64_t*>(ob.buf) + start;
    for (Py_ssize_t i = 0; i < n; i++) {
      int64_t a = off[i], b = off[i + 1];
      if (a < 0 || b < a || b > vlen) {
        PyErr_Format(PyExc_ValueError,
                     "arrowbuf offsets corrupt at record %zd", i);
        return false;
      }
      spans.push_back({base + a, (Py_ssize_t)(b - a)});
    }
  }
  *n_out = n;
  return true;
}

// Owns one decode call's input spans whichever lane produced them
// (list[bytes] pins + buffer views, or the two arrowbuf views).
struct SpanCollection {
  std::vector<Span> spans;
  std::vector<Py_buffer> views;
  std::vector<PyObject*> pins;
  PyObject* seq = nullptr;
  Py_ssize_t n = 0;
  ~SpanCollection() {
    release_spans(views, pins);
    Py_XDECREF(seq);
  }
};

inline bool collect_input(PyObject* data_obj, SpanCollection& sc) {
  if (is_arrowbuf_tuple(data_obj)) {
    return collect_spans_arrowbuf(data_obj, sc.spans, sc.views, &sc.n);
  }
  sc.seq = PySequence_Fast(data_obj, "data must be a sequence");
  if (!sc.seq) return false;
  sc.n = PySequence_Fast_GET_SIZE(sc.seq);
  return collect_spans(sc.seq, sc.spans, sc.views, sc.pins);
}

struct ShardResult {
  std::vector<Col> cols;
  int64_t err_record = -1;
  int32_t err_bits = 0;
};

// The single place that maps a column builder to its raw output bytes
// (``which`` selects COL_STR's second buffer, the lens).
inline const void* col_data(const Col& col, int32_t ty, int which,
                            size_t* nbytes) {
  switch (ty) {
    case COL_I32:
    case COL_OFFS:
      *nbytes = col.i32.size() * 4;
      return col.i32.data();
    case COL_I64:
      *nbytes = col.i64.size() * 8;
      return col.i64.data();
    case COL_F32:
      *nbytes = col.f32.size() * 4;
      return col.f32.data();
    case COL_F64:
      *nbytes = col.f64.size() * 8;
      return col.f64.data();
    case COL_U8:
      *nbytes = col.u8.size();
      return col.u8.data();
    case COL_STR:
      if (which == 1) {
        *nbytes = col.i32.size() * 4;
        return col.i32.data();
      }
      *nbytes = col.u8.size();
      return col.u8.data();
  }
  *nbytes = 0;
  return nullptr;
}

// One result buffer for column ``c``: allocated at the summed size and
// filled per shard — no intermediate merge vectors for any shard count.
// COL_OFFS running totals rebase during the copy.
inline PyObject* build_col_buffer(const std::vector<ShardResult>& shards,
                                  size_t c, int32_t ty, int which) {
  size_t total = 0, nb = 0;
  for (auto& s : shards) {
    col_data(s.cols[c], ty, which, &nb);
    total += nb;
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)total);
  if (!out) return nullptr;
  char* dst = PyBytes_AS_STRING(out);
  int64_t base = 0;
  for (auto& s : shards) {
    const Col& col = s.cols[c];
    const void* src = col_data(col, ty, which, &nb);
    if (ty == COL_OFFS && base) {
      const int32_t* sp = static_cast<const int32_t*>(src);
      int32_t* dp = reinterpret_cast<int32_t*>(dst);
      for (size_t i = 0; i < nb / 4; i++) {
        int64_t v = base + (int64_t)sp[i];
        if (v > INT32_MAX) {
          Py_DECREF(out);
          PyErr_SetString(PyExc_OverflowError,
                          "item total exceeds int32 offsets");
          return nullptr;
        }
        dp[i] = (int32_t)v;
      }
    } else if (nb) {
      std::memcpy(dst, src, nb);
    }
    dst += nb;
    if (ty == COL_OFFS) base += (int64_t)col.running;
  }
  return out;
}

// Per-column element-count profile of a decoded shard, used to scale
// reserves for the real pass (see the sampling block in decode_boundary).
struct ColProfile {
  std::vector<int64_t> i32n, i64n, f32n, f64n, u8n;
};

inline void profile_of(const ShardResult& s, ColProfile* p) {
  size_t n = s.cols.size();
  p->i32n.resize(n);
  p->i64n.resize(n);
  p->f32n.resize(n);
  p->f64n.resize(n);
  p->u8n.resize(n);
  for (size_t c = 0; c < n; c++) {
    p->i32n[c] = (int64_t)s.cols[c].i32.size();
    p->i64n[c] = (int64_t)s.cols[c].i64.size();
    p->f32n[c] = (int64_t)s.cols[c].f32.size();
    p->f64n[c] = (int64_t)s.cols[c].f64.size();
    p->u8n[c] = (int64_t)s.cols[c].u8.size();
  }
}

inline int pick_threads(int64_t nrows, int requested) {
  if (requested > 0) return requested;
  unsigned hw = std::thread::hardware_concurrency();
  int maxt = (int)(hw ? (hw > 16 ? 16 : hw) : 1);
  // ~4k rows per shard minimum: merging has per-shard fixed cost
  int by_rows = (int)(nrows / 4096);
  int t = by_rows < maxt ? by_rows : maxt;
  return t < 1 ? 1 : t;
}

struct BufferGuard {
  Py_buffer view{};
  bool held = false;
  ~BufferGuard() {
    if (held) PyBuffer_Release(&view);
  }
  bool acquire(PyObject* obj, const char* what) {
    if (PyObject_GetBuffer(obj, &view, PyBUF_SIMPLE) != 0) {
      PyErr_Format(PyExc_TypeError, "%s must be a contiguous buffer", what);
      return false;
    }
    held = true;
    return true;
  }
};

inline PyObject* bytes_from(const void* p, size_t nbytes) {
  return PyBytes_FromStringAndSize(static_cast<const char*>(p),
                                   (Py_ssize_t)nbytes);
}

// ---- shard runner + Python boundary, generic over the decoder --------
//
// ``RecFn`` decodes ONE record: void(Reader&, std::vector<Col>&). The
// interpreter passes a lambda running its bytecode VM; a generated
// module passes its schema-specialized straight-line function. Must be
// copyable and thread-safe (pure function of the wire bytes).

// err_record = -2 in a ShardResult marks an allocation failure (mapped
// to MemoryError at the boundary), never a wire error.
template <class RecFn>
inline void run_shard_t(RecFn rec, const int32_t* coltypes, size_t ncols,
                        const Span* spans, int64_t row_a, int64_t row_b,
                        ShardResult* out, const ColProfile* prof = nullptr,
                        double scale = 0.0) try {
  out->cols.resize(ncols);
  int64_t nrows = row_b - row_a;
  for (size_t c = 0; c < ncols; c++) {
    Col& col = out->cols[c];
    col.type = coltypes[c];
    if (prof != nullptr) {
      // reserves scaled from a sampled row range: growing a multi-
      // hundred-MB vector memcpies its whole payload per doubling, so
      // giant batches must land near their final sizes up front
      col.i32.reserve((size_t)(prof->i32n[c] * scale) + 16);
      col.i64.reserve((size_t)(prof->i64n[c] * scale) + 16);
      col.f32.reserve((size_t)(prof->f32n[c] * scale) + 16);
      col.f64.reserve((size_t)(prof->f64n[c] * scale) + 16);
      col.u8.reserve((size_t)(prof->u8n[c] * scale) + 16);
      continue;
    }
    switch (col.type) {  // row-region columns get exact reserves; item
      case COL_I32:      // columns grow amortized
      case COL_OFFS:
        col.i32.reserve((size_t)nrows);
        break;
      case COL_I64:
        col.i64.reserve((size_t)nrows);
        break;
      case COL_F32:
        col.f32.reserve((size_t)nrows);
        break;
      case COL_F64:
        col.f64.reserve((size_t)nrows);
        break;
      case COL_U8:
        col.u8.reserve((size_t)nrows);
        break;
      case COL_STR:
        col.u8.reserve((size_t)nrows * 12);  // typical short strings
        col.i32.reserve((size_t)nrows);
        break;
    }
  }
  for (int64_t i = row_a; i < row_b; i++) {
    Reader r{spans[i].ptr, 0, spans[i].len, 0};
    rec(r, out->cols);
    if (!r.err && r.cur != r.end) r.err |= ERR_TRAILING;
    if (r.err) {
      out->err_record = i;
      out->err_bits = r.err;
      PYR_PROF_FLUSH();  // publish this shard thread's opcode counters
      return;
    }
  }
  PYR_PROF_FLUSH();
} catch (const std::bad_alloc&) {
  out->err_record = -2;
  PYR_PROF_FLUSH();
}

// Run the whole decode over collected spans: sharding, the sampled-
// reserve prepass and the worker threads (GIL released inside). Shared
// by the plan-buffer boundary below and the fused Arrow boundary
// (arrow_decode_core.h).
template <class RecFn>
inline void run_all_shards(RecFn rec, const int32_t* coltypes, size_t ncols,
                           const SpanCollection& sc, int nthreads,
                           std::vector<ShardResult>& shards) {
  Py_ssize_t n = sc.n;
  int nt = pick_threads(n, nthreads);
  int cap = shard::env_threads_cap();  // PYRUHVRO_TPU_SHARD_THREADS
  if (cap > 0 && nt > cap) nt = cap;
  // NOTE (measured twice, r05): neither sub-sharding the serial path
  // (~4k-row shards, all live) NOR an incremental merge-and-free
  // sub-batch mode reproduced the ~30% gain separate small decode
  // CALLS show (159 vs 225 ns/rec, kafka) — the in-boundary variant's
  // growing accumulators pay realloc/page-fault churn that cancels the
  // builder-locality win. One shard per thread stays; revisit only
  // with a two-pass exact-size merge if this cell matters again.
  shards.resize((size_t)nt);
  const std::vector<Span>& spans = sc.spans;

  Py_BEGIN_ALLOW_THREADS;
  // large batches: decode a small evenly-strided sample first and
  // reserve every column from the scaled profile — without this the
  // builders realloc-copy their multi-hundred-MB payloads ~log2(n)
  // times (measured 3x wall at 10M rows)
  ColProfile prof;
  bool have_prof = false;
  // the prepass is serial; with worker threads, thin the sample so its
  // Amdahl share stays ~1/64 of ONE thread's work, not of the wall
  const int64_t kSampleEvery = 64 * (nt > 1 ? nt : 1);
  // = 4 * the host codec's _PER_CHUNK_ROWS (hostpath/codec.py): the
  // per-chunk decode mode keeps chunks below this, so the prepass only
  // engages for genuinely giant single passes
  if (n > 262144) {
    std::vector<Span> sample;
    sample.reserve((size_t)(n / kSampleEvery) + 1);
    for (int64_t i = 0; i < n; i += kSampleEvery) sample.push_back(spans[i]);
    ShardResult sr;
    run_shard_t(rec, coltypes, ncols, sample.data(), 0,
                (int64_t)sample.size(), &sr);
    if (sr.err_record == -1) {  // NOT -2: an OOM-aborted sample has a
      profile_of(sr, &prof);    // truncated/partial profile — unusable
      have_prof = true;
    }
    // a sampling error is ignored: the real pass reports it exactly
  }
  const ColProfile* pp = have_prof ? &prof : nullptr;
  double total_scale = have_prof
      ? (double)n / (double)((n + kSampleEvery - 1) / kSampleEvery) * 1.08
      : 0.0;
  if (nt <= 1) {
    run_shard_t(rec, coltypes, ncols, spans.data(), 0, n, &shards[0], pp,
                total_scale);
  } else {
    // fan out through the persistent pool (shard_runner.h): the caller
    // runs shard 0 and then steals, workers claim the rest — no thread
    // create/join inside the call. ``rec`` is shared by reference
    // across shards, which its contract allows (stateless per record).
    PYR_PROF_OP(pyr::prof::DOM_VM, pyr::prof::P_SHARD);
    double wall0 = shard::now_s();
    std::vector<double> shard_s((size_t)nt, 0.0);
    int64_t per = n / nt;
    const Span* sp = spans.data();
    shard::Pool::instance().run(nt, [&](int t) {
      double t0 = shard::now_s();
      int64_t a = per * t;
      int64_t b = (t == nt - 1) ? n : per * (t + 1);
      double sc2 = total_scale * ((double)(b - a) / (double)n);
      run_shard_t(rec, coltypes, ncols, sp, a, b, &shards[(size_t)t], pp,
                  sc2);
      shard_s[(size_t)t] = shard::now_s() - t0;  // distinct index per shard
      // reopen attribution on the calling thread so its steal/drain and
      // the completion wait land in the shard pseudo-slot (workers'
      // counters flushed inside run_shard_t)
      if (t == 0) PYR_PROF_OP(pyr::prof::DOM_VM, pyr::prof::P_SHARD);
    });
    shard::Stats::instance().record(nt, shard::now_s() - wall0,
                                    shard_s.data(), nt);
  }
  Py_END_ALLOW_THREADS;
}

// Scan shard results for errors; returns nullptr when decoding may
// proceed, else the (None, err_record, err_bits) result (or sets a
// Python error for OOM shards).
inline PyObject* shard_error_result(const std::vector<ShardResult>& shards) {
  for (auto& s : shards) {
    if (s.err_record == -2) {
      PyErr_NoMemory();
      return nullptr;
    }
    if (s.err_record >= 0)
      return Py_BuildValue("(OLi)", Py_None, (long long)s.err_record,
                           (int)s.err_bits);
  }
  return nullptr;
}

// The legacy plan-buffer list: one output buffer per column (two for
// COL_STR), allocated at the summed size and filled per shard by
// build_col_buffer — COL_OFFS rebases during the copy, every other type
// is a straight memcpy.
inline PyObject* build_plan_buffers(const std::vector<ShardResult>& shards,
                                    const int32_t* coltypes, size_t ncols) {
  PyObject* bufs = PyList_New(0);
  if (!bufs) return nullptr;
  for (size_t c = 0; c < ncols; c++) {
    int32_t ty = coltypes[c];
    if (ty < 0 || ty > COL_OFFS) {
      Py_DECREF(bufs);
      PyErr_Format(PyExc_ValueError, "unknown column type %d", (int)ty);
      return nullptr;
    }
    int nparts = ty == COL_STR ? 2 : 1;
    for (int which = 0; which < nparts; which++) {
      PyObject* b = build_col_buffer(shards, c, ty, which);
      if (!b || PyList_Append(bufs, b) != 0) {
        Py_XDECREF(b);
        Py_DECREF(bufs);
        return nullptr;
      }
      Py_DECREF(b);
    }
  }
  return bufs;
}

// decode boundary: (coltypes, data, nthreads) with the decoder
// supplied by the caller -> (buffers: list[bytes], err_record, err_bits)
// ``data`` is the caller's list[bytes] (records decode straight from
// the original Python buffers — span collection under the GIL, like
// the packer shim, so no host-side concatenation pass or flat copy
// exists at all) or the zero-copy ``("arrowbuf", ...)`` descriptor of a
// pyarrow Binary/LargeBinaryArray's own buffers. Buffer order: for each
// column in order — COL_STR contributes two entries (value bytes uint8,
// len int32); others one. COL_OFFS buffers carry running totals only;
// Python prepends the 0.
template <class RecFn>
inline PyObject* decode_boundary(RecFn rec, PyObject* coltypes_obj,
                                 PyObject* list_obj, int nthreads) {
  BufferGuard ct_b;
  if (!ct_b.acquire(coltypes_obj, "coltypes")) return nullptr;
  const int32_t* coltypes = static_cast<const int32_t*>(ct_b.view.buf);
  size_t ncols = (size_t)(ct_b.view.len / sizeof(int32_t));

  SpanCollection sc;
  PYR_PROF_OP(pyr::prof::DOM_VM, pyr::prof::P_COLLECT);
  bool spans_ok = collect_input(list_obj, sc);
  PYR_PROF_STOP();
  if (!spans_ok) return nullptr;

  std::vector<ShardResult> shards;
  run_all_shards(rec, coltypes, ncols, sc, nthreads, shards);
  PyObject* err = shard_error_result(shards);
  if (err != nullptr || PyErr_Occurred()) return err;

  PYR_PROF_OP(pyr::prof::DOM_VM, pyr::prof::P_MERGE);
  PyObject* bufs = build_plan_buffers(shards, coltypes, ncols);
  if (!bufs) return nullptr;
  PyObject* out = Py_BuildValue("(OLi)", bufs, (long long)-1, 0);
  Py_DECREF(bufs);
  PYR_PROF_FLUSH();
  return out;
}


// shard_stats() -> dict: snapshot-and-clear of the shard-runner's
// cumulative fan-out counters (shard_runner.h). Python's fanout_stats
// derives pool.chunk_efficiency from busy/wall/shards without any
// per-shard Python call existing. GIL held.
inline PyObject* shard_stats_py() {
  shard::StatsSnap s = shard::Stats::instance().drain();
  return Py_BuildValue(
      "{s:K,s:K,s:d,s:d,s:i}", "fanouts", (unsigned long long)s.fanouts,
      "shards", (unsigned long long)s.shards, "shard_s", s.shard_s,
      "wall_s", s.wall_s, "threads", s.last_threads);
}

// ===================== encode (Arrow -> Avro wire) ====================
//
// Same sharing story as decode: the extracted-column cursors, writer
// sinks and per-field emit leaves live here, used by BOTH the generic
// encode VM (host_codec.cpp) and generated schema-specialized encoders.

struct InCol {
  const uint8_t* u8 = nullptr;
  const int32_t* i32 = nullptr;
  const int64_t* i64 = nullptr;
  const float* f32 = nullptr;
  const double* f64 = nullptr;
  const uint8_t* bytes = nullptr;  // COL_STR value bytes
  size_t cur = 0;                  // entry cursor
  size_t bcur = 0;                 // COL_STR byte cursor
};

// Output sinks: RawWriter assumes the caller allocated the extractor's
// byte BOUND upfront (a strict upper bound on the wire total,
// ops/encode.py), so every write is unchecked; VecWriter is the
// capacity-checked fallback when no bound is available.
struct RawWriter {
  uint8_t* p;
  const uint8_t* base;
  inline void push(uint8_t b) { *p++ = b; }
  inline void append(const void* s, size_t n) {
    std::memcpy(p, s, n);
    p += n;
  }
  inline size_t pos() const { return (size_t)(p - base); }
};

// Debug writer (PYRUHVRO_DEBUG_BOUNDS=1): same contract as RawWriter
// but never writes past ``end`` — overage is counted and reported as a
// hard error at the boundary, making a bound under-estimate an
// exception instead of heap corruption.
struct CheckedRawWriter {
  uint8_t* p;
  const uint8_t* base;
  const uint8_t* end;
  size_t over = 0;
  inline void push(uint8_t b) {
    if (p < end) *p++ = b;
    else over++;
  }
  inline void append(const void* s, size_t n) {
    size_t room = (size_t)(end - p);
    size_t w = n < room ? n : room;
    std::memcpy(p, s, w);
    p += w;
    over += n - w;
  }
  inline size_t pos() const { return (size_t)(p - base) + over; }
};

struct VecWriter {
  std::vector<uint8_t>* v;
  inline void push(uint8_t b) { v->push_back(b); }
  inline void append(const void* s, size_t n) {
    const uint8_t* s8 = static_cast<const uint8_t*>(s);
    v->insert(v->end(), s8, s8 + n);
  }
  inline size_t pos() const { return v->size(); }
};

template <class W>
inline void write_varint(W& out, uint64_t v) {
  if (v < 0x80) {  // dominant case: branch bytes, counts, short lengths
    out.push((uint8_t)v);
    return;
  }
  while (v >= 0x80) {
    out.push((uint8_t)(v | 0x80));
    v >>= 7;
  }
  out.push((uint8_t)v);
}

template <class W>
inline void write_zigzag(W& out, int64_t v) {
  write_varint(out, ((uint64_t)v << 1) ^ (uint64_t)(v >> 63));
}

inline int bitlen128(unsigned __int128 a) {
  uint64_t hi = (uint64_t)(a >> 64), lo = (uint64_t)a;
  if (hi) return 128 - __builtin_clzll(hi);
  if (lo) return 64 - __builtin_clzll(lo);
  return 0;
}

// ---- per-field emit leaves (shared by VM and generated code) ---------

template <class W>
inline void wr_string(W& out, InCol& c, bool present) {
  int32_t len = c.i32[c.cur++];
  if (present) {
    write_zigzag(out, (int64_t)len);
    if (len) out.append(c.bytes + c.bcur, (size_t)len);
  }
  c.bcur += (size_t)len;
}

// 16B LE decimal128 word -> big-endian two's complement; the length
// rule reproduces the oracle exactly: max((abs_bit_length + 8) // 8, 1),
// i.e. deliberately non-minimal for negative powers of two.
// ``fixed_size < 0`` = decimal-over-bytes (length-prefixed). Returns
// false when a fixed-size decimal does not fit its wire size
// (≙ int.to_bytes overflow in the oracle).
template <class W>
inline bool wr_decimal(W& out, InCol& c, bool present, int64_t fixed_size) {
  const uint8_t* p = c.u8 + c.cur;
  c.cur += 16;
  if (!present) return true;
  unsigned __int128 v = 0;
  for (int i = 15; i >= 0; i--) v = (v << 8) | p[i];
  bool neg = (p[15] & 0x80) != 0;
  unsigned __int128 a = neg ? (unsigned __int128)(~v + 1) : v;
  int bits = bitlen128(a);
  int64_t n;
  if (fixed_size < 0) {
    n = ((int64_t)bits + 8) / 8;
    if (n < 1) n = 1;
    write_zigzag(out, n);
  } else {
    n = fixed_size;
    if (n < 16) {  // signed-range fit (≙ int.to_bytes overflow)
      unsigned __int128 lim = (unsigned __int128)1 << (8 * n - 1);
      if (neg ? (a > lim) : (a >= lim)) return false;
    }
  }
  for (int64_t i = 0; i < n; i++) {
    int shift = (int)(8 * (n - 1 - i));
    out.push(shift >= 128 ? (neg ? 0xFF : 0x00) : (uint8_t)(v >> shift));
  }
  return true;
}

// The generic bytecode encode VM: the opcode program run in reverse —
// per-column entry cursors consume the dense extracted arrays
// sequentially, emitting wire bytes. Lives in the shared core (not
// host_codec.cpp) so the Arrow-native extractor module can run the
// same interpreter fused behind its extraction pass. Absent subtrees
// (null branch / non-selected union arm) consume their entries without
// emitting — the exact mirror of the decoder's default-appending mode.
template <class W>
class EncVm {
 public:
  EncVm(const Op* ops, std::vector<InCol>* cols, W* out)
      : ops_(ops), cols_(cols), out_(out) {}

  bool err = false;  // decimal didn't fit its fixed size

  size_t exec(size_t pc, bool present) {
    const Op& op = ops_[pc];
    PYR_PROF_OP(pyr::prof::DOM_ENC, op.kind);
    switch (op.kind) {
      case OP_RECORD: {
        size_t p = pc + 1, stop = pc + op.nops;
        while (p < stop) p = exec(p, present);
        return p;
      }
      case OP_INT:
      case OP_ENUM: {
        InCol& c = (*cols_)[op.col];
        int32_t v = c.i32[c.cur++];
        if (present) write_zigzag(*out_, (int64_t)v);
        return pc + 1;
      }
      case OP_LONG: {
        InCol& c = (*cols_)[op.col];
        int64_t v = c.i64[c.cur++];
        if (present) write_zigzag(*out_, v);
        return pc + 1;
      }
      case OP_FLOAT: {
        InCol& c = (*cols_)[op.col];
        float v = c.f32[c.cur++];
        if (present) {
          uint8_t b[4];
          std::memcpy(b, &v, 4);
          out_->append(b, 4);
        }
        return pc + 1;
      }
      case OP_DOUBLE: {
        InCol& c = (*cols_)[op.col];
        double v = c.f64[c.cur++];
        if (present) {
          uint8_t b[8];
          std::memcpy(b, &v, 8);
          out_->append(b, 8);
        }
        return pc + 1;
      }
      case OP_BOOL: {
        InCol& c = (*cols_)[op.col];
        uint8_t v = c.u8[c.cur++];
        if (present) out_->push(v ? 1 : 0);
        return pc + 1;
      }
      case OP_STRING: {
        wr_string(*out_, (*cols_)[op.col], present);
        return pc + 1;
      }
      case OP_FIXED: {
        InCol& c = (*cols_)[op.col];
        size_t nsz = (size_t)op.a;
        if (present) out_->append(c.u8 + c.cur, nsz);
        c.cur += nsz;
        return pc + 1;
      }
      case OP_DEC_BYTES:
      case OP_DEC_FIXED: {
        if (!wr_decimal(*out_, (*cols_)[op.col], present,
                        op.kind == OP_DEC_BYTES ? -1 : op.a))
          err = true;
        return pc + 1;
      }
      case OP_NULL:
        return pc + 1;
      case OP_NULLABLE: {
        InCol& c = (*cols_)[op.col];
        uint8_t valid = c.u8[c.cur++];
        if (present)
          write_zigzag(*out_, valid ? (int64_t)(1 - op.a) : (int64_t)op.a);
        return exec(pc + 1, present && valid);
      }
      case OP_UNION: {
        InCol& c = (*cols_)[op.col];
        int32_t tid = c.i32[c.cur++];
        if (present) write_zigzag(*out_, (int64_t)tid);
        size_t p = pc + 1;
        for (int32_t k = 0; k < op.a; k++)
          p = exec(p, present && k == tid);
        return p;
      }
      case OP_ARRAY:
      case OP_MAP: {
        InCol& c = (*cols_)[op.col];
        int32_t count = c.i32[c.cur++];
        bool is_map = op.kind == OP_MAP;
        if (present && count > 0) write_zigzag(*out_, (int64_t)count);
        for (int32_t i = 0; i < count; i++) {
          if (is_map) wr_string(*out_, (*cols_)[op.b], present);
          exec(pc + 1, present);
        }
        if (present) out_->push(0);  // block terminator
        return pc + 1 + ops_[pc + 1].nops;
      }
      case OP_FIXED_RUN: {
        // encode has no span check to hoist — the header is dispatch
        // grouping only; members emit exactly as in the raw program
        size_t p = pc + 1, stop = pc + op.nops;
        while (p < stop) p = exec(p, present);
        return p;
      }
    }
    return pc + 1;  // unreachable for well-formed programs
  }

 private:
  const Op* ops_;
  std::vector<InCol>* cols_;
  W* out_;
};

// The VM-backed per-record encoder functor shared by the generic
// boundary (host_codec.cpp py_encode) and the Arrow-native fused
// boundary (extract.cpp): encodes ONE record, false on decimal misfit.
struct VmEncRec {
  const Op* ops;
  template <class W>
  bool operator()(W& w, std::vector<InCol>& cols) const {
    EncVm<W> vm(ops, &cols, &w);
    vm.exec(0, true);
    return !vm.err;
  }
};

// The per-record encode loop, generic over BOTH the writer strategy and
// the per-record encoder. ``Rec`` is a functor with
// ``template<class W> bool operator()(W&, std::vector<InCol>&)`` that
// encodes ONE record and returns false on a decimal range error.
// ``offs`` has n+1 slots and receives the ARROW OFFSETS layout directly
// (leading 0, then the running wire position after each record) — the
// caller wraps it in a BinaryArray with no Python-side prefix-sum pass.
template <class Rec, class W>
inline void run_encode_t(Rec rec, std::vector<InCol>& cols, W& w,
                         Py_ssize_t n, int32_t* offs, bool* overflow,
                         bool* vm_err) {
  offs[0] = 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    if (!rec(w, cols)) {
      *vm_err = true;
      PYR_PROF_FLUSH();
      return;
    }
    size_t pos = w.pos();
    if (pos > (size_t)INT32_MAX) {
      *overflow = true;
      PYR_PROF_FLUSH();
      return;
    }
    offs[i + 1] = (int32_t)pos;
  }
  PYR_PROF_FLUSH();
}

// encode boundary: (coltypes, buffers, n, size_hint) with the encoder
// supplied by the caller -> (blob: bytes, offsets: bytes of n+1 int32,
// leading 0 — the Arrow Binary offsets layout, ready for
// ``pa.Array.from_buffers`` with no Python-side prefix sum). ``buffers``
// follows the decode buffer order (COL_STR: bytes then lens);
// ``size_hint`` (the extractor's byte bound) pre-sizes the output so
// the hot loop never reallocates. Raises OverflowError when the wire
// total exceeds int32 offsets (callers split the batch).
template <class Rec>
inline PyObject* encode_boundary(Rec rec, PyObject* coltypes_obj,
                                 PyObject* bufs_obj, Py_ssize_t n,
                                 Py_ssize_t size_hint, int checked = 0) {
  BufferGuard ct_b;
  if (!ct_b.acquire(coltypes_obj, "coltypes")) return nullptr;
  const int32_t* coltypes = static_cast<const int32_t*>(ct_b.view.buf);
  size_t ncols = (size_t)(ct_b.view.len / sizeof(int32_t));

  PyObject* seq = PySequence_Fast(bufs_obj, "buffers must be a sequence");
  if (!seq) return nullptr;
  // a bad_alloc must become MemoryError, never cross the extern-C
  // boundary into std::terminate (tight-memory path by definition)
  std::vector<BufferGuard> guards;
  std::vector<InCol> cols;
  try {
    guards.resize((size_t)PySequence_Fast_GET_SIZE(seq));
    cols.resize(ncols);
  } catch (const std::bad_alloc&) {
    Py_DECREF(seq);
    PyErr_NoMemory();
    return nullptr;
  }
  size_t bi = 0;
  bool ok = true;
  for (size_t c = 0; c < ncols && ok; c++) {
    InCol& col = cols[c];
    switch (coltypes[c]) {
      case COL_STR: {
        if (bi + 2 > guards.size() ||
            !guards[bi].acquire(PySequence_Fast_GET_ITEM(seq, (Py_ssize_t)bi),
                                "buffer") ||
            !guards[bi + 1].acquire(
                PySequence_Fast_GET_ITEM(seq, (Py_ssize_t)(bi + 1)),
                "buffer")) {
          ok = false;
          break;
        }
        col.bytes = static_cast<const uint8_t*>(guards[bi].view.buf);
        col.i32 = static_cast<const int32_t*>(guards[bi + 1].view.buf);
        bi += 2;
        break;
      }
      default: {
        if (bi + 1 > guards.size() ||
            !guards[bi].acquire(PySequence_Fast_GET_ITEM(seq, (Py_ssize_t)bi),
                                "buffer")) {
          ok = false;
          break;
        }
        const void* p = guards[bi].view.buf;
        col.u8 = static_cast<const uint8_t*>(p);
        col.i32 = static_cast<const int32_t*>(p);
        col.i64 = static_cast<const int64_t*>(p);
        col.f32 = static_cast<const float*>(p);
        col.f64 = static_cast<const double*>(p);
        bi += 1;
        break;
      }
    }
  }
  if (!ok || bi != guards.size()) {
    Py_DECREF(seq);
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_ValueError, "buffer count mismatch with coltypes");
    return nullptr;
  }

  std::vector<int32_t> sizes;
  try {
    sizes.resize((size_t)n + 1);  // Arrow offsets: n+1 slots, leading 0
  } catch (const std::bad_alloc&) {
    Py_DECREF(seq);
    PyErr_NoMemory();
    return nullptr;
  }
  bool overflow = false;
  bool vm_err = false;

  // Fast path: ``size_hint`` is the extractor's strict upper bound on
  // the wire total (ops/encode.py sums per-type varint maxima + exact
  // string bytes), so the final blob is allocated ONCE at the bound and
  // every write is an unchecked raw-pointer store; the bytes object is
  // shrunk to the real size at the end. Falls back to the
  // capacity-checked vector writer when no bound is given or the eager
  // allocation fails.
  PyObject* blob = nullptr;
  if (size_hint > 0) blob = PyBytes_FromStringAndSize(nullptr, size_hint);
  if (blob != nullptr) {
    uint8_t* base = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(blob));
    size_t endpos;
    if (checked) {
      CheckedRawWriter w{base, base, base + size_hint};
      Py_BEGIN_ALLOW_THREADS;
      run_encode_t(rec, cols, w, n, sizes.data(), &overflow, &vm_err);
      Py_END_ALLOW_THREADS;
      if (w.over) {
        Py_DECREF(seq);
        Py_DECREF(blob);
        PyErr_Format(
            PyExc_RuntimeError,
            "encode bound violated: writer overran the extractor's "
            "%zd-byte bound by %zu bytes (PYRUHVRO_DEBUG_BOUNDS)",
            size_hint, w.over);
        return nullptr;
      }
      endpos = w.pos();
    } else {
      RawWriter w{base, base};
      Py_BEGIN_ALLOW_THREADS;
      run_encode_t(rec, cols, w, n, sizes.data(), &overflow, &vm_err);
      Py_END_ALLOW_THREADS;
      endpos = w.pos();
    }
    Py_DECREF(seq);
    if (overflow || vm_err) {
      Py_DECREF(blob);
      PyErr_SetString(PyExc_OverflowError,
                      overflow ? "encoded batch exceeds int32 binary offsets"
                               : "decimal value does not fit its fixed size");
      return nullptr;
    }
    if (_PyBytes_Resize(&blob, (Py_ssize_t)endpos) != 0)
      return nullptr;  // blob already decref'd by _PyBytes_Resize
  } else {
    PyErr_Clear();  // bound allocation failed: geometric growth instead
    std::vector<uint8_t> out;
    bool oom = false;
    Py_BEGIN_ALLOW_THREADS;
    // this branch runs exactly when memory is already tight (the eager
    // bound allocation above failed, or bound > int32) — a bad_alloc
    // here must become a Python MemoryError, not std::terminate across
    // the extern-C boundary (ADVICE r04)
    try {
      try {
        out.reserve((size_t)n * 32);
      } catch (const std::bad_alloc&) {
        // the reserve is only a pre-size hint; geometric growth remains
      }
      VecWriter w{&out};
      run_encode_t(rec, cols, w, n, sizes.data(), &overflow, &vm_err);
    } catch (const std::bad_alloc&) {
      oom = true;
    }
    Py_END_ALLOW_THREADS;
    Py_DECREF(seq);
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
    blob = bytes_from(out.data(), out.size());
    if (!blob) return nullptr;
  }

  PyObject* szb = bytes_from(sizes.data(), sizes.size() * 4);
  if (!szb) {
    Py_DECREF(blob);
    return nullptr;
  }
  PyObject* res = Py_BuildValue("(OO)", blob, szb);
  Py_DECREF(blob);
  Py_DECREF(szb);
  return res;
}

}  // namespace pyr

#endif  // PYRUHVRO_HOST_VM_CORE_H_
