// decode_walk.cu — the pipeline engine's walk (K1) on Hopper: the Avro
// field program over every record of a launch, one thread per record.
//
// Replaces the walk of the reference's default decode engine,
// pyruhvro_tpu/ops/decode.py DeviceDecoder._trace_walk (:373-400), which
// runs the emitters of pyruhvro_tpu/ops/fieldprog.py (:134-500) as one
// lane-masked lockstep program over all R lanes inside the jitted pipeline.
// It executes the flat int32 code of pyruhvro_tpu_torch/ops/fieldprog.py;
// one build serves every schema (code, caps and buffer tables are
// arguments). Its plain PyTorch version is walk_plain in ops/decode.py.
//
// What it computes, per record: LEB128 varints with zig-zag into (lo, hi)
// u32, float and double bit patterns, bools, enum and union indices with
// range checks, nullable validity, (start, len) string descriptors with
// absolute starts, the array/map block loop at any nesting depth into
// strided slots parent_slot*icap+cnt (int32, wrapping; ERR_ITEM_OVERFLOW
// past the cap, the slot then 2^30 and dropped), OR-accumulated error bits
// and ERR_TRAILING. Every output element is written by the kernel, zeros
// included, so the wrapper allocates the outputs with torch.empty.
//
// Reads. Cursors are absolute in one flat word buffer of the whole launch
// (the reference's jnp.take(words, widx, mode="clip")): byte k of the
// window at cursor c, read as unsigned, is byte (c&3)+k of word
// min((c>>2) + (((c&3)+k)>>2), n_words-1). A read past a record's end sees
// the next record's bytes, as in the reference; #err depends on it.
//
// Writes. A thread owns its row's contiguous range of every buffer (the
// row's slot for the row region, its [row*P, (row+1)*P) slots for an item
// region with P the product of the caps down the ancestry); the block zeroes
// its rows' ranges and then walks, so no thread writes into another's
// range. One exception: the items under a dropped item (slot 2^30) get
// slots 2^30*icap+cnt, which wrap into the first record's range, and the
// reference lets the last such write win. The kernel does not store those:
// it appends them to a log (buffer, slot, value, lane, the iteration
// counters of the open loops), and the wrapper applies the log in the
// reference's order after the launch. Only rungs with ERR_ITEM_OVERFLOW
// lanes have such writes, and the capacity ladder retries them.
//
// The loop bound. The reference runs each array/map loop in lockstep over
// all lanes in its mask, for at most max(ends - cursor over those lanes, 0
// for the others) + icap + 2 iterations in wrapping int32, taken anew at
// every entry of a nested loop, once per iteration of the enclosing loops.
// A thread cannot see the other lanes, but a live lane's own iteration
// counter equals the lockstep counter, so one loop instance is named by
// its key (region, counters of the enclosing loops). A lane first bounds a
// loop by its own span (never more than the global value, so a lane that
// finishes is exact); each key records its lanes' span max and count
// (warp-aggregated atomics) and whether a lane was cut by its own bound.
// The wrapper then relaunches with the recorded bound of every key where a
// lane was cut (spec/has_spec), until the bounds settle. The key table is
// sized from the counters seen: a region's keys number the product of the
// extents of its ancestors' counters (ext, 0 at first). A lane whose key
// lies off the table is bounded by its own span alone; if it is cut there,
// the launch records its counters (it_max) and off_cut, and the wrapper
// widens the table to hold them and relaunches. So a bound is never
// guessed: a key either finishes within its lanes' own spans or runs with
// the value the reference computes.
//
// Bound on an H100 SXM: memory. A launch must read the records' bytes
// (the words buffer, contiguous), starts and lengths, and write every
// output element and #err once: (those bytes) / 3.35 TB/s. This first
// design is simple: bytes are read from device memory through the
// read-only cache; the code and tables sit in shared memory; the warp
// steps by its lowest pc (__reduce_min_sync), so lanes that took different
// branches or item counts rejoin where the paths meet; outputs are zeroed
// by 16-byte stores and then stored into directly.
//
// Arithmetic on cursors and slots is done in uint32_t and reinterpreted:
// the reference wraps in int32, which is undefined behaviour for int32_t
// in C++.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

// opcodes: keep in step with pyruhvro_tpu_torch/ops/fieldprog.py
#define OP_END 0
#define OP_LONG 1
#define OP_INT 2
#define OP_FLOAT 3
#define OP_DOUBLE 4
#define OP_BOOL 5
#define OP_STRING 6
#define OP_FIXED 7
#define OP_ENUM 8
#define OP_NULLABLE 9
#define OP_UNION 10
#define OP_JUMP 11
#define OP_REPEATED 12
#define OP_LOOP 13
#define OP_TRAILING 14
#define OP_REBASE 15

// error bits: keep in step with pyruhvro_tpu_torch/ops/varint.py
#define ERR_VARINT 1u
#define ERR_NEG_LEN 2u
#define ERR_OVERRUN 4u
#define ERR_BAD_BRANCH 8u
#define ERR_BAD_ENUM 16u
#define ERR_TRAILING 32u
#define ERR_BAD_BOOL 64u
#define ERR_ITEM_OVERFLOW 128u

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDepth = 8;         // open loops a thread keeps (its stack)
constexpr int kLogWords = 4;         // b, slot, value, lane; then counters
constexpr int32_t kBig = 1 << 30;    // a slot past the cap: dropped
constexpr int kDone = INT_MAX;       // the pc of a lane that has ended

struct Params {
  const uint8_t* words;              // the launch's bytes
  uint32_t last_word;
  const int32_t* starts;             // [R]
  const int32_t* lengths;            // [R]
  int n;                             // active lanes
  int R;
  // code[code_len] | caps[nr] | parents[nr] | esize[nb] | region[nb]
  const int32_t* table;
  int code_len, n_bufs, n_regions, depth;
  const long long* buf_ptrs;         // [nb] device pointers, 16-B aligned
  const long long* buf_lens;         // [nb] elements
  const int32_t* key_tab;            // ext[nr] | key_off[nr]
  const int32_t* spec;               // [n_keys]
  const int32_t* has_spec;           // [n_keys]
  int n_keys;
  int32_t* status;                   // see the wrapper's WalkLaunch
  int32_t* log;                      // [log_cap, kLogWords + max(depth, 1)]
  int log_cap;
  uint32_t* err;                     // [R]
};

// The block's shared tables.
struct Tabs {
  const int32_t* code;
  const int32_t* caps;
  const int32_t* esize;
  const int32_t* ext;
  const int32_t* key_off;
  void* const* dst;                  // buffer base pointers
  const long long* len;              // buffer lengths
};

struct Level {                       // one open array/map loop
  int rep_pc, rid, icap, key;
  int32_t rem, cnt, it, bound;
  int32_t base;                      // the slot its items hang under
  bool base_wrapped, done, own;
};

struct Lane {
  int32_t cur, end;
  uint32_t err;
  int row;
  int top;                           // open loops
  Level lv[kMaxDepth];
};

__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ uint32_t win_byte(const Params& P, uint32_t c,
                                             uint32_t k) {
  const uint32_t m = (c & 3u) + k;
  const uint32_t w = min((c >> 2) + (m >> 2), P.last_word);
  return (uint32_t)__ldg(P.words + ((size_t)w << 2) + (m & 3u));
}

__device__ __forceinline__ uint32_t win_word(const Params& P, uint32_t c,
                                             uint32_t k) {
  return win_byte(P, c, k) | (win_byte(P, c, k + 1) << 8) |
         (win_byte(P, c, k + 2) << 16) | (win_byte(P, c, k + 3) << 24);
}

// One unsigned LEB128 varint (at most 10 bytes) at the cursor.
__device__ void read_varint(const Params& P, Lane& L, uint32_t& lo,
                            uint32_t& hi) {
  const uint32_t c = (uint32_t)L.cur;
  lo = 0;
  hi = 0;
  uint32_t n = 0;
  bool more = true;
  for (int k = 0; k < 10 && more; ++k) {
    const uint32_t b = win_byte(P, c, k);
    const uint32_t g = b & 0x7Fu;
    const int s = 7 * k;
    if (s < 32) {
      lo |= g << s;
      if (s + 7 > 32) hi |= g >> (32 - s);
    } else {
      hi |= g << (s - 32);
    }
    ++n;
    more = b >= 0x80u;
  }
  L.cur = (int32_t)(c + n);
  if (more) L.err |= ERR_VARINT;
}

__device__ __forceinline__ void read_long(const Params& P, Lane& L,
                                          uint32_t& lo, uint32_t& hi) {
  read_varint(P, L, lo, hi);
  const uint32_t m = 0u - (lo & 1u);
  const uint32_t lo1 = (lo >> 1) | (hi << 31);
  const uint32_t hi1 = hi >> 1;
  lo = lo1 ^ m;
  hi = hi1 ^ m;
}

__device__ __forceinline__ int32_t read_branch(const Params& P, Lane& L) {
  uint32_t lo, hi;
  read_long(P, L, lo, hi);
  if (hi != 0) L.err |= ERR_BAD_BRANCH;
  return (int32_t)lo;
}

// The slot and wrapped flag the current position writes to: the row for
// the row region, else the innermost loop's item slot.
__device__ __forceinline__ void context(const Lane& L, int32_t& slot,
                                        bool& wrapped) {
  if (L.top == 0) {
    slot = L.row;
    wrapped = false;
    return;
  }
  const Level& S = L.lv[L.top - 1];
  slot = S.cnt < S.icap
             ? (int32_t)((uint32_t)S.base * (uint32_t)S.icap + (uint32_t)S.cnt)
             : kBig;
  wrapped = S.base_wrapped;
}

// One store: direct into the lane's own range, or, for a slot under a
// dropped item, into the log. Slots outside the buffer are dropped, a
// negative wrapped slot counting from the end (jnp's scatter, mode="drop").
__device__ void put(const Params& P, const Tabs& T, const Lane& L, int b,
                    uint32_t v) {
  int32_t slot;
  bool wrapped;
  context(L, slot, wrapped);
  long long s = slot;
  if (wrapped && s < 0) s += T.len[b];
  if (s < 0 || s >= T.len[b]) return;
  if (!wrapped) {
    if (T.esize[b] == 1) {
      static_cast<uint8_t*>(T.dst[b])[s] = (uint8_t)v;
    } else {
      static_cast<uint32_t*>(T.dst[b])[s] = v;
    }
    return;
  }
  const int width = kLogWords + max(P.depth, 1);
  int32_t* log_n = P.status + 3 * max(P.n_keys, 1) + 2 * P.n_regions;
  const int at = atomicAdd(log_n, 1);
  if (at >= P.log_cap) return;  // the wrapper grows the log and relaunches
  int32_t* e = P.log + (size_t)at * width;
  e[0] = b;
  e[1] = (int32_t)s;
  e[2] = (int32_t)v;
  e[3] = L.row;
  for (int i = 0; i < width - kLogWords; ++i) {
    e[kLogWords + i] = i < L.top ? L.lv[i].it : 0;
  }
}

// The key of a loop of region rid entered now: its index in the table, or
// -1 when a counter of an enclosing loop lies past its extent.
__device__ __forceinline__ int key_of(const Tabs& T, const Lane& L, int rid) {
  long long k = 0;
  for (int i = 0; i < L.top; ++i) {
    const int e = T.ext[L.lv[i].rid];
    if (L.lv[i].it >= e) return -1;
    k = k * e + L.lv[i].it;
  }
  return T.key_off[rid] + (int)k;
}

// A lane that ran out of iterations under its own bound.
__device__ void record_cut(const Params& P, const Lane& L, const Level& S) {
  const int T = max(P.n_keys, 1);
  if (S.key >= 0) {
    P.status[2 * T + S.key] = 1;
    return;
  }
  int32_t* it_max = P.status + 3 * T;
  int32_t* off_cut = it_max + P.n_regions;
  off_cut[S.rid] = 1;
  for (int i = 0; i < L.top - 1; ++i) atomicMax(&it_max[L.lv[i].rid], L.lv[i].it);
}

// Runs the innermost loop's iterations up to its next item. True when an
// item is to be decoded; false when the loop has ended (it is popped and
// its count written where the enclosing position writes).
__device__ bool loop_next(const Params& P, const Tabs& T, Lane& L) {
  Level& S = L.lv[L.top - 1];
  for (;;) {
    if (S.done || S.it >= S.bound) {
      if (!S.done) {
        L.err |= ERR_OVERRUN;  // ran out of iterations: malformed
        if (S.own) record_cut(P, L, S);
      }
      const int count_buf = T.code[S.rep_pc + 1];
      const int32_t cnt = S.cnt;
      L.top -= 1;
      put(P, T, L, count_buf, (uint32_t)cnt);
      return false;
    }
    if (S.rem == 0) {  // block header
      uint32_t lo, hi;
      read_long(P, L, lo, hi);
      int32_t b = (int32_t)lo;
      // a count whose high word is neither a zero- nor a sign-extension
      // of the low word would truncate
      const bool fits = (hi == 0u && b >= 0) || (hi == 0xFFFFFFFFu && b < 0);
      if (!fits) {
        L.err |= ERR_OVERRUN;
        b = 0;
      }
      if (b < 0) {  // negative count: a byte-size long follows; skip it
        uint32_t slo, shi;
        read_varint(P, L, slo, shi);
        b = (int32_t)(0u - (uint32_t)b);
      }
      if (b == 0) S.done = true;
      S.rem = b;
    }
    if (!S.done && L.cur > L.end) {
      L.err |= ERR_OVERRUN;
      S.done = true;
    }
    if (!S.done && S.rem > 0) {
      if (S.cnt >= S.icap) L.err |= ERR_ITEM_OVERFLOW;
      return true;
    }
    if (!S.done && S.rem < 0) {
      // -2^31 items: nothing changes until the bound ends the loop
      S.it = S.bound;
      continue;
    }
    S.it += 1;
  }
}

// Enters the array/map loop at pc for the lane. Every lane of `run` (the
// lanes of the warp at this pc) calls it: the span records are aggregated
// per key across the warp before the atomics.
__device__ bool loop_enter(const Params& P, const Tabs& T, Lane& L, int pc,
                           unsigned run) {
  const int rid = T.code[pc + 2];
  const int icap = T.caps[rid];
  const int32_t span = (int32_t)((uint32_t)L.end - (uint32_t)L.cur);
  const int key = key_of(T, L, rid);
  const unsigned grp = __match_any_sync(run, key);
  const int32_t mx = __reduce_max_sync(grp, span);
  const int tabn = max(P.n_keys, 1);
  if (key >= 0 && (threadIdx.x & 31) == __ffs(grp) - 1) {
    atomicMax(&P.status[key], mx);
    atomicAdd(&P.status[tabn + key], __popc(grp));
  }
  int32_t slot;
  bool wrapped;
  context(L, slot, wrapped);
  Level& S = L.lv[L.top];
  S.rep_pc = pc;
  S.rid = rid;
  S.icap = icap;
  S.key = key;
  S.rem = 0;
  S.cnt = 0;
  S.it = 0;
  S.done = false;
  S.base = slot;
  S.base_wrapped = L.top > 0 && (wrapped || slot == kBig);
  S.own = key < 0 || P.has_spec[key] == 0;
  S.bound = S.own ? add_wrap(span, icap + 2) : P.spec[key];
  L.top += 1;
  return loop_next(P, T, L);
}

// Walks the lane's record; every lane of the warp calls it (an inactive
// one with active = false). The lanes step together: at each step only the
// lanes at the warp's lowest pc run their op.
__device__ void run_row(const Params& P, const Tabs& T, Lane& L,
                        bool active) {
  const int32_t* code = T.code;
  int pc = active ? 0 : kDone;
  for (;;) {
    const int at = __reduce_min_sync(0xFFFFFFFFu, pc);
    if (at == kDone) return;
    const unsigned run = __ballot_sync(0xFFFFFFFFu, pc == at);
    if (pc != at) continue;
    switch (code[pc]) {
      case OP_LONG: {
        uint32_t lo, hi;
        read_long(P, L, lo, hi);
        put(P, T, L, code[pc + 1], lo);
        put(P, T, L, code[pc + 2], hi);
        pc += 3;
        break;
      }
      case OP_INT: {
        uint32_t lo, hi;
        read_long(P, L, lo, hi);
        put(P, T, L, code[pc + 1], lo);
        pc += 2;
        break;
      }
      case OP_FLOAT: {
        const uint32_t v = win_word(P, (uint32_t)L.cur, 0);
        L.cur = add_wrap(L.cur, 4);
        put(P, T, L, code[pc + 1], v);
        pc += 2;
        break;
      }
      case OP_DOUBLE: {
        const uint32_t lo = win_word(P, (uint32_t)L.cur, 0);
        const uint32_t hi = win_word(P, (uint32_t)L.cur, 4);
        L.cur = add_wrap(L.cur, 8);
        put(P, T, L, code[pc + 1], lo);
        put(P, T, L, code[pc + 2], hi);
        pc += 3;
        break;
      }
      case OP_BOOL: {
        const uint32_t b = win_byte(P, (uint32_t)L.cur, 0);
        if (b > 1u) L.err |= ERR_BAD_BOOL;
        L.cur = add_wrap(L.cur, 1);
        put(P, T, L, code[pc + 1], b);
        pc += 2;
        break;
      }
      case OP_STRING: {
        uint32_t lo, hi;
        read_long(P, L, lo, hi);
        int32_t slen = (int32_t)lo;
        if (slen < 0 || hi != 0u) {
          L.err |= ERR_NEG_LEN;
          slen = 0;
        }
        const int32_t start = L.cur;
        const int32_t next = add_wrap(start, slen);
        if (next > L.end) L.err |= ERR_OVERRUN;
        put(P, T, L, code[pc + 1], (uint32_t)start);
        put(P, T, L, code[pc + 2], (uint32_t)slen);
        L.cur = next;
        pc += 3;
        break;
      }
      case OP_FIXED: {
        const int32_t start = L.cur;
        const int32_t next = add_wrap(start, code[pc + 2]);
        if (next > L.end) L.err |= ERR_OVERRUN;
        put(P, T, L, code[pc + 1], (uint32_t)start);
        L.cur = next;
        pc += 3;
        break;
      }
      case OP_ENUM: {
        uint32_t lo, hi;
        read_long(P, L, lo, hi);
        const int32_t idx = (int32_t)lo;
        if (hi != 0u || idx < 0 || idx >= code[pc + 2]) L.err |= ERR_BAD_ENUM;
        put(P, T, L, code[pc + 1], (uint32_t)idx);
        pc += 3;
        break;
      }
      case OP_NULLABLE: {
        const int32_t br = read_branch(P, L);
        const int32_t null_idx = code[pc + 2];
        const bool present = br == 1 - null_idx;
        if (!present && br != null_idx) L.err |= ERR_BAD_BRANCH;
        if (present) {
          put(P, T, L, code[pc + 1], 1u);
          pc += 4;
        } else {
          pc = code[pc + 3];
        }
        break;
      }
      case OP_UNION: {
        const int32_t br = read_branch(P, L);
        const int32_t n = code[pc + 2];
        const bool in_range = br >= 0 && br < n;
        if (!in_range) L.err |= ERR_BAD_BRANCH;
        put(P, T, L, code[pc + 1], (uint32_t)br);
        const int32_t start = in_range ? code[pc + 4 + 2 * br] : -1;
        pc = start >= 0 ? start : code[pc + 3];
        break;
      }
      case OP_JUMP:
        pc = code[pc + 1];
        break;
      case OP_REPEATED:
        pc = loop_enter(P, T, L, pc, run) ? pc + 4 : code[pc + 3];
        break;
      case OP_LOOP: {  // one item decoded
        Level& S = L.lv[L.top - 1];
        S.rem -= 1;
        S.cnt += 1;
        S.it += 1;
        const int rep = S.rep_pc;
        pc = loop_next(P, T, L) ? rep + 4 : code[rep + 3];
        break;
      }
      case OP_TRAILING:
        if (L.cur != L.end) L.err |= ERR_TRAILING;
        pc += 1;
        break;
      case OP_REBASE:  // cursors are absolute: nothing to rebase
        pc += 2;
        break;
      default:  // OP_END
        pc = kDone;
        break;
    }
  }
}

__global__ void __launch_bounds__(kThreads) decode_walk_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  void** dst = reinterpret_cast<void**>(smem);
  long long* len = reinterpret_cast<long long*>(smem + 8 * P.n_bufs);
  int32_t* tab = reinterpret_cast<int32_t*>(smem + 16 * P.n_bufs);
  const int n_tab = P.code_len + 2 * P.n_regions + 2 * P.n_bufs;
  int32_t* keys = tab + n_tab;
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kThreads;
  const int rows = min(kThreads, P.R - first);

  for (int i = tid; i < n_tab; i += kThreads) tab[i] = P.table[i];
  for (int i = tid; i < 2 * P.n_regions; i += kThreads) keys[i] = P.key_tab[i];
  for (int b = tid; b < P.n_bufs; b += kThreads) {
    dst[b] = reinterpret_cast<void*>(P.buf_ptrs[b]);
    len[b] = P.buf_lens[b];
  }
  __syncthreads();
  Tabs T;
  T.code = tab;
  T.caps = tab + P.code_len;
  T.esize = T.caps + 2 * P.n_regions;
  T.ext = keys;
  T.key_off = keys + P.n_regions;
  T.dst = dst;
  T.len = len;

  // every element of the block's rows starts at 0: the rows' ranges are one
  // contiguous span of each buffer, zeroed by 16-byte stores
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int b = 0; b < P.n_bufs; ++b) {
    const long long per_row = len[b] / P.R * T.esize[b];
    uint8_t* p = static_cast<uint8_t*>(dst[b]) + (long long)first * per_row;
    const long long bytes = (long long)rows * per_row;
    const long long n16 = bytes / 16;
    for (long long i = tid; i < n16; i += kThreads) {
      reinterpret_cast<uint4*>(p)[i] = zero;
    }
    for (long long i = n16 * 16 + tid; i < bytes; i += kThreads) p[i] = 0;
  }
  __syncthreads();

  // the walk: one thread per row, the whole warp in step
  Lane L;
  L.row = first + tid;
  L.top = 0;
  L.err = 0;
  const bool in_grid = tid < rows;
  L.cur = in_grid ? P.starts[L.row] : 0;
  L.end = in_grid ? add_wrap(L.cur, P.lengths[L.row]) : 0;
  run_row(P, T, L, in_grid && L.row < P.n);
  if (in_grid) P.err[L.row] = L.err;
}

}  // namespace

static int smem_of(int code_len, int n_bufs, int n_regions) {
  return 16 * n_bufs + 4 * (code_len + 4 * n_regions + 2 * n_bufs);
}

// Launches the walk on `stream`; returns a CUDA error code (0 = launched).
// Every buffer pointer 16-B aligned, each buffer's length a multiple of R;
// every output buffer and err are written whole. status must hold INT_MIN
// in its span maxima, -1 in it_max and 0 elsewhere (the wrapper's reset).
extern "C" int decode_walk(const void* words, long long n_words,
                           const void* starts, const void* lengths, int n,
                           int R, const void* table, int code_len, int n_bufs,
                           int n_regions, int depth, const void* buf_ptrs,
                           const void* buf_lens, const void* key_tab,
                           const void* spec, const void* has_spec, int n_keys,
                           void* status, void* log, int log_cap, void* err,
                           void* stream) {
  if (R <= 0) return 0;
  if (n_words <= 0 || n_words > (1ll << 30) || depth > kMaxDepth ||
      n < 0 || n > R) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.words = static_cast<const uint8_t*>(words);
  p.last_word = (uint32_t)(n_words - 1);
  p.starts = static_cast<const int32_t*>(starts);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.n = n;
  p.R = R;
  p.table = static_cast<const int32_t*>(table);
  p.code_len = code_len;
  p.n_bufs = n_bufs;
  p.n_regions = n_regions;
  p.depth = depth;
  p.buf_ptrs = static_cast<const long long*>(buf_ptrs);
  p.buf_lens = static_cast<const long long*>(buf_lens);
  p.key_tab = static_cast<const int32_t*>(key_tab);
  p.spec = static_cast<const int32_t*>(spec);
  p.has_spec = static_cast<const int32_t*>(has_spec);
  p.n_keys = n_keys;
  p.status = static_cast<int32_t*>(status);
  p.log = static_cast<int32_t*>(log);
  p.log_cap = log_cap;
  p.err = static_cast<uint32_t*>(err);
  const int shmem = smem_of(code_len, n_bufs, n_regions);
  if (shmem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        decode_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shmem);
    if (rc != 0) return rc;
  }
  decode_walk_kernel<<<(R + kThreads - 1) / kThreads, kThreads, shmem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
