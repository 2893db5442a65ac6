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
// and whether a lane was cut by its own bound. The wrapper then relaunches
// with the recorded bound of every key where a lane was cut
// (spec/has_spec), until the bounds settle. The key table is sized from
// the counters seen: a region's keys number the product of the extents of
// its ancestors' counters (ext, 0 at first). A lane whose key lies off the
// table is bounded by its own span alone; if it is cut there, the launch
// records its counters (it_max) and off_cut, and the wrapper widens the
// table to hold them and relaunches. So a bound is never guessed: a key
// either finishes within its lanes' own spans or runs with the value the
// reference computes.
//
// Bound on an H100 SXM: memory. A launch must read the records' bytes
// (the words buffer, contiguous), starts and lengths, and write every
// output element and #err once: (those bytes) / 3.35 TB/s. The walk itself
// is bound by instruction latency (one dependent byte after another), so
// the design keeps the bytes close and the blocks many. Block by block
// (kThreads consecutive lanes, one thread each):
// - The block's active records are one contiguous span of the words
//   (starts[first] .. starts[last active] + lengths[last active]; inactive
//   lanes have length 0 and stay out of it). Widened to 16-B bounds, it is
//   copied into shared memory by one Hopper bulk asynchronous copy
//   (cp.async.bulk ... mbarrier::complete_tx::bytes), issued before the
//   tables are copied and the outputs zeroed, so the three overlap; every
//   thread waits on the mbarrier's phase. A span over the launch's input
//   budget is not staged: that block reads device memory. Cursors are
//   absolute and wrap, so a read may leave the span (the block's last
//   lanes overrunning into the next block's records, a cursor wrapped by a
//   string length near 2^31, the launch's last record overrunning into the
//   padding and the clip): the byte function takes a byte from shared
//   memory only when its clipped address lies inside the staged copy, and
//   from device memory (__ldg) otherwise.
// - The field-program code and the buffer tables are copied into shared
//   memory once per block. The wrapper packs every table into one tensor.
// - The lane's stack of open loops is sized by the schema's nesting depth:
//   the kernel is instantiated for 1, 2 and 8 levels, and the launcher
//   takes the one the wrapper names. At one level every index into the
//   stack is a constant, so the stack lives in registers (on the H100 the
//   Kafka walk ran 0.43 ms at one level against 0.66 ms at eight; two
//   levels saved about 3 % on a two-deep schema, four none measurable).
// - The span records of the first kKeyTab keys are folded in shared memory
//   (warp-aggregated, then one shared atomic per warp and key), and the
//   block issues one global atomicMax and atomicAdd per touched key at its
//   end; keys past the table keep one global pair per warp.
// - Every output element of the block's rows is written by the block: its
//   ranges of all buffers are zeroed as one sequence of 16-byte stores,
//   then the walk stores into them directly. (Staging the ranges in shared
//   memory and flushing them whole cost resident blocks and was slower at
//   every size tried on the H100, as in walk_decode.cu.)
// - Each block counts itself in the status: staged, or reading device
//   memory (a block with no active record byte counts in neither).
// - The warp steps by its lowest pc (__reduce_min_sync), so lanes that
//   took different branches or item counts rejoin where the paths meet.
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
constexpr int kKeyTab = 64;          // keys a block folds in shared memory
constexpr int kLogWords = 4;         // b, slot, value, lane; then counters
constexpr int32_t kBig = 1 << 30;    // a slot past the cap: dropped
constexpr int kDone = INT_MAX;       // the pc of a lane that has ended

struct Params {
  const uint8_t* words;              // the launch's bytes
  long long n_bytes;                 // 4 * n_words
  uint32_t last_word;
  const int32_t* starts;             // [R]
  const int32_t* lengths;            // [R]
  int n;                             // active lanes
  int R;
  // buf_ptrs[nb] | buf_lens[nb] (int64), then the int32 parts at
  // tab_offsets: code | caps | esize | ext | key_off | spec | has_spec
  const int32_t* table;
  int code_len, n_bufs, n_regions, depth;
  int n_keys;
  int in_budget;                     // bytes for a block's record span
  int fold;                          // keys folded per block (<= kKeyTab)
  int32_t* status;                   // see the wrapper's WalkLaunch
  int32_t* log;                      // [log_cap, kLogWords + max(depth, 1)]
  int log_cap;
  uint32_t* err;                     // [R]
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Where each part of the table's int32 part starts, in int32 words: code
// at 0, then caps[nr], esize[nb], ext[nr], key_off[nr], spec[T] and
// has_spec[T] with T = max(n_keys, 1). A block copies [0, spec) into
// shared memory.
struct TabOffsets {
  int caps, esize, ext, key_off, spec, has_spec;
};

__host__ __device__ inline TabOffsets tab_offsets(int code_len, int n_bufs,
                                                  int n_regions, int n_keys) {
  TabOffsets o;
  o.caps = code_len;
  o.esize = o.caps + n_regions;
  o.ext = o.esize + n_bufs;
  o.key_off = o.ext + n_regions;
  o.spec = o.key_off + n_regions;
  o.has_spec = o.spec + max(n_keys, 1);
  return o;
}

// Byte offsets of the parts of a block's dynamic shared memory.
struct Layout {
  int gptr, len, lo, z16, tab, in, total;
};

__host__ __device__ inline Layout layout_of(int code_len, int n_bufs,
                                            int n_regions, int in_budget) {
  Layout L;
  L.gptr = 16;  // after the mbarrier
  L.len = L.gptr + 8 * n_bufs;
  L.lo = L.len + 8 * n_bufs;
  L.z16 = L.lo + 8 * n_bufs;
  L.tab = L.z16 + 8 * n_bufs;
  L.in = align16(L.tab +
                 4 * tab_offsets(code_len, n_bufs, n_regions, 0).spec);
  L.total = L.in + align16(in_budget);
  return L;
}

// -- Hopper bulk copy and mbarrier (as in walk_decode.cu) ------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Copies `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-B aligned; the barrier's phase 0 completes when all bytes have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// -- the walk ----------------------------------------------------------------

// The block's tables (shared memory) and its staged record span.
struct Tabs {
  const int32_t* code;
  const int32_t* caps;
  const int32_t* esize;
  const int32_t* ext;
  const int32_t* key_off;
  void* const* gptr;                 // buffer base pointers
  const long long* len;              // buffer lengths
  const int32_t* spec;               // [n_keys], device memory
  const int32_t* has_spec;
  int32_t* s_max;                    // [fold] span max per key
  int32_t* s_cnt;                    // [fold] lanes per key
  const uint8_t* in;                 // staged bytes of words [in_lo, +in_n)
  uint32_t in_lo, in_n;
};

struct Level {                       // one open array/map loop
  int rep_pc, rid, icap, key;
  int32_t rem, cnt, it, bound;
  int32_t base;                      // the slot its items hang under
  bool base_wrapped, done, own;
};

template <int D>
struct Lane {
  int32_t cur, end;
  uint32_t err;
  int row;
  int top;                           // open loops
  Level lv[D];
};

// The innermost open loop, and the level a loop entered now takes: at one
// level the index is a constant, so the stack stays in registers.
template <int D>
__device__ __forceinline__ Level& inner(Lane<D>& L) {
  return L.lv[D == 1 ? 0 : L.top - 1];
}

template <int D>
__device__ __forceinline__ const Level& inner(const Lane<D>& L) {
  return L.lv[D == 1 ? 0 : L.top - 1];
}

__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// Byte k of the window at cursor c: from the staged copy when its clipped
// address lies inside it, else from device memory.
__device__ __forceinline__ uint32_t win_byte(const Params& P, const Tabs& T,
                                             uint32_t c, uint32_t k) {
  const uint32_t m = (c & 3u) + k;
  const uint32_t w = min((c >> 2) + (m >> 2), P.last_word);
  const uint32_t p = (w << 2) | (m & 3u);
  const uint32_t r = p - T.in_lo;
  return r < T.in_n ? (uint32_t)T.in[r] : (uint32_t)__ldg(P.words + p);
}

__device__ __forceinline__ uint32_t win_word(const Params& P, const Tabs& T,
                                             uint32_t c, uint32_t k) {
  return win_byte(P, T, c, k) | (win_byte(P, T, c, k + 1) << 8) |
         (win_byte(P, T, c, k + 2) << 16) | (win_byte(P, T, c, k + 3) << 24);
}

// One unsigned LEB128 varint (at most 10 bytes) at the cursor.
template <int D>
__device__ void read_varint(const Params& P, const Tabs& T, Lane<D>& L,
                            uint32_t& lo, uint32_t& hi) {
  const uint32_t c = (uint32_t)L.cur;
  lo = 0;
  hi = 0;
  uint32_t n = 0;
  bool more = true;
  for (int k = 0; k < 10 && more; ++k) {
    const uint32_t b = win_byte(P, T, c, k);
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

template <int D>
__device__ __forceinline__ void read_long(const Params& P, const Tabs& T,
                                          Lane<D>& L, uint32_t& lo,
                                          uint32_t& hi) {
  read_varint(P, T, L, lo, hi);
  const uint32_t m = 0u - (lo & 1u);
  const uint32_t lo1 = (lo >> 1) | (hi << 31);
  const uint32_t hi1 = hi >> 1;
  lo = lo1 ^ m;
  hi = hi1 ^ m;
}

template <int D>
__device__ __forceinline__ int32_t read_branch(const Params& P,
                                               const Tabs& T, Lane<D>& L) {
  uint32_t lo, hi;
  read_long(P, T, L, lo, hi);
  if (hi != 0) L.err |= ERR_BAD_BRANCH;
  return (int32_t)lo;
}

// The slot and wrapped flag the current position writes to: the row for
// the row region, else the innermost loop's item slot.
template <int D>
__device__ __forceinline__ void context(const Lane<D>& L, int32_t& slot,
                                        bool& wrapped) {
  if (L.top == 0) {
    slot = L.row;
    wrapped = false;
    return;
  }
  const Level& S = inner(L);
  slot = S.cnt < S.icap
             ? (int32_t)((uint32_t)S.base * (uint32_t)S.icap + (uint32_t)S.cnt)
             : kBig;
  wrapped = S.base_wrapped;
}

// One store: into the lane's own range, or, for a slot under a dropped
// item, into the log. Slots outside the buffer are dropped, a negative
// wrapped slot counting from the end (jnp's scatter, mode="drop").
template <int D>
__device__ void put(const Params& P, const Tabs& T, const Lane<D>& L, int b,
                    uint32_t v) {
  int32_t slot;
  bool wrapped;
  context(L, slot, wrapped);
  long long s = slot;
  if (wrapped && s < 0) s += T.len[b];
  if (s < 0 || s >= T.len[b]) return;
  if (!wrapped) {
    if (T.esize[b] == 1) {
      static_cast<uint8_t*>(T.gptr[b])[s] = (uint8_t)v;
    } else {
      static_cast<uint32_t*>(T.gptr[b])[s] = v;
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
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (i < width - kLogWords) e[kLogWords + i] = i < L.top ? L.lv[i].it : 0;
  }
}

// The key of a loop of region rid entered now: its index in the table, or
// -1 when a counter of an enclosing loop lies past its extent.
template <int D>
__device__ __forceinline__ int key_of(const Tabs& T, const Lane<D>& L,
                                      int rid) {
  long long k = 0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (i >= L.top) break;
    const int e = T.ext[L.lv[i].rid];
    if (L.lv[i].it >= e) return -1;
    k = k * e + L.lv[i].it;
  }
  return T.key_off[rid] + (int)k;
}

// A lane that ran out of iterations under its own bound.
template <int D>
__device__ void record_cut(const Params& P, const Lane<D>& L,
                           const Level& S) {
  const int T = max(P.n_keys, 1);
  if (S.key >= 0) {
    P.status[2 * T + S.key] = 1;
    return;
  }
  int32_t* it_max = P.status + 3 * T;
  int32_t* off_cut = it_max + P.n_regions;
  off_cut[S.rid] = 1;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (i < L.top - 1) atomicMax(&it_max[L.lv[i].rid], L.lv[i].it);
  }
}

// Runs the innermost loop's iterations up to its next item. True when an
// item is to be decoded; false when the loop has ended (it is popped and
// its count written where the enclosing position writes).
template <int D>
__device__ bool loop_next(const Params& P, const Tabs& T, Lane<D>& L) {
  Level& S = inner(L);
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
      read_long(P, T, L, lo, hi);
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
        read_varint(P, T, L, slo, shi);
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
// per key across the warp, then folded into the block's table (the first
// P.fold keys) or into the status in device memory.
template <int D>
__device__ bool loop_enter(const Params& P, const Tabs& T, Lane<D>& L, int pc,
                           unsigned run) {
  const int rid = T.code[pc + 2];
  const int icap = T.caps[rid];
  const int32_t span = (int32_t)((uint32_t)L.end - (uint32_t)L.cur);
  const int key = key_of(T, L, rid);
  const unsigned grp = __match_any_sync(run, key);
  const int32_t mx = __reduce_max_sync(grp, span);
  if (key >= 0 && (threadIdx.x & 31) == __ffs(grp) - 1) {
    if (key < P.fold) {
      atomicMax(&T.s_max[key], mx);
      atomicAdd(&T.s_cnt[key], __popc(grp));
    } else {
      atomicMax(&P.status[key], mx);
      atomicAdd(&P.status[max(P.n_keys, 1) + key], __popc(grp));
    }
  }
  int32_t slot;
  bool wrapped;
  context(L, slot, wrapped);
  Level& S = L.lv[D == 1 ? 0 : L.top];
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
  S.own = key < 0 || T.has_spec[key] == 0;
  S.bound = S.own ? add_wrap(span, icap + 2) : T.spec[key];
  L.top += 1;
  return loop_next(P, T, L);
}

// Walks the lane's record; every lane of the warp calls it (an inactive
// one with active = false). The lanes step together: at each step only the
// lanes at the warp's lowest pc run their op.
template <int D>
__device__ void run_row(const Params& P, const Tabs& T, Lane<D>& L,
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
        read_long(P, T, L, lo, hi);
        put(P, T, L, code[pc + 1], lo);
        put(P, T, L, code[pc + 2], hi);
        pc += 3;
        break;
      }
      case OP_INT: {
        uint32_t lo, hi;
        read_long(P, T, L, lo, hi);
        put(P, T, L, code[pc + 1], lo);
        pc += 2;
        break;
      }
      case OP_FLOAT: {
        const uint32_t v = win_word(P, T, (uint32_t)L.cur, 0);
        L.cur = add_wrap(L.cur, 4);
        put(P, T, L, code[pc + 1], v);
        pc += 2;
        break;
      }
      case OP_DOUBLE: {
        const uint32_t lo = win_word(P, T, (uint32_t)L.cur, 0);
        const uint32_t hi = win_word(P, T, (uint32_t)L.cur, 4);
        L.cur = add_wrap(L.cur, 8);
        put(P, T, L, code[pc + 1], lo);
        put(P, T, L, code[pc + 2], hi);
        pc += 3;
        break;
      }
      case OP_BOOL: {
        const uint32_t b = win_byte(P, T, (uint32_t)L.cur, 0);
        if (b > 1u) L.err |= ERR_BAD_BOOL;
        L.cur = add_wrap(L.cur, 1);
        put(P, T, L, code[pc + 1], b);
        pc += 2;
        break;
      }
      case OP_STRING: {
        uint32_t lo, hi;
        read_long(P, T, L, lo, hi);
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
        read_long(P, T, L, lo, hi);
        const int32_t idx = (int32_t)lo;
        if (hi != 0u || idx < 0 || idx >= code[pc + 2]) L.err |= ERR_BAD_ENUM;
        put(P, T, L, code[pc + 1], (uint32_t)idx);
        pc += 3;
        break;
      }
      case OP_NULLABLE: {
        const int32_t br = read_branch(P, T, L);
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
        const int32_t br = read_branch(P, T, L);
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
        Level& S = inner(L);
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

template <int D>
__global__ void __launch_bounds__(kThreads) decode_walk_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t s_fold[2 * kKeyTab];
  const int nb = P.n_bufs;
  const Layout Lo = layout_of(P.code_len, nb, P.n_regions, P.in_budget);
  const TabOffsets O = tab_offsets(P.code_len, nb, P.n_regions, P.n_keys);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  void** gptr = reinterpret_cast<void**>(smem + Lo.gptr);
  long long* len = reinterpret_cast<long long*>(smem + Lo.len);
  long long* lo_el = reinterpret_cast<long long*>(smem + Lo.lo);
  long long* z16 = reinterpret_cast<long long*>(smem + Lo.z16);
  int32_t* tab = reinterpret_cast<int32_t*>(smem + Lo.tab);
  uint8_t* s_in = smem + Lo.in;
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kThreads;
  const int rows = min(kThreads, P.R - first);
  const int keys = max(P.n_keys, 1);
  // the status's block counts: staged, reading device memory
  int32_t* blocks = P.status + 3 * keys + 2 * P.n_regions + 1;

  // 1. the block's active records, one span of the words widened to 16-B
  // bounds: into shared memory by one bulk copy when it fits the budget
  const int last = min(first + rows, P.n) - 1;
  long long a = 0, span = 0;
  bool covers = false, staged = false;
  if (last >= first) {
    const long long lo = P.starts[first];
    const long long hi = (long long)P.starts[last] + P.lengths[last];
    a = lo & ~15ll;
    span = ((hi + 15) & ~15ll) - a;
    covers = hi > lo;
    staged = covers && lo >= 0 && a + span <= P.n_bytes &&
             span <= P.in_budget;
  }
  if (tid == 0 && staged) mbar_init(bar);
  __syncthreads();  // the initialised barrier is visible to every thread
  if (tid == 0 && staged) {
    bulk_load(s_in, P.words + a, (uint32_t)span, bar);
  }
  if (tid == 0 && covers) atomicAdd(&blocks[staged ? 0 : 1], 1);

  // 2. tables into shared memory, while the copy is in flight
  const long long* t64 = reinterpret_cast<const long long*>(P.table);
  const int32_t* t32 = P.table + 4 * nb;
  for (int i = tid; i < O.spec; i += kThreads) tab[i] = t32[i];
  for (int b = tid; b < nb; b += kThreads) {
    const long long n_b = t64[nb + b];
    const long long per_row = n_b / P.R;
    gptr[b] = reinterpret_cast<void*>(t64[b]);
    len[b] = n_b;
    lo_el[b] = (long long)first * per_row;
    // the whole 16-B words of the block's range
    z16[b] = (long long)rows * per_row * t32[O.esize + b] / 16;
  }
  const int fold = min(P.fold, P.n_keys);
  for (int i = tid; i < fold; i += kThreads) {
    s_fold[i] = INT_MIN;
    s_fold[kKeyTab + i] = 0;
  }
  __syncthreads();
  Tabs T;
  T.code = tab;
  T.caps = tab + O.caps;
  T.esize = tab + O.esize;
  T.ext = tab + O.ext;
  T.key_off = tab + O.key_off;
  T.gptr = gptr;
  T.len = len;
  T.spec = t32 + O.spec;
  T.has_spec = t32 + O.has_spec;
  T.s_max = s_fold;
  T.s_cnt = s_fold + kKeyTab;
  T.in = s_in;
  T.in_lo = (uint32_t)a;
  T.in_n = staged ? (uint32_t)span : 0u;

  // 3. every output element of the block's rows starts at 0: its ranges
  // of all buffers, walked as one sequence of 16-byte words
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  {
    int b = 0;
    long long base = 0;  // the first word of buffer b in the sequence
    for (long long i = tid;; i += kThreads) {
      while (b < nb && i >= base + z16[b]) base += z16[b++];
      if (b == nb) break;
      uint8_t* p = static_cast<uint8_t*>(gptr[b]) + lo_el[b] * T.esize[b];
      reinterpret_cast<uint4*>(p)[i - base] = zero;
    }
  }
  if (rows < kThreads) {  // a short last block: the ranges' tail bytes
    for (int b = 0; b < nb; ++b) {
      const long long esz = T.esize[b];
      uint8_t* p = static_cast<uint8_t*>(gptr[b]) + lo_el[b] * esz;
      const long long bytes = (long long)rows * (len[b] / P.R) * esz;
      for (long long i = z16[b] * 16 + tid; i < bytes; i += kThreads) {
        p[i] = 0;
      }
    }
  }
  __syncthreads();
  if (staged) mbar_wait(bar, 0);

  // 4. the walk: one thread per row, the whole warp in step
  Lane<D> L;
  L.row = first + tid;
  L.top = 0;
  L.err = 0;
  const bool in_grid = tid < rows;
  L.cur = in_grid ? P.starts[L.row] : 0;
  L.end = in_grid ? add_wrap(L.cur, P.lengths[L.row]) : 0;
  run_row(P, T, L, in_grid && L.row < P.n);
  if (in_grid) P.err[L.row] = L.err;
  __syncthreads();

  // 5. the block's span records, one global pair per touched key
  for (int i = tid; i < fold; i += kThreads) {
    if (T.s_cnt[i] > 0) {
      atomicMax(&P.status[i], T.s_max[i]);
      atomicAdd(&P.status[keys + i], T.s_cnt[i]);
    }
  }
}

template <int D>
int allow_smem(int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      decode_walk_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
}

template <int D>
int blocks_per_sm(int smem_bytes) {
  int rc = allow_smem<D>(smem_bytes);
  if (rc != 0) return -rc;
  int n = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_walk_kernel<D>, kThreads, smem_bytes);
  return rc != 0 ? -rc : n;
}

template <int D>
int launch(const Params& p, int shmem, cudaStream_t stream) {
  const int rc = allow_smem<D>(shmem);
  if (rc != 0) return rc;
  decode_walk_kernel<D><<<(p.R + kThreads - 1) / kThreads, kThreads, shmem,
                          stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block, in bytes.
extern "C" int decode_walk_smem_bytes(int code_len, int n_bufs, int n_regions,
                                      int in_budget) {
  return layout_of(code_len, n_bufs, n_regions, in_budget).total;
}

// Blocks of the kernel's `stack`-level instantiation that fit one SM at
// `smem_bytes` of dynamic shared memory (registers and threads counted
// too); a negative CUDA error code when the query fails.
extern "C" int decode_walk_blocks_per_sm(int stack, int smem_bytes) {
  switch (stack) {
    case 1: return blocks_per_sm<1>(smem_bytes);
    case 2: return blocks_per_sm<2>(smem_bytes);
    case 8: return blocks_per_sm<8>(smem_bytes);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// Launches the walk on `stream` with the `stack`-level instantiation (1,
// 2 or 8, at least depth); returns a CUDA error code (0 = launched).
// words 16-B aligned; every buffer pointer 16-B aligned, each buffer's
// length a multiple of R; in_budget a multiple of 16; fold at most
// kKeyTab. Every output buffer and err are written whole. status
// [3 * max(n_keys, 1) + 2 * n_regions + 3] must hold INT_MIN in its span
// maxima, -1 in it_max and 0 elsewhere (the wrapper's reset); its last
// two words count the blocks staged and reading device memory.
extern "C" int decode_walk(const void* words, long long n_words,
                           const void* starts, const void* lengths, int n,
                           int R, const void* table, int code_len, int n_bufs,
                           int n_regions, int depth, int stack, int n_keys,
                           int in_budget, int fold, void* status, void* log,
                           int log_cap, void* err, void* stream) {
  if (R <= 0) return 0;
  if (n_words <= 0 || n_words > (1ll << 30) || depth > stack || n < 0 ||
      n > R || in_budget < 0 || in_budget % 16 != 0 || fold < 0 ||
      fold > kKeyTab || reinterpret_cast<uintptr_t>(words) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.words = static_cast<const uint8_t*>(words);
  p.n_bytes = 4 * n_words;
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
  p.n_keys = n_keys;
  p.in_budget = in_budget;
  p.fold = fold;
  p.status = static_cast<int32_t*>(status);
  p.log = static_cast<int32_t*>(log);
  p.log_cap = log_cap;
  p.err = static_cast<uint32_t*>(err);
  const int shmem = layout_of(code_len, n_bufs, n_regions, in_budget).total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stack) {
    case 1: return launch<1>(p, shmem, s);
    case 2: return launch<2>(p, shmem, s);
    case 8: return launch<8>(p, shmem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
