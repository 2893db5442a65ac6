// walk_decode.cu — the Avro field-program walk on Hopper, one thread per
// record, over the records' unpadded bytes.
//
// Replaces pyruhvro_tpu/ops/pallas_decode.py PallasKernelDecoder._build
// (the kernel body at :203-241 and its pl.pallas_call at :256), which runs
// the schema-lowered field program over row-padded [TILE_R, BW] u32 tiles.
// The Pallas helpers that exist only because Mosaic lowers no gathers,
// scatters or integer reductions (_TileWords.take_words, item_put,
// reduce_max_f32) have no counterpart here: a thread loads its record's
// bytes directly and stores each value directly to its slot.
//
// What it computes (per record, cursor record-local): LEB128 varints with
// zig-zag into (lo, hi) u32, float and double bit patterns, bools, enum and
// union indices with range checks, nullable validity, (start, len) string
// descriptors, the array/map block loop into strided slots row*icap+cnt
// (ERR_ITEM_OVERFLOW past the cap, the slot then dropped), OR-accumulated
// error bits, ERR_TRAILING, and the row-region #start rebase by base[row].
// It executes the flat int32 code of pyruhvro_tpu_torch/ops/fieldprog.py;
// one build serves every schema, since the code, the output buffer table
// and the item caps are arguments.
//
// Input layout. The records are concatenated in `flat` (at least 16 zero
// bytes of tail), record r at [offs[r], offs[r+1]). The semantics stay the
// reference's row-padded ones: BW (row_words) clips every read to word
// BW-1, and byte p of the virtual padded row reads p < len ? src[p] : 0.
// The `p < len` test is what keeps a read past the record's end from
// seeing the next record, which follows it directly.
//
// The array/map loop bound. The reference bounds each repeated field's loop
// by one value per tile of tile_r rows (the max span of the tile's lanes in
// mask, 0 for the others, through float32, + icap + 2). A thread cannot see
// its tile, so a lane is first bounded by its own span (never more than the
// tile's, so a lane that finishes is exact), and every block folds its
// lanes' spans into span_max/in_mask; a lane cut short by its own bound
// sets cut[region], and the wrapper (ops/walk_decode.py) relaunches. In the
// relaunch, regions 1..fixed_upto take the exact tile bound, computed here
// from the span_max/in_mask that the first launch recorded for them.
//
// Bound on an H100 SXM: memory. A launch must read every record's bytes
// once (sum of lengths, contiguous), offs (8 B a row), act and base (4 B a
// row each), and write every output element once: (those bytes) / 3.35
// TB/s. The design, block by block (128 rows, one thread per row):
// - The block's records are one contiguous span of `flat`. One thread
//   copies it into shared memory with the Hopper bulk asynchronous copy
//   (cp.async.bulk ... mbarrier::complete_tx::bytes): the copy engine
//   computes no per-thread addresses, the whole span arrives as one
//   transfer, and completion is an mbarrier phase that every thread waits
//   on; the walk then reads its bytes from shared memory instead of
//   scattering 1-byte global loads 256 B apart. The copy needs 16-B-aligned
//   addresses and size, so the span is widened to 16-B bounds and each
//   record keeps its offset from the widened start. It is issued before
//   the tables are copied and the outputs zeroed, so the three overlap. A
//   span over the launch's input budget is not staged: that block reads
//   `flat` in device memory through the same byte function.
// - The field-program code, the per-buffer element sizes and caps, and
//   each buffer's base pointer for this block are copied into shared
//   memory once per block: every op and every store reads them.
// - Every output element of the block's rows is written by the block,
//   zeros included, for active and inactive rows alike, so the wrapper
//   allocates the outputs with torch.empty and never zero-fills them. The
//   buffers the host's staging plan places in shared memory (the row
//   region first, then item buffers, within the output budget) are zeroed
//   there, stored into by the walk and flushed as coalesced 16-byte
//   vector stores, so their strided slots reach device memory once, as
//   whole lines. The others are zeroed in device memory by 16-byte stores
//   and then stored into directly. The wrapper's default budget stages
//   only what costs no resident block: the walk is bound by instruction
//   latency, and on the H100 the blocks per SM (12 at 40 registers) are
//   worth more than the saved stores (PERF.md).
// - The warp steps together: at each step only the lanes at the warp's
//   lowest pc run their op (__reduce_min_sync), so lanes whose records
//   took different branches (a null field, fewer items) wait and meet
//   the others where the paths join, instead of every distinct op of the
//   warp running one after another at every step.
//
// Arithmetic on cursors is done in uint32_t and reinterpreted: the
// reference adds cursors in wrapping int32 (a string length up to 2^31-1
// can wrap the cursor), which is undefined behaviour for int32_t in C++.

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

constexpr int kThreads = 128;  // rows of a block; divides every tile

struct Params {
  const uint8_t* flat;                 // the records' bytes, concatenated
  const long long* offs;               // [R+1]
  const int32_t* act;                  // [R]
  const int32_t* base;                 // [R]: OP_REBASE adds base[row]
  int R;
  int row_words;                       // BW
  // code[code_len] | esize[n_bufs] | region[n_bufs] | stage[n_bufs] |
  // caps[n_regions]; stage is a byte offset in the output staging area,
  // or -1 for a buffer stored to directly in device memory
  const int32_t* table;
  int code_len;
  int n_bufs;
  int n_regions;
  const unsigned long long* buf_ptrs;  // device pointers, 16-B aligned
  int tile_r;
  int fixed_upto;                      // regions 1..fixed_upto: tile bound
  int in_budget;                       // bytes for a block's record span
  int out_bytes;                       // bytes of the output staging area
  int32_t* span_max;                   // [n_tiles, n_regions]
  int32_t* in_mask;                    // [n_tiles, n_regions]
  int32_t* cut;                        // [n_regions]
  uint32_t* err;                       // [R]
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Byte offsets of the parts of a block's dynamic shared memory.
struct Layout {
  int dst, table, stats, in, out, total;
};

__host__ __device__ inline Layout layout_of(int code_len, int n_bufs,
                                            int n_regions, int in_budget,
                                            int out_bytes) {
  Layout L;
  L.dst = 16;  // after the mbarrier
  L.table = L.dst + 8 * n_bufs;
  L.stats = L.table + 4 * (code_len + 3 * n_bufs + n_regions);
  L.in = align16(L.stats + 4 * 3 * n_regions);
  L.out = L.in + align16(in_budget);
  L.total = L.out + align16(out_bytes);
  return L;
}

// -- Hopper bulk copy and mbarrier ------------------------------------------

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

// The block's view of the tables, all in shared memory.
struct Block {
  const int32_t* code;
  const int32_t* esize;
  const int32_t* caps;
  void* const* dst;  // base of each buffer's slice for this block
  int32_t* s_span;
  int32_t* s_cnt;
  int32_t* s_cut;
  int tid;
  int row;
  int tile;
};

struct Lane {
  const uint8_t* src;  // the record's first byte (shared or global memory)
  uint32_t len;
  uint32_t last_word;
  int32_t end;
  int32_t cur;
  uint32_t err;
};

__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// Byte k of the window at cursor c: byte p of the virtual padded row, with
// word min((c>>2) + (((c&3)+k)>>2), BW-1); 0 past the record's length.
__device__ __forceinline__ uint32_t win_byte(const Lane& L, uint32_t c,
                                             uint32_t k) {
  const uint32_t m = (c & 3u) + k;
  const uint32_t w = min((c >> 2) + (m >> 2), L.last_word);
  const uint32_t p = (w << 2) | (m & 3u);
  return p < L.len ? (uint32_t)L.src[p] : 0u;
}

__device__ __forceinline__ uint32_t win_word(const Lane& L, uint32_t c,
                                             uint32_t k) {
  return win_byte(L, c, k) | (win_byte(L, c, k + 1) << 8) |
         (win_byte(L, c, k + 2) << 16) | (win_byte(L, c, k + 3) << 24);
}

// One unsigned LEB128 varint (at most 10 bytes) at the cursor.
__device__ void read_varint(Lane& L, uint32_t& lo, uint32_t& hi) {
  const uint32_t c = (uint32_t)L.cur;
  lo = 0;
  hi = 0;
  uint32_t n = 0;
  bool more = true;
  for (int k = 0; k < 10 && more; ++k) {
    const uint32_t b = win_byte(L, c, k);
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

__device__ __forceinline__ void zigzag(uint32_t& lo, uint32_t& hi) {
  const uint32_t m = 0u - (lo & 1u);
  const uint32_t lo1 = (lo >> 1) | (hi << 31);
  const uint32_t hi1 = hi >> 1;
  lo = lo1 ^ m;
  hi = hi1 ^ m;
}

__device__ __forceinline__ void read_long(Lane& L, uint32_t& lo,
                                          uint32_t& hi) {
  read_varint(L, lo, hi);
  zigzag(lo, hi);
}

// A union or nullable branch index; a nonzero high word is out of range.
__device__ __forceinline__ int32_t read_branch(Lane& L) {
  uint32_t lo, hi;
  read_long(L, lo, hi);
  if (hi != 0) L.err |= ERR_BAD_BRANCH;
  return (int32_t)lo;
}

// Slot: the block-local element index (the row's thread index for the row
// region, tid*icap+cnt for an item region); -1 drops an item past the cap.
__device__ __forceinline__ void put(const Block& B, int b, int slot,
                                    uint32_t v) {
  if (slot < 0) return;
  if (B.esize[b] == 1) {
    static_cast<uint8_t*>(B.dst[b])[slot] = (uint8_t)v;
  } else {
    static_cast<uint32_t*>(B.dst[b])[slot] = v;
  }
}

// max_span + icap + 2 as the reference computes it: through float32
// (round to nearest, back to int32 saturating) and summed in int32.
__device__ __forceinline__ long long bound_of(int32_t span, int icap) {
  const float f = __int2float_rn(span);
  const int32_t rt = f >= 2147483648.0f ? INT_MAX : (int32_t)f;
  return (long long)rt + icap + 2;
}

// The reference's loop bound of one tile, from the spans a launch recorded:
// lanes outside the mask count as span 0; the sum wraps as int32.
__device__ __forceinline__ int32_t tile_bound(const Params& P, int tile,
                                              int rid, int icap) {
  const size_t at = (size_t)tile * P.n_regions + rid;
  int32_t span = P.span_max[at];
  if (P.in_mask[at] < P.tile_r) span = max(span, 0);
  return (int32_t)(uint32_t)(unsigned long long)bound_of(span, icap);
}

struct Loop {
  int rep_pc;
  int rid;
  int icap;
  int32_t rem, cnt, it, bound;
  bool done;
  bool own;  // bounded by this lane's own span
};

// Runs the loop's iterations up to the next item. Returns true with *slot
// set when an item is to be decoded; false when the loop has ended (count
// written, *slot back to the row).
__device__ bool loop_next(const Block& B, Lane& L, Loop& S, int* slot) {
  for (;;) {
    if (S.done || S.it >= S.bound) {
      if (!S.done) {
        L.err |= ERR_OVERRUN;  // ran out of iterations: malformed
        if (S.own) B.s_cut[S.rid] = 1;
      }
      put(B, B.code[S.rep_pc + 1], B.tid, (uint32_t)S.cnt);
      *slot = B.tid;
      return false;
    }
    if (S.rem == 0) {  // block header
      uint32_t lo, hi;
      read_long(L, lo, hi);
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
        read_varint(L, slo, shi);
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
      *slot = S.cnt < S.icap ? B.tid * S.icap + S.cnt : -1;
      return true;
    }
    S.it += 1;
  }
}

constexpr int kDone = INT_MAX;  // the pc of a lane that has ended

// Walks the lane's record; every lane of the warp calls it (an inactive one
// with active = false). The lanes step together: at each step only the
// lanes at the warp's lowest pc run their op, so an op runs once for all
// the lanes that are at it, and lanes that took different branches meet
// again where the paths join (pcs only grow, except a loop's jump back).
__device__ uint32_t run_row(const Params& P, const Block& B, Lane& L,
                            bool active) {
  const int32_t* code = B.code;
  int slot = B.tid;
  Loop S = {};
  int pc = active ? 0 : kDone;
  for (;;) {
    const int at = __reduce_min_sync(0xFFFFFFFFu, pc);
    if (at == kDone) return L.err;
    if (pc != at) continue;
    switch (code[pc]) {
      case OP_LONG: {
        uint32_t lo, hi;
        read_long(L, lo, hi);
        put(B, code[pc + 1], slot, lo);
        put(B, code[pc + 2], slot, hi);
        pc += 3;
        break;
      }
      case OP_INT: {
        uint32_t lo, hi;
        read_long(L, lo, hi);
        put(B, code[pc + 1], slot, lo);
        pc += 2;
        break;
      }
      case OP_FLOAT: {
        const uint32_t v = win_word(L, (uint32_t)L.cur, 0);
        L.cur = add_wrap(L.cur, 4);
        put(B, code[pc + 1], slot, v);
        pc += 2;
        break;
      }
      case OP_DOUBLE: {
        const uint32_t lo = win_word(L, (uint32_t)L.cur, 0);
        const uint32_t hi = win_word(L, (uint32_t)L.cur, 4);
        L.cur = add_wrap(L.cur, 8);
        put(B, code[pc + 1], slot, lo);
        put(B, code[pc + 2], slot, hi);
        pc += 3;
        break;
      }
      case OP_BOOL: {
        const uint32_t b = win_byte(L, (uint32_t)L.cur, 0);
        if (b > 1u) L.err |= ERR_BAD_BOOL;
        L.cur = add_wrap(L.cur, 1);
        put(B, code[pc + 1], slot, b);
        pc += 2;
        break;
      }
      case OP_STRING: {
        uint32_t lo, hi;
        read_long(L, lo, hi);
        int32_t slen = (int32_t)lo;
        if (slen < 0 || hi != 0u) {
          L.err |= ERR_NEG_LEN;
          slen = 0;
        }
        const int32_t start = L.cur;
        const int32_t next = add_wrap(start, slen);
        if (next > L.end) L.err |= ERR_OVERRUN;
        put(B, code[pc + 1], slot, (uint32_t)start);
        put(B, code[pc + 2], slot, (uint32_t)slen);
        L.cur = next;
        pc += 3;
        break;
      }
      case OP_FIXED: {
        const int32_t start = L.cur;
        const int32_t next = add_wrap(start, code[pc + 2]);
        if (next > L.end) L.err |= ERR_OVERRUN;
        put(B, code[pc + 1], slot, (uint32_t)start);
        L.cur = next;
        pc += 3;
        break;
      }
      case OP_ENUM: {
        uint32_t lo, hi;
        read_long(L, lo, hi);
        const int32_t idx = (int32_t)lo;
        if (hi != 0u || idx < 0 || idx >= code[pc + 2]) L.err |= ERR_BAD_ENUM;
        put(B, code[pc + 1], slot, (uint32_t)idx);
        pc += 3;
        break;
      }
      case OP_NULLABLE: {
        const int32_t br = read_branch(L);
        const int32_t null_idx = code[pc + 2];
        const bool present = br == 1 - null_idx;
        if (!present && br != null_idx) L.err |= ERR_BAD_BRANCH;
        if (present) {
          put(B, code[pc + 1], slot, 1u);
          pc += 4;
        } else {
          pc = code[pc + 3];
        }
        break;
      }
      case OP_UNION: {
        const int32_t br = read_branch(L);
        const int32_t n = code[pc + 2];
        const bool in_range = br >= 0 && br < n;
        if (!in_range) L.err |= ERR_BAD_BRANCH;
        put(B, code[pc + 1], slot, (uint32_t)br);
        const int32_t start = in_range ? code[pc + 4 + 2 * br] : -1;
        pc = start >= 0 ? start : code[pc + 3];
        break;
      }
      case OP_JUMP:
        pc = code[pc + 1];
        break;
      case OP_REPEATED: {
        S.rep_pc = pc;
        S.rid = code[pc + 2];
        S.icap = B.caps[S.rid];
        S.own = S.rid > P.fixed_upto;
        if (S.own) {
          const int32_t span = (int32_t)((uint32_t)L.end - (uint32_t)L.cur);
          atomicMax(&B.s_span[S.rid], span);
          atomicAdd(&B.s_cnt[S.rid], 1);
          const long long b = bound_of(span, S.icap);
          if (b > INT_MAX) B.s_cut[S.rid] = 1;  // the tile's bound wraps
          S.bound = (int32_t)(uint32_t)(unsigned long long)b;
        } else {  // the span table holds an earlier launch's record
          S.bound = tile_bound(P, B.tile, S.rid, S.icap);
        }
        S.rem = 0;
        S.cnt = 0;
        S.it = 0;
        S.done = false;
        pc = loop_next(B, L, S, &slot) ? pc + 4 : code[pc + 3];
        break;
      }
      case OP_LOOP:  // one item decoded
        S.rem -= 1;
        S.cnt += 1;
        S.it += 1;
        pc = loop_next(B, L, S, &slot) ? S.rep_pc + 4 : code[S.rep_pc + 3];
        break;
      case OP_TRAILING:
        if (L.cur != L.end) L.err |= ERR_TRAILING;
        pc += 1;
        break;
      case OP_REBASE: {
        uint32_t* p = static_cast<uint32_t*>(B.dst[code[pc + 1]]);
        p[B.tid] += (uint32_t)P.base[B.row];
        pc += 2;
        break;
      }
      default:  // OP_END
        pc = kDone;
        break;
    }
  }
}

// Bytes of this block's slice of buffer b (a multiple of 16).
__device__ __forceinline__ long long slice_bytes(const int32_t* esize,
                                                 const int32_t* region,
                                                 const int32_t* caps, int b) {
  const long long per_row = region[b] == 0 ? 1 : caps[region[b]];
  return (long long)kThreads * per_row * esize[b];
}

__global__ void __launch_bounds__(kThreads) walk_decode_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout Lo = layout_of(P.code_len, P.n_bufs, P.n_regions, P.in_budget,
                              P.out_bytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  void** dst = reinterpret_cast<void**>(smem + Lo.dst);
  int32_t* tab = reinterpret_cast<int32_t*>(smem + Lo.table);
  int32_t* s_span = reinterpret_cast<int32_t*>(smem + Lo.stats);
  uint8_t* s_in = smem + Lo.in;
  uint8_t* s_out = smem + Lo.out;
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kThreads;

  // 1. the block's records, one span of flat widened to 16-B bounds: into
  // shared memory by one bulk copy when it fits the input budget
  const long long lo = P.offs[first];
  const long long hi = P.offs[first + kThreads];
  const long long a = lo & ~15ll;
  const long long span = ((hi + 15) & ~15ll) - a;
  const bool staged = hi > lo && span <= P.in_budget;
  if (tid == 0 && staged) mbar_init(bar);
  __syncthreads();  // the initialised barrier is visible to every thread
  if (tid == 0 && staged) bulk_load(s_in, P.flat + a, (uint32_t)span, bar);

  // 2. tables into shared memory, while the copy is in flight
  const int n_tab = P.code_len + 3 * P.n_bufs + P.n_regions;
  for (int i = tid; i < n_tab; i += kThreads) tab[i] = P.table[i];
  for (int i = tid; i < P.n_regions; i += kThreads) {
    s_span[i] = INT_MIN;
    s_span[P.n_regions + i] = 0;
    s_span[2 * P.n_regions + i] = 0;
  }
  __syncthreads();
  const int32_t* esize = tab + P.code_len;
  const int32_t* region = esize + P.n_bufs;
  const int32_t* stage = region + P.n_bufs;
  const int32_t* caps = stage + P.n_bufs;

  // 3. every output element of the block starts at 0: the staged slices in
  // shared memory, the others in device memory
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int b = tid; b < P.n_bufs; b += kThreads) {
    if (stage[b] >= 0) {
      dst[b] = s_out + stage[b];
    } else {
      dst[b] = reinterpret_cast<uint8_t*>(P.buf_ptrs[b]) +
               (long long)blockIdx.x * slice_bytes(esize, region, caps, b);
    }
  }
  for (int i = tid; i < P.out_bytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(s_out)[i] = zero;
  }
  for (int b = 0; b < P.n_bufs; ++b) {
    if (stage[b] >= 0) continue;
    const long long n16 = slice_bytes(esize, region, caps, b) / 16;
    uint4* g = reinterpret_cast<uint4*>(
        reinterpret_cast<uint8_t*>(P.buf_ptrs[b]) + blockIdx.x * n16 * 16);
    for (long long i = tid; i < n16; i += kThreads) g[i] = zero;
  }
  __syncthreads();
  if (staged) mbar_wait(bar, 0);

  // 4. the walk: one thread per row, the whole warp in step
  Block B;
  B.code = tab;
  B.esize = esize;
  B.caps = caps;
  B.dst = dst;
  B.s_span = s_span;
  B.s_cnt = s_span + P.n_regions;
  B.s_cut = s_span + 2 * P.n_regions;
  B.tid = tid;
  B.row = first + tid;
  B.tile = first / P.tile_r;  // a block lies inside one tile
  const long long o = P.offs[B.row];
  Lane L;
  L.src = staged ? s_in + (o - a) : P.flat + o;
  L.len = (uint32_t)(P.offs[B.row + 1] - o);
  L.end = (int32_t)L.len;
  L.last_word = (uint32_t)P.row_words - 1;
  L.cur = 0;
  L.err = 0;
  P.err[B.row] = run_row(P, B, L, P.act[B.row] != 0);
  __syncthreads();

  // 5. the tile's span record, and the staged slices out as 16-B stores
  for (int i = tid; i < P.n_regions; i += kThreads) {
    const size_t at = (size_t)B.tile * P.n_regions + i;
    if (B.s_cnt[i] > 0) {
      atomicMax(&P.span_max[at], B.s_span[i]);
      atomicAdd(&P.in_mask[at], B.s_cnt[i]);
    }
    if (B.s_cut[i]) P.cut[i] = 1;
  }
  for (int b = 0; b < P.n_bufs; ++b) {
    if (stage[b] < 0) continue;
    const long long n16 = slice_bytes(esize, region, caps, b) / 16;
    const uint4* s = reinterpret_cast<const uint4*>(s_out + stage[b]);
    uint4* g = reinterpret_cast<uint4*>(
        reinterpret_cast<uint8_t*>(P.buf_ptrs[b]) + blockIdx.x * n16 * 16);
    for (long long i = tid; i < n16; i += kThreads) g[i] = s[i];
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes.
extern "C" int walk_decode_smem_bytes(int code_len, int n_bufs, int n_regions,
                                      int in_budget, int out_bytes) {
  return layout_of(code_len, n_bufs, n_regions, in_budget, out_bytes).total;
}

static int allow_smem(int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      walk_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Blocks of the kernel that fit one SM at `smem_bytes` of dynamic shared
// memory (registers and threads counted too); a negative CUDA error code
// when the query fails.
extern "C" int walk_decode_blocks_per_sm(int smem_bytes) {
  int rc = allow_smem(smem_bytes);
  if (rc != 0) return -rc;
  int n = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, walk_decode_kernel, kThreads, smem_bytes);
  return rc != 0 ? -rc : n;
}

// Launches the walk on `stream`; returns a CUDA error code (0 = launched).
// R must be a multiple of tile_r, itself a multiple of 128; flat, every
// buffer pointer and the budgets 16-B aligned; flat readable up to
// offs[R] rounded up to 16. Every output buffer, err, span_max and in_mask
// of regions above fixed_upto are written whole; cut must be zeroed. The
// span tables of regions above fixed_upto must hold INT_MIN (span_max) and
// 0 (in_mask); those of regions 1..fixed_upto hold what an earlier launch
// recorded, and stay as they are.
extern "C" int walk_decode(const void* flat, const void* offs, const void* act,
                           const void* base, int R, int row_words,
                           const void* table, int code_len, int n_bufs,
                           int n_regions, const void* buf_ptrs, int tile_r,
                           int fixed_upto, int in_budget, int out_bytes,
                           void* span_max, void* in_mask, void* cut, void* err,
                           void* stream) {
  if (R <= 0) return 0;
  if (R % kThreads != 0 || tile_r % kThreads != 0 || R % tile_r != 0 ||
      in_budget < 0 || in_budget % 16 != 0 || out_bytes < 0 ||
      out_bytes % 16 != 0 || reinterpret_cast<uintptr_t>(flat) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.flat = static_cast<const uint8_t*>(flat);
  p.offs = static_cast<const long long*>(offs);
  p.act = static_cast<const int32_t*>(act);
  p.base = static_cast<const int32_t*>(base);
  p.R = R;
  p.row_words = row_words;
  p.table = static_cast<const int32_t*>(table);
  p.code_len = code_len;
  p.n_bufs = n_bufs;
  p.n_regions = n_regions;
  p.buf_ptrs = static_cast<const unsigned long long*>(buf_ptrs);
  p.tile_r = tile_r;
  p.fixed_upto = fixed_upto;
  p.in_budget = in_budget;
  p.out_bytes = out_bytes;
  p.span_max = static_cast<int32_t*>(span_max);
  p.in_mask = static_cast<int32_t*>(in_mask);
  p.cut = static_cast<int32_t*>(cut);
  p.err = static_cast<uint32_t*>(err);
  const int shmem =
      layout_of(code_len, n_bufs, n_regions, in_budget, out_bytes).total;
  const int rc = allow_smem(shmem);
  if (rc != 0) return rc;
  walk_decode_kernel<<<R / kThreads, kThreads, shmem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
