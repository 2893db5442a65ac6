// walk_decode.cu — the Avro field-program walk, one thread per record.
//
// Replaces pyruhvro_tpu/ops/pallas_decode.py PallasKernelDecoder._build
// (the kernel body at :203-241 and its pl.pallas_call at :256), which runs
// the schema-lowered field program over row-padded [TILE_R, BW] u32 tiles.
// The Pallas helpers that exist only because Mosaic lowers no gathers,
// scatters or integer reductions (_TileWords.take_words, item_put,
// reduce_max_f32) have no counterpart here: a thread loads its record's
// bytes directly and stores each value directly to its slot.
//
// What it computes (per record, cursor record-local, reads clipped to the
// row's last word): LEB128 varints with zig-zag into (lo, hi) u32, float
// and double bit patterns, bools, enum and union indices with range checks,
// nullable validity, (start, len) string descriptors, the array/map block
// loop into strided slots row*icap+cnt (ERR_ITEM_OVERFLOW past the cap,
// the slot then dropped), OR-accumulated error bits, ERR_TRAILING, and the
// row-region #start rebase to row*BW*4. It executes the flat int32 code of
// pyruhvro_tpu_torch/ops/fieldprog.py; one build serves every schema,
// since the code, the output buffer table and the item caps are arguments.
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
// Bound on an H100 SXM: memory. A call (the wrapper's zero-fill of the
// outputs and this launch) must read each record's bytes up to its length,
// in 32-byte sectors, plus lens and act, and write every output buffer
// once: (sum of sector-rounded lengths + 8*R + output bytes) / 3.35 TB/s.
// This first design makes uncoalesced loads and stores: each thread walks
// its own 4*BW-byte row byte by byte and threads of a warp diverge on the
// schema's branches. Coalesced staging of rows through shared memory and
// warp-cooperative decoding are later work.
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

constexpr int kThreads = 128;  // divides every tile (tile_r % 128 == 0)

struct Params {
  const uint8_t* rows;                 // [R, row_words*4]
  const int32_t* lens;                 // [R]
  const int32_t* act;                  // [R]
  int R;
  int row_words;                       // BW
  const int32_t* code;
  const unsigned long long* buf_ptrs;  // device pointers
  const int32_t* buf_esize;            // 1 or 4 bytes
  const int32_t* caps;                 // [n_regions]
  int n_regions;
  int tile_r;
  int fixed_upto;                      // regions 1..fixed_upto: tile bound
  int32_t* span_max;                   // [n_tiles, n_regions]
  int32_t* in_mask;                    // [n_tiles, n_regions]
  int32_t* cut;                        // [n_regions]
  uint32_t* err;                       // [R]
};

struct Lane {
  const uint8_t* row;
  uint32_t last_word;
  int32_t end;
  int32_t cur;
  uint32_t err;
};

__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// Byte k of the window at cursor c: word min((c>>2) + (((c&3)+k)>>2), BW-1).
__device__ __forceinline__ uint32_t win_byte(const Lane& L, uint32_t c,
                                             uint32_t k) {
  const uint32_t m = (c & 3u) + k;
  const uint32_t w = min((c >> 2) + (m >> 2), L.last_word);
  return L.row[(w << 2) | (m & 3u)];
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

__device__ __forceinline__ void put(const Params& P, int b, long long slot,
                                    uint32_t v) {
  if (slot < 0) return;  // an item past the cap: dropped
  if (P.buf_esize[b] == 1) {
    reinterpret_cast<uint8_t*>(P.buf_ptrs[b])[slot] = (uint8_t)v;
  } else {
    reinterpret_cast<uint32_t*>(P.buf_ptrs[b])[slot] = v;
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
__device__ bool loop_next(const Params& P, Lane& L, Loop& S, int row,
                          long long* slot, int32_t* s_cut) {
  for (;;) {
    if (S.done || S.it >= S.bound) {
      if (!S.done) {
        L.err |= ERR_OVERRUN;  // ran out of iterations: malformed
        if (S.own) s_cut[S.rid] = 1;
      }
      put(P, P.code[S.rep_pc + 1], row, (uint32_t)S.cnt);
      *slot = row;
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
      *slot = S.cnt < S.icap ? (long long)row * S.icap + S.cnt : -1;
      return true;
    }
    S.it += 1;
  }
}

__device__ void run_row(const Params& P, int row, int tile, int32_t* s_span,
                        int32_t* s_cnt, int32_t* s_cut) {
  const int32_t* code = P.code;
  Lane L;
  L.row = P.rows + (size_t)row * (size_t)P.row_words * 4;
  L.last_word = (uint32_t)P.row_words - 1;
  L.end = P.lens[row];
  L.cur = 0;
  L.err = 0;
  long long slot = row;
  Loop S = {};
  int pc = 0;
  for (;;) {
    switch (code[pc]) {
      case OP_LONG: {
        uint32_t lo, hi;
        read_long(L, lo, hi);
        put(P, code[pc + 1], slot, lo);
        put(P, code[pc + 2], slot, hi);
        pc += 3;
        break;
      }
      case OP_INT: {
        uint32_t lo, hi;
        read_long(L, lo, hi);
        put(P, code[pc + 1], slot, lo);
        pc += 2;
        break;
      }
      case OP_FLOAT: {
        const uint32_t v = win_word(L, (uint32_t)L.cur, 0);
        L.cur = add_wrap(L.cur, 4);
        put(P, code[pc + 1], slot, v);
        pc += 2;
        break;
      }
      case OP_DOUBLE: {
        const uint32_t lo = win_word(L, (uint32_t)L.cur, 0);
        const uint32_t hi = win_word(L, (uint32_t)L.cur, 4);
        L.cur = add_wrap(L.cur, 8);
        put(P, code[pc + 1], slot, lo);
        put(P, code[pc + 2], slot, hi);
        pc += 3;
        break;
      }
      case OP_BOOL: {
        const uint32_t b = win_byte(L, (uint32_t)L.cur, 0);
        if (b > 1u) L.err |= ERR_BAD_BOOL;
        L.cur = add_wrap(L.cur, 1);
        put(P, code[pc + 1], slot, b);
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
        put(P, code[pc + 1], slot, (uint32_t)start);
        put(P, code[pc + 2], slot, (uint32_t)slen);
        L.cur = next;
        pc += 3;
        break;
      }
      case OP_FIXED: {
        const int32_t start = L.cur;
        const int32_t next = add_wrap(start, code[pc + 2]);
        if (next > L.end) L.err |= ERR_OVERRUN;
        put(P, code[pc + 1], slot, (uint32_t)start);
        L.cur = next;
        pc += 3;
        break;
      }
      case OP_ENUM: {
        uint32_t lo, hi;
        read_long(L, lo, hi);
        const int32_t idx = (int32_t)lo;
        if (hi != 0u || idx < 0 || idx >= code[pc + 2]) L.err |= ERR_BAD_ENUM;
        put(P, code[pc + 1], slot, (uint32_t)idx);
        pc += 3;
        break;
      }
      case OP_NULLABLE: {
        const int32_t br = read_branch(L);
        const int32_t null_idx = code[pc + 2];
        const bool present = br == 1 - null_idx;
        if (!present && br != null_idx) L.err |= ERR_BAD_BRANCH;
        if (present) {
          put(P, code[pc + 1], slot, 1u);
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
        put(P, code[pc + 1], slot, (uint32_t)br);
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
        S.icap = P.caps[S.rid];
        S.own = S.rid > P.fixed_upto;
        if (S.own) {
          const int32_t span = (int32_t)((uint32_t)L.end - (uint32_t)L.cur);
          atomicMax(&s_span[S.rid], span);
          atomicAdd(&s_cnt[S.rid], 1);
          const long long b = bound_of(span, S.icap);
          if (b > INT_MAX) s_cut[S.rid] = 1;  // the tile's bound wraps
          S.bound = (int32_t)(uint32_t)(unsigned long long)b;
        } else {  // the span table holds an earlier launch's record
          S.bound = tile_bound(P, tile, S.rid, S.icap);
        }
        S.rem = 0;
        S.cnt = 0;
        S.it = 0;
        S.done = false;
        pc = loop_next(P, L, S, row, &slot, s_cut) ? pc + 4 : code[pc + 3];
        break;
      }
      case OP_LOOP:  // one item decoded
        S.rem -= 1;
        S.cnt += 1;
        S.it += 1;
        pc = loop_next(P, L, S, row, &slot, s_cut) ? S.rep_pc + 4
                                                    : code[S.rep_pc + 3];
        break;
      case OP_TRAILING:
        if (L.cur != L.end) L.err |= ERR_TRAILING;
        pc += 1;
        break;
      case OP_REBASE: {
        uint32_t* p = reinterpret_cast<uint32_t*>(P.buf_ptrs[code[pc + 1]]);
        p[row] += (uint32_t)row * (uint32_t)(P.row_words * 4);
        pc += 2;
        break;
      }
      default:  // OP_END
        P.err[row] = L.err;
        return;
    }
  }
}

__global__ void __launch_bounds__(kThreads) walk_decode_kernel(Params P) {
  extern __shared__ int32_t smem[];
  int32_t* s_span = smem;
  int32_t* s_cnt = smem + P.n_regions;
  int32_t* s_cut = smem + 2 * P.n_regions;
  for (int i = threadIdx.x; i < P.n_regions; i += blockDim.x) {
    s_span[i] = INT_MIN;
    s_cnt[i] = 0;
    s_cut[i] = 0;
  }
  __syncthreads();
  const int first = blockIdx.x * blockDim.x;
  const int tile = first / P.tile_r;  // a block lies inside one tile
  const int row = first + threadIdx.x;
  if (row < P.R && P.act[row] != 0) {
    run_row(P, row, tile, s_span, s_cnt, s_cut);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P.n_regions; i += blockDim.x) {
    const size_t at = (size_t)tile * P.n_regions + i;
    if (s_cnt[i] > 0) {
      atomicMax(&P.span_max[at], s_span[i]);
      atomicAdd(&P.in_mask[at], s_cnt[i]);
    }
    if (s_cut[i]) P.cut[i] = 1;
  }
}

}  // namespace

// Launches the walk on `stream`; returns cudaGetLastError() (0 = launched).
// R must be a multiple of tile_r, itself a multiple of 128. The outputs
// (buffers, err, cut) must be zeroed. The span tables of regions above
// fixed_upto must hold INT_MIN (span_max) and 0 (in_mask); those of regions
// 1..fixed_upto hold what an earlier launch recorded, and stay as they are.
extern "C" int walk_decode(const void* rows, const void* lens, const void* act,
                           int R, int row_words, const void* code,
                           const void* buf_ptrs, const void* buf_esize,
                           const void* caps, int n_regions, int tile_r,
                           int fixed_upto, void* span_max, void* in_mask,
                           void* cut, void* err, void* stream) {
  if (R <= 0) return 0;
  if (R % kThreads != 0 || tile_r % kThreads != 0 || R % tile_r != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.rows = static_cast<const uint8_t*>(rows);
  p.lens = static_cast<const int32_t*>(lens);
  p.act = static_cast<const int32_t*>(act);
  p.R = R;
  p.row_words = row_words;
  p.code = static_cast<const int32_t*>(code);
  p.buf_ptrs = static_cast<const unsigned long long*>(buf_ptrs);
  p.buf_esize = static_cast<const int32_t*>(buf_esize);
  p.caps = static_cast<const int32_t*>(caps);
  p.n_regions = n_regions;
  p.tile_r = tile_r;
  p.fixed_upto = fixed_upto;
  p.span_max = static_cast<int32_t*>(span_max);
  p.in_mask = static_cast<int32_t*>(in_mask);
  p.cut = static_cast<int32_t*>(cut);
  p.err = static_cast<uint32_t*>(err);
  const size_t shmem = 3 * (size_t)n_regions * sizeof(int32_t);
  walk_decode_kernel<<<R / kThreads, kThreads, shmem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
