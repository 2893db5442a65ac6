// encode.cu — the encode program (K3) on Hopper: Arrow lanes → Avro wire
// bytes. encode_rows walks each row (a size pass, then a write pass that
// stores each block's output span whole from shared memory);
// encode_strings copies the payloads window by window of their source
// bytes, staged by bulk asynchronous copies.
//
// Replaces the reference's jitted encode program,
// pyruhvro_tpu/ops/encode.py DeviceEncoder._program (:1328-1341), which runs
// the emitters of _EncLowering (:160-554) as lane-masked vector passes (a
// size pass, an int32 cumsum, a write pass) and _write_string_bytes (:579)
// per payload column. Its plain PyTorch version is encode_plain in
// pyruhvro_tpu_torch/ops/encode.py (rows_plain, the cumsum, strings_plain).
// The kernels execute the flat int32 encode code of that module's
// lower_encoder; one build serves every schema (code and lane table are
// arguments).
//
// The launch buffer. Everything lives in one device buffer `base`: the
// code, a table of lane byte offsets (int64, one per lane id), a column
// table, the extractor's lanes, and the scratch lanes #off (each region's
// exclusive cumsum of #count, written by torch.cumsum before the launch)
// and #dst (each payload element's output position, -1 where no row writes
// it). Every lane starts 16-byte aligned.
//
// Bound on an H100 SXM: memory, (the bytes each function must move) /
// 3.35 TB/s: encode_rows the lane entries its code reaches, #off, #dst,
// the rows' non-payload bytes and the row sizes; encode_strings 12 B of
// #src/#len/#dst and the payload twice per placed payload
// (chip_smoke.py rows_traffic; PERF.md has the times beside them).
//
// encode_rows: one thread per row walks the code with the row's values.
// A value op reads its lane at the current index: the row, or the item of
// the innermost open array/map loop (a stack of (item, end, pc)). The wire
// form is canonical, so a walk over the live values only writes what the
// reference's masked vector passes write: minimal zig-zag varints, float
// and double bit patterns as they are, branch indices, decimals big-endian
// with the sign fill past byte 16, and single-block arrays/maps
// [count, items..., 0] or a bare 0. Size mode (write = 0) stores each
// row's byte count (0 for lanes at or past n). Write mode records each
// payload's output position in its #dst lane and writes every other byte
// at start = cum[row] - row_sizes[row]. The rows of a block own one
// contiguous span [S, E) of out. A span that fits the launch's budget is
// staged: each thread writes its row into shared memory at start - S0
// (S0 = S rounded down to 16), then the block stores the span whole, 16-B
// stores over the aligned middle and bytes over the head and tail. The
// budget is the largest that costs no resident block (the occupancy
// query), and at least kSpanFloor: a block of 128 Kafka rows spans about
// 12.4 KB, just over what costs no block, and staging them all at one
// block fewer an SM beats storing a fifth of them row by row. A block whose
// span is over the budget (rows of kilobytes) has each thread store its
// row's bytes to device memory itself, in the same kernel. A staged span's
// payload positions are stored with whatever shared memory held there:
// encode_strings, which runs after it on the same stream, writes every one
// of them, so those bytes are written twice and [0, total) ends as the
// plain version's.
//
// encode_strings computes strings_plain: byte j of a column's #bytes
// belongs to the element e with the largest #src[e] <= j (#src is
// non-decreasing; empty elements share a start; the _BIG pads own
// nothing) and goes to out[#dst[e] + j - #src[e]] when j - #src[e] <
// #len[e] and #dst[e] >= 0. Bytes past the end of the last element that
// starts in the buffer are never copied, so each column's windows of
// kWindow bytes cover [0, extent) (the table's extent); the windows of all
// columns are numbered in one sequence. A persistent grid (kGridWaves
// blocks per resident slot) gives each block a contiguous run of windows,
// walked in order with bulk asynchronous copies (cp.async.bulk, completed
// on mbarriers) running ahead: the window bytes kByteStages windows ahead,
// and the #src, #len and #dst of the window's elements one window ahead,
// from the owner of the byte before the window (a block-wide search over
// #src at a block's first window in a column, else the count the window
// before ended on), as many as the window before held plus a quarter and
// kAhead. Per window: the staged elements that start before its end are
// counted (more than were staged are loaded and mapped kChunk at a time);
// a window of at most kFew elements copies each one's bytes as a run,
// the whole block on each run with 16-B stores built by funnel shifts
// (payloads of kilobytes); any other marks each element's first byte in
// the window, maps each byte to its owner by a block max-scan over the
// marks, and stores the bytes in window order, so a warp's store
// instruction covers 32 neighbouring source bytes (a few payloads) and not
// 32 rows.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

// opcodes: keep in step with pyruhvro_tpu_torch/ops/encode.py
#define OP_END 0
#define OP_VARINT32 1
#define OP_VARINT64 2
#define OP_F32 3
#define OP_F64 4
#define OP_BOOL 5
#define OP_STRING 6
#define OP_PAYLOAD 7
#define OP_DEC_BYTES 8
#define OP_DEC_FIXED 9
#define OP_NULLABLE 10
#define OP_UNION 11
#define OP_JUMP 12
#define OP_REPEATED 13
#define OP_LOOP 14

namespace {

constexpr int kThreads = 128;       // rows of one encode_rows block
constexpr int kMaxDepth = 16;       // open loops a row keeps
constexpr int kSpanFloor = 16384;   // least span budget the wrapper asks
constexpr int kSpanMax = 65536;     // most span budget a launch may ask
static_assert(kSpanFloor % 16 == 0 && kSpanFloor <= kSpanMax, "budget");
constexpr int kColWords = 8;        // src len bytes dst lanes, n_el,
                                    // extent, first window, 0
constexpr int kStringThreads = 256;
constexpr int kWindow = 4096;       // #bytes a string window copies
constexpr int kSlot = kWindow / kStringThreads;  // bytes a thread maps
constexpr int kSlotWords = kSlot + 4;            // a slot, padded
constexpr int kChunk = 1024;        // elements a window stages at once
constexpr int kStageWords = kChunk + 8;  // a staged lane, 16-B padded
constexpr int kAhead = 64;          // margin of a window's staged elements
constexpr int kFew = 32;            // elements a window copies run by run
constexpr int kGridWaves = 8;       // blocks of the grid per resident slot
constexpr int kByteStages = 4;      // windows whose bytes are in flight
constexpr int kStringBlocks = 3;    // resident blocks the registers allow

struct Loop {
  int32_t i;    // current item
  int32_t end;  // one past the last item
  int32_t pc;   // the REPEATED op
};

struct RowWalk {
  const uint8_t* base;
  const long long* lanes;   // shared: byte offset of each lane
  uint8_t* out;             // null in size mode; shared for a staged
                            // span
  uint32_t origin;          // output byte at out[0]
  uint32_t start;           // the row's first byte, from out[0]
  uint32_t pos;             // bytes so far

  template <typename T>
  __device__ __forceinline__ T at(int lane, int32_t idx) const {
    return __ldg(reinterpret_cast<const T*>(base + lanes[lane]) + idx);
  }

  template <bool WRITE>
  __device__ __forceinline__ void put(uint32_t b) {
    if (WRITE) out[start + pos] = (uint8_t)b;
    pos++;
  }

  template <bool WRITE>
  __device__ __forceinline__ void varint(uint64_t z) {
    while (z >= 0x80u) {
      put<WRITE>((uint32_t)(z & 0x7Fu) | 0x80u);
      z >>= 7;
    }
    put<WRITE>((uint32_t)z);
  }

  template <bool WRITE>
  __device__ __forceinline__ void varint32(int32_t v) {
    const uint32_t u = (uint32_t)v;
    varint<WRITE>((uint64_t)((u << 1) ^ (0u - (u >> 31))));
  }

  // n big-endian bytes of the 16-byte little-endian two's complement at
  // dec[idx*16]; positions past byte 16 take the sign fill
  template <bool WRITE>
  __device__ __forceinline__ void decimal(int lane, int32_t idx, int n) {
    if (!WRITE) {
      pos += (uint32_t)n;
      return;
    }
    const uint8_t* dec =
        base + lanes[lane] + 16ll * (long long)idx;
    const uint32_t fill = dec[15] >= 0x80 ? 0xFFu : 0u;
    for (int k = 0; k < n; ++k) {
      const int le = n - 1 - k;
      put<WRITE>(le < 16 ? (uint32_t)dec[le] : fill);
    }
  }

  template <bool WRITE>
  __device__ void run(const int32_t* code, int32_t row) {
    Loop stack[kMaxDepth];
    int top = -1;
    int pc = 0;
    for (;;) {
      const int32_t idx = top < 0 ? row : stack[top].i;
      switch (code[pc]) {
        case OP_VARINT32:
          varint32<WRITE>(at<int32_t>(code[pc + 1], idx));
          pc += 2;
          break;
        case OP_VARINT64: {
          const uint64_t x =
              (uint64_t)at<uint32_t>(code[pc + 1], idx) |
              ((uint64_t)at<uint32_t>(code[pc + 2], idx) << 32);
          varint<WRITE>((x << 1) ^ (0ull - (x >> 63)));
          pc += 3;
          break;
        }
        case OP_F32: {
          const uint32_t w = at<uint32_t>(code[pc + 1], idx);
          for (int k = 0; k < 4; ++k) put<WRITE>((w >> (8 * k)) & 0xFFu);
          pc += 2;
          break;
        }
        case OP_F64: {
          const uint32_t lo = at<uint32_t>(code[pc + 1], idx);
          const uint32_t hi = at<uint32_t>(code[pc + 2], idx);
          for (int k = 0; k < 4; ++k) put<WRITE>((lo >> (8 * k)) & 0xFFu);
          for (int k = 0; k < 4; ++k) put<WRITE>((hi >> (8 * k)) & 0xFFu);
          pc += 3;
          break;
        }
        case OP_BOOL:
          put<WRITE>(at<uint8_t>(code[pc + 1], idx));
          pc += 2;
          break;
        case OP_STRING: {
          const int32_t len = at<int32_t>(code[pc + 1], idx);
          varint32<WRITE>(len);
          if (WRITE) {
            int32_t* dst = reinterpret_cast<int32_t*>(
                const_cast<uint8_t*>(base) + lanes[code[pc + 2]]);
            dst[idx] = (int32_t)(origin + start + pos);
          }
          pos += (uint32_t)len;
          pc += 3;
          break;
        }
        case OP_PAYLOAD:
          if (WRITE) {
            int32_t* dst = reinterpret_cast<int32_t*>(
                const_cast<uint8_t*>(base) + lanes[code[pc + 2]]);
            dst[idx] = (int32_t)(origin + start + pos);
          }
          pos += (uint32_t)code[pc + 1];
          pc += 3;
          break;
        case OP_DEC_BYTES: {
          const int32_t n = at<int32_t>(code[pc + 1], idx);
          varint32<WRITE>(n);
          decimal<WRITE>(code[pc + 2], idx, n);
          pc += 3;
          break;
        }
        case OP_DEC_FIXED:
          decimal<WRITE>(code[pc + 2], idx, code[pc + 1]);
          pc += 3;
          break;
        case OP_NULLABLE: {
          const bool valid = at<uint8_t>(code[pc + 1], idx) != 0;
          const int32_t null_idx = code[pc + 2];
          varint32<WRITE>(valid ? 1 - null_idx : null_idx);
          pc = valid ? pc + 4 : code[pc + 3];
          break;
        }
        case OP_UNION: {
          const int32_t tid = at<int32_t>(code[pc + 1], idx);
          const int32_t n = code[pc + 2];
          varint32<WRITE>(tid);
          const int32_t arm =
              (tid >= 0 && tid < n) ? code[pc + 4 + tid] : -1;
          pc = arm >= 0 ? arm : code[pc + 3];
          break;
        }
        case OP_JUMP:
          pc = code[pc + 1];
          break;
        case OP_REPEATED: {
          const int32_t count = at<int32_t>(code[pc + 1], idx);
          if (count > 0 && top + 1 < kMaxDepth) {
            varint32<WRITE>(count);
            const int32_t first = at<int32_t>(code[pc + 2], idx);
            ++top;
            stack[top].i = first;
            stack[top].end = first + count;
            stack[top].pc = pc;
            pc += 4;
          } else {
            put<WRITE>(0u);
            pc = code[pc + 3];
          }
          break;
        }
        case OP_LOOP: {
          Loop& lp = stack[top];
          if (++lp.i < lp.end) {
            pc = lp.pc + 4;
          } else {
            --top;
            put<WRITE>(0u);
            pc += 2;
          }
          break;
        }
        default:  // OP_END
          return;
      }
    }
  }
};

// -- Hopper bulk copy and mbarrier (as csrc/walk_decode.cu) -----------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// -- encode_rows ---------------------------------------------------------------

// Bytes of a block's lane table and code in shared memory, 16-B aligned;
// a staged span follows them.
__host__ __device__ __forceinline__ int tables_bytes(int n_lanes,
                                                     int code_len) {
  return (8 * n_lanes + 4 * code_len + 15) & ~15;
}

__global__ void __launch_bounds__(kThreads)
encode_rows_kernel(const uint8_t* base, const int32_t* code, int code_len,
                   const long long* lanes, int n_lanes, int n, int R,
                   int write, int span_budget, const int32_t* cum,
                   int32_t* row_sizes, uint8_t* out) {
  extern __shared__ __align__(16) long long smem[];
  long long* s_lanes = smem;
  int32_t* s_code = reinterpret_cast<int32_t*>(smem + n_lanes);
  uint8_t* s_span =
      reinterpret_cast<uint8_t*>(smem) + tables_bytes(n_lanes, code_len);
  for (int k = threadIdx.x; k < n_lanes; k += blockDim.x)
    s_lanes[k] = lanes[k];
  for (int k = threadIdx.x; k < code_len; k += blockDim.x)
    s_code[k] = code[k];
  __syncthreads();
  const int32_t r0 = (int32_t)(blockIdx.x * blockDim.x);
  const int32_t row = r0 + (int32_t)threadIdx.x;
  RowWalk w;
  w.base = base;
  w.lanes = s_lanes;
  w.origin = 0;
  w.pos = 0;
  if (!write) {
    if (row >= R) return;
    w.out = nullptr;
    w.start = 0;
    if (row < n) w.run<false>(s_code, row);
    row_sizes[row] = (int32_t)w.pos;
    return;
  }
  // write mode: the block's rows below n own [S, E) of out
  const int32_t r_end = min(r0 + (int32_t)blockDim.x, n);
  if (r_end <= r0) return;
  const int32_t S = cum[r0] - row_sizes[r0];
  const int32_t E = cum[r_end - 1];
  const int32_t S0 = S & ~15;
  if (E - S0 > span_budget) {
    // over the budget: each row's bytes go straight to device memory
    if (row < n) {
      w.out = out;
      w.start = (uint32_t)(cum[row] - row_sizes[row]);
      w.run<true>(s_code, row);
    }
    return;
  }
  // staged: the rows write the span into shared memory at g - S0 ...
  if (row < n) {
    w.out = s_span;
    w.origin = (uint32_t)S0;
    w.start = (uint32_t)(cum[row] - row_sizes[row] - S0);
    w.run<true>(s_code, row);
  }
  __syncthreads();
  // ... and the block stores it whole: 16-B stores over the aligned
  // middle [A, B), bytes over the head [S, A) and the tail [B, E)
  const int32_t A = min((S + 15) & ~15, E);
  const int32_t B = max(E & ~15, A);
  const int32_t tid = (int32_t)threadIdx.x;
  if (tid < A - S) out[S + tid] = s_span[S - S0 + tid];
  if (tid < E - B) out[B + tid] = s_span[B - S0 + tid];
  for (int32_t g = A + 16 * tid; g < B; g += 16 * kThreads)
    *reinterpret_cast<uint4*>(out + g) =
        *reinterpret_cast<const uint4*>(s_span + (g - S0));
}

// -- encode_strings ------------------------------------------------------------

// s_mark index of window byte k: each thread's kSlot bytes, padded to
// kSlotWords words, so a warp's 16-B stores of its slots and its word
// loads of neighbouring bytes both spread over the banks
__device__ __forceinline__ int map_at(int k) {
  return (k / kSlot) * kSlotWords + k % kSlot;
}

__device__ __forceinline__ int32_t word(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Arrives on `bar` expecting `bytes` more of asynchronous copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-B aligned) from
// global `src` to shared `dst`, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A payload column of the table: its lanes and sizes.
struct Column {
  const int32_t* src;
  const int32_t* len;
  const uint8_t* bytes;
  const int32_t* dst;
  int32_t n_el;    // elements
  int32_t extent;  // #bytes that may be copied: [0, extent)
  int32_t first;   // its first window
};

// The column of window w, scanning on from column c (windows are numbered
// column after column; a column without windows shares its first window
// with the next).
__device__ __forceinline__ int column_of(const int32_t* cols, int n_cols,
                                         int c, int32_t w) {
  while (c + 1 < n_cols && __ldg(cols + (c + 1) * kColWords + 6) <= w) ++c;
  return c;
}

__device__ __forceinline__ Column load_column(const uint8_t* base,
                                              const long long* lanes,
                                              const int32_t* cols, int c) {
  const int32_t* row = cols + c * kColWords;
  Column C;
  C.src = reinterpret_cast<const int32_t*>(base + __ldg(lanes + __ldg(row)));
  C.len =
      reinterpret_cast<const int32_t*>(base + __ldg(lanes + __ldg(row + 1)));
  C.bytes = base + __ldg(lanes + __ldg(row + 2));
  C.dst =
      reinterpret_cast<const int32_t*>(base + __ldg(lanes + __ldg(row + 3)));
  C.n_el = __ldg(row + 4);
  C.extent = __ldg(row + 5);
  C.first = __ldg(row + 6);
  return C;
}

// Block-wide search over the non-decreasing src[0, n): the number of
// elements with src[e] <= x. Each step samples kStringThreads points of
// the range left, so a million elements take three steps. Every thread
// of the block calls it.
__device__ int32_t count_le(const int32_t* src, int32_t n, int32_t x) {
  int32_t lo = 0, hi = n;  // the count lies in [lo, hi]
  const long long t = threadIdx.x;
  constexpr long long parts = kStringThreads + 1;
  while (lo < hi) {
    const long long span = hi - lo;
    const int32_t q = lo + (int32_t)(span * (t + 1) / parts);
    const int c = __syncthreads_count(__ldg(src + q) <= x);
    const int32_t new_lo = c > 0 ? lo + (int32_t)(span * c / parts) + 1 : lo;
    hi = c < kStringThreads ? lo + (int32_t)(span * (c + 1) / parts) : hi;
    lo = new_lo;
  }
  return lo;
}

// The sum of every thread's `v` (one barrier; `s_sum` holds a word per
// warp).
__device__ __forceinline__ int32_t block_sum(int32_t v, int32_t* s_sum) {
  v = __reduce_add_sync(0xFFFFFFFFu, v);
  if ((threadIdx.x & 31) == 0) s_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  int32_t total = 0;
#pragma unroll
  for (int k = 0; k < kStringThreads / 32; ++k) total += s_sum[k];
  return total;
}

// Where one window's prefetch put its elements: element c0a + i of the
// column at index i of the staged lanes, for i < cnt.
struct Staged {
  int32_t c0;   // the first element the window needs
  int32_t c0a;  // c0 rounded down to 4 (16-B aligned)
  int32_t cnt;  // elements copied
  int set;      // the staging set
  bool landed;  // the copies were waited for
};

// Starts window w's bytes towards a stage: the 16-B multiple by one bulk
// copy counted on `bar` (a bare arrive when there is none), the ragged
// tail by the threads below it. Its column is found on from column c. The
// stage was last read through the generic proxy, hence the proxy fence.
__device__ __forceinline__ void fetch_bytes(const uint8_t* base,
                                            const long long* lanes,
                                            const int32_t* cols, int n_cols,
                                            int c, int32_t w, uint8_t* win,
                                            uint64_t* bar) {
  const int32_t* row = cols + column_of(cols, n_cols, c, w) * kColWords;
  const uint8_t* bytes = base + __ldg(lanes + __ldg(row + 2));
  const int32_t ws = (w - __ldg(row + 6)) * kWindow;
  const int32_t wl = min(kWindow, __ldg(row + 5) - ws);
  const int32_t n16 = wl & ~15;
  if (threadIdx.x == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (n16 > 0) {
      mbar_expect(bar, (uint32_t)n16);
      bulk_copy(win, bytes + ws, (uint32_t)n16, bar);
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                       smem_addr(bar))
                   : "memory");
    }
  }
  if ((int32_t)threadIdx.x < wl - n16)
    win[n16 + threadIdx.x] = __ldg(bytes + ws + n16 + threadIdx.x);
}

// Starts a window's elements towards a staging set: the #src, #len and
// #dst of up to `want` elements from c0 (rounded down to 4), three bulk
// copies counted on `bar`.
__device__ __forceinline__ Staged fetch_elements(const Column& C, int32_t c0,
                                                 int32_t want, int set,
                                                 int32_t* el, uint64_t* bar) {
  Staged S;
  S.set = set;
  S.landed = false;
  S.c0 = c0;
  S.c0a = c0 & ~3;
  S.cnt = min(want, ((C.n_el + 3) & ~3) - S.c0a);
  if (threadIdx.x == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(bar, 12u * S.cnt);
    bulk_copy(el, C.src + S.c0a, 4u * S.cnt, bar);
    bulk_copy(el + kStageWords, C.len + S.c0a, 4u * S.cnt, bar);
    bulk_copy(el + 2 * kStageWords, C.dst + S.c0a, 4u * S.cnt, bar);
  }
  return S;
}

// One chunk of a window's elements, mc of them from src/len/dst (shared),
// the one after them starting at `next`: marks each element's first byte
// in the window (a start before ws counts at ws; of the elements that
// start together, the last), then maps each byte of this thread's slot
// in [max(ws, src[0]), min(we, next)) to its owner, the last mark at or
// before it, into tgt. Clears this thread's marks.
__device__ __forceinline__ void map_chunk(const int32_t* src,
                                          const int32_t* len,
                                          const int32_t* dst, int32_t mc,
                                          int32_t next, int32_t ws,
                                          int32_t we, int32_t* s_mark,
                                          int32_t* s_warp,
                                          int32_t (&tgt)[kSlot]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int32_t i = tid; i < mc; i += kStringThreads) {
    const int32_t p = max(src[i], ws);
    if (p != max(i + 1 < mc ? src[i + 1] : next, ws))
      s_mark[map_at(p - ws)] = i;
  }
  __syncthreads();
  int4* mine = reinterpret_cast<int4*>(s_mark + tid * kSlotWords);
  const int4 none = make_int4(-1, -1, -1, -1);
  int4 m4[kSlot / 4];
#pragma unroll
  for (int q = 0; q < kSlot / 4; ++q) {
    m4[q] = mine[q];
    mine[q] = none;
  }
  // the owner of this slot's first byte: the last mark of the slots
  // before it (an exclusive max-scan over the block)
  int32_t scan = -1;
#pragma unroll
  for (int k = 0; k < kSlot; ++k) scan = max(scan, word(m4[k >> 2], k & 3));
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t v = __shfl_up_sync(0xFFFFFFFFu, scan, d);
    if (lane >= d) scan = max(scan, v);
  }
  if (lane == 31) s_warp[warp] = scan;
  __syncthreads();
  int32_t run = __shfl_up_sync(0xFFFFFFFFu, scan, 1);
  if (lane == 0) run = -1;
  for (int v = 0; v < warp; ++v) run = max(run, s_warp[v]);
  const int32_t b0 = max(ws, src[0]), b1 = min(we, next);
  int32_t at = -1, from = 0, size = 0, to = -1;
#pragma unroll
  for (int k = 0; k < kSlot; ++k) {
    run = max(run, word(m4[k >> 2], k & 3));
    const int32_t j = ws + tid * kSlot + k;
    if (j >= b0 && j < b1) {
      if (run != at) {
        at = run;
        from = src[at];
        size = len[at];
        to = dst[at];
      }
      const int32_t pos = j - from;
      tgt[k] = (to >= 0 && pos < size) ? to + pos : -1;
    }
  }
}

// out[t0, t0 + n) = win[s0, s0 + n), by the whole block: bytes over the
// head and tail, 16-B stores over the aligned middle, each built from
// five words of the window by funnel shifts.
__device__ __forceinline__ void copy_run(uint8_t* out, int32_t t0,
                                         const uint8_t* win, int32_t s0,
                                         int32_t n) {
  const int32_t tid = (int32_t)threadIdx.x;
  const int32_t A = min((t0 + 15) & ~15, t0 + n);
  const int32_t B = max((t0 + n) & ~15, A);
  if (tid < A - t0) out[t0 + tid] = win[s0 + tid];
  if (tid < t0 + n - B) out[B + tid] = win[s0 + B - t0 + tid];
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(win);
  for (int32_t g = A + 16 * tid; g < B; g += 16 * kStringThreads) {
    const int32_t i = s0 + g - t0;
    const int32_t q = i >> 2;
    const uint32_t sh = 8u * (uint32_t)(i & 3);
    const uint32_t v0 = w32[q], v1 = w32[q + 1], v2 = w32[q + 2],
                   v3 = w32[q + 3], v4 = sh ? w32[q + 4] : 0u;
    *reinterpret_cast<uint4*>(out + g) =
        make_uint4(__funnelshift_r(v0, v1, sh), __funnelshift_r(v1, v2, sh),
                   __funnelshift_r(v2, v3, sh), __funnelshift_r(v3, v4, sh));
  }
}

// Elements to stage for a window whose neighbour had mc: a quarter more
// and kAhead, rounded up to 4 (the copies' 16-B steps), at most kChunk + 4.
// A window with more loads the rest itself.
__device__ __forceinline__ int32_t expect(int32_t mc) {
  return min(kChunk + 4, (mc + (mc >> 2) + kAhead + 3) & ~3);
}

// The payload copy. A persistent grid: each block walks a contiguous run
// of the launch's windows in order. Window bytes arrive kByteStages
// windows ahead, a window's elements one window ahead (where they start
// is known once the window before has counted its own), all by bulk
// copies, while the block maps and copies the window at hand.
__global__ void __launch_bounds__(kStringThreads, kStringBlocks)
encode_strings_kernel(const uint8_t* base, const long long* lanes,
                      const int32_t* cols, int n_cols, int32_t n_windows,
                      uint8_t* out) {
  extern __shared__ __align__(16) uint8_t smem_s[];
  uint8_t* s_win = smem_s;  // [kByteStages][kWindow]
  int32_t* s_el = reinterpret_cast<int32_t*>(smem_s + kByteStages * kWindow);
  // [2][3][kStageWords]: #src, #len, #dst of each set
  int32_t* s_mark = s_el + 6 * kStageWords;  // [kStringThreads][kSlotWords]
  int32_t* s_warp = s_mark + kStringThreads * kSlotWords;  // [8]
  uint64_t* s_wbar = reinterpret_cast<uint64_t*>(s_warp + 8);
  uint64_t* s_ebar = s_wbar + kByteStages;  // [2]
  const int tid = threadIdx.x;
  const int32_t w_lo =
      (int32_t)((long long)blockIdx.x * n_windows / gridDim.x);
  const int32_t w_hi =
      (int32_t)((long long)(blockIdx.x + 1) * n_windows / gridDim.x);
  if (w_lo >= w_hi) return;
  int4* mine = reinterpret_cast<int4*>(s_mark + tid * kSlotWords);
  const int4 none = make_int4(-1, -1, -1, -1);
  for (int q = 0; q < kSlot / 4; ++q) mine[q] = none;
  if (tid < kByteStages + 2) mbar_init(&s_wbar[tid]);
  __syncthreads();
  int c = column_of(cols, n_cols, 0, w_lo);
  Column C = load_column(base, lanes, cols, c);
  for (int d = 0; d < kByteStages && w_lo + d < w_hi; ++d)
    fetch_bytes(base, lanes, cols, n_cols, c, w_lo + d, s_win + d * kWindow,
                &s_wbar[d]);
  Staged S = fetch_elements(
      C, max(count_le(C.src, C.n_el, (w_lo - C.first) * kWindow - 1) - 1, 0),
      kChunk + 4, 0, s_el, &s_ebar[0]);
  uint32_t uses = 0;  // bit k: parity of set k's next completion
  for (int32_t w = w_lo; w < w_hi; ++w) {
    const int32_t i_w = w - w_lo;
    const int b = S.set;
    const int stage = i_w % kByteStages;
    uint8_t* win = s_win + stage * kWindow;
    int32_t* e_src = s_el + 3 * b * kStageWords;
    int32_t* e_len = e_src + kStageWords;
    int32_t* e_dst = e_len + kStageWords;
    const int32_t ws = (w - C.first) * kWindow;
    const int32_t wl = min(kWindow, C.extent - ws);
    const int32_t we = ws + wl;
    if (!S.landed) {
      mbar_wait(&s_ebar[b], (uses >> b) & 1);
      uses ^= 1u << b;
    }
    // 1. the staged elements that start before we (src is sorted)
    const int32_t off = S.c0 - S.c0a;
    const int32_t avail = min(S.cnt - off, C.n_el - S.c0);
    int32_t own = 0;
    for (int32_t i = tid; i < avail; i += kStringThreads)
      own += e_src[off + i] <= we - 1;
    int32_t mc = block_sum(own, s_warp);
    int32_t next = mc < avail ? e_src[off + mc]
                   : S.c0 + mc < C.n_el ? __ldg(C.src + S.c0 + mc)
                                         : INT_MAX;
    int32_t tgt[kSlot];
#pragma unroll
    for (int k = 0; k < kSlot; ++k) tgt[k] = -1;
    const int next_c = w + 1 < w_hi ? column_of(cols, n_cols, c, w + 1) : c;
    Staged N = S;
    int32_t* next_el = s_el + 3 * (b ^ 1) * kStageWords;
    // 2. the next window's elements start now, unless this one has more
    // than were staged (then after them), or they are staged already (a
    // payload over many windows)
    const bool more = next <= we - 1;
    if (!more && w + 1 < w_hi && next_c == c) {
      const int32_t c0 = max(S.c0 + mc - 1, 0);
      if (c0 - S.c0a + expect(mc) <= S.cnt) {
        N.c0 = c0;
        N.landed = true;
      } else {
        N = fetch_elements(C, c0, expect(mc), b ^ 1, next_el,
                           &s_ebar[b ^ 1]);
      }
    }
    // 3. a window of few elements copies them run by run (below); any
    // other maps its bytes, chunk by chunk: the staged one, then (rarely)
    // chunks loaded here
    const bool few = !more && mc <= kFew;
    if (!few)
      map_chunk(e_src + off, e_len + off, e_dst + off, mc, next, ws, we,
                s_mark, s_warp, tgt);
    int32_t cursor = S.c0 + mc;  // elements with src <= we - 1, so far
    while (next <= we - 1) {
      __syncthreads();  // the chunk's elements are read
      own = 0;
      for (int32_t i = tid; i < kChunk; i += kStringThreads) {
        const int32_t e = cursor + i;
        int32_t sv = INT_MAX;
        if (e < C.n_el) {
          sv = __ldg(C.src + e);
          e_len[i] = __ldg(C.len + e);
          e_dst[i] = __ldg(C.dst + e);
        }
        e_src[i] = sv;
        own += sv <= we - 1;
      }
      mc = block_sum(own, s_warp);
      next = mc < kChunk ? e_src[mc]
             : cursor + mc < C.n_el ? __ldg(C.src + cursor + mc)
                                    : INT_MAX;
      map_chunk(e_src, e_len, e_dst, mc, next, ws, we, s_mark, s_warp, tgt);
      cursor += mc;
    }
    if (w + 1 < w_hi && (more || next_c != c)) {
      int32_t c0;
      if (next_c != c) {
        c = next_c;
        C = load_column(base, lanes, cols, c);
        c0 = max(count_le(C.src, C.n_el, (w + 1 - C.first) * kWindow - 1) - 1,
                 0);
      } else {
        c0 = max(cursor - 1, 0);
      }
      N = fetch_elements(C, c0, kChunk + 4, b ^ 1, next_el, &s_ebar[b ^ 1]);
    }
    // 4. the copy. Few elements: each one's bytes in the window, the
    // whole block on each run. Else the targets go into the slot, and
    // neighbouring threads store neighbouring window bytes
    mbar_wait(&s_wbar[stage], (i_w / kByteStages) & 1);
    if (few) {
      for (int32_t i = 0; i < mc; ++i) {
        const int32_t from = e_src[off + i], to = e_dst[off + i];
        const int32_t lo = max(from, ws);
        const int32_t hi = min(min(i + 1 < mc ? e_src[off + i + 1] : next,
                                   from + e_len[off + i]),
                               we);
        if (to >= 0 && lo < hi)
          copy_run(out, to + lo - from, win, lo - ws, hi - lo);
      }
    } else {
#pragma unroll
      for (int q = 0; q < kSlot / 4; ++q)
        mine[q] = make_int4(tgt[4 * q], tgt[4 * q + 1], tgt[4 * q + 2],
                            tgt[4 * q + 3]);
      __syncthreads();
      for (int k = tid; k < wl; k += kStringThreads) {
        const int32_t t = s_mark[map_at(k)];
        if (t >= 0) out[t] = win[k];
      }
    }
    __syncthreads();
    for (int q = 0; q < kSlot / 4; ++q) mine[q] = none;
    // 5. the stage refills kByteStages windows ahead
    if (w + kByteStages < w_hi)
      fetch_bytes(base, lanes, cols, n_cols, c, w + kByteStages, win,
                  &s_wbar[stage]);
    S = N;
  }
}

}  // namespace

// Dynamic shared memory of one encode_rows block at `span_budget` bytes of
// span staging (0 in size mode).
extern "C" int encode_rows_smem_bytes(int n_lanes, int code_len,
                                      int span_budget) {
  return tables_bytes(n_lanes, code_len) + span_budget;
}

static int allow_rows_smem(int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      encode_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Blocks of encode_rows that fit one SM at `smem_bytes` of dynamic shared
// memory (registers and threads counted too); a negative CUDA error code
// when the query fails.
extern "C" int encode_rows_blocks_per_sm(int smem_bytes) {
  int rc = allow_rows_smem(smem_bytes);
  if (rc != 0) return -rc;
  int n = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, encode_rows_kernel, kThreads, smem_bytes);
  return rc != 0 ? -rc : n;
}

// Launches one pass of the row walk on `stream`; returns a CUDA error code
// (0 = launched). write = 0: row_sizes[R] (cum and out unused). write = 1:
// out at start = cum[row] - row_sizes[row] and the #dst lanes, for rows < n;
// a block whose span fits span_budget (a multiple of 16 up to kSpanMax;
// out 16-B aligned) stages it in shared memory. The wrapper asks for
// what costs no resident block, and at least kSpanFloor.
extern "C" int encode_rows(const void* base, const void* code, int code_len,
                           const void* lanes, int n_lanes, int n, int R,
                           int depth, int write, int span_budget,
                           const void* cum, void* row_sizes, void* out,
                           void* stream) {
  if (R <= 0) return 0;
  if (n < 0 || n > R || depth > kMaxDepth || code_len <= 0 ||
      (write && (cum == nullptr || out == nullptr)) ||
      span_budget < 0 || span_budget > kSpanMax || span_budget % 16 != 0 ||
      (span_budget > 0 && reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int budget = write ? span_budget : 0;
  const int shmem = encode_rows_smem_bytes(n_lanes, code_len, budget);
  const int rc = allow_rows_smem(shmem);
  if (rc != 0) return rc;
  encode_rows_kernel<<<(R + kThreads - 1) / kThreads, kThreads, shmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), static_cast<const int32_t*>(code),
      code_len, static_cast<const long long*>(lanes), n_lanes, n, R, write,
      budget, static_cast<const int32_t*>(cum),
      static_cast<int32_t*>(row_sizes), static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one encode_strings block: kByteStages window
// stages, two element sets (#src, #len, #dst), the marks, the warp sums,
// the stages' and sets' mbarriers.
static int strings_smem_bytes() {
  return kByteStages * kWindow + 4 * 6 * kStageWords +
         4 * kStringThreads * kSlotWords + 4 * 8 + 8 * (kByteStages + 2);
}

// Launches the payload copy on `stream`: n_windows windows of kWindow
// bytes (each column's windows cover [0, extent) of its #bytes and are
// numbered from its table row's first window), walked in order by a grid
// of as many blocks as fit the card at once, each taking a contiguous run.
// Returns a CUDA error code.
extern "C" int encode_strings(const void* base, const void* lanes,
                              const void* cols, int n_cols,
                              long long n_windows, void* out, void* stream) {
  if (n_windows <= 0 || n_cols <= 0) return 0;
  if (n_windows > INT_MAX || reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int shmem = strings_smem_bytes();
  int dev = 0, sms = 0, per_sm = 0;
  int rc = (int)cudaFuncSetAttribute(
      encode_strings_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shmem);
  if (rc == 0) rc = (int)cudaGetDevice(&dev);
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, encode_strings_kernel, kStringThreads, shmem);
  if (rc != 0) return rc;
  const long long grid =
      min(n_windows, (long long)sms * max(per_sm, 1) * kGridWaves);
  encode_strings_kernel<<<(unsigned)grid, kStringThreads, shmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), static_cast<const long long*>(lanes),
      static_cast<const int32_t*>(cols), n_cols, (int32_t)n_windows,
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
