// decode_finalize.cu — the pipeline engine's finalize (K2) on Hopper: the
// walk's strided item slots compacted into dense arrays, the reductions
// that drive the capacity ladder and the blob shrinking, all written into
// the one uint8 blob that a single device-to-host copy brings back.
//
// Replaces pyruhvro_tpu/ops/decode.py DeviceDecoder.build_pipeline's
// pipeline (:456-542), which XLA fuses after the walk: per item region,
// parents first, the counts gathered through the parent's slot map,
// #offsets (a cumsum), row_of (scatter-max + cummax), the gather of every
// item buffer, then #red:max/#red:sum/#red:err/#red:strfit, the string
// descriptors packed as sl32 (start | len << 21) or #start + u16 #lenc,
// every u8 lane bit-packed little-endian, and the concatenation in sorted
// key order. Its plain PyTorch version is finalize_plain in ops/decode.py;
// the wrapper (FinalizeTables, built once per rung) holds the blob layout
// and hands this kernel its tables, so one build serves every schema.
//
// Launches, in stream order, all made by one call of decode_finalize_run:
// - one finalize_tiles_kernel per level of nesting. Level 1 holds the row
//   segment (the row-region payload and the error flag, tiles of kTile
//   rows) and one segment per region whose parent is the row; level k + 1
//   one segment per region nested k deep. A block takes a ticket from an
//   atomic counter and works on that tile of its segment, so a tile only
//   ever waits on tiles that were handed out before it.
// - one finalize_tail_kernel: each item field's positions past its
//   region's total zeroed, the bit-packed item lanes packed, and, in block
//   0, #red:max/#red:sum/#red:err/#red:strfit and the status bytes (byte
//   0: a region's total reached 2^31, which int32 #offsets cannot hold);
//   then block 0 resets the tickets, the look-back words and the maxima
//   for the next run on the same scratch. Every byte of the blob is
//   written by exactly one of them; the blob is torch.empty.
//
// An item segment's tile is kRows entries (rows, or the parent's compacted
// positions), kPerEntry consecutive entries per thread. The block reads
// its entries' counts (a nested region's from the scratch its parent's
// tiles gathered them into, zero past the parent's total), folds their
// maximum into #red:max, scans them in int64 and takes the tile's prefix
// by a single-pass decoupled look-back (warp 0 reads kLookBack
// predecessors' words at a time, all in flight together; a word is the
// tile's sum or its inclusive prefix with a 2-bit flag). It writes its entries of #offsets (int32, truncated), and
// its entries' items fill the contiguous positions [P, P + sum): entry e's
// item k is position off[e] + k, slot parent_slot[e] * icap + k in
// wrapping int32, positions at or past tot_cap dropped. So no position
// searches for its entry; an empty entry places nothing, as row_of gives
// the position to the last entry that starts there.
//
// Bound on an H100 SXM: memory. The launches must read each gathered
// element once and write the blob once: (those bytes) / 3.35 TB/s. The
// blob's key order (the reference's) leaves fields at any byte offset (on
// the Kafka schema every 4-byte field starts at 2 mod 4), so a store per
// element would go out byte by byte. Instead each warp of a block gathers
// its part of a span (kWarpSpan of up to kTile positions) into shared
// memory at the same offset mod 16 as the field's bytes in the blob, then
// stores that part whole (store_span): 16-byte words over its aligned
// middle, single bytes over its head and tail. No 16-byte word crosses
// the part, and no two parts meet, so every blob byte is written by one
// thread; and no block barrier falls between two jobs, so a warp's loads
// wait on no other warp. A bit-packed item lane cannot be split so (a
// tile's span starts at any bit), so its tiles store one byte per
// position into scratch and the tail kernel packs it, 8 positions to a
// byte. The job descriptors (with their sources' pointers and lengths)
// are resolved into shared memory kJobChunk at a time, one thread each.
// The row payload's jobs of one row tile are split over several blocks
// (groups of FIN_ROW_JOBS). The sources' pointers change every call and
// come by value in the launch's parameter
// block (__grid_constant__): nothing is copied to the card per call.

#include <cstdint>
#include <cuda_runtime.h>

#define ERR_ITEM_OVERFLOW 128u

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // rows of a row tile; span
constexpr int kPerEntry = 4;
constexpr int kRows = kThreads * kPerEntry;   // entries of an item tile
constexpr int kWarps = kThreads / 32;
constexpr int kJobChunk = 32;  // job descriptors a block resolves at once
constexpr int kLookBack = 256;  // look-back words read at once (warp 0)
// a warp's own part of a span, and of a staging set
constexpr int kWarpSpan = kTile / kWarps;
constexpr int kWarpStage4 = 4 * kWarpSpan + 16;
constexpr int kWarpSet = kWarpStage4 + 2 * kWarpSpan + 16;
// the sources' pointers a launch's parameter block holds: kSrcSmall (a
// Call of 552 bytes) up to that many sources, else kSrcMax (32,040
// bytes). The larger block costs about 2 us more a launch on the card
// and 10 us more host enqueue a run (PERF.md section 6, the parameter
// block's A/B; scripts/k2_param_block.py builds this source with
// -DFIN_SRC_SMALL=4000 to time it).
#ifndef FIN_SRC_SMALL
#define FIN_SRC_SMALL 64
#endif
constexpr int kSrcSmall = FIN_SRC_SMALL;
constexpr int kSrcMax = 4000;

// job kinds: keep in step with ops/decode.py (J_*). No J_REDUCE job is
// handed to the kernel: an item segment folds its counts' maximum itself.
enum { J_COPY32, J_BITS8, J_SL32, J_START_LENC, J_REDUCE, J_ERRFLAG };
// epilogue entries: keep in step with ops/decode.py (E_*)
enum { E_MAX, E_SUM, E_ERR, E_STRFIT, E_STATUS };
// segment kinds: keep in step with ops/decode.py (SEG_*)
enum { SEG_ROWS, SEG_ITEMS };
// table words: keep in step with ops/decode.py (_*_WORDS, FinalizeTables)
constexpr int kHeadWords = 14;  // n_seg seg_at job_at ent_at n_ent len_at
                                // n_red n_flag n_aux n_lvl red_off tot_off
                                // flag_off ticket_off
constexpr int kSegWords = 18;   // kind rid n_entries tcap icap counts_src
                                // counts_off parent pslot_off slot_off
                                // off_at job_first job_end tile_first
                                // n_tiles flag_first aux_first n_aux
constexpr int kJobWords = 8;    // kind src src2 at at2 scratch red esize
constexpr int kEntryWords = 5;  // kind at a b c
constexpr int kStatusBytes = 8;
// a look-back word: value << 2 | flag
constexpr unsigned long long kAggregate = 1, kInclusive = 2;

template <int N>
struct Call {
  const long long* tab;  // FinalizeTables' words, on the card
  uint8_t* scratch;      // this run's scratch (FinalizeScratch)
  uint8_t* blob;
  int seg_first, seg_end;  // the launch's segments
  int level;               // its ticket
  int n_src;
  const void* src[N];      // the walk's buffers, then #err
};

__device__ __forceinline__ void store32(uint8_t* p, uint32_t v) {
  if ((reinterpret_cast<uintptr_t>(p) & 3u) == 0) {
    *reinterpret_cast<uint32_t*>(p) = v;
  } else {
    p[0] = (uint8_t)v;
    p[1] = (uint8_t)(v >> 8);
    p[2] = (uint8_t)(v >> 16);
    p[3] = (uint8_t)(v >> 24);
  }
}

// Little-endian stores into a staging set (shared memory), as wide as the
// address allows.
__device__ __forceinline__ void put32(uint8_t* p, uint32_t v) {
  switch (reinterpret_cast<uintptr_t>(p) & 3u) {
    case 0:
      *reinterpret_cast<uint32_t*>(p) = v;
      break;
    case 2:
      reinterpret_cast<uint16_t*>(p)[0] = (uint16_t)v;
      reinterpret_cast<uint16_t*>(p)[1] = (uint16_t)(v >> 16);
      break;
    default:
      p[0] = (uint8_t)v;
      *reinterpret_cast<uint16_t*>(p + 1) = (uint16_t)(v >> 8);
      p[3] = (uint8_t)(v >> 24);
  }
}

__device__ __forceinline__ void put16(uint8_t* p, uint32_t v) {
  if ((reinterpret_cast<uintptr_t>(p) & 1u) == 0) {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)v;
  } else {
    p[0] = (uint8_t)v;
    p[1] = (uint8_t)(v >> 8);
  }
}

// Byte g0 + k of a span goes to the staging set at shift_of(g0) + k.
__device__ __forceinline__ int shift_of(const uint8_t* g0) {
  return (int)(reinterpret_cast<uintptr_t>(g0) & 15u);
}

// A group of kGroup threads (the block, or a warp) stores the staged span
// [d, d + n): bytes over the head up to the first 16-byte boundary and
// over the tail after the last, 16-byte words between. `st` holds byte k
// at st + shift_of(d) + k.
template <int kGroup>
__device__ __forceinline__ void store_span(uint8_t* d, long long n,
                                           const uint8_t* st) {
  if (n <= 0) return;
  const uint8_t* s = st + shift_of(d);
  const long long a = min((long long)((16 - shift_of(d)) & 15), n);
  const long long b = a + ((n - a) & ~15ll);
  const int tid = threadIdx.x % kGroup;
  if (tid < a) d[tid] = s[tid];
  if (tid < n - b) d[b + tid] = s[b + tid];
  for (long long k = a + 16 * tid; k < b; k += 16 * kGroup) {
    *reinterpret_cast<uint4*>(d + k) = *reinterpret_cast<const uint4*>(s + k);
  }
}

// The block zeroes [d, d + n), in the pieces of store_span.
__device__ __forceinline__ void zero_span(uint8_t* d, long long n) {
  if (n <= 0) return;
  const long long a = min((long long)((16 - shift_of(d)) & 15), n);
  const long long b = a + ((n - a) & ~15ll);
  const int tid = threadIdx.x;
  if (tid < a) d[tid] = 0;
  if (tid < n - b) d[b + tid] = 0;
  for (long long k = a + 16 * tid; k < b; k += 16 * kThreads) {
    *reinterpret_cast<uint4*>(d + k) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ int32_t load_max(const int32_t* p) {
  int32_t v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// One job with its sources resolved, as a block keeps it in shared memory.
struct Job {
  const void* src;
  long long n;
  const void* src2;  // J_SL32 / J_START_LENC: the lengths
  long long n2;
  long long at, at2;
  uint8_t* scratch;  // J_COPY32: a child's counts; J_BITS8 of an item
                     // segment: the lane's bytes by position; or null
  int kind, red, esize;
};

template <int N>
__device__ __forceinline__ void load_job(const Call<N>& c, int k, Job* out) {
  const long long* T = c.tab;
  const long long* J = T + T[2] + (size_t)k * kJobWords;
  const long long* len = T + T[5];
  const int src = (int)J[1];
  const int src2 = (int)J[2];
  out->kind = (int)J[0];
  out->src = c.src[src];
  out->n = len[src];
  out->src2 = src2 >= 0 ? c.src[src2] : nullptr;
  out->n2 = src2 >= 0 ? len[src2] : 0;
  out->at = J[3];
  out->at2 = J[4];
  out->scratch = J[5] >= 0 ? c.scratch + J[5] : nullptr;
  out->red = (int)J[6];
  out->esize = (int)J[7];
}

// Element `slot` of a source, clipped into it (jnp.take(mode="clip")).
__device__ __forceinline__ uint32_t take(const void* src, long long n,
                                         int esize, int32_t slot) {
  long long s = slot;
  s = s < 0 ? 0 : (s >= n ? n - 1 : s);
  if (esize == 1) return (uint32_t) reinterpret_cast<const uint8_t*>(src)[s];
  return reinterpret_cast<const uint32_t*>(src)[s];
}

struct Shared {
  // each warp's two staging sets: its part of a span of a 4-byte and of a
  // 2-byte output, each with room for a shift of 0-15 bytes (before the
  // jobs, the block stages #offsets across all of it)
  __align__(16) uint8_t stage[kWarps][2][kWarpSet];
  Job job[2][kJobChunk];
  long long wsum[kWarps];
  int32_t slot[kTile];  // an item span's slots, by position
  int32_t part[kWarps];
  long long prefix;
  unsigned ticket;
};

// Resolves the next kJobChunk descriptors when job k starts a chunk (one
// thread each, into the buffer the jobs two chunks back used); every
// thread calls it for every k.
template <int N>
__device__ __forceinline__ const Job& job_at(const Call<N>& c, Shared& sh,
                                             int first, int end, int k) {
  Job* chunk = sh.job[(k / kJobChunk) & 1];
  if (k % kJobChunk == 0) {
    if ((int)threadIdx.x < min(kJobChunk, end - first - k)) {
      load_job(c, first + k + threadIdx.x, &chunk[threadIdx.x]);
    }
    __syncthreads();
  }
  return chunk[k % kJobChunk];
}

// The jobs [first, first + n) over the span [p0, p0 + n_pos) of at most
// kTile positions. Each warp works on its own kWarpSpan positions
// q = kWarpSpan * warp + 32 * i + lane (those whose bit is set in `live`),
// each element at slot[i] of every source, with no block barrier between
// jobs: it gathers a job, stages the values in its own part of a staging
// set at the offset mod 16 of their blob bytes, and stores its part of the
// span whole; its two sets alternate between jobs. A bit-packed lane is
// staged as bits (a row span starts at a multiple of 8) or, with scratch
// (an item span), stored there one byte per position for the tail to
// pack. A reduction is folded per warp, by an atomicMax only where it is
// above what red holds already.
template <int N>
__device__ void warp_jobs(const Call<N>& c, Shared& sh, int first, int n,
                          long long p0, long long n_pos, const int32_t* slot,
                          unsigned live, int32_t* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long w0 = p0 + (long long)kWarpSpan * warp;
  const long long w_n = max(0ll, min((long long)kWarpSpan, p0 + n_pos - w0));
  for (int k = 0; k < n; ++k) {
    const Job& J = job_at(c, sh, first, first + n, k);
    const bool two = J.kind == J_SL32 || J.kind == J_START_LENC;
    uint32_t v[kPerThread], ln[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const bool on = (live >> i) & 1u;
      v[i] = on ? take(J.src, J.n, J.esize, slot[i]) : 0u;
      ln[i] = on && two ? take(J.src2, J.n2, 4, slot[i]) : 0u;
    }
    uint8_t* set = sh.stage[warp][k & 1];
    uint8_t* d = c.blob + J.at + (J.kind == J_BITS8 ? w0 / 8 : 4 * w0);
    uint8_t* d2 = c.blob + J.at2 + 2 * w0;
    uint8_t* st = set + shift_of(d);
    uint8_t* st2 = set + kWarpStage4 + shift_of(d2);
    int32_t mx = 0;  // the lane's maximum (any error for J_ERRFLAG)
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int q = 32 * i + lane;
      const bool on = (live >> i) & 1u;
      switch (J.kind) {
        case J_SL32:
          if (on) put32(st + 4 * q, v[i] | (ln[i] << 21));
          mx = max(mx, (int32_t)ln[i]);
          break;
        case J_START_LENC:
          if (on) {
            put32(st + 4 * q, v[i]);
            put16(st2 + 2 * q, ln[i]);
          }
          mx = max(mx, (int32_t)ln[i]);
          break;
        case J_COPY32:
          if (on) {
            put32(st + 4 * q, v[i]);
            if (J.scratch) {
              reinterpret_cast<int32_t*>(J.scratch)[w0 + q] = (int32_t)v[i];
            }
          }
          break;
        case J_BITS8:
          if (J.scratch) {
            if (on) J.scratch[w0 + q] = v[i] != 0u;
          } else {
            // 32 positions are 4 bytes: each lane 8k stores one
            const unsigned bits = __ballot_sync(0xFFFFFFFFu, on && v[i] != 0u);
            if ((lane & 7) == 0) st[q / 8] = (uint8_t)(bits >> lane);
          }
          break;
        default:  // J_ERRFLAG: any error bit other than ERR_ITEM_OVERFLOW
          mx |= (v[i] & ~ERR_ITEM_OVERFLOW) != 0u;
      }
    }
    if (J.red >= 0) {
      mx = __reduce_max_sync(0xFFFFFFFFu, mx);
      if (lane == 0 && mx > 0 && mx > load_max(&red[J.red])) {
        atomicMax(&red[J.red], mx);
      }
    }
    __syncwarp();
    if (J.kind == J_BITS8) {
      if (!J.scratch) store_span<32>(d, w_n / 8, set);
    } else if (J.kind != J_ERRFLAG) {
      store_span<32>(d, 4 * w_n, set);
      if (J.kind == J_START_LENC) store_span<32>(d2, 2 * w_n, set + kWarpStage4);
    }
  }
}

// A tile of the row segment: rows j0 + q, and one group of S[4] of the
// row payload's jobs and the error flag (the groups of a row tile run in
// blocks of their own).
template <int N>
__device__ void rows_tile(const Call<N>& c, const long long* S, long long t,
                          Shared& sh) {
  const long long R = S[2];
  const long long groups = (S[12] - S[11] + S[4] - 1) / S[4];
  const long long j0 = t / groups * kTile;
  int32_t slot[kPerThread];
  unsigned live = 0;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    slot[i] = (int32_t)(j0 + kWarpSpan * (threadIdx.x >> 5) + 32 * i +
                        (threadIdx.x & 31));
    live |= (unsigned)(slot[i] < R) << i;
  }
  const int first = (int)(S[11] + t % groups * S[4]);
  warp_jobs(c, sh, first, (int)min(S[4], S[12] - first), j0,
            min(j0 + kTile, R) - j0, slot, live,
            reinterpret_cast<int32_t*>(c.scratch + c.tab[10]));
}

// A tile of an item segment: kRows entries, kPerEntry per thread.
template <int N>
__device__ void items_tile(const Call<N>& c, const long long* S, long long t,
                           Shared& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long* T = c.tab;
  const int rid = (int)S[1];
  const long long n_e = S[2];
  const long long tcap = S[3];
  const uint32_t icap = (uint32_t)S[4];
  int32_t* red = reinterpret_cast<int32_t*>(c.scratch + T[10]);
  long long* totals = reinterpret_cast<long long*>(c.scratch + T[11]);
  unsigned long long* flags =
      reinterpret_cast<unsigned long long*>(c.scratch + T[12]) + S[15];
  const long long e0 = t * kRows;
  const long long eb = e0 + (long long)tid * kPerEntry;
  const bool last = t == S[14] - 1;

  // the entries' counts: a row-level region's from its count buffer, a
  // nested one's from the scratch its parent's tiles gathered them into,
  // zero past the parent's total
  const int32_t* counts;
  long long n_live = n_e;
  if (S[5] >= 0) {
    counts = static_cast<const int32_t*>(c.src[S[5]]);
  } else {
    counts = reinterpret_cast<const int32_t*>(c.scratch + S[6]);
    n_live = min(n_e, totals[S[7]]);
  }
  int32_t cnt[kPerEntry];
  long long s = 0;
  int32_t m = 0;
#pragma unroll
  for (int i = 0; i < kPerEntry; ++i) {
    cnt[i] = eb + i < n_live ? counts[eb + i] : 0;
    s += cnt[i];
    m = max(m, cnt[i]);
  }
  // the block's scan: each warp's inclusive, then the warps' sums
  long long x = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  m = __reduce_max_sync(0xFFFFFFFFu, m);
  if (lane == 31) sh.wsum[warp] = x;
  if (lane == 0) sh.part[warp] = m;
  __syncthreads();
  long long before = 0, agg = 0;  // the warps' sums before this warp; all
  int32_t bm = 0;                 // the block's largest count
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? sh.wsum[w] : 0;
    agg += sh.wsum[w];
    bm = max(bm, sh.part[w]);
  }
  if (tid == 0 && bm > 0) atomicMax(&red[rid], bm);
  if (warp == 0) {
    // the tile's prefix: its own sum published, then the predecessors'
    // words read kLookBack at a time (kLookBack / 32 per lane, all in
    // flight together), nearest first, down to an inclusive one
    long long P = 0;
    if (t == 0) {
      if (lane == 0) store_word(&flags[0], (unsigned long long)agg << 2 |
                                               kInclusive);
    } else {
      if (lane == 0) store_word(&flags[t], (unsigned long long)agg << 2 |
                                               kAggregate);
      long long k = t - 1;
      for (;;) {
        unsigned long long w[kLookBack / 32];
#pragma unroll
        for (int r = 0; r < kLookBack / 32; ++r) {
          const long long i = k - (32 * r + lane);
          w[r] = i >= 0 ? load_word(&flags[i]) : kInclusive;
        }
        // the nearest inclusive word, and any unpublished one before it
        int stop = kLookBack;
        bool wait = false;
#pragma unroll
        for (int r = kLookBack / 32 - 1; r >= 0; --r) {
          const unsigned incl =
              __ballot_sync(0xFFFFFFFFu, (w[r] & 3) == kInclusive);
          if (incl) stop = 32 * r + __ffs(incl) - 1;
        }
#pragma unroll
        for (int r = 0; r < kLookBack / 32; ++r) {
          wait = wait || __any_sync(0xFFFFFFFFu, (w[r] & 3) == 0 &&
                                                     32 * r + lane <= stop);
        }
        if (wait) continue;  // a predecessor has not published
        long long v = 0;
#pragma unroll
        for (int r = 0; r < kLookBack / 32; ++r) {
          v += 32 * r + lane <= stop ? (long long)(w[r] >> 2) : 0;
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
        }
        P += v;
        if (stop < kLookBack) break;
        k -= kLookBack;
      }
      if (lane == 0) store_word(&flags[t], (unsigned long long)(P + agg)
                                               << 2 | kInclusive);
    }
    if (lane == 0) {
      sh.prefix = P;
      if (last) totals[rid] = P + agg;
    }
  }
  __syncthreads();
  const long long P = sh.prefix;
  // the thread's entries: their first positions
  long long lo[kPerEntry];
  lo[0] = P + before + x - s;
#pragma unroll
  for (int i = 1; i < kPerEntry; ++i) lo[i] = lo[i - 1] + cnt[i - 1];

  // #offsets: the tile's entries, and the last tile's closing entry
  {
    const long long e_end = min(e0 + kRows, n_e) + (last ? 1 : 0);
    uint8_t* d = c.blob + S[10] + 4 * e0;
    uint8_t* flat = &sh.stage[0][0][0];
    uint8_t* st = flat + shift_of(d);
#pragma unroll
    for (int i = 0; i < kPerEntry; ++i) {
      if (eb + i < n_e) put32(st + 4 * (eb + i - e0), (uint32_t)lo[i]);
    }
    if (last && tid == 0) put32(st + 4 * (n_e - e0), (uint32_t)(P + agg));
    __syncthreads();
    store_span<kThreads>(d, 4 * (e_end - e0), flat);
  }

  // the entries' items: positions [P, P + agg) below tot_cap, a span of
  // kTile positions at a time. Each entry writes its items' slots into
  // the span's slot table (no position searches for its entry); then
  // every job gathers the span position by position (warp_jobs), as a
  // row tile does.
  const long long span_end = min(P + agg, tcap);
  uint32_t ps[kPerEntry];
  const int32_t* pslot =
      S[8] >= 0 ? reinterpret_cast<const int32_t*>(c.scratch + S[8]) : nullptr;
#pragma unroll
  for (int i = 0; i < kPerEntry; ++i) {
    ps[i] = (uint32_t)(eb + i);
    if (pslot && cnt[i] > 0 && lo[i] < span_end) ps[i] = (uint32_t)pslot[eb + i];
  }
  int32_t* slot_out =
      S[9] >= 0 ? reinterpret_cast<int32_t*>(c.scratch + S[9]) : nullptr;
  for (long long c0 = P; c0 < span_end; c0 += kTile) {
    const long long c1 = min(c0 + kTile, span_end);
    __syncthreads();  // #offsets' staging, the last span's slots are read
#pragma unroll
    for (int i = 0; i < kPerEntry; ++i) {
      const long long a = max(lo[i], c0);
      const long long b = min(lo[i] + cnt[i], c1);
      for (long long j = a; j < b; ++j) {
        sh.slot[j - c0] = (int32_t)(ps[i] * icap + (uint32_t)(j - lo[i]));
      }
    }
    __syncthreads();
    unsigned live = 0;
    int32_t slot[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int q = kWarpSpan * warp + 32 * i + lane;
      live |= (unsigned)(c0 + q < c1) << i;
      slot[i] = (live >> i) & 1u ? sh.slot[q] : 0;
      // this region's slot map, for its children's tiles
      if (slot_out && ((live >> i) & 1u)) slot_out[c0 + q] = slot[i];
    }
    warp_jobs(c, sh, (int)S[11], (int)(S[12] - S[11]), c0, c1 - c0, slot,
              live, red);
  }
}

// Levels' tiles: a ticket picks the segment and its tile.
template <int N>
__global__ void __launch_bounds__(kThreads, 4)
    finalize_tiles_kernel(const __grid_constant__ Call<N> c) {
  __shared__ Shared sh;
  if (threadIdx.x == 0) {
    unsigned* tickets = reinterpret_cast<unsigned*>(c.scratch + c.tab[13]);
    sh.ticket = atomicAdd(&tickets[c.level], 1u);
  }
  __syncthreads();
  const long long ticket = sh.ticket;
  for (int s = c.seg_first; s < c.seg_end; ++s) {
    const long long* S = c.tab + c.tab[1] + (size_t)s * kSegWords;
    if (ticket >= S[13] && ticket < S[13] + S[14]) {
      if (S[0] == SEG_ROWS) {
        rows_tile(c, S, ticket - S[13], sh);
      } else {
        items_tile(c, S, ticket - S[13], sh);
      }
      return;
    }
  }
}

// After every level: item fields zeroed past their region's total, the
// bit-packed item lanes packed, a chunk of kTile positions per step; then
// block 0 writes the reductions and the status bytes and resets the
// scratch's counters for the next run.
template <int N>
__global__ void __launch_bounds__(kThreads)
    finalize_tail_kernel(const __grid_constant__ Call<N> c) {
  const long long* T = c.tab;
  const int tid = threadIdx.x;
  int32_t* red = reinterpret_cast<int32_t*>(c.scratch + T[10]);
  const long long* totals = reinterpret_cast<const long long*>(c.scratch + T[11]);
  for (long long g = blockIdx.x; g < T[8]; g += gridDim.x) {
    const long long* S = nullptr;
    for (int s = 0; s < (int)T[0]; ++s) {
      const long long* X = T + T[1] + (size_t)s * kSegWords;
      if (X[0] == SEG_ITEMS && g >= X[16] && g < X[16] + X[17]) S = X;
    }
    const long long c0 = (g - S[16]) * kTile;
    const long long c1 = min(c0 + kTile, S[3]);
    const long long total = totals[S[1]];
    const long long z0 = max(c0, min(total, c1));
    for (int k = (int)S[11]; k < (int)S[12]; ++k) {
      const long long* J = T + T[2] + (size_t)k * kJobWords;
      const int kind = (int)J[0];
      if (kind == J_BITS8) {
        const uint8_t* lane = c.scratch + J[5];
        for (long long b = c0 / 8 + tid; b < c1 / 8; b += kThreads) {
          uint32_t bits = 0;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const long long j = 8 * b + q;
            bits |= (uint32_t)(j < total && lane[j] != 0) << q;
          }
          c.blob[J[3] + b] = (uint8_t)bits;
        }
      } else {
        zero_span(c.blob + J[3] + 4 * z0, 4 * (c1 - z0));
        if (kind == J_START_LENC) zero_span(c.blob + J[4] + 2 * z0, 2 * (c1 - z0));
      }
    }
  }
  if (blockIdx.x != 0) return;
  // one thread per entry; the status entry reads every region's total
  for (int i = tid; i < (int)T[4]; i += kThreads) {
    const long long* E = T + T[3] + (size_t)i * kEntryWords;
    uint8_t* at = c.blob + E[1];
    switch ((int)E[0]) {
      case E_MAX:
        store32(at, (uint32_t)red[E[2]]);
        break;
      case E_SUM:
        store32(at, (uint32_t)totals[E[2]]);
        break;
      case E_ERR:
        *at = red[E[2]] != 0;
        break;
      case E_STRFIT: {
        bool fit = true;
        for (long long k = 0; k < E[3]; ++k) fit = fit && red[E[2] + k] < E[4];
        *at = fit;
        break;
      }
      default: {  // E_STATUS
        bool wide = false;
        for (long long r = 1; r < E[2]; ++r) wide = wide || totals[r] >= (1ll << 31);
        for (int k = 0; k < kStatusBytes; ++k) at[k] = k == 0 ? wide : 0;
        break;
      }
    }
  }
  __syncthreads();
  for (long long i = tid; i < T[6]; i += kThreads) red[i] = 0;
  unsigned long long* flags = reinterpret_cast<unsigned long long*>(c.scratch + T[12]);
  for (long long i = tid; i < T[7]; i += kThreads) flags[i] = 0;
  unsigned* tickets = reinterpret_cast<unsigned*>(c.scratch + T[13]);
  for (long long i = tid; i < T[9]; i += kThreads) tickets[i] = 0;
}

// Records a timing event (a cudaEvent_t, or null for none) on `s`.
int record_event(void* ev, cudaStream_t s) {
  return ev ? (int)cudaEventRecord(static_cast<cudaEvent_t>(ev), s) : 0;
}

template <int N>
int run(const long long* tab, const long long* plan, uint8_t* scratch,
        uint8_t* blob, const long long* srcs, int n_src, cudaStream_t s,
        void* ev0, void* ev1) {
  Call<N> c;
  c.tab = tab;
  c.scratch = scratch;
  c.blob = blob;
  c.n_src = n_src;
  for (int i = 0; i < n_src; ++i) {
    c.src[i] = reinterpret_cast<const void*>(srcs[i]);
  }
  int rc = record_event(ev0, s);
  if (rc != 0) return rc;
  const int n_lvl = (int)plan[0];
  for (int L = 0; L < n_lvl; ++L) {
    const long long* P = plan + 2 + 3 * L;
    c.seg_first = (int)P[0];
    c.seg_end = (int)P[1];
    c.level = L;
    finalize_tiles_kernel<N><<<(unsigned)P[2], kThreads, 0, s>>>(c);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  finalize_tail_kernel<N><<<(unsigned)plan[1], kThreads, 0, s>>>(c);
  rc = (int)cudaGetLastError();
  return rc != 0 ? rc : record_event(ev1, s);
}

}  // namespace

// One finalize on `stream`: every level's tiles, then the tail. `tab` is
// the rung's table on the card, `plan` its launch plan on the host
// ([levels, tail blocks, then per level first segment, end, blocks]),
// `srcs` the n_src sources' pointers on the host. ev0 and ev1 (cudaEvent_t
// or null) are recorded right before the first launch and right after the
// last. Returns a CUDA error code (0 = launched).
extern "C" int decode_finalize_run(const void* tab, const void* plan,
                                   void* scratch, void* blob,
                                   const void* srcs, int n_src, void* stream,
                                   void* ev0, void* ev1) {
  const long long* p = static_cast<const long long*>(plan);
  if (n_src < 1 || n_src > kSrcMax || p[0] < 1 || p[1] < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long* t = static_cast<const long long*>(tab);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  uint8_t* b = static_cast<uint8_t*>(blob);
  const long long* s = static_cast<const long long*>(srcs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_src <= kSrcSmall) {
    return run<kSrcSmall>(t, p, sc, b, s, n_src, st, ev0, ev1);
  }
  return run<kSrcMax>(t, p, sc, b, s, n_src, st, ev0, ev1);
}
