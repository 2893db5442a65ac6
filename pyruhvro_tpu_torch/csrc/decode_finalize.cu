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
// the wrapper (FinalizePlan) holds the blob layout and hands this kernel a
// table of jobs per pass, so one build serves every schema.
//
// Passes, in stream order, each one launch of decode_finalize_pass:
// - the row pass (position = row): the row-region payload into the blob,
//   the max of each row-level region's counts, the error flag;
// - one pass per item region, parents first (region ids are in DFS
//   order), after the wrapper's torch.cumsum of the region's counts into
//   int64 offsets (the reference's jnp.cumsum; no kernel of its own): each
//   dense position j < tot_cap finds its entry, the largest i
//   with offsets[i] <= j, by binary search (the same answer as row_of, also
//   when empty entries share an offset), computes slot = parent_slot[ent]
//   * icap + j - offsets[ent] in wrapping int32, gathers every buffer of
//   the region at that slot (clipped, as jnp.take(mode="clip")) or writes 0
//   for j >= the region's total, and writes #offsets itself. A child
//   region's counts are gathered here (they are buffers of this region),
//   into an aligned scratch that the child's cumsum reads, and this
//   region's slot map is kept for the child's pass.
// Then decode_finalize_epilogue writes #red:max/#red:sum/#red:err/
// #red:strfit and the status bytes after the blob (byte 0: a region's
// total reached 2^31, which int32 #offsets cannot hold). Every byte of the
// blob is written by exactly one of them; the blob is torch.empty.
//
// Bound on an H100 SXM: memory. The passes must read each gathered
// element once and write the blob once: (those bytes) / 3.35 TB/s. The
// blob's key order (the reference's) leaves fields at any byte offset
// (on the Kafka schema every 4-byte field starts at 2 mod 4), so a store
// per element would go out byte by byte. Instead each block owns a tile
// of kTile positions (kPerThread per thread, position j0 + i * kThreads
// + tid, so a warp's gathers are neighbours) and, job after job, gathers
// the tile's values into shared memory at the same offset mod 16 as the
// field's bytes in the blob, then stores the tile's byte span whole:
// 16-byte words over its aligned middle, single bytes over its head and
// tail (as encode_rows' staged spans in csrc/encode.cu). No 16-byte word
// crosses the span, so every blob byte is still written by one thread.
// Two staging sets alternate between jobs, and the job descriptors (with
// their sources' pointers and lengths) are resolved into shared memory
// kJobChunk at a time, one thread each, so a job costs one barrier and no
// thread waits on a descriptor's dependent loads per job. A reducing job
// takes each thread's maximum over its positions, the warp's by
// __reduce_max_sync, the block's from shared memory, and folds it into
// red with one atomicMax per block and job, only where it is above 0
// (red starts at 0 and only grows, so nothing else can change it).

#include <cstdint>
#include <cuda_runtime.h>

#define ERR_ITEM_OVERFLOW 128u

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // positions of one block
constexpr int kWarps = kThreads / 32;
// one staging set: a tile of a 4-byte output and of a 2-byte output,
// each with room for a shift of 0-15 bytes
constexpr int kStage4 = 4 * kTile + 16;
constexpr int kStage2 = 2 * kTile + 16;
constexpr int kSetBytes = kStage4 + kStage2;
constexpr int kJobChunk = 32;  // job descriptors a block resolves at once

// job kinds: keep in step with ops/decode.py (J_*)
enum { J_COPY32, J_BITS8, J_SL32, J_START_LENC, J_REDUCE, J_ERRFLAG };
// epilogue entries: keep in step with ops/decode.py (E_*)
enum { E_MAX, E_SUM, E_ERR, E_STRFIT, E_STATUS };
constexpr int kJobWords = 8;    // kind src src2 at at2 scratch red esize
constexpr int kEntryWords = 5;  // kind at a b c
constexpr int kStatusBytes = 8;

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

// The block stores the staged span [d, d + n): bytes over the head up to
// the first 16-byte boundary and over the tail after the last, 16-byte
// words between. `st` holds byte k at st + shift_of(d) + k.
__device__ __forceinline__ void store_span(uint8_t* d, long long n,
                                           const uint8_t* st) {
  if (n <= 0) return;
  const uint8_t* s = st + shift_of(d);
  const long long a = min((long long)((16 - shift_of(d)) & 15), n);
  const long long b = a + ((n - a) & ~15ll);
  const int tid = threadIdx.x;
  if (tid < a) d[tid] = s[tid];
  if (tid < n - b) d[b + tid] = s[b + tid];
  for (long long k = a + 16 * tid; k < b; k += 16 * kThreads) {
    *reinterpret_cast<uint4*>(d + k) = *reinterpret_cast<const uint4*>(s + k);
  }
}

struct Pass {
  const long long* offsets;     // [n_entries + 1] int64, or null (row pass)
  const int32_t* parent_slot;   // [n_entries], or null (identity)
  int n_entries;
  int icap;
  int n_pos;
  int32_t* slot_out;            // [n_pos] or null
  const long long* jobs;
  int n_jobs;
  const long long* src_ptrs;
  const long long* src_lens;
  uint8_t* blob;
  long long offsets_at;         // byte offset of #offsets in the blob
  int32_t* red;
};

// One job with its sources resolved, as a block keeps it in shared memory.
struct Job {
  const void* src;
  long long n;
  const void* src2;  // J_SL32 / J_START_LENC: the lengths
  long long n2;
  long long at, at2;
  int32_t* scratch;  // J_COPY32: the child region's counts, or null
  int kind, red, esize;
};

__device__ __forceinline__ void load_job(const Pass& P, int k, Job* out) {
  const long long* J = P.jobs + (size_t)k * kJobWords;
  const int src = (int)J[1];
  const int src2 = (int)J[2];
  out->kind = (int)J[0];
  out->src = reinterpret_cast<const void*>(P.src_ptrs[src]);
  out->n = P.src_lens[src];
  out->src2 = src2 >= 0 ? reinterpret_cast<const void*>(P.src_ptrs[src2])
                        : nullptr;
  out->n2 = src2 >= 0 ? P.src_lens[src2] : 0;
  out->at = J[3];
  out->at2 = J[4];
  out->scratch = reinterpret_cast<int32_t*>(J[5]);
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

__global__ void __launch_bounds__(kThreads, 4) finalize_pass_kernel(Pass P) {
  __shared__ __align__(16) uint8_t s_stage[2][kSetBytes];
  __shared__ Job s_job[2][kJobChunk];
  __shared__ int32_t s_part[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long j0 = (long long)blockIdx.x * kTile;
  const long long j_end = min(j0 + kTile, (long long)P.n_pos);
  const bool item = P.offsets != nullptr;

  // the thread's positions j0 + i * kThreads + tid: live below n_pos, in
  // range below the region's total; their slots
  unsigned live = 0, in_range = 0;
  int32_t slot[kPerThread];
  const long long total = item ? P.offsets[P.n_entries] : (long long)P.n_pos;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long j = j0 + i * kThreads + tid;
    live |= (unsigned)(j < P.n_pos) << i;
    in_range |= (unsigned)(j < P.n_pos && j < total) << i;
    slot[i] = (int32_t)j;
  }
  if (item) {
    // per position, the largest entry e with offsets[e] <= j, all of the
    // thread's searches stepping together
    int lo[kPerThread], hi[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      lo[i] = 0;
      hi[i] = (live >> i) & 1u ? P.n_entries - 1 : 0;
    }
    for (bool more = true; more;) {
      more = false;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        if (lo[i] < hi[i]) {
          const int mid = (lo[i] + hi[i] + 1) >> 1;
          if (P.offsets[mid] <= j0 + i * kThreads + tid) lo[i] = mid;
          else hi[i] = mid - 1;
          more = more || lo[i] < hi[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if ((live >> i) & 1u) {
        const long long j = j0 + i * kThreads + tid;
        const int32_t ps = P.parent_slot ? P.parent_slot[lo[i]] : lo[i];
        slot[i] = (int32_t)((uint32_t)ps * (uint32_t)P.icap +
                            ((uint32_t)j - (uint32_t)P.offsets[lo[i]]));
        if (P.slot_out) P.slot_out[j] = slot[i];
      }
    }
    // this block's entries of #offsets, through the second staging set
    const long long e_end = min(j0 + kTile, (long long)P.n_entries + 1);
    uint8_t* d = P.blob + P.offsets_at + 4 * j0;
    uint8_t* st = s_stage[1] + shift_of(d);
    uint32_t o[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const long long e = j0 + i * kThreads + tid;
      o[i] = e < e_end ? (uint32_t)P.offsets[e] : 0u;
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (j0 + i * kThreads + tid < e_end) {
        put32(st + 4 * (i * kThreads + tid), o[i]);
      }
    }
    __syncthreads();
    store_span(d, 4 * (e_end - j0), s_stage[1]);
  }

  for (int k = 0; k < P.n_jobs; ++k) {
    // the next kJobChunk descriptors, one thread each, into the chunk
    // buffer that the jobs two chunks back used
    Job* chunk = s_job[(k / kJobChunk) & 1];
    if (k % kJobChunk == 0) {
      if (tid < min(kJobChunk, P.n_jobs - k)) {
        load_job(P, k + tid, &chunk[tid]);
      }
      __syncthreads();
    }
    const Job& J = chunk[k % kJobChunk];
    uint8_t* set = s_stage[k & 1];
    uint8_t* d = P.blob + J.at + (J.kind == J_BITS8 ? j0 / 8 : 4 * j0);
    uint8_t* d2 = P.blob + J.at2 + 2 * j0;
    int32_t m = 0;  // the thread's maximum (any error for J_ERRFLAG)
    uint32_t v[kPerThread];
    const bool two = J.kind == J_SL32 || J.kind == J_START_LENC;
    const unsigned gate = J.kind == J_REDUCE || J.kind == J_ERRFLAG ? live
                                                                    : in_range;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      v[i] = (gate >> i) & 1u ? take(J.src, J.n, J.esize, slot[i]) : 0u;
    }
    if (two) {
      uint32_t ln[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        ln[i] = (in_range >> i) & 1u ? take(J.src2, J.n2, 4, slot[i]) : 0u;
      }
      uint8_t* st = set + shift_of(d);
      uint8_t* st2 = set + kStage4 + shift_of(d2);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int t = i * kThreads + tid;
        if ((live >> i) & 1u) {
          m = max(m, (int32_t)ln[i]);
          if (J.kind == J_SL32) {
            put32(st + 4 * t, v[i] | (ln[i] << 21));
          } else {
            put32(st + 4 * t, v[i]);
            put16(st2 + 2 * t, ln[i]);
          }
        }
      }
    } else if (J.kind == J_COPY32) {
      uint8_t* st = set + shift_of(d);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        if ((live >> i) & 1u) {
          m = max(m, (int32_t)v[i]);
          put32(st + 4 * (i * kThreads + tid), v[i]);
          if (J.scratch) J.scratch[j0 + i * kThreads + tid] = (int32_t)v[i];
        }
      }
    } else if (J.kind == J_BITS8) {
      // 32 positions of a warp are 4 bytes: each lane 8k stores one
      uint8_t* st = set + shift_of(d);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const unsigned bits =
            __ballot_sync(0xFFFFFFFFu, ((live >> i) & 1u) && v[i] != 0u);
        if ((lane & 7) == 0) {
          st[(i * kThreads + tid) / 8] = (uint8_t)(bits >> lane);
        }
      }
    } else if (J.kind == J_REDUCE) {
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) m = max(m, (int32_t)v[i]);
    } else {  // J_ERRFLAG: any error bit other than ERR_ITEM_OVERFLOW
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        m |= (v[i] & ~ERR_ITEM_OVERFLOW) != 0u;
      }
    }
    if (J.red >= 0) {
      m = __reduce_max_sync(0xFFFFFFFFu, m);
      if (lane == 0) s_part[k & 1][warp] = m;
    }
    __syncthreads();
    if (J.kind == J_BITS8) {
      store_span(d, (j_end - j0) / 8, set);
    } else if (J.kind != J_REDUCE && J.kind != J_ERRFLAG) {
      store_span(d, 4 * (j_end - j0), set);
      if (J.kind == J_START_LENC) {
        store_span(d2, 2 * (j_end - j0), set + kStage4);
      }
    }
    if (tid == 0 && J.red >= 0) {
      int32_t b = 0;
      for (int w = 0; w < kWarps; ++w) b = max(b, s_part[k & 1][w]);
      if (b > 0) atomicMax(&P.red[J.red], b);
    }
  }
}

// One thread per entry; the status entry reads every E_SUM entry's total.
__global__ void finalize_epilogue_kernel(const long long* entries, int n,
                                         uint8_t* blob, const int32_t* red) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long* E = entries + (size_t)i * kEntryWords;
  uint8_t* at = blob + E[1];
  switch ((int)E[0]) {
    case E_MAX:
      store32(at, (uint32_t)red[E[2]]);
      break;
    case E_SUM: {
      const long long* off = reinterpret_cast<const long long*>(E[2]);
      store32(at, (uint32_t)off[E[3]]);
      break;
    }
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
      for (int k = 0; k < n; ++k) {
        const long long* S = entries + (size_t)k * kEntryWords;
        if (S[0] == E_SUM) {
          wide = wide ||
                 reinterpret_cast<const long long*>(S[2])[S[3]] >= (1ll << 31);
        }
      }
      for (int k = 0; k < kStatusBytes; ++k) at[k] = k == 0 ? wide : 0;
      break;
    }
  }
}

}  // namespace

// One gather pass on `stream`; returns a CUDA error code (0 = launched).
// offsets null: the row pass over n_pos = R rows, slot = position.
extern "C" int decode_finalize_pass(const void* offsets,
                                    const void* parent_slot, int n_entries,
                                    int icap, int n_pos, void* slot_out,
                                    const void* jobs, int n_jobs,
                                    const void* src_ptrs, const void* src_lens,
                                    void* blob, long long offsets_at,
                                    void* red, void* stream) {
  if (n_pos < 0 || n_entries < 0 || (offsets && n_entries < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Pass p;
  p.offsets = static_cast<const long long*>(offsets);
  p.parent_slot = static_cast<const int32_t*>(parent_slot);
  p.n_entries = n_entries;
  p.icap = icap;
  p.n_pos = n_pos;
  p.slot_out = static_cast<int32_t*>(slot_out);
  p.jobs = static_cast<const long long*>(jobs);
  p.n_jobs = n_jobs;
  p.src_ptrs = static_cast<const long long*>(src_ptrs);
  p.src_lens = static_cast<const long long*>(src_lens);
  p.blob = static_cast<uint8_t*>(blob);
  p.offsets_at = offsets_at;
  p.red = static_cast<int32_t*>(red);
  const long long work =
      offsets ? (long long)max(n_pos, n_entries + 1) : (long long)n_pos;
  const long long blocks = (work + kTile - 1) / kTile;
  if (blocks == 0) return 0;
  finalize_pass_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The reductions and the status bytes, on `stream`, after every pass.
extern "C" int decode_finalize_epilogue(const void* entries, int n, void* blob,
                                        const void* red, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  finalize_epilogue_kernel<<<(n + 127) / 128, 128, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(entries), n, static_cast<uint8_t*>(blob),
      static_cast<const int32_t*>(red));
  return (int)cudaGetLastError();
}
