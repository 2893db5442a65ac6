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
// - the row pass (one thread per row): the row-region payload into the
//   blob, the max of each row-level region's counts, the error flag;
// - one pass per item region, parents first (region ids are in DFS
//   order), after the wrapper's torch.cumsum of the region's counts into
//   int64 offsets (the reference's jnp.cumsum; no kernel of its own): one
//   thread per dense position j < tot_cap finds its entry, the largest i
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
// blob's key order (the reference's) leaves fields at any byte offset, so
// a field whose offset is a multiple of its width is stored whole, others
// byte by byte; u8 lanes are packed by a warp ballot (32 positions to 4
// bytes); maxima are reduced within the warp before one atomic per warp.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define ERR_ITEM_OVERFLOW 128u

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ void store16(uint8_t* p, uint32_t v) {
  if ((reinterpret_cast<uintptr_t>(p) & 1u) == 0) {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)v;
  } else {
    p[0] = (uint8_t)v;
    p[1] = (uint8_t)(v >> 8);
  }
}

// The warp's max of v (every lane calls it); lane 0 folds it into *red.
__device__ __forceinline__ void warp_max(int32_t* red, int32_t v) {
  const int32_t m = __reduce_max_sync(0xFFFFFFFFu, v);
  if ((threadIdx.x & 31) == 0) atomicMax(red, m);
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

__device__ __forceinline__ uint32_t gather(const Pass& P, int src, int esize,
                                           int32_t slot, bool in_range) {
  if (!in_range) return 0u;
  const long long n = P.src_lens[src];
  long long s = slot;
  s = s < 0 ? 0 : (s >= n ? n - 1 : s);
  if (esize == 1) {
    return (uint32_t)reinterpret_cast<const uint8_t*>(P.src_ptrs[src])[s];
  }
  return reinterpret_cast<const uint32_t*>(P.src_ptrs[src])[s];
}

__global__ void __launch_bounds__(kThreads) finalize_pass_kernel(Pass P) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool item = P.offsets != nullptr;
  if (item && j <= P.n_entries) {
    store32(P.blob + P.offsets_at + 4 * j, (uint32_t)P.offsets[j]);
  }
  const bool pos = j < P.n_pos;
  int32_t slot = (int32_t)j;
  bool in_range = pos;
  if (item && pos) {
    in_range = j < P.offsets[P.n_entries];
    int lo = 0, hi = P.n_entries - 1;  // largest i with offsets[i] <= j
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (P.offsets[mid] <= j) lo = mid; else hi = mid - 1;
    }
    const int32_t ps = P.parent_slot ? P.parent_slot[lo] : lo;
    slot = (int32_t)((uint32_t)ps * (uint32_t)P.icap +
                     ((uint32_t)j - (uint32_t)P.offsets[lo]));
    if (P.slot_out) P.slot_out[j] = slot;
  }
  for (int k = 0; k < P.n_jobs; ++k) {
    const long long* J = P.jobs + (size_t)k * kJobWords;
    const int kind = (int)J[0];
    const int src = (int)J[1];
    const int red = (int)J[6];
    const int esize = (int)J[7];
    switch (kind) {
      case J_COPY32: {
        const uint32_t v = gather(P, src, 4, slot, in_range);
        if (pos) {
          store32(P.blob + J[3] + 4 * j, v);
          if (J[5]) reinterpret_cast<int32_t*>(J[5])[j] = (int32_t)v;
        }
        if (red >= 0) warp_max(&P.red[red], pos ? (int32_t)v : 0);
        break;
      }
      case J_BITS8: {
        const uint32_t v = gather(P, src, 1, slot, in_range);
        const unsigned bits = __ballot_sync(0xFFFFFFFFu, pos && v != 0u);
        const int lane = threadIdx.x & 31;
        if (pos && (lane & 7) == 0) {
          P.blob[J[3] + j / 8] = (uint8_t)(bits >> lane);
        }
        break;
      }
      case J_SL32:
      case J_START_LENC: {
        const uint32_t s = gather(P, src, 4, slot, in_range);
        const uint32_t ln = gather(P, (int)J[2], 4, slot, in_range);
        if (pos) {
          if (kind == J_SL32) {
            store32(P.blob + J[3] + 4 * j, s | (ln << 21));
          } else {
            store32(P.blob + J[3] + 4 * j, s);
            store16(P.blob + J[4] + 2 * j, ln);
          }
        }
        warp_max(&P.red[red], pos ? (int32_t)ln : 0);
        break;
      }
      case J_REDUCE: {
        const int32_t v = pos ? (int32_t)gather(P, src, esize, slot, true) : 0;
        warp_max(&P.red[red], v);
        break;
      }
      default: {  // J_ERRFLAG: any error bit other than ERR_ITEM_OVERFLOW
        const uint32_t v = pos ? gather(P, src, 4, slot, true) : 0u;
        const bool bad = (v & ~ERR_ITEM_OVERFLOW) != 0u;
        if (__any_sync(0xFFFFFFFFu, bad) && (threadIdx.x & 31) == 0) {
          atomicMax(&P.red[red], 1);
        }
        break;
      }
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
  const long long blocks = (work + kThreads - 1) / kThreads;
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
