// encode.cu — the encode program (K3) on Hopper: Arrow lanes → Avro wire
// bytes, one thread per row, then one thread per payload element.
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
// encode_rows: one thread per row walks the code with the row's values.
// A value op reads its lane at the current index: the row, or the item of
// the innermost open array/map loop (a stack of (item, end, pc)). The wire
// form is canonical, so a walk over the live values only writes what the
// reference's masked vector passes write: minimal zig-zag varints, float
// and double bit patterns as they are, branch indices, decimals big-endian
// with the sign fill past byte 16, and single-block arrays/maps
// [count, items..., 0] or a bare 0. Size mode (write = 0) stores each
// row's byte count (0 for lanes at or past n); write mode stores every
// byte at start = cum[row] - row_sizes[row] and records each payload's
// position in its #dst lane. Payload bytes are left to encode_strings.
//
// encode_strings copies each payload element (string, bytes, uuid text,
// fixed, duration, map key) from #bytes at #src to out at #dst, in one of
// two modes the wrapper picks from the launch's mean payload-lane size:
// - short payloads (the Kafka batch: 5.8 bytes a lane): one thread per
//   element, so 31 lanes of a warp do not idle; a payload of 32 bytes or
//   more is copied by its whole warp together (ballot, then one after
//   another, 32 neighbouring bytes a step);
// - long payloads (records of 4-16 KiB): one warp per element, since a
//   warp that copies its long payloads one after another leaves the card
//   idle.
// chip_smoke.py times both modes in turns on a batch of each kind.
//
// Bound on an H100 SXM: memory. The program must read the lanes once and
// write the total output bytes and the row sizes once: (those bytes) /
// 3.35 TB/s. This first design is simple: the code and lane table sit in
// shared memory, lanes are read through the read-only cache (a warp's
// rows read neighbouring lane elements), and each thread stores its row's
// bytes one at a time, so stores are not coalesced; the row walk runs
// twice (size, then write) around the row-start cumsum.

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

constexpr int kThreads = 128;
constexpr int kMaxDepth = 16;       // open loops a row keeps
constexpr int kColWords = 6;        // src len bytes dst lanes, n_el, base
constexpr int kStringThreads = 256;
constexpr int kWarpCopy = 32;       // payloads copied by a whole warp

struct Loop {
  int32_t i;    // current item
  int32_t end;  // one past the last item
  int32_t pc;   // the REPEATED op
};

struct RowWalk {
  const uint8_t* base;
  const long long* lanes;   // shared: byte offset of each lane
  uint8_t* out;             // null in size mode
  uint32_t start;           // the row's first output byte
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
            dst[idx] = (int32_t)(start + pos);
          }
          pos += (uint32_t)len;
          pc += 3;
          break;
        }
        case OP_PAYLOAD:
          if (WRITE) {
            int32_t* dst = reinterpret_cast<int32_t*>(
                const_cast<uint8_t*>(base) + lanes[code[pc + 2]]);
            dst[idx] = (int32_t)(start + pos);
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

__global__ void __launch_bounds__(kThreads)
encode_rows_kernel(const uint8_t* base, const int32_t* code, int code_len,
                   const long long* lanes, int n_lanes, int n, int R,
                   int write, const int32_t* cum, int32_t* row_sizes,
                   uint8_t* out) {
  extern __shared__ long long smem[];
  long long* s_lanes = smem;
  int32_t* s_code = reinterpret_cast<int32_t*>(smem + n_lanes);
  for (int k = threadIdx.x; k < n_lanes; k += blockDim.x)
    s_lanes[k] = lanes[k];
  for (int k = threadIdx.x; k < code_len; k += blockDim.x)
    s_code[k] = code[k];
  __syncthreads();
  const int32_t row = (int32_t)(blockIdx.x * blockDim.x + threadIdx.x);
  if (row >= R) return;
  RowWalk w;
  w.base = base;
  w.lanes = s_lanes;
  w.pos = 0;
  if (!write) {
    w.out = nullptr;
    w.start = 0;
    if (row < n) w.run<false>(s_code, row);
    row_sizes[row] = (int32_t)w.pos;
    return;
  }
  if (row >= n) return;
  w.out = out;
  w.start = (uint32_t)(cum[row] - row_sizes[row]);
  w.run<true>(s_code, row);
}

__global__ void __launch_bounds__(kStringThreads)
encode_strings_kernel(const uint8_t* base, const long long* lanes,
                      int n_lanes, const int32_t* cols, int n_cols,
                      long long n_elems, int per_warp, uint8_t* out) {
  extern __shared__ long long smem[];
  long long* s_lanes = smem;
  int32_t* s_cols = reinterpret_cast<int32_t*>(smem + n_lanes);
  for (int k = threadIdx.x; k < n_lanes; k += blockDim.x)
    s_lanes[k] = lanes[k];
  for (int k = threadIdx.x; k < n_cols * kColWords; k += blockDim.x)
    s_cols[k] = cols[k];
  __syncthreads();
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long e = per_warp ? t >> 5 : t;
  const int lane = threadIdx.x & 31;
  const uint8_t* from = nullptr;
  uint8_t* to = nullptr;
  int32_t len = 0;
  if (e < n_elems) {
    int c = 0;
    while (c + 1 < n_cols &&
           (long long)s_cols[(c + 1) * kColWords + 5] <= e)
      ++c;
    const int32_t* col = s_cols + c * kColWords;
    const int32_t j = (int32_t)(e - col[5]);
    const int32_t d =
        reinterpret_cast<const int32_t*>(base + s_lanes[col[3]])[j];
    if (d >= 0) {
      const int32_t src = __ldg(
          reinterpret_cast<const int32_t*>(base + s_lanes[col[0]]) + j);
      len = __ldg(reinterpret_cast<const int32_t*>(base + s_lanes[col[1]]) +
                  j);
      from = base + s_lanes[col[2]] + src;
      to = out + d;
    }
  }
  if (per_warp) {
    // every lane of the warp holds the same element
    for (int32_t k = lane; k < len; k += 32) to[k] = __ldg(from + k);
    return;
  }
  // a short payload: its own thread copies it
  if (len < kWarpCopy) {
    for (int32_t k = 0; k < len; ++k) to[k] = __ldg(from + k);
  }
  // a long one: the whole warp copies it, 32 neighbouring bytes a step
  unsigned long_lanes = __ballot_sync(0xFFFFFFFFu, len >= kWarpCopy);
  while (long_lanes) {
    const int src_lane = __ffs(long_lanes) - 1;
    long_lanes &= long_lanes - 1;
    const unsigned long long f = __shfl_sync(
        0xFFFFFFFFu, (unsigned long long)from, src_lane);
    const unsigned long long t = __shfl_sync(
        0xFFFFFFFFu, (unsigned long long)to, src_lane);
    const int32_t n = __shfl_sync(0xFFFFFFFFu, len, src_lane);
    const uint8_t* wf = reinterpret_cast<const uint8_t*>(f);
    uint8_t* wt = reinterpret_cast<uint8_t*>(t);
    // four loads in flight per lane before their stores
    for (int32_t k = lane; k < n; k += 4 * 32) {
      uint8_t b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        b[u] = k + 32 * u < n ? __ldg(wf + k + 32 * u) : 0;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k + 32 * u < n) wt[k + 32 * u] = b[u];
    }
  }
}

}  // namespace

// Launches one pass of the row walk on `stream`; returns a CUDA error code
// (0 = launched). write = 0: row_sizes[R] (cum and out unused). write = 1:
// out at start = cum[row] - row_sizes[row] and the #dst lanes, for rows < n.
extern "C" int encode_rows(const void* base, const void* code, int code_len,
                           const void* lanes, int n_lanes, int n, int R,
                           int depth, int write, const void* cum,
                           void* row_sizes, void* out, void* stream) {
  if (R <= 0) return 0;
  if (n < 0 || n > R || depth > kMaxDepth || code_len <= 0 ||
      (write && (cum == nullptr || out == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int shmem = 8 * n_lanes + 4 * code_len;
  if (shmem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        encode_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shmem);
    if (rc != 0) return rc;
  }
  encode_rows_kernel<<<(R + kThreads - 1) / kThreads, kThreads, shmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), static_cast<const int32_t*>(code),
      code_len, static_cast<const long long*>(lanes), n_lanes, n, R, write,
      static_cast<const int32_t*>(cum), static_cast<int32_t*>(row_sizes),
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// Launches the payload copy on `stream` over the n_elems elements of the
// n_cols columns: per_warp = 0, one thread per element (payloads of 32
// bytes or more copied by the whole warp); per_warp = 1, one warp per
// element. Returns a CUDA error code.
extern "C" int encode_strings(const void* base, const void* lanes,
                              int n_lanes, const void* cols, int n_cols,
                              long long n_elems, int per_warp, void* out,
                              void* stream) {
  if (n_elems <= 0 || n_cols <= 0) return 0;
  const long long threads = per_warp ? n_elems * 32 : n_elems;
  const long long blocks = (threads + kStringThreads - 1) / kStringThreads;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  const int shmem = 8 * n_lanes + 4 * kColWords * n_cols;
  if (shmem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        encode_strings_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shmem);
    if (rc != 0) return rc;
  }
  encode_strings_kernel<<<(unsigned)blocks, kStringThreads, shmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), static_cast<const long long*>(lanes),
      n_lanes, static_cast<const int32_t*>(cols), n_cols, n_elems, per_warp,
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
