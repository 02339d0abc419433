// Sorted segment sum (K5), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/segment_reduce.py
// segment_sum_sorted (:49):
//
//   out[s, :] = sum of values[r, :] over the rows r with ids[r] == s,
//               for s in [0, S); rows whose id lies outside [0, S) are
//               padding and dropped; an empty segment gives zeros.
//
// values [N, D] in f32, f16 or bf16, row-major and contiguous; ids [N]
// int32, sorted ascending; out [S, D] in the values' type.  The sum is
// taken in f32 and cast back once, as the Pallas kernel does.
//
// Bound: device-memory bytes.  Each launch must read every value and id
// once and write every output once: N*D*e + 4*N + S*D*e bytes for an
// e-byte type, with one add per value.  At ogb_products' aggregation
// shape (N = 61,859,140 rows, D = 100, S = 2,449,029, f32) that is
// 25.97 GB, 7.75 ms at 3.35 TB/s; at 2 operations per byte at most, no
// arithmetic rate comes near it.
//
// Design.  The Pallas kernel keeps the whole [S, D] accumulator resident
// in VMEM and adds each block's one-hot product into it, relying on the
// TPU running grid steps in order.  Hopper runs blocks in no order, so
// nothing is carried between blocks: one warp owns one segment at a time
// (grid-stride over segments), finds the segment's row range [lo, hi) by
// two binary searches in the sorted ids (lanes of one parity search the
// same bound, so each probe is one broadcast load), and sums the rows in
// row order, 32 columns a pass with lane c on column c: every load is one
// contiguous 32-element stretch of a row, and a segment's rows are
// contiguous in memory because the ids are sorted.  Each output element
// is written once by one lane, so the result has no atomics and is the
// same bits on every run.  Padding ids (negative, or >= S) fall outside
// every searched range by construction.  A very long segment is summed by
// one warp (a load-balance limit, left for later work); the entry point
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// First row r in [0, n) with ids[r] >= key (n if none).
__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ ids,
                                               int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (static_cast<int64_t>(ids[mid]) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ values,
                   const int32_t* __restrict__ ids, T* __restrict__ out,
                   int64_t n, int64_t d, int64_t num_segments) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t seg = warp; seg < num_segments; seg += n_warps) {
    // even lanes find the segment's first row, odd lanes its end
    const int64_t bound = lower_bound(ids, n, seg + (lane & 1));
    const int64_t lo = __shfl_sync(0xffffffffu, bound, 0);
    const int64_t hi = __shfl_sync(0xffffffffu, bound, 1);
    T* __restrict__ dst = out + seg * d;
    for (int64_t c = lane; c < d; c += 32) {
      const T* __restrict__ src = values + lo * d + c;
      float acc = 0.0f;
#pragma unroll 4
      for (int64_t r = lo; r < hi; ++r, src += d) {
        acc += to_f32(*src);
      }
      dst[c] = from_f32<T>(acc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* values, const int32_t* ids, void* out,
                   int64_t n, int64_t d, int64_t num_segments,
                   cudaStream_t stream) {
  int64_t blocks = (num_segments + kWarps - 1) / kWarps;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;  // grid-stride
  segment_sum_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(static_cast<const T*>(values), ids,
                                    static_cast<T*>(out), n, d,
                                    num_segments);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = f16, 2 = bf16.  Needs num_segments >= 1 and d >= 1.
int sr_segment_sum_sorted(const void* values, const int32_t* ids, void* out,
                          long long n, long long d, long long num_segments,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(values, ids, out, n, d, num_segments, s);
    case 1:
      return launch<__half>(values, ids, out, n, d, num_segments, s);
    case 2:
      return launch<__nv_bfloat16>(values, ids, out, n, d, num_segments, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
