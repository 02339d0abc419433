// Pointer-doubling rounds of Phase 3, hand-written for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of repro/kernels/pointer_double.py:
//
//   pd_pointer_double       <- pointer_double       (K1, min-label CC round)
//       nxt'[i] = nxt[nxt[i]];  lab'[i] = min(lab[i], lab[nxt[i]])
//   pd_pointer_double_rank  <- pointer_double_rank  (K2, list-ranking round)
//       ptr'[i] = ptr[ptr[i]];  dist'[i] = dist[i] + dist[ptr[i]];
//       reach'[i] = max(reach[i], reach[ptr[i]])
//
// All arrays are int32 [n] with 0 <= nxt[i], ptr[i] < n (the caller's
// contract, as in the reference).  dist adds with int32 wrap-around, like
// the torch twin.
//
// Bound: device-memory bytes.  Each round reads every input once and
// writes every output once: 16 bytes per element for K1 (two tables in,
// two out), 24 for K2.  At the main path's n = 8,388,608 that is 134 MB
// and 201 MB, about 40 us and 60 us at 3.35 TB/s.  Almost no arithmetic.
//
// Design.  The Pallas kernels keep the whole jump table resident in VMEM
// and tile the queries; Hopper has no store that large (the tables are
// 67 MB and 101 MB at that n, above the 50 MB L2).  So the tables stay in
// device memory: one thread per element in a grid-stride loop, the
// queries nxt[i]/ptr[i] and the own values read coalesced, the table
// values at the pointer gathered at random, every output written
// coalesced.  Enough threads stay resident (256 per block, up to 8 blocks
// per SM) to keep many independent gathers in flight.  Round k must read
// only round k-1's values, so inputs and outputs are separate buffers
// that the caller ping-pongs; an in-place update would race.  Nothing is
// padded: the loop bound masks the ragged edge.  Each entry point launches
// on the given stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
pointer_double_kernel(const int32_t* __restrict__ nxt,
                      const int32_t* __restrict__ lab,
                      int32_t* __restrict__ nxt_out,
                      int32_t* __restrict__ lab_out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t j = nxt[i];
    const int32_t own = lab[i];
    const int32_t far = lab[j];
    nxt_out[i] = nxt[j];
    lab_out[i] = far < own ? far : own;
  }
}

__global__ void __launch_bounds__(kThreads)
pointer_double_rank_kernel(const int32_t* __restrict__ ptr,
                           const int32_t* __restrict__ dist,
                           const int32_t* __restrict__ reach,
                           int32_t* __restrict__ ptr_out,
                           int32_t* __restrict__ dist_out,
                           int32_t* __restrict__ reach_out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t j = ptr[i];
    const int32_t r_own = reach[i];
    const int32_t r_far = reach[j];
    ptr_out[i] = ptr[j];
    // unsigned add: int32 wrap-around without signed-overflow UB
    dist_out[i] = static_cast<int32_t>(static_cast<uint32_t>(dist[i]) +
                                       static_cast<uint32_t>(dist[j]));
    reach_out[i] = r_far > r_own ? r_far : r_own;
  }
}

int grid_for(int64_t n) {
  int dev = 0;
  int sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm * 8;
  return static_cast<int>(need < cap ? need : cap);
}

}  // namespace

extern "C" int pd_pointer_double(const void* nxt, const void* lab,
                                 void* nxt_out, void* lab_out, long long n,
                                 void* stream) {
  if (n <= 0) return 0;
  pointer_double_kernel<<<grid_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nxt), static_cast<const int32_t*>(lab),
      static_cast<int32_t*>(nxt_out), static_cast<int32_t*>(lab_out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pd_pointer_double_rank(const void* ptr, const void* dist,
                                      const void* reach, void* ptr_out,
                                      void* dist_out, void* reach_out,
                                      long long n, void* stream) {
  if (n <= 0) return 0;
  pointer_double_rank_kernel<<<grid_for(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ptr), static_cast<const int32_t*>(dist),
      static_cast<const int32_t*>(reach), static_cast<int32_t*>(ptr_out),
      static_cast<int32_t*>(dist_out), static_cast<int32_t*>(reach_out), n);
  return static_cast<int>(cudaGetLastError());
}
