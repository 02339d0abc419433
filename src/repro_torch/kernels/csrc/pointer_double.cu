// Pointer-doubling rounds of Phase 3, hand-written for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of repro/kernels/pointer_double.py:
//
//   pd_pointer_double       <- pointer_double       (K1, :108, min-label CC
//                                                    round, on packed records)
//       rec[i] = (nxt, lab), one int2 per element:
//       nxt'[i] = nxt[nxt[i]];  lab'[i] = min(lab[i], lab[nxt[i]])
//   pd_pointer_double_rank  <- pointer_double_rank  (K2, :152, list-ranking
//                                                    round, on packed records)
//       rec[i] = (ptr, dist, reach, 0), one int4 per element:
//       ptr'[i] = ptr[ptr[i]];  dist'[i] = dist[i] + dist[ptr[i]];
//       reach'[i] = max(reach[i], reach[ptr[i]])
//   pd_pointer_double_shard       <- pointer_double_shard       (K3, :220)
//   pd_pointer_double_rank_shard  <- pointer_double_rank_shard  (K4, :275)
//       one ring step of the sharded Phase 3, for all n query shards at
//       once: row r of the [n, S] queries owns the visiting table slice
//       tbl[r, 0:s_real] at global offset base[r].  With
//       idx = q[r,i] - base[r] (int32 wrap-around, as in the reference),
//       own = 0 <= idx < s_real, and out[r,i] = own ? tbl[r,idx] : a[r,i]
//       for each of the 2 (K3: nxt, lab) or 3 (K4: ptr, dist, reach)
//       tables.  The 1-D single-shard form is the case n = 1.
//
// All values are int32.  K1 takes [n, 2] and K2 [n, 4] records, 8- and
// 16-byte aligned.  A pointer nxt[i], ptr[i] is read as a jnp gather
// reads its index (gather_index below): a negative one plus n, then
// clamped to [0, n), so the reference's halt at a wrapped -1 reads row
// n - 1 and nothing reads outside the table.  dist adds with int32
// wrap-around, like the torch twin.  K3/K4 take any query values: a
// query outside [base, base + s_real) is simply not owned.
//
// Bound: device-memory bytes; almost no arithmetic.  Each launch reads
// every input once and writes every output once.  K1: 16 bytes per
// element (two tables in, two out: the packed record adds no padding),
// K2: 24 (three in, three out; the record's fourth lane is the layout's
// cost, not the work's, and is not counted), K3: 28 (q, two carried
// answers, two table slices of T = S rows, two outputs), K4: 40.  At the
// main path's 8,388,608 stubs (n = 8 shards of S = 1,048,576) that is
// 134, 201, 235 and 336 MB: 0.040, 0.060, 0.070 and 0.100 ms at
// 3.35 TB/s.
//
// Design.  The Pallas kernels keep the whole jump table (K1/K2) or the
// visiting table slice (K3/K4) resident in VMEM and tile the queries;
// Hopper has no store that large (K1's records are 67 MB and K2's 134 MB
// at that size, above the 50 MB L2).  So the tables stay in device
// memory: one thread per element in a grid-stride loop, the own record
// read coalesced, the record at the pointer gathered at random, the
// result written coalesced.  A random gather fetches a whole 32-byte
// sector for the 8 or 16 bytes it uses, so each round keeps its state as
// one record per element: K1's (nxt, lab) in one 8-byte load, K2's (ptr,
// dist, reach, 0) in one 16-byte load, one random sector an element
// where separate tables cost one a table.  K1 moves about 48 bytes an
// element where its bound counts 16 (its two-table form moved about 80).
//
// What the L2 does for K1.  Half of K1's 67 MB of records fits in the
// 50 MB L2, and the coalesced streams (own records in, results out, 134
// MB a round) pass through it too.  A round's results are read only by
// the next round, after all of this one's traffic, so K1 stores them
// evict-first (a createpolicy policy passed with .L2::cache_hint): they
// leave the L2 before table lines do.  Measured on an H100 with
// launch/k1_variants.py (PERF.md), that store hint gains 0.6-1.6 % on a
// random one-cycle input and on the solve's own input, and the other L2
// controls lose: evict-first own-record loads lose up to 9 % (the own
// records a round streams are the very lines its gathers hit, so marking
// them evict-first throws hits away); evict-last gathers lose up to 9 %
// on the random cycle; a persisting access-policy window set and cleared
// around each launch costs 0.03-0.04 ms a call in limit and reset calls
// alone and loses 65-120 %; two passes over table halves lose 15-25 % (a
// second stream of the records and partial-sector writes); 2 or 4
// records a thread with every load issued first gain nothing (256
// threads x 8 blocks an SM already keep about 2,000 gathers in flight).
//
// Enough threads stay resident (256 per block, up to 8 blocks per SM) to
// keep many independent gathers in flight.  K3/K4 give each query shard
// its own grid row (blockIdx.y), so a thread reads its shard's base once,
// and only the owned queries, about 1/n of them, gather: most of each
// launch is the coalesced stream the bound counts, which is why K3/K4
// come nearer their bound than K1/K2.  Round k (K1/K2) and ring step k
// (K3/K4) must read only the values of step k-1, so inputs and outputs
// are separate buffers that the caller ping-pongs; an in-place update
// would race in K1/K2 and, in K3/K4, would move fewer bytes than the
// bound counts (left for later work).  Nothing is padded but K2's
// records: the loop bound masks the ragged edge, and s_real masks a table
// slice's pad rows.  Each entry point launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// so the caller can raise on a refused launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// The row a jnp gather reads for pointer p of a table of n rows: a
// negative p wraps once (p + n), then the row is clamped to [0, n).  So
// x[[-1, 7, -9]] on 5 rows reads rows 4, 4, 0, and no pointer reads
// outside the table.  In-range pointers are unchanged.
__device__ __forceinline__ int64_t gather_index(int32_t p, int64_t n) {
  int64_t r = p < 0 ? static_cast<int64_t>(p) + n : static_cast<int64_t>(p);
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

// K1 on records rec[i] = (nxt, lab): one 8-byte load of the own record
// (coalesced), one of the record at nxt (gathered), one 8-byte store,
// marked evict-first in L2 under the cache policy pol.
__device__ __forceinline__ void store_evict_first(int2* p, int2 v,
                                                  uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v2.s32 [%0], {%1, %2}, %3;" ::"l"(p),
               "r"(v.x), "r"(v.y), "l"(pol)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
pointer_double_kernel(const int2* __restrict__ rec, int2* __restrict__ out,
                      int64_t n) {
  uint64_t evict_first;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
      : "=l"(evict_first));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int2 own = __ldg(rec + i);
    const int2 far = __ldg(rec + gather_index(own.x, n));
    store_evict_first(
        out + i, make_int2(far.x, far.y < own.y ? far.y : own.y),
        evict_first);
  }
}

__global__ void __launch_bounds__(kThreads)
pointer_double_rank_kernel(const int4* __restrict__ rec,
                           int4* __restrict__ rec_out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int4 own = __ldg(rec + i);
    const int4 far = __ldg(rec + gather_index(own.x, n));
    int4 next;
    next.x = far.x;
    // unsigned add: int32 wrap-around without signed-overflow UB
    next.y = static_cast<int32_t>(static_cast<uint32_t>(own.y) +
                                  static_cast<uint32_t>(far.y));
    next.z = far.z > own.z ? far.z : own.z;
    next.w = 0;
    rec_out[i] = next;
  }
}

// Shard ring step, the 2-table (K3) and 3-table (K4) forms.  Row r =
// blockIdx.y; the grid's x dimension strides over the row's cols queries.
__device__ __forceinline__ bool shard_owns(int32_t q, int32_t base,
                                           int32_t s_real, int32_t* idx) {
  // unsigned subtract: int32 wrap-around without signed-overflow UB
  *idx = static_cast<int32_t>(static_cast<uint32_t>(q) -
                              static_cast<uint32_t>(base));
  return *idx >= 0 && *idx < s_real;
}

__global__ void __launch_bounds__(kThreads)
pointer_double_shard_kernel(const int32_t* __restrict__ q,
                            const int32_t* __restrict__ a_nxt,
                            const int32_t* __restrict__ a_lab,
                            const int32_t* __restrict__ base,
                            const int32_t* __restrict__ t_nxt,
                            const int32_t* __restrict__ t_lab,
                            int32_t* __restrict__ o_nxt,
                            int32_t* __restrict__ o_lab, int64_t cols,
                            int64_t tcols, int32_t s_real) {
  const int64_t row = blockIdx.y;
  const int32_t b = base[row];
  const int64_t off = row * cols;
  const int32_t* tn = t_nxt + row * tcols;
  const int32_t* tl = t_lab + row * tcols;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < cols; i += stride) {
    const int64_t k = off + i;
    int32_t idx;
    if (shard_owns(q[k], b, s_real, &idx)) {
      o_nxt[k] = tn[idx];
      o_lab[k] = tl[idx];
    } else {
      o_nxt[k] = a_nxt[k];
      o_lab[k] = a_lab[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
pointer_double_rank_shard_kernel(const int32_t* __restrict__ q,
                                 const int32_t* __restrict__ a_ptr,
                                 const int32_t* __restrict__ a_dist,
                                 const int32_t* __restrict__ a_reach,
                                 const int32_t* __restrict__ base,
                                 const int32_t* __restrict__ t_ptr,
                                 const int32_t* __restrict__ t_dist,
                                 const int32_t* __restrict__ t_reach,
                                 int32_t* __restrict__ o_ptr,
                                 int32_t* __restrict__ o_dist,
                                 int32_t* __restrict__ o_reach, int64_t cols,
                                 int64_t tcols, int32_t s_real) {
  const int64_t row = blockIdx.y;
  const int32_t b = base[row];
  const int64_t off = row * cols;
  const int32_t* tp = t_ptr + row * tcols;
  const int32_t* td = t_dist + row * tcols;
  const int32_t* tr = t_reach + row * tcols;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < cols; i += stride) {
    const int64_t k = off + i;
    int32_t idx;
    if (shard_owns(q[k], b, s_real, &idx)) {
      o_ptr[k] = tp[idx];
      o_dist[k] = td[idx];
      o_reach[k] = tr[idx];
    } else {
      o_ptr[k] = a_ptr[k];
      o_dist[k] = a_dist[k];
      o_reach[k] = a_reach[k];
    }
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

// x extent of a shard launch: the rows share grid_for's block budget.
unsigned shard_grid_x(int64_t rows, int64_t cols) {
  const int64_t per_row = grid_for(rows * cols) / rows;
  const int64_t need = (cols + kThreads - 1) / kThreads;
  const int64_t x = per_row < need ? per_row : need;
  return static_cast<unsigned>(x > 0 ? x : 1);
}

}  // namespace

// rec and rec_out: n records (nxt, lab) of 2 int32, 8-byte aligned.
extern "C" int pd_pointer_double(const void* rec, void* rec_out,
                                 long long n, void* stream) {
  if (n <= 0) return 0;
  pointer_double_kernel<<<grid_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(rec), static_cast<int2*>(rec_out), n);
  return static_cast<int>(cudaGetLastError());
}

// rec and rec_out: n records of 4 int32, 16-byte aligned.
extern "C" int pd_pointer_double_rank(const void* rec, void* rec_out,
                                      long long n, void* stream) {
  if (n <= 0) return 0;
  pointer_double_rank_kernel<<<grid_for(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(rec), static_cast<int4*>(rec_out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pd_pointer_double_shard(const void* q, const void* a_nxt,
                                       const void* a_lab, const void* base,
                                       const void* t_nxt, const void* t_lab,
                                       void* o_nxt, void* o_lab,
                                       long long rows, long long cols,
                                       long long tcols, int s_real,
                                       void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const dim3 grid(shard_grid_x(rows, cols), static_cast<unsigned>(rows));
  pointer_double_shard_kernel<<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), static_cast<const int32_t*>(a_nxt),
      static_cast<const int32_t*>(a_lab), static_cast<const int32_t*>(base),
      static_cast<const int32_t*>(t_nxt), static_cast<const int32_t*>(t_lab),
      static_cast<int32_t*>(o_nxt), static_cast<int32_t*>(o_lab), cols, tcols,
      s_real);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pd_pointer_double_rank_shard(
    const void* q, const void* a_ptr, const void* a_dist, const void* a_reach,
    const void* base, const void* t_ptr, const void* t_dist,
    const void* t_reach, void* o_ptr, void* o_dist, void* o_reach,
    long long rows, long long cols, long long tcols, int s_real,
    void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const dim3 grid(shard_grid_x(rows, cols), static_cast<unsigned>(rows));
  pointer_double_rank_shard_kernel<<<grid, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), static_cast<const int32_t*>(a_ptr),
      static_cast<const int32_t*>(a_dist),
      static_cast<const int32_t*>(a_reach),
      static_cast<const int32_t*>(base), static_cast<const int32_t*>(t_ptr),
      static_cast<const int32_t*>(t_dist),
      static_cast<const int32_t*>(t_reach), static_cast<int32_t*>(o_ptr),
      static_cast<int32_t*>(o_dist), static_cast<int32_t*>(o_reach), cols,
      tcols, s_real);
  return static_cast<int>(cudaGetLastError());
}
