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
// Bound: device-memory bytes.  Each call must read every value and id
// once and write every output once: N*D*e + 4*N + S*D*e bytes for an
// e-byte type, with one add per value.  At ogb_products' aggregation
// shape (N = 61,859,140 rows, D = 100, S = 2,449,029, f32) that is
// 25.97 GB, 7.75 ms at 3.35 TB/s; at 2 operations per byte at most, no
// arithmetic rate comes near it.
//
// Design: a row-tiled reduce-by-key.  The Pallas kernel keeps the whole
// [S, D] accumulator resident in VMEM and adds each block's one-hot
// product into it, relying on the TPU running grid steps in order.
// Hopper runs blocks in no order, so the work is split by rows instead:
//
//  * Tiles of rows.  A team of threads owns one tile of R contiguous rows
//    (R sized on the host so that a tile moves about 128 KB, a multiple
//    of 16 rows, at least 32).  Thread c of the team owns vector column c
//    of the row (columns c, c + team, ... when a row has more vectors than
//    the team has threads); the team is as wide as the row, so every
//    lane loads, and a block of 256 threads holds 256 / team teams.  The
//    time of a call depends on N*D, not on the length of any segment.
//  * Wide loads.  A vector is VE elements, the widest of 16, 8, 4 or 2
//    bytes (VE of 8, 4, 2 or 1) that divides the row pitch D*e and the
//    base addresses: 16-byte loads at D = 100 f32, 8-byte ones at D = 100
//    bf16, 4-byte ones at D = 1,433 f32.  A thread loads 128 bytes of
//    vectors (8 rows of 16 bytes, 16 of 8) before it adds any and
//    without waiting for their ids, so that many independent loads are in
//    flight; each load asks L2 for the 256-byte block around it; 2 blocks
//    of 256 threads fit an SM (at most 128 registers a thread).  These
//    sizes and hints are the fastest of launch/k5_variants.py's on the
//    H100 (PERF.md); the L1 no-allocate hint cost 13 %.
//  * Segment edges from the tile's own ids.  A thread walks its tile's
//    rows in order, reading each row's id (one broadcast load for the
//    team), and compares it with the previous one: no binary search.  A
//    run of equal ids is summed in f32 registers.  A run that lies wholly
//    inside the tile is written to out by the tile.  A run that continues
//    into the tile before (ids[r0 - 1] == s) or after (ids[r1] == s) is
//    partial: it goes to the tile's carry slot 0 (first run) or 1 (last
//    run), with its id as the slot's key; a tile that holds one run
//    continuing on both sides writes its sum to slot 0 and zeros under
//    the same key to slot 1.  An unused slot's key is -1 (padding).
//  * Carries by the same kernel.  The carries, [tiles, 2, D] f32 with
//    their keys, are again rows with sorted keys (a segment's partial
//    sums are contiguous and in tile order, padding keys fall only
//    between segments), so the next level is the same kernel over them,
//    with f32 input: segments that fit one of its tiles are written out,
//    the rest carry on.  Each level cuts the rows by R / 2; the level
//    with one tile carries nothing.  At ogb_products f32 (R = 320) that
//    is 4 launches over 61.9 M, 387 K, 2,418 and 16 rows.  However long a
//    segment, no thread sums more than one tile of it, and the sum has a
//    fixed order: no atomics, the same bits on every run.
//  * Every output row is written exactly once: a segment with rows by the
//    one run (at some level) that holds all of it; an empty segment by
//    the level-1 team that owns the gap in the ids around it (the row
//    where the id changes, or row 0, or the last row for the gap after
//    the last id).  The gap's zeros are spread over the team's columns;
//    a gap of g segments costs that one team g*D*e bytes of stores.
//
// Workspace: the carries of every level (f32 values and int32 keys),
// sr_workspace_bytes(n, d, dtype) bytes, allocated by the caller.  The
// entry point launches on the given stream (one launch per level, all
// counted as one call of K5 by the wrapper), allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBatchBytes = 128;       // a thread loads this much ahead
constexpr int kMinBlocks = 2;          // resident blocks an SM must fit
constexpr int64_t kTileBytes = 131072; // a tile moves about this much
constexpr int64_t kMinRows = 32;
constexpr int64_t kMaxRows = 4096;

// Rows a thread loads before it adds any: kBatchBytes of vectors, 4 to 16
// rows.
template <typename T, int VE>
__host__ __device__ constexpr int batch_rows() {
  constexpr int rows = kBatchBytes / static_cast<int>(sizeof(T) * VE);
  return rows < 4 ? 4 : (rows > 16 ? 16 : rows);
}
constexpr int64_t kAlign = 256;        // each workspace array starts so

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

// VE elements loaded or stored as one aligned access (two for 32 bytes).
template <typename T, int VE>
struct alignas(sizeof(T) * VE) Vec {
  T v[VE];
};

// The values' loads: read-only, and each miss asks L2 for the 256-byte
// block around it (a team reads its rows in order).
#define K5_LOAD "ld.global.nc.L2::256B"

template <typename T, int VE>
__device__ __forceinline__ Vec<T, VE> load_vec(const T* p) {
  constexpr int kBytes = static_cast<int>(sizeof(T)) * VE;
  union {
    Vec<T, VE> vec;
    uint32_t w[kBytes >= 4 ? kBytes / 4 : 1];
    uint16_t h;
  } u;
  if constexpr (kBytes == 16) {
    asm(K5_LOAD ".v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(u.w[0]), "=r"(u.w[1]), "=r"(u.w[2]), "=r"(u.w[3])
        : "l"(p));
  } else if constexpr (kBytes == 8) {
    asm(K5_LOAD ".v2.u32 {%0, %1}, [%2];"
        : "=r"(u.w[0]), "=r"(u.w[1]) : "l"(p));
  } else if constexpr (kBytes == 4) {
    asm(K5_LOAD ".u32 %0, [%1];" : "=r"(u.w[0]) : "l"(p));
  } else {
    static_assert(kBytes == 2, "vectors are 2, 4, 8 or 16 bytes");
    asm(K5_LOAD ".u16 %0, [%1];" : "=h"(u.h) : "l"(p));
  }
  return u.vec;
}

template <typename T, int VE>
__device__ __forceinline__ void store_f32(T* dst, const float (&acc)[VE]) {
  Vec<T, VE> w;
#pragma unroll
  for (int i = 0; i < VE; ++i) w.v[i] = from_f32<T>(acc[i]);
  *reinterpret_cast<Vec<T, VE>*>(dst) = w;
}

struct Level {
  int64_t rows;        // input rows of this level
  int64_t tile_rows;   // R
  int64_t tiles;       // ceil(rows / R)
  int team;            // threads per tile
  int teams;           // tiles per block
};

// Sums tile `tile` of `rows` rows of `in` ([rows, d], keys `ids`) into
// `out` ([s, d]) and the carries (`carry` [tiles, 2, d] f32, `carry_ids`
// [tiles, 2]).  `zero_gaps` on the first level only: later levels' keys
// skip segments that level 1 already owns.
template <typename Tin, typename Tout, int VE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_tile_kernel(const Tin* __restrict__ in,
                    const int32_t* __restrict__ ids, Tout* __restrict__ out,
                    float* __restrict__ carry, int32_t* __restrict__ carry_ids,
                    int64_t rows, int64_t d, int64_t s, int64_t tile_rows,
                    int64_t tiles, int team, int teams, bool zero_gaps) {
  const int slot = threadIdx.x / team;
  const int lane = threadIdx.x - slot * team;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * teams + slot;
  if (slot >= teams || tile >= tiles) return;
  const int64_t r0 = tile * tile_rows;
  const int64_t r1 = r0 + tile_rows < rows ? r0 + tile_rows : rows;
  const int64_t vcols = d / VE;
  const int32_t left = r0 > 0 ? ids[r0 - 1] : -1;
  const int32_t right = r1 < rows ? ids[r1] : -1;
  const int32_t first_key = ids[r0];
  const int32_t last_key = ids[r1 - 1];
  const bool first_carries = r0 > 0 && left == first_key &&
                             first_key >= 0 && first_key < s;
  const bool last_carries = r1 < rows && right == last_key &&
                            last_key >= 0 && last_key < s;
  if (lane == 0 && carry_ids != nullptr) {
    carry_ids[2 * tile] = first_carries ? first_key : -1;
    carry_ids[2 * tile + 1] = last_carries ? last_key : -1;
  }

  for (int64_t c = lane; c < vcols; c += team) {
    const int64_t col = c * VE;

    // the zeros of segments lo .. hi-1, this thread's column
    auto zero_rows = [&](int64_t lo, int64_t hi) {
      if (lo < 0) lo = 0;
      if (hi > s) hi = s;
      const float z[VE] = {};
      for (int64_t g = lo; g < hi; ++g) {
        store_f32<Tout, VE>(out + g * d + col, z);
      }
    };

    float acc[VE];
#pragma unroll
    for (int i = 0; i < VE; ++i) acc[i] = 0.0f;
    int32_t key = first_key;
    int64_t start = r0;
    if (zero_gaps && left != first_key) {
      zero_rows(int64_t{left} + 1, first_key);
    }

    // the run of `key` over rows [start, end) is complete: write it
    auto flush = [&](int64_t end) {
      if (key < 0 || key >= s) return;
      const bool l = start == r0 && first_carries;
      const bool r = end == r1 && last_carries;
      if (!l && !r) {
        store_f32<Tout, VE>(out + int64_t{key} * d + col, acc);
        return;
      }
      float* dst = carry + (2 * tile + (l ? 0 : 1)) * d + col;
      store_f32<float, VE>(dst, acc);
      if (l && r) {   // one run continuing both ways: slot 1 adds nothing
        const float z[VE] = {};
        store_f32<float, VE>(dst + d, z);
      }
    };

    // batches of U rows: every load of a batch is issued before any add,
    // and none waits for an id (a padding row's values are read and
    // dropped).  A batch that ends in the segment it starts in lies wholly
    // in it, the common case, and adds without a test: valid keys never
    // fall, and a padding key never sits between two equal valid ones
    constexpr int U = batch_rows<Tin, VE>();
    const Tin* src = in + r0 * d + col;
    for (int64_t rb = r0; rb < r1; rb += U, src += U * d) {
      const int64_t m = r1 - rb < U ? r1 - rb : U;
      int32_t k[U];
      Vec<Tin, VE> v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < m) {
          k[u] = ids[rb + u];
          v[u] = load_vec<Tin, VE>(src + u * d);
        }
      }
      if (m == U && k[U - 1] == key && key >= 0 && key < s) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int i = 0; i < VE; ++i) acc[i] += to_f32(v[u].v[i]);
        }
        continue;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= m) break;
        if (k[u] != key) {
          flush(rb + u);
          if (zero_gaps) zero_rows(int64_t{key} + 1, k[u]);
          key = k[u];
          start = rb + u;
#pragma unroll
          for (int i = 0; i < VE; ++i) acc[i] = 0.0f;
        }
        if (k[u] >= 0 && k[u] < s) {
#pragma unroll
          for (int i = 0; i < VE; ++i) acc[i] += to_f32(v[u].v[i]);
        }
      }
    }
    flush(r1);
    if (zero_gaps && r1 == rows) zero_rows(int64_t{key} + 1, s);
  }
}

int64_t align_up(int64_t x) { return (x + kAlign - 1) / kAlign * kAlign; }

// Vector elements for a row of `d` elements of `in_size` bytes read from
// `in` and written as `out_size`-byte elements to `out` (and, when there
// is a next level, as f32 carries): the widest that divides the pitches
// and the base addresses, at most 16 bytes a load.
int vector_elems(int64_t d, const void* in, int in_size, const void* out,
                 int out_size) {
  for (int ve = 8; ve > 1; ve /= 2) {
    if (ve * in_size > 16 || d % ve) continue;
    if (reinterpret_cast<uintptr_t>(in) % (ve * in_size)) continue;
    if (reinterpret_cast<uintptr_t>(out) % (ve * out_size)) continue;
    return ve;
  }
  return 1;
}

Level plan(int64_t rows, int64_t d, int in_size, int ve) {
  Level lv;
  lv.rows = rows;
  int64_t r = kTileBytes / (d * in_size);
  r = r < kMinRows ? kMinRows : (r > kMaxRows ? kMaxRows : r);
  lv.tile_rows = r / 16 * 16;
  lv.tiles = (rows + lv.tile_rows - 1) / lv.tile_rows;
  const int64_t vcols = d / ve;
  lv.team = vcols < kThreads ? static_cast<int>(vcols) : kThreads;
  lv.teams = kThreads / lv.team;
  return lv;
}

// Bytes of one level's carries: f32 values, then int32 keys.
int64_t carry_bytes(int64_t tiles, int64_t d) {
  return align_up(2 * tiles * d * 4) + align_up(2 * tiles * 4);
}

template <typename Tin, typename Tout, int VE>
cudaError_t launch_level(const Level& lv, const void* in, const int32_t* ids,
                         void* out, float* carry, int32_t* carry_ids,
                         int64_t d, int64_t s, bool zero_gaps,
                         cudaStream_t stream) {
  const int64_t blocks = (lv.tiles + lv.teams - 1) / lv.teams;
  segment_tile_kernel<Tin, Tout, VE><<<static_cast<unsigned>(blocks), kThreads,
                                       0, stream>>>(
      static_cast<const Tin*>(in), ids, static_cast<Tout*>(out), carry,
      carry_ids, lv.rows, d, s, lv.tile_rows, lv.tiles, lv.team, lv.teams,
      zero_gaps);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_ve(int ve, const Level& lv, const void* in,
                      const int32_t* ids, void* out, float* carry,
                      int32_t* carry_ids, int64_t d, int64_t s,
                      bool zero_gaps, cudaStream_t stream) {
  switch (ve) {
    case 8:
      if constexpr (sizeof(Tin) <= 2) {
        return launch_level<Tin, Tout, 8>(lv, in, ids, out, carry, carry_ids,
                                          d, s, zero_gaps, stream);
      }
      return cudaErrorInvalidValue;
    case 4:
      return launch_level<Tin, Tout, 4>(lv, in, ids, out, carry, carry_ids, d,
                                        s, zero_gaps, stream);
    case 2:
      return launch_level<Tin, Tout, 2>(lv, in, ids, out, carry, carry_ids, d,
                                        s, zero_gaps, stream);
    default:
      return launch_level<Tin, Tout, 1>(lv, in, ids, out, carry, carry_ids, d,
                                        s, zero_gaps, stream);
  }
}

// Walks the levels; with `values` null it only adds up the workspace.
template <typename T>
cudaError_t run(const void* values, const int32_t* ids, void* out, int64_t n,
                int64_t d, int64_t s, char* work, int64_t* work_bytes,
                cudaStream_t stream) {
  const void* in = values;
  const int32_t* keys = ids;
  int64_t rows = n;
  int64_t used = 0;
  bool first = true;
  while (true) {
    const int in_size = first ? static_cast<int>(sizeof(T)) : 4;
    const int ve = vector_elems(d, in, in_size, out, sizeof(T));
    const Level lv = plan(rows, d, in_size, ve);
    float* carry = nullptr;
    int32_t* carry_ids = nullptr;
    if (lv.tiles > 1) {
      carry = reinterpret_cast<float*>(work + used);
      carry_ids = reinterpret_cast<int32_t*>(
          work + used + align_up(2 * lv.tiles * d * 4));
      used += carry_bytes(lv.tiles, d);
    }
    if (values != nullptr) {
      const cudaError_t err =
          first ? launch_ve<T, T>(ve, lv, in, keys, out, carry, carry_ids, d,
                                  s, true, stream)
                : launch_ve<float, T>(ve, lv, in, keys, out, carry, carry_ids,
                                      d, s, false, stream);
      if (err != cudaSuccess) return err;
    }
    if (lv.tiles <= 1) break;
    in = carry;
    keys = carry_ids;
    rows = 2 * lv.tiles;
    first = false;
  }
  if (work_bytes != nullptr) *work_bytes = used;
  return cudaSuccess;
}

cudaError_t by_dtype(int dtype, const void* values, const int32_t* ids,
                     void* out, int64_t n, int64_t d, int64_t s, void* work,
                     int64_t* work_bytes, cudaStream_t stream) {
  char* w = static_cast<char*>(work);
  switch (dtype) {
    case 0:
      return run<float>(values, ids, out, n, d, s, w, work_bytes, stream);
    case 1:
      return run<__half>(values, ids, out, n, d, s, w, work_bytes, stream);
    case 2:
      return run<__nv_bfloat16>(values, ids, out, n, d, s, w, work_bytes,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Writes to *bytes the workspace sr_segment_sum_sorted needs for n rows
// of d elements (every array aligned to 256 bytes; 0 when one tile holds
// all n rows).  Returns a cudaError_t.
int sr_workspace_bytes(long long n, long long d, int dtype,
                       long long* bytes) {
  int64_t total = 0;
  cudaError_t err = cudaSuccess;
  // the plan depends on the addresses only through the vector width,
  // which never changes the tile count: aligned placeholders do
  if (n >= 1 && d >= 1) {
    err = by_dtype(dtype, nullptr, nullptr, reinterpret_cast<void*>(kAlign),
                   n, d, 1, nullptr, &total, nullptr);
  }
  *bytes = total;
  return static_cast<int>(err);
}

// dtype: 0 = f32, 1 = f16, 2 = bf16.  Needs n >= 1, d >= 1,
// num_segments >= 1 and sr_workspace_bytes(n, d, dtype) bytes at work.
int sr_segment_sum_sorted(const void* values, const int32_t* ids, void* out,
                          long long n, long long d, long long num_segments,
                          int dtype, void* work, void* stream) {
  if (values == nullptr || n < 1 || d < 1 || num_segments < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      by_dtype(dtype, values, ids, out, n, d, num_segments, work, nullptr,
               static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
