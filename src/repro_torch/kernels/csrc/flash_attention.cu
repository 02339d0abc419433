// Flash attention forward (K6), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// flash_attention (:69) together with the GQA head repeat of
// repro/kernels/ops.py flash_attention_gqa (:54).  It computes
// repro/kernels/ref.py flash_attention_ref:
//
//   o[b, s, h, :] = softmax_t(q[b, s, h, :] . k[b, t, h / g, :] / sqrt(D))
//                   @ v[b, t, h / g, :],        g = Hq / Hkv,
//
// with t restricted to t <= s + (T - S) when causal (the queries are the
// suffix of the keys).  q and o are [B, S, Hq, D], k and v [B, T, Hkv, D],
// all contiguous: the kernel computes every row's offset from these
// shapes, so neither the head repeat nor a transpose is ever
// materialised.  Any S and T (T >= S when causal): ragged tails are
// masked; D is a template over {32, 64, 128}.
//
// Numerics, as the reference: scores in f32, scaled after the dot,
// masked with -1e30; the running (max, sum, acc) in f32; p cast to v's
// type before the PV product; o = acc / max(l, 1e-20) in q's type.
//
// Bound.  2 * 2 * D operations per visible (query, key) pair and head
// (the QK dot and the PV product), against reading q, k, v once and
// writing o once.  At the serving prefill's shape (B = 4, S = T = 4096,
// Hq = 15, Hkv = 5, D = 64, bf16, causal) that is 0.129 TFLOP against
// 21 MB: 0.130 ms at 989 TFLOP/s dense bf16, twenty times the 0.0063 ms
// the bytes need, so the tensor cores bound it.
//
// Design.  The Pallas kernel keeps a whole head's K and V in VMEM and
// streams 128-row tiles through the MXU.  Here, in bf16, one block of
// four warps owns 64 query rows of one (batch, head); each warp owns 16
// rows and keeps its Q fragments in registers for the whole run.  K and V
// stream through shared memory in 64-key tiles (rows padded by 16 bytes
// so every fragment load is free of bank conflicts); the warp computes
// its 16 x 64 score tile with mma.sync m16n8k16 (bf16 in, f32
// accumulate), applies scale and mask, updates the online softmax in
// registers (a row's four owners combine their maxima with two shuffles),
// and multiplies the bf16 probabilities, which the score accumulators
// already hold in the A-fragment layout, by V with mma.sync again.  A
// causal block stops after the last tile any of its rows can see.  In
// f32, which only the checks and the reduced configuration use, the same
// online softmax runs on CUDA-core FMAs (tensor cores would round the
// inputs to TF32): four threads share a query row, each holding a quarter
// of its q and accumulator as float4s, over 32-key tiles.  Loads are
// synchronous and single-buffered, so copies and products do not overlap
// yet: a simple kernel first (wgmma and TMA are later work).  The entry
// point launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Shape {
  int S, T, Hq, Hkv, group;  // group = Hq / Hkv
  int causal;
  float scale;               // 1 / sqrt(D)
};

// Element offset of [b, s, h, 0] in a contiguous [B, L, H, D] tensor.
__device__ __forceinline__ int64_t row_at(int b, int s, int h, int L, int H,
                                          int D) {
  return ((static_cast<int64_t>(b) * L + s) * H + h) * D;
}

// Number of 64- or 32-key tiles a block of rows [q0, q0 + rows) must read.
__device__ __forceinline__ int tiles_to_read(const Shape& sh, int q0,
                                             int rows, int bc) {
  int n = (sh.T + bc - 1) / bc;
  if (sh.causal) {
    const int last = min(sh.T - 1, q0 + rows - 1 + (sh.T - sh.S));
    n = min(n, last / bc + 1);
  }
  return n;
}

__device__ __forceinline__ bool visible(const Shape& sh, int row, int key) {
  return key < sh.T && (!sh.causal || key <= row + (sh.T - sh.S));
}

// ---------------------------------------------------------------- bf16 --

constexpr int kBr = 64;   // query rows per block (16 per warp)
constexpr int kBc = 64;   // keys per tile
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t load2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, Shape sh) {
  constexpr int kLd = D + 8;  // padded row: conflict-free fragment loads
  __shared__ __align__(16) __nv_bfloat16 ks[kBc][kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kBc][kLd];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;          // fragment row within 8
  const int t2 = (lane & 3) * 2;    // fragment column pair
  const int b = blockIdx.z, h = blockIdx.y, hk = h / sh.group;
  const int q0 = blockIdx.x * kBr;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's rows
  const bool live0 = r0 < sh.S, live1 = r1 < sh.S;
  const __nv_bfloat16* q_r0 = q + row_at(b, live0 ? r0 : 0, h, sh.S, sh.Hq, D);
  const __nv_bfloat16* q_r1 = q + row_at(b, live1 ? r1 : 0, h, sh.S, sh.Hq, D);

  // Q as A fragments (rows r0/r1, columns t2 and t2 + 8 of each 16-slab)
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t2;
    qa[kk][0] = live0 ? load2(q_r0 + c) : 0u;
    qa[kk][1] = live1 ? load2(q_r1 + c) : 0u;
    qa[kk][2] = live0 ? load2(q_r0 + c + 8) : 0u;
    qa[kk][3] = live1 ? load2(q_r1 + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.0f;
  }
  float m0 = -INFINITY, m1 = -INFINITY;  // running maxima of rows r0, r1
  float l0 = 0.0f, l1 = 0.0f;            // this thread's share of the sums

  const int n_tiles = tiles_to_read(sh, q0, kBr, kBc);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBc;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kBc * D / 8; i += kThreads) {
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      const int key = k0 + row;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;  // zero past T
      if (key < sh.T) {
        const int64_t at = row_at(b, key, hk, sh.T, sh.Hkv, D) + col;
        kx = *reinterpret_cast<const uint4*>(k + at);
        vx = *reinterpret_cast<const uint4*>(v + at);
      }
      *reinterpret_cast<uint4*>(&ks[row][col]) = kx;
      *reinterpret_cast<uint4*>(&vs[row][col]) = vx;
    }
    __syncthreads();

    // scores: s[nt] is keys k0 + 8 nt + t2 (+1) of rows r0 (0, 1), r1 (2, 3)
    float s[kBc / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBc / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &ks[nt * 8 + g][kk * 16 + t2];
        mma_bf16(s[nt], qa[kk], load2(kr), load2(kr + 8));
      }
    }

    float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
    for (int nt = 0; nt < kBc / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + t2 + (e & 1);
        const float x = s[nt][e] * sh.scale;
        s[nt][e] = visible(sh, e < 2 ? r0 : r1, key) ? x : kMasked;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float m0n = fmaxf(m0, mx0), m1n = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - m0n), alpha1 = expf(m1 - m1n);
    m0 = m0n;
    m1 = m1n;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < kBc / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - m0);
      s[nt][1] = expf(s[nt][1] - m0);
      s[nt][2] = expf(s[nt][2] - m1);
      s[nt][3] = expf(s[nt][3] - m1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha0;
      acc[dn][1] *= alpha0;
      acc[dn][2] *= alpha1;
      acc[dn][3] *= alpha1;
    }

    // acc += p @ V: the score accumulators of n-tiles 2kk, 2kk+1 are the
    // A fragment of key slab kk; V's B fragment pairs keys t2, t2 + 1
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                              pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key = kk * 16 + t2;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const int col = dn * 8 + g;
        mma_bf16(acc[dn], pa, pack(vs[key][col], vs[key + 1][col]),
                 pack(vs[key + 8][col], vs[key + 9][col]));
      }
    }
  }

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
  if (live0) {
    __nv_bfloat16* out = o + row_at(b, r0, h, sh.S, sh.Hq, D);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(out + dn * 8 + t2) =
          pack(acc[dn][0] / d0, acc[dn][1] / d0);
    }
  }
  if (live1) {
    __nv_bfloat16* out = o + row_at(b, r1, h, sh.S, sh.Hq, D);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(out + dn * 8 + t2) =
          pack(acc[dn][2] / d1, acc[dn][3] / d1);
    }
  }
}

// ----------------------------------------------------------------- f32 --

constexpr int kRows32 = 32;  // query rows per block: 4 threads a row
constexpr int kBc32 = 32;    // keys per tile

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Shape sh) {
  constexpr int kVec = D / 16;  // float4s a thread holds: D / 4 values
  __shared__ __align__(16) float4 ks[kBc32][D / 4];
  __shared__ __align__(16) float4 vs[kBc32][D / 4];

  const int part = threadIdx.x & 3;  // this thread holds float4s part + 4i
  const int b = blockIdx.z, h = blockIdx.y, hk = h / sh.group;
  const int q0 = blockIdx.x * kRows32;
  const int row = q0 + (threadIdx.x >> 2);
  const bool live = row < sh.S;
  const float4* qr = reinterpret_cast<const float4*>(
      q + row_at(b, live ? row : 0, h, sh.S, sh.Hq, D));

  float4 qv[kVec], acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    qv[i] = live ? qr[part + 4 * i] : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, l = 0.0f;

  const int n_tiles = tiles_to_read(sh, q0, kRows32, kBc32);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBc32;
    __syncthreads();
    for (int i = threadIdx.x; i < kBc32 * D / 4; i += kThreads) {
      const int r = i / (D / 4), c = i % (D / 4);
      const int key = k0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key < sh.T) {
        const int64_t at = row_at(b, key, hk, sh.T, sh.Hkv, D);
        kx = reinterpret_cast<const float4*>(k + at)[c];
        vx = reinterpret_cast<const float4*>(v + at)[c];
      }
      ks[r][c] = kx;
      vs[r][c] = vx;
    }
    __syncthreads();

    float s[kBc32];
    float mx = kMasked;
#pragma unroll
    for (int c = 0; c < kBc32; ++c) {
      float x = 0.0f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) x += dot4(qv[i], ks[c][part + 4 * i]);
      x += __shfl_xor_sync(kFull, x, 1);
      x += __shfl_xor_sync(kFull, x, 2);
      s[c] = visible(sh, row, k0 + c) ? x * sh.scale : kMasked;
      mx = fmaxf(mx, s[c]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    m = mn;
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < kBc32; ++c) {
      s[c] = expf(s[c] - m);
      sum += s[c];
    }
    l = l * alpha + sum;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int c = 0; c < kBc32; ++c) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float4 vv = vs[c][part + 4 * i];
        acc[i].x += s[c] * vv.x;
        acc[i].y += s[c] * vv.y;
        acc[i].z += s[c] * vv.z;
        acc[i].w += s[c] * vv.w;
      }
    }
  }

  if (live) {
    const float d = fmaxf(l, 1e-20f);
    float4* out = reinterpret_cast<float4*>(o + row_at(b, row, h, sh.S,
                                                       sh.Hq, D));
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      out[part + 4 * i] = make_float4(acc[i].x / d, acc[i].y / d,
                                      acc[i].z / d, acc[i].w / d);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, const Shape& sh, int dtype,
                   cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid((sh.S + kRows32 - 1) / kRows32, sh.Hq, batch);
    flash_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sh);
  } else if (dtype == 2) {
    const dim3 grid((sh.S + kBr - 1) / kBr, sh.Hq, batch);
    flash_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), sh);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 2 = bf16.  Needs B, S, T, Hkv >= 1, Hq a multiple of
// Hkv, T >= S when causal, D in {32, 64, 128}, every pointer 16-byte
// aligned.
int fa_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int batch, int s, int t, int hq, int hkv, int d,
                       int causal, int dtype, void* stream) {
  const Shape sh{s, t, hq, hkv, hq / hkv, causal,
                 1.0f / sqrtf(static_cast<float>(d))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, batch, sh, dtype, st);
    case 64:
      return launch<64>(q, k, v, o, batch, sh, dtype, st);
    case 128:
      return launch<128>(q, k, v, o, batch, sh, dtype, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
