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
// all contiguous: neither the head repeat nor a transpose is ever
// materialised.  Any S and T (T >= S when causal; T >= 1 in bf16); D is
// a template over {32, 64, 128}, and in f32 also 16 (the reduced
// configurations' head width).
//
// Numerics, as the reference: scores in f32, scaled after the dot,
// masked with -1e30; the running (max, sum, acc) in f32; p rounded to
// v's type before the PV product; o = acc / max(l, 1e-20) in q's type.
// The bf16 path takes its exponentials in base 2 (ex2.approx, what
// exp2f compiles to) with log2(e) folded into the scale: p =
// 2^(s * log2(e) / sqrt(D) - m'), m' the running max of the same
// products.  That moves p by a few f32 ulps of the exponent (about 1e-6
// relative), far below the 2^-9 rounding of p to bf16.
//
// Bound.  2 * 2 * D operations per visible (query, key) pair and head
// (the QK dot and the PV product), against reading q, k, v once and
// writing o once.  At the serving prefill's shape (B = 4, S = T = 4096,
// Hq = 15, Hkv = 5, D = 64, bf16, causal) that is 0.129 TFLOP against
// 21 MB: 0.1303 ms at 989 TFLOP/s dense bf16, twenty times the 0.0063 ms
// the bytes need, so the tensor cores bound it.
//
// Design (bf16).  The Pallas kernel keeps a whole head's K and V in VMEM
// and streams 128-row tiles through the MXU.  Here one block of three
// warpgroups owns 128 query rows of one (batch, query head):
//   * warpgroup 0 is the producer: it gives up registers (setmaxnreg 24)
//     and one of its threads issues every copy.  Q's 128 rows are loaded
//     once by TMA and stay in shared memory; K and V stream through a
//     ring of kStages stages of 128 keys (3 stages at D <= 64, 2 at D 128),
//     each filled by TMA (cp.async.bulk.tensor over rank-4 tensor maps of
//     the [B, L, H, D] tensors, box (min(D, 64), 1, 128, 1), 128-byte
//     swizzle, 64-byte at D 32; D 128 is two 64-column boxes) and
//     completed on a "full" mbarrier armed with expect_tx for the whole
//     box: TMA zero-fills the keys past T and counts them.  The
//     consumers hand a stage back on an "empty" mbarrier.
//   * warpgroups 1 and 2 are the consumers (setmaxnreg 240), 64 query
//     rows each.  S = Q K^T is wgmma m64n128k16 with both operands
//     K-major in shared memory and f32 accumulators; the online softmax
//     runs on wgmma's accumulator layout (four threads share a row and
//     combine their maxima with two shuffles); the f32 probabilities are
//     rounded in place into bf16 A fragments (wgmma's accumulator layout
//     per 8 columns is mma.sync's, so the score registers of two 8-key
//     chunks are one 16-key A fragment) and O += P V is wgmma
//     m64n{D}k16 with A from registers and V from shared memory as an
//     MN-major (transposed) B.  The consumer loop is software-pipelined:
//     it issues tile j + 1's QK product and tile j's PV product together
//     and takes tile j + 1's softmax while the PV product runs.  The loop
//     body has no branch, or ptxas serialises the products (C7514).
//   * the blocks run in order of decreasing key range: the grid is
//     (Hq, B, query blocks) with the last query block first, so the
//     causal blocks with the most tiles start first and the short ones
//     fill the tail.
// Against the mma.sync kernel it replaced (synchronous single-buffered
// 64-key loads; V's B fragments gathered by scalar 16-bit shared loads;
// mma.sync; a mask and expf on every score; ascending query blocks): TMA
// copies run kStages - 1 tiles ahead of the products with no thread
// spending an instruction on them; V is read by the tensor cores through
// the descriptor's transpose, with no shared load by a thread; both
// products are wgmma; the mask is applied only on tiles that cross the
// causal diagonal or T, and exponentials are ex2 with the scale folded
// into one FMA; the longest blocks start first.  The entry point
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().
//
// f32, which only the checks and the reduced configurations use, runs
// the same online softmax on CUDA-core FMAs (tensor cores would round the
// inputs to TF32): four threads share a query row, each holding a
// quarter of its q and accumulator as float4s (D / 16 of them: one at
// D 16, so the four threads hold float4s 0-3 of the row, and a tile row
// of ks/vs is those four), over 32-key tiles with synchronous loads.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;  // f32 block

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

// Tiles of kKeys keys that rows [lo, hi] need (0 when they are all >=
// S): a causal row r sees keys up to r + T - S.
template <int kKeys, class Sh>
__device__ __forceinline__ int tiles_for_rows(const Sh& sh, int lo, int hi) {
  if (lo >= sh.S) return 0;
  int n = (sh.T + kKeys - 1) / kKeys;
  if (sh.causal) {
    const int last = min(sh.T - 1, min(hi, sh.S - 1) + (sh.T - sh.S));
    n = min(n, last / kKeys + 1);
  }
  return n;
}

__device__ __forceinline__ bool visible(const Shape& sh, int row, int key) {
  return key < sh.T && (!sh.causal || key <= row + (sh.T - sh.S));
}

// ---------------------------------------------------------------- bf16 --

constexpr int kBr = 128;         // query rows per block
constexpr int kWgRows = 64;      // query rows per consumer warpgroup
constexpr int kBc = 128;         // keys per K/V tile
constexpr int kThreads16 = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Bf16Config {
  static constexpr int kBox = D < 64 ? D : 64;  // columns of one TMA box
  static constexpr int kRowBytes = 2 * kBox;    // one swizzled row: 64, 128
  static constexpr int kHalves = D / kBox;      // boxes a row of D needs
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kQBytes = kBr * D * 2;
  static constexpr int kTileBytes = kBc * D * 2;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // + the full, empty and Q barriers, + slack to align the base to 1 KB
  static constexpr int kSmemBytes =
      kBarOffset + 8 * (2 * kStages + 1) + 1024;
};

struct Bf16Shape {
  int S, T, group, causal;
  float scale2;  // log2(e) / sqrt(D)
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity ``parity``.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// TMA: the box of ``map`` at (c0, c1, c2, c3) into shared memory at
// ``dst``, completing ``bar``'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed groups are pending
// (groups complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A from registers, B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers, B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 32) {
    wgmma_rs_n32(d, a, db);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// One consumer warpgroup's view of the block: its 64 rows, its lanes.
struct Rows {
  int r0, r1;  // this thread's two rows (r1 = r0 + 8)
  int lo;      // the warpgroup's first row
  int t2;      // this thread's first column pair within an 8-column chunk
};

// Issues S = Q K^T for one tile (D / 16 steps of 16 columns, both
// operands K-major) and commits it as one group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBc / 2], uint32_t q_wg,
                                         uint32_t ks) {
  using C = Bf16Config<D>;
  constexpr uint32_t kSbo = 8 * C::kRowBytes;  // 8 rows: one swizzle atom
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // a 16-column step lies in box kk * 16 / kBox, at byte kk * 32 of its
    // (swizzled) row
    const uint32_t half = kk * 16 / C::kBox, col = (kk * 16 % C::kBox) * 2;
    wgmma_ss_n128(
        s, smem_desc(q_wg + half * kBr * C::kRowBytes + col, 16, kSbo,
                     C::kLayout),
        smem_desc(ks + half * kBc * C::kRowBytes + col, 16, kSbo,
                  C::kLayout),
        kk > 0);
  }
  wgmma_commit();
}

// Issues O += P V for one tile (kBc / 16 steps of 16 keys; V's tile is an
// MN-major B whose D-boxes lie kBc rows apart) and commits it.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[kBc / 16][4],
                                         uint32_t vs) {
  using C = Bf16Config<D>;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBc / 16; ++kk) {
    wgmma_pv<D>(acc, pa[kk],
                smem_desc(vs + kk * 16 * C::kRowBytes, kBc * C::kRowBytes,
                          8 * C::kRowBytes, C::kLayout));
  }
  wgmma_commit();
}

// The online-softmax step of one tile, in place: the raw scores s become
// p = 2^(s * scale2 - m * scale2), the running maxima m (raw units) and
// this thread's sums l move on, and alpha returns the factors that
// rescale each row's earlier accumulator.  The mask applies only on a
// tile that crosses the causal diagonal of these rows or the end of the
// keys.
__device__ __forceinline__ void softmax_tile(float (&s)[kBc / 2],
                                             const Bf16Shape& sh,
                                             const Rows& rw, int k0,
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  const int off = sh.T - sh.S;
  const bool edge = k0 + kBc > sh.T ||
                    (sh.causal && k0 + kBc - 1 > rw.lo + off);
  float mx[2] = {kMasked, kMasked};
#pragma unroll
  for (int c = 0; c < kBc / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (edge) {
        const int key = k0 + 8 * c + rw.t2 + (e & 1);
        const int row = e < 2 ? rw.r0 : rw.r1;
        if (key >= sh.T || (sh.causal && key > row + off)) {
          s[4 * c + e] = kMasked;
        }
      }
      mx[e / 2] = fmaxf(mx[e / 2], s[4 * c + e]);
    }
  }
  float bias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
    const float mn = fmaxf(m[i], mx[i]);
    alpha[i] = ex2((m[i] - mn) * sh.scale2);  // 0 on the first tile
    m[i] = mn;
    bias[i] = mn * sh.scale2;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < kBc / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * c + e] = ex2(fmaf(s[4 * c + e], sh.scale2, -bias[e / 2]));
      sum[e / 2] += s[4 * c + e];
    }
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// p rounded to bf16 A fragments: the scores of 8-key chunks 2kk and
// 2kk + 1 are the A fragment of key slab kk (wgmma's accumulator layout
// per 8 columns is mma.sync's).
__device__ __forceinline__ void to_fragments(const float (&s)[kBc / 2],
                                             uint32_t (&pa)[kBc / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBc / 16; ++kk) {
    pa[kk][0] = pack(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads16, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  __nv_bfloat16* __restrict__ o, Bf16Shape sh) {
  using C = Bf16Config<D>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1 KB: every tile starts on a 1 KB boundary
  const uint32_t q_s =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const uint32_t kv_s = q_s + C::kQBytes;  // stage st: K, then V
  const uint32_t full = q_s + C::kBarOffset;
  const uint32_t empty = full + 8 * C::kStages;
  const uint32_t q_bar = empty + 8 * C::kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBr;  // longest range first
  const int n_tiles = tiles_for_rows<kBc>(sh, q0, q0 + kBr - 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int hk = h / sh.group;
      mbar_expect_tx(q_bar, C::kQBytes);
      for (int half = 0; half < C::kHalves; ++half) {
        tma_load(q_s + half * kBr * C::kRowBytes, &qmap, q_bar,
                 half * C::kBox, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % C::kStages;
        // the n-th fill of a stage waits for the consumers' (n-1)-th
        // release; the first passes on the fresh barrier
        mbar_wait(empty + 8 * st, ((j / C::kStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, C::kStageBytes);
        const uint32_t ks = kv_s + st * C::kStageBytes;
        const uint32_t vs = ks + C::kTileBytes;
        for (int half = 0; half < C::kHalves; ++half) {
          tma_load(ks + half * kBc * C::kRowBytes, &kmap, bar,
                   half * C::kBox, hk, j * kBc, b);
          tma_load(vs + half * kBc * C::kRowBytes, &vmap, bar,
                   half * C::kBox, hk, j * kBc, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int wg = warp / 4 - 1;
    Rows rw;
    rw.lo = q0 + wg * kWgRows;
    rw.r0 = rw.lo + (warp % 4) * 16 + lane / 4;
    rw.r1 = rw.r0 + 8;
    rw.t2 = (lane % 4) * 2;
    const int my_tiles = tiles_for_rows<kBc>(sh, rw.lo, rw.lo + kWgRows - 1);
    const uint32_t q_wg = q_s + wg * kWgRows * C::kRowBytes;

    // s[4c + e]: keys k0 + 8c + t2 + (e & 1) of row r0 (e < 2) or r1;
    // acc[4c + e] likewise for columns 8c + t2 + (e & 1)
    float s[kBc / 2], acc[D / 2];
    uint32_t pa[kBc / 16][4];
#pragma unroll
    for (int i = 0; i < kBc / 2; ++i) s[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};  // running maxima (raw scores)
    float l[2] = {0.0f, 0.0f};            // this thread's share of sums
    float alpha[2];

    // Software pipeline: while the tensor cores run tile j's PV product,
    // the warpgroup takes the softmax of tile j + 1, whose QK product
    // was issued just before.  The loop body has no branch, so that ptxas
    // can follow which product each register belongs to.
    mbar_wait(q_bar, 0);
    if (my_tiles > 0) {
      mbar_wait(full, 0);
      issue_qk<D>(s, q_wg, kv_s);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(s, sh, rw, 0, m, l, alpha);
      to_fragments(s, pa);
    }
    for (int j = 0; j + 1 < my_tiles; ++j) {
      const int st = j % C::kStages, sn = (j + 1) % C::kStages;
      mbar_wait(full + 8 * sn, ((j + 1) / C::kStages) & 1);
      issue_qk<D>(s, q_wg, kv_s + sn * C::kStageBytes);
      issue_pv<D>(acc, pa, kv_s + st * C::kStageBytes + C::kTileBytes);
      wgmma_wait<1>();  // the QK product; the PV product may still run
      fence_regs(s);
      softmax_tile(s, sh, rw, (j + 1) * kBc, m, l, alpha);
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        acc[4 * c] *= alpha[0];
        acc[4 * c + 1] *= alpha[0];
        acc[4 * c + 2] *= alpha[1];
        acc[4 * c + 3] *= alpha[1];
      }
      to_fragments(s, pa);
    }
    if (my_tiles > 0) {
      const int st = (my_tiles - 1) % C::kStages;
      issue_pv<D>(acc, pa, kv_s + st * C::kStageBytes + C::kTileBytes);
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
    // the tile past this warpgroup's diagonal that only the other needs
    for (int j = my_tiles; j < n_tiles; ++j) {
      const int st = j % C::kStages;
      mbar_wait(full + 8 * st, (j / C::kStages) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

    float d[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(kFull, l[i], 1);
      l[i] += __shfl_xor_sync(kFull, l[i], 2);
      d[i] = fmaxf(l[i], 1e-20f);
    }
    const int hq = gridDim.x, t2 = rw.t2;
    if (rw.r0 < sh.S) {
      __nv_bfloat16* out = o + row_at(b, rw.r0, h, sh.S, hq, D);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        *reinterpret_cast<uint32_t*>(out + 8 * c + t2) =
            pack(acc[4 * c] / d[0], acc[4 * c + 1] / d[0]);
      }
    }
    if (rw.r1 < sh.S) {
      __nv_bfloat16* out = o + row_at(b, rw.r1, h, sh.S, hq, D);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        *reinterpret_cast<uint32_t*>(out + 8 * c + t2) =
            pack(acc[4 * c + 2] / d[1], acc[4 * c + 3] / d[1]);
      }
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

  const int n_tiles = tiles_for_rows<kBc32>(sh, q0, q0 + kRows32 - 1);
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

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so
// that the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A rank-4 map over a contiguous bf16 [B, L, H, D] tensor, (D, H, L, B)
// innermost first; box (kBox, 1, rows, 1), swizzled as the wgmma
// descriptors expect, zero-filled out of bounds.
template <int D>
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr,
              int batch, int len, int heads, int rows) {
  using C = Bf16Config<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = 2ull * heads * D;
  const cuuint64_t strides[3] = {2ull * D, row, row * len};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(C::kBox), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                C::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int batch, const Shape& sh, cudaStream_t stream) {
  using C = Bf16Config<D>;
  const int q_blocks = (sh.S + kBr - 1) / kBr;
  if (sh.T < 1 || batch > 65535 || q_blocks > 65535) {
    return cudaErrorInvalidValue;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  if (!make_map<D>(&qm, encode, q, batch, sh.S, sh.Hq, kBr) ||
      !make_map<D>(&km, encode, k, batch, sh.T, sh.Hkv, kBc) ||
      !make_map<D>(&vm, encode, v, batch, sh.T, sh.Hkv, kBc)) {
    return cudaErrorInvalidValue;
  }
  // above 48 KB of dynamic shared memory: set on every launch, as the
  // attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const Bf16Shape bs{sh.S, sh.T, sh.group, sh.causal,
                     kLog2e / sqrtf(static_cast<float>(D))};
  const dim3 grid(sh.Hq, batch, q_blocks);
  flash_bf16_kernel<D><<<grid, kThreads16, C::kSmemBytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), bs);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int batch, const Shape& sh, cudaStream_t stream) {
  const dim3 grid((sh.S + kRows32 - 1) / kRows32, sh.Hq, batch);
  flash_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sh);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, const Shape& sh, int dtype,
                   cudaStream_t stream) {
  if (dtype == 2) return launch_bf16<D>(q, k, v, o, batch, sh, stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  return launch_f32<D>(q, k, v, o, batch, sh, stream);
}

template <int D>
void bf16_config(int* out) {
  using C = Bf16Config<D>;
  out[0] = C::kStages;
  out[1] = kBr;
  out[2] = kBc;
  out[3] = C::kSmemBytes;
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 2 = bf16.  Needs B, S, T, Hkv >= 1, Hq a multiple of
// Hkv, T >= S when causal, D in {32, 64, 128} (f32 also 16), every
// pointer 16-byte aligned; bf16 also needs B and ceil(S / 128) <= 65535.
int fa_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int batch, int s, int t, int hq, int hkv, int d,
                       int causal, int dtype, void* stream) {
  const Shape sh{s, t, hq, hkv, hq / hkv, causal,
                 1.0f / sqrtf(static_cast<float>(d))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:  // f32 only: a 32-byte bf16 row needs a TMA swizzle of its own
      return dtype == 0 ? launch_f32<16>(q, k, v, o, batch, sh, st)
                        : static_cast<int>(cudaErrorInvalidValue);
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

// The bf16 instantiation for head dim d: out = {pipeline stages, query
// rows per block, keys per tile, dynamic shared memory bytes}.
int fa_bf16_config(int d, int* out) {
  switch (d) {
    case 32:
      bf16_config<32>(out);
      return 0;
    case 64:
      bf16_config<64>(out);
      return 0;
    case 128:
      bf16_config<128>(out);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
