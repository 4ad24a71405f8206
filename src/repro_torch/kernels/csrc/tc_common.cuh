// Building blocks shared by the tensor-core attention kernels
// (flash_partial_tc.cu, the forward; flash_partial_bwd_tc.cu, the backward):
// cp.async, ldmatrix and mma.sync m16n8k16 (bf16 operands, fp32
// accumulators) in one fragment layout, the split of an fp32 operand into
// kTerms bf16 terms, and the up-front decision of which KV tiles some query
// row of a block sees.  Each kernel source is its own shared library, so the
// helpers live in an anonymous namespace here.
//
// Two families of kernels use them.  The narrow ones take head dims up to
// kMaxHd = 128 and hold a warp's whole row of o (or dq, dk, dv) in
// registers.  The wide ones take MLA's absorbed heads, hd_k up to
// kWideHdK = 576 and hd_v up to kWideHdV = 512 (deepseek-v3: q_eff and the
// latent [c_kv | k_rope] against v = the latent's first 512 columns): there
// a row of fp32 o alone is 256 registers a thread, so the eight warps of a
// block split the output columns in four quarters and share p (or dS)
// through shared memory (flash_partial_tc.cu, flash_partial_bwd_tc.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxHd = 128;          // largest hd_k and hd_v of the narrow kernels
constexpr int kSteps = kMaxHd / 16;  // 16-column steps of a full head dim
constexpr int kLd = kMaxHd + 8;      // bf16 row stride of every shared tile (272 bytes: ldmatrix is conflict-free)
constexpr int kBlockK = 64;          // KV slots per tile
constexpr int kTerms = 3;            // bf16 terms of a split fp32 operand
constexpr int kWindow = 1024;        // tiles whose visibility one pass decides (a bit mask)
constexpr float kNegInf = -1e30f;
constexpr int kPadPos = 1 << 30;

// the wide kernels (MLA)
constexpr int kWideHdK = 576;             // largest hd_k
constexpr int kWideHdV = 512;             // largest hd_v
constexpr int kWideLd = kWideHdK + 8;     // bf16 row stride of a q / k tile (1168 bytes: 73 16-byte units, odd)
constexpr int kWideLdV = kWideHdV + 8;    // of a v / dO tile (1040 bytes: 65 units)
constexpr int kWideRows = 32;             // query rows of a tile: two row groups of 16
constexpr int kWideBlockK = 32;           // KV slots of a tile: two slot groups of 16, four n-tiles of 8
constexpr int kWideLdP = kWideBlockK + 8; // of a p / dS term tile (80 bytes: 5 units)
constexpr int kWideWarps = 8;             // warp w: group w / 4 of rows (or slots), quarter w % 4 of columns
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideColsK = kWideHdK / 4;  // a quarter of hd_k: 144 columns, 9 steps of 16
constexpr int kWideColsV = kWideHdV / 4;  // a quarter of hd_v: 128 columns, 8 steps of 16

// ---- PTX: cp.async, ldmatrix, mma.sync

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `valid` false zero-fills (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The B fragment of one n-tile (registers {0, 1} of ldsm_x4) from an [N][K]
// tile, at the same lane addresses (lanes 16-31 give none).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a . b for one m16n8k16 tile: bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment addressing (lane = thread in warp).  A fragment of rows m0.. and
// columns k0.. of a row-major [M][K] tile: ldsm_x4 at row m0 + a_row,
// column k0 + a_col.  The B fragments of two n-tiles (n0, n0 + 8) over
// k0..k0 + 15: from an [N][K] tile by ldsm_x4 at row n0 + b_row, column
// k0 + b_col (registers {0, 1} and {2, 3}); from a [K][N] tile by ldsm_x4_t
// at row k0 + t_row, column n0 + t_col.  An m16n8 accumulator holds, in
// lane, rows lane / 4 (registers 0, 1) and lane / 4 + 8 (2, 3) at columns
// 2 (lane % 4) and 2 (lane % 4) + 1.
struct Lanes {
  int a_row, a_col, b_row, b_col, t_row, t_col;
  __device__ __forceinline__ explicit Lanes(int lane)
      : a_row(lane & 15),
        a_col((lane >> 4) * 8),
        b_row((lane & 7) + (lane >> 4) * 8),
        b_col(((lane >> 3) & 1) * 8),
        t_row((lane & 7) + ((lane >> 3) & 1) * 8),
        t_col((lane >> 4) * 8) {}
};

// ---- the split

// Two adjacent fp32 values as kTerms bf16x2 words, largest term first; each
// difference is exact in fp32, so the terms sum to x within 2^-24 |x|.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&t)[kTerms]) {
#pragma unroll
  for (int i = 0; i < kTerms; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    t[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    x0 -= f.x;
    x1 -= f.y;
  }
}

// The split A fragments of one 16-column k-step whose columns 0-7 are the
// accumulator tile c0 and 8-15 the tile c1 (same rows).
__device__ __forceinline__ void acc_to_a(const float (&c0)[4], const float (&c1)[4], uint32_t (&a)[kTerms][4]) {
  uint32_t t[4][kTerms];
  split_pair(c0[0], c0[1], t[0]);
  split_pair(c0[2], c0[3], t[1]);
  split_pair(c1[0], c1[1], t[2]);
  split_pair(c1[2], c1[3], t[3]);
#pragma unroll
  for (int i = 0; i < kTerms; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[i][r] = t[r][i];
}

__device__ __forceinline__ void add_to(float (&acc)[4], const float (&t)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] += t[j];
}

// ---- tiles and masks

// cp.async of a [kRows][hd] bf16 tile into shared memory ([kRows][kStride]):
// row r from row_ptr(r) (nullptr: absent), 16-byte chunks over hd padded to
// a multiple of 16 columns; absent rows and the padding are zero-filled.
template <int kRows, int kThreads, int kStride, typename RowPtr>
__device__ __forceinline__ void load_rows_async(bf16* dst, int hd, const bf16* any, RowPtr row_ptr, int tid) {
  const int chunks = 2 * ((hd + 15) / 16), valid = hd / 8;
  for (int e = tid; e < kRows * chunks; e += kThreads) {
    const int r = e / chunks, c = e % chunks;
    const bf16* src = row_ptr(r);
    const bool ok = src != nullptr && c < valid;
    cp_async16(dst + r * kStride + c * 8, ok ? src + c * 8 : any, ok);
  }
}

// The same into a narrow tile ([kRows][kLd]).
template <int kRows, int kThreads, typename RowPtr>
__device__ __forceinline__ void load_tile_async(bf16* dst, int hd, const bf16* any, RowPtr row_ptr, int tid) {
  load_rows_async<kRows, kThreads, kLd>(dst, hd, any, row_ptr, tid);
}

__device__ __forceinline__ bool visible(int kp, int qp, int qs, int causal) {
  return kp != kPadPos && (!causal || qp >= kp) && kp >= qs;
}

// The kRows rows of a query tile ordered by q_start (ties by index), with the
// running max of their q_pos, for slot_seen; threads tid < kRows take one row
// each.  Padding and dead rows carry q_start = PAD and sort last.
template <int kRows>
__device__ __forceinline__ void sort_rows(const int* row_qpos, const int* row_qstart, int* qs_sorted, int* qp_max,
                                          int tid) {
  if (tid < kRows) {
    const int qs = row_qstart[tid];
    int rank = 0, best = row_qpos[tid];
    for (int j = 0; j < kRows; ++j) {
      const int qs2 = row_qstart[j];
      if (qs2 < qs || (qs2 == qs && j < tid)) {
        ++rank;
        best = max(best, row_qpos[j]);
      }
    }
    qs_sorted[rank] = qs;
    qp_max[rank] = best;
  }
}

// Whether some row of the query tile sees a slot at position kp, from
// sort_rows' output: some row whose window starts at or before kp must reach
// it.  kRows is a power of two.
template <int kRows>
__device__ __forceinline__ bool slot_seen(const int* qs_sorted, const int* qp_max, int kp, int causal) {
  if (kp == kPadPos) return false;
  int n = 0;  // rows with q_start <= kp
#pragma unroll
  for (int step = kRows / 2; step >= 1; step >>= 1)
    if (qs_sorted[n + step - 1] <= kp) n += step;
  n += qs_sorted[n] <= kp;
  return n > 0 && (!causal || qp_max[n - 1] >= kp);
}

// The 16 x 8 accumulator tile of A . B^T over `steps` 16-column k-steps,
// A's 16 rows from shared memory at `a` (this lane's ldsm_x4 address) and
// B's 8 rows at `b` (this lane's ldsm_x2 address), each step 16 columns
// on, as four independent chains summed at the end: a wide head's 36 steps
// would otherwise be one dependent chain.
__device__ __forceinline__ void dot_tile(float (&out)[4], const bf16* a, const bf16* b, int steps) {
  float c[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[u][j] = 0.f;
  int ks = 0;
  for (; ks + 4 <= steps; ks += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t af[4], bf[2];
      ldsm_x4(af, a + (ks + u) * 16);
      ldsm_x2(bf, b + (ks + u) * 16);
      mma(c[u], af, bf[0], bf[1]);
    }
  }
  for (; ks < steps; ++ks) {
    uint32_t af[4], bf[2];
    ldsm_x4(af, a + ks * 16);
    ldsm_x2(bf, b + ks * 16);
    mma(c[0], af, bf[0], bf[1]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = (c[0][j] + c[1][j]) + (c[2][j] + c[3][j]);
}

// Whether v is the view of k's first hd_v columns (MLA's latent: the same
// base and strides), so a wide kernel reads V from K's tile.
template <typename P>
__device__ __forceinline__ bool v_views_k(const P& p) {
  return p.v == p.k && p.v_sb == p.k_sb && p.v_ss == p.k_ss && p.v_sh == p.k_sh;
}

// Writes the fp32 pair (x0, x1) as its kTerms bf16x2 words into kTerms tiles
// of bf16 laid out [term][rows][ld] at element offset `at` of term 0.
template <int kTermStride>
__device__ __forceinline__ void store_split(bf16* base, long long at, float x0, float x1) {
  uint32_t t[kTerms];
  split_pair(x0, x1, t);
#pragma unroll
  for (int i = 0; i < kTerms; ++i) *reinterpret_cast<uint32_t*>(base + i * kTermStride + at) = t[i];
}

}  // namespace
