// Partial flash attention, backward, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU backward kernels of
// src/repro/kernels/flash_attention.py: `_flash_bwd_dq_kernel` (pallas_call at
// line 331) and `_flash_bwd_dkv_kernel` (pallas_call at line 355), with their
// shared block math `_recompute_p_ds`.  Given the cotangents (dO, dl) of the
// forward's un-normalized (o, l) and its saved row max m (gradient-frozen: no
// dm), both recompute p = exp(s - m) per score tile and form
// dS = p * (dO . v^T + dl); there is no D = rowsum(dO * O) term, since (o, l)
// are un-normalized.  Visibility is the forward's: kv_pos != 2**30,
// q_pos >= kv_pos when causal, kv_pos >= q_start.  Rows whose m is -1e30
// (fully masked) have o = l = 0 whatever the inputs; their cotangents may be
// inf or NaN, so dO and dl are read as zeros there, and such rows add exactly
// nothing.
//
// - dq kernel: one block per (query tile, KV head, batch row), the forward's
//   row layout (the G query heads of a KV head in the block's rows: row r =
//   token q0 + r / G, head kvh * G + r % G; 16, 32 or 64 rows), looping over
//   the KV tiles with the next tile's 16-byte K/V loads in flight:
//   dq = scale * sum_kv dS . k, accumulated in fp32 registers.
// - dk/dv kernel: one block per (64-slot KV tile, KV head, batch row), looping
//   over the query tiles: dv = sum_q p^T . dO and dk = scale * sum_q dS^T . q.
//   The G heads of the KV head are rows of the same tiles, so the sum over
//   them is part of the row reduction: no atomics, no second pass.
// Both kernels skip a (query tile, KV tile) pair in which no query sees any
// slot (the causal upper triangle, PAD slots, q_start windows): such a pair
// contributes exact zeros.
//
// What bounds them on an H100: the five products per visible score tile
// (s = q.k^T, dp = dO.v^T, dq, dk, dv: 2.5x the forward's operations), at
// every shape the training path gives them (query tiles of thousands of rows
// against thousands of slots), so operations.  These kernels compute in
// fp32 on the CUDA cores, as the forward kernel does (inputs upcast into
// shared memory, 16-byte loads), which holds fp32 inputs within 1e-5 of the
// plain version; their ceiling is the fp32 FMA rate, far below the bf16
// tensor-core peak the bound uses.  They serve fp32 inputs; bf16 inputs take
// the tensor-core kernels of flash_partial_bwd_tc.cu (these run bf16 only
// when the caller asks, to compare the two).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (kernels/flash_attention.py does this at first use).  Plain C interface,
// called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // 16 x 16 thread grid (ty, tx)
constexpr int kBlockK = 64;        // KV slots per tile
constexpr int kMaxHd = 128;        // largest hd_k and hd_v
constexpr int kLd = kMaxHd + 4;    // row stride of the Q, dO, K and V tiles
constexpr int kLdP = kBlockK + 4;  // row stride of the p / dS tiles
constexpr float kNegInf = -1e30f;
constexpr int kPadPos = 1 << 30;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* dout;   // [B, Tq, H, hdv] contiguous
  const float* m;      // [B, Tq, H] contiguous
  const float* dl;     // [B, Tq, H] contiguous
  const int* q_pos;    // [B, Tq], or [Tq] with batch stride 0
  const int* kv_pos;   // [S]
  const int* q_start;  // [B, Tq] or [Tq]; null: no window
  float* dq;           // [B, Tq, H, hdk] contiguous
  float* dk;           // [B, S, Hkv, hdk] contiguous
  float* dv;           // [B, S, Hkv, hdv] contiguous
  int B, Tq, S, H, Hkv, hdk, hdv, bq, qpos_sb, qstart_sb;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ void store_vec(float* out, const uint4& raw) {
  constexpr int kW = 16 / static_cast<int>(sizeof(T));
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int w = 0; w < kW; w += 4)
    *reinterpret_cast<float4*>(out + w) =
        make_float4(to_float(vals[w]), to_float(vals[w + 1]), to_float(vals[w + 2]), to_float(vals[w + 3]));
}

// One tile of kRows rows x kMaxHd columns held in registers between its
// global load and its store into shared memory as fp32.  Each thread owns
// kItems 16-byte vectors of kW consecutive elements of one row.  Row r sits
// at base + row_offset(r); rows the caller marks absent and columns past hd
// read as zeros.
template <typename T, int kRows>
struct Tile {
  static constexpr int kW = 16 / static_cast<int>(sizeof(T));
  static constexpr int kPerRow = kMaxHd / kW;
  static constexpr int kItems = kRows * kPerRow / kThreads;
  uint4 raw[kItems];

  // KV rows kv0 + j of a [S, hd] slab with row stride `row_stride`.
  __device__ __forceinline__ void load_kv(const T* base, long long row_stride, int S, int hd, int kv0, int tid) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int e = tid + it * kThreads;
      const int j = e / kPerRow, d0 = (e % kPerRow) * kW;
      const int s = kv0 + j;
      raw[it] = (s < S && d0 < hd) ? *reinterpret_cast<const uint4*>(base + s * row_stride + d0)
                                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // Query-side rows of the block layout: row r = token q0 + r / G, head
  // kvh * G + r % G; only rows r < nrows with live[r] are read.
  __device__ __forceinline__ void load_rows(const T* base, long long st, long long sh, int hd, int q0, int kvh,
                                            int G, int nrows, const float* row_m, int tid) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int e = tid + it * kThreads;
      const int r = e / kPerRow, d0 = (e % kPerRow) * kW;
      raw[it] = make_uint4(0u, 0u, 0u, 0u);
      if (r < nrows && d0 < hd && row_m[r] > kNegInf / 2) {
        const int t = q0 + r / G, h = kvh * G + r % G;
        raw[it] = *reinterpret_cast<const uint4*>(base + t * st + h * sh + d0);
      }
    }
  }

  __device__ __forceinline__ void store(float* dst, int tid) const {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int e = tid + it * kThreads;
      store_vec<T>(dst + (e / kPerRow) * kLd + (e % kPerRow) * kW, raw[it]);
    }
  }
};

__device__ __forceinline__ bool visible(int kp, int qp, int qs, int causal) {
  return kp != kPadPos && (!causal || qp >= kp) && kp >= qs;
}

// Per-row state of a query tile in shared memory: positions, the saved max
// and dl (zero on dead rows: m = -1e30).  Block-padding rows are dead
// (q_start = PAD, m = -1e30).
__device__ __forceinline__ void load_row_state(const Params& p, int b, int kvh, int G, int q0, int nrows, int n,
                                               int* row_qpos, int* row_qstart, float* row_m, float* row_dl,
                                               int tid) {
  for (int r = tid; r < n; r += kThreads) {
    int qp = -1, qs = kPadPos;
    float mr = kNegInf, dr = 0.f;
    if (r < nrows) {
      const int t = q0 + r / G, h = kvh * G + r % G;
      const long long idx = (static_cast<long long>(b) * p.Tq + t) * p.H + h;
      qp = p.q_pos[b * p.qpos_sb + t];
      qs = p.q_start != nullptr ? p.q_start[b * p.qstart_sb + t] : 0;
      mr = p.m[idx];
      dr = mr > kNegInf / 2 ? p.dl[idx] : 0.f;
    }
    row_qpos[r] = qp;
    row_qstart[r] = qs;
    row_m[r] = mr;
    row_dl[r] = dr;
  }
}

// True on every thread when some live row of the tile sees some slot of the
// 64-slot KV tile whose positions are `col` (shared or global memory).
template <int kRows>
__device__ __forceinline__ bool tile_visible(const int* col, int kv0, int S, const int* row_qpos,
                                             const int* row_qstart, int nrows, int causal, int tid) {
  bool any = false;
#pragma unroll 4
  for (int e = tid; e < kRows * kBlockK; e += kThreads) {
    const int r = e / kBlockK, j = e % kBlockK;
    if (r < nrows && kv0 + j < S) any |= visible(col[j], row_qpos[r], row_qstart[r], causal);
  }
  return __syncthreads_or(any) != 0;
}

// p = exp(s - m) and dS = p * (dO . v^T + dl) for rows ty + 16 i and columns
// tx + 16 c of the score tile, from fp32 tiles in shared memory (Q and dO:
// [rows][kLd]; K and V: [64][kLd]).  Writes p to Ps (if non-null) and dS to
// Ds.  Rows that are dead or past nrows, and masked pairs, get exact zeros.
template <int kRowGroups>
__device__ __forceinline__ void score_tile(const Params& p, const float* Qs, const float* dOs, const float* Ks,
                                           const float* Vs, const int* col_pos, const int* row_qpos,
                                           const int* row_qstart, const float* row_m, const float* row_dl,
                                           float* Ps, float* Ds, int ty, int tx) {
  float sc[kRowGroups][4], dp[kRowGroups][4];
#pragma unroll
  for (int i = 0; i < kRowGroups; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[i][c] = dp[i][c] = 0.f;
  const int hdk4 = (p.hdk + 3) & ~3, hdv4 = (p.hdv + 3) & ~3;  // tiles are zero past hd
#pragma unroll 2
  for (int d = 0; d < hdk4; d += 4) {
    float4 a[kRowGroups], kb[4];
#pragma unroll
    for (int i = 0; i < kRowGroups; ++i) a[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * kLd + d]);
#pragma unroll
    for (int c = 0; c < 4; ++c) kb[c] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * c) * kLd + d]);
#pragma unroll
    for (int i = 0; i < kRowGroups; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = sc[i][c];
        s = fmaf(a[i].x, kb[c].x, s);
        s = fmaf(a[i].y, kb[c].y, s);
        s = fmaf(a[i].z, kb[c].z, s);
        sc[i][c] = fmaf(a[i].w, kb[c].w, s);
      }
  }
#pragma unroll 2
  for (int d = 0; d < hdv4; d += 4) {
    float4 a[kRowGroups], vb[4];
#pragma unroll
    for (int i = 0; i < kRowGroups; ++i) a[i] = *reinterpret_cast<const float4*>(&dOs[(ty + 16 * i) * kLd + d]);
#pragma unroll
    for (int c = 0; c < 4; ++c) vb[c] = *reinterpret_cast<const float4*>(&Vs[(tx + 16 * c) * kLd + d]);
#pragma unroll
    for (int i = 0; i < kRowGroups; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = dp[i][c];
        s = fmaf(a[i].x, vb[c].x, s);
        s = fmaf(a[i].y, vb[c].y, s);
        s = fmaf(a[i].z, vb[c].z, s);
        dp[i][c] = fmaf(a[i].w, vb[c].w, s);
      }
  }
#pragma unroll
  for (int i = 0; i < kRowGroups; ++i) {
    const int r = ty + 16 * i;
    const float mr = row_m[r];
    const bool live = mr > kNegInf / 2;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const bool vis = live && visible(col_pos[j], row_qpos[r], row_qstart[r], p.causal);
      const float pr = vis ? expf(sc[i][c] * p.scale - mr) : 0.f;
      if (Ps != nullptr) Ps[r * kLdP + j] = pr;
      Ds[r * kLdP + j] = pr * (dp[i][c] + row_dl[r]);
    }
  }
}

template <int kRowGroups>
constexpr size_t dq_smem_bytes() {
  constexpr int rows = 16 * kRowGroups;
  return sizeof(float) * (2 * size_t(rows) * kLd       // Q, dO tiles
                          + 2 * size_t(kBlockK) * kLd  // K, V tiles
                          + size_t(rows) * kLdP        // dS tile
                          + 2 * rows)                  // row m, dl
         + sizeof(int) * (2 * rows + kBlockK);         // row positions, tile positions
}

template <typename T, int kRowGroups>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  constexpr int kRows = 16 * kRowGroups;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kRows * kLd;
  float* Ks = dOs + kRows * kLd;
  float* Vs = Ks + kBlockK * kLd;
  float* Ds = Vs + kBlockK * kLd;
  float* row_m = Ds + kRows * kLdP;
  float* row_dl = row_m + kRows;
  int* row_qpos = reinterpret_cast<int*>(row_dl + kRows);
  int* row_qstart = row_qpos + kRows;
  int* col_pos = row_qstart + kRows;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = p.H / p.Hkv;
  const int q0 = blockIdx.x * p.bq;
  const int nrows = G * min(p.bq, p.Tq - q0);
  const bool warp_live = 2 * warp < nrows;  // the warp's rows are ty + 16 i, ty in {2 warp, 2 warp + 1}
  const int n_tiles = (p.S + kBlockK - 1) / kBlockK;

  const T* kbase = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vbase = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  load_row_state(p, b, kvh, G, q0, nrows, kRows, row_qpos, row_qstart, row_m, row_dl, tid);
  __syncthreads();
  {
    Tile<T, kRows> qt;
    Tile<float, kRows> dt;
    qt.load_rows(static_cast<const T*>(p.q) + b * p.q_sb, p.q_st, p.q_sh, p.hdk, q0, kvh, G, nrows, row_m, tid);
    dt.load_rows(p.dout + static_cast<long long>(b) * p.Tq * p.H * p.hdv, static_cast<long long>(p.H) * p.hdv,
                 p.hdv, p.hdv, q0, kvh, G, nrows, row_m, tid);
    qt.store(Qs, tid);
    dt.store(dOs, tid);
  }

  // The next KV tile that some row of the block sees, from `tile` on.
  auto next_visible = [&](int tile) {
    for (; tile < n_tiles; ++tile)
      if (tile_visible<kRows>(p.kv_pos + tile * kBlockK, tile * kBlockK, p.S, row_qpos, row_qstart, nrows,
                              p.causal, tid))
        break;
    return tile;
  };

  Tile<T, kBlockK> kload, vload;
  int kp_next = kPadPos;
  int tile = next_visible(0);
  if (tile < n_tiles) {
    kload.load_kv(kbase, p.k_ss, p.S, p.hdk, tile * kBlockK, tid);
    vload.load_kv(vbase, p.v_ss, p.S, p.hdv, tile * kBlockK, tid);
    const int s = tile * kBlockK + tid;
    if (tid < kBlockK && s < p.S) kp_next = p.kv_pos[s];
  }

  float acc[kRowGroups][8];  // rows ty + 16 i; cols tx*4 + c and 64 + tx*4 + c
#pragma unroll
  for (int i = 0; i < kRowGroups; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  while (tile < n_tiles) {
    __syncthreads();  // the previous tile's readers are done
    kload.store(Ks, tid);
    vload.store(Vs, tid);
    if (tid < kBlockK) col_pos[tid] = kp_next;
    __syncthreads();
    const int next = next_visible(tile + 1);
    if (next < n_tiles) {  // the next tile's loads overlap this tile's math
      const int kv1 = next * kBlockK;
      kload.load_kv(kbase, p.k_ss, p.S, p.hdk, kv1, tid);
      vload.load_kv(vbase, p.v_ss, p.S, p.hdv, kv1, tid);
      kp_next = (tid < kBlockK && kv1 + tid < p.S) ? p.kv_pos[kv1 + tid] : kPadPos;
    }
    if (warp_live)
      score_tile<kRowGroups>(p, Qs, dOs, Ks, Vs, col_pos, row_qpos, row_qstart, row_m, row_dl, nullptr, Ds, ty, tx);
    __syncthreads();

    // acc += dS K (rows past nrows hold garbage and are never stored)
    if (warp_live) {
#pragma unroll 2
      for (int j = 0; j < kBlockK; j += 4) {
        float4 da[kRowGroups];
#pragma unroll
        for (int i = 0; i < kRowGroups; ++i) da[i] = *reinterpret_cast<const float4*>(&Ds[(ty + 16 * i) * kLdP + j]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 k0 = *reinterpret_cast<const float4*>(&Ks[(j + jj) * kLd + tx * 4]);
          const float4 k1 = *reinterpret_cast<const float4*>(&Ks[(j + jj) * kLd + 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < kRowGroups; ++i) {
            const float dsv = jj == 0 ? da[i].x : jj == 1 ? da[i].y : jj == 2 ? da[i].z : da[i].w;
            acc[i][0] = fmaf(dsv, k0.x, acc[i][0]);
            acc[i][1] = fmaf(dsv, k0.y, acc[i][1]);
            acc[i][2] = fmaf(dsv, k0.z, acc[i][2]);
            acc[i][3] = fmaf(dsv, k0.w, acc[i][3]);
            acc[i][4] = fmaf(dsv, k1.x, acc[i][4]);
            acc[i][5] = fmaf(dsv, k1.y, acc[i][5]);
            acc[i][6] = fmaf(dsv, k1.z, acc[i][6]);
            acc[i][7] = fmaf(dsv, k1.w, acc[i][7]);
          }
        }
      }
    }
    tile = next;
  }

#pragma unroll
  for (int i = 0; i < kRowGroups; ++i) {
    const int r = ty + 16 * i;
    if (r < nrows) {
      const int t = q0 + r / G, h = kvh * G + r % G;
      float* row = p.dq + ((static_cast<long long>(b) * p.Tq + t) * p.H + h) * p.hdk;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = (c < 4 ? 0 : 64) + tx * 4 + (c & 3);
        if (col < p.hdk) row[col] = acc[i][c] * p.scale;
      }
    }
  }
}

template <int kRowGroups>
constexpr size_t dkv_smem_bytes() {
  constexpr int rows = 16 * kRowGroups;
  return sizeof(float) * (2 * size_t(kBlockK) * kLd  // K, V tiles
                          + 2 * size_t(rows) * kLd   // Q, dO tiles
                          + 2 * size_t(rows) * kLdP  // p, dS tiles
                          + 2 * rows)                // row m, dl
         + sizeof(int) * (2 * rows + kBlockK);       // row positions, tile positions
}

template <typename T, int kRowGroups>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Params p) {
  constexpr int kRows = 16 * kRowGroups;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlockK * kLd;
  float* Qs = Vs + kBlockK * kLd;
  float* dOs = Qs + kRows * kLd;
  float* Ps = dOs + kRows * kLd;
  float* Ds = Ps + kRows * kLdP;
  float* row_m = Ds + kRows * kLdP;
  float* row_dl = row_m + kRows;
  int* row_qpos = reinterpret_cast<int*>(row_dl + kRows);
  int* row_qstart = row_qpos + kRows;
  int* col_pos = row_qstart + kRows;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = p.H / p.Hkv;
  const int kv0 = blockIdx.x * kBlockK;
  const int n_qtiles = (p.Tq + p.bq - 1) / p.bq;

  {
    Tile<T, kBlockK> kt, vt;
    kt.load_kv(static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh, p.k_ss, p.S, p.hdk, kv0, tid);
    vt.load_kv(static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh, p.v_ss, p.S, p.hdv, kv0, tid);
    kt.store(Ks, tid);
    vt.store(Vs, tid);
  }
  if (tid < kBlockK) col_pos[tid] = kv0 + tid < p.S ? p.kv_pos[kv0 + tid] : kPadPos;

  float dk[4][8], dv[4][8];  // KV rows ty + 16 i; cols tx*4 + c and 64 + tx*4 + c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk[i][c] = dv[i][c] = 0.f;

  const T* qbase = static_cast<const T*>(p.q) + b * p.q_sb;
  const float* dobase = p.dout + static_cast<long long>(b) * p.Tq * p.H * p.hdv;
  for (int qt = 0; qt < n_qtiles; ++qt) {
    const int q0 = qt * p.bq;
    const int nrows = G * min(p.bq, p.Tq - q0);
    __syncthreads();  // the previous tile's readers are done
    load_row_state(p, b, kvh, G, q0, nrows, kRows, row_qpos, row_qstart, row_m, row_dl, tid);
    __syncthreads();
    if (!tile_visible<kRows>(col_pos, kv0, p.S, row_qpos, row_qstart, nrows, p.causal, tid)) continue;
    {
      Tile<T, kRows> qtile;
      Tile<float, kRows> dtile;
      qtile.load_rows(qbase, p.q_st, p.q_sh, p.hdk, q0, kvh, G, nrows, row_m, tid);
      dtile.load_rows(dobase, static_cast<long long>(p.H) * p.hdv, p.hdv, p.hdv, q0, kvh, G, nrows, row_m, tid);
      qtile.store(Qs, tid);
      dtile.store(dOs, tid);
    }
    __syncthreads();
    if (2 * warp < nrows)
      score_tile<kRowGroups>(p, Qs, dOs, Ks, Vs, col_pos, row_qpos, row_qstart, row_m, row_dl, Ps, Ds, ty, tx);
    __syncthreads();

    // dv += p^T dO and dk += dS^T Q over the tile's live rows (rows past
    // nrows were not written this tile: never read)
    for (int r = 0; r < nrows; ++r) {
      const float4 o0 = *reinterpret_cast<const float4*>(&dOs[r * kLd + tx * 4]);
      const float4 o1 = *reinterpret_cast<const float4*>(&dOs[r * kLd + 64 + tx * 4]);
      const float4 a0 = *reinterpret_cast<const float4*>(&Qs[r * kLd + tx * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Qs[r * kLd + 64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = Ps[r * kLdP + ty + 16 * i];
        const float dsv = Ds[r * kLdP + ty + 16 * i];
        dv[i][0] = fmaf(pv, o0.x, dv[i][0]);
        dv[i][1] = fmaf(pv, o0.y, dv[i][1]);
        dv[i][2] = fmaf(pv, o0.z, dv[i][2]);
        dv[i][3] = fmaf(pv, o0.w, dv[i][3]);
        dv[i][4] = fmaf(pv, o1.x, dv[i][4]);
        dv[i][5] = fmaf(pv, o1.y, dv[i][5]);
        dv[i][6] = fmaf(pv, o1.z, dv[i][6]);
        dv[i][7] = fmaf(pv, o1.w, dv[i][7]);
        dk[i][0] = fmaf(dsv, a0.x, dk[i][0]);
        dk[i][1] = fmaf(dsv, a0.y, dk[i][1]);
        dk[i][2] = fmaf(dsv, a0.z, dk[i][2]);
        dk[i][3] = fmaf(dsv, a0.w, dk[i][3]);
        dk[i][4] = fmaf(dsv, a1.x, dk[i][4]);
        dk[i][5] = fmaf(dsv, a1.y, dk[i][5]);
        dk[i][6] = fmaf(dsv, a1.z, dk[i][6]);
        dk[i][7] = fmaf(dsv, a1.w, dk[i][7]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = kv0 + ty + 16 * i;
    if (s < p.S) {
      const long long row = (static_cast<long long>(b) * p.S + s) * p.Hkv + kvh;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = (c < 4 ? 0 : 64) + tx * 4 + (c & 3);
        if (col < p.hdk) p.dk[row * p.hdk + col] = dk[i][c] * p.scale;
        if (col < p.hdv) p.dv[row * p.hdv + col] = dv[i][c];
      }
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  configured = e == cudaSuccess;
  return e;
}

template <typename T, int kRowGroups>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<kRowGroups>();
  static bool configured = false;  // one attribute call per instantiation
  const cudaError_t e = set_smem(flash_bwd_dq_kernel<T, kRowGroups>, smem, configured);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Tq + p.bq - 1) / p.bq, p.Hkv, p.B);
  flash_bwd_dq_kernel<T, kRowGroups><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int kRowGroups>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<kRowGroups>();
  static bool configured = false;
  const cudaError_t e = set_smem(flash_bwd_dkv_kernel<T, kRowGroups>, smem, configured);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.S + kBlockK - 1) / kBlockK, p.Hkv, p.B);
  flash_bwd_dkv_kernel<T, kRowGroups><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int kRowGroups>
cudaError_t launch(const Params& p, int which, cudaStream_t stream) {
  return which == 0 ? launch_dq<T, kRowGroups>(p, stream) : launch_dkv<T, kRowGroups>(p, stream);
}

template <typename T>
cudaError_t dispatch(const Params& p, int which, int row_groups, cudaStream_t stream) {
  switch (row_groups) {
    case 1: return launch<T, 1>(p, which, stream);
    case 2: return launch<T, 2>(p, which, stream);
    case 4: return launch<T, 4>(p, which, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// which: 0 = the dq kernel (writes dq), 1 = the dk/dv kernel (writes dk, dv).
// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it).  Strides are in
// elements.  dout [B, Tq, H, hdv], m and dl [B, Tq, H] are contiguous fp32;
// dq [B, Tq, H, hdk], dk [B, S, Hkv, hdk] and dv [B, S, Hkv, hdv] are
// contiguous fp32 outputs, every element written.  q_pos and q_start are
// int32 rows of Tq with batch strides qpos_sb / qstart_sb (0: shared by the
// batch); q_start may be null.  The caller's geometry (the forward's
// kernels/flash_attention.py::_geometry without splits): row_groups (1, 2, 4)
// of 16 rows, bq tokens per query tile.  Q, K and V are loaded in 16-byte
// vectors: their bases, strides and head dims must be whole vectors.
// Returns a cudaError_t.
extern "C" int flash_partial_bwd(int which, int dtype, const void* q, const void* k, const void* v,
                                 const float* dout, const float* m, const float* dl, const int* q_pos,
                                 const int* kv_pos, const int* q_start, float* dq, float* dk, float* dv, int B,
                                 int Tq, int S, int H, int Hkv, int hdk, int hdv, int row_groups, int bq,
                                 int qpos_sb, int qstart_sb, long long q_sb, long long q_st, long long q_sh,
                                 long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                 long long v_sh, float scale, int causal, void* stream) {
  if (which < 0 || which > 1 || B <= 0 || Tq <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || bq <= 0 ||
      hdk <= 0 || hdk > kMaxHd || hdv <= 0 || hdv > kMaxHd || (H / Hkv) * bq > 16 * row_groups ||
      (which == 0 && dq == nullptr) || (which == 1 && (dk == nullptr || dv == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long vec = dtype == 0 ? 4 : 8;  // elements per 16-byte load
  if (reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16 || reinterpret_cast<uintptr_t>(dout) % 16 || hdk % vec ||
      hdv % vec || q_sb % vec || q_st % vec || q_sh % vec || k_sb % vec || k_ss % vec || k_sh % vec ||
      v_sb % vec || v_ss % vec || v_sh % vec)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Params p{q,  k,  v,  dout, m,  dl,   q_pos, kv_pos, q_start, dq,   dk,   dv,   B,     Tq,
                 S,  H,  Hkv, hdk, hdv, bq,  qpos_sb, qstart_sb, q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                 v_sb, v_ss, v_sh, scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) e = dispatch<float>(p, which, row_groups, s);
  if (dtype == 1) e = dispatch<__nv_bfloat16>(p, which, row_groups, s);
  return static_cast<int>(e);
}
