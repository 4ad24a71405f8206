// Partial flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_partial_kernel` / `_fwd_impl` in
// src/repro/kernels/flash_attention.py (pallas_call at line 260).  It computes
// what that kernel computes: for each query row the masked scores
// s = q.k^T * scale, an online max and sum over KV tiles, and the
// *un-normalized* fp32 triple (o, m, l), so partials over KV shards merge
// exactly.  A KV slot is visible when kv_pos != 2**30, q_pos >= kv_pos (when
// causal) and kv_pos >= q_start.  Fully masked rows return o = l = 0 and
// m = -1e30 exactly (the `safe` guard below).
//
// Layout: one thread block per (query tile, KV split, KV head, batch row).
// The G query heads that share a KV head sit in the block's rows (row r =
// token q0 + r / G, head kvh * G + r % G), so each K/V tile is read from
// device memory once per group; CUDA needs no power-of-two row count, so
// G = 7 (qwen2-7b) wastes at most G - 1 rows.  The block holds 16, 32 or 64
// rows (kRowGroups = 1, 2, 4), the fewest that fit G x Tq, so a decode step
// (Tq = 1) does not compute 64 rows for 7 live ones.  K and V may be strided
// views of a larger cache (prefill attends a prefix of the cache buffer): the
// caller passes element strides; the last dim must be contiguous.
//
// What bounds it on an H100: at decode the kernel must read K and V of the
// whole cache buffer, so device-memory bytes bound it; at a prefill chunk the
// 4.B.Tq.S.H.hd operations bound it.  What the design does about each:
// - bytes: K/V tiles are fetched with 16-byte loads (K/V whose base, head
//   dim or strides are not whole 16-byte vectors are refused), and the next
//   tile's loads are issued into registers before the current tile is
//   computed, so their latency hides behind the arithmetic; when
//   (query tiles x KV heads x batch) blocks would leave most of the 132 SMs
//   idle (decode: 16 blocks), the KV range is split over up to 32 blocks per
//   group and a second small kernel merges the partials (flash-decoding);
// - operations: this version computes in fp32 on the CUDA cores (inputs
//   upcast into shared memory, register tiles fed by 16-byte shared loads),
//   which keeps fp32 inputs within 1e-5 of the reference and needs no
//   tensor-core layout.  Its ceiling is the fp32 FMA rate, well below the
//   bf16 tensor-core peak the bound uses; wgmma and TMA are the next step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (kernels/flash_attention.py does this at first use).  Plain C interface,
// called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;       // 16 x 16 thread grid (ty, tx)
constexpr int kBlockK = 64;         // KV slots per tile
constexpr int kMaxHd = 128;         // largest hd_k and hd_v
constexpr int kLd = kMaxHd + 4;     // row stride of the Q and K tiles (16-byte rows, no bank conflicts)
constexpr int kLdP = kBlockK + 4;   // row stride of the score tile
constexpr int kMaxSplits = 32;      // the merge keeps one split weight per lane
constexpr float kNegInf = -1e30f;
constexpr int kPadPos = 1 << 30;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;    // [B, Tq], or [Tq] with batch stride 0
  const int* kv_pos;   // [S]
  const int* q_start;  // [B, Tq] or [Tq]; null: no window (all zeros)
  float* o;            // [nsplit, B, Tq, H, hdv] (nsplit = 1: the output itself)
  float* m;            // [nsplit, B, Tq, H]
  float* l;            // [nsplit, B, Tq, H]
  int B, Tq, S, H, Hkv, hdk, hdv, bq, nsplit, tiles_per_split, qpos_sb, qstart_sb;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// One KV tile (kBlockK rows x kMaxHd columns) of K or V, held in registers
// between its global load and its store into shared memory.  Each thread
// owns kItems 16-byte vectors of kW consecutive elements of one row.
template <typename T>
struct TileLoader {
  static constexpr int kW = 16 / static_cast<int>(sizeof(T));
  static constexpr int kPerRow = kMaxHd / kW;
  static constexpr int kItems = kBlockK * kPerRow / kThreads;
  uint4 raw[kItems];

  __device__ __forceinline__ void load(const T* base, long long row_stride, int S, int hd, int kv0, int tid) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int e = tid + it * kThreads;
      const int j = e / kPerRow, d0 = (e % kPerRow) * kW;
      const int s = kv0 + j;
      raw[it] = (s < S && d0 < hd) ? *reinterpret_cast<const uint4*>(base + s * row_stride + d0) : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(float* dst, int ld, int tid) const {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int e = tid + it * kThreads;
      const int j = e / kPerRow, d0 = (e % kPerRow) * kW;
      const T* vals = reinterpret_cast<const T*>(&raw[it]);
      float* out = dst + j * ld + d0;
#pragma unroll
      for (int w = 0; w < kW; w += 4)
        *reinterpret_cast<float4*>(out + w) =
            make_float4(to_float(vals[w]), to_float(vals[w + 1]), to_float(vals[w + 2]), to_float(vals[w + 3]));
    }
  }
};

template <int kRowGroups>
constexpr size_t smem_bytes() {
  constexpr int rows = 16 * kRowGroups;
  return sizeof(float) * (size_t(rows) * kLd          // Q tile
                          + size_t(kBlockK) * kLd     // K tile
                          + size_t(kBlockK) * kMaxHd  // V tile
                          + size_t(rows) * kLdP       // scores / probabilities
                          + 3 * rows)                 // running m, l, rescale
         + sizeof(int) * (2 * rows + kBlockK);        // row positions, tile positions
}

template <typename T, int kRowGroups>
__global__ void __launch_bounds__(kThreads) flash_partial_fwd_kernel(const Params p) {
  constexpr int kRows = 16 * kRowGroups;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kRows * kLd;
  float* Vs = Ks + kBlockK * kLd;
  float* Ps = Vs + kBlockK * kMaxHd;
  float* row_m = Ps + kRows * kLdP;
  float* row_l = row_m + kRows;
  float* row_alpha = row_l + kRows;
  int* row_qpos = reinterpret_cast<int*>(row_alpha + kRows);
  int* row_qstart = row_qpos + kRows;
  int* col_pos = row_qstart + kRows;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int qtile = blockIdx.x / p.nsplit, split = blockIdx.x % p.nsplit;
  const int G = p.H / p.Hkv;
  const int q0 = qtile * p.bq;
  const int nrows = G * min(p.bq, p.Tq - q0);  // live rows of this block
  const bool warp_live = 2 * warp < nrows;     // the warp's rows are ty + 16 i, ty in {2 warp, 2 warp + 1}
  const int n_tiles = (p.S + kBlockK - 1) / kBlockK;
  const int tile_begin = split * p.tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + p.tiles_per_split);

  const T* q = static_cast<const T*>(p.q);
  const T* kbase = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vbase = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  TileLoader<T> kload, vload;
  int kp_next = kPadPos;
  if (tile_begin < tile_end) {  // first tile's loads fly while Q is staged
    kload.load(kbase, p.k_ss, p.S, p.hdk, tile_begin * kBlockK, tid);
    vload.load(vbase, p.v_ss, p.S, p.hdv, tile_begin * kBlockK, tid);
    const int s = tile_begin * kBlockK + tid;
    if (tid < kBlockK && s < p.S) kp_next = p.kv_pos[s];
  }

  // Q tile (zero beyond the live rows and hd_k): all loads issued, then stored.
  {
    constexpr int kQItems = kRows * kMaxHd / kThreads;
    float qv[kQItems];
#pragma unroll
    for (int it = 0; it < kQItems; ++it) {
      const int e = tid + it * kThreads;
      const int r = e / kMaxHd, d = e % kMaxHd;
      qv[it] = 0.f;
      if (r < nrows && d < p.hdk) {
        const int t = q0 + r / G, h = kvh * G + r % G;
        qv[it] = to_float(q[b * p.q_sb + t * p.q_st + h * p.q_sh + d]);
      }
    }
#pragma unroll
    for (int it = 0; it < kQItems; ++it) {
      const int e = tid + it * kThreads;
      Qs[(e / kMaxHd) * kLd + e % kMaxHd] = qv[it];
    }
  }
  for (int r = tid; r < kRows; r += kThreads) {
    int qp = -1, qs = kPadPos;  // block-padding rows are dead: q_start = PAD
    if (r < nrows) {
      const int t = q0 + r / G;
      qp = p.q_pos[b * p.qpos_sb + t];
      qs = p.q_start != nullptr ? p.q_start[b * p.qstart_sb + t] : 0;
    }
    row_qpos[r] = qp;
    row_qstart[r] = qs;
    row_m[r] = kNegInf;
    row_l[r] = 0.f;
  }

  float acc[kRowGroups][8];  // rows ty + 16 i; cols tx*4 + c and 64 + tx*4 + c
#pragma unroll
  for (int i = 0; i < kRowGroups; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  const int hdk4 = (p.hdk + 3) & ~3;  // the Q and K tiles are zero past hd_k

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    __syncthreads();  // the previous tile's readers are done
    kload.store(Ks, kLd, tid);
    vload.store(Vs, kMaxHd, tid);
    if (tid < kBlockK) col_pos[tid] = kp_next;
    __syncthreads();
    if (tile + 1 < tile_end) {  // the next tile's loads overlap this tile's math
      const int kv1 = (tile + 1) * kBlockK;
      kload.load(kbase, p.k_ss, p.S, p.hdk, kv1, tid);
      vload.load(vbase, p.v_ss, p.S, p.hdv, kv1, tid);
      kp_next = (tid < kBlockK && kv1 + tid < p.S) ? p.kv_pos[kv1 + tid] : kPadPos;
    }

    // Masked scores: rows ty + 16 i, cols tx + 16 c.
    if (warp_live) {
      float sc[kRowGroups][4];
#pragma unroll
      for (int i = 0; i < kRowGroups; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll 2
      for (int d = 0; d < hdk4; d += 4) {
        float4 qa[kRowGroups], kb[4];
#pragma unroll
        for (int i = 0; i < kRowGroups; ++i) qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * kLd + d]);
#pragma unroll
        for (int c = 0; c < 4; ++c) kb[c] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * c) * kLd + d]);
#pragma unroll
        for (int i = 0; i < kRowGroups; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float s = sc[i][c];
            s = fmaf(qa[i].x, kb[c].x, s);
            s = fmaf(qa[i].y, kb[c].y, s);
            s = fmaf(qa[i].z, kb[c].z, s);
            sc[i][c] = fmaf(qa[i].w, kb[c].w, s);
          }
      }
#pragma unroll
      for (int i = 0; i < kRowGroups; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          const int kp = col_pos[j];
          const bool vis = kp != kPadPos && (!p.causal || row_qpos[r] >= kp) && kp >= row_qstart[r];
          Ps[r * kLdP + j] = vis ? sc[i][c] * p.scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // Online softmax over the live rows: one warp per row, two columns a lane.
    for (int r = warp; r < nrows; r += kThreads / 32) {
      const float s0 = Ps[r * kLdP + lane], s1 = Ps[r * kLdP + lane + 32];
      float mb = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mb);
      // fully masked so far: exp(NEG_INF - NEG_INF) would be 1, keep zeros
      const bool safe = m_new > kNegInf / 2;
      const float alpha = safe ? expf(m_prev - m_new) : 0.f;
      const float p0 = safe ? expf(s0 - m_new) : 0.f;
      const float p1 = safe ? expf(s1 - m_new) : 0.f;
      Ps[r * kLdP + lane] = p0;
      Ps[r * kLdP + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        row_l[r] = row_l[r] * alpha + sum;
        row_alpha[r] = alpha;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V (rows past nrows hold garbage and are never stored)
    if (warp_live) {
#pragma unroll
      for (int i = 0; i < kRowGroups; ++i) {
        const float a = row_alpha[ty + 16 * i];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] *= a;
      }
#pragma unroll 2
      for (int j = 0; j < kBlockK; j += 4) {
        float4 pa[kRowGroups];
#pragma unroll
        for (int i = 0; i < kRowGroups; ++i) pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * kLdP + j]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 v0 = *reinterpret_cast<const float4*>(&Vs[(j + jj) * kMaxHd + tx * 4]);
          const float4 v1 = *reinterpret_cast<const float4*>(&Vs[(j + jj) * kMaxHd + 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < kRowGroups; ++i) {
            const float pv = jj == 0 ? pa[i].x : jj == 1 ? pa[i].y : jj == 2 ? pa[i].z : pa[i].w;
            acc[i][0] = fmaf(pv, v0.x, acc[i][0]);
            acc[i][1] = fmaf(pv, v0.y, acc[i][1]);
            acc[i][2] = fmaf(pv, v0.z, acc[i][2]);
            acc[i][3] = fmaf(pv, v0.w, acc[i][3]);
            acc[i][4] = fmaf(pv, v1.x, acc[i][4]);
            acc[i][5] = fmaf(pv, v1.y, acc[i][5]);
            acc[i][6] = fmaf(pv, v1.z, acc[i][6]);
            acc[i][7] = fmaf(pv, v1.w, acc[i][7]);
          }
        }
      }
    }
  }
  __syncthreads();

  const long long rows_total = static_cast<long long>(p.B) * p.Tq * p.H;
  float* o_out = p.o + split * rows_total * p.hdv;
#pragma unroll
  for (int i = 0; i < kRowGroups; ++i) {
    const int r = ty + 16 * i;
    if (r < nrows) {
      const int t = q0 + r / G, h = kvh * G + r % G;
      float* orow = o_out + ((static_cast<long long>(b) * p.Tq + t) * p.H + h) * p.hdv;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = (c < 4 ? 0 : 64) + tx * 4 + (c & 3);
        if (col < p.hdv) orow[col] = acc[i][c];
      }
    }
  }
  for (int r = tid; r < nrows; r += kThreads) {
    const int t = q0 + r / G, h = kvh * G + r % G;
    const long long idx = split * rows_total + (static_cast<long long>(b) * p.Tq + t) * p.H + h;
    p.m[idx] = row_m[r];
    p.l[idx] = row_l[r];
  }
}

// Merges the KV-split partials of each (b, t, h) row: with M = max_s m_s,
// o = sum_s exp(m_s - M) o_s and l = sum_s exp(m_s - M) l_s.  One warp per
// row; dead rows (every m_s = -1e30) stay o = l = 0, m = -1e30 exactly.
__global__ void merge_splits_kernel(const float* o_part, const float* m_part, const float* l_part, float* o,
                                    float* m, float* l, long long rows, int hdv, int nsplit) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float m_lane = lane < nsplit ? m_part[lane * rows + row] : kNegInf;
  float M = m_lane;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  const float w_lane = lane < nsplit ? expf(m_lane - M) : 0.f;
  float lsum = lane < nsplit ? l_part[lane * rows + row] * w_lane : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
  for (int c0 = 0; c0 < hdv; c0 += 32) {  // every lane runs every shuffle
    const int c = c0 + lane;
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = __shfl_sync(0xffffffffu, w_lane, s);
      if (c < hdv) acc = fmaf(o_part[(s * rows + row) * hdv + c], w, acc);
    }
    if (c < hdv) o[row * hdv + c] = acc;
  }
  if (lane == 0) {
    m[row] = M;
    l[row] = lsum;
  }
}

template <typename T, int kRowGroups>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<kRowGroups>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(flash_partial_fwd_kernel<T, kRowGroups>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(((p.Tq + p.bq - 1) / p.bq) * p.nsplit, p.Hkv, p.B);
  flash_partial_fwd_kernel<T, kRowGroups><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int row_groups, cudaStream_t stream) {
  switch (row_groups) {
    case 1: return launch<T, 1>(p, stream);
    case 2: return launch<T, 2>(p, stream);
    case 4: return launch<T, 4>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it).  Strides are in
// elements.  q_pos and q_start are int32 rows of Tq with batch strides
// qpos_sb / qstart_sb (0: one row shared by the batch); q_start may be null
// (no window).  kv_pos is [S] int32; o, m and l are contiguous fp32 outputs.
// The geometry comes from the caller (kernels/flash_attention.py::_geometry):
// row_groups (1, 2, 4) of 16 rows, bq tokens per block, nsplit KV splits of
// tiles_per_split 64-slot tiles.  K and V are loaded in 16-byte vectors:
// their base, their strides and hd_k / hd_v must be whole vectors.  With
// nsplit > 1 the partials go to o_part [nsplit, B, Tq, H, hdv], m_part and
// l_part [nsplit, B, Tq, H] (caller-allocated) and a merge kernel writes o,
// m, l.  Returns a cudaError_t.
extern "C" int flash_partial_fwd(int dtype, const void* q, const void* k, const void* v, const int* q_pos,
                                 const int* kv_pos, const int* q_start, float* o, float* m, float* l, float* o_part,
                                 float* m_part, float* l_part, int B, int Tq, int S, int H, int Hkv, int hdk,
                                 int hdv, int row_groups, int bq, int nsplit, int tiles_per_split,
                                 int qpos_sb, int qstart_sb, long long q_sb, long long q_st, long long q_sh,
                                 long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                 long long v_sh, float scale, int causal, void* stream) {
  if (B <= 0 || Tq <= 0 || S < 0 || Hkv <= 0 || H % Hkv != 0 || bq <= 0 || hdk <= 0 || hdk > kMaxHd ||
      hdv <= 0 || hdv > kMaxHd || (H / Hkv) * bq > 16 * row_groups || nsplit < 1 || nsplit > kMaxSplits ||
      tiles_per_split < 1 || (nsplit > 1 && (o_part == nullptr || m_part == nullptr || l_part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long vec = dtype == 0 ? 4 : 8;  // elements per 16-byte K/V load
  if (reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16 || hdk % vec || hdv % vec ||
      k_sb % vec || k_ss % vec || k_sh % vec || v_sb % vec || v_ss % vec || v_sh % vec)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bool split = nsplit > 1;
  const Params p{q,    k,    v,    q_pos, kv_pos, q_start,
                 split ? o_part : o,      split ? m_part : m,     split ? l_part : l,
                 B,    Tq,   S,    H,     Hkv,    hdk,     hdv,   bq,     nsplit, tiles_per_split,
                 qpos_sb, qstart_sb,
                 q_sb, q_st, q_sh, k_sb,  k_ss,   k_sh,    v_sb,  v_ss,   v_sh,
                 scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) e = dispatch<float>(p, row_groups, s);
  if (dtype == 1) e = dispatch<__nv_bfloat16>(p, row_groups, s);
  if (e != cudaSuccess || !split) return static_cast<int>(e);
  const long long rows = static_cast<long long>(B) * Tq * H;
  const int warps_per_block = kThreads / 32;
  const unsigned blocks = static_cast<unsigned>((rows + warps_per_block - 1) / warps_per_block);
  merge_splits_kernel<<<blocks, kThreads, 0, s>>>(o_part, m_part, l_part, o, m, l, rows, hdv, nsplit);
  return static_cast<int>(cudaGetLastError());
}
