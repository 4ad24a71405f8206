// Partial flash attention, forward, on the tensor cores, for Hopper (sm_90a).
//
// Replaces, for bf16 inputs, the Pallas TPU kernel `_flash_partial_kernel` /
// `_fwd_impl` of src/repro/kernels/flash_attention.py (pallas_call at line
// 260, visibility `_visible`).  It computes what flash_partial.cu computes
// for fp32 inputs (its note has the math): the masked scores
// s = q . k^T * scale, an online max and sum over 64-slot KV tiles, and the
// un-normalized fp32 triple (o, m, l); fully masked rows return o = l = 0
// and m = -1e30 exactly.
//
// What bounds it on an H100: at the prefill and training chunks the
// 4 . (visible pairs) . H . hd operations of q . k^T and p . v, which the
// bound counts at the 989 TFLOP/s bf16 tensor-core peak; at decode (Tq = 1)
// the bytes of the K/V cache it must read.  What the design does:
// - operations: both products run as mma.sync.m16n8k16 bf16 with fp32
//   accumulators (flash_partial.cu computes in fp32 on the CUDA cores, at
//   most 67 TFLOP/s).  s = q . k^T has two bf16 operands, so its products are
//   exact.  p = exp(s - m) is fp32, and one bf16 rounding costs ~2^-9
//   relative, 200x the 1e-5 the port holds the kernel to, so p is split into
//   kTerms = 3 bf16 terms (hi, mid, lo; 24 bits), built straight as A
//   fragments from the s accumulators (two m16n8 tiles are one m16n8k16 A
//   fragment), with no trip through shared memory.  Three terms are kept:
//   two would do one product fewer per tile, but were allowed only if the
//   first run on the card showed every case within half the tolerance, and
//   that run tried three only (tests/test_torch_split.py emulates the
//   scheme on the CPU: two terms err by ~2e-6 of the normalized output,
//   three by ~5e-7).  Tensor-core work per visible tile is 1 + 3 = 4
//   bf16 products against the 2 the bound counts.  o is a sum over up to
//   the whole cache, and a long tensor-core accumulation drifts (the
//   backward's note): each 8-column n-tile of o gets one short chain per KV
//   tile (4 k-steps x 3 terms = 12 MMAs from a zeroed accumulator), added
//   into o's fp32 registers after the online rescale o *= exp(m_prev -
//   m_new).  l = sum p is summed from the fp32 p in registers (quad
//   shuffles), not from the terms.  Which KV tiles some row of the block
//   sees is decided up front into a bit mask (rows ordered by q_start with
//   the running max of q_pos; each warp reads 4 tiles' positions at a time,
//   coalesced), and only those tiles stream through a two-stage cp.async
//   ring, read into fragments by ldmatrix (.trans for p . v's B operand).
//   Query tiles launch longest first (the last tile of a causal chunk sees
//   the most), so the grid's tail is short.
// - bytes: K, V and q are read in 16-byte vectors (cp.async); when
//   (query tiles x KV heads x batch) blocks would leave more than half the
//   132 SMs idle (decode: 16 blocks), the KV range is split over more blocks
//   and the last block of each group to finish merges the group's partials
//   in split order (deterministic) in the same launch: each split block
//   publishes its partial, fences, and draws a ticket from an int32 counter
//   of its group; the one that draws the last ticket merges and resets the
//   counter to 0 for the next call.
//
// Layout: one block of kWarps warps (1, 2, 4 or 8: the fewest whose 16 rows
// each hold the G x bq query rows) per (query tile, KV split, KV head, batch
// row).  Row r of the block is token q0 + r / G, head kvh * G + r % G (the
// G heads of a KV head share each K/V tile), 16 rows a warp; Q is loaded
// once by cp.async and held as A fragments in registers.  Head dims up to
// 128, multiples of 8: the reduction dimension is padded to 16 with zeros in
// shared memory and the stores are masked; hd_k = hd_v = 128 (the model's)
// compiles its loops without bounds checks (kFull).
//
// Wide heads (MLA, deepseek-v3: flash_fwd_wide_kernel, entry point
// flash_partial_fwd_tc_wide).  The same TPU kernel at hd_k = 576 (q_eff and
// the latent [c_kv | k_rope]), hd_v = 512 (v the latent's first 512 columns,
// a view of k) and G = 128 query heads on one KV head.  What bounds it: at
// prefill and train chunks the operations, (visible pairs) x 128 heads x
// (2 x 576 + 2 x 512) at the bf16 peak; at decode the latent cache's bytes.
// The narrow design does not widen: Q held as A fragments would be 144
// registers a thread, one warp's 16 rows of fp32 o at 512 columns 256
// registers (over the 255 limit alone), and a 128-row Q tile plus a two-stage
// K/V ring at a 584-element row stride would take 300 KB of shared memory
// against 227.  So the output columns are split over warps that share p
// through shared memory: a block holds 32 fold rows (token t, head g as row
// t x G + g: a quarter of one token's heads at G = 128) and 8 warps, warp w
// taking row group w / 4 and quarter w % 4.  Q (32 x 576) stays in shared
// memory and is read by ldmatrix at each k-step; each 32-slot KV tile lands
// once; each warp computes its 16 x 8 tile of s over the whole hd_k (four
// independent MMA chains), the quarters' row maxima and sums meet in shared
// memory, each warp writes its p as kTerms bf16 terms, and each warp
// multiplies the row group's p (16 x 32) by its 128 columns of V into 64
// fp32 registers of o.  s is computed once, not once per column slice: the
// tensor-core work per tile is 1 (s) + 3 (p's terms) products against the
// bound's 2.  Where v is k's view the V tile is the K tile; otherwise V's rows
// replace K's in the same buffer once s is read.  82 KB of shared memory, two
// blocks an SM: one waits on its tile while the other computes.  A decode
// call (4 blocks a batch row at G = 128) splits its KV range and merges the
// partials in the launch, as the narrow kernel does.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (kernels/flash_attention.py does this at first use).  Plain C interface,
// called through ctypes.

#include "tc_common.cuh"

namespace {

constexpr int kStages = 2;      // K/V ring
constexpr int kMaxWarps = 8;    // 128 query rows a block
constexpr int kMaxSplits = 32;  // KV splits of a group

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* q_pos;    // [B, Tq], or [Tq] with batch stride 0
  const int* kv_pos;   // [S]
  const int* q_start;  // [B, Tq] or [Tq]; null: no window
  float* o;            // [B, Tq, H, hdv] contiguous
  float* m;            // [B, Tq, H] contiguous
  float* l;            // [B, Tq, H] contiguous
  float* o_part;       // nsplit > 1: [nsplit, B, Tq, H, hdv], each split's partial
  float* m_part;       // nsplit > 1: [nsplit, B, Tq, H]
  float* l_part;       // nsplit > 1: [nsplit, B, Tq, H]
  int* tickets;        // nsplit > 1: [query tiles x Hkv x B], 0 between calls
  int B, Tq, S, H, Hkv, hdk, hdv, bq, nsplit, tiles_per_split, qpos_sb, qstart_sb;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
  int causal;
};

template <int kWarps>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * size_t(kLd) * (16 * kWarps + kStages * 2 * kBlockK)  // Q tile, K/V ring
         + sizeof(int) * (kStages * kBlockK + 4 * 16 * kWarps)               // slot and row positions
         + sizeof(uint32_t) * (kWindow / 32);                                // visible-tile mask
}

// Merges the nsplit partials of the group's nrows rows into (o, m, l), in
// split order: with M = max_s m_s, o = sum_s exp(m_s - M) o_s and
// l = sum_s exp(m_s - M) l_s.  Dead rows (every m_s = -1e30) stay o = l = 0,
// m = -1e30 exactly.  The partials were written by other blocks of this
// launch: read through L2 (__ldcg).
// The group's rows are fold rows f0 .. f0 + nrows - 1 of KV head kvh (row f:
// token f / G, head kvh * G + f % G).
template <int kThreads>
__device__ void merge_group(const Params& p, int b, int kvh, int f0, int nrows, int G, int hdv, int tid) {
  const long long rows_total = static_cast<long long>(p.B) * p.Tq * p.H;
  const int c4 = hdv / 4;
  for (int e = tid; e < nrows * c4; e += kThreads) {
    const int r = e / c4, c = e % c4, f = f0 + r;
    const long long row = (static_cast<long long>(b) * p.Tq + f / G) * p.H + kvh * G + f % G;
    float M = kNegInf;
    for (int s = 0; s < p.nsplit; ++s) M = fmaxf(M, __ldcg(p.m_part + s * rows_total + row));
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float lsum = 0.f;
    for (int s = 0; s < p.nsplit; ++s) {
      const float w = expf(__ldcg(p.m_part + s * rows_total + row) - M);
      const float4 x = __ldcg(reinterpret_cast<const float4*>(p.o_part + (s * rows_total + row) * hdv) + c);
      acc.x = fmaf(w, x.x, acc.x);
      acc.y = fmaf(w, x.y, acc.y);
      acc.z = fmaf(w, x.z, acc.z);
      acc.w = fmaf(w, x.w, acc.w);
      if (c == 0) lsum = fmaf(w, __ldcg(p.l_part + s * rows_total + row), lsum);
    }
    reinterpret_cast<float4*>(p.o + row * hdv)[c] = acc;
    if (c == 0) {
      p.m[row] = M;
      p.l[row] = lsum;
    }
  }
}

template <int kWarps, bool kFull>
__global__ void __launch_bounds__(32 * kWarps, 1) flash_fwd_tc_kernel(const Params p) {
  constexpr int kRows = 16 * kWarps, kThreads = 32 * kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);                                  // [kRows][kLd]
  bf16* KVs = Qs + kRows * kLd;                                              // [kStages][K, V][kBlockK][kLd]
  int* col_pos = reinterpret_cast<int*>(KVs + kStages * 2 * kBlockK * kLd);  // [kStages][kBlockK]
  int* row_qpos = col_pos + kStages * kBlockK;                               // [kRows]
  int* row_qstart = row_qpos + kRows;                                        // [kRows]
  int* qs_sorted = row_qstart + kRows;                                       // [kRows]
  int* qp_max = qs_sorted + kRows;                                           // [kRows]
  uint32_t* mask = reinterpret_cast<uint32_t*>(qp_max + kRows);              // [kWindow / 32]
  __shared__ int merges;  // this block drew its group's last ticket

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Lanes ln(lane);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int n_qt = (p.Tq + p.bq - 1) / p.bq;
  const int qtile = n_qt - 1 - static_cast<int>(blockIdx.x) / p.nsplit;  // the longest tiles first
  const int split = static_cast<int>(blockIdx.x) % p.nsplit;
  const int G = p.H / p.Hkv;
  const int q0 = qtile * p.bq;
  const int nrows = G * min(p.bq, p.Tq - q0);
  const int n_tiles = (p.S + kBlockK - 1) / kBlockK;
  const int tile_begin = min(n_tiles, split * p.tiles_per_split);
  const int tile_end = min(n_tiles, tile_begin + p.tiles_per_split);
  const int hdk = kFull ? kMaxHd : p.hdk, hdv = kFull ? kMaxHd : p.hdv;
  const int nk = (hdk + 15) / 16, nv = (hdv + 15) / 16;  // 16-column steps of the head dims
  const bool warp_live = warp * 16 < nrows;

  const bf16* qb = p.q + b * p.q_sb;
  load_tile_async<kRows, kThreads>(Qs, hdk, p.q, [&](int r) {
    return r < nrows ? qb + (q0 + r / G) * p.q_st + (kvh * G + r % G) * p.q_sh : nullptr;
  }, tid);
  cp_async_commit();
  for (int r = tid; r < kRows; r += kThreads) {
    int qp = -1, qs = kPadPos;  // block-padding rows are dead: q_start = PAD
    if (r < nrows) {
      const int t = q0 + r / G;
      qp = p.q_pos[b * p.qpos_sb + t];
      qs = p.q_start != nullptr ? p.q_start[b * p.qstart_sb + t] : 0;
    }
    row_qpos[r] = qp;
    row_qstart[r] = qs;
  }
  cp_async_wait<0>();
  __syncthreads();
  sort_rows<kRows>(row_qpos, row_qstart, qs_sorted, qp_max, tid);  // for slot_seen

  // this lane's two rows (accumulator rows lane / 4 and lane / 4 + 8), Q's A fragments
  int qp[2], qs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + (lane >> 2) + 8 * h;
    qp[h] = row_qpos[r];
    qs[h] = row_qstart[r];
  }
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
    if (ks < nk) ldsm_x4(qf[ks], Qs + (warp * 16 + ln.a_row) * kLd + ks * 16 + ln.a_col);

  float o[2 * kSteps][4];  // the warp's 16 rows x hd_v, in n-tiles of 8
#pragma unroll
  for (int n = 0; n < 2 * kSteps; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[n][j] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  const bf16* kbase = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vbase = p.v + b * p.v_sb + kvh * p.v_sh;
  auto issue_kv = [&](int tile, int stage) {
    const int kv0 = tile * kBlockK;
    bf16* Kst = KVs + stage * 2 * kBlockK * kLd;
    load_tile_async<kBlockK, kThreads>(Kst, hdk, p.k, [&](int j) {
      return kv0 + j < p.S ? kbase + (kv0 + j) * p.k_ss : nullptr;
    }, tid);
    load_tile_async<kBlockK, kThreads>(Kst + kBlockK * kLd, hdv, p.v, [&](int j) {
      return kv0 + j < p.S ? vbase + (kv0 + j) * p.v_ss : nullptr;
    }, tid);
    for (int j = tid; j < kBlockK; j += kThreads) {  // slots past S are PAD: never visible
      int* dst = col_pos + stage * kBlockK + j;
      if (kv0 + j < p.S)
        cp_async4(dst, p.kv_pos + kv0 + j);
      else
        *dst = kPadPos;
    }
  };

  for (int w0 = tile_begin; w0 < tile_end; w0 += kWindow) {
    // Which KV tiles of a window of 1024 some row sees (a bit mask), so the
    // loop below needs no barrier to skip a tile: each warp takes 4 tiles at
    // a time, a lane 2 slots of each, loads first.
    const int n_w = min(kWindow, tile_end - w0);
    __syncthreads();  // the sorted rows are written; the previous window's mask is no longer read
    for (int i = tid; i < kWindow / 32; i += kThreads) mask[i] = 0u;
    __syncthreads();
    for (int t0 = 4 * warp; t0 < n_w; t0 += 4 * kWarps) {
      int kp[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = (w0 + t0 + i) * kBlockK + 32 * h + lane;
          kp[i][h] = t0 + i < n_w && s < p.S ? p.kv_pos[s] : kPadPos;
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool seen = slot_seen<kRows>(qs_sorted, qp_max, kp[i][0], p.causal) ||
                          slot_seen<kRows>(qs_sorted, qp_max, kp[i][1], p.causal);
        if (__any_sync(0xffffffffu, seen) && lane == 0) atomicOr(mask + ((t0 + i) >> 5), 1u << ((t0 + i) & 31));
      }
    }
    __syncthreads();
    auto visible_tile = [&](int t) { return (mask[t >> 5] >> (t & 31)) & 1u; };
    auto next_tile = [&](int t) {  // the next visible tile after t (>= n_w: none)
      for (++t; t < n_w && !visible_tile(t); ++t) {
      }
      return t;
    };
    int cur = visible_tile(0) ? 0 : next_tile(0);
    if (cur < n_w) issue_kv(w0 + cur, 0);
    cp_async_commit();
    for (int stage = 0; cur < n_w; stage ^= 1) {
      const int nxt = next_tile(cur);
      if (nxt < n_w) issue_kv(w0 + nxt, stage ^ 1);  // that stage's readers passed the barrier below
      cp_async_commit();
      cp_async_wait<1>();  // this tile landed
      __syncthreads();
      const bf16* Ks = KVs + stage * 2 * kBlockK * kLd;
      const bf16* Vs = Ks + kBlockK * kLd;
      const int* cpos = col_pos + stage * kBlockK;
      if (warp_live) {
        // s = Q . K^T: one chain of nk k-steps per 8-slot n-tile
        float s[kBlockK / 8][4];
#pragma unroll
        for (int n = 0; n < kBlockK / 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          if (ks < nk) {
#pragma unroll
            for (int np = 0; np < kBlockK / 16; ++np) {
              uint32_t bb[4];
              ldsm_x4(bb, Ks + (np * 16 + ln.b_row) * kLd + ks * 16 + ln.b_col);
              mma(s[2 * np], qf[ks], bb[0], bb[1]);
              mma(s[2 * np + 1], qf[ks], bb[2], bb[3]);
            }
          }
        }
        // mask and scale; the tile's row max over the quad (4 lanes share a row)
        float mt[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < kBlockK / 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int h = j >> 1;
            const int kp = cpos[n * 8 + 2 * (lane & 3) + (j & 1)];
            s[n][j] = visible(kp, qp[h], qs[h], p.causal) ? s[n][j] * p.scale : kNegInf;
            mt[h] = fmaxf(mt[h], s[n][j]);
          }
        float alpha[2];
        bool safe[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
          mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
          const float m_new = fmaxf(m_run[h], mt[h]);
          // fully masked so far: exp(NEG_INF - NEG_INF) would be 1, keep zeros
          safe[h] = m_new > kNegInf / 2;
          alpha[h] = safe[h] ? expf(m_run[h] - m_new) : 0.f;
          m_run[h] = m_new;
        }
        // p = exp(s - m) in fp32, kept in s; l from the fp32 p
        float ls[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < kBlockK / 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int h = j >> 1;
            s[n][j] = safe[h] ? expf(s[n][j] - m_run[h]) : 0.f;
            ls[h] += s[n][j];
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 1);
          ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 2);
          l_run[h] = l_run[h] * alpha[h] + ls[h];
        }
#pragma unroll
        for (int n = 0; n < 2 * kSteps; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
        // o += p . V: p's kTerms terms as A fragments, one chain of the
        // tile's 4 k-steps x kTerms MMAs per n-tile, from zero, added into o
        uint32_t pa[kBlockK / 16][kTerms][4];
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) acc_to_a(s[2 * kk], s[2 * kk + 1], pa[kk]);
#pragma unroll
        for (int np = 0; np < kSteps; ++np) {
          if (np < nv) {
            float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kk = 0; kk < kBlockK / 16; ++kk) {
              uint32_t bb[4];
              ldsm_x4_t(bb, Vs + (kk * 16 + ln.t_row) * kLd + np * 16 + ln.t_col);
#pragma unroll
              for (int i = 0; i < kTerms; ++i) {
                mma(t0, pa[kk][i], bb[0], bb[1]);
                mma(t1, pa[kk][i], bb[2], bb[3]);
              }
            }
            add_to(o[2 * np], t0);
            add_to(o[2 * np + 1], t1);
          }
        }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
      cur = nxt;
    }
    cp_async_wait<0>();
  }

  // this block's (o, m, l): the output itself, or its split's partial
  const bool parted = p.nsplit > 1;
  const long long rows_total = static_cast<long long>(p.B) * p.Tq * p.H;
  float* o_out = parted ? p.o_part + split * rows_total * p.hdv : p.o;
  float* m_out = parted ? p.m_part + split * rows_total : p.m;
  float* l_out = parted ? p.l_part + split * rows_total : p.l;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + (lane >> 2) + 8 * h;
    if (r < nrows) {
      const long long row = (static_cast<long long>(b) * p.Tq + q0 + r / G) * p.H + kvh * G + r % G;
#pragma unroll
      for (int n = 0; n < 2 * kSteps; ++n) {
        const int col = n * 8 + 2 * (lane & 3);
        if (col < hdv) *reinterpret_cast<float2*>(o_out + row * hdv + col) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
      }
      if ((lane & 3) == 0) {
        m_out[row] = m_run[h];
        l_out[row] = l_run[h];
      }
    }
  }
  if (!parted) return;

  // publish the partial, draw a ticket; the group's last block merges
  __threadfence();
  __syncthreads();
  int* ticket = p.tickets + (static_cast<long long>(b) * p.Hkv + kvh) * n_qt + qtile;
  if (tid == 0) merges = atomicAdd(ticket, 1) == p.nsplit - 1;
  __syncthreads();
  if (!merges) return;
  __threadfence();
  merge_group<kThreads>(p, b, kvh, q0 * G, nrows, G, hdv, tid);
  if (tid == 0) *ticket = 0;  // ready for the next call on this stream
}

// ---- wide heads (MLA): hd_k <= 576, hd_v <= 512

constexpr size_t kWideSmem = sizeof(bf16) * (size_t(kWideRows + kWideBlockK) * kWideLd      // Q, the K / V tile
                                             + size_t(kTerms) * kWideRows * kWideLdP)      // p's terms
                             + sizeof(float) * 2 * 4 * kWideRows                           // row max and sum per quarter
                             + sizeof(int) * (kWideBlockK + 4 * kWideRows)                 // slot and row positions
                             + sizeof(uint32_t) * (kWindow / 32);                          // visible-tile mask

// One block of 8 warps per (32-row fold tile, KV split, KV head, batch row).
// Fold row f of KV head kvh is token f / G, head kvh * G + f % G (G = 128:
// a quarter of one token's heads).  Warp w takes row group w / 4 (16 rows)
// and quarter w % 4: for s, the quarter's 8 slots of the 32-slot KV tile; for
// o, the quarter's 128 columns of hd_v.  Per visible tile: the K tile lands
// (cp.async), each warp computes its 16 x 8 tile of s over the whole hd_k
// (dot_tile), the four quarters' row maxima meet in shared memory, each warp
// writes its p = exp(s - m) as kTerms bf16 terms to shared memory with its
// row sums, and then multiplies the row group's 16 x 32 p by the tile's V
// columns of its quarter into o.  V is K's first hd_v columns when v is a
// view of k (the MLA latent: same base and strides), read from the K tile
// as it stands; otherwise V's rows replace K's in the same buffer once s is
// done.  82 KB of shared memory: two blocks an SM, each waiting on its loads
// while the other computes.
__global__ void __launch_bounds__(kWideThreads, 2) flash_fwd_wide_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);                                   // [kWideRows][kWideLd]
  bf16* KVs = Qs + kWideRows * kWideLd;                                       // [kWideBlockK][kWideLd]
  bf16* Ps = KVs + kWideBlockK * kWideLd;                                     // [kTerms][kWideRows][kWideLdP]
  float* red_max = reinterpret_cast<float*>(Ps + kTerms * kWideRows * kWideLdP);  // [4][kWideRows]
  float* red_sum = red_max + 4 * kWideRows;                                   // [4][kWideRows]
  int* col_pos = reinterpret_cast<int*>(red_sum + 4 * kWideRows);             // [kWideBlockK]
  int* row_qpos = col_pos + kWideBlockK;                                      // [kWideRows]
  int* row_qstart = row_qpos + kWideRows;
  int* qs_sorted = row_qstart + kWideRows;
  int* qp_max = qs_sorted + kWideRows;
  uint32_t* mask = reinterpret_cast<uint32_t*>(qp_max + kWideRows);           // [kWindow / 32]
  __shared__ int merges;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp >> 2, quarter = warp & 3;
  const Lanes ln(lane);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = p.H / p.Hkv, R = p.Tq * G;
  const int n_rt = (R + kWideRows - 1) / kWideRows;
  const int rtile = n_rt - 1 - static_cast<int>(blockIdx.x) / p.nsplit;  // the longest tiles first
  const int split = static_cast<int>(blockIdx.x) % p.nsplit;
  const int f0 = rtile * kWideRows;
  const int nrows = min(kWideRows, R - f0);
  const int n_tiles = (p.S + kWideBlockK - 1) / kWideBlockK;
  const int tile_begin = min(n_tiles, split * p.tiles_per_split);
  const int tile_end = min(n_tiles, tile_begin + p.tiles_per_split);
  const int nk = (p.hdk + 15) / 16;
  const int c0 = quarter * kWideColsV;  // this warp's first column of o
  const int nvq = max(0, min(kWideColsV / 16, (p.hdv - c0 + 15) / 16));
  const bool alias = v_views_k(p);

  const bf16* qb = p.q + b * p.q_sb;
  load_rows_async<kWideRows, kWideThreads, kWideLd>(Qs, p.hdk, p.q, [&](int r) {
    const int f = f0 + r;
    return r < nrows ? qb + (f / G) * p.q_st + (kvh * G + f % G) * p.q_sh : nullptr;
  }, tid);
  cp_async_commit();
  for (int r = tid; r < kWideRows; r += kWideThreads) {
    int qp = -1, qs = kPadPos;  // tile-padding rows are dead
    if (r < nrows) {
      const int t = (f0 + r) / G;
      qp = p.q_pos[b * p.qpos_sb + t];
      qs = p.q_start != nullptr ? p.q_start[b * p.qstart_sb + t] : 0;
    }
    row_qpos[r] = qp;
    row_qstart[r] = qs;
  }
  cp_async_wait<0>();
  __syncthreads();
  sort_rows<kWideRows>(row_qpos, row_qstart, qs_sorted, qp_max, tid);

  int rr[2], qp[2], qs[2];  // this lane's two rows of the row group
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rr[h] = rg * 16 + (lane >> 2) + 8 * h;
    qp[h] = row_qpos[rr[h]];
    qs[h] = row_qstart[rr[h]];
  }
  float o[2 * kWideColsV / 16][4];  // 16 rows x the quarter's 128 columns, in n-tiles of 8
#pragma unroll
  for (int n = 0; n < 2 * kWideColsV / 16; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[n][j] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  const bf16* kbase = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vbase = p.v + b * p.v_sb + kvh * p.v_sh;
  const bf16* qa = Qs + (rg * 16 + ln.a_row) * kWideLd + ln.a_col;
  const bf16* kb = KVs + (quarter * 8 + ln.b_row) * kWideLd + ln.b_col;
  const bf16* pa_at = Ps + (rg * 16 + ln.a_row) * kWideLdP + ln.a_col;
  const int pcol = quarter * 8 + 2 * (lane & 3);  // this lane's slot pair of the tile

  for (int w0 = tile_begin; w0 < tile_end; w0 += kWindow) {
    // which KV tiles of a window of 1024 some row sees: each warp takes 4
    // tiles at a time, a lane one slot of each
    const int n_w = min(kWindow, tile_end - w0);
    __syncthreads();
    for (int i = tid; i < kWindow / 32; i += kWideThreads) mask[i] = 0u;
    __syncthreads();
    for (int t0 = 4 * warp; t0 < n_w; t0 += 4 * kWideWarps) {
      int kp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = (w0 + t0 + i) * kWideBlockK + lane;
        kp[i] = t0 + i < n_w && s < p.S ? p.kv_pos[s] : kPadPos;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool seen = slot_seen<kWideRows>(qs_sorted, qp_max, kp[i], p.causal);
        if (__any_sync(0xffffffffu, seen) && lane == 0) atomicOr(mask + ((t0 + i) >> 5), 1u << ((t0 + i) & 31));
      }
    }
    __syncthreads();
    for (int t = 0; t < n_w; ++t) {
      if (!((mask[t >> 5] >> (t & 31)) & 1u)) continue;  // the same for every thread
      const int kv0 = (w0 + t) * kWideBlockK;
      load_rows_async<kWideBlockK, kWideThreads, kWideLd>(KVs, p.hdk, p.k, [&](int j) {
        return kv0 + j < p.S ? kbase + (kv0 + j) * p.k_ss : nullptr;
      }, tid);
      cp_async_commit();
      if (tid < kWideBlockK) col_pos[tid] = kv0 + tid < p.S ? p.kv_pos[kv0 + tid] : kPadPos;
      cp_async_wait<0>();
      __syncthreads();

      // s = Q . K^T: the row group's 16 rows x the quarter's 8 slots
      float s[4];
      dot_tile(s, qa, kb, nk);
      float mt[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = j >> 1;
        s[j] = visible(col_pos[pcol + (j & 1)], qp[h], qs[h], p.causal) ? s[j] * p.scale : kNegInf;
        mt[h] = fmaxf(mt[h], s[j]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
        if ((lane & 3) == 0) red_max[quarter * kWideRows + rr[h]] = mt[h];
      }
      __syncthreads();  // every warp's s is done: the K tile may be replaced
      if (!alias) {
        load_rows_async<kWideBlockK, kWideThreads, kWideLd>(KVs, p.hdv, p.v, [&](int j) {
          return kv0 + j < p.S ? vbase + (kv0 + j) * p.v_ss : nullptr;
        }, tid);
        cp_async_commit();
      }
      // the tile's row max over the four quarters, in quarter order (every
      // warp of the row group gets the same bits), and the online rescale
      float alpha[2];
      bool safe[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* rm = red_max + rr[h];
        const float tm = fmaxf(fmaxf(rm[0], rm[kWideRows]), fmaxf(rm[2 * kWideRows], rm[3 * kWideRows]));
        const float m_new = fmaxf(m_run[h], tm);
        safe[h] = m_new > kNegInf / 2;  // fully masked so far: keep zeros
        alpha[h] = safe[h] ? expf(m_run[h] - m_new) : 0.f;
        m_run[h] = m_new;
      }
      // p = exp(s - m) in fp32: its row sums over the quarter's slots, its
      // terms to shared memory
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = j >> 1;
        s[j] = safe[h] ? expf(s[j] - m_run[h]) : 0.f;
        ls[h] += s[j];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 1);
        ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 2);
        if ((lane & 3) == 0) red_sum[quarter * kWideRows + rr[h]] = ls[h];
        store_split<kWideRows * kWideLdP>(Ps, rr[h] * kWideLdP + pcol, s[2 * h], s[2 * h + 1]);
      }
      cp_async_wait<0>();
      __syncthreads();  // p's terms, the row sums (and V) are in place
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* rs = red_sum + rr[h];
        l_run[h] = l_run[h] * alpha[h] + ((rs[0] + rs[kWideRows]) + (rs[2 * kWideRows] + rs[3 * kWideRows]));
      }
#pragma unroll
      for (int n = 0; n < 2 * kWideColsV / 16; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // o += p . V over the quarter's columns: one chain of the tile's 2
      // k-steps x kTerms MMAs per n-tile, from zero, added into o
      uint32_t pa[kWideBlockK / 16][kTerms][4];
#pragma unroll
      for (int kk = 0; kk < kWideBlockK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < kTerms; ++i) ldsm_x4(pa[kk][i], pa_at + i * kWideRows * kWideLdP + kk * 16);
#pragma unroll
      for (int np = 0; np < kWideColsV / 16; ++np) {
        if (np < nvq) {
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < kWideBlockK / 16; ++kk) {
            uint32_t bb[4];
            ldsm_x4_t(bb, KVs + (kk * 16 + ln.t_row) * kWideLd + c0 + np * 16 + ln.t_col);
#pragma unroll
            for (int i = 0; i < kTerms; ++i) {
              mma(t0, pa[kk][i], bb[0], bb[1]);
              mma(t1, pa[kk][i], bb[2], bb[3]);
            }
          }
          add_to(o[2 * np], t0);
          add_to(o[2 * np + 1], t1);
        }
      }
      __syncthreads();  // every warp is done with the tile before the next lands
    }
  }

  // this block's (o, m, l): the output itself, or its split's partial
  const bool parted = p.nsplit > 1;
  const long long rows_total = static_cast<long long>(p.B) * p.Tq * p.H;
  float* o_out = parted ? p.o_part + split * rows_total * p.hdv : p.o;
  float* m_out = parted ? p.m_part + split * rows_total : p.m;
  float* l_out = parted ? p.l_part + split * rows_total : p.l;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rr[h] < nrows) {
      const int f = f0 + rr[h];
      const long long row = (static_cast<long long>(b) * p.Tq + f / G) * p.H + kvh * G + f % G;
#pragma unroll
      for (int n = 0; n < 2 * kWideColsV / 16; ++n) {
        const int col = c0 + n * 8 + 2 * (lane & 3);
        if (col < p.hdv)
          *reinterpret_cast<float2*>(o_out + row * p.hdv + col) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
      }
      if (quarter == 0 && (lane & 3) == 0) {
        m_out[row] = m_run[h];
        l_out[row] = l_run[h];
      }
    }
  }
  if (!parted) return;

  // publish the partial, draw a ticket; the group's last block merges
  __threadfence();
  __syncthreads();
  int* ticket = p.tickets + (static_cast<long long>(b) * p.Hkv + kvh) * n_rt + rtile;
  if (tid == 0) merges = atomicAdd(ticket, 1) == p.nsplit - 1;
  __syncthreads();
  if (!merges) return;
  __threadfence();
  merge_group<kWideThreads>(p, b, kvh, f0, nrows, G, p.hdv, tid);
  if (tid == 0) *ticket = 0;  // ready for the next call on this stream
}

cudaError_t launch_wide(const Params& p, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(flash_fwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(kWideSmem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int n_rt = (p.Tq * (p.H / p.Hkv) + kWideRows - 1) / kWideRows;
  const dim3 grid(n_rt * p.nsplit, p.Hkv, p.B);
  flash_fwd_wide_kernel<<<grid, kWideThreads, kWideSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int kWarps, bool kFull>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<kWarps>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(flash_fwd_tc_kernel<kWarps, kFull>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(((p.Tq + p.bq - 1) / p.bq) * p.nsplit, p.Hkv, p.B);
  flash_fwd_tc_kernel<kWarps, kFull><<<grid, 32 * kWarps, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kFull>
cudaError_t dispatch(const Params& p, int warps, cudaStream_t stream) {
  switch (warps) {
    case 1: return launch<1, kFull>(p, stream);
    case 2: return launch<2, kFull>(p, stream);
    case 4: return launch<4, kFull>(p, stream);
    case 8: return launch<8, kFull>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k and v are bf16 with element strides, loaded in 16-byte vectors (bases,
// strides and head dims whole vectors); q_pos and q_start are int32 rows of
// Tq with batch strides qpos_sb / qstart_sb (0: one row shared by the
// batch); q_start may be null (no window); kv_pos is [S] int32.  o [B, Tq,
// H, hdv], m and l [B, Tq, H] are contiguous fp32 outputs, every element
// written.  The geometry comes from the caller
// (kernels/flash_attention.py::_tc_geometry): warps (1, 2, 4, 8) of 16 rows,
// bq query tokens per block (G x bq <= 16 x warps), nsplit KV splits of
// tiles_per_split 64-slot tiles.  With nsplit > 1, o_part [nsplit, B, Tq, H,
// hdv], m_part and l_part [nsplit, B, Tq, H] are contiguous fp32 scratch and
// tickets is an int32 counter per (query tile, KV head, batch row), all zero
// before the call and left zero after it: calls that share tickets must be
// ordered (one stream).  Returns a cudaError_t.
extern "C" int flash_partial_fwd_tc(const void* q, const void* k, const void* v, const int* q_pos, const int* kv_pos,
                                    const int* q_start, float* o, float* m, float* l, float* o_part, float* m_part,
                                    float* l_part, int* tickets, int B, int Tq, int S, int H, int Hkv, int hdk,
                                    int hdv, int warps, int bq, int nsplit, int tiles_per_split, int qpos_sb,
                                    int qstart_sb, long long q_sb, long long q_st, long long q_sh, long long k_sb,
                                    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                    float scale, int causal, void* stream) {
  if (B <= 0 || Tq <= 0 || S < 0 || Hkv <= 0 || H % Hkv != 0 || bq <= 0 || hdk <= 0 || hdk > kMaxHd ||
      hdv <= 0 || hdv > kMaxHd || warps <= 0 || warps > kMaxWarps || (H / Hkv) * bq > 16 * warps || nsplit < 1 ||
      nsplit > kMaxSplits || tiles_per_split < 1 ||
      (nsplit > 1 && (o_part == nullptr || m_part == nullptr || l_part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16 || reinterpret_cast<uintptr_t>(o) % 16 ||
      reinterpret_cast<uintptr_t>(o_part) % 16 || hdk % 8 || hdv % 8 || q_sb % 8 || q_st % 8 || q_sh % 8 ||
      k_sb % 8 || k_ss % 8 || k_sh % 8 || v_sb % 8 || v_ss % 8 || v_sh % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), q_pos,
                 kv_pos, q_start, o, m, l, o_part, m_part, l_part, tickets, B, Tq, S, H, Hkv, hdk, hdv, bq, nsplit,
                 tiles_per_split, qpos_sb, qstart_sb, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                 causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool full = hdk == kMaxHd && hdv == kMaxHd;
  return static_cast<int>(full ? dispatch<true>(p, warps, s) : dispatch<false>(p, warps, s));
}

// The wide forward (MLA's hd_k <= 576, hd_v <= 512): the arguments of
// flash_partial_fwd_tc without the block shape, which is fixed (32 fold rows
// of G x Tq per KV head, 8 warps); tickets: one counter per (fold tile, KV
// head, batch row).  v may be a view of k (its first hd_v columns, k's base
// and strides), and is then read from k's tiles.
extern "C" int flash_partial_fwd_tc_wide(const void* q, const void* k, const void* v, const int* q_pos,
                                         const int* kv_pos, const int* q_start, float* o, float* m, float* l,
                                         float* o_part, float* m_part, float* l_part, int* tickets, int B, int Tq,
                                         int S, int H, int Hkv, int hdk, int hdv, int nsplit, int tiles_per_split,
                                         int qpos_sb, int qstart_sb, long long q_sb, long long q_st, long long q_sh,
                                         long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                         long long v_ss, long long v_sh, float scale, int causal, void* stream) {
  if (B <= 0 || Tq <= 0 || S < 0 || Hkv <= 0 || H % Hkv != 0 || hdk <= 0 || hdk > kWideHdK || hdv <= 0 ||
      hdv > kWideHdV || nsplit < 1 || nsplit > kMaxSplits || tiles_per_split < 1 ||
      (nsplit > 1 && (o_part == nullptr || m_part == nullptr || l_part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16 || reinterpret_cast<uintptr_t>(o) % 16 ||
      reinterpret_cast<uintptr_t>(o_part) % 16 || hdk % 8 || hdv % 8 || q_sb % 8 || q_st % 8 || q_sh % 8 ||
      k_sb % 8 || k_ss % 8 || k_sh % 8 || v_sb % 8 || v_ss % 8 || v_sh % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), q_pos,
                 kv_pos, q_start, o, m, l, o_part, m_part, l_part, tickets, B, Tq, S, H, Hkv, hdk, hdv, 1, nsplit,
                 tiles_per_split, qpos_sb, qstart_sb, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                 causal};
  return static_cast<int>(launch_wide(p, static_cast<cudaStream_t>(stream)));
}
