// Partial flash attention, backward, on the tensor cores, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU backward kernels of
// src/repro/kernels/flash_attention.py for bf16 inputs: `_flash_bwd_dq_kernel`
// (pallas_call at line 331) and `_flash_bwd_dkv_kernel` (pallas_call at line
// 355), with their shared block math `_recompute_p_ds`.  They compute what
// flash_partial_bwd.cu computes (its note has the math): p = exp(s - m) from
// the saved row max, dS = p * (dO . v^T + dl), dq = scale * sum_kv dS . k,
// dk = scale * sum_q dS^T . q, dv = sum_q p^T . dO; dead rows (m = -1e30) read
// dO and dl as zeros, so NaN cotangents there reach nothing.
//
// What bounds them on an H100: the operations of five products per visible
// score tile, which the bound counts at the 989 TFLOP/s bf16 tensor-core
// peak.  The fp32 kernels of flash_partial_bwd.cu run on the CUDA cores
// (67 TFLOP/s at most); these run every product as mma.sync.m16n8k16 bf16
// with fp32 accumulators.
//
// Accuracy.  The reference computes in fp32, and the port holds each gradient
// to 1e-5 x max |plain gradient|.  Only s = q . k^T has two bf16 operands; dO
// is fp32 (the cotangent of the fp32 o), and p and dS are fp32 by
// construction.  Rounding any of them to bf16 costs ~2^-9 relative, 200x the
// tolerance, so each fp32 operand x is split into kTerms = 3 bf16 terms,
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid): 24 significant
// bits, fp32's exponent range, each difference exact.  A product of a split
// operand and a bf16 one is three MMAs; p^T . dO keeps the six cross terms
// i + j < 3 (those above 2^-24).  Tensor-core work per visible tile is
// 1 + 3 + 3 = 7 bf16 products in the dq kernel and 1 + 3 + 6 + 3 = 13 in the
// dk/dv kernel, against the 3 and 4 the bound counts.  Two terms would err by
// ~4e-6, 0.4 of the tolerance, where three err by ~5e-7
// (tests/test_torch_split.py emulates the scheme on the CPU).  3xTF32 would
// need as many operand passes at half the bf16 rate, for 22 bits.  The tensor
// cores' fp32 accumulation may round toward zero, which over the thousands of
// MMAs of one dq or dk row would drift by ~3e-5 relative: every long sum
// therefore runs in a plain fp32 register (round to nearest), fed by short
// MMA chains (one 16-deep k-step, all its split terms) that start from zero.
//
// - dq kernel: one block of 8 warps per (128-row query tile, KV head, batch
//   row); rows use the forward's fold (row r = token q0 + r / G, head
//   kvh * G + r % G), 16 rows a warp.  Q is loaded once by cp.async; dO is read
//   once, zeroed on dead rows, split and kept in shared memory.  The kernel
//   also writes, in fold order, dO's terms, a copy of q and each row's
//   (q_pos, q_start, m, dl), so the dk/dv kernel reads a query tile as
//   consecutive rows and splits nothing.  Which 64-slot KV tiles some row
//   sees is decided up front into a bit mask (rows ordered by q_start with
//   the running max of q_pos, one tile a lane), and the visible K and V tiles
//   stream through a two-stage cp.async ring, read into fragments by
//   ldmatrix (row stride 272 bytes: conflict-free).  s and dp stay in
//   registers as MMA accumulators; the mask, p and dS are applied there, and
//   dS is split straight into A fragments (two m16n8 accumulator tiles are
//   one m16n8k16 A fragment), with no trip through shared memory.
// - dk/dv kernel: one block per (64-slot KV tile, KV head, batch row), two
//   warp groups of 4 warps, 16 slots a warp, over 32-row query tiles.  It
//   computes the transposed tiles s^T = k . q^T and dp^T = v . dO^T (slots as
//   rows, one accumulator per dO term), so p^T and dS^T come out in the
//   accumulator layout and feed dv += p^T . dO and dk += dS^T . q as A
//   fragments.  The G grouped heads are rows of the query tile, so the GQA
//   sum is the reduction dimension: no atomics.  The visible query tiles
//   are decided up front into a bit mask (the tile's positions sorted, a
//   binary search per row); the two groups take alternate ones, each with
//   two cp.async buffers, so loads overlap the products, and the longest
//   causal column (KV tile 0 sees every query tile) is walked by both.
// Head dims up to 128, multiples of 8: the reduction dimension is padded to
// 16 with zeros in shared memory and the stores are masked; hd_k = hd_v =
// 128 (the model's) compiles its loops without bounds checks (kFull).
//
// Wide heads (MLA, deepseek-v3: flash_bwd_dq_wide_kernel and
// flash_bwd_dkv_wide_kernel, entry point flash_partial_bwd_tc_wide).  The
// same two TPU kernels at hd_k = 576, hd_v = 512 (v a view of the latent k)
// and G = 128.  What bounds them at the train chunks: the operations of the
// three and four products per visible pair and head, 2 x 128 x (576 + 512 +
// 576) and 2 x 128 x (2 x 576 + 2 x 512).  The narrow tiles do not widen: a
// 128-row dq accumulator at 576 columns, or 64 slots of dk at 576 and dv at
// 512, is far over 255 registers a thread, and dO's three bf16 terms for 128
// rows at 512 columns alone are 400 KB of shared memory.  So both kernels
// split the output columns over warps and share the score tiles through
// shared memory, with no atomics (each output element has one writer):
// - dq: a block of 8 warps holds 32 fold rows, their q (37 KB) and dO's three
//   terms (100 KB) in shared memory; per visible 32-slot KV tile, warp w
//   (row group w / 4, quarter w % 4) computes its 16 x 8 tiles of s and dp
//   (one chain per dO term) and writes dS's terms; then dq += dS . K over
//   its 144 columns of hd_k (72 fp32 registers).  It also writes dO's terms,
//   q and the rows' records in fold order for the dk/dv kernel.
// - dk/dv: a block of 8 warps holds a 32-slot KV tile; per visible 32-row
//   query tile (q and dO's terms from the fold-order scratch), warp w (slot
//   group w / 4, quarter w % 4) computes its 16 x 8 tiles of s^T and dp^T and
//   writes p^T's and dS^T's terms; then dv += p^T . dO over its 128 columns
//   of hd_v (the six cross terms i + j < 3) and dk += dS^T . Q over its 144
//   columns of hd_k (136 fp32 registers in all).  The G heads are query
//   rows, so their sum is the reduction dimension.
// s and dp are computed once a tile, not once per column slice; the
// tensor-core work per tile is 7 bf16 products in the dq kernel and 13 in
// the dk/dv kernel, as in the narrow pair.  Each block holds about 215 KB of
// shared memory, one a SM, loading a tile while no other work overlaps it
// (a simple first design: the warp-specialised wgmma + TMA redesign of
// ROADMAP Queue 2 is where the overlap comes).  Where v is k's view the V
// tile is the K tile.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (kernels/flash_attention.py does this at first use).  Plain C interface,
// called through ctypes.

#include "tc_common.cuh"

namespace {

constexpr int kDqWarps = 8;
constexpr int kDqRows = 16 * kDqWarps;  // query rows of a dq block
constexpr int kDqThreads = 32 * kDqWarps;
constexpr int kStages = 2;         // K/V ring of the dq kernel
constexpr int kKvWarps = kBlockK / 16;  // warps of a dk/dv warp group: 16 slots each
constexpr int kKvGroups = 2;       // dk/dv warp groups, each on its own query tiles
constexpr int kKvRows = 32;        // query rows of a dk/dv query tile
constexpr int kKvBufs = 2;         // a group's query-tile buffers: the next tile loads during this one
constexpr int kKvGroupThreads = 32 * kKvWarps;
constexpr int kKvThreads = kKvGroups * kKvGroupThreads;
constexpr int kKvWarpsAll = kKvGroups * kKvWarps;
constexpr int kKvBufTile = (1 + kTerms) * kKvRows * kLd;  // one buffer's Q and dO tiles (bf16)

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* dout;   // [B, Tq, H, hdv] contiguous
  const float* m;      // [B, Tq, H] contiguous
  const float* dl;     // [B, Tq, H] contiguous
  const int* q_pos;    // [B, Tq], or [Tq] with batch stride 0
  const int* kv_pos;   // [S]
  const int* q_start;  // [B, Tq] or [Tq]; null: no window
  // Written by the dq kernel in fold order (row R = token * G + g of KV head
  // kvh, so a query tile is consecutive rows) and read by the dk/dv kernel:
  bf16* dout_split;    // [kTerms, B, Hkv, Tq * G, hdv]: dO's bf16 terms, zero on dead rows
  bf16* q_fold;        // [B, Hkv, Tq * G, hdk]: q
  int4* row_rec;       // [B, Hkv, Tq * G]: (q_pos, q_start, m, dl zeroed on dead rows)
  float* dq;           // [B, Tq, H, hdk] contiguous
  float* dk;           // [B, S, Hkv, hdk] contiguous
  float* dv;           // [B, S, Hkv, hdv] contiguous
  int B, Tq, S, H, Hkv, hdk, hdv, bq, qpos_sb, qstart_sb;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
  int causal;
};

// Per-row state of the dq kernel's query tile: positions, the saved max and
// dl (zero on dead rows, m = -1e30), also written to row_rec for the dk/dv
// kernel (`fold0`: the tile's first fold-order row).  Rows past nrows are
// block padding and dead.
__device__ __forceinline__ void load_row_state(const Params& p, int b, int kvh, int G, int q0, int nrows,
                                               long long fold0, int* row_qpos, int* row_qstart, float* row_m,
                                               float* row_dl, int tid) {
  for (int r = tid; r < kDqRows; r += kDqThreads) {
    int qp = -1, qs = kPadPos;
    float mr = kNegInf, dr = 0.f;
    if (r < nrows) {
      const int t = q0 + r / G, h = kvh * G + r % G;
      const long long idx = (static_cast<long long>(b) * p.Tq + t) * p.H + h;
      qp = p.q_pos[b * p.qpos_sb + t];
      qs = p.q_start != nullptr ? p.q_start[b * p.qstart_sb + t] : 0;
      mr = p.m[idx];
      dr = mr > kNegInf / 2 ? p.dl[idx] : 0.f;
      p.row_rec[fold0 + r] = make_int4(qp, qs, __float_as_int(mr), __float_as_int(dr));
    }
    row_qpos[r] = qp;
    row_qstart[r] = qs;
    row_m[r] = mr;
    row_dl[r] = dr;
  }
}

// Barrier of one dk/dv warp group (named barrier `id`, its 128 threads).
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kKvGroupThreads) : "memory");
}

// ---- dq

constexpr size_t kDqSmem = sizeof(bf16) * size_t(kLd) * (kDqRows + kTerms * kDqRows + kStages * 2 * kBlockK) +
                           sizeof(int) * (kStages * kBlockK + 6 * kDqRows) + sizeof(uint32_t) * (kWindow / 32);

// kFull: hd_k = hd_v = 128, so every head-dim loop has compile-time bounds
// and no branch (the main path); otherwise the steps past hd are skipped.
template <bool kFull>
__global__ void __launch_bounds__(kDqThreads, 1) flash_bwd_dq_tc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);           // [kDqRows][kLd]
  bf16* dOs = Qs + kDqRows * kLd;                     // [kTerms][kDqRows][kLd]
  bf16* KVs = dOs + kTerms * kDqRows * kLd;           // [kStages][K, V][kBlockK][kLd]
  int* col_pos = reinterpret_cast<int*>(KVs + kStages * 2 * kBlockK * kLd);  // [kStages][kBlockK]
  int* row_qpos = col_pos + kStages * kBlockK;
  int* row_qstart = row_qpos + kDqRows;
  float* row_m = reinterpret_cast<float*>(row_qstart + kDqRows);
  float* row_dl = row_m + kDqRows;
  int* qs_sorted = reinterpret_cast<int*>(row_dl + kDqRows);  // [kDqRows]
  int* qp_max = qs_sorted + kDqRows;                           // [kDqRows]
  uint32_t* mask = reinterpret_cast<uint32_t*>(qp_max + kDqRows);  // [kWindow / 32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Lanes ln(lane);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = p.H / p.Hkv;
  const int q0 = blockIdx.x * p.bq;
  const int nrows = G * min(p.bq, p.Tq - q0);
  const int n_tiles = (p.S + kBlockK - 1) / kBlockK;
  const int hdk = kFull ? kMaxHd : p.hdk, hdv = kFull ? kMaxHd : p.hdv;
  const int nk = (hdk + 15) / 16, nv = (hdv + 15) / 16;  // 16-column steps of the head dims
  const bool warp_live = warp * 16 < nrows;

  const long long fold0 = (static_cast<long long>(b) * p.Hkv + kvh) * p.Tq * G + q0 * G;  // row 0's fold row
  load_row_state(p, b, kvh, G, q0, nrows, fold0, row_qpos, row_qstart, row_m, row_dl, tid);
  __syncthreads();
  sort_rows<kDqRows>(row_qpos, row_qstart, qs_sorted, qp_max, tid);  // for slot_seen

  const bf16* kbase = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vbase = p.v + b * p.v_sb + kvh * p.v_sh;
  auto issue_kv = [&](int tile, int stage) {
    const int kv0 = tile * kBlockK;
    bf16* Kst = KVs + stage * 2 * kBlockK * kLd;
    load_tile_async<kBlockK, kDqThreads>(Kst, hdk, p.k, [&](int j) {
      return kv0 + j < p.S ? kbase + (kv0 + j) * p.k_ss : nullptr;
    }, tid);
    load_tile_async<kBlockK, kDqThreads>(Kst + kBlockK * kLd, hdv, p.v, [&](int j) {
      return kv0 + j < p.S ? vbase + (kv0 + j) * p.v_ss : nullptr;
    }, tid);
    if (tid < kBlockK) col_pos[stage * kBlockK + tid] = kv0 + tid < p.S ? p.kv_pos[kv0 + tid] : kPadPos;
  };
  const bf16* qb = p.q + b * p.q_sb;
  load_tile_async<kDqRows, kDqThreads>(Qs, hdk, p.q, [&](int r) {
    return r < nrows ? qb + (q0 + r / G) * p.q_st + (kvh * G + r % G) * p.q_sh : nullptr;
  }, tid);
  cp_async_commit();

  // dO: read once, zeroed on dead rows, split into shared memory and into
  // dout_split; padding rows and columns are zeros.  q is copied to q_fold.
  {
    const int f4 = 4 * nv;  // float4 chunks of a row padded to 16 columns
    const long long plane = static_cast<long long>(p.B) * p.Tq * p.H * hdv;
    for (int e = tid; e < kDqRows * f4; e += kDqThreads) {
      const int r = e / f4, c = e % f4;
      const bool real = r < nrows && 4 * c < hdv;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (real && row_m[r] > kNegInf / 2)
        x = *reinterpret_cast<const float4*>(
            p.dout + ((static_cast<long long>(b) * p.Tq + q0 + r / G) * p.H + kvh * G + r % G) * hdv + 4 * c);
      uint32_t t01[kTerms], t23[kTerms];
      split_pair(x.x, x.y, t01);
      split_pair(x.z, x.w, t23);
#pragma unroll
      for (int i = 0; i < kTerms; ++i) {
        const uint2 w = make_uint2(t01[i], t23[i]);
        *reinterpret_cast<uint2*>(dOs + (i * kDqRows + r) * kLd + 4 * c) = w;
        if (real) *reinterpret_cast<uint2*>(p.dout_split + i * plane + (fold0 + r) * hdv + 4 * c) = w;
      }
    }
    const int c16 = hdk / 8;  // 16-byte chunks of a q row
    for (int e = tid; e < nrows * c16; e += kDqThreads) {
      const int r = e / c16, c = e % c16;
      *reinterpret_cast<uint4*>(p.q_fold + (fold0 + r) * hdk + 8 * c) =
          *reinterpret_cast<const uint4*>(qb + (q0 + r / G) * p.q_st + (kvh * G + r % G) * p.q_sh + 8 * c);
    }
  }

  // this lane's two rows (accumulator rows lane / 4 and lane / 4 + 8)
  int qp[2], qs[2];
  float mr[2], dlr[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + (lane >> 2) + 8 * h;
    qp[h] = row_qpos[r];
    qs[h] = row_qstart[r];
    mr[h] = row_m[r];
    dlr[h] = row_dl[r];
    live[h] = mr[h] > kNegInf / 2;
  }

  float acc[2 * kSteps][4];  // dq rows of the warp x hd_k, in n-tiles of 8
#pragma unroll
  for (int n = 0; n < 2 * kSteps; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;

  const bf16* qa = Qs + (warp * 16 + ln.a_row) * kLd + ln.a_col;   // this warp's A fragments
  const bf16* oa = dOs + (warp * 16 + ln.a_row) * kLd + ln.a_col;
  for (int w0 = 0; w0 < n_tiles; w0 += kWindow) {
    // Which KV tiles of a window of 1024 some row sees (lane: one tile; a bit
    // mask), so the loop below needs no barrier to skip a tile.
    const int n_w = min(kWindow, n_tiles - w0);
    __syncthreads();  // the sorted rows are written; the previous window's mask is no longer read
    for (int word = warp; word * 32 < n_w; word += kDqWarps) {
      const int t = word * 32 + lane;
      bool seen = false;
      if (t < n_w) {
        const int kv0 = (w0 + t) * kBlockK, n = min(kBlockK, p.S - kv0);
        for (int j = 0; j < n && !seen; ++j) seen = slot_seen<kDqRows>(qs_sorted, qp_max, p.kv_pos[kv0 + j], p.causal);
      }
      const uint32_t bits = __ballot_sync(0xffffffffu, seen);
      if (lane == 0) mask[word] = bits;
    }
    __syncthreads();
    auto visible_tile = [&](int t) { return (mask[t >> 5] >> (t & 31)) & 1u; };
    auto next_tile = [&](int t) {  // the next visible tile after t (>= n_w: none)
      for (++t; t < n_w && !visible_tile(t); ++t) {
      }
      return t;
    };
    int cur = n_w > 0 && visible_tile(0) ? 0 : next_tile(0);
    if (cur < n_w) issue_kv(w0 + cur, 0);
    cp_async_commit();
    for (int stage = 0; cur < n_w; stage ^= 1) {
      const int nxt = next_tile(cur);
      if (nxt < n_w) issue_kv(w0 + nxt, stage ^ 1);  // that stage's readers passed the barrier below
      cp_async_commit();
      cp_async_wait<1>();  // this tile (and Q) landed
      __syncthreads();
      const bf16* Ks = KVs + stage * 2 * kBlockK * kLd;
      const bf16* Vs = Ks + kBlockK * kLd;
      const int* cpos = col_pos + stage * kBlockK;
      if (warp_live) {
        float s[kBlockK / 8][4], dp[kBlockK / 8][4];
#pragma unroll
        for (int n = 0; n < kBlockK / 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
        // s = Q . K^T
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          if (ks < nk) {
            uint32_t a[4];
            ldsm_x4(a, qa + ks * 16);
#pragma unroll
            for (int np = 0; np < kBlockK / 16; ++np) {
              uint32_t bb[4];
              ldsm_x4(bb, Ks + (np * 16 + ln.b_row) * kLd + ks * 16 + ln.b_col);
              mma(s[2 * np], a, bb[0], bb[1]);
              mma(s[2 * np + 1], a, bb[2], bb[3]);
            }
          }
        }
        // dp = dO . V^T, dO as its kTerms terms
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          if (ks < nv) {
            uint32_t a[kTerms][4];
#pragma unroll
            for (int i = 0; i < kTerms; ++i) ldsm_x4(a[i], oa + i * kDqRows * kLd + ks * 16);
#pragma unroll
            for (int np = 0; np < kBlockK / 16; ++np) {
              uint32_t bb[4];
              ldsm_x4(bb, Vs + (np * 16 + ln.b_row) * kLd + ks * 16 + ln.b_col);
#pragma unroll
              for (int i = 0; i < kTerms; ++i) {
                mma(dp[2 * np], a[i], bb[0], bb[1]);
                mma(dp[2 * np + 1], a[i], bb[2], bb[3]);
              }
            }
          }
        }
        // p = exp(s scale - m) where visible, dS = p (dp + dl), kept in s
#pragma unroll
        for (int n = 0; n < kBlockK / 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int h = j >> 1;
            const int kp = cpos[n * 8 + 2 * (lane & 3) + (j & 1)];
            const bool vis = live[h] && visible(kp, qp[h], qs[h], p.causal);
            const float pr = vis ? expf(s[n][j] * p.scale - mr[h]) : 0.f;
            s[n][j] = pr * (dp[n][j] + dlr[h]);
          }
        // dq += dS . K, one 16-slot k-step (all dS terms) per fresh chain
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
          uint32_t a[kTerms][4];
          acc_to_a(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
          for (int np = 0; np < kSteps; ++np) {
            if (np < nk) {
              uint32_t bb[4];
              ldsm_x4_t(bb, Ks + (kk * 16 + ln.t_row) * kLd + np * 16 + ln.t_col);
              float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int i = 0; i < kTerms; ++i) {
                mma(t0, a[i], bb[0], bb[1]);
                mma(t1, a[i], bb[2], bb[3]);
              }
              add_to(acc[2 * np], t0);
              add_to(acc[2 * np + 1], t1);
            }
          }
        }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
      cur = nxt;
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + (lane >> 2) + 8 * h;
    if (r < nrows) {
      float* row = p.dq + ((static_cast<long long>(b) * p.Tq + q0 + r / G) * p.H + kvh * G + r % G) * hdk;
#pragma unroll
      for (int n = 0; n < 2 * kSteps; ++n) {
        const int col = n * 8 + 2 * (lane & 3);
        if (col < hdk)
          *reinterpret_cast<float2*>(row + col) = make_float2(acc[n][2 * h] * p.scale, acc[n][2 * h + 1] * p.scale);
      }
    }
  }
}

// ---- dk/dv

constexpr size_t kDkvSmem = sizeof(bf16) * (size_t(kLd) * 2 * kBlockK + size_t(kKvGroups) * kKvBufs * kKvBufTile) +
                            sizeof(int4) * kKvGroups * kKvBufs * kKvRows + sizeof(int) * 2 * kBlockK +
                            sizeof(uint32_t) * (kWindow / 32);

// Whether some position of the ascending `sorted` 64 lies in [qs, qp] (qs
// and up when not causal) and is not PAD: the row sees some slot of the tile.
__device__ __forceinline__ bool row_sees(const int* sorted, int qp, int qs, int causal) {
  int lo = 0;  // the first position >= qs (63 if none)
#pragma unroll
  for (int step = kBlockK / 2; step >= 1; step >>= 1)
    if (sorted[lo + step - 1] < qs) lo += step;
  const int kp = sorted[lo];
  return kp >= qs && kp != kPadPos && (!causal || kp <= qp);
}

// One block per (64-slot KV tile, KV head, batch row).  Query tiles are 32
// consecutive fold-order rows of the KV head (q_fold, dout_split, row_rec,
// written by the dq kernel).  A pass of all 8 warps first decides which
// tiles of a window of 1024 some row sees (a bit mask, from the tile's sorted
// positions: no barrier per tile).  Then two warp groups of 4 warps take the
// visible tiles of even and of odd index, each with two buffers, so a
// group's next tile loads (cp.async) while it computes this one.  At the end
// group 1 hands its dk / dv sums to group 0 through shared memory.
template <bool kFull>
__global__ void __launch_bounds__(kKvThreads, 1) flash_bwd_dkv_tc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = warp / kKvWarps, gwarp = warp % kKvWarps, gtid = tid % kKvGroupThreads;
  const int bar = 1 + group;                  // barrier 0 is __syncthreads
  bf16* Ks = reinterpret_cast<bf16*>(smem);   // [kBlockK][kLd]
  bf16* Vs = Ks + kBlockK * kLd;              // [kBlockK][kLd]
  bf16* bufs = Vs + kBlockK * kLd;            // [group][buffer]: Q [kKvRows][kLd], dO [kTerms][kKvRows][kLd]
  int4* recs = reinterpret_cast<int4*>(bufs + kKvGroups * kKvBufs * kKvBufTile);  // [group][buffer][kKvRows]
  int* col_pos = reinterpret_cast<int*>(recs + kKvGroups * kKvBufs * kKvRows);    // [kBlockK]
  int* sorted = col_pos + kBlockK;                                                 // [kBlockK], ascending
  uint32_t* mask = reinterpret_cast<uint32_t*>(sorted + kBlockK);                  // [kWindow / 32]

  const Lanes ln(lane);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = p.H / p.Hkv;
  const int kv0 = blockIdx.x * kBlockK;
  const int R = p.Tq * G;                          // fold rows of the KV head
  const int n_qt = (R + kKvRows - 1) / kKvRows;
  const int hdk = kFull ? kMaxHd : p.hdk, hdv = kFull ? kMaxHd : p.hdv;
  const int nk = (hdk + 15) / 16, nv = (hdv + 15) / 16;
  const bool warp_live = kv0 + gwarp * 16 < p.S;

  {
    const bf16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
    const bf16* vb = p.v + b * p.v_sb + kvh * p.v_sh;
    load_tile_async<kBlockK, kKvThreads>(Ks, hdk, p.k, [&](int j) {
      return kv0 + j < p.S ? kb + (kv0 + j) * p.k_ss : nullptr;
    }, tid);
    load_tile_async<kBlockK, kKvThreads>(Vs, hdv, p.v, [&](int j) {
      return kv0 + j < p.S ? vb + (kv0 + j) * p.v_ss : nullptr;
    }, tid);
    cp_async_commit();
  }
  if (tid < kBlockK) col_pos[tid] = kv0 + tid < p.S ? p.kv_pos[kv0 + tid] : kPadPos;
  int kp[2];  // positions of this lane's two slots (accumulator rows lane / 4, lane / 4 + 8)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = kv0 + gwarp * 16 + (lane >> 2) + 8 * h;
    kp[h] = s < p.S ? p.kv_pos[s] : kPadPos;
  }
  __syncthreads();
  if (tid < kBlockK) {  // sort the positions: each one's rank, ties by index
    const int x = col_pos[tid];
    int rank = 0;
    for (int j = 0; j < kBlockK; ++j) {
      const int y = col_pos[j];
      rank += y < x || (y == x && j < tid);
    }
    sorted[rank] = x;
  }
  cp_async_wait<0>();
  __syncthreads();  // K, V and the sorted positions, from every thread

  float dk[2 * kSteps][4], dv[2 * kSteps][4];  // the warp's 16 slots x hd, in n-tiles of 8
#pragma unroll
  for (int n = 0; n < 2 * kSteps; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[n][j] = dv[n][j] = 0.f;

  const long long head0 = (static_cast<long long>(b) * p.Hkv + kvh) * R;  // fold row 0 of this KV head
  const long long plane = static_cast<long long>(p.B) * p.Hkv * R * hdv;
  const int4* rec_g = p.row_rec + head0;
  const bf16* kaddr = Ks + (gwarp * 16 + ln.a_row) * kLd + ln.a_col;
  const bf16* vaddr = Vs + (gwarp * 16 + ln.a_row) * kLd + ln.a_col;

  // cp.async of query tile `qt` (rows, their records) into buffer `bi` of this group
  auto issue = [&](int qt, int bi) {
    const long long r0 = static_cast<long long>(qt) * kKvRows;
    bf16* Qs = bufs + (group * kKvBufs + bi) * kKvBufTile;
    load_tile_async<kKvRows, kKvGroupThreads>(Qs, hdk, p.q_fold, [&](int r) {
      return r0 + r < R ? p.q_fold + (head0 + r0 + r) * hdk : nullptr;
    }, gtid);
#pragma unroll
    for (int i = 0; i < kTerms; ++i)
      load_tile_async<kKvRows, kKvGroupThreads>(Qs + (1 + i) * kKvRows * kLd, hdv, p.dout_split, [&](int r) {
        return r0 + r < R ? p.dout_split + i * plane + (head0 + r0 + r) * hdv : nullptr;
      }, gtid);
    if (gtid < kKvRows) {
      const bool ok = r0 + gtid < R;
      cp_async16(recs + (group * kKvBufs + bi) * kKvRows + gtid, ok ? rec_g + r0 + gtid : p.row_rec, ok);
    }
  };
  auto visible_tile = [&](int t) { return (mask[t >> 5] >> (t & 31)) & 1u; };

  for (int w0 = 0; w0 < n_qt; w0 += kWindow) {
    const int n_w = min(kWindow, n_qt - w0);
    __syncthreads();  // both groups are done with the previous window's mask
    for (int word = warp; word * 32 < n_w; word += kKvWarpsAll) {  // lane: one query tile
      const int t = word * 32 + lane;
      bool sees = false;
      if (t < n_w) {
        const int r0 = (w0 + t) * kKvRows, r1 = min(r0 + kKvRows, R);
#pragma unroll 4
        for (int r = r0; r < r1; ++r) {
          const int4 rec = rec_g[r];
          sees |= row_sees(sorted, rec.x, rec.y, p.causal);
        }
      }
      const uint32_t bits = __ballot_sync(0xffffffffu, sees);
      if (lane == 0) mask[word] = bits;
    }
    __syncthreads();

    auto next_tile = [&](int t) {  // this group's next visible tile after t (>= n_w: none)
      for (t += kKvGroups; t < n_w && !visible_tile(t); t += kKvGroups) {
      }
      return t;
    };
    int cur = group < n_w && visible_tile(group) ? group : next_tile(group);
    if (cur < n_w) issue(w0 + cur, 0);
    cp_async_commit();
    for (int bi = 0; cur < n_w; bi ^= 1) {
      const int nxt = next_tile(cur);
      if (nxt < n_w) issue(w0 + nxt, bi ^ 1);  // that buffer's readers passed the barrier below
      cp_async_commit();
      cp_async_wait<1>();  // tile `cur` landed
      group_sync(bar);
      const long long r0 = static_cast<long long>(w0 + cur) * kKvRows;
      const int nrows = static_cast<int>(min(static_cast<long long>(kKvRows), R - r0));
      const bf16* Qs = bufs + (group * kKvBufs + bi) * kKvBufTile;
      const bf16* dOs = Qs + kKvRows * kLd;
      const int4* rq = recs + (group * kKvBufs + bi) * kKvRows;
      if (warp_live) {
        for (int c0 = 0; c0 < nrows; c0 += 16) {  // 16 query rows at a time
          // s^T = K . Q^T; dp^T = V . dO^T with one accumulator per dO term, so
          // no chain of dependent MMAs is longer than the head dim's 8 steps
          float st[2][4], dpt[kTerms][2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              st[n][j] = 0.f;
#pragma unroll
              for (int i = 0; i < kTerms; ++i) dpt[i][n][j] = 0.f;
            }
#pragma unroll
          for (int ks = 0; ks < kSteps; ++ks) {
            if (ks < nk) {
              uint32_t a[4], bb[4];
              ldsm_x4(a, kaddr + ks * 16);
              ldsm_x4(bb, Qs + (c0 + ln.b_row) * kLd + ks * 16 + ln.b_col);
              mma(st[0], a, bb[0], bb[1]);
              mma(st[1], a, bb[2], bb[3]);
            }
            if (ks < nv) {
              uint32_t a[4];
              ldsm_x4(a, vaddr + ks * 16);
#pragma unroll
              for (int i = 0; i < kTerms; ++i) {
                uint32_t bb[4];
                ldsm_x4(bb, dOs + (i * kKvRows + c0 + ln.b_row) * kLd + ks * 16 + ln.b_col);
                mma(dpt[i][0], a, bb[0], bb[1]);
                mma(dpt[i][1], a, bb[2], bb[3]);
              }
            }
          }
          // p^T (kept in st) and dS^T (kept in dpt[0]); columns are query rows
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = c0 + n * 8 + 2 * (lane & 3) + (j & 1);
              const int4 rec = rq[col];
              const float mc = __int_as_float(rec.z);
              const bool vis = col < nrows && mc > kNegInf / 2 && visible(kp[j >> 1], rec.x, rec.y, p.causal);
              const float pr = vis ? expf(st[n][j] * p.scale - mc) : 0.f;
              float dp = dpt[kTerms - 1][n][j];
#pragma unroll
              for (int i = kTerms - 2; i >= 0; --i) dp += dpt[i][n][j];  // smallest term first
              st[n][j] = pr;
              dpt[0][n][j] = pr * (dp + __int_as_float(rec.w));
            }
          uint32_t pa[kTerms][4], da[kTerms][4];
          acc_to_a(st[0], st[1], pa);
          acc_to_a(dpt[0][0], dpt[0][1], da);
          // dv += p^T . dO: the six cross terms i + j < 3, one fresh chain per n-tile
#pragma unroll
          for (int np = 0; np < kSteps; ++np) {
            if (np < nv) {
              uint32_t bb[kTerms][4];
#pragma unroll
              for (int j = 0; j < kTerms; ++j)
                ldsm_x4_t(bb[j], dOs + (j * kKvRows + c0 + ln.t_row) * kLd + np * 16 + ln.t_col);
              float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int i = 0; i < kTerms; ++i)
#pragma unroll
                for (int j = 0; j < kTerms; ++j)
                  if (i + j < kTerms) {
                    mma(t0, pa[i], bb[j][0], bb[j][1]);
                    mma(t1, pa[i], bb[j][2], bb[j][3]);
                  }
              add_to(dv[2 * np], t0);
              add_to(dv[2 * np + 1], t1);
            }
          }
          // dk += dS^T . Q
#pragma unroll
          for (int np = 0; np < kSteps; ++np) {
            if (np < nk) {
              uint32_t bb[4];
              ldsm_x4_t(bb, Qs + (c0 + ln.t_row) * kLd + np * 16 + ln.t_col);
              float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int i = 0; i < kTerms; ++i) {
                mma(t0, da[i], bb[0], bb[1]);
                mma(t1, da[i], bb[2], bb[3]);
              }
              add_to(dk[2 * np], t0);
              add_to(dk[2 * np + 1], t1);
            }
          }
        }
      }
      group_sync(bar);  // the group is done with buffer bi before it is refilled
      cur = nxt;
    }
    cp_async_wait<0>();
  }

  // group 1's sums to group 0 through group 1's buffers (64 KB of fp32,
  // element i of thread t at i * 128 + t: conflict-free)
  __syncthreads();
  float* hand = reinterpret_cast<float*>(bufs + kKvBufs * kKvBufTile);
  if (group == 1) {
#pragma unroll
    for (int n = 0; n < 2 * kSteps; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hand[(n * 4 + j) * kKvGroupThreads + gtid] = dk[n][j];
        hand[((2 * kSteps + n) * 4 + j) * kKvGroupThreads + gtid] = dv[n][j];
      }
  }
  __syncthreads();
  if (group == 1) return;
#pragma unroll
  for (int n = 0; n < 2 * kSteps; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk[n][j] += hand[(n * 4 + j) * kKvGroupThreads + gtid];
      dv[n][j] += hand[((2 * kSteps + n) * 4 + j) * kKvGroupThreads + gtid];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = kv0 + gwarp * 16 + (lane >> 2) + 8 * h;
    if (s < p.S) {
      const long long row = (static_cast<long long>(b) * p.S + s) * p.Hkv + kvh;
#pragma unroll
      for (int n = 0; n < 2 * kSteps; ++n) {
        const int col = n * 8 + 2 * (lane & 3);
        if (col < hdk)
          *reinterpret_cast<float2*>(p.dk + row * hdk + col) =
              make_float2(dk[n][2 * h] * p.scale, dk[n][2 * h + 1] * p.scale);
        if (col < hdv)
          *reinterpret_cast<float2*>(p.dv + row * hdv + col) = make_float2(dv[n][2 * h], dv[n][2 * h + 1]);
      }
    }
  }
}

// ---- wide heads (MLA): hd_k <= 576, hd_v <= 512

constexpr size_t kWideDqSmem =
    sizeof(bf16) * (size_t(kWideRows) * kWideLd                   // Q
                    + size_t(kTerms) * kWideRows * kWideLdV       // dO's terms
                    + size_t(kWideBlockK) * kWideLd               // K tile
                    + size_t(kWideBlockK) * kWideLdV              // V tile (unused where V is K's view)
                    + size_t(kTerms) * kWideRows * kWideLdP)      // dS's terms
    + sizeof(int) * (kWideBlockK + 6 * kWideRows) + sizeof(uint32_t) * (kWindow / 32);

// The wide dq kernel.  One block of 8 warps per (32-row fold tile, KV head,
// batch row); fold row f is token f / G, head kvh * G + f % G.  Q and dO's
// three terms (read once, zeroed on dead rows, split) stay in shared memory;
// the kernel also writes them, with each row's record, in fold order for the
// dk/dv kernel.  Per visible 32-slot KV tile, warp w (row group w / 4,
// quarter w % 4) computes the 16 x 8 tiles of s = Q . K^T over hd_k and
// dp = dO . V^T over hd_v (one chain per dO term), p and dS = p (dp + dl),
// and writes dS's terms to shared memory; then dq += dS . K over the
// quarter's 144 columns of hd_k (a fresh chain per n-tile and tile, added
// into fp32 registers).  V is read from K's tile where v is k's view.
__global__ void __launch_bounds__(kWideThreads, 1) flash_bwd_dq_wide_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);             // [kWideRows][kWideLd]
  bf16* dOs = Qs + kWideRows * kWideLd;                 // [kTerms][kWideRows][kWideLdV]
  bf16* Ks = dOs + kTerms * kWideRows * kWideLdV;       // [kWideBlockK][kWideLd]
  bf16* Vs = Ks + kWideBlockK * kWideLd;                // [kWideBlockK][kWideLdV]
  bf16* dSs = Vs + kWideBlockK * kWideLdV;              // [kTerms][kWideRows][kWideLdP]
  int* col_pos = reinterpret_cast<int*>(dSs + kTerms * kWideRows * kWideLdP);  // [kWideBlockK]
  int* row_qpos = col_pos + kWideBlockK;
  int* row_qstart = row_qpos + kWideRows;
  float* row_m = reinterpret_cast<float*>(row_qstart + kWideRows);
  float* row_dl = row_m + kWideRows;
  int* qs_sorted = reinterpret_cast<int*>(row_dl + kWideRows);
  int* qp_max = qs_sorted + kWideRows;
  uint32_t* mask = reinterpret_cast<uint32_t*>(qp_max + kWideRows);  // [kWindow / 32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp >> 2, quarter = warp & 3;
  const Lanes ln(lane);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = p.H / p.Hkv, R = p.Tq * G;
  const int f0 = blockIdx.x * kWideRows;
  const int nrows = min(kWideRows, R - f0);
  const int n_tiles = (p.S + kWideBlockK - 1) / kWideBlockK;
  const int nk = (p.hdk + 15) / 16, nv = (p.hdv + 15) / 16;
  const int c0 = quarter * kWideColsK;  // this warp's first column of dq
  const int ndq = max(0, min(kWideColsK / 16, (p.hdk - c0 + 15) / 16));
  const bool alias = v_views_k(p);
  const long long fold0 = (static_cast<long long>(b) * p.Hkv + kvh) * R + f0;  // row 0's fold row
  const bf16* qb = p.q + b * p.q_sb;
  auto q_row = [&](int r) {
    const int f = f0 + r;
    return qb + (f / G) * p.q_st + (kvh * G + f % G) * p.q_sh;
  };

  for (int r = tid; r < kWideRows; r += kWideThreads) {  // positions, max, dl; the dk/dv kernel's records
    int qp = -1, qs = kPadPos;
    float mr = kNegInf, dr = 0.f;
    if (r < nrows) {
      const int f = f0 + r, t = f / G;
      const long long idx = (static_cast<long long>(b) * p.Tq + t) * p.H + kvh * G + f % G;
      qp = p.q_pos[b * p.qpos_sb + t];
      qs = p.q_start != nullptr ? p.q_start[b * p.qstart_sb + t] : 0;
      mr = p.m[idx];
      dr = mr > kNegInf / 2 ? p.dl[idx] : 0.f;
      p.row_rec[fold0 + r] = make_int4(qp, qs, __float_as_int(mr), __float_as_int(dr));
    }
    row_qpos[r] = qp;
    row_qstart[r] = qs;
    row_m[r] = mr;
    row_dl[r] = dr;
  }
  load_rows_async<kWideRows, kWideThreads, kWideLd>(Qs, p.hdk, p.q, [&](int r) {
    return r < nrows ? q_row(r) : nullptr;
  }, tid);
  cp_async_commit();
  __syncthreads();
  sort_rows<kWideRows>(row_qpos, row_qstart, qs_sorted, qp_max, tid);

  // dO: read once, zeroed on dead rows, split into shared memory and into
  // dout_split; padding rows and columns are zeros.  q is copied to q_fold.
  {
    const int f4 = 4 * nv;  // float4 chunks of a row padded to 16 columns
    const long long plane = static_cast<long long>(p.B) * p.Tq * p.H * p.hdv;
    for (int e = tid; e < kWideRows * f4; e += kWideThreads) {
      const int r = e / f4, c = e % f4, f = f0 + r;
      const bool real = r < nrows && 4 * c < p.hdv;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (real && row_m[r] > kNegInf / 2)
        x = *reinterpret_cast<const float4*>(
            p.dout + ((static_cast<long long>(b) * p.Tq + f / G) * p.H + kvh * G + f % G) * p.hdv + 4 * c);
      uint32_t t01[kTerms], t23[kTerms];
      split_pair(x.x, x.y, t01);
      split_pair(x.z, x.w, t23);
#pragma unroll
      for (int i = 0; i < kTerms; ++i) {
        const uint2 w = make_uint2(t01[i], t23[i]);
        *reinterpret_cast<uint2*>(dOs + (i * kWideRows + r) * kWideLdV + 4 * c) = w;
        if (real) *reinterpret_cast<uint2*>(p.dout_split + i * plane + (fold0 + r) * p.hdv + 4 * c) = w;
      }
    }
    const int c16 = p.hdk / 8;  // 16-byte chunks of a q row
    for (int e = tid; e < nrows * c16; e += kWideThreads) {
      const int r = e / c16, c = e % c16;
      *reinterpret_cast<uint4*>(p.q_fold + (fold0 + r) * p.hdk + 8 * c) =
          *reinterpret_cast<const uint4*>(q_row(r) + 8 * c);
    }
  }

  int rr[2], qp[2], qs[2];  // this lane's two rows of the row group
  float mr[2], dlr[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rr[h] = rg * 16 + (lane >> 2) + 8 * h;
    qp[h] = row_qpos[rr[h]];
    qs[h] = row_qstart[rr[h]];
    mr[h] = row_m[rr[h]];
    dlr[h] = row_dl[rr[h]];
    live[h] = mr[h] > kNegInf / 2;
  }
  float acc[2 * kWideColsK / 16][4];  // dq: 16 rows x the quarter's 144 columns
#pragma unroll
  for (int n = 0; n < 2 * kWideColsK / 16; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;

  const bf16* kbase = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vbase = p.v + b * p.v_sb + kvh * p.v_sh;
  const bf16* Vt = alias ? Ks : Vs;
  const int ldv = alias ? kWideLd : kWideLdV;
  const bf16* qa = Qs + (rg * 16 + ln.a_row) * kWideLd + ln.a_col;
  const bf16* oa = dOs + (rg * 16 + ln.a_row) * kWideLdV + ln.a_col;
  const bf16* kb = Ks + (quarter * 8 + ln.b_row) * kWideLd + ln.b_col;
  const bf16* vb = Vt + (quarter * 8 + ln.b_row) * ldv + ln.b_col;
  const bf16* da_at = dSs + (rg * 16 + ln.a_row) * kWideLdP + ln.a_col;
  const int pcol = quarter * 8 + 2 * (lane & 3);  // this lane's slot pair of the tile

  for (int w0 = 0; w0 < n_tiles; w0 += kWindow) {
    // which KV tiles of a window of 1024 some row sees (lane: one tile)
    const int n_w = min(kWindow, n_tiles - w0);
    __syncthreads();
    for (int word = warp; word * 32 < n_w; word += kWideWarps) {
      const int t = word * 32 + lane;
      bool seen = false;
      if (t < n_w) {
        const int kv0 = (w0 + t) * kWideBlockK, n = min(kWideBlockK, p.S - kv0);
        for (int j = 0; j < n && !seen; ++j)
          seen = slot_seen<kWideRows>(qs_sorted, qp_max, p.kv_pos[kv0 + j], p.causal);
      }
      const uint32_t bits = __ballot_sync(0xffffffffu, seen);
      if (lane == 0) mask[word] = bits;
    }
    __syncthreads();
    for (int t = 0; t < n_w; ++t) {
      if (!((mask[t >> 5] >> (t & 31)) & 1u)) continue;  // the same for every thread
      const int kv0 = (w0 + t) * kWideBlockK;
      load_rows_async<kWideBlockK, kWideThreads, kWideLd>(Ks, p.hdk, p.k, [&](int j) {
        return kv0 + j < p.S ? kbase + (kv0 + j) * p.k_ss : nullptr;
      }, tid);
      if (!alias)
        load_rows_async<kWideBlockK, kWideThreads, kWideLdV>(Vs, p.hdv, p.v, [&](int j) {
          return kv0 + j < p.S ? vbase + (kv0 + j) * p.v_ss : nullptr;
        }, tid);
      cp_async_commit();
      if (tid < kWideBlockK) col_pos[tid] = kv0 + tid < p.S ? p.kv_pos[kv0 + tid] : kPadPos;
      cp_async_wait<0>();  // this tile (and Q) landed
      __syncthreads();

      // s = Q . K^T and dp = dO . V^T: the row group's 16 rows x the quarter's 8 slots
      float s[4], dpc[kTerms][4];
      dot_tile(s, qa, kb, nk);
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dpc[i][j] = 0.f;
      for (int ks = 0; ks < nv; ++ks) {
        uint32_t bf[2];
        ldsm_x2(bf, vb + ks * 16);
#pragma unroll
        for (int i = 0; i < kTerms; ++i) {
          uint32_t af[4];
          ldsm_x4(af, oa + i * kWideRows * kWideLdV + ks * 16);
          mma(dpc[i], af, bf[0], bf[1]);
        }
      }
      // p = exp(s scale - m) where visible, dS = p (dp + dl): its terms to shared memory
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = j >> 1;
        const bool vis = live[h] && visible(col_pos[pcol + (j & 1)], qp[h], qs[h], p.causal);
        const float pr = vis ? expf(s[j] * p.scale - mr[h]) : 0.f;
        const float dp = dpc[2][j] + dpc[1][j] + dpc[0][j];  // smallest term first
        ds[j] = pr * (dp + dlr[h]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_split<kWideRows * kWideLdP>(dSs, rr[h] * kWideLdP + pcol, ds[2 * h], ds[2 * h + 1]);
      __syncthreads();

      // dq += dS . K over the quarter's columns: a fresh chain per n-tile
#pragma unroll
      for (int kk = 0; kk < kWideBlockK / 16; ++kk) {
        uint32_t a[kTerms][4];
#pragma unroll
        for (int i = 0; i < kTerms; ++i) ldsm_x4(a[i], da_at + i * kWideRows * kWideLdP + kk * 16);
#pragma unroll
        for (int np = 0; np < kWideColsK / 16; ++np) {
          if (np < ndq) {
            uint32_t bb[4];
            ldsm_x4_t(bb, Ks + (kk * 16 + ln.t_row) * kWideLd + c0 + np * 16 + ln.t_col);
            float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int i = 0; i < kTerms; ++i) {
              mma(t0, a[i], bb[0], bb[1]);
              mma(t1, a[i], bb[2], bb[3]);
            }
            add_to(acc[2 * np], t0);
            add_to(acc[2 * np + 1], t1);
          }
        }
      }
      __syncthreads();  // every warp is done with the tile before the next lands
    }
  }
  cp_async_wait<0>();  // Q, where no tile was visible

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rr[h] < nrows) {
      const int f = f0 + rr[h];
      float* row = p.dq + ((static_cast<long long>(b) * p.Tq + f / G) * p.H + kvh * G + f % G) * p.hdk;
#pragma unroll
      for (int n = 0; n < 2 * kWideColsK / 16; ++n) {
        const int col = c0 + n * 8 + 2 * (lane & 3);
        if (col < p.hdk)
          *reinterpret_cast<float2*>(row + col) = make_float2(acc[n][2 * h] * p.scale, acc[n][2 * h + 1] * p.scale);
      }
    }
  }
}

constexpr size_t kWideDkvSmem =
    sizeof(bf16) * (size_t(kWideBlockK) * kWideLd                 // K tile
                    + size_t(kWideBlockK) * kWideLdV              // V tile (unused where V is K's view)
                    + size_t(kWideRows) * kWideLd                 // the query tile's q
                    + size_t(kTerms) * kWideRows * kWideLdV       // its dO terms
                    + 2 * size_t(kTerms) * kWideBlockK * kWideLdP)  // p^T's and dS^T's terms
    + sizeof(int4) * kWideRows + sizeof(int) * 2 * kWideBlockK + sizeof(uint32_t) * (kWindow / 32);

// Whether some position of the ascending `sorted` kN lies in [qs, qp] (qs
// and up when not causal) and is not PAD.
template <int kN>
__device__ __forceinline__ bool row_sees_n(const int* sorted, int qp, int qs, int causal) {
  int lo = 0;
#pragma unroll
  for (int step = kN / 2; step >= 1; step >>= 1)
    if (sorted[lo + step - 1] < qs) lo += step;
  const int kp = sorted[lo];
  return kp >= qs && kp != kPadPos && (!causal || kp <= qp);
}

// The wide dk/dv kernel.  One block of 8 warps per (32-slot KV tile, KV
// head, batch row), over 32-row query tiles of the fold rows (q_fold,
// dout_split, row_rec, written by the wide dq kernel); the visible ones are
// decided up front into a bit mask.  Per query tile, warp w (slot group
// w / 4, quarter w % 4) computes the 16 x 8 tiles of s^T = K . Q^T and
// dp^T = V . dO^T (slots as rows, the quarter's 8 query rows as columns),
// p^T and dS^T, and writes their terms to shared memory; then dv += p^T . dO
// (the six cross terms i + j < 3) over the quarter's 128 columns of hd_v and
// dk += dS^T . Q over its 144 columns of hd_k.  The G heads are query rows,
// so the sum over them is the reduction dimension: no atomics.
__global__ void __launch_bounds__(kWideThreads, 1) flash_bwd_dkv_wide_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);             // [kWideBlockK][kWideLd]
  bf16* Vs = Ks + kWideBlockK * kWideLd;                // [kWideBlockK][kWideLdV]
  bf16* Qs = Vs + kWideBlockK * kWideLdV;               // [kWideRows][kWideLd]
  bf16* dOs = Qs + kWideRows * kWideLd;                 // [kTerms][kWideRows][kWideLdV]
  bf16* PTs = dOs + kTerms * kWideRows * kWideLdV;      // [kTerms][kWideBlockK][kWideLdP]
  bf16* DSTs = PTs + kTerms * kWideBlockK * kWideLdP;   // [kTerms][kWideBlockK][kWideLdP]
  int4* recs = reinterpret_cast<int4*>(DSTs + kTerms * kWideBlockK * kWideLdP);  // [kWideRows]
  int* col_pos = reinterpret_cast<int*>(recs + kWideRows);                       // [kWideBlockK]
  int* sorted = col_pos + kWideBlockK;                                           // [kWideBlockK], ascending
  uint32_t* mask = reinterpret_cast<uint32_t*>(sorted + kWideBlockK);            // [kWindow / 32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sg = warp >> 2, quarter = warp & 3;
  const Lanes ln(lane);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int G = p.H / p.Hkv, R = p.Tq * G;
  const int kv0 = blockIdx.x * kWideBlockK;
  const int n_qt = (R + kWideRows - 1) / kWideRows;
  const int nk = (p.hdk + 15) / 16, nv = (p.hdv + 15) / 16;
  const int ck = quarter * kWideColsK, cv = quarter * kWideColsV;  // this warp's first dk, dv columns
  const int ndk = max(0, min(kWideColsK / 16, (p.hdk - ck + 15) / 16));
  const int ndv = max(0, min(kWideColsV / 16, (p.hdv - cv + 15) / 16));
  const bool alias = v_views_k(p);

  {
    const bf16* kbase = p.k + b * p.k_sb + kvh * p.k_sh;
    const bf16* vbase = p.v + b * p.v_sb + kvh * p.v_sh;
    load_rows_async<kWideBlockK, kWideThreads, kWideLd>(Ks, p.hdk, p.k, [&](int j) {
      return kv0 + j < p.S ? kbase + (kv0 + j) * p.k_ss : nullptr;
    }, tid);
    if (!alias)
      load_rows_async<kWideBlockK, kWideThreads, kWideLdV>(Vs, p.hdv, p.v, [&](int j) {
        return kv0 + j < p.S ? vbase + (kv0 + j) * p.v_ss : nullptr;
      }, tid);
    cp_async_commit();
  }
  if (tid < kWideBlockK) col_pos[tid] = kv0 + tid < p.S ? p.kv_pos[kv0 + tid] : kPadPos;
  int kp[2];  // positions of this lane's two slots (accumulator rows lane / 4, lane / 4 + 8)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = kv0 + sg * 16 + (lane >> 2) + 8 * h;
    kp[h] = s < p.S ? p.kv_pos[s] : kPadPos;
  }
  __syncthreads();
  if (tid < kWideBlockK) {  // sort the positions: each one's rank, ties by index
    const int x = col_pos[tid];
    int rank = 0;
    for (int j = 0; j < kWideBlockK; ++j) {
      const int y = col_pos[j];
      rank += y < x || (y == x && j < tid);
    }
    sorted[rank] = x;
  }
  cp_async_wait<0>();
  __syncthreads();  // K, V and the sorted positions, from every thread

  float dk[2 * kWideColsK / 16][4], dv[2 * kWideColsV / 16][4];  // 16 slots x the quarter's columns
#pragma unroll
  for (int n = 0; n < 2 * kWideColsK / 16; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[n][j] = 0.f;
#pragma unroll
  for (int n = 0; n < 2 * kWideColsV / 16; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dv[n][j] = 0.f;

  const long long head0 = (static_cast<long long>(b) * p.Hkv + kvh) * R;  // fold row 0 of this KV head
  const long long plane = static_cast<long long>(p.B) * p.Hkv * R * p.hdv;
  const int4* rec_g = p.row_rec + head0;
  const bf16* Vt = alias ? Ks : Vs;
  const int ldv = alias ? kWideLd : kWideLdV;
  const bf16* ka = Ks + (sg * 16 + ln.a_row) * kWideLd + ln.a_col;
  const bf16* va = Vt + (sg * 16 + ln.a_row) * ldv + ln.a_col;
  const bf16* qb = Qs + (quarter * 8 + ln.b_row) * kWideLd + ln.b_col;
  const bf16* ob = dOs + (quarter * 8 + ln.b_row) * kWideLdV + ln.b_col;
  const int srow[2] = {sg * 16 + (lane >> 2), sg * 16 + (lane >> 2) + 8};  // this lane's slot rows
  const int qcol = quarter * 8 + 2 * (lane & 3);  // this lane's query-row pair of the tile

  for (int w0 = 0; w0 < n_qt; w0 += kWindow) {
    const int n_w = min(kWindow, n_qt - w0);
    __syncthreads();  // the previous window's mask is no longer read
    for (int word = warp; word * 32 < n_w; word += kWideWarps) {  // lane: one query tile
      const int t = word * 32 + lane;
      bool sees = false;
      if (t < n_w) {
        const int r0 = (w0 + t) * kWideRows, r1 = min(r0 + kWideRows, R);
#pragma unroll 4
        for (int r = r0; r < r1; ++r) {
          const int4 rec = rec_g[r];
          sees |= row_sees_n<kWideBlockK>(sorted, rec.x, rec.y, p.causal);
        }
      }
      const uint32_t bits = __ballot_sync(0xffffffffu, sees);
      if (lane == 0) mask[word] = bits;
    }
    __syncthreads();
    for (int t = 0; t < n_w; ++t) {
      if (!((mask[t >> 5] >> (t & 31)) & 1u)) continue;  // the same for every thread
      const long long r0 = static_cast<long long>(w0 + t) * kWideRows;
      const int nrows = static_cast<int>(min(static_cast<long long>(kWideRows), R - r0));
      load_rows_async<kWideRows, kWideThreads, kWideLd>(Qs, p.hdk, p.q_fold, [&](int r) {
        return r < nrows ? p.q_fold + (head0 + r0 + r) * p.hdk : nullptr;
      }, tid);
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
        load_rows_async<kWideRows, kWideThreads, kWideLdV>(dOs + i * kWideRows * kWideLdV, p.hdv, p.dout_split,
                                                           [&](int r) {
          return r < nrows ? p.dout_split + i * plane + (head0 + r0 + r) * p.hdv : nullptr;
        }, tid);
      if (tid < kWideRows) {
        const bool ok = tid < nrows;
        cp_async16(recs + tid, ok ? rec_g + r0 + tid : p.row_rec, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      // s^T = K . Q^T and dp^T = V . dO^T: the slot group's 16 slots x the quarter's 8 query rows
      float st[4], dpc[kTerms][4];
      dot_tile(st, ka, qb, nk);
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dpc[i][j] = 0.f;
      for (int ks = 0; ks < nv; ++ks) {
        uint32_t af[4];
        ldsm_x4(af, va + ks * 16);
#pragma unroll
        for (int i = 0; i < kTerms; ++i) {
          uint32_t bf[2];
          ldsm_x2(bf, ob + i * kWideRows * kWideLdV + ks * 16);
          mma(dpc[i], af, bf[0], bf[1]);
        }
      }
      // p^T and dS^T; columns are query rows
      float pt[4], dst[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = qcol + (j & 1);
        const int4 rec = recs[col];
        const float mc = __int_as_float(rec.z);
        const bool vis = col < nrows && mc > kNegInf / 2 && visible(kp[j >> 1], rec.x, rec.y, p.causal);
        pt[j] = vis ? expf(st[j] * p.scale - mc) : 0.f;
        const float dp = dpc[2][j] + dpc[1][j] + dpc[0][j];  // smallest term first
        dst[j] = pt[j] * (dp + __int_as_float(rec.w));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        store_split<kWideBlockK * kWideLdP>(PTs, srow[h] * kWideLdP + qcol, pt[2 * h], pt[2 * h + 1]);
        store_split<kWideBlockK * kWideLdP>(DSTs, srow[h] * kWideLdP + qcol, dst[2 * h], dst[2 * h + 1]);
      }
      __syncthreads();

      // dv += p^T . dO and dk += dS^T . Q over the quarter's columns, one
      // 16-row k-step at a time, each a fresh chain per n-tile
#pragma unroll
      for (int kk = 0; kk < kWideRows / 16; ++kk) {
        uint32_t pa[kTerms][4], da[kTerms][4];
#pragma unroll
        for (int i = 0; i < kTerms; ++i) {
          ldsm_x4(pa[i], PTs + (i * kWideBlockK + sg * 16 + ln.a_row) * kWideLdP + kk * 16 + ln.a_col);
          ldsm_x4(da[i], DSTs + (i * kWideBlockK + sg * 16 + ln.a_row) * kWideLdP + kk * 16 + ln.a_col);
        }
#pragma unroll
        for (int np = 0; np < kWideColsV / 16; ++np) {
          if (np < ndv) {
            uint32_t bb[kTerms][4];
#pragma unroll
            for (int j = 0; j < kTerms; ++j)
              ldsm_x4_t(bb[j], dOs + (j * kWideRows + kk * 16 + ln.t_row) * kWideLdV + cv + np * 16 + ln.t_col);
            float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int i = 0; i < kTerms; ++i)
#pragma unroll
              for (int j = 0; j < kTerms; ++j)
                if (i + j < kTerms) {
                  mma(t0, pa[i], bb[j][0], bb[j][1]);
                  mma(t1, pa[i], bb[j][2], bb[j][3]);
                }
            add_to(dv[2 * np], t0);
            add_to(dv[2 * np + 1], t1);
          }
        }
#pragma unroll
        for (int np = 0; np < kWideColsK / 16; ++np) {
          if (np < ndk) {
            uint32_t bb[4];
            ldsm_x4_t(bb, Qs + (kk * 16 + ln.t_row) * kWideLd + ck + np * 16 + ln.t_col);
            float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int i = 0; i < kTerms; ++i) {
              mma(t0, da[i], bb[0], bb[1]);
              mma(t1, da[i], bb[2], bb[3]);
            }
            add_to(dk[2 * np], t0);
            add_to(dk[2 * np + 1], t1);
          }
        }
      }
      __syncthreads();  // every warp is done with the query tile before the next lands
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = kv0 + srow[h];
    if (s < p.S) {
      const long long row = (static_cast<long long>(b) * p.S + s) * p.Hkv + kvh;
#pragma unroll
      for (int n = 0; n < 2 * kWideColsK / 16; ++n) {
        const int col = ck + n * 8 + 2 * (lane & 3);
        if (col < p.hdk)
          *reinterpret_cast<float2*>(p.dk + row * p.hdk + col) =
              make_float2(dk[n][2 * h] * p.scale, dk[n][2 * h + 1] * p.scale);
      }
#pragma unroll
      for (int n = 0; n < 2 * kWideColsV / 16; ++n) {
        const int col = cv + n * 8 + 2 * (lane & 3);
        if (col < p.hdv)
          *reinterpret_cast<float2*>(p.dv + row * p.hdv + col) = make_float2(dv[n][2 * h], dv[n][2 * h + 1]);
      }
    }
  }
}

template <typename K>
cudaError_t launch(K kernel, size_t smem, bool& configured, dim3 grid, int threads, const Params& p,
                   cudaStream_t stream) {
  if (!configured) {  // one attribute call per kernel
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// which: 0 = the dq kernel (writes dq, and dout_split, q_fold and row_rec),
// 1 = the dk/dv kernel (writes dk and dv; reads what the dq kernel wrote, so
// it runs after it on the same stream).  q, k and v are bf16 with element
// strides, loaded in 16-byte vectors (bases, strides and head dims whole
// vectors); dout [B, Tq, H, hdv], m and dl [B, Tq, H] are contiguous fp32; dq
// [B, Tq, H, hdk], dk [B, S, Hkv, hdk] and dv [B, S, Hkv, hdv] are contiguous
// fp32 outputs, every element written; dout_split [3, B, Hkv, Tq * G, hdv]
// and q_fold [B, Hkv, Tq * G, hdk] (bf16) and row_rec [B, Hkv, Tq * G, 4]
// (int32) are contiguous scratch.  q_pos and q_start are int32 rows of Tq
// with batch strides qpos_sb / qstart_sb (0: shared by the batch); q_start
// may be null.  bq: query tokens per dq tile, G x bq <= 128.
// Returns a cudaError_t.
extern "C" int flash_partial_bwd_tc(int which, const void* q, const void* k, const void* v, const float* dout,
                                    const float* m, const float* dl, const int* q_pos, const int* kv_pos,
                                    const int* q_start, void* dout_split, void* q_fold, void* row_rec, float* dq,
                                    float* dk, float* dv, int B, int Tq, int S, int H, int Hkv, int hdk, int hdv,
                                    int bq, int qpos_sb, int qstart_sb, long long q_sb, long long q_st,
                                    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                    long long v_ss, long long v_sh, float scale, int causal, void* stream) {
  if (which < 0 || which > 1 || B <= 0 || Tq <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || bq <= 0 ||
      hdk <= 0 || hdk > kMaxHd || hdv <= 0 || hdv > kMaxHd || (H / Hkv) * bq > kDqRows ||
      dout_split == nullptr || q_fold == nullptr || row_rec == nullptr || (which == 0 && dq == nullptr) ||
      (which == 1 && (dk == nullptr || dv == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16 || reinterpret_cast<uintptr_t>(dout) % 16 ||
      reinterpret_cast<uintptr_t>(dout_split) % 16 || reinterpret_cast<uintptr_t>(q_fold) % 16 ||
      reinterpret_cast<uintptr_t>(row_rec) % 16 || hdk % 8 || hdv % 8 || q_sb % 8 || q_st % 8 || q_sh % 8 ||
      k_sb % 8 || k_ss % 8 || k_sh % 8 || v_sb % 8 || v_ss % 8 || v_sh % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), dout, m, dl,
                 q_pos, kv_pos, q_start, static_cast<bf16*>(dout_split), static_cast<bf16*>(q_fold),
                 static_cast<int4*>(row_rec), dq, dk, dv, B, Tq, S, H, Hkv, hdk, hdv, bq, qpos_sb, qstart_sb,
                 q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool full = hdk == kMaxHd && hdv == kMaxHd;
  static bool configured[2][2] = {};  // [which][full]
  const dim3 dq_grid((Tq + bq - 1) / bq, Hkv, B), dkv_grid((S + kBlockK - 1) / kBlockK, Hkv, B);
  cudaError_t e;
  if (which == 0)
    e = full ? launch(flash_bwd_dq_tc_kernel<true>, kDqSmem, configured[0][1], dq_grid, kDqThreads, p, s)
             : launch(flash_bwd_dq_tc_kernel<false>, kDqSmem, configured[0][0], dq_grid, kDqThreads, p, s);
  else
    e = full ? launch(flash_bwd_dkv_tc_kernel<true>, kDkvSmem, configured[1][1], dkv_grid, kKvThreads, p, s)
             : launch(flash_bwd_dkv_tc_kernel<false>, kDkvSmem, configured[1][0], dkv_grid, kKvThreads, p, s);
  return static_cast<int>(e);
}

// The wide pair (MLA's hd_k <= 576, hd_v <= 512): the arguments of
// flash_partial_bwd_tc without bq (a dq block is 32 fold rows of G x Tq per
// KV head, a dk/dv block 32 slots); the scratch has the same layout.  v may
// be a view of k (its first hd_v columns, k's base and strides), and is then
// read from k's tiles.
extern "C" int flash_partial_bwd_tc_wide(int which, const void* q, const void* k, const void* v, const float* dout,
                                         const float* m, const float* dl, const int* q_pos, const int* kv_pos,
                                         const int* q_start, void* dout_split, void* q_fold, void* row_rec,
                                         float* dq, float* dk, float* dv, int B, int Tq, int S, int H, int Hkv,
                                         int hdk, int hdv, int qpos_sb, int qstart_sb, long long q_sb,
                                         long long q_st, long long q_sh, long long k_sb, long long k_ss,
                                         long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                         float scale, int causal, void* stream) {
  if (which < 0 || which > 1 || B <= 0 || Tq <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || hdk <= 0 ||
      hdk > kWideHdK || hdv <= 0 || hdv > kWideHdV || dout_split == nullptr || q_fold == nullptr ||
      row_rec == nullptr || (which == 0 && dq == nullptr) || (which == 1 && (dk == nullptr || dv == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16 || reinterpret_cast<uintptr_t>(dout) % 16 ||
      reinterpret_cast<uintptr_t>(dout_split) % 16 || reinterpret_cast<uintptr_t>(q_fold) % 16 ||
      reinterpret_cast<uintptr_t>(row_rec) % 16 || hdk % 8 || hdv % 8 || q_sb % 8 || q_st % 8 || q_sh % 8 ||
      k_sb % 8 || k_ss % 8 || k_sh % 8 || v_sb % 8 || v_ss % 8 || v_sh % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), dout, m, dl,
                 q_pos, kv_pos, q_start, static_cast<bf16*>(dout_split), static_cast<bf16*>(q_fold),
                 static_cast<int4*>(row_rec), dq, dk, dv, B, Tq, S, H, Hkv, hdk, hdv, 1, qpos_sb, qstart_sb,
                 q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool configured[2] = {};
  const int R = Tq * (H / Hkv);
  if (which == 0)
    return static_cast<int>(launch(flash_bwd_dq_wide_kernel, kWideDqSmem, configured[0],
                                   dim3((R + kWideRows - 1) / kWideRows, Hkv, B), kWideThreads, p, s));
  return static_cast<int>(launch(flash_bwd_dkv_wide_kernel, kWideDkvSmem, configured[1],
                                 dim3((S + kWideBlockK - 1) / kWideBlockK, Hkv, B), kWideThreads, p, s));
}
