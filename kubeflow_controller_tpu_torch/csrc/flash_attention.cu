// Flash attention forward and backward on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of kubeflow_controller_tpu/ops/attention.py:
//   flash_fwd <- _fwd_kernel (l.62, launched by _fwd l.123): blocked online
//                softmax, causal block skip; writes O and the per-row lse.
//   flash_dq  <- _dq_kernel (l.174, _bwd_calls l.255): the q block stays,
//                k blocks stream: p = exp(s - lse), ds = p (dO V^T - delta),
//                dQ += ds K, scaled once at the end.
//   flash_dkv <- _dkv_kernel (l.208, _bwd_calls l.272): the k block stays,
//                q blocks stream: dV += p^T dO, dK += ds^T Q.
//
// Contract (ops/attention.py checks it): q, k, v, o, do, dq, dk, dv are
// contiguous [B, T, H, D] bf16 (the model's layout, read through strides:
// no [B*H, T, D] transpose); lse and delta are contiguous [B*H, T] f32 (one
// value per row: the reference's 128-lane broadcast is a Mosaic tiling rule);
// D is 64 or 128 and T a multiple of 64.  Offsets are 64-bit.  B * H is
// folded into the grid's x extent with the blocks of one head, so any B * H
// whose grid fits 2^31 - 1 blocks is taken.
//
// The arithmetic is the reference's, rounding places included: scores are
// bf16 x bf16 products accumulated in f32 and then multiplied by scale;
// masked scores are NEG_INF = -1e30 (finite, so exp(m_prev - m_new) is 0 on
// the first block, never NaN); p is rounded to bf16 before p V and p^T dO,
// ds before ds K and ds^T Q; l is floored at 1e-30; dQ and dK are scaled
// after the ds products.
//
// What bounds it on this card.  At the pretrain shape (B 4, H 32, T 4096,
// D 128, causal) the forward is ~550 GFLOP of tensor-core work against
// ~0.54 GB of HBM traffic: ~0.56 ms at the bf16 peak, 0.16 ms at the byte
// rate, so operations bound it, as they do dQ (~825 GFLOP) and dKV (~1100).
//
// What the designs do about it.  All three are warp-specialised wgmma
// kernels on the same machinery (csrc/hopper.cuh): one producer issues TMA
// loads through tensor maps over q, k, v and do as [B][T][H * D] (64-wide
// 128-byte-swizzled boxes, two per 128-wide head; the batch a coordinate of
// its own, so a tile that runs past T reads zeros, never the next
// sequence), into tiles loaded once and a ring of stages with a full
// barrier each and an empty barrier both consumers arrive on.  Two consumer
// warpgroups own 64 rows each and run wgmma on what has arrived; f32
// accumulators are rounded pairwise to bf16 in registers as the A operand
// of the next product (the register-A wgmma), so no score tile touches
// shared or global memory.  Only the diagonal stage is masked, causal
// stages past it are never loaded, and the heaviest blocks of each head are
// scheduled first.  Each warpgroup runs its stages in turn; while one runs
// its elementwise work, the other's products keep the tensor cores busy.
//
// flash_fwd: a block owns 128 q rows of one head; the producer warpgroup
//   gives its registers back (setmaxnreg) and loads Q once, K and V through
//   a two-stage ring of 128-key stages (a full barrier for each of K and
//   V).  S = Q K^T is wgmma.m64n128k16 with both operands K-major; the
//   online softmax runs on the f32 accumulator, a row's statistics reduced
//   over the 4 lanes of a quad by shuffles; P feeds O += P V from registers,
//   V an MN-major B operand.  (Issuing block j's scores ahead of block
//   j - 1's P V needs a second score tile; it spilled and was slower while
//   the consumers were held to 168 registers, and is untried at 240.)
//
// flash_dq: a block owns 128 q rows of one head.  Q and dO load once; K and
//   V stream through a two-stage ring of 64-key stages.  S = Q K^T and
//   dP = dO V^T are wgmma.m64n64k16 with both operands K-major; p and ds
//   are computed on the accumulators with each row's lse and delta held in
//   registers; dQ += dS K takes dS from registers and reads the same K stage
//   MN-major.  A consumer holds dQ (D / 2), S and dP (32 each) and the dS
//   fragments (16): ~150 live values at D 128.
//
// flash_dkv: a block owns 128 keys of one head (K and V load once); q rows
//   stream through a two-stage ring of 64-row stages holding Q, dO and the
//   rows' lse and delta (a 1-D bulk copy on the same barrier).  S^T = K Q^T
//   and dP^T = V dO^T are wgmma.m64n64k16 with both operands K-major, so p^T
//   and ds^T come out in registers as the A operands of dV += p^T dO and
//   dK += ds^T Q, which read the same dO and Q stages MN-major.  lse and
//   delta index the accumulator's columns, so each thread reads them from
//   the stage in shared memory.  A consumer holds dK and dV (D / 2 each)
//   and S^T and dP^T (32 each): ~200 live values at D 128, over the 168 a
//   thread of a 384-thread block gets at launch.  The consumers run at the
//   240 that setmaxnreg grants them (the producer gives its registers
//   back; tools/setmaxnreg_probe.py) and read lse and delta a column group
//   at a time.
//
// Both backward kernels run each stage in turn within a warpgroup (scores,
// elementwise, products, one wait each).  Issuing a stage's last products
// back to back with the next stage's scores measured slower: ptxas
// serializes the wgmmas across the loop's divergent edge (C7518).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int T_GRAIN = 64;   // T must be a multiple of it
constexpr float NEG_INF = -1e30f;

constexpr int FW_BQ = 128;   // q rows per block: two consumer warpgroups
constexpr int FW_BKV = 128;  // keys per K/V stage
constexpr int FW_STAGES = 2;
constexpr int FW_THREADS = 3 * 128;  // producer + two consumers
constexpr int FW_BOX = 128 * 128;    // bytes of one [128 rows][64] bf16 box

// The backward kernels: two consumer warpgroups (threads 0-255), then the
// producer warpgroup; rows per block and per stage.
constexpr int BW_BLOCK = 128;  // q rows (dQ) or keys (dKV) per block
constexpr int BW_STEP = 64;    // keys (dQ) or q rows (dKV) per stage
constexpr int DQ_STAGES = 2;   // K/V stages in dQ's ring
constexpr int DKV_STAGES = 2;  // Q/dO stages in dKV's ring
constexpr int BW_CONSUMERS = 256;
constexpr int BW_THREADS = BW_CONSUMERS + 128;
constexpr int BOX64 = 64 * 128;  // bytes of one [64 rows][64] bf16 box

// setmaxnreg split of a block of one producer and two consumer warpgroups:
// 128 x 24 + 256 x 240 = 64,512 registers, the launch's 384 x 168.
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// Block x of a grid of `per_head` blocks for each of B * H heads: its head
// (b, h, and bh = b * H + h) and its index i among the head's blocks.  Each
// role decodes it after its setmaxnreg, so nothing derived from it need
// stay live across the producer's cut to 24 registers.
struct HeadBlock {
  int b, h, bh, i;
};

__device__ __forceinline__ HeadBlock head_block(int per_head, int H) {
  HeadBlock hb;
  hb.bh = blockIdx.x / per_head;
  hb.i = blockIdx.x - hb.bh * per_head;
  hb.b = hb.bh / H;
  hb.h = hb.bh - hb.b * H;
  return hb;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Reduce over the 4 lanes that hold one row of an accumulator fragment.
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint8_t* align_smem(uint8_t* raw) {
  return raw + ((hopper::SWIZZLE_ATOM -
                 hopper::smem_u32(raw) % hopper::SWIZZLE_ATOM) %
                hopper::SWIZZLE_ATOM);
}

// K-major descriptor steps over D, 16 deep: 32 B along a 128-byte row, and
// every 64 columns to the next box (of BOX bytes).
template <int BOX>
__device__ __forceinline__ uint64_t d_step(int kk) {
  return ((kk / 4) * BOX + (kk % 4) * 32) >> 4;
}

// Rows r and r + 8 (r = 16 w + l / 4 from `row_lo`) of a [64][D] f32
// accumulator, times mul, to bf16 rows of stride rs.
template <int D>
__device__ __forceinline__ void store_acc(bf16* g, int64_t rs, int row_lo,
                                          int l, const float (&acc)[D / 2],
                                          float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = row_lo + 8 * r;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(g + row * rs + 8 * jj +
                                         2 * (l % 4)) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * r] * mul,
                                acc[4 * jj + 2 * r + 1] * mul);
  }
}

// dQ += dS K (or dV += P^T dO, dK += dS^T Q): the A fragments in registers,
// B a [64][D] stage read MN-major (its 64-wide D blocks one box apart).
template <int D>
__device__ __forceinline__ void rs_product(float (&acc)[D / 2],
                                           const uint32_t (&a)[4][4],
                                           uint64_t db) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if constexpr (D == 128)
      hopper::wgmma_m64n128k16_rs<1>(acc, a[ks],
                                     db + ks * hopper::K_STEP_MNMAJOR, 1);
    else
      hopper::wgmma_m64n64k16_rs<1>(acc, a[ks],
                                    db + ks * hopper::K_STEP_MNMAJOR, 1);
  }
}

// ---------------------------------------------------------------------------
// Forward: warp-specialised wgmma
// ---------------------------------------------------------------------------

template <int D>
struct FwdShape {
  static constexpr int TILE = (D / 64) * FW_BOX;  // one [128][D] tile
  static constexpr int KV = TILE;                 // stage s: K, then V
  static constexpr int BARS = TILE + 2 * FW_STAGES * TILE;
  // + 1 KB to align to the swizzle atom; q_full, k_full[], v_full[], empty[].
  static constexpr int SMEM = 1024 + BARS + (1 + 3 * FW_STAGES) * 8;
  static_assert(SMEM <= 227 * 1024, "dynamic shared memory limit");
};

// Block x owns q rows [q0, q0 + 128) of head x / n_qb (the q blocks of a
// head counted from the last, so the longest causal rows go first);
// consumer warpgroup c owns rows q0 + 64c + [0, 64).  Maps: q, k, v as
// [B][T][H * D] with a box of {64, 128, 1}.
template <int D>
__global__ void __launch_bounds__(FW_THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           int H, int T, float scale, int causal) {
  using S = FwdShape<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + FW_STAGES;
  uint64_t* empty = v_full + FW_STAGES;

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      const int n_qb = (T + FW_BQ - 1) / FW_BQ;
      const HeadBlock hb = head_block(n_qb, H);
      const int qb = n_qb - 1 - hb.i;
      const int q0 = qb * FW_BQ, b = hb.b, col = hb.h * D;
      const int n_kb = causal ? qb + 1 : (T + FW_BKV - 1) / FW_BKV;
      hopper::mbar_arrive_expect_tx(q_full, S::TILE);
#pragma unroll
      for (int i = 0; i < D / 64; ++i)
        hopper::tma_load_3d(smem + i * FW_BOX, &map_q, q_full, col + 64 * i,
                            q0, b);
      for (int j = 0; j < n_kb; ++j) {
        const int s = j % FW_STAGES;
        if (j >= FW_STAGES)
          hopper::mbar_wait(&empty[s], ((j / FW_STAGES) + 1) & 1);
        uint8_t* kt = smem + S::KV + 2 * s * S::TILE;
        uint8_t* vt = kt + S::TILE;
        hopper::mbar_arrive_expect_tx(&k_full[s], S::TILE);
#pragma unroll
        for (int i = 0; i < D / 64; ++i)
          hopper::tma_load_3d(kt + i * FW_BOX, &map_k, &k_full[s],
                              col + 64 * i, j * FW_BKV, b);
        hopper::mbar_arrive_expect_tx(&v_full[s], S::TILE);
#pragma unroll
        for (int i = 0; i < D / 64; ++i)
          hopper::tma_load_3d(vt + i * FW_BOX, &map_v, &v_full[s],
                              col + 64 * i, j * FW_BKV, b);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int n_qb = (T + FW_BQ - 1) / FW_BQ;
  const HeadBlock hb = head_block(n_qb, H);
  const int qb = n_qb - 1 - hb.i;
  const int q0 = qb * FW_BQ, b = hb.b, h = hb.h, bh = hb.bh;
  const int n_kb = causal ? qb + 1 : (T + FW_BKV - 1) / FW_BKV;
  const int c = wg - 1;
  const int t = tid % 128, w = t / 32, l = t % 32;
  const int row_lo = q0 + 64 * c + 16 * w + l / 4;  // and row_lo + 8
  // S = Q K^T: Q rows (this warpgroup's 64) and K rows both K-major.
  // O += P V: V MN-major (D contiguous), its 64-wide D blocks one box apart
  // (LBO), a 16-key step 16 rows on.
  const uint64_t dq = hopper::desc_b128(smem + c * 64 * 128, 16,
                                        hopper::SWIZZLE_ATOM);

  float acc[D / 2];  // O: [64 rows][D], accumulator layout (hopper.cuh)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};
  float lsum[2] = {0.0f, 0.0f};  // this lane's share of the row sums

  hopper::mbar_wait(q_full, 0);
  for (int j = 0; j < n_kb; ++j) {
    const int s = j % FW_STAGES;
    const uint32_t ph = (j / FW_STAGES) & 1;
    const uint8_t* kt = smem + S::KV + 2 * s * S::TILE;
    const uint8_t* vt = kt + S::TILE;
    const int k0 = j * FW_BKV;

    float sc[FW_BKV / 2];  // S: [64 rows][128 keys]
    hopper::mbar_wait(&k_full[s], ph);
    const uint64_t dk = hopper::desc_b128(kt, 16, hopper::SWIZZLE_ATOM);
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_m64n128k16<0, 0>(sc, dq + d_step<FW_BOX>(kk),
                                     dk + d_step<FW_BOX>(kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // Scale after the product; mask only a block that reaches past this
    // warpgroup's first row (the diagonal) or past T.
    const bool masked =
        (causal && k0 + FW_BKV - 1 > q0 + 64 * c) || k0 + FW_BKV > T;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < FW_BKV / 2; ++i) {
      float x = sc[i] * scale;
      if (masked) {
        const int key = k0 + 8 * (i / 4) + 2 * (l % 4) + (i & 1);
        const int row = row_lo + 8 * ((i / 2) & 1);
        if ((causal && key > row) || key >= T) x = NEG_INF;
      }
      sc[i] = x;
      mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = row_max(mx[r]);
      corr[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
      lsum[r] *= corr[r];
    }
    // P, summed in f32 before it is rounded to bf16 as the A fragments of
    // P V (the k16 slices of the accumulator, hopper.cuh).
    uint32_t pa[FW_BKV / 16][4];
#pragma unroll
    for (int ks = 0; ks < FW_BKV / 16; ++ks) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * ks + 2 * q;
        const int r = q & 1;
        const float p0 = __expf(sc[i] - m[r]);
        const float p1 = __expf(sc[i + 1] - m[r]);
        lsum[r] += p0 + p1;
        pa[ks][q] = pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) & 1];

    hopper::mbar_wait(&v_full[s], ph);
    const uint64_t dv = hopper::desc_b128(vt, FW_BOX, hopper::SWIZZLE_ATOM);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < FW_BKV / 16; ++ks) {
      if constexpr (D == 128)
        hopper::wgmma_m64n128k16_rs<1>(acc, pa[ks],
                                       dv + ks * hopper::K_STEP_MNMAJOR, 1);
      else
        hopper::wgmma_m64n64k16_rs<1>(acc, pa[ks],
                                      dv + ks * hopper::K_STEP_MNMAJOR, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < FW_BKV / 16; ++ks) hopper::fence_regs(pa[ks]);
    if (t == 0) hopper::mbar_arrive(&empty[s]);
  }

  const int64_t rs = static_cast<int64_t>(H) * D;
  bf16* ob = o + (static_cast<int64_t>(b) * T * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const float lr = fmaxf(row_sum(lsum[r]), 1e-30f);
    const float inv = 1.0f / lr;
    if (row >= T) continue;  // past T (T % 128 == 64): computed, not kept
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * rs + 8 * jj +
                                         2 * (l % 4)) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * r] * inv,
                                acc[4 * jj + 2 * r + 1] * inv);
    if (l % 4 == 0) lse[static_cast<int64_t>(bh) * T + row] = m[r] + logf(lr);
  }
}

// ---------------------------------------------------------------------------
// dQ: the q block stays, K/V stages stream
// ---------------------------------------------------------------------------

template <int D>
struct DqShape {
  static constexpr int QT = (D / 64) * FW_BOX;  // one [128][D] tile: Q, dO
  static constexpr int KT = (D / 64) * BOX64;   // one [64][D] tile: K or V
  static constexpr int Q = 0, DO = QT, KV = 2 * QT;  // stage s: K, then V
  static constexpr int BARS = KV + 2 * DQ_STAGES * KT;
  // + 1 KB to align to the swizzle atom; qo_full, full[], empty[].
  static constexpr int SMEM = 1024 + BARS + (1 + 2 * DQ_STAGES) * 8;
  static_assert(SMEM <= 227 * 1024, "dynamic shared memory limit");
};

// Block x owns q rows [q0, q0 + 128) of head x / n_qb, the q blocks of a
// head counted from the last (the longest causal rows first); consumer
// warpgroup c owns rows q0 + 64c + [0, 64).  Maps: q and do with a box of
// {64, 128, 1}, k and v with {64, 64, 1}, all [B][T][H * D].
template <int D>
__global__ void __launch_bounds__(BW_THREADS, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int H, int T, float scale,
                          int causal) {
  using S = DqShape<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint64_t* qo_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = qo_full + 1;
  uint64_t* empty = full + DQ_STAGES;

  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(qo_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // The block's q rows [q0, q0 + 128) and its K/V stages: every key up to
  // its last row (causal), else all.
  auto rows = [&](const HeadBlock& hb, int& q0, int& n_kb) {
    const int qb = (T + BW_BLOCK - 1) / BW_BLOCK - 1 - hb.i;
    q0 = qb * BW_BLOCK;
    n_kb = causal ? min(2 * qb + 2, T / BW_STEP) : T / BW_STEP;
  };
  const int n_qb = (T + BW_BLOCK - 1) / BW_BLOCK;

  if (tid >= BW_CONSUMERS) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == BW_CONSUMERS) {
      const HeadBlock hb = head_block(n_qb, H);
      int q0, n_kb;
      rows(hb, q0, n_kb);
      const int b = hb.b, col = hb.h * D;
      hopper::mbar_arrive_expect_tx(qo_full, 2 * S::QT);
#pragma unroll
      for (int i = 0; i < D / 64; ++i) {
        hopper::tma_load_3d(smem + S::Q + i * FW_BOX, &map_q, qo_full,
                            col + 64 * i, q0, b);
        hopper::tma_load_3d(smem + S::DO + i * FW_BOX, &map_do, qo_full,
                            col + 64 * i, q0, b);
      }
      for (int j = 0; j < n_kb; ++j) {
        const int s = j % DQ_STAGES;
        if (j >= DQ_STAGES)
          hopper::mbar_wait(&empty[s], ((j / DQ_STAGES) + 1) & 1);
        uint8_t* kt = smem + S::KV + 2 * s * S::KT;
        uint8_t* vt = kt + S::KT;
        hopper::mbar_arrive_expect_tx(&full[s], 2 * S::KT);
#pragma unroll
        for (int i = 0; i < D / 64; ++i) {
          hopper::tma_load_3d(kt + i * BOX64, &map_k, &full[s], col + 64 * i,
                              j * BW_STEP, b);
          hopper::tma_load_3d(vt + i * BOX64, &map_v, &full[s], col + 64 * i,
                              j * BW_STEP, b);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const HeadBlock hb = head_block(n_qb, H);
    int q0, n_kb;
    rows(hb, q0, n_kb);
    const int c = tid / 128;
    const int t = tid % 128, w = t / 32, l = t % 32;
    const int r0 = q0 + 64 * c;               // this warpgroup's first row
    const int row_lo = r0 + 16 * w + l / 4;   // and row_lo + 8
    // Rows past T (T % 128 == 64, the last block's second half) have no
    // work; causal stages past the diagonal (keys all after the last row)
    // have none either.  Both still take part in the ring.
    const bool active = r0 < T;
    const int last = causal ? r0 / BW_STEP : n_kb - 1;
    const uint64_t q_desc = hopper::desc_b128(smem + S::Q + c * 64 * 128, 16,
                                              hopper::SWIZZLE_ATOM);
    const uint64_t do_desc = hopper::desc_b128(smem + S::DO + c * 64 * 128,
                                               16, hopper::SWIZZLE_ATOM);
    float lse_r[2] = {0.0f, 0.0f}, dl_r[2] = {0.0f, 0.0f};
    if (active) {
      const int64_t stat = static_cast<int64_t>(hb.bh) * T + row_lo;
      lse_r[0] = lse[stat];
      lse_r[1] = lse[stat + 8];
      dl_r[0] = delta[stat];
      dl_r[1] = delta[stat + 8];
    }

    float acc[D / 2];  // dQ: [64 rows][D]
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float sc[32], dp[32];  // S, dP of the stage in hand: [64 rows][64 keys]
    uint32_t da[4][4];     // its dS, rounded: the A operand of dQ += dS K

    auto stage = [&](int j) {
      return smem + S::KV + 2 * (j % DQ_STAGES) * S::KT;
    };
    auto wait_full = [&](int j) {
      hopper::mbar_wait(&full[j % DQ_STAGES], (j / DQ_STAGES) & 1);
    };
    auto release = [&](int j) {
      if (t == 0) hopper::mbar_arrive(&empty[j % DQ_STAGES]);
    };
    // S = Q K^T and dP = dO V^T of stage j, issued and committed.
    auto issue_scores = [&](int j) {
      const uint64_t dk = hopper::desc_b128(stage(j), 16, hopper::SWIZZLE_ATOM);
      const uint64_t dv =
          hopper::desc_b128(stage(j) + S::KT, 16, hopper::SWIZZLE_ATOM);
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n64k16<0, 0>(sc, q_desc + d_step<FW_BOX>(kk),
                                      dk + d_step<BOX64>(kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n64k16<0, 0>(dp, do_desc + d_step<FW_BOX>(kk),
                                      dv + d_step<BOX64>(kk), kk > 0);
      hopper::wgmma_commit();
    };
    // p = exp(s * scale - lse), ds = p (dp - delta) from stage j's retired
    // S and dP, masked on the diagonal stage only; ds rounded to bf16 as
    // the A fragments.
    auto make_ds = [&](int j) {
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      const int k0 = j * BW_STEP;
      const bool masked = causal && k0 + BW_STEP - 1 > r0;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = q & 1;
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * ks + 2 * q + e;
            float x = sc[i] * scale;
            if (masked && k0 + 8 * (i / 4) + 2 * (l % 4) + e > row_lo + 8 * r)
              x = NEG_INF;
            const float p = __expf(x - lse_r[r]);
            ds[e] = p * (dp[i] - dl_r[r]);
          }
          da[ks][q] = pack_bf16(ds[0], ds[1]);
        }
      }
    };
    // dQ += dS K_j (K read MN-major from the same stage), issued and
    // committed; acc and da stay untouched until a wait retires it.
    auto issue_dq = [&](int j) {
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      rs_product<D>(acc, da,
                    hopper::desc_b128(stage(j), BOX64, hopper::SWIZZLE_ATOM));
      hopper::wgmma_commit();
    };
    auto retire = [&] {
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) hopper::fence_regs(da[ks]);
    };

    const int n_work = active ? last + 1 : 0;  // stages 0 .. n_work - 1
    hopper::mbar_wait(qo_full, 0);
    for (int j = 0; j < n_work; ++j) {
      wait_full(j);
      issue_scores(j);
      hopper::wgmma_wait<0>();
      make_ds(j);
      issue_dq(j);
      retire();
      release(j);
    }
    for (int j = n_work; j < n_kb; ++j) {
      wait_full(j);
      release(j);
    }

    if (active)
      store_acc<D>(dq + (static_cast<int64_t>(hb.b) * T * H + hb.h) * D,
                   static_cast<int64_t>(H) * D, row_lo, l, acc, scale);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: the k block stays, Q/dO stages stream
// ---------------------------------------------------------------------------

template <int D>
struct DkvShape {
  static constexpr int KT = (D / 64) * FW_BOX;  // one [128][D] tile: K, V
  static constexpr int QT = (D / 64) * BOX64;   // one [64][D] tile: Q or dO
  // Stage s: Q, dO, then 64 lse and 64 delta (f32), padded to the atom.
  static constexpr int STAGE = 2 * QT + 1024;
  static constexpr int K = 0, V = KT, QS = 2 * KT;
  static constexpr int BARS = QS + DKV_STAGES * STAGE;
  // + 1 KB to align to the swizzle atom; kv_full, full[], empty[].
  static constexpr int SMEM = 1024 + BARS + (1 + 2 * DKV_STAGES) * 8;
  static_assert(SMEM <= 227 * 1024, "dynamic shared memory limit");
};

// Block x owns keys [k0, k0 + 128) of head x / n_kb, the k blocks of a head
// counted from the first (under causal the low keys see the most q rows);
// consumer warpgroup c owns keys k0 + 64c + [0, 64).  Maps: k and v with a
// box of {64, 128, 1}, q and do with {64, 64, 1}, all [B][T][H * D].
template <int D>
__global__ void __launch_bounds__(BW_THREADS, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int H, int T, float scale, int causal) {
  using S = DkvShape<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + DKV_STAGES;

  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // The block's keys [k0, k0 + 128) and its first Q/dO stage: every q row
  // from its first key on (causal), else all.
  const int n_kb = (T + BW_BLOCK - 1) / BW_BLOCK;
  const int n_qs = T / BW_STEP;

  if (tid >= BW_CONSUMERS) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == BW_CONSUMERS) {
      const HeadBlock hb = head_block(n_kb, H);
      const int k0 = hb.i * BW_BLOCK, b = hb.b, col = hb.h * D;
      const int first = causal ? k0 / BW_STEP : 0;
      const float* lse_j = lse + static_cast<int64_t>(hb.bh) * T;
      const float* dl_j = delta + static_cast<int64_t>(hb.bh) * T;
      hopper::mbar_arrive_expect_tx(kv_full, 2 * S::KT);
#pragma unroll
      for (int i = 0; i < D / 64; ++i) {
        hopper::tma_load_3d(smem + S::K + i * FW_BOX, &map_k, kv_full,
                            col + 64 * i, k0, b);
        hopper::tma_load_3d(smem + S::V + i * FW_BOX, &map_v, kv_full,
                            col + 64 * i, k0, b);
      }
      for (int j = first; j < n_qs; ++j) {
        const int u = j - first;
        const int s = u % DKV_STAGES;
        if (u >= DKV_STAGES)
          hopper::mbar_wait(&empty[s], ((u / DKV_STAGES) + 1) & 1);
        uint8_t* st = smem + S::QS + s * S::STAGE;
        hopper::mbar_arrive_expect_tx(&full[s], 2 * S::QT + 2 * 64 * 4);
#pragma unroll
        for (int i = 0; i < D / 64; ++i) {
          hopper::tma_load_3d(st + i * BOX64, &map_q, &full[s], col + 64 * i,
                              j * BW_STEP, b);
          hopper::tma_load_3d(st + S::QT + i * BOX64, &map_do, &full[s],
                              col + 64 * i, j * BW_STEP, b);
        }
        hopper::bulk_load(st + 2 * S::QT, lse_j + j * BW_STEP, 64 * 4,
                          &full[s]);
        hopper::bulk_load(st + 2 * S::QT + 64 * 4, dl_j + j * BW_STEP, 64 * 4,
                          &full[s]);
      }
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const HeadBlock hb = head_block(n_kb, H);
    const int k0 = hb.i * BW_BLOCK;
    const int first = causal ? k0 / BW_STEP : 0;
    const int c = tid / 128;
    const int t = tid % 128, w = t / 32, l = t % 32;
    const int kc = k0 + 64 * c;               // this warpgroup's first key
    const int key_lo = kc + 16 * w + l / 4;   // and key_lo + 8
    // Keys past T (T % 128 == 64, the last block's second half) have no
    // work; causal stages before the diagonal (q rows all before the first
    // key) have none either.  Both still take part in the ring.
    const bool active = kc < T;
    const int first_c = causal ? kc / BW_STEP : 0;
    const uint64_t k_desc = hopper::desc_b128(smem + S::K + c * 64 * 128, 16,
                                              hopper::SWIZZLE_ATOM);
    const uint64_t v_desc = hopper::desc_b128(smem + S::V + c * 64 * 128, 16,
                                              hopper::SWIZZLE_ATOM);

    float dka[D / 2], dva[D / 2];  // dK, dV: [64 keys][D]
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dka[i] = 0.0f;
      dva[i] = 0.0f;
    }
    float sct[32], dpt[32];  // S^T, dP^T of the stage in hand: [64 keys][64 q]
    uint32_t pa[4][4], sa[4][4];  // its p^T and ds^T, rounded: A operands

    // Stage u of the ring holds q rows [64 (first + u), + 64).
    auto stage = [&](int u) {
      return smem + S::QS + (u % DKV_STAGES) * S::STAGE;
    };
    auto wait_full = [&](int u) {
      hopper::mbar_wait(&full[u % DKV_STAGES], (u / DKV_STAGES) & 1);
    };
    auto release = [&](int u) {
      if (t == 0) hopper::mbar_arrive(&empty[u % DKV_STAGES]);
    };
    // S^T = K Q^T and dP^T = V dO^T of stage u, issued and committed.
    auto issue_scores = [&](int u) {
      const uint64_t dqs = hopper::desc_b128(stage(u), 16, hopper::SWIZZLE_ATOM);
      const uint64_t dos =
          hopper::desc_b128(stage(u) + S::QT, 16, hopper::SWIZZLE_ATOM);
      hopper::fence_regs(sct);
      hopper::fence_regs(dpt);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n64k16<0, 0>(sct, k_desc + d_step<FW_BOX>(kk),
                                      dqs + d_step<BOX64>(kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_m64n64k16<0, 0>(dpt, v_desc + d_step<FW_BOX>(kk),
                                      dos + d_step<BOX64>(kk), kk > 0);
      hopper::wgmma_commit();
    };
    // p^T = exp(s^T * scale - lse[q]), ds^T = p^T (dp^T - delta[q]) from
    // stage u's retired S^T and dP^T, masked on the diagonal stage only;
    // each rounded to bf16 as the A fragments of its product.  Column group
    // jc (q columns 8 jc + 2 (l % 4) + {0, 1}) reads its lse and delta
    // pairs from the stage; the empty asm keeps the next group's reads from
    // being hoisted, so 4 of them, not 32, are live beside ~200
    // accumulator values.
    auto make_p_ds = [&](int u) {
      hopper::fence_regs(sct);
      hopper::fence_regs(dpt);
      const float* s_lse = reinterpret_cast<const float*>(stage(u) + 2 * S::QT);
      const float* s_dl = s_lse + 64;
      const int q0 = (first + u) * BW_STEP;
      const bool masked = causal && q0 < kc + BW_STEP - 1;
#pragma unroll
      for (int jc = 0; jc < 8; ++jc) {
        const int qc = 8 * jc + 2 * (l % 4);
        const float2 lq = *reinterpret_cast<const float2*>(s_lse + qc);
        const float2 dl = *reinterpret_cast<const float2*>(s_dl + qc);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * jc + 2 * r;
          float x0 = sct[i] * scale, x1 = sct[i + 1] * scale;
          if (masked) {
            if (key_lo + 8 * r > q0 + qc) x0 = NEG_INF;
            if (key_lo + 8 * r > q0 + qc + 1) x1 = NEG_INF;
          }
          const float p0 = __expf(x0 - lq.x), p1 = __expf(x1 - lq.y);
          pa[jc / 2][2 * (jc % 2) + r] = pack_bf16(p0, p1);
          sa[jc / 2][2 * (jc % 2) + r] =
              pack_bf16(p0 * (dpt[i] - dl.x), p1 * (dpt[i + 1] - dl.y));
        }
        asm volatile("" ::: "memory");
      }
    };
    // dV += p^T dO and dK += ds^T Q (dO and Q read MN-major from the same
    // stage), issued and committed; the accumulators and fragments stay
    // untouched until a wait retires them.
    auto issue_dkv = [&](int u) {
      hopper::fence_regs(dva);
      hopper::fence_regs(dka);
      hopper::wgmma_fence();
      rs_product<D>(dva, pa,
                    hopper::desc_b128(stage(u) + S::QT, BOX64,
                                      hopper::SWIZZLE_ATOM));
      rs_product<D>(dka, sa,
                    hopper::desc_b128(stage(u), BOX64, hopper::SWIZZLE_ATOM));
      hopper::wgmma_commit();
    };
    auto retire = [&] {
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dva);
      hopper::fence_regs(dka);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        hopper::fence_regs(pa[ks]);
        hopper::fence_regs(sa[ks]);
      }
    };

    // Ring stages 0 .. u0 - 1 have no work for this warpgroup, u0 .. n - 1
    // do (none if its keys lie past T).
    const int n = n_qs - first;
    const int u0 = active ? first_c - first : n;
    hopper::mbar_wait(kv_full, 0);
    for (int u = 0; u < u0; ++u) {
      wait_full(u);
      release(u);
    }
    for (int u = u0; u < n; ++u) {
      wait_full(u);
      issue_scores(u);
      hopper::wgmma_wait<0>();
      make_p_ds(u);
      issue_dkv(u);
      retire();
      release(u);
    }

    if (active) {
      const int64_t head0 = (static_cast<int64_t>(hb.b) * T * H + hb.h) * D;
      const int64_t rs = static_cast<int64_t>(H) * D;
      store_acc<D>(dk + head0, rs, key_lo, l, dka, scale);
      store_acc<D>(dv + head0, rs, key_lo, l, dva, 1.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

bool bad_args(int B, int H, int T, int D) {
  return B <= 0 || H <= 0 || T <= 0 || T % T_GRAIN != 0 ||
         (D != 64 && D != 128);
}

// Blocks of a grid of `per_head` blocks for each of B * H heads, or -1 if
// that is past the grid's x extent (2^31 - 1).
int64_t grid_blocks(int B, int H, int per_head) {
  const int64_t n = static_cast<int64_t>(B) * H * per_head;
  return n > 0x7fffffff ? -1 : n;
}

// A map over a [B][T][H * D] bf16 tensor with a box of {64, rows, 1}.
bool head_map(CUtensorMap* map, const void* base, int B, int H, int T, int D,
              int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H) * D,
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return hopper::make_map(map, base, 3, dims, strides, box);
}

template <typename Kernel, typename... Args>
int launch_1d(Kernel kernel, int64_t blocks, int threads, int smem,
              void* stream, Args... args) {
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int H, int T, float scale, int causal, void* stream) {
  if (hopper::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_q, map_k, map_v;
  if (!head_map(&map_q, q, B, H, T, D, FW_BQ) ||
      !head_map(&map_k, k, B, H, T, D, FW_BKV) ||
      !head_map(&map_v, v, B, H, T, D, FW_BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_1d(flash_fwd_wgmma_kernel<D>,
                   grid_blocks(B, H, (T + FW_BQ - 1) / FW_BQ), FW_THREADS,
                   FwdShape<D>::SMEM, stream, map_q, map_k, map_v,
                   static_cast<bf16*>(o), static_cast<float*>(lse), H, T,
                   scale, causal);
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, int B, int H, int T,
       float scale, int causal, void* stream) {
  if (hopper::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!head_map(&map_q, q, B, H, T, D, BW_BLOCK) ||
      !head_map(&map_k, k, B, H, T, D, BW_STEP) ||
      !head_map(&map_v, v, B, H, T, D, BW_STEP) ||
      !head_map(&map_do, dout, B, H, T, D, BW_BLOCK))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_1d(flash_dq_wgmma_kernel<D>,
                   grid_blocks(B, H, (T + BW_BLOCK - 1) / BW_BLOCK),
                   BW_THREADS, DqShape<D>::SMEM, stream, map_q, map_k, map_v,
                   map_do, static_cast<const float*>(lse),
                   static_cast<const float*>(delta),
                   static_cast<bf16*>(dq_out), H, T, scale, causal);
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int B, int H,
        int T, float scale, int causal, void* stream) {
  if (hopper::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!head_map(&map_q, q, B, H, T, D, BW_STEP) ||
      !head_map(&map_k, k, B, H, T, D, BW_BLOCK) ||
      !head_map(&map_v, v, B, H, T, D, BW_BLOCK) ||
      !head_map(&map_do, dout, B, H, T, D, BW_STEP))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_1d(flash_dkv_wgmma_kernel<D>,
                   grid_blocks(B, H, (T + BW_BLOCK - 1) / BW_BLOCK),
                   BW_THREADS, DkvShape<D>::SMEM, stream, map_q, map_k, map_v,
                   map_do, static_cast<const float*>(lse),
                   static_cast<const float*>(delta), static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), H, T, scale, causal);
}

}  // namespace

extern "C" {

// o, lse = attention(q, k, v).  Returns a cudaError_t code.
int kctpu_flash_fwd(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int H, int T, int D, float scale,
                    int causal, void* stream) {
  if (bad_args(B, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  return D == 64 ? fwd<64>(q, k, v, o, lse, B, H, T, scale, causal, stream)
                 : fwd<128>(q, k, v, o, lse, B, H, T, scale, causal, stream);
}

// dq from (q, k, v, do, lse, delta = rowsum(do * o)).
int kctpu_flash_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq_out, int B, int H, int T, int D, float scale,
                   int causal, void* stream) {
  if (bad_args(B, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  return D == 64 ? dq<64>(q, k, v, dout, lse, delta, dq_out, B, H, T, scale,
                          causal, stream)
                 : dq<128>(q, k, v, dout, lse, delta, dq_out, B, H, T, scale,
                           causal, stream);
}

// dk, dv from the same inputs.
int kctpu_flash_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int H, int T, int D,
                    float scale, int causal, void* stream) {
  if (bad_args(B, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  return D == 64 ? dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, T, scale,
                           causal, stream)
                 : dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, T,
                            scale, causal, stream);
}

}  // extern "C"
