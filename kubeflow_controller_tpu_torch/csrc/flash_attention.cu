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
// D is 64 or 128 and T a multiple of 64.  Offsets are 64-bit.
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
// What the designs do about it.
//
// flash_fwd: warp-specialised, on wgmma.  A block owns 128 q rows of one
//   head.  Warpgroup 0 is the producer: it gives its registers back
//   (setmaxnreg) and one thread issues TMA loads through tensor maps over
//   q, k and v as [B][T][H * D] (64-wide 128-byte-swizzled boxes, two per
//   128-wide head; the batch a coordinate of its own, so a tile that runs
//   past T reads zeros): Q once, K and V through a two-stage ring of
//   128-key stages with a full barrier each and a shared empty barrier.
//   Two consumer warpgroups own 64 q rows each.  S = Q K^T is
//   wgmma.m64n128k16 with both operands K-major in shared memory; the
//   online softmax runs on the f32 accumulator in registers, a row's
//   statistics reduced over the 4 lanes of a quad by shuffles; P, rounded
//   to bf16, feeds O += P V from registers (the register-A wgmma: the
//   accumulator's k16 slices are its A fragments), V an MN-major B operand
//   (csrc/hopper.cuh).  Each warpgroup runs its blocks in turn (S, softmax,
//   P V); while one runs its softmax, the other's products keep the tensor
//   cores busy.  (Issuing block j's scores ahead of block j - 1's P V
//   within a warpgroup needs a second score tile, past the 168 registers a
//   thread of a 384-thread block may hold: ptxas then spills and serializes
//   the wgmmas, and the kernel is slower.)  Only the diagonal block (and one
//   that runs past T) is masked, causal blocks past it are never loaded,
//   and the heaviest q blocks are scheduled first.
//
// flash_dq, flash_dkv: one block of 4 warps owns 64 rows (q rows for dQ,
//   k rows for dKV); each warp owns 16 of them and runs mma.sync m16n8k16
//   (bf16 in, f32 accumulate) on operands fed by ldmatrix from padded
//   shared-memory tiles (row stride D + 8: conflict-free ldmatrix phases).
//   The score tile never leaves registers: its f32 accumulator fragment is
//   re-packed in place as the bf16 A operand of the next product
//   (FlashAttention-2's register reuse), and the per-row statistics are
//   reduced across the 4 lanes that share a row by shuffles.  Tiles stream
//   through cp.async; causal blocks past the diagonal are never visited.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 128;       // threads per block (dQ, dKV): 4 warps of 16 rows
constexpr int BQ = 64;        // q rows per block (dQ)
constexpr int BKV = 64;       // k rows per step (dQ) and per block (dKV)
constexpr int BQ2 = 32;       // q rows per step of dKV (bounds its registers)
constexpr int PAD = 8;        // bf16 row padding of every shared tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives matrix i's fragment.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Addresses of the ldmatrix lanes.  A operand (16 rows from r0, 16 columns
// from c0): matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15),
// (8-15, 8-15) = a0..a3.
__device__ __forceinline__ const bf16* a_addr(const bf16* s, int ld, int r0,
                                              int c0, int lane) {
  return s + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}

// B operand read from a tile stored [n][k] (k contiguous), two n-tiles of
// 8 from n0 and one k-step of 16 from k0: registers 0,1 are b0,b1 of n-tile
// n0 and registers 2,3 those of n-tile n0 + 8.  Used with ldsm_x4.
__device__ __forceinline__ const bf16* bnk_addr(const bf16* s, int ld, int n0,
                                                int k0, int lane) {
  return s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
         ((lane >> 3) & 1) * 8;
}

// B operand read from a tile stored [k][n] (n contiguous), through the
// transposing ldmatrix; same register order.  Used with ldsm_x4_t.
__device__ __forceinline__ const bf16* bkn_addr(const bf16* s, int ld, int k0,
                                                int n0, int lane) {
  return s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
         (lane >> 4) * 8;
}

// ROWS rows of D bf16 from global (row stride rs elements) to a padded tile.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g, int64_t rs,
                                          int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int c = tid; c < ROWS * CH; c += NT) {
    const int r = c / CH;
    const int col = (c % CH) * 8;
    cp_async16(s + r * (D + PAD) + col, g + r * rs + col);
  }
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

// Accumulator fragments of n-tiles 2i and 2i+1 -> the bf16 A operand of
// k-step i (the C and A layouts of m16n8k16 line up this way).
template <int NTILES>
__device__ __forceinline__ void to_a(const float (&c)[NTILES][4],
                                     unsigned (&a)[NTILES / 2][4]) {
#pragma unroll
  for (int i = 0; i < NTILES / 2; ++i) {
    a[i][0] = pack_bf16(c[2 * i][0], c[2 * i][1]);
    a[i][1] = pack_bf16(c[2 * i][2], c[2 * i][3]);
    a[i][2] = pack_bf16(c[2 * i + 1][0], c[2 * i + 1][1]);
    a[i][3] = pack_bf16(c[2 * i + 1][2], c[2 * i + 1][3]);
  }
}

// Rows r and r + 8 of a [16 x D] f32 fragment set, times mul, to bf16.
template <int D>
__device__ __forceinline__ void store_rows(bf16* g, int64_t rs, int r,
                                           int tig, const float (&c)[D / 8][4],
                                           float mul0, float mul1) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
    *reinterpret_cast<__nv_bfloat162*>(g + r * rs + col) =
        __floats2bfloat162_rn(c[nt][0] * mul0, c[nt][1] * mul0);
    *reinterpret_cast<__nv_bfloat162*>(g + (r + 8) * rs + col) =
        __floats2bfloat162_rn(c[nt][2] * mul1, c[nt][3] * mul1);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.0f;
}

// ---------------------------------------------------------------------------
// Forward: warp-specialised wgmma
// ---------------------------------------------------------------------------

constexpr int FW_BQ = 128;   // q rows per block: two consumer warpgroups
constexpr int FW_BKV = 128;  // keys per K/V stage
constexpr int FW_STAGES = 2;
constexpr int FW_THREADS = 3 * 128;  // producer + two consumers
constexpr int FW_BOX = 128 * 128;    // bytes of one [128 rows][64] bf16 box

template <int D>
struct FwdShape {
  static constexpr int TILE = (D / 64) * FW_BOX;  // one [128][D] tile
  static constexpr int KV = TILE;                 // stage s: K, then V
  static constexpr int BARS = TILE + 2 * FW_STAGES * TILE;
  // + 1 KB to align to the swizzle atom; q_full, k_full[], v_full[], empty[].
  static constexpr int SMEM = 1024 + BARS + (1 + 3 * FW_STAGES) * 8;
  static_assert(SMEM <= 227 * 1024, "dynamic shared memory limit");
};

// Block (x, y) owns q rows [q0, q0 + 128) of head y (x counted from the
// last q block, so the longest causal rows go first); consumer warpgroup c
// owns rows q0 + 64c + [0, 64).  Maps: q, k, v as [B][T][H * D] with a box
// of {64, 128, 1}, the batch a coordinate of its own, so a tile that runs
// past T reads zeros, never the next sequence.
template <int D>
__global__ void __launch_bounds__(FW_THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           int H, int T, float scale, int causal) {
  using S = FwdShape<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((hopper::SWIZZLE_ATOM -
                   hopper::smem_u32(smem_raw) % hopper::SWIZZLE_ATOM) %
                  hopper::SWIZZLE_ATOM);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + FW_STAGES;
  uint64_t* empty = v_full + FW_STAGES;

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = qb * FW_BQ;
  const int n_kb = causal ? qb + 1 : (T + FW_BKV - 1) / FW_BKV;
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
    hopper::setmaxnreg_dec<24>();
    if (tid == 0) {
      const int col = h * D;
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

  hopper::setmaxnreg_inc<240>();
  const int c = wg - 1;
  const int t = tid % 128, w = t / 32, l = t % 32;
  const int row_lo = q0 + 64 * c + 16 * w + l / 4;  // and row_lo + 8
  // S = Q K^T: Q rows (this warpgroup's 64) and K rows both K-major; a
  // 16-deep step over D moves 32 B along a row, and every 64 columns to the
  // next box.  O += P V: V MN-major (D contiguous), its 64-wide D blocks
  // one box apart (LBO), a 16-key step 16 rows on.
  auto d_step = [](int kk) -> uint64_t {
    return ((kk / 4) * FW_BOX + (kk % 4) * 32) >> 4;
  };
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
      hopper::wgmma_m64n128k16<0, 0>(sc, dq + d_step(kk), dk + d_step(kk),
                                     kk > 0);
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
// dQ: the q block stays, k blocks stream
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NT)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int T, float scale, int causal) {
  constexpr int LD = D + PAD;
  constexpr int KS = D / 16;
  constexpr int NTD = D / 8;
  constexpr int NTK = BKV / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + BQ * LD;  // dO
  bf16* sK = sO + BQ * LD;
  bf16* sV = sK + BKV * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int64_t rs = static_cast<int64_t>(H) * D;
  const int64_t head0 = (static_cast<int64_t>(b) * T * H + h) * D;
  const int q0 = qb * BQ;
  const int n_kb = causal ? qb + 1 : T / BKV;
  const int r_lo = q0 + warp * 16 + gid;

  load_rows<D, BQ>(sQ, q + head0 + q0 * rs, rs, tid);
  load_rows<D, BQ>(sO, dout + head0 + q0 * rs, rs, tid);
  load_rows<D, BKV>(sK, k + head0, rs, tid);
  load_rows<D, BKV>(sV, v + head0, rs, tid);
  cp_async_commit();

  const int64_t stat0 = static_cast<int64_t>(bh) * T;
  const float lse_r[2] = {lse[stat0 + r_lo], lse[stat0 + r_lo + 8]};
  const float dl_r[2] = {delta[stat0 + r_lo], delta[stat0 + r_lo + 8]};

  float acc[NTD][4];
  zero(acc);
  for (int j = 0; j < n_kb; ++j) {
    const int k0 = j * BKV;
    cp_async_wait<0>();
    __syncthreads();
    float s[NTK][4], dp[NTK][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned qa[4], oa[4];
      ldsm_x4(qa, a_addr(sQ, LD, warp * 16, ks * 16, lane));
      ldsm_x4(oa, a_addr(sO, LD, warp * 16, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < NTK / 2; ++np) {
        unsigned bb[4];
        ldsm_x4(bb, bnk_addr(sK, LD, np * 16, ks * 16, lane));
        mma(s[2 * np], qa, bb[0], bb[1]);
        mma(s[2 * np + 1], qa, bb[2], bb[3]);
        ldsm_x4(bb, bnk_addr(sV, LD, np * 16, ks * 16, lane));
        mma(dp[2 * np], oa, bb[0], bb[1]);
        mma(dp[2 * np + 1], oa, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (causal && k0 + nt * 8 + tig * 2 + (e & 1) > r_lo + (e >> 1) * 8)
          x = NEG_INF;
        const float p = __expf(x - lse_r[e >> 1]);
        s[nt][e] = p * (dp[nt][e] - dl_r[e >> 1]);  // ds
      }
    }
    unsigned dsf[NTK / 2][4];
    to_a(s, dsf);
#pragma unroll
    for (int ks = 0; ks < NTK / 2; ++ks) {
#pragma unroll
      for (int np = 0; np < NTD / 2; ++np) {
        unsigned bb[4];
        ldsm_x4_t(bb, bkn_addr(sK, LD, ks * 16, np * 16, lane));
        mma(acc[2 * np], dsf[ks], bb[0], bb[1]);
        mma(acc[2 * np + 1], dsf[ks], bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with K_j, V_j
    if (j + 1 < n_kb) {
      load_rows<D, BKV>(sK, k + head0 + (k0 + BKV) * rs, rs, tid);
      load_rows<D, BKV>(sV, v + head0 + (k0 + BKV) * rs, rs, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  store_rows<D>(dq + head0, rs, r_lo, tig, acc, scale, scale);
}

// ---------------------------------------------------------------------------
// dK, dV: the k block stays, q blocks stream.  Each warp computes the
// transposed tiles s^T = K Q^T and dp^T = V dO^T for its 16 keys, so p^T
// and ds^T are already the A operands of dV += p^T dO and dK += ds^T Q.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NT)
    flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int T, float scale,
                     int causal) {
  constexpr int LD = D + PAD;
  constexpr int KS = D / 16;
  constexpr int NTD = D / 8;
  constexpr int NTQ = BQ2 / 8;  // n-tiles over one q step
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BKV * LD;
  bf16* sQ = sV + BKV * LD;
  bf16* sO = sQ + BQ2 * LD;  // dO
  float* sL = reinterpret_cast<float*>(sO + BQ2 * LD);
  float* sD = sL + BQ2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kb = blockIdx.x;  // under causal the low k blocks see most q
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int64_t rs = static_cast<int64_t>(H) * D;
  const int64_t head0 = (static_cast<int64_t>(b) * T * H + h) * D;
  const int64_t stat0 = static_cast<int64_t>(bh) * T;
  const int k0 = kb * BKV;
  const int first = causal ? k0 / BQ2 : 0;
  const int n_qb = T / BQ2;
  const int key_lo = k0 + warp * 16 + gid;  // this thread's keys

  auto load_q_step = [&](int i) {
    const int q0 = i * BQ2;
    load_rows<D, BQ2>(sQ, q + head0 + q0 * rs, rs, tid);
    load_rows<D, BQ2>(sO, dout + head0 + q0 * rs, rs, tid);
    if (tid < BQ2 / 4)
      cp_async16(sL + tid * 4, lse + stat0 + q0 + tid * 4);
    else if (tid < BQ2 / 2)
      cp_async16(sD + (tid - BQ2 / 4) * 4,
                 delta + stat0 + q0 + (tid - BQ2 / 4) * 4);
  };

  load_rows<D, BKV>(sK, k + head0 + k0 * rs, rs, tid);
  load_rows<D, BKV>(sV, v + head0 + k0 * rs, rs, tid);
  load_q_step(first);
  cp_async_commit();

  float dka[NTD][4], dva[NTD][4];
  zero(dka);
  zero(dva);
  for (int i = first; i < n_qb; ++i) {
    const int q0 = i * BQ2;
    cp_async_wait<0>();
    __syncthreads();
    float s[NTQ][4], dp[NTQ][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned ka[4], va[4];
      ldsm_x4(ka, a_addr(sK, LD, warp * 16, ks * 16, lane));
      ldsm_x4(va, a_addr(sV, LD, warp * 16, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < NTQ / 2; ++np) {
        unsigned bb[4];
        ldsm_x4(bb, bnk_addr(sQ, LD, np * 16, ks * 16, lane));
        mma(s[2 * np], ka, bb[0], bb[1]);
        mma(s[2 * np + 1], ka, bb[2], bb[3]);
        ldsm_x4(bb, bnk_addr(sO, LD, np * 16, ks * 16, lane));
        mma(dp[2 * np], va, bb[0], bb[1]);
        mma(dp[2 * np + 1], va, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NTQ; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + tig * 2 + (e & 1);
        float x = s[nt][e] * scale;
        if (causal && key_lo + (e >> 1) * 8 > q0 + qi) x = NEG_INF;
        const float p = __expf(x - sL[qi]);
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sD[qi]);  // ds^T
      }
    }
    unsigned pf[NTQ / 2][4], dsf[NTQ / 2][4];
    to_a(s, pf);
    to_a(dp, dsf);
#pragma unroll
    for (int ks = 0; ks < NTQ / 2; ++ks) {
#pragma unroll
      for (int np = 0; np < NTD / 2; ++np) {
        unsigned bb[4];
        ldsm_x4_t(bb, bkn_addr(sO, LD, ks * 16, np * 16, lane));
        mma(dva[2 * np], pf[ks], bb[0], bb[1]);
        mma(dva[2 * np + 1], pf[ks], bb[2], bb[3]);
        ldsm_x4_t(bb, bkn_addr(sQ, LD, ks * 16, np * 16, lane));
        mma(dka[2 * np], dsf[ks], bb[0], bb[1]);
        mma(dka[2 * np + 1], dsf[ks], bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with this q step
    if (i + 1 < n_qb) load_q_step(i + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
  store_rows<D>(dk + head0, rs, key_lo, tig, dka, scale, scale);
  store_rows<D>(dv + head0, rs, key_lo, tig, dva, 1.0f, 1.0f);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

bool bad_args(int B, int H, int T, int D) {
  return B <= 0 || H <= 0 || T <= 0 || T % BKV != 0 || (D != 64 && D != 128) ||
         B * H > 65535;  // the grid's y extent
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int T, int BH, size_t smem, void* stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(T / BKV, BH);
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int H, int T, float scale, int causal, void* stream) {
  using S = FwdShape<D>;
  if (hopper::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  // [B][T][H * D], innermost first; a box of 64 columns x 128 rows.
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H) * D,
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t box[3] = {64, FW_BQ, 1};
  CUtensorMap map_q, map_k, map_v;
  if (!hopper::make_map(&map_q, q, 3, dims, strides, box) ||
      !hopper::make_map(&map_k, k, 3, dims, strides, box) ||
      !hopper::make_map(&map_v, v, 3, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = flash_fwd_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + FW_BQ - 1) / FW_BQ, B * H);
  kernel<<<grid, FW_THREADS, S::SMEM, static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, static_cast<bf16*>(o), static_cast<float*>(lse),
      H, T, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, int B, int H, int T,
       float scale, int causal, void* stream) {
  const size_t smem = (2 * BQ + 2 * BKV) * (D + PAD) * sizeof(bf16);
  return launch(flash_dq_kernel<D>, T, B * H, smem, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<bf16*>(dq_out),
                H, T, scale, causal);
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int B, int H,
        int T, float scale, int causal, void* stream) {
  const size_t smem = (2 * BKV + 2 * BQ2) * (D + PAD) * sizeof(bf16) +
                      2 * BQ2 * sizeof(float);
  return launch(flash_dkv_kernel<D>, T, B * H, smem, stream,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                static_cast<const float*>(lse),
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
