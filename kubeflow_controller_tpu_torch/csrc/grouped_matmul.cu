// Grouped (per-expert) matmuls for the MoE FFN on Hopper (sm_90a), forward
// and backward.
//
// Replaces the Pallas TPU kernels of kubeflow_controller_tpu/ops/grouped_matmul.py:
//   gmm        <- _gmm_kernel (l.78, K loop), _gmm_single_k_kernel (l.132,
//                 K in one block) and _gmm_single_k_skip_kernel (l.138, tiles
//                 at or past valid_tiles[0] write zeros).  All compute
//                 out[r] = lhs[r] @ rhs[e(r)]; they differ only in how the
//                 TPU's VMEM was budgeted and in the skip, so one kernel with
//                 a K loop and an optional valid_tiles pointer ports all
//                 three.  A template flag reads rhs as [E, N, K] (rhs^T per
//                 expert), the operand of the backward's dlhs = dout @ rhs^T.
//   gmm_swiglu <- _gmm2_kernel (l.227), the fused gate/up/SwiGLU forward;
//                 gate and up are written too when the caller passes their
//                 pointers (the backward needs them).
//   tgmm       <- _tgmm_kernel (l.338) and _tgmm_skip_kernel (l.364), the
//                 weight gradient out[e] = sum over the tiles of e of
//                 lhs_tile^T @ dout_tile.
//
// Contract (models/moe.py builds the layout): lhs [M, K] bf16 row-major,
// rhs [E, K, N] bf16 (or [E, N, K] transposed), tile_experts [M / bm]
// int32, non-decreasing, out [M, N] bf16, with e(r) = tile_experts[r / bm].
// Every bm-row tile belongs to one expert; bm is a power of two.
// Accumulation is f32; each output is rounded to bf16 once.
//
// What bounds it on this card.  At decode (8 slots, top-2: M = 144, bm = 16)
// the forward is bytes: the gate and up weights of every touched expert,
// 2 x 8 x 4096 x 14336 x 2 B = 1.9 GB per layer at Mixtral-8x7B widths, are
// read once for 16 real rows (~0.56 ms at 3.35 TB/s).  In training (B 2 x
// T 4096: 16384 routed rows, M = 18432 layout rows, bm = 256) each expert's
// weights serve ~2048 rows: every product is operations, ~1.9 TFLOP for the
// gate/up-sized ones (~1.95 ms at 989 TFLOP/s) against ~1.5 GB of bytes.
//
// What the design does about it.  gmm: each block owns a row tile of BM
// rows (never more than bm, so it never straddles two experts) and a
// BN-wide column slice; it reads its expert id itself (no scalar prefetch)
// and streams K in BK-deep steps through a two-stage cp.async ring in shared
// memory, so the next step's loads are in flight while the tensor cores
// (WMMA m16n16k16, bf16 in, f32 accumulate) work on the current one.
// blockIdx.x walks the row tiles, so the row tiles of one expert at one
// column slice are scheduled together and re-read that weight slice from
// L2.  gmm_swiglu reads each lhs tile once for both products and applies
// silu(gate) * up to the f32 accumulators before the single bf16 rounding
// of h.  tgmm: one block per (expert, K tile, N tile) of the output; it
// finds its expert's tile range in tile_experts itself and runs the
// contraction over those rows through the same ring, the sum in registers,
// so no atomics and one write.  The contraction runs over rows, so the lhs
// tile is read as a column-major A operand straight from its row-major
// shared-memory copy: no transpose in device memory.  wgmma, TMA and a
// persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int BK = 32;    // depth of one pipeline stage (K, or rows for tgmm)
constexpr int APAD = 8;   // bf16 row padding of the A tile (bank spread)
constexpr int BPAD = 8;   // bf16 row padding of the B tiles
constexpr int CPAD = 4;   // f32 row padding of the epilogue tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  // src-size 0 zero-fills the 16 destination bytes without reading gmem.
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Round a [ROWS, BN] f32 tile (row stride LDC) to bf16 and store its first
// `rows` rows and `cols` columns at dst (row stride ld), 16 bytes a thread.
template <int ROWS, int BN, int NT, int LDC>
__device__ __forceinline__ void store_bf16_tile(const float* sC,
                                                __nv_bfloat16* dst, size_t ld,
                                                int rows, int cols, int tid) {
  for (int c = tid; c < ROWS * (BN / 8); c += NT) {
    const int r = c / (BN / 8);
    const int nc = (c % (BN / 8)) * 8;
    if (r < rows && nc < cols) {
      const float* src = sC + r * LDC + nc;
      uint4 packed;
      unsigned* words = reinterpret_cast<unsigned*>(&packed);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        __nv_bfloat162 pair = __floats2bfloat162_rn(src[2 * q], src[2 * q + 1]);
        words[q] = *reinterpret_cast<unsigned*>(&pair);
      }
      *reinterpret_cast<uint4*>(dst + r * ld + nc) = packed;
    }
  }
}

// Zeros over the same region as store_bf16_tile.
template <int ROWS, int BN, int NT>
__device__ __forceinline__ void zero_bf16_tile(__nv_bfloat16* dst, size_t ld,
                                               int rows, int cols, int tid) {
  for (int c = tid; c < ROWS * (BN / 8); c += NT) {
    const int r = c / (BN / 8);
    const int nc = (c % (BN / 8)) * 8;
    if (r < rows && nc < cols)
      *reinterpret_cast<uint4*>(dst + r * ld + nc) = make_uint4(0, 0, 0, 0);
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool SWIGLU, bool TRANS>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
    gmm_kernel(const __nv_bfloat16* __restrict__ lhs,
               const __nv_bfloat16* __restrict__ rhs0,
               const __nv_bfloat16* __restrict__ rhs1,
               const int32_t* __restrict__ tile_experts,
               const int32_t* __restrict__ valid_tiles,
               __nv_bfloat16* __restrict__ out,
               __nv_bfloat16* __restrict__ gate_out,
               __nv_bfloat16* __restrict__ up_out, int K, int N, int bm) {
  static_assert(!(SWIGLU && TRANS), "the fused SwiGLU reads rhs as [E, K, N]");
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int NB = SWIGLU ? 2 : 1;  // weight operands per stage
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int FM = WM / 16;
  constexpr int FN = WN / 16;
  constexpr int LDA = BK + APAD;
  // B tile: [BK][BN] for rhs [E, K, N]; [BN][BK] for rhs [E, N, K].
  constexpr int LDB = TRANS ? BK + BPAD : BN + BPAD;
  constexpr int LDC = BN + CPAD;
  constexpr int A_STAGE = BM * LDA;  // elements
  constexpr int B_STAGE = TRANS ? BN * LDB : BK * LDB;
  constexpr int PIPE_BYTES = 2 * (A_STAGE + NB * B_STAGE) * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  constexpr int SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile must be 16-aligned");
  static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");
  using BLayout =
      typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type;

  // The pipeline ring [2][A | NB x B] and, after the K loop, the f32
  // epilogue tile share one buffer.
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + 2 * A_STAGE;
  float* sC = reinterpret_cast<float*>(smem);

  const int rows = bm < BM ? bm : BM;  // rows this block owns
  const int row0 = blockIdx.x * rows;
  const int col0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tile = row0 / bm;
  __nv_bfloat16* dst = out + static_cast<size_t>(row0) * N + col0;

  // The compute skip: a tile at or past valid_tiles[0] writes zeros.
  if (valid_tiles != nullptr && tile >= valid_tiles[0]) {
    zero_bf16_tile<BM, BN, NT>(dst, N, rows, N - col0, tid);
    return;
  }

  const int expert = tile_experts[tile];
  const size_t wofs = static_cast<size_t>(expert) * K * N;
  const __nv_bfloat16* W0 = rhs0 + wofs;
  const __nv_bfloat16* W1 = SWIGLU ? rhs1 + wofs : rhs0;

  const int warp = tid / 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;

  auto load_stage = [&](int stage, int k0) {
    __nv_bfloat16* a = sA + stage * A_STAGE;
    for (int c = tid; c < BM * (BK / 8); c += NT) {
      const int r = c / (BK / 8);
      const int kc = (c % (BK / 8)) * 8;
      const bool ok = r < rows && k0 + kc < K;
      const __nv_bfloat16* src =
          ok ? lhs + static_cast<size_t>(row0 + r) * K + k0 + kc : lhs;
      cp_async16(a + r * LDA + kc, src, ok);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const __nv_bfloat16* W = b == 0 ? W0 : W1;
      __nv_bfloat16* s = sB + (stage * NB + b) * B_STAGE;
      if constexpr (TRANS) {
        // rhs[e] is [N, K]: BN rows of BK contiguous values.
        for (int c = tid; c < BN * (BK / 8); c += NT) {
          const int nr = c / (BK / 8);
          const int kc = (c % (BK / 8)) * 8;
          const bool ok = col0 + nr < N && k0 + kc < K;
          const __nv_bfloat16* src =
              ok ? W + static_cast<size_t>(col0 + nr) * K + k0 + kc : W;
          cp_async16(s + nr * LDB + kc, src, ok);
        }
      } else {
        for (int c = tid; c < BK * (BN / 8); c += NT) {
          const int kr = c / (BN / 8);
          const int nc = (c % (BN / 8)) * 8;
          const bool ok = k0 + kr < K && col0 + nc < N;
          const __nv_bfloat16* src =
              ok ? W + static_cast<size_t>(k0 + kr) * N + col0 + nc : W;
          cp_async16(s + kr * LDB + nc, src, ok);
        }
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][FM][FN];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[b][i][j], 0.0f);

  const int nk = (K + BK - 1) / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    // Refill the other stage (last read in iteration kt - 1, which ended in
    // a barrier), then wait for this stage's group.  A group is committed
    // every iteration, empty at the end, so wait_group 1 always means
    // "stage kt has landed".
    if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const __nv_bfloat16* a = sA + (kt & 1) * A_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fa[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const __nv_bfloat16* s = sB + ((kt & 1) * NB + b) * B_STAGE;
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout>
              fb;
          const int n = wn * WN + j * 16;
          wmma::load_matrix_sync(fb, TRANS ? s + n * LDB + kk : s + kk * LDB + n,
                                 LDB);
#pragma unroll
          for (int i = 0; i < FM; ++i)
            wmma::mma_sync(acc[b][i][j], fa[i], fb, acc[b][i][j]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: f32 accumulators -> f32 tile in shared memory -> one bf16
  // rounding on the way out.  With SWIGLU, gate and up go out first when
  // asked for, then h = silu(gate) * up on the f32 accumulators.  Two
  // accumulator fragments of one type map elements to threads identically,
  // so the elementwise SwiGLU pairs gate and up of the same (row, col).
  auto emit = [&](int b, __nv_bfloat16* base) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(
            sC + (wm * WM + i * 16) * LDC + wn * WN + j * 16, acc[b][i][j],
            LDC, wmma::mem_row_major);
    __syncthreads();
    store_bf16_tile<BM, BN, NT, LDC>(
        sC, base + static_cast<size_t>(row0) * N + col0, N, rows, N - col0,
        tid);
    __syncthreads();
  };
  if constexpr (SWIGLU) {
    if (gate_out != nullptr) emit(0, gate_out);
    if (up_out != nullptr) emit(1, up_out);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int t = 0; t < acc[0][i][j].num_elements; ++t) {
          const float g = acc[0][i][j].x[t];
          const float u = acc[1][i][j].x[t];
          acc[0][i][j].x[t] = g / (1.0f + __expf(-g)) * u;
        }
  }
  emit(0, out);
}

// tgmm: out[e][k, n] = sum over rows r of the tiles i with tile_experts[i]
// == e (and i < valid_tiles[0], when given) of lhs[r, k] * dout[r, n].
// Block (x, y, z) owns out[z][x*BKO : +BKO, y*BN : +BN].
template <int BKO, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
    tgmm_kernel(const __nv_bfloat16* __restrict__ lhs,
                const __nv_bfloat16* __restrict__ dout,
                const int32_t* __restrict__ tile_experts,
                const int32_t* __restrict__ valid_tiles,
                __nv_bfloat16* __restrict__ out, int n_tiles, int K, int N,
                int bm) {
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int WM = BKO / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int FM = WM / 16;
  constexpr int FN = WN / 16;
  constexpr int LDA = BKO + APAD;  // A tile: [BK rows][BKO] of lhs
  constexpr int LDB = BN + BPAD;   // B tile: [BK rows][BN] of dout
  constexpr int LDC = BN + CPAD;
  constexpr int A_STAGE = BK * LDA;
  constexpr int B_STAGE = BK * LDB;
  constexpr int PIPE_BYTES = 2 * (A_STAGE + B_STAGE) * 2;
  constexpr int C_BYTES = BKO * LDC * 4;
  constexpr int SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile must be 16-aligned");
  static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");

  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ int s_first, s_last;
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + 2 * A_STAGE;
  float* sC = reinterpret_cast<float*>(smem);

  const int k0o = blockIdx.x * BKO;
  const int col0 = blockIdx.y * BN;
  const int expert = blockIdx.z;
  const int tid = threadIdx.x;
  __nv_bfloat16* dst =
      out + (static_cast<size_t>(expert) * K + k0o) * N + col0;

  // This expert's first and last counted tile.  Tiles past the last group
  // clamp to E - 1 in the layout and add into E - 1, as in the reference.
  int limit = n_tiles;
  if (valid_tiles != nullptr && valid_tiles[0] < limit) limit = valid_tiles[0];
  if (tid == 0) {
    s_first = n_tiles;
    s_last = -1;
  }
  __syncthreads();
  for (int i = tid; i < limit; i += NT)
    if (tile_experts[i] == expert) {
      atomicMin(&s_first, i);
      atomicMax(&s_last, i);
    }
  __syncthreads();
  const int first = s_first;
  const int last = s_last;
  if (last < 0) {  // no counted tile: the expert's gradient is exactly zero
    zero_bf16_tile<BKO, BN, NT>(dst, N, K - k0o, N - col0, tid);
    return;
  }
  const int r_begin = first * bm;
  const int r_end = (last + 1) * bm;

  const int warp = tid / 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;

  // Rows of another expert's tile inside [r_begin, r_end) (only if the
  // layout were not grouped) load as zeros, as do rows past r_end.
  auto load_stage = [&](int stage, int r0) {
    __nv_bfloat16* a = sA + stage * A_STAGE;
    __nv_bfloat16* b = sB + stage * B_STAGE;
    for (int c = tid; c < BK * (BKO / 8); c += NT) {
      const int rr = c / (BKO / 8);
      const int kc = (c % (BKO / 8)) * 8;
      const int r = r0 + rr;
      const bool ok = r < r_end && k0o + kc < K &&
                      tile_experts[r / bm] == expert;
      const __nv_bfloat16* src =
          ok ? lhs + static_cast<size_t>(r) * K + k0o + kc : lhs;
      cp_async16(a + rr * LDA + kc, src, ok);
    }
    for (int c = tid; c < BK * (BN / 8); c += NT) {
      const int rr = c / (BN / 8);
      const int nc = (c % (BN / 8)) * 8;
      const int r = r0 + rr;
      const bool ok = r < r_end && col0 + nc < N &&
                      tile_experts[r / bm] == expert;
      const __nv_bfloat16* src =
          ok ? dout + static_cast<size_t>(r) * N + col0 + nc : dout;
      cp_async16(b + rr * LDB + nc, src, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nsteps = (r_end - r_begin + BK - 1) / BK;
  load_stage(0, r_begin);
  cp_async_commit();
  for (int st = 0; st < nsteps; ++st) {
    if (st + 1 < nsteps) load_stage((st + 1) & 1, r_begin + (st + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const __nv_bfloat16* a = sA + (st & 1) * A_STAGE;
    const __nv_bfloat16* b = sB + (st & 1) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A = lhs_tile^T: element (k, r) sits at a[r * LDA + k], which is the
      // column-major layout of a [BKO, BK] matrix with leading dim LDA.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          fa[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], a + kk * LDA + wm * WM + i * 16, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fb;
        wmma::load_matrix_sync(fb, b + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(sC + (wm * WM + i * 16) * LDC + wn * WN + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  store_bf16_tile<BKO, BN, NT, LDC>(sC, dst, N, K - k0o, N - col0, tid);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool SWIGLU, bool TRANS>
int launch(const void* lhs, const void* rhs0, const void* rhs1,
           const void* tile_experts, const void* valid_tiles, void* out,
           void* gate_out, void* up_out, int M, int K, int N, int bm,
           void* stream) {
  const int rows = bm < BM ? bm : BM;
  dim3 grid(M / rows, (N + BN - 1) / BN);
  dim3 block(WARPS_M * WARPS_N * 32);
  gmm_kernel<BM, BN, WARPS_M, WARPS_N, SWIGLU, TRANS>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(lhs),
          static_cast<const __nv_bfloat16*>(rhs0),
          static_cast<const __nv_bfloat16*>(rhs1),
          static_cast<const int32_t*>(tile_experts),
          static_cast<const int32_t*>(valid_tiles),
          static_cast<__nv_bfloat16*>(out),
          static_cast<__nv_bfloat16*>(gate_out),
          static_cast<__nv_bfloat16*>(up_out), K, N, bm);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int M, int K, int N, int bm) {
  // bm a power of two dividing M; K and N in whole 16-byte chunks.
  return M <= 0 || K <= 0 || N <= 0 || bm <= 0 || (bm & (bm - 1)) != 0 ||
         M % bm != 0 || K % 8 != 0 || N % 8 != 0;
}

template <bool SWIGLU, bool TRANS>
int dispatch(const void* lhs, const void* rhs0, const void* rhs1,
             const void* tile_experts, const void* valid_tiles, void* out,
             void* gate_out, void* up_out, int M, int K, int N, int bm,
             void* stream) {
  if (bad_args(M, K, N, bm)) return static_cast<int>(cudaErrorInvalidValue);
  if (bm >= 64)
    return launch<64, 128, 2, 4, SWIGLU, TRANS>(
        lhs, rhs0, rhs1, tile_experts, valid_tiles, out, gate_out, up_out, M,
        K, N, bm, stream);
  return launch<16, 128, 1, 4, SWIGLU, TRANS>(
      lhs, rhs0, rhs1, tile_experts, valid_tiles, out, gate_out, up_out, M, K,
      N, bm, stream);
}

}  // namespace

extern "C" {

// out[r] = lhs[r] @ rhs[e] (rhs [E, K, N]) or lhs[r] @ rhs[e]^T (rhs
// [E, N, K], transpose_rhs != 0), e = tile_experts[r / bm]; tiles at or past
// valid_tiles[0] write zeros when valid_tiles is not null.  Returns a
// cudaError_t code.
int kctpu_gmm(const void* lhs, const void* rhs, const void* tile_experts,
              const void* valid_tiles, void* out, int M, int K, int N, int bm,
              int transpose_rhs, void* stream) {
  if (transpose_rhs)
    return dispatch<false, true>(lhs, rhs, rhs, tile_experts, valid_tiles, out,
                                 nullptr, nullptr, M, K, N, bm, stream);
  return dispatch<false, false>(lhs, rhs, rhs, tile_experts, valid_tiles, out,
                                nullptr, nullptr, M, K, N, bm, stream);
}

// h[r] = silu(lhs[r] @ rhs_g[e]) * (lhs[r] @ rhs_u[e]), e = tile_experts[r / bm];
// gate and up (the two products, rounded once) too where their pointers are
// not null.
int kctpu_gmm_swiglu(const void* lhs, const void* rhs_g, const void* rhs_u,
                     const void* tile_experts, void* h, void* gate, void* up,
                     int M, int K, int N, int bm, void* stream) {
  return dispatch<true, false>(lhs, rhs_g, rhs_u, tile_experts, nullptr, h,
                               gate, up, M, K, N, bm, stream);
}

// out[e] = sum over the tiles i of expert e (i < valid_tiles[0] when
// valid_tiles is not null) of lhs_i^T @ dout_i: lhs [M, K], dout [M, N],
// out [E, K, N]; an expert with no counted tile gets zeros.
int kctpu_tgmm(const void* lhs, const void* dout, const void* tile_experts,
               const void* valid_tiles, void* out, int M, int K, int N, int bm,
               int n_experts, void* stream) {
  constexpr int BKO = 64, BN = 128, WARPS_M = 2, WARPS_N = 4;
  if (bad_args(M, K, N, bm) || n_experts <= 0 || n_experts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((K + BKO - 1) / BKO, (N + BN - 1) / BN, n_experts);
  dim3 block(WARPS_M * WARPS_N * 32);
  tgmm_kernel<BKO, BN, WARPS_M, WARPS_N>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(lhs),
          static_cast<const __nv_bfloat16*>(dout),
          static_cast<const int32_t*>(tile_experts),
          static_cast<const int32_t*>(valid_tiles),
          static_cast<__nv_bfloat16*>(out), M / bm, K, N, bm);
  return static_cast<int>(cudaGetLastError());
}

const char* kctpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
