// Grouped (per-expert) matmuls for the MoE FFN on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of kubeflow_controller_tpu/ops/grouped_matmul.py:
//   gmm        <- _gmm_kernel (l.78, K loop) and _gmm_single_k_kernel (l.132,
//                 K in one block).  Both compute out[r] = lhs[r] @ rhs[e(r)];
//                 they differ only in how the TPU's VMEM was budgeted, so one
//                 kernel with a K loop ports both.
//   gmm_swiglu <- _gmm2_kernel (l.227), the fused gate/up/SwiGLU forward.
//
// Contract (models/moe.py builds the layout): lhs [M, K] bf16 row-major,
// rhs [E, K, N] bf16, tile_experts [M / bm] int32, out [M, N] bf16, with
// e(r) = tile_experts[r / bm].  Every bm-row tile belongs to one expert; bm
// is a power of two.  Accumulation is f32 over a K loop.
//
// What bounds it on this card.  At decode (8 slots, top-2: M = 144, bm = 16)
// the work is bytes: the gate and up weights of every touched expert,
// 2 x 8 x 4096 x 14336 x 2 B = 1.9 GB per layer at Mixtral-8x7B widths, are
// read once for 16 real rows; at 3.35 TB/s that is ~0.56 ms, against
// ~3.8 GFLOP that the tensor cores finish in ~4 us.  At prefill (a 128-token
// bucket: 256 routed rows, bm = 256) each expert's weights serve ~32 real
// rows, ~64 FLOP per weight byte, still under the ~295 FLOP/B line of bf16
// on H100: bytes again.  But the layout holds M = 2304 rows, 256 of them
// real, and every row is computed, so the padded tiles cost ~9x the useful
// FLOPs (~0.55 ms of tensor-core time at peak for the gate/up product).
//
// What the design does about it.  Each block owns a row tile of BM rows
// (never more than bm, so it never straddles two experts) and a BN-wide
// column slice; it reads its expert id itself (no scalar prefetch) and
// streams K in BK-deep steps through a two-stage cp.async ring in shared
// memory, so the next tile's loads are in flight while the tensor cores
// (WMMA m16n16k16, bf16 in, f32 accumulate) work on the current one.
// blockIdx.x walks the row tiles, so the row tiles of one expert at one
// column slice are scheduled together and re-read that weight slice from
// L2, not from device memory.  gmm_swiglu reads each lhs tile once for both
// products and applies silu(gate) * up to the f32 accumulators before the
// single bf16 rounding of h.  Two tile shapes: BM = 16 for small bm (the
// decode shape, 1008 blocks for the gate/up product) and BM = 64 for bm >= 64.
// Row tiles past the last expert group (their tile_experts clamp to E - 1)
// are computed like any other; nobody reads their rows.
//
// Serving slice: gate and up are needed only by the backward (_gmm2_kernel
// writes them for the VJP); this forward writes h alone.  wgmma, TMA and a
// persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BK = 32;    // K depth of one pipeline stage
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

template <int BM, int BN, int WARPS_M, int WARPS_N, bool SWIGLU>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
    gmm_kernel(const __nv_bfloat16* __restrict__ lhs,
               const __nv_bfloat16* __restrict__ rhs0,
               const __nv_bfloat16* __restrict__ rhs1,
               const int32_t* __restrict__ tile_experts,
               __nv_bfloat16* __restrict__ out, int K, int N, int bm) {
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int NB = SWIGLU ? 2 : 1;  // weight operands per stage
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int FM = WM / 16;
  constexpr int FN = WN / 16;
  constexpr int LDA = BK + APAD;
  constexpr int LDB = BN + BPAD;
  constexpr int LDC = BN + CPAD;
  constexpr int A_STAGE = BM * LDA;  // elements
  constexpr int B_STAGE = BK * LDB;
  constexpr int PIPE_BYTES = 2 * (A_STAGE + NB * B_STAGE) * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  constexpr int SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile must be 16-aligned");
  static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");

  // The pipeline ring [2][A | NB x B] and, after the K loop, the f32
  // epilogue tile share one buffer.
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + 2 * A_STAGE;
  float* sC = reinterpret_cast<float*>(smem);

  const int rows = bm < BM ? bm : BM;  // rows this block owns
  const int row0 = blockIdx.x * rows;
  const int col0 = blockIdx.y * BN;
  const int expert = tile_experts[row0 / bm];
  const size_t wofs = static_cast<size_t>(expert) * K * N;
  const __nv_bfloat16* W0 = rhs0 + wofs;
  const __nv_bfloat16* W1 = SWIGLU ? rhs1 + wofs : rhs0;

  const int tid = threadIdx.x;
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
      for (int c = tid; c < BK * (BN / 8); c += NT) {
        const int kr = c / (BN / 8);
        const int nc = (c % (BN / 8)) * 8;
        const bool ok = k0 + kr < K && col0 + nc < N;
        const __nv_bfloat16* src =
            ok ? W + static_cast<size_t>(k0 + kr) * N + col0 + nc : W;
        cp_async16(s + kr * LDB + nc, src, ok);
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
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, s + kk * LDB + wn * WN + j * 16, LDB);
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

  // Epilogue: (silu(gate) * up on the f32 accumulators for SWIGLU) -> f32
  // tile in shared memory -> one bf16 rounding on the way out.  Two
  // accumulator fragments of one type map elements to threads identically,
  // so the elementwise SwiGLU pairs gate and up of the same (row, col).
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      if constexpr (SWIGLU) {
#pragma unroll
        for (int t = 0; t < acc[0][i][j].num_elements; ++t) {
          const float g = acc[0][i][j].x[t];
          const float u = acc[1][i][j].x[t];
          acc[0][i][j].x[t] = g / (1.0f + __expf(-g)) * u;
        }
      }
      wmma::store_matrix_sync(sC + (wm * WM + i * 16) * LDC + wn * WN + j * 16,
                              acc[0][i][j], LDC, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int c = tid; c < BM * (BN / 8); c += NT) {
    const int r = c / (BN / 8);
    const int nc = (c % (BN / 8)) * 8;
    if (r < rows && col0 + nc < N) {
      const float* src = sC + r * LDC + nc;
      uint4 packed;
      unsigned* words = reinterpret_cast<unsigned*>(&packed);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        __nv_bfloat162 pair = __floats2bfloat162_rn(src[2 * q], src[2 * q + 1]);
        words[q] = *reinterpret_cast<unsigned*>(&pair);
      }
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + r) * N +
                                col0 + nc) = packed;
    }
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool SWIGLU>
int launch(const void* lhs, const void* rhs0, const void* rhs1,
           const void* tile_experts, void* out, int M, int K, int N, int bm,
           void* stream) {
  const int rows = bm < BM ? bm : BM;
  dim3 grid(M / rows, (N + BN - 1) / BN);
  dim3 block(WARPS_M * WARPS_N * 32);
  gmm_kernel<BM, BN, WARPS_M, WARPS_N, SWIGLU>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(lhs),
          static_cast<const __nv_bfloat16*>(rhs0),
          static_cast<const __nv_bfloat16*>(rhs1),
          static_cast<const int32_t*>(tile_experts),
          static_cast<__nv_bfloat16*>(out), K, N, bm);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int M, int K, int N, int bm) {
  // bm a power of two dividing M; K and N in whole 16-byte chunks.
  return M <= 0 || K <= 0 || N <= 0 || bm <= 0 || (bm & (bm - 1)) != 0 ||
         M % bm != 0 || K % 8 != 0 || N % 8 != 0;
}

template <bool SWIGLU>
int dispatch(const void* lhs, const void* rhs0, const void* rhs1,
             const void* tile_experts, void* out, int M, int K, int N, int bm,
             void* stream) {
  if (bad_args(M, K, N, bm)) return static_cast<int>(cudaErrorInvalidValue);
  if (bm >= 64)
    return launch<64, 128, 2, 4, SWIGLU>(lhs, rhs0, rhs1, tile_experts, out,
                                         M, K, N, bm, stream);
  return launch<16, 128, 1, 4, SWIGLU>(lhs, rhs0, rhs1, tile_experts, out, M,
                                       K, N, bm, stream);
}

}  // namespace

extern "C" {

// out[r] = lhs[r] @ rhs[tile_experts[r / bm]].  Returns a cudaError_t code.
int kctpu_gmm(const void* lhs, const void* rhs, const void* tile_experts,
              void* out, int M, int K, int N, int bm, void* stream) {
  return dispatch<false>(lhs, rhs, rhs, tile_experts, out, M, K, N, bm,
                         stream);
}

// h[r] = silu(lhs[r] @ rhs_g[e]) * (lhs[r] @ rhs_u[e]), e = tile_experts[r / bm].
int kctpu_gmm_swiglu(const void* lhs, const void* rhs_g, const void* rhs_u,
                     const void* tile_experts, void* h, int M, int K, int N,
                     int bm, void* stream) {
  return dispatch<true>(lhs, rhs_g, rhs_u, tile_experts, h, M, K, N, bm,
                        stream);
}

const char* kctpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
