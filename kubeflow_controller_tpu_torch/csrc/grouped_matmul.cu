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
//                 three.  rhs is [E, K, N], or [E, N, K] read as rhs^T per
//                 expert (the backward's dlhs = dout @ rhs^T).
//   gmm_swiglu <- _gmm2_kernel (l.227), the fused gate/up/SwiGLU forward;
//                 gate and up are written too when the caller passes their
//                 pointers (the backward needs them).
//   tgmm       <- _tgmm_kernel (l.338) and _tgmm_skip_kernel (l.364), the
//                 weight gradient out[e] = sum over the tiles of e of
//                 lhs_tile^T @ dout_tile.
//
// Contract (models/moe.py builds the layout): lhs [M, K] bf16 row-major,
// rhs [E, K, N] bf16 (or [E, N, K] transposed), tile_experts [M / bm]
// int32, non-decreasing (each expert's tiles consecutive), out [M, N] bf16,
// with e(r) = tile_experts[r / bm].  Every bm-row tile belongs to one
// expert; bm is a power of two; K and N are multiples of 8.  Accumulation
// is f32; each output is rounded to bf16 once.
//
// What bounds it on this card.  At decode (8 slots, top-2: M = 144, bm = 16)
// the forward is bytes: the 16 routed rows read the weights of every
// touched expert (4096 x 14336 x 2 B = 117 MB per expert per weight matrix
// at Mixtral-8x7B widths), 2-3 rows an expert, so 2-3 FLOP a byte against
// the card's ~295 break-even: ~0.035 ms an expert and matrix at 3.35
// TB/s.  At prefill (M 2304, bm 256) still bytes (~0.28 ms for the down
// gmm at 3.35 TB/s).  In training (B 2 x T 4096: 16384 routed rows, M
// 18432, bm 256) each expert's weights serve ~2048 rows: every product is
// operations, ~1.9 TFLOP for a gate/up-sized one (~1.95 ms at 989 TFLOP/s).
//
// Three designs, chosen by bm alone (the wrapper's ops/grouped_matmul.py:
// kernel_variant; the C entry points refuse a bm their design cannot take):
//
// bm >= 64: gmm_wgmma_kernel, gmm_swiglu_wgmma_kernel and tgmm_wgmma_kernel,
//   for the training and prefill layouts.  Warp-specialised: warpgroup 0 is
//   the producer (one thread issuing TMA loads, registers given back with
//   setmaxnreg), one or two consumer warpgroups each hold a 64 x 256 f32
//   tile in registers and run wgmma.m64n256k16 on shared-memory operands
//   (csrc/hopper.cuh).  A 4-stage ring of 48 KB stages (64 deep) with a
//   full/empty mbarrier pair per stage overlaps TMA with the tensor cores;
//   TMA's out-of-bounds zero fill covers ragged K and N, so no load is
//   masked.
//   gmm: a block owns BM = min(128, bm) rows (one expert, never two) and 256
//     columns.  lhs is K-major; rhs is read through a 3-D tensor map with
//     the expert as a coordinate, MN-major for [E, K, N] and K-major for
//     [E, N, K], so rhs^T exists nowhere.  Blocks run in groups of 16 row
//     tiles across the columns, so an expert's weight slice and the group's
//     rows stay in L2.  Under valid_tiles a block of a skipped tile writes
//     zeros without loading anything.
//   gmm_swiglu: gmm's mainloop, registers and stage bytes, with 128 output
//     columns per block.  The stage's B region holds the gate weights'
//     columns [col0, col0 + 128) in its first two [64 K][64 N] boxes and the
//     up weights' same columns in the last two (a tensor map each), so one
//     m64n256k16 accumulates [gate | up] side by side: the thread holding
//     gate column n of a row holds up column n too, and SwiGLU runs on the
//     f32 accumulators in registers.  (Two 64 x 256 accumulators, gate and
//     up at gmm's width, would not fit a warpgroup's registers.)
//   tgmm: a block owns out[e][128 K rows x 256 N columns].  Its expert's
//     tiles are consecutive, so the contraction is one whole-tile row range
//     [first * bm, (last + 1) * bm), found once per block by a scan of
//     tile_experts into shared memory; 64 divides every range, so no row is
//     masked.  Both operands are MN-major in shared memory (lhs^T's M is
//     lhs's K, contiguous; dout's N, contiguous): wgmma takes both
//     transposed, so nothing is transposed in device memory.  Blocks of one
//     expert run in groups of 16 K tiles across N (each wave re-reads about
//     as many lhs bytes as dout bytes).  One write per output, no atomics;
//     an expert with no counted tile writes zeros.
//   The epilogue rounds the accumulators to bf16 once, stages them in the
//   (then idle) ring and writes each row out in 16-byte stores (gmm_swiglu:
//   h, and gate and up where the caller asks for them).
//
// bm < 64, gmm and gmm_swiglu: gmm_swapab_kernel<NR, SWIGLU, TRANS>, the
//   swap-AB weight stream (decode: bm 16; the 16-token prefill bucket: bm
//   32).  It ports _gmm_single_k_kernel, _gmm_single_k_skip_kernel and
//   _gmm2_kernel at these sizes.  A bm-row tile is too few rows for
//   wgmma's 64-row M, and the weights are the operand that has to stream,
//   so the operands are swapped: the block computes out^T = W^T lhs^T, the
//   weights' output columns as wgmma's M (A, from shared memory: MN-major
//   for rhs [E, K, N], K-major for [E, N, K]) and the rows as its N (B,
//   K-major lhs rows): m64nNRk16.  Below bm 8 a tile's 8-row box runs into
//   the next tile; those rows are computed and never stored.
//   What it does about the bytes.  A block owns 128 output columns (two
//   64-wide weight boxes a stage; gmm_swiglu: the same 128 gate and up
//   columns, four boxes, into four accumulators, so gate and up of one
//   (column, row) sit in one thread and SwiGLU runs on the f32 values).
//   The accumulators are 128 x NR f32 (gmm_swiglu: twice that), NR to
//   2 NR registers a thread, so the block is small (one consumer warpgroup and one producer warp,
//   160 threads) and its shared memory goes to the ring: 3-4 stages of 64
//   K (16 KB of weights a stage for gmm, 32 KB for gmm_swiglu, plus the
//   lhs rows), a full/empty mbarrier pair per stage, one thread issuing
//   the TMA loads.  Rings of <= 72 KB (gmm) and <= 108 KB (gmm_swiglu)
//   let 3 and 2 blocks share an SM: ~100-140 KB of loads outstanding per
//   SM.  The decode down gmm (N 4096, K 14336) has 32 column slices x 9
//   row tiles = 288 blocks, all resident at once; K is not split (no
//   second pass).  128-column slices read 256 contiguous bytes of each
//   weight row and half the lhs re-reads of 64-column ones: 3% (gmm) and
//   6% (gmm_swiglu) faster at decode (tools/swapab_variants.py, H100
//   80GB HBM3 at 700 W).
//   One weight read per run.  Row tiles run fastest within a column slice
//   (blockIdx.x = slice * tiles + tile), so the tiles of one expert, the
//   clamped tiles past the last group included (they carry E - 1), are
//   resident together and later reads of the same weight boxes hit L2.
//   gmm goes further: at bm >= 8 its wgmma N is 64 and a block takes up
//   to 64 / bm consecutive tiles of its expert's run (found by a binary
//   search of the non-decreasing tile_experts), loading one lhs box per
//   tile it holds; blocks whose tile a run-mate took exit at once.  The
//   clamped tail then streams its weights once, not once a tile: at
//   decode, with 4 tail tiles of 9, 7% faster.  gmm_swiglu stays at one
//   tile a block: a 64-row lhs region would grow its 34 KB stage to 40 KB
//   and its ring to one block an SM, 12% slower (same tool and card).
//   Under valid_tiles a skipped tile writes zeros without loading
//   anything, and no block takes a tile past it.
//   Epilogue: the accumulator is [columns x rows]; it is rounded to bf16
//   once (gmm_swiglu: h = silu(gate) * up on the f32 values, and gate and
//   up where asked), transposed through the idle ring, and written as rows
//   in 16-byte stores, masked at the ragged N edge and past the rows the
//   block holds.
//
// bm < 64, tgmm: tgmm_kernel (WMMA m16n16k16 from mma.sync, a two-stage
//   cp.async ring, 48 KB of static shared memory).  No chip path launches
//   it: the training layouts use bm 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace nvcuda;

constexpr int BK = 32;    // rows of one tgmm_kernel pipeline stage
constexpr int APAD = 8;   // bf16 row padding of the A tile (bank spread)
constexpr int BPAD = 8;   // bf16 row padding of the B tile
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

bool bad_args(int M, int K, int N, int bm) {
  // bm a power of two dividing M; K and N in whole 16-byte chunks.
  return M <= 0 || K <= 0 || N <= 0 || bm <= 0 || (bm & (bm - 1)) != 0 ||
         M % bm != 0 || K % 8 != 0 || N % 8 != 0;
}

// The smallest bm of the wgmma design (ops/grouped_matmul.py:WGMMA_MIN_BM):
// a 64-row tile never straddles two experts, and 64 divides every
// expert's row range.
constexpr int WGMMA_MIN_BM = 64;

// ---------------------------------------------------------------------------
// bm >= 64: warp-specialised TMA + wgmma kernels
// ---------------------------------------------------------------------------

constexpr int HG_BK = 64;        // depth of one stage: K (gmm) or rows (tgmm)
constexpr int HG_BN = 256;       // output columns per block
constexpr int HG_STAGES = 4;
constexpr int HG_BOX = 64 * 128;  // bytes of one [64][64] bf16 TMA box
constexpr int HG_GROUP = 16;      // raster group: row (gmm) or K (tgmm) tiles
constexpr int HG_LDS = HG_BN + 8;  // bf16 row stride of the epilogue staging

// NC consumer warpgroups: an output tile of 64 * NC rows.
template <int NC>
struct HgShape {
  static constexpr int BM = 64 * NC;
  static constexpr int THREADS = (NC + 1) * 128;
  static constexpr int A_BYTES = BM * 128;     // [BM][64] gmm, [64][BM] tgmm
  static constexpr int B_BYTES = HG_BN * 128;   // 4 x [64][64] or [256][64]
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = HG_STAGES * STAGE;
  // + 1 KB to align the ring to the swizzle atom, + the mbarriers.
  static constexpr int SMEM = 1024 + RING + 2 * HG_STAGES * 8;
  static_assert(NC * 64 * HG_LDS * 2 <= RING, "epilogue staging fits");
  static_assert(SMEM <= 227 * 1024, "dynamic shared memory limit");
};

// Block `pid` of an n_major x n_minor grid of tiles, in groups of HG_GROUP
// major tiles: within a group the major index runs fastest.
__device__ __forceinline__ void raster(int pid, int n_major, int n_minor,
                                       int& major, int& minor) {
  const int per_group = HG_GROUP * n_minor;
  const int group = pid / per_group;
  const int first = group * HG_GROUP;
  const int size = min(n_major - first, HG_GROUP);
  const int in_group = pid - group * per_group;
  major = first + in_group % size;
  minor = in_group / size;
}

__device__ __forceinline__ uint8_t* align_ring(uint8_t* p) {
  const uint32_t a = hopper::smem_u32(p);
  return p + ((hopper::SWIZZLE_ATOM - a % hopper::SWIZZLE_ATOM) %
              hopper::SWIZZLE_ATOM);
}

// A consumer warpgroup's 64 x 256 f32 accumulators (layout in hopper.cuh),
// rounded to bf16 once, through `stage` (64 x HG_LDS bf16, conflict-free
// 4-byte writes) to dst in 16-byte row-contiguous stores: rows < rows_ok,
// columns < cols_ok.  t is the thread's index in its warpgroup.
__device__ __forceinline__ void store_acc(const float (&d)[128],
                                          __nv_bfloat16* stage,
                                          __nv_bfloat16* dst, size_t ld,
                                          int rows_ok, int cols_ok, int t,
                                          int barrier_id) {
  const int w = t / 32, l = t % 32;
#pragma unroll
  for (int j = 0; j < HG_BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * w + l / 4 + 8 * h;
      const int c = 8 * j + 2 * (l % 4);
      *reinterpret_cast<__nv_bfloat162*>(stage + r * HG_LDS + c) =
          __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  hopper::named_barrier(barrier_id, 128);
  for (int i = t; i < 64 * (HG_BN / 8); i += 128) {
    const int r = i / (HG_BN / 8);
    const int c = (i % (HG_BN / 8)) * 8;
    if (r < rows_ok && c < cols_ok)
      *reinterpret_cast<uint4*>(dst + r * ld + c) =
          *reinterpret_cast<const uint4*>(stage + r * HG_LDS + c);
  }
}

// The consumer side of the kernels: `steps` stages through the ring, each
// four m64n256k16 products of this warpgroup's A slice (a_off bytes into
// the stage's A region) and the stage's B.  Once every consumer's last
// products are done (so the ring is free for staging), epilogue(d).
template <int NC, int TA, int TB, typename Epilogue>
__device__ __forceinline__ void consume(uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, int steps, int a_off,
                                        uint32_t a_lbo, uint32_t b_lbo,
                                        Epilogue&& epilogue) {
  using S = HgShape<NC>;
  constexpr uint64_t A_STEP =
      TA ? hopper::K_STEP_MNMAJOR : hopper::K_STEP_KMAJOR;
  constexpr uint64_t B_STEP =
      TB ? hopper::K_STEP_MNMAJOR : hopper::K_STEP_KMAJOR;
  const int t = threadIdx.x % 128;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  for (int st = 0; st < steps; ++st) {
    const int s = st % HG_STAGES;
    hopper::mbar_wait(&full[s], (st / HG_STAGES) & 1);
    const uint8_t* a = ring + s * S::STAGE + a_off;
    const uint8_t* b = ring + s * S::STAGE + S::A_BYTES;
    const uint64_t da = hopper::desc_b128(a, a_lbo, hopper::SWIZZLE_ATOM);
    const uint64_t db = hopper::desc_b128(b, b_lbo, hopper::SWIZZLE_ATOM);
    hopper::fence_regs(d);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HG_BK / 16; ++kk)
      hopper::wgmma_m64n256k16<TA, TB>(d, da + kk * A_STEP, db + kk * B_STEP);
    hopper::wgmma_commit();
    // The previous stage's products are done: hand its buffer back.
    hopper::wgmma_wait<1>();
    hopper::fence_regs(d);
    if (st > 0 && t == 0) hopper::mbar_arrive(&empty[(st - 1) % HG_STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
  hopper::named_barrier(1, NC * 128);
  epilogue(d);
}

// Barriers of the ring: full[s] completes when stage s has landed (one
// arrival with its byte count), empty[s] when all NC consumers are done
// with it.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int nc) {
  for (int s = 0; s < HG_STAGES; ++s) {
    hopper::mbar_init(&full[s], 1);
    hopper::mbar_init(&empty[s], nc);
  }
  hopper::fence_barrier_init();
}

// The producer of gmm and gmm_swiglu (one thread): stage kt % HG_STAGES
// gets lhs rows [row0, row0 + BM) of K tile kt and, through
// load_b(b, k0, bar), the stage's B region.
template <int NC, typename LoadB>
__device__ __forceinline__ void produce(uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, int nk,
                                        const CUtensorMap* map_lhs, int row0,
                                        LoadB&& load_b) {
  using S = HgShape<NC>;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % HG_STAGES;
    if (kt >= HG_STAGES)
      hopper::mbar_wait(&empty[s], ((kt / HG_STAGES) + 1) & 1);
    uint8_t* a = ring + s * S::STAGE;
    hopper::mbar_arrive_expect_tx(&full[s], S::STAGE);
    hopper::tma_load_2d(a, map_lhs, &full[s], kt * HG_BK, row0);
    load_b(a + S::A_BYTES, kt * HG_BK, &full[s]);
  }
}

// gmm, bm >= 64: out[row0 : +BM, col0 : +256] of the tile's expert.
// map_lhs: [M, K] box {64, BM}; map_rhs: [E, K, N] box {64, 64, 1}, or
// (TRANS) [E, N, K] box {64, 256, 1}.
template <int NC, bool TRANS>
__global__ void __launch_bounds__(HgShape<NC>::THREADS, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_lhs,
                     const __grid_constant__ CUtensorMap map_rhs,
                     const int32_t* __restrict__ tile_experts,
                     const int32_t* __restrict__ valid_tiles,
                     __nv_bfloat16* __restrict__ out, int K, int N, int bm,
                     int n_row_tiles, int n_col_tiles) {
  using S = HgShape<NC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_ring(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::RING);
  uint64_t* empty = full + HG_STAGES;

  int rt, ct;
  raster(blockIdx.x, n_row_tiles, n_col_tiles, rt, ct);
  const int row0 = rt * S::BM;
  const int col0 = ct * HG_BN;
  const int tile = row0 / bm;
  const int tid = threadIdx.x;
  __nv_bfloat16* dst = out + static_cast<size_t>(row0) * N + col0;

  // The compute skip: a tile at or past valid_tiles[0] writes zeros.
  if (valid_tiles != nullptr && tile >= valid_tiles[0]) {
    zero_bf16_tile<S::BM, HG_BN, S::THREADS>(dst, N, S::BM, N - col0, tid);
    return;
  }
  const int expert = tile_experts[tile];
  const int nk = (K + HG_BK - 1) / HG_BK;

  if (tid == 0) init_ring(full, empty, NC);
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    if constexpr (NC == 2) hopper::setmaxnreg_dec<40>();
    if (tid == 0)
      produce<NC>(ring, full, empty, nk, &map_lhs, row0,
                  [&](uint8_t* b, int k0, uint64_t* bar) {
                    if constexpr (TRANS) {
                      hopper::tma_load_3d(b, &map_rhs, bar, k0, col0, expert);
                    } else {
#pragma unroll
                      for (int j = 0; j < HG_BN / 64; ++j)
                        hopper::tma_load_3d(b + j * HG_BOX, &map_rhs, bar,
                                            col0 + 64 * j, k0, expert);
                    }
                  });
  } else {
    if constexpr (NC == 2) hopper::setmaxnreg_inc<232>();
    const int c = wg - 1;  // this warpgroup's rows: [64c, 64c + 64)
    // A: K-major rows of lhs.  B: K-major rows of rhs^T ([E, N, K]), or
    // MN-major [64 K][64 N] boxes 8 KB apart ([E, K, N]).
    consume<NC, 0, TRANS ? 0 : 1>(
        ring, full, empty, nk, c * 64 * 128, 16, TRANS ? 16 : HG_BOX,
        [&](const float (&d)[128]) {
          store_acc(d, reinterpret_cast<__nv_bfloat16*>(ring) + c * 64 * HG_LDS,
                    dst + static_cast<size_t>(c) * 64 * N, N, 64, N - col0,
                    tid % 128, 2 + c);
        });
  }
}

// gmm_swiglu's block: 128 output columns (a [gate | up] pair of 128 each in
// the 256-wide accumulator).
constexpr int SW_BN = HG_BN / 2;
constexpr int SW_LDS = SW_BN + 8;  // bf16 row stride of its staging
constexpr int SW_STAGING = 3 * 64 * SW_LDS;  // h, gate, up: bf16 per consumer
static_assert(2 * SW_STAGING * 2 <= HgShape<2>::RING, "staging fits (NC 2)");
static_assert(SW_STAGING * 2 <= HgShape<1>::RING, "staging fits (NC 1)");

// A consumer warpgroup's [gate | up] accumulators: gate column n of a row in
// d[4j + 2h + c], up column n in d[4(j + 16) + 2h + c] (j < 16; layout in
// hopper.cuh).  h = silu(gate) * up on the f32 values, then each output
// rounded to bf16 once, through `stage` (three 64 x SW_LDS tiles,
// conflict-free 4-byte writes) to h_dst (and gate_dst / up_dst when not
// null) in 16-byte row-contiguous stores, columns < cols_ok.
__device__ __forceinline__ void store_swiglu(
    const float (&d)[128], __nv_bfloat16* stage, __nv_bfloat16* h_dst,
    __nv_bfloat16* gate_dst, __nv_bfloat16* up_dst, size_t ld, int cols_ok,
    int t, int barrier_id) {
  const int w = t / 32, l = t % 32;
  __nv_bfloat16* s_h = stage;
  __nv_bfloat16* s_g = stage + 64 * SW_LDS;
  __nv_bfloat16* s_u = stage + 2 * 64 * SW_LDS;
#pragma unroll
  for (int j = 0; j < SW_BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = (16 * w + l / 4 + 8 * h) * SW_LDS + 8 * j + 2 * (l % 4);
      const float g0 = d[4 * j + 2 * h], g1 = d[4 * j + 2 * h + 1];
      const float u0 = d[4 * (j + 16) + 2 * h];
      const float u1 = d[4 * (j + 16) + 2 * h + 1];
      *reinterpret_cast<__nv_bfloat162*>(s_h + i) = __floats2bfloat162_rn(
          g0 / (1.0f + __expf(-g0)) * u0, g1 / (1.0f + __expf(-g1)) * u1);
      *reinterpret_cast<__nv_bfloat162*>(s_g + i) =
          __floats2bfloat162_rn(g0, g1);
      *reinterpret_cast<__nv_bfloat162*>(s_u + i) =
          __floats2bfloat162_rn(u0, u1);
    }
  hopper::named_barrier(barrier_id, 128);
  for (int i = t; i < 64 * (SW_BN / 8); i += 128) {
    const int r = i / (SW_BN / 8);
    const int c = (i % (SW_BN / 8)) * 8;
    if (c >= cols_ok) continue;
    const int src = r * SW_LDS + c;
    const size_t dst = r * ld + c;
    *reinterpret_cast<uint4*>(h_dst + dst) =
        *reinterpret_cast<const uint4*>(s_h + src);
    if (gate_dst != nullptr)
      *reinterpret_cast<uint4*>(gate_dst + dst) =
          *reinterpret_cast<const uint4*>(s_g + src);
    if (up_dst != nullptr)
      *reinterpret_cast<uint4*>(up_dst + dst) =
          *reinterpret_cast<const uint4*>(s_u + src);
  }
}

// gmm_swiglu, bm >= 64: h[row0 : +BM, col0 : +128] = silu(lhs @ rhs_g[e]) *
// (lhs @ rhs_u[e]) for the tile's expert, and gate / up where their
// pointers are not null.  map_lhs: [M, K] box {64, BM}; map_g, map_u:
// [E, K, N] box {64, 64, 1}.
template <int NC>
__global__ void __launch_bounds__(HgShape<NC>::THREADS, 1)
    gmm_swiglu_wgmma_kernel(const __grid_constant__ CUtensorMap map_lhs,
                            const __grid_constant__ CUtensorMap map_g,
                            const __grid_constant__ CUtensorMap map_u,
                            const int32_t* __restrict__ tile_experts,
                            __nv_bfloat16* __restrict__ h,
                            __nv_bfloat16* __restrict__ gate,
                            __nv_bfloat16* __restrict__ up, int K, int N,
                            int bm, int n_row_tiles, int n_col_tiles) {
  using S = HgShape<NC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_ring(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::RING);
  uint64_t* empty = full + HG_STAGES;

  int rt, ct;
  raster(blockIdx.x, n_row_tiles, n_col_tiles, rt, ct);
  const int row0 = rt * S::BM;
  const int col0 = ct * SW_BN;
  const int expert = tile_experts[row0 / bm];
  const int nk = (K + HG_BK - 1) / HG_BK;
  const int tid = threadIdx.x;

  if (tid == 0) init_ring(full, empty, NC);
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    if constexpr (NC == 2) hopper::setmaxnreg_dec<40>();
    if (tid == 0)
      produce<NC>(ring, full, empty, nk, &map_lhs, row0,
                  [&](uint8_t* b, int k0, uint64_t* bar) {
#pragma unroll
                    for (int j = 0; j < SW_BN / 64; ++j) {
                      hopper::tma_load_3d(b + j * HG_BOX, &map_g, bar,
                                          col0 + 64 * j, k0, expert);
                      hopper::tma_load_3d(b + (SW_BN / 64 + j) * HG_BOX,
                                          &map_u, bar, col0 + 64 * j, k0,
                                          expert);
                    }
                  });
  } else {
    if constexpr (NC == 2) hopper::setmaxnreg_inc<232>();
    const int c = wg - 1;  // this warpgroup's rows: [64c, 64c + 64)
    const size_t ofs = static_cast<size_t>(row0 + 64 * c) * N + col0;
    // A: K-major rows of lhs.  B: four MN-major [64 K][64 N] boxes 8 KB
    // apart, gate columns then up columns.
    consume<NC, 0, 1>(
        ring, full, empty, nk, c * 64 * 128, 16, HG_BOX,
        [&](const float (&d)[128]) {
          store_swiglu(d,
                       reinterpret_cast<__nv_bfloat16*>(ring) + c * SW_STAGING,
                       h + ofs, gate == nullptr ? nullptr : gate + ofs,
                       up == nullptr ? nullptr : up + ofs, N, N - col0,
                       tid % 128, 2 + c);
        });
  }
}

// tgmm, bm >= 64: out[e][k0 : +128, col0 : +256] = sum over the rows r of
// e's counted tiles of lhs[r, k0 : +128]^T dout[r, col0 : +256].
// map_lhs: [M, K] box {64, 64}; map_dout: [M, N] box {64, 64}.
__global__ void __launch_bounds__(HgShape<2>::THREADS, 1)
    tgmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_lhs,
                      const __grid_constant__ CUtensorMap map_dout,
                      const int32_t* __restrict__ tile_experts,
                      const int32_t* __restrict__ valid_tiles,
                      __nv_bfloat16* __restrict__ out, int n_tiles, int K,
                      int N, int bm, int n_k_tiles, int n_n_tiles) {
  using S = HgShape<2>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_first, s_last;
  uint8_t* ring = align_ring(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::RING);
  uint64_t* empty = full + HG_STAGES;

  int kt, nt;
  raster(blockIdx.x, n_k_tiles, n_n_tiles, kt, nt);
  const int k0 = kt * S::BM;
  const int col0 = nt * HG_BN;
  const int expert = blockIdx.y;
  const int tid = threadIdx.x;
  __nv_bfloat16* dst =
      out + (static_cast<size_t>(expert) * K + k0) * N + col0;

  // The expert's first and last counted tile.  Tiles past the last group
  // carry E - 1 in the layout and add into E - 1, as in the reference.
  int limit = n_tiles;
  if (valid_tiles != nullptr && valid_tiles[0] < limit) limit = valid_tiles[0];
  if (tid == 0) {
    s_first = n_tiles;
    s_last = -1;
    init_ring(full, empty, 2);
  }
  __syncthreads();
  for (int i = tid; i < limit; i += S::THREADS)
    if (tile_experts[i] == expert) {
      atomicMin(&s_first, i);
      atomicMax(&s_last, i);
    }
  __syncthreads();
  if (s_last < 0) {  // no counted tile: the expert's gradient is exactly zero
    zero_bf16_tile<S::BM, HG_BN, S::THREADS>(dst, N, K - k0, N - col0, tid);
    return;
  }
  const int r_begin = s_first * bm;
  const int steps = (s_last + 1 - s_first) * bm / HG_BK;

  const int wg = tid / 128;
  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int st = 0; st < steps; ++st) {
        const int s = st % HG_STAGES;
        if (st >= HG_STAGES)
          hopper::mbar_wait(&empty[s], ((st / HG_STAGES) + 1) & 1);
        uint8_t* a = ring + s * S::STAGE;
        uint8_t* b = a + S::A_BYTES;
        const int r = r_begin + st * HG_BK;
        hopper::mbar_arrive_expect_tx(&full[s], S::STAGE);
#pragma unroll
        for (int j = 0; j < S::BM / 64; ++j)
          hopper::tma_load_2d(a + j * HG_BOX, &map_lhs, &full[s], k0 + 64 * j,
                              r);
#pragma unroll
        for (int j = 0; j < HG_BN / 64; ++j)
          hopper::tma_load_2d(b + j * HG_BOX, &map_dout, &full[s],
                              col0 + 64 * j, r);
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int c = wg - 1;  // this warpgroup's K rows: [k0 + 64c, +64)
    // A = lhs^T: the c-th [64 rows][64 K] box, MN-major (one 64-wide block).
    // B = dout: four [64 rows][64 N] boxes 8 KB apart, MN-major.
    consume<2, 1, 1>(
        ring, full, empty, steps, c * HG_BOX, HG_BOX, HG_BOX,
        [&](const float (&d)[128]) {
          store_acc(d, reinterpret_cast<__nv_bfloat16*>(ring) + c * 64 * HG_LDS,
                    dst + static_cast<size_t>(c) * 64 * N, N, K - k0 - 64 * c,
                    N - col0, tid % 128, 2 + c);
        });
  }
}

// ---------------------------------------------------------------------------
// bm < 64: the swap-AB weight stream
// ---------------------------------------------------------------------------

constexpr int SA_NC = 2;           // 64-column weight boxes a matrix a stage
constexpr int SA_BN = 64 * SA_NC;  // output columns per block
constexpr int SA_THREADS = 160;    // one consumer warpgroup + one producer warp
constexpr int SA_LDS = SA_BN + 8;  // bf16 row stride of the epilogue staging
constexpr int SA_GMM_BUDGET = 72 * 1024;      // ring bytes: 3 blocks an SM
constexpr int SA_SWIGLU_BUDGET = 102 * 1024;  // 2 blocks an SM

// Rows of one tile's lhs box: max(8, bm); for bm < 8 the box runs into the
// next tile.
__host__ __device__ constexpr int sa_box_rows(int bm) {
  return bm < 8 ? 8 : bm;
}

// NR rows (wgmma's N) a block; SWIGLU: gate and up boxes per stage.
template <int NR, bool SWIGLU>
struct SaShape {
  static constexpr int NB = (SWIGLU ? 2 : 1) * SA_NC;  // weight boxes a stage
  static constexpr int W_BYTES = NB * HG_BOX;   // [64 K][64 columns] each
  static constexpr int B_BYTES = NR * 128;      // [NR rows][64 K] of lhs
  static constexpr int STAGE = W_BYTES + B_BYTES;  // a multiple of 1 KB
  static constexpr int BUDGET = SWIGLU ? SA_SWIGLU_BUDGET : SA_GMM_BUDGET;
  static constexpr int STAGES = BUDGET / STAGE < 3 ? 3 : BUDGET / STAGE;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = 1024 + RING + 2 * STAGES * 8;
  static constexpr int PLANES = SWIGLU ? 3 : 1;  // h, gate, up staging
  static_assert(STAGE % hopper::SWIZZLE_ATOM == 0, "stages stay aligned");
  static_assert(PLANES * NR * SA_LDS * 2 <= RING, "epilogue staging fits");
};

// gmm (SWIGLU false) and gmm_swiglu (SWIGLU true), bm < 64: output columns
// [col0, col0 + SA_BN) of the rows of tile x % n_tiles (and, where NR
// holds more than one tile's box, of the next tiles of its expert's run,
// up to NR rows), as out^T = W^T lhs^T.  Column slice x / n_tiles.  map_lhs: [M, K] box {64, max(8,
// bm)}; map_w0 (and map_w1, the up weights, with SWIGLU): [E, K, N] box
// {64, 64, 1}, or (TRANS) [E, N, K] box {64, 64, 1}.  tile_experts is
// non-decreasing.
template <int NR, bool SWIGLU, bool TRANS>
__global__ void __launch_bounds__(SA_THREADS)
    gmm_swapab_kernel(const __grid_constant__ CUtensorMap map_lhs,
                      const __grid_constant__ CUtensorMap map_w0,
                      const __grid_constant__ CUtensorMap map_w1,
                      const int32_t* __restrict__ tile_experts,
                      const int32_t* __restrict__ valid_tiles,
                      __nv_bfloat16* __restrict__ out,
                      __nv_bfloat16* __restrict__ gate,
                      __nv_bfloat16* __restrict__ up, int K, int N, int bm,
                      int n_tiles) {
  static_assert(!(SWIGLU && TRANS), "the fused SwiGLU reads rhs as [E, K, N]");
  using S = SaShape<NR, SWIGLU>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_ring(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::RING);
  uint64_t* empty = full + S::STAGES;

  const int tile = blockIdx.x % n_tiles;
  const int col0 = (blockIdx.x / n_tiles) * SA_BN;
  const int row0 = tile * bm;
  const int cols_ok = N - col0;
  const int tid = threadIdx.x;
  const size_t ofs = static_cast<size_t>(row0) * N + col0;

  // The compute skip: a tile at or past valid_tiles[0] writes zeros.
  int limit = n_tiles;
  if (valid_tiles != nullptr) limit = min(limit, valid_tiles[0]);
  if (tile >= limit) {
    zero_bf16_tile<NR, SA_BN, SA_THREADS>(out + ofs, N, bm, cols_ok, tid);
    return;
  }
  const int expert = tile_experts[tile];
  // The tiles this block computes, [tile, tile + n_in): with more than one
  // box in NR, the run's tiles go in chunks of `per` from its first tile,
  // and a block whose tile is not a chunk's first has nothing to do.
  const int box_rows = sa_box_rows(bm);
  const int per = NR / box_rows;
  int n_in = 1;
  if (per > 1) {
    int lo = 0, hi = tile;  // the run's first tile
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (tile_experts[mid] < expert)
        lo = mid + 1;
      else
        hi = mid;
    }
    if ((tile - lo) % per != 0) return;
    const int end = min(tile + per, limit);
    while (tile + n_in < end && tile_experts[tile + n_in] == expert) ++n_in;
  }
  const int nk = (K + HG_BK - 1) / HG_BK;

  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 1);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp: one thread issues every load
    if (tid == 128) {
      const uint32_t bytes = S::W_BYTES + n_in * box_rows * 128;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S::STAGES;
        if (kt >= S::STAGES)
          hopper::mbar_wait(&empty[s], ((kt / S::STAGES) + 1) & 1);
        uint8_t* st = ring + s * S::STAGE;
        const int k0 = kt * HG_BK;
        hopper::mbar_arrive_expect_tx(&full[s], bytes);
#pragma unroll
        for (int c = 0; c < SA_NC; ++c) {
          const int n0 = col0 + 64 * c;
          if constexpr (TRANS) {
            hopper::tma_load_3d(st + c * HG_BOX, &map_w0, &full[s], k0, n0,
                                expert);
          } else {
            hopper::tma_load_3d(st + c * HG_BOX, &map_w0, &full[s], n0, k0,
                                expert);
            if constexpr (SWIGLU)
              hopper::tma_load_3d(st + (SA_NC + c) * HG_BOX, &map_w1,
                                  &full[s], n0, k0, expert);
          }
        }
        for (int i = 0; i < n_in; ++i)
          hopper::tma_load_2d(st + S::W_BYTES + i * box_rows * 128, &map_lhs,
                              &full[s], k0, row0 + i * bm);
      }
    }
    return;
  }

  // The consumer warpgroup.  A: each weight box, MN-major for [E, K, N]
  // (one 64-wide block; a 16-deep K step is 16 rows), K-major for
  // [E, N, K].  B: NR K-major lhs rows (rows of boxes not loaded are
  // computed and never stored).
  constexpr int TA = TRANS ? 0 : 1;
  constexpr uint64_t A_STEP =
      TRANS ? hopper::K_STEP_KMAJOR : hopper::K_STEP_MNMAJOR;
  constexpr uint32_t A_LBO = TRANS ? 16 : HG_BOX;
  float acc[S::NB][NR / 2];
#pragma unroll
  for (int b = 0; b < S::NB; ++b)
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) acc[b][i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S::STAGES;
    hopper::mbar_wait(&full[s], (kt / S::STAGES) & 1);
    const uint8_t* st = ring + s * S::STAGE;
    const uint64_t db =
        hopper::desc_b128(st + S::W_BYTES, 16, hopper::SWIZZLE_ATOM);
#pragma unroll
    for (int b = 0; b < S::NB; ++b) hopper::fence_regs(acc[b]);
    hopper::wgmma_fence();
#pragma unroll
    for (int b = 0; b < S::NB; ++b) {
      const uint64_t da =
          hopper::desc_b128(st + b * HG_BOX, A_LBO, hopper::SWIZZLE_ATOM);
#pragma unroll
      for (int kk = 0; kk < HG_BK / 16; ++kk)
        hopper::wgmma_m64nNk16<NR, TA, 0>(acc[b], da + kk * A_STEP,
                                          db + kk * hopper::K_STEP_KMAJOR);
    }
    hopper::wgmma_commit();
    // The previous stage's products are done: hand its buffer back.
    hopper::wgmma_wait<1>();
#pragma unroll
    for (int b = 0; b < S::NB; ++b) hopper::fence_regs(acc[b]);
    if (kt > 0 && tid == 0) hopper::mbar_arrive(&empty[(kt - 1) % S::STAGES]);
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < S::NB; ++b) hopper::fence_regs(acc[b]);
  // Every load has landed and every product is done: the ring is idle.
  hopper::named_barrier(1, 128);

  // acc[b][4j + 2h + c] is output column col0 + 64 (b % SA_NC) + 16w + l/4
  // + 8h of row 8j + 2(l % 4) + c (hopper.cuh's layout, M and N swapped;
  // boxes b >= SA_NC hold the up weights' columns): staged as [row][column]
  // bf16 planes (h, then gate and up with SWIGLU).
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(ring);
  constexpr int PLANE = NR * SA_LDS;
  const int w = tid / 32, l = tid % 32;
#pragma unroll
  for (int b = 0; b < SA_NC; ++b)
#pragma unroll
    for (int j = 0; j < NR / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = (8 * j + 2 * (l % 4) + c) * SA_LDS + 64 * b +
                        16 * w + l / 4 + 8 * h;
          const int e = 4 * j + 2 * h + c;
          if constexpr (SWIGLU) {
            const float g = acc[b][e], u = acc[SA_NC + b][e];
            stage[i] = __float2bfloat16_rn(g / (1.0f + __expf(-g)) * u);
            stage[PLANE + i] = __float2bfloat16_rn(g);
            stage[2 * PLANE + i] = __float2bfloat16_rn(u);
          } else {
            stage[i] = __float2bfloat16_rn(acc[b][e]);
          }
        }
  hopper::named_barrier(1, 128);
  const int rows_ok = n_in * bm;
  for (int i = tid; i < rows_ok * (SA_BN / 8); i += 128) {
    const int r = i / (SA_BN / 8);
    const int c = (i % (SA_BN / 8)) * 8;
    if (c >= cols_ok) continue;
    const int src = r * SA_LDS + c;
    const size_t dst = ofs + static_cast<size_t>(r) * N + c;
    *reinterpret_cast<uint4*>(out + dst) =
        *reinterpret_cast<const uint4*>(stage + src);
    if constexpr (SWIGLU) {
      if (gate != nullptr)
        *reinterpret_cast<uint4*>(gate + dst) =
            *reinterpret_cast<const uint4*>(stage + PLANE + src);
      if (up != nullptr)
        *reinterpret_cast<uint4*>(up + dst) =
            *reinterpret_cast<const uint4*>(stage + 2 * PLANE + src);
    }
  }
}

// Host side: the kernels take more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int NC, bool TRANS>
int launch_gmm_wgmma(const CUtensorMap& map_lhs, const CUtensorMap& map_rhs,
                     const void* tile_experts, const void* valid_tiles,
                     void* out, int M, int K, int N, int bm, void* stream) {
  using S = HgShape<NC>;
  const auto kernel = gmm_wgmma_kernel<NC, TRANS>;
  cudaError_t err = allow_smem(kernel, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_row = M / S::BM;
  const int n_col = (N + HG_BN - 1) / HG_BN;
  kernel<<<n_row * n_col, S::THREADS, S::SMEM,
           static_cast<cudaStream_t>(stream)>>>(
      map_lhs, map_rhs, static_cast<const int32_t*>(tile_experts),
      static_cast<const int32_t*>(valid_tiles),
      static_cast<__nv_bfloat16*>(out), K, N, bm, n_row, n_col);
  return static_cast<int>(cudaGetLastError());
}

template <int NC>
int launch_gmm_swiglu_wgmma(const CUtensorMap& map_lhs,
                            const CUtensorMap& map_g, const CUtensorMap& map_u,
                            const void* tile_experts, void* h, void* gate,
                            void* up, int M, int K, int N, int bm,
                            void* stream) {
  using S = HgShape<NC>;
  const auto kernel = gmm_swiglu_wgmma_kernel<NC>;
  cudaError_t err = allow_smem(kernel, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_row = M / S::BM;
  const int n_col = (N + SW_BN - 1) / SW_BN;
  kernel<<<n_row * n_col, S::THREADS, S::SMEM,
           static_cast<cudaStream_t>(stream)>>>(
      map_lhs, map_g, map_u, static_cast<const int32_t*>(tile_experts),
      static_cast<__nv_bfloat16*>(h), static_cast<__nv_bfloat16*>(gate),
      static_cast<__nv_bfloat16*>(up), K, N, bm, n_row, n_col);
  return static_cast<int>(cudaGetLastError());
}

template <int NR, bool SWIGLU, bool TRANS>
int launch_swapab(const CUtensorMap& map_lhs, const CUtensorMap& map_w0,
                  const CUtensorMap& map_w1, const void* tile_experts,
                  const void* valid_tiles, void* out, void* gate, void* up,
                  int M, int K, int N, int bm, void* stream) {
  using S = SaShape<NR, SWIGLU>;
  const auto kernel = gmm_swapab_kernel<NR, SWIGLU, TRANS>;
  cudaError_t err = allow_smem(kernel, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = M / bm;
  const int n_col = (N + SA_BN - 1) / SA_BN;
  kernel<<<n_tiles * n_col, SA_THREADS, S::SMEM,
           static_cast<cudaStream_t>(stream)>>>(
      map_lhs, map_w0, map_w1, static_cast<const int32_t*>(tile_experts),
      static_cast<const int32_t*>(valid_tiles),
      static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(gate),
      static_cast<__nv_bfloat16*>(up), K, N, bm, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// One tile a block: wgmma's N is the tile's box, max(8, bm) rows
// (gmm_swiglu at every bm < 64: its 32 KB of weights a stage leave no room
// for 64 lhs rows at 2 blocks an SM).
template <bool SWIGLU, bool TRANS>
int launch_swapab_tiles(const CUtensorMap& map_lhs, const CUtensorMap& map_w0,
                        const CUtensorMap& map_w1, const void* tile_experts,
                        const void* valid_tiles, void* out, void* gate,
                        void* up, int M, int K, int N, int bm, void* stream) {
  switch (sa_box_rows(bm)) {
    case 8:
      return launch_swapab<8, SWIGLU, TRANS>(map_lhs, map_w0, map_w1,
                                             tile_experts, valid_tiles, out,
                                             gate, up, M, K, N, bm, stream);
    case 16:
      return launch_swapab<16, SWIGLU, TRANS>(map_lhs, map_w0, map_w1,
                                              tile_experts, valid_tiles, out,
                                              gate, up, M, K, N, bm, stream);
    default:
      return launch_swapab<32, SWIGLU, TRANS>(map_lhs, map_w0, map_w1,
                                              tile_experts, valid_tiles, out,
                                              gate, up, M, K, N, bm, stream);
  }
}

// gmm: one 8-row box a block below bm 8; from bm 8 wgmma's N is 64 and a
// block takes up to 64 / bm consecutive tiles of one expert's run.
template <bool TRANS>
int launch_swapab_gmm(const CUtensorMap& map_lhs, const CUtensorMap& map_rhs,
                      const void* tile_experts, const void* valid_tiles,
                      void* out, int M, int K, int N, int bm, void* stream) {
  if (bm < 8)
    return launch_swapab<8, false, TRANS>(map_lhs, map_rhs, map_rhs,
                                          tile_experts, valid_tiles, out,
                                          nullptr, nullptr, M, K, N, bm,
                                          stream);
  return launch_swapab<64, false, TRANS>(map_lhs, map_rhs, map_rhs,
                                         tile_experts, valid_tiles, out,
                                         nullptr, nullptr, M, K, N, bm,
                                         stream);
}

// A [rows, cols] row-major bf16 matrix (or `depth` of them back to back) as
// a TMA map with a box of {64, box_rows} (x 1).
bool bf16_map(CUtensorMap* map, const void* base, int rows, int cols,
              int box_rows, int depth = 0) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * rows * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  return hopper::make_map(map, base, depth > 0 ? 3 : 2, dims, strides, box);
}

}  // namespace

extern "C" {

// out[r] = lhs[r] @ rhs[e] (rhs [E, K, N]) or lhs[r] @ rhs[e]^T (rhs
// [E, N, K], transpose_rhs != 0), e = tile_experts[r / bm]; tiles at or
// past valid_tiles[0] write zeros when valid_tiles is not null;
// n_experts = rhs.shape[0].  The swap-AB design, bm < 64
// (kctpu_gmm_wgmma takes every other bm).  Returns a cudaError_t code.
int kctpu_gmm_swapab(const void* lhs, const void* rhs,
                     const void* tile_experts, const void* valid_tiles,
                     void* out, int M, int K, int N, int bm, int n_experts,
                     int transpose_rhs, void* stream) {
  if (bad_args(M, K, N, bm) || bm >= WGMMA_MIN_BM || n_experts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hopper::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_lhs, map_rhs;
  const bool ok = bf16_map(&map_lhs, lhs, M, K, sa_box_rows(bm)) &&
                  (transpose_rhs ? bf16_map(&map_rhs, rhs, N, K, 64, n_experts)
                                 : bf16_map(&map_rhs, rhs, K, N, 64, n_experts));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return transpose_rhs
             ? launch_swapab_gmm<true>(map_lhs, map_rhs, tile_experts,
                                       valid_tiles, out, M, K, N, bm, stream)
             : launch_swapab_gmm<false>(map_lhs, map_rhs, tile_experts,
                                        valid_tiles, out, M, K, N, bm,
                                        stream);
}

// The same product, wgmma design, bm >= 64; n_experts = rhs.shape[0].
int kctpu_gmm_wgmma(const void* lhs, const void* rhs, const void* tile_experts,
                    const void* valid_tiles, void* out, int M, int K, int N,
                    int bm, int n_experts, int transpose_rhs, void* stream) {
  if (bad_args(M, K, N, bm) || bm < WGMMA_MIN_BM || n_experts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hopper::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  const bool wide = bm >= 128;  // two consumer warpgroups, 128-row tiles
  CUtensorMap map_lhs, map_rhs;
  const bool ok =
      bf16_map(&map_lhs, lhs, M, K, wide ? 128 : 64) &&
      (transpose_rhs ? bf16_map(&map_rhs, rhs, N, K, HG_BN, n_experts)
                     : bf16_map(&map_rhs, rhs, K, N, 64, n_experts));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (wide)
    return transpose_rhs
               ? launch_gmm_wgmma<2, true>(map_lhs, map_rhs, tile_experts,
                                           valid_tiles, out, M, K, N, bm,
                                           stream)
               : launch_gmm_wgmma<2, false>(map_lhs, map_rhs, tile_experts,
                                            valid_tiles, out, M, K, N, bm,
                                            stream);
  return transpose_rhs
             ? launch_gmm_wgmma<1, true>(map_lhs, map_rhs, tile_experts,
                                         valid_tiles, out, M, K, N, bm, stream)
             : launch_gmm_wgmma<1, false>(map_lhs, map_rhs, tile_experts,
                                          valid_tiles, out, M, K, N, bm,
                                          stream);
}

// h[r] = silu(lhs[r] @ rhs_g[e]) * (lhs[r] @ rhs_u[e]), e = tile_experts[r / bm];
// gate and up (the two products, rounded once) too where their pointers are
// not null; n_experts = rhs_g.shape[0].  The swap-AB design, bm < 64
// (kctpu_gmm_swiglu_wgmma takes every other bm).
int kctpu_gmm_swiglu_swapab(const void* lhs, const void* rhs_g,
                            const void* rhs_u, const void* tile_experts,
                            void* h, void* gate, void* up, int M, int K, int N,
                            int bm, int n_experts, void* stream) {
  if (bad_args(M, K, N, bm) || bm >= WGMMA_MIN_BM || n_experts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hopper::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_lhs, map_g, map_u;
  if (!bf16_map(&map_lhs, lhs, M, K, sa_box_rows(bm)) ||
      !bf16_map(&map_g, rhs_g, K, N, 64, n_experts) ||
      !bf16_map(&map_u, rhs_u, K, N, 64, n_experts))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_swapab_tiles<true, false>(map_lhs, map_g, map_u, tile_experts,
                                          nullptr, h, gate, up, M, K, N, bm,
                                          stream);
}

// The same fused SwiGLU, wgmma design, bm >= 64; n_experts = rhs_g.shape[0].
int kctpu_gmm_swiglu_wgmma(const void* lhs, const void* rhs_g,
                           const void* rhs_u, const void* tile_experts,
                           void* h, void* gate, void* up, int M, int K, int N,
                           int bm, int n_experts, void* stream) {
  if (bad_args(M, K, N, bm) || bm < WGMMA_MIN_BM || n_experts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hopper::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  const bool wide = bm >= 128;  // two consumer warpgroups, 128-row tiles
  CUtensorMap map_lhs, map_g, map_u;
  if (!bf16_map(&map_lhs, lhs, M, K, wide ? 128 : 64) ||
      !bf16_map(&map_g, rhs_g, K, N, 64, n_experts) ||
      !bf16_map(&map_u, rhs_u, K, N, 64, n_experts))
    return static_cast<int>(cudaErrorInvalidValue);
  return wide ? launch_gmm_swiglu_wgmma<2>(map_lhs, map_g, map_u, tile_experts,
                                           h, gate, up, M, K, N, bm, stream)
              : launch_gmm_swiglu_wgmma<1>(map_lhs, map_g, map_u, tile_experts,
                                           h, gate, up, M, K, N, bm, stream);
}

// out[e] = sum over the tiles i of expert e (i < valid_tiles[0] when
// valid_tiles is not null) of lhs_i^T @ dout_i: lhs [M, K], dout [M, N],
// out [E, K, N]; an expert with no counted tile gets zeros.  The WMMA
// design, bm < 64 (kctpu_tgmm_wgmma takes every other bm).
int kctpu_tgmm(const void* lhs, const void* dout, const void* tile_experts,
               const void* valid_tiles, void* out, int M, int K, int N, int bm,
               int n_experts, void* stream) {
  constexpr int BKO = 64, BN = 128, WARPS_M = 2, WARPS_N = 4;
  if (bad_args(M, K, N, bm) || bm >= WGMMA_MIN_BM || n_experts <= 0 ||
      n_experts > 65535)
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

// The same weight gradient, wgmma design, bm >= 64.
int kctpu_tgmm_wgmma(const void* lhs, const void* dout,
                     const void* tile_experts, const void* valid_tiles,
                     void* out, int M, int K, int N, int bm, int n_experts,
                     void* stream) {
  using S = HgShape<2>;
  if (bad_args(M, K, N, bm) || bm < WGMMA_MIN_BM || n_experts <= 0 ||
      n_experts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hopper::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_lhs, map_dout;
  if (!bf16_map(&map_lhs, lhs, M, K, 64) ||
      !bf16_map(&map_dout, dout, M, N, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(tgmm_wgmma_kernel, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_k = (K + S::BM - 1) / S::BM;
  const int n_n = (N + HG_BN - 1) / HG_BN;
  tgmm_wgmma_kernel<<<dim3(n_k * n_n, n_experts), S::THREADS, S::SMEM,
                      static_cast<cudaStream_t>(stream)>>>(
      map_lhs, map_dout, static_cast<const int32_t*>(tile_experts),
      static_cast<const int32_t*>(valid_tiles),
      static_cast<__nv_bfloat16*>(out), M / bm, K, N, bm, n_k, n_n);
  return static_cast<int>(cudaGetLastError());
}

const char* kctpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
