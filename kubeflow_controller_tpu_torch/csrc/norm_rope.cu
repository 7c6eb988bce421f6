// RMSNorm and rotate-half RoPE over the rows of a bf16 tensor on Hopper
// (sm_90a), forward and backward, each as one pass: the norm, the rotation
// or the norm then the rotation (ops/norm_rope.py; models/llama.py's
// rmsnorm and apply_rope).
//
// Replaces no Pallas kernel: the JAX package writes the norm and the
// rotation in jnp (kubeflow_controller_tpu/models/llama.py, rmsnorm and
// apply_rope) and XLA fuses each into one pass.  Eager PyTorch ran them as
// about 8 (norm) and 7 (rotation) elementwise launches forward and twice
// as many backward, each reading and writing the whole tensor, partly in
// f32, with f32 intermediates saved for the backward.
//
// What it computes.  A row is the last dim, of width D.  Forward, with the
// norm (scale s, bf16 [D]):
//   rstd = rsqrt(sum(x^2) * (1/D) + eps)                 (f32; torch's
//                                                         mean, 1/D on the
//                                                         host)
//   y    = bf16(float(bf16(x * rstd)) * float(s))        (the plain code's
//                                                         two roundings)
// with the rotation (cos, sin: f32 [T, D]; x [B, T, H, D], so the row
// r = (b T + t) H + h takes position t = (r / H) mod T), on y (or x):
//   z[i]       = bf16(y[i] cos[t, i]         - y[i + D/2] sin[t, i])
//   z[i + D/2] = bf16(y[i + D/2] cos[t, i + D/2] + y[i] sin[t, i + D/2])
// each product and sum rounded once in f32 (no fused multiply-add), as
// the plain code's separate multiplies and add round them.  The outputs
// are the bf16 result and rstd (f32, one a row, with the norm).  Only the
// order of the mean's sum differs from the plain composition; the
// rotation alone equals it bit for bit.
// Backward, from x, rstd, s, dz and the tables:
//   g  = the rotation of dz by -theta (or dz), in f32
//   x^ = x * rstd;  gs = g * s
//   dx = rstd * (gs - x^ * mean(gs * x^))                (bf16, once)
//   ds = sum over rows of g * float(bf16(x^))            (f32, then bf16)
// The rotation alone's dx equals autograd's of the plain code bit for bit.
// ds is summed per block in a fixed row order into f32 partials [blocks,
// D], then over the blocks in a fixed order by a second small launch: no
// atomics, so dx and ds are the same bits from run to run.
//
// What bounds it on this card: bytes.  A few flops a byte, far below the
// ~295 flop/B ridge.  Forward reads x once and writes the result once
// (bf16) plus 4 B a row of rstd; backward reads x, dz and rstd once and
// writes dx once, plus the partials (blocks x D f32, written and read
// once).  The tables ([T, D] f32) stay in L2.
//
// The design: every value stays in registers, in f32, between one 16-byte
// load and one 16-byte store of each bf16 vector.  A row is owned by a
// group of G threads (G a power of two, at most a block): a thread holds
// V units, a unit being one 8-element vector, or with the rotation a
// vector of the first half and its partner D/2 further on, so the
// rotate-half needs no shuffle.  Neighbouring threads of a group read
// neighbouring 16 B.  A 128-wide head row (8 units with the rotation, 16
// without) is 8 or 16 threads, so a block of 256 threads covers 32 or 16
// rows, whole tokens of the heads of one position, whose table rows come
// from L1 after the first head; a hidden row of 2048 or 4096 is the whole
// block, one or two vectors a thread.  The row's sums are warp shuffles,
// then, above 32 threads a row, one exchange through shared memory in a
// fixed order.  Blocks stride over the rows, at most a few waves of them,
// so the backward's partials stay small.  The mapping (G and the block
// count) is chosen by the wrapper from D alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;                    // bf16 in 16 bytes

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void unpack(uint4 u, float (&f)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void as_array(float4 a, float (&f)[4]) {
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

// Rotates one unit's pair (lo at element i, hi at i + D/2) by the table
// rows at cos_p and sin_p (element i's), or with BACK by their transpose
// (-theta), four elements at a time, each product and sum rounded once.
template <bool BACK>
__device__ __forceinline__ void rotate(float (&lo)[VEC], float (&hi)[VEC],
                                       const float* cos_p,
                                       const float* sin_p, int half) {
#pragma unroll
  for (int j = 0; j < VEC; j += 4) {
    float c0[4], c1[4], s0[4], s1[4];
    as_array(__ldg(reinterpret_cast<const float4*>(cos_p + j)), c0);
    as_array(__ldg(reinterpret_cast<const float4*>(cos_p + half + j)), c1);
    as_array(__ldg(reinterpret_cast<const float4*>(sin_p + j)), s0);
    as_array(__ldg(reinterpret_cast<const float4*>(sin_p + half + j)), s1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = lo[j + i], b = hi[j + i];
      if (BACK) {
        lo[j + i] = __fadd_rn(__fmul_rn(a, c0[i]), __fmul_rn(b, s1[i]));
        hi[j + i] = __fsub_rn(__fmul_rn(b, c1[i]), __fmul_rn(a, s0[i]));
      } else {
        lo[j + i] = __fsub_rn(__fmul_rn(a, c0[i]), __fmul_rn(b, s0[i]));
        hi[j + i] = __fadd_rn(__fmul_rn(b, c1[i]), __fmul_rn(a, s1[i]));
      }
    }
  }
}

// The sum of v over the g threads of a row, the same bits in every one of
// them.  Every thread of the block calls it (it may synchronise the block).
__device__ __forceinline__ float row_sum(float v, int g, float* red) {
  const int w = g < 32 ? g : 32;
  for (int o = w >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  if (g > 32) {
    __syncthreads();                       // red's last readers are done
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    const int first = (threadIdx.x / g) * (g >> 5);
    v = 0.f;
    for (int i = 0; i < (g >> 5); ++i) v += red[first + i];
  }
  return v;
}

// The row's position in the tables: x is [B, T, H, D].  Rows stay below
// 2**31 (the wrapper's rule), so the division is a 32-bit one, inline.
__device__ __forceinline__ long long position(long long row, int heads,
                                              int seq) {
  return (static_cast<unsigned>(row) / static_cast<unsigned>(heads)) %
         static_cast<unsigned>(seq);
}

// Both kernels declare one block an SM as their floor: without it ptxas
// spills a register in the norm-and-rotation instantiations (4 bytes at
// 48-128 registers), which chip_smoke.py's build phase refuses.
template <bool NORM, bool ROPE, int V>
__global__ void __launch_bounds__(THREADS, 1) norm_rope_fwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ scale,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    bf16* __restrict__ y, float* __restrict__ rstd, long long rows, int d,
    float inv_d, int g, int heads, int seq, float eps) {
  constexpr int P = ROPE ? 2 : 1;          // vectors a unit
  __shared__ float red[THREADS / 32];
  const int units = d / (VEC * P);
  const int half = d / 2;
  const int lane = threadIdx.x & (g - 1);
  const int groups = THREADS / g;
  const long long step = static_cast<long long>(gridDim.x) * groups;
  for (long long base = static_cast<long long>(blockIdx.x) * groups;
       base < rows; base += step) {
    const long long row = base + threadIdx.x / g;
    const bool live = row < rows;
    const long long off = row * d;
    uint4 raw[V][P];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int u = lane + k * g;
#pragma unroll
      for (int p = 0; p < P; ++p)
        raw[k][p] = live && u < units ? load16(x + off + u * VEC + p * half)
                                      : make_uint4(0, 0, 0, 0);
    }
    float r = 0.f;
    if (NORM) {
      float ss = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float f[VEC];
          unpack(raw[k][p], f);
#pragma unroll
          for (int i = 0; i < VEC; ++i) ss = fmaf(f[i], f[i], ss);
        }
      ss = row_sum(ss, g, red);
      r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
      if (live && lane == 0) rstd[row] = r;
    }
    if (!live) continue;
    const long long t = ROPE ? position(row, heads, seq) * d : 0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int u = lane + k * g;
      if (u >= units) break;
      float v[P][VEC];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        unpack(raw[k][p], v[p]);
        if (NORM) {
          float s[VEC];
          unpack(load16(scale + u * VEC + p * half), s);
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            v[p][i] = to_bf16(__fmul_rn(to_bf16(__fmul_rn(v[p][i], r)),
                                        s[i]));
        }
      }
      if (ROPE)
        rotate<false>(v[0], v[P - 1], cos_t + t + u * VEC,
                      sin_t + t + u * VEC, half);
#pragma unroll
      for (int p = 0; p < P; ++p)
        *reinterpret_cast<uint4*>(y + off + u * VEC + p * half) =
            pack(v[p]);
    }
  }
}

template <bool NORM, bool ROPE, int V>
__global__ void __launch_bounds__(THREADS, 1) norm_rope_bwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ scale,
    const float* __restrict__ rstd, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const bf16* __restrict__ dy,
    bf16* __restrict__ dx, float* __restrict__ partial, long long rows,
    int d, float inv_d, int g, int heads, int seq) {
  constexpr int P = ROPE ? 2 : 1;
  __shared__ float red[THREADS / 32];
  extern __shared__ float sds[];           // [groups, d] when groups > 1
  const int units = d / (VEC * P);
  const int half = d / 2;
  const int lane = threadIdx.x & (g - 1);
  const int groups = THREADS / g;
  const long long step = static_cast<long long>(gridDim.x) * groups;
  float acc[V][P][VEC];                    // this thread's share of ds
#pragma unroll
  for (int k = 0; k < V; ++k)
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[k][p][i] = 0.f;

  for (long long base = static_cast<long long>(blockIdx.x) * groups;
       base < rows; base += step) {
    const long long row = base + threadIdx.x / g;
    const bool live = row < rows;
    const long long off = row * d;
    const long long t = ROPE && live ? position(row, heads, seq) * d : 0;
    const float r = NORM && live ? rstd[row] : 0.f;
    float gv[V][P][VEC];                   // dz rotated back, f32
    uint4 xr[V][P];
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int u = lane + k * g;
      const bool here = live && u < units;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        unpack(here ? load16(dy + off + u * VEC + p * half)
                    : make_uint4(0, 0, 0, 0), gv[k][p]);
        xr[k][p] = NORM && here ? load16(x + off + u * VEC + p * half)
                                : make_uint4(0, 0, 0, 0);
      }
      if (ROPE && here)
        rotate<true>(gv[k][0], gv[k][P - 1], cos_t + t + u * VEC,
                     sin_t + t + u * VEC, half);
      if (NORM && here) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float xh[VEC], s[VEC];
          unpack(xr[k][p], xh);
          unpack(load16(scale + u * VEC + p * half), s);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            xh[i] = __fmul_rn(xh[i], r);
            acc[k][p][i] = fmaf(gv[k][p][i], to_bf16(xh[i]), acc[k][p][i]);
            dot = fmaf(__fmul_rn(gv[k][p][i], s[i]), xh[i], dot);
          }
        }
      }
    }
    float m = 0.f;
    if (NORM) m = __fmul_rn(row_sum(dot, g, red), inv_d);
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int u = lane + k * g;
      if (u >= units) break;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float o[VEC];
        if (NORM) {
          float xh[VEC], s[VEC];
          unpack(xr[k][p], xh);
          unpack(load16(scale + u * VEC + p * half), s);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float xi = __fmul_rn(xh[i], r);
            o[i] = r * (gv[k][p][i] * s[i] - xi * m);
          }
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) o[i] = gv[k][p][i];
        }
        *reinterpret_cast<uint4*>(dx + off + u * VEC + p * half) = pack(o);
      }
    }
  }
  if (!NORM) return;
  // This block's ds: each row group's share, summed over the groups in
  // order through shared memory (one group a block: written directly).
  float* out = partial + static_cast<long long>(blockIdx.x) * d;
  float* mine = groups > 1 ? sds + (threadIdx.x / g) * d : out;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int u = lane + k * g;
    if (u >= units) break;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        mine[u * VEC + p * half + i] = acc[k][p][i];
  }
  if (groups == 1) return;
  __syncthreads();
  for (int e = threadIdx.x; e < d; e += THREADS) {
    float s = 0.f;
    for (int q = 0; q < groups; ++q) s += sds[q * d + e];
    out[e] = s;
  }
}

// ds[j] = bf16(sum over b of partial[b, j]), b in a fixed order: a block
// sums 32 columns, each of its 8 warps every 8th block's partial, then
// one warp adds the 8 in order.
__global__ void __launch_bounds__(THREADS) norm_scale_grad_kernel(
    const float* __restrict__ partial, int blocks, int d,
    bf16* __restrict__ ds) {
  __shared__ float part[THREADS / 32][33];
  const int col = blockIdx.x * 32 + (threadIdx.x & 31);
  const int slice = threadIdx.x >> 5;
  float s = 0.f;
  if (col < d)
    for (int b = slice; b < blocks; b += THREADS / 32)
      s += partial[static_cast<long long>(b) * d + col];
  part[slice][threadIdx.x & 31] = s;
  __syncthreads();
  if (slice == 0 && col < d) {
    float t = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) t += part[i][threadIdx.x];
    ds[col] = __float2bfloat16_rn(t);
  }
}

// Units a thread holds: 1, 2 or 4, else 0 (a mapping the kernels do not
// take).  g must be a power of two up to a block.
int units_per_thread(int d, int g, bool rope) {
  const int per = VEC * (rope ? 2 : 1);
  if (g < 1 || g > THREADS || (g & (g - 1)) || d < per || d % per)
    return 0;
  const int v = (d / per + g - 1) / g;
  return v == 1 || v == 2 || v == 4 ? v : v == 3 ? 4 : 0;
}

template <bool NORM, bool ROPE>
cudaError_t launch_fwd(int v, int blocks, cudaStream_t s, const bf16* x,
                       const bf16* scale, const float* cos_t,
                       const float* sin_t, bf16* y, float* rstd,
                       long long rows, int d, int g, int heads, int seq,
                       float eps) {
  switch (v) {
    case 1: norm_rope_fwd_kernel<NORM, ROPE, 1><<<blocks, THREADS, 0, s>>>(
        x, scale, cos_t, sin_t, y, rstd, rows, d, 1.f / d, g, heads, seq,
        eps); break;
    case 2: norm_rope_fwd_kernel<NORM, ROPE, 2><<<blocks, THREADS, 0, s>>>(
        x, scale, cos_t, sin_t, y, rstd, rows, d, 1.f / d, g, heads, seq,
        eps); break;
    default: norm_rope_fwd_kernel<NORM, ROPE, 4><<<blocks, THREADS, 0, s>>>(
        x, scale, cos_t, sin_t, y, rstd, rows, d, 1.f / d, g, heads, seq,
        eps);
  }
  return cudaGetLastError();
}

template <bool NORM, bool ROPE>
cudaError_t launch_bwd(int v, int blocks, size_t smem, cudaStream_t s,
                       const bf16* x, const bf16* scale, const float* rstd,
                       const float* cos_t, const float* sin_t, const bf16* dy,
                       bf16* dx, float* partial, long long rows, int d, int g,
                       int heads, int seq) {
  switch (v) {
    case 1: norm_rope_bwd_kernel<NORM, ROPE, 1><<<blocks, THREADS, smem, s>>>(
        x, scale, rstd, cos_t, sin_t, dy, dx, partial, rows, d, 1.f / d, g,
        heads,
        seq); break;
    case 2: norm_rope_bwd_kernel<NORM, ROPE, 2><<<blocks, THREADS, smem, s>>>(
        x, scale, rstd, cos_t, sin_t, dy, dx, partial, rows, d, 1.f / d, g,
        heads,
        seq); break;
    default: norm_rope_bwd_kernel<NORM, ROPE, 4><<<blocks, THREADS, smem,
                                                   s>>>(
        x, scale, rstd, cos_t, sin_t, dy, dx, partial, rows, d, 1.f / d, g,
        heads,
        seq);
  }
  return cudaGetLastError();
}

bool bad_shape(long long rows, int d, int g, int blocks, bool rope,
               int heads, int seq) {
  return rows < 1 || rows >= (1LL << 31) || blocks < 1 || units_per_thread(d, g, rope) == 0 ||
         (rope && (heads < 1 || seq < 1));
}

}  // namespace

extern "C" {

// The forward over `rows` rows of width d: the norm when scale (bf16 [d])
// is not null, the rotation when cos and sin (f32 [seq, d]) are not null,
// x being [B, seq, heads, d].  y (bf16, x's shape) is written, and rstd
// (f32 [rows]) with the norm.  g threads a row, `blocks` blocks striding
// over the rows.  Returns a cudaError_t code.
int kctpu_norm_rope_fwd(const void* x, const void* scale, const void* cos_t,
                        const void* sin_t, void* y, void* rstd,
                        long long rows, int d, int g, int blocks, int heads,
                        int seq, float eps, void* stream) {
  const bool norm = scale != nullptr, rope = cos_t != nullptr;
  if (x == nullptr || y == nullptr || (!norm && !rope) ||
      (norm && rstd == nullptr) || (rope && sin_t == nullptr) ||
      bad_shape(rows, d, g, blocks, rope, heads, seq))
    return static_cast<int>(cudaErrorInvalidValue);
  const int v = units_per_thread(d, g, rope);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* sb = static_cast<const bf16*>(scale);
  const float* c = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  bf16* yb = static_cast<bf16*>(y);
  float* rs = static_cast<float*>(rstd);
  cudaError_t err;
  if (norm && rope)
    err = launch_fwd<true, true>(v, blocks, s, xb, sb, c, sn, yb, rs, rows,
                                 d, g, heads, seq, eps);
  else if (norm)
    err = launch_fwd<true, false>(v, blocks, s, xb, sb, c, sn, yb, rs, rows,
                                  d, g, heads, seq, eps);
  else
    err = launch_fwd<false, true>(v, blocks, s, xb, sb, c, sn, yb, rs, rows,
                                  d, g, heads, seq, eps);
  return static_cast<int>(err);
}

// The backward of kctpu_norm_rope_fwd from dy (bf16, x's shape): dx (bf16)
// is written; with the norm (scale and rstd not null), partial (f32
// [blocks, d], scratch) and dscale (bf16 [d]) too.  The same g and
// `blocks` rule as the forward.  Returns a cudaError_t code.
int kctpu_norm_rope_bwd(const void* x, const void* scale, const void* rstd,
                        const void* cos_t, const void* sin_t, const void* dy,
                        void* dx, void* partial, void* dscale,
                        long long rows, int d, int g, int blocks, int heads,
                        int seq, void* stream) {
  const bool norm = scale != nullptr, rope = cos_t != nullptr;
  if (dy == nullptr || dx == nullptr || (!norm && !rope) ||
      (norm && (x == nullptr || rstd == nullptr || partial == nullptr ||
                dscale == nullptr)) ||
      (rope && sin_t == nullptr) ||
      bad_shape(rows, d, g, blocks, rope, heads, seq))
    return static_cast<int>(cudaErrorInvalidValue);
  const int v = units_per_thread(d, g, rope);
  const int groups = THREADS / g;
  const size_t smem = norm && groups > 1
                          ? static_cast<size_t>(groups) * d * sizeof(float)
                          : 0;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* sb = static_cast<const bf16*>(scale);
  const float* rs = static_cast<const float*>(rstd);
  const float* c = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  const bf16* dyb = static_cast<const bf16*>(dy);
  bf16* dxb = static_cast<bf16*>(dx);
  float* part = static_cast<float*>(partial);
  cudaError_t err;
  if (norm && rope)
    err = launch_bwd<true, true>(v, blocks, smem, s, xb, sb, rs, c, sn, dyb,
                                 dxb, part, rows, d, g, heads, seq);
  else if (norm)
    err = launch_bwd<true, false>(v, blocks, smem, s, xb, sb, rs, c, sn, dyb,
                                  dxb, part, rows, d, g, heads, seq);
  else
    err = launch_bwd<false, true>(v, blocks, smem, s, xb, sb, rs, c, sn, dyb,
                                  dxb, part, rows, d, g, heads, seq);
  if (err != cudaSuccess || !norm) return static_cast<int>(err);
  norm_scale_grad_kernel<<<(d + 31) / 32, THREADS, 0, s>>>(
      part, blocks, d, static_cast<bf16*>(dscale));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
