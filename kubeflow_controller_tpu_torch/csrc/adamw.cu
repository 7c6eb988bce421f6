// AdamW with the global-norm clip's scale folded in, on Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves optax's
// clip_by_global_norm + adamw update to XLA, which fuses it into one
// elementwise pass (kubeflow_controller_tpu/workloads/trainer.py,
// default_optimizer).  On the port it replaces torch.optim.AdamW's foreach
// chain (eight passes over the state: the decay, lerp_ on m, mul_ and
// addcmul_ on v, sqrt, div_, add_, addcdiv_; ~80 B moved a f32 parameter,
// plus an f32 copy of every parameter for sqrt(v)) and the clip's two
// in-place rescales of every gradient (workloads/trainer.py,
// Optimizer._clip: 16 B more).  The clip's norm stays a pass of its own:
// it must be known before any element is updated.
//
// The arithmetic, per element, in f32 registers whatever the storage type,
// in the order of torch's _multi_tensor_adam for AdamW:
//   p  = p * (1 - lr * wd)
//   g' = (g / div) * mul                  the clip's pair; (1, 1) unclipped
//   m  = lerp(m, g', 1 - b1)              m + w (g' - m) for w < 0.5
//   v  = v * b2 + (1 - b2) * (g' * g')
//   p  = p - (lr / bc1) * (m / (sqrt(v) / sqrt(bc2) + eps))
// with IEEE division and square root (no fast-math flag).  The scalars are
// formed in double and rounded to f32, as torch's foreach ops take them;
// bc1 and bc2 come from the host's step count, or from the device's step
// tensor (a capturable group, whose step a CUDA graph advances).  The
// compiler may contract a product and a sum into one fma where torch's
// passes round in between, so the result agrees with the foreach chain to
// f32 rounding, not bit for bit.
//
// What bounds it on this card: bytes.  ~15 flops an element against 28 B
// (f32 p, g, m, v read; p, m, v written): 0.5 flop/B, far below the ~20
// flop/B where the card's f32 pipes would bind.  At 3.35 TB/s, 28 B a
// parameter is 26.4 ms for Mixtral-8x7B's 2-layer stage (3.164 B f32
// parameters) and 16.8 ms for Mistral-7B's 8-layer stage (2.013 B).
//
// What the design does about it: every byte moves once.  A grid-stride
// loop over 16-byte vectors (4 f32 or 8 bf16) issues the four loads of a
// vector together, so each thread keeps 64 B in flight; 8 blocks of 256
// threads an SM keep ~128 KB in flight an SM, well above what the card's
// latency times its bandwidth asks (~20 KB).  No shared memory.  A scalar
// loop takes the tail below one vector, and the whole tensor when a
// pointer is not 16-byte aligned.  One launch a parameter tensor; nothing
// is allocated and nothing waits for the host, so a CUDA graph can hold
// the step: the clip's pair and a capturable group's step are read from
// device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

// The f32 scalars of one launch.
struct Coef {
  float decay;     // 1 - lr * wd
  float w1;        // 1 - b1, the lerp weight
  float b2;
  float w2;        // 1 - b2
  float eps;
  float neg_step;  // -(lr / bc1)
  float bc2_sqrt;  // sqrt(bc2)
};

// What the host hands the kernel: the scalars it formed, and for a
// capturable group what the device forms them from.
struct Args {
  Coef c;
  double lr, beta1, beta2;
  const float* step;  // the device step count, or null (host step)
  const float* div;   // the clip's pair, or null (unclipped)
  const float* mul;
};

template <typename T, int N>
struct alignas(sizeof(T) * N) Lanes {
  T e[N];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void update(const Coef& c, float div, float mul,
                                       float& p, float g, float& m,
                                       float& v) {
  p = p * c.decay;
  g = g / div * mul;
  m = c.w1 < 0.5f ? m + c.w1 * (g - m) : g - (g - m) * (1.0f - c.w1);
  v = v * c.b2 + c.w2 * (g * g);
  const float denom = sqrtf(v) / c.bc2_sqrt + c.eps;
  p = p + c.neg_step * (m / denom);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    adamw_kernel(T* __restrict__ p, const T* __restrict__ g,
                 T* __restrict__ m, T* __restrict__ v, int64_t n, int vec,
                 Args a) {
  Coef c = a.c;
  if (a.step != nullptr) {
    const double t = static_cast<double>(*a.step);
    c.neg_step = static_cast<float>(-(a.lr / (1.0 - pow(a.beta1, t))));
    c.bc2_sqrt = static_cast<float>(pow(1.0 - pow(a.beta2, t), 0.5));
  }
  const float div = a.div != nullptr ? *a.div : 1.0f;
  const float mul = a.mul != nullptr ? *a.mul : 1.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int64_t done = 0;
  if (vec) {
    constexpr int N = 16 / sizeof(T);
    using L = Lanes<T, N>;
    const int64_t nv = n / N;
    for (int64_t i = tid; i < nv; i += stride) {
      L lp = reinterpret_cast<const L*>(p)[i];
      const L lg = reinterpret_cast<const L*>(g)[i];
      L lm = reinterpret_cast<const L*>(m)[i];
      L lv = reinterpret_cast<const L*>(v)[i];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float pf = to_f32(lp.e[k]), mf = to_f32(lm.e[k]),
              vf = to_f32(lv.e[k]);
        update(c, div, mul, pf, to_f32(lg.e[k]), mf, vf);
        lp.e[k] = from_f32<T>(pf);
        lm.e[k] = from_f32<T>(mf);
        lv.e[k] = from_f32<T>(vf);
      }
      reinterpret_cast<L*>(p)[i] = lp;
      reinterpret_cast<L*>(m)[i] = lm;
      reinterpret_cast<L*>(v)[i] = lv;
    }
    done = nv * N;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    float pf = to_f32(p[i]), mf = to_f32(m[i]), vf = to_f32(v[i]);
    update(c, div, mul, pf, to_f32(g[i]), mf, vf);
    p[i] = from_f32<T>(pf);
    m[i] = from_f32<T>(mf);
    v[i] = from_f32<T>(vf);
  }
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <typename T>
int launch(void* p, const void* g, void* m, void* v, int64_t n,
           const Args& a, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int vec = aligned16(p) && aligned16(g) && aligned16(m) &&
                  aligned16(v);
  const int64_t work = vec ? (n + N - 1) / N : n;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t most = static_cast<int64_t>(sms) * BLOCKS_PER_SM;
  const int64_t want = (work + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < most ? want : most);
  adamw_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<T*>(p), static_cast<const T*>(g), static_cast<T*>(m),
      static_cast<T*>(v), n, vec, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One AdamW step of one parameter tensor of n elements, in place: p, m, v
// updated from g (all f32, or all bf16 when bf16 != 0).  The bias
// corrections come from `step` (the host's count after this step), or from
// *device_step when it is not null.  g is scaled by *div then *mul when
// they are not null (the clip).  Returns a cudaError_t code.
int kctpu_adamw(void* p, const void* g, void* m, void* v, long long n,
                int bf16, double lr, double beta1, double beta2, double eps,
                double weight_decay, double step, const void* device_step,
                const void* div, const void* mul, void* stream) {
  if (n < 0 || p == nullptr || g == nullptr || m == nullptr || v == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  Args a;
  a.c.decay = static_cast<float>(1.0 - lr * weight_decay);
  a.c.w1 = static_cast<float>(1.0 - beta1);
  a.c.b2 = static_cast<float>(beta2);
  a.c.w2 = static_cast<float>(1.0 - beta2);
  a.c.eps = static_cast<float>(eps);
  a.c.neg_step = static_cast<float>(-(lr / (1.0 - pow(beta1, step))));
  a.c.bc2_sqrt = static_cast<float>(pow(1.0 - pow(beta2, step), 0.5));
  a.lr = lr;
  a.beta1 = beta1;
  a.beta2 = beta2;
  a.step = static_cast<const float*>(device_step);
  a.div = static_cast<const float*>(div);
  a.mul = static_cast<const float*>(mul);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, g, m, v, n, a, s)
              : launch<float>(p, g, m, v, n, a, s);
}

}  // extern "C"
