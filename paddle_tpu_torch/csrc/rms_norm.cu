// Fused RMSNorm forward and backward dx for Hopper (sm_90a), bound through a
// plain C interface and loaded with ctypes by paddle_tpu_torch/ops/fused_norm.py.
//
// Replaces: paddle_tpu/ops/pallas/fused_norm.py:79 `rms_norm_2d` (its
// bodies `_rms_fwd_kernel`, :45-52, and `_rms_bwd_dx_kernel`, :55-64), which
// eager `rms_norm` calls reach: every Llama norm of the training step.
// Computes, per row of x [N, H], in f32 whatever the storage type:
//   inv = rsqrt(mean(x^2) + eps);  out = x * inv * w   (w applied in f32,
//   then one rounding to the storage type), inv saved as f32 [N];
//   dx = inv * dO * w - x * inv^3 * sum(dO * w * x) / H.
// dW (a plain column sum over rows) stays outside the kernel, as the
// reference leaves it to its compiler.
//
// A second mode (`round_first`) is the reference's composed form
// (paddle_tpu/nn/functional/norm.py:80-94), which every traced call takes,
// the whole compiled TrainStep included: n = T(x * inv) is rounded to the
// storage type first, then out = T(n * w) (a product of two values of T,
// exact in f32, rounded once: T's own multiply). Its backward is that
// form's gradient: dn = T(dO * w), rounded as the composed multiply's
// transpose rounds it, then dx = inv * dn - x * inv^3 * sum(dn * x) / H in
// f32; dW = sum over rows of dO * n, outside the kernel.
//
// Bound on the H100: bytes. The forward reads x and writes out (two rows of
// traffic per row), the backward reads x and dO and writes dx (three),
// against 3.35 TB/s: 0.040 and 0.060 ms at [8192, 4096] bf16. A few FLOPs
// per element. So the design moves each row through HBM once, in 16-byte
// vectors, and its second read of the row hits L1/L2.
//
// Design: one block of 256 threads per row. Each thread reads 16-byte
// vectors of the row (scalars when H or an address does not allow it), sums
// squares in f32, and the block reduces with warp shuffles and one fixed-
// order pass over the warp partials, so the result does not depend on
// scheduling. The second pass re-reads the row, which the first pass left in
// L1/L2. Not done yet: several rows per block for small H, keeping the row in
// registers.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ float to_f(T v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else if constexpr (std::is_same<T, __nv_bfloat16>::value) return __bfloat162float(v);
  else return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else if constexpr (std::is_same<T, __nv_bfloat16>::value) return __float2bfloat16(v);
  else return __float2half(v);
}

template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// Sum over the block, the same value in every thread; the warp partials are
// added in warp order.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += red[i];
  return total;
}

// fn(i, values of x at i..) over the row, by vectors when VEC
template <typename T, bool VEC, typename F>
__device__ __forceinline__ void for_row(int H, F&& fn) {
  if constexpr (VEC) {
    constexpr int N = Vec<T>::N;
    for (int i = threadIdx.x * N; i < H; i += kThreads * N) fn(i, N);
  } else {
    for (int i = threadIdx.x; i < H; i += kThreads) fn(i, 1);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void load(const T* p, int n, float* f) {
  if constexpr (VEC) {
    const Vec<T> v = *reinterpret_cast<const Vec<T>*>(p);
#pragma unroll
    for (int j = 0; j < Vec<T>::N; ++j) f[j] = to_f(v.v[j]);
  } else {
    f[0] = to_f(p[0]);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store(T* p, const float* f) {
  if constexpr (VEC) {
    Vec<T> v;
#pragma unroll
    for (int j = 0; j < Vec<T>::N; ++j) v.v[j] = from_f<T>(f[j]);
    *reinterpret_cast<Vec<T>*>(p) = v;
  } else {
    p[0] = from_f<T>(f[0]);
  }
}

// v rounded to T and back, where the mode rounds first
template <typename T, bool ROUND>
__device__ __forceinline__ float first(float v) {
  if constexpr (ROUND) return to_f(from_f<T>(v));
  else return v;
}

template <typename T, bool VEC, bool ROUND>
__global__ void __launch_bounds__(kThreads)
rms_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               float* __restrict__ inv, int H, float eps) {
  constexpr int N = VEC ? Vec<T>::N : 1;
  __shared__ float red[kWarps];
  const size_t base = (size_t)blockIdx.x * H;
  float ss = 0.f;
  for_row<T, VEC>(H, [&](int i, int) {
    float f[N];
    load<T, VEC>(x + base + i, N, f);
#pragma unroll
    for (int j = 0; j < N; ++j) ss += f[j] * f[j];
  });
  const float r = rsqrtf(block_sum(ss, red) / H + eps);
  if (threadIdx.x == 0) inv[blockIdx.x] = r;
  for_row<T, VEC>(H, [&](int i, int) {
    float f[N], wf[N];
    load<T, VEC>(x + base + i, N, f);
    load<T, VEC>(w + i, N, wf);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = first<T, ROUND>(f[j] * r) * wf[j];
    store<T, VEC>(out + base + i, f);
  });
}

template <typename T, bool VEC, bool ROUND>
__global__ void __launch_bounds__(kThreads)
rms_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ inv, const T* __restrict__ dout,
                  T* __restrict__ dx, int H) {
  constexpr int N = VEC ? Vec<T>::N : 1;
  __shared__ float red[kWarps];
  const size_t base = (size_t)blockIdx.x * H;
  float proj = 0.f;
  for_row<T, VEC>(H, [&](int i, int) {
    float f[N], wf[N], d[N];
    load<T, VEC>(x + base + i, N, f);
    load<T, VEC>(w + i, N, wf);
    load<T, VEC>(dout + base + i, N, d);
#pragma unroll
    for (int j = 0; j < N; ++j) proj += first<T, ROUND>(d[j] * wf[j]) * f[j];
  });
  const float r = inv[blockIdx.x];
  const float c = r * r * r * (block_sum(proj, red) / H);
  for_row<T, VEC>(H, [&](int i, int) {
    float f[N], wf[N], d[N];
    load<T, VEC>(x + base + i, N, f);
    load<T, VEC>(w + i, N, wf);
    load<T, VEC>(dout + base + i, N, d);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = r * first<T, ROUND>(d[j] * wf[j]) - f[j] * c;
    store<T, VEC>(dx + base + i, f);
  });
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, bool ROUND>
int fwd(const void* x, const void* w, void* out, void* inv, int rows, int H, float eps,
        cudaStream_t s) {
  const bool vec = H % Vec<T>::N == 0 && aligned16(x) && aligned16(w) && aligned16(out);
  auto* xp = static_cast<const T*>(x);
  auto* wp = static_cast<const T*>(w);
  auto* op = static_cast<T*>(out);
  auto* ip = static_cast<float*>(inv);
  if (vec)
    rms_fwd_kernel<T, true, ROUND><<<rows, kThreads, 0, s>>>(xp, wp, op, ip, H, eps);
  else
    rms_fwd_kernel<T, false, ROUND><<<rows, kThreads, 0, s>>>(xp, wp, op, ip, H, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool ROUND>
int bwd(const void* x, const void* w, const void* inv, const void* dout, void* dx, int rows,
        int H, cudaStream_t s) {
  const bool vec = H % Vec<T>::N == 0 && aligned16(x) && aligned16(w) && aligned16(dout) &&
                   aligned16(dx);
  auto* xp = static_cast<const T*>(x);
  auto* wp = static_cast<const T*>(w);
  auto* ip = static_cast<const float*>(inv);
  auto* dp = static_cast<const T*>(dout);
  auto* dxp = static_cast<T*>(dx);
  if (vec)
    rms_bwd_dx_kernel<T, true, ROUND><<<rows, kThreads, 0, s>>>(xp, wp, ip, dp, dxp, H);
  else
    rms_bwd_dx_kernel<T, false, ROUND><<<rows, kThreads, 0, s>>>(xp, wp, ip, dp, dxp, H);
  return (int)cudaGetLastError();
}

template <bool ROUND>
int fwd_any(const void* x, const void* w, void* out, void* inv, int rows, int H, float eps,
            int dtype, cudaStream_t s) {
  switch (dtype) {
    case 0: return fwd<float, ROUND>(x, w, out, inv, rows, H, eps, s);
    case 1: return fwd<__nv_bfloat16, ROUND>(x, w, out, inv, rows, H, eps, s);
    case 2: return fwd<__half, ROUND>(x, w, out, inv, rows, H, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool ROUND>
int bwd_any(const void* x, const void* w, const void* inv, const void* dout, void* dx, int rows,
            int H, int dtype, cudaStream_t s) {
  switch (dtype) {
    case 0: return bwd<float, ROUND>(x, w, inv, dout, dx, rows, H, s);
    case 1: return bwd<__nv_bfloat16, ROUND>(x, w, inv, dout, dx, rows, H, s);
    case 2: return bwd<__half, ROUND>(x, w, inv, dout, dx, rows, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out [rows, H] contiguous, w [H], inv f32 [rows]; dtype 0 f32, 1 bf16,
// 2 fp16; round_first 1 for the composed form's rounding. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int rms_norm_fwd(const void* x, const void* w, void* out, void* inv, int rows, int H,
                            float eps, int dtype, int round_first, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return round_first ? fwd_any<true>(x, w, out, inv, rows, H, eps, dtype, s)
                     : fwd_any<false>(x, w, out, inv, rows, H, eps, dtype, s);
}

// dx [rows, H] from x, w, the forward's inv and dout, all contiguous.
extern "C" int rms_norm_bwd_dx(const void* x, const void* w, const void* inv, const void* dout,
                               void* dx, int rows, int H, int dtype, int round_first,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return round_first ? bwd_any<true>(x, w, inv, dout, dx, rows, H, dtype, s)
                     : bwd_any<false>(x, w, inv, dout, dx, rows, H, dtype, s);
}
