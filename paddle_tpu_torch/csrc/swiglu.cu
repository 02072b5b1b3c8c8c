// SwiGLU forward and backward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes by paddle_tpu_torch/ops/fused_norm.py.
//
// Replaces: paddle_tpu/ops/pallas/fused_norm.py:152 `swiglu_2d` (forward
// body `_swiglu_fwd_kernel` :135-138, backward `_swiglu_bwd_kernel`
// :141-148), the fused op the reference keeps for explicit use (its Llama
// and `swiglu` functional stay composed). Semantics, as the TPU kernels:
// inputs widened to f32, sig = sigmoid(a), silu = a * sig;
//   forward   out = silu * b
//   backward  da = dO * b * (sig + silu * (1 - sig)),  db = dO * silu
// each output rounded once to the storage type.
//
// Bound on the H100: bytes. Each element is read and written once (3
// tensor passes forward, 5 backward) against a handful of f32 operations,
// far under the ridge point. So the design is one pass, 16-byte vectors
// (8 bf16/fp16 or 4 f32 elements a thread), one thread per vector and the
// ragged tail (fewer elements than a vector) taken one element a thread
// by the threads past the last vector. The tensors are flat: any shape of
// contiguous, 16-byte aligned storage.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

__device__ __forceinline__ float sigmoid(float a) { return 1.f / (1.f + expf(-a)); }

template <typename T>
struct Fwd {
  __device__ __forceinline__ static void op(const T* a, const T* b, T* out, long long i) {
    const float x = to_f(a[i]), sg = sigmoid(x);
    out[i] = from_f<T>(x * sg * to_f(b[i]));
  }
};

template <typename T>
struct Bwd {
  __device__ __forceinline__ static void op(const T* a, const T* b, const T* dout, T* da, T* db,
                                            long long i) {
    const float x = to_f(a[i]), y = to_f(b[i]), d = to_f(dout[i]);
    const float sg = sigmoid(x), silu = x * sg;
    da[i] = from_f<T>(d * y * (sg + silu * (1.f - sg)));
    db[i] = from_f<T>(d * silu);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                  long long n) {
  constexpr int V = 16 / sizeof(T);
  const long long nvec = n / V;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < nvec) {
    const uint4 va = __ldg(reinterpret_cast<const uint4*>(a) + i);
    const uint4 vb = __ldg(reinterpret_cast<const uint4*>(b) + i);
    uint4 vo;
    const T* ea = reinterpret_cast<const T*>(&va);
    const T* eb = reinterpret_cast<const T*>(&vb);
    T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
    for (int e = 0; e < V; ++e) Fwd<T>::op(ea, eb, eo, e);
    reinterpret_cast<uint4*>(out)[i] = vo;
  } else if (i - nvec < n - nvec * V) {
    Fwd<T>::op(a, b, out, nvec * V + (i - nvec));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ dout,
                  T* __restrict__ da, T* __restrict__ db, long long n) {
  constexpr int V = 16 / sizeof(T);
  const long long nvec = n / V;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < nvec) {
    const uint4 va = __ldg(reinterpret_cast<const uint4*>(a) + i);
    const uint4 vb = __ldg(reinterpret_cast<const uint4*>(b) + i);
    const uint4 vd = __ldg(reinterpret_cast<const uint4*>(dout) + i);
    uint4 wa, wb;
    const T* ea = reinterpret_cast<const T*>(&va);
    const T* eb = reinterpret_cast<const T*>(&vb);
    const T* ed = reinterpret_cast<const T*>(&vd);
    T* oa = reinterpret_cast<T*>(&wa);
    T* ob = reinterpret_cast<T*>(&wb);
#pragma unroll
    for (int e = 0; e < V; ++e) Bwd<T>::op(ea, eb, ed, oa, ob, e);
    reinterpret_cast<uint4*>(da)[i] = wa;
    reinterpret_cast<uint4*>(db)[i] = wb;
  } else if (i - nvec < n - nvec * V) {
    Bwd<T>::op(a, b, dout, da, db, nvec * V + (i - nvec));
  }
}

// threads: one per vector plus one per tail element
template <typename T>
unsigned blocks_of(long long n) {
  constexpr int V = 16 / sizeof(T);
  const long long threads = n / V + n % V;
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

template <typename T>
int fwd(const void* a, const void* b, void* out, long long n, cudaStream_t s) {
  swiglu_fwd_kernel<T><<<blocks_of<T>(n), kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* a, const void* b, const void* dout, void* da, void* db, long long n,
        cudaStream_t s) {
  swiglu_bwd_kernel<T><<<blocks_of<T>(n), kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(dout),
      static_cast<T*>(da), static_cast<T*>(db), n);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, out: n elements of one type (0 f32, 1 bf16, 2 fp16), contiguous and
// 16-byte aligned (checked by the caller). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int swiglu_fwd(const void* a, const void* b, void* out, long long n, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return fwd<float>(a, b, out, n, s);
    case 1: return fwd<__nv_bfloat16>(a, b, out, n, s);
    case 2: return fwd<__half>(a, b, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// da, db from a, b and dout under the same conditions.
extern "C" int swiglu_bwd(const void* a, const void* b, const void* dout, void* da, void* db,
                          long long n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return bwd<float>(a, b, dout, da, db, n, s);
    case 1: return bwd<__nv_bfloat16>(a, b, dout, da, db, n, s);
    case 2: return bwd<__half>(a, b, dout, da, db, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
