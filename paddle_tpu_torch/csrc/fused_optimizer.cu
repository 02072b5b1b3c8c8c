// The fused optimizer step for Hopper (sm_90a): one launch updates a list
// of tensors with SGD, Momentum, Adam or AdamW, bound through a plain C
// interface and loaded with ctypes by paddle_tpu_torch/ops/fused_optimizer.py.
//
// Replaces no TPU kernel: the reference runs its whole optimizer step as one
// compiled XLA program (paddle_tpu/optimizer/fused_step.py `run_fused_step`,
// and the update inside `jit.TrainStep`'s step), which XLA fuses itself.
// Without this kernel the port updates parameter by parameter with about
// fifteen eager elementwise kernels each, every one a pass over the tensor.
//
// Semantics: the port's composed update of each class
// (paddle_tpu_torch/optimizer/algorithms.py), op by op as ATen computes it
// on the card, bit for bit: every op in f32 and rounded once to the
// parameter's dtype (round to nearest even), scalars rounded to that dtype
// on the host, `tensor / python scalar` a multiply by the f32 reciprocal (as
// ATen's CUDA division by a CPU scalar does; the host computes it),
// `tensor / tensor` and sqrt IEEE. Every product, sum and quotient is an
// explicit _rn intrinsic, so no multiply and add contract into an FMA. The
// global-norm clip's scale (a 0-dim f32 tensor, computed before the launch)
// is read by pointer: a gradient with need_clip becomes round(g * scale) in
// its own dtype, then takes the parameter's dtype (g.to(p.dtype)). With a
// master weight the parameter is the f32 copy and `low` receives its
// rounding to bf16 or fp16 (p.copy_(master)).
//
// Bound on the H100: bytes. AdamW in bf16 reads p, g, m and v and writes p,
// m and v, 14 bytes an element, against 16 f32 operations. So the design is
// one pass: a block takes a chunk of kChunk elements of one tensor (found
// by a binary search over the launch's per-tensor metadata, which the host
// sends in one copy), four elements a thread per step with 8- or 16-byte
// vector loads when every pointer of the tensor is 16-byte aligned, and
// the chunk's ragged tail one element a thread.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 16384;  // elements a block
constexpr int kMaxTensors = 128;     // metadata rows a launch

enum Op { kSGD = 0, kMomentum = 1, kAdam = 2, kAdamW = 3 };
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum Flag { kClip = 1, kNesterov = 2, kL2 = 4 };

// One tensor of a launch; the host builds the same 128-byte layout (META in
// ops/fused_optimizer.py, checked through fused_optimizer_abi).
struct Meta {
  void* p;             // parameter (or f32 master), dtype `dtype`
  const void* g;       // gradient, dtype `gdtype`
  void* s1;            // m or velocity, dtype `dtype` (unused by SGD)
  void* s2;            // v, dtype `dtype` (Adam, AdamW)
  void* low;           // low-precision copy of p, dtype `lowdtype`, or null
  const float* scale;  // the global-norm clip's scale, read where kClip
  long long n;         // elements
  long long first_chunk;
  int op, dtype, gdtype, lowdtype, flags;
  float lr, decay, l2, b1, omb1, b2, omb2, inv_c1, inv_c2, eps, mu;
};
static_assert(sizeof(Meta) == 128, "Meta must be the host's 128-byte row");

__device__ __forceinline__ float round_to(float x, int dt) {
  if (dt == kBF16) return __bfloat162float(__float2bfloat16_rn(x));
  if (dt == kF16) return __half2float(__float2half_rn(x));
  return x;
}

template <int DT>
__device__ __forceinline__ float R(float x) { return round_to(x, DT); }

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// element i of an array of dtype dt, as f32
__device__ __forceinline__ float load1(const void* base, int dt, long long i) {
  if (dt == kBF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  if (dt == kF16) return __half2float(static_cast<const __half*>(base)[i]);
  return static_cast<const float*>(base)[i];
}

// x (already a value of dtype dt) stored as element i
__device__ __forceinline__ void store1(void* base, int dt, long long i, float x) {
  if (dt == kBF16) static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  else if (dt == kF16) static_cast<__half*>(base)[i] = __float2half_rn(x);
  else static_cast<float*>(base)[i] = x;
}

// elements i .. i + 3 (i a multiple of 4, base 16-byte aligned)
__device__ __forceinline__ void load4(const void* base, int dt, long long i, float* out) {
  if (dt == kF32) {
    const float4 v = *reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(base) + i);
    if (dt == kBF16) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) out[k] = __bfloat162float(e[k]);
    } else {
      const __half* e = reinterpret_cast<const __half*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) out[k] = __half2float(e[k]);
    }
  }
}

__device__ __forceinline__ void store4(void* base, int dt, long long i, const float* x) {
  if (dt == kF32) {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + i) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    uint2 v;
    if (dt == kBF16) {
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) e[k] = __float2bfloat16_rn(x[k]);
    } else {
      __half* e = reinterpret_cast<__half*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) e[k] = __float2half_rn(x[k]);
    }
    *reinterpret_cast<uint2*>(static_cast<uint16_t*>(base) + i) = v;
  }
}

// One element's update in dtype DT: p, s1, s2 in and out; g the gradient
// after the clip and the cast to DT.
template <int DT, int OP>
__device__ __forceinline__ void update(const Meta& m, float& p, float g, float& s1, float& s2) {
  if (m.flags & kL2) g = R<DT>(add(g, R<DT>(mul(p, m.l2))));  // g + p * l2
  if (OP == kSGD) {
    p = R<DT>(sub(p, R<DT>(mul(g, m.lr))));  // p - g * lr
  } else if (OP == kMomentum) {
    const float v = R<DT>(add(R<DT>(mul(s1, m.mu)), g));  // velocity * mu + g
    const float step = (m.flags & kNesterov) ? R<DT>(add(g, R<DT>(mul(v, m.mu)))) : v;
    s1 = v;
    p = R<DT>(sub(p, R<DT>(mul(step, m.lr))));  // p - step * lr
  } else {
    if (OP == kAdamW) p = R<DT>(mul(p, m.decay));  // p * (1 - lr * wd)
    const float mm = R<DT>(add(R<DT>(mul(s1, m.b1)), R<DT>(mul(g, m.omb1))));
    const float vv = R<DT>(add(R<DT>(mul(s2, m.b2)), R<DT>(mul(R<DT>(mul(g, g)), m.omb2))));
    // den = sqrt(v / c2) + eps; step = (m / c1) * lr / den
    const float den = R<DT>(add(R<DT>(__fsqrt_rn(R<DT>(mul(vv, m.inv_c2)))), m.eps));
    const float step = R<DT>(__fdiv_rn(R<DT>(mul(R<DT>(mul(mm, m.inv_c1)), m.lr)), den));
    s1 = mm;
    s2 = vv;
    p = R<DT>(sub(p, step));
  }
}

// the gradient as the update takes it: clipped in its own dtype, then cast
template <int DT>
__device__ __forceinline__ float prepare(const Meta& m, float g, float scale) {
  if (m.flags & kClip) g = round_to(mul(g, scale), m.gdtype);
  return R<DT>(g);
}

template <int DT, int OP>
__device__ void run_chunk(const Meta& m, long long begin, long long end) {
  constexpr bool kS1 = OP != kSGD, kS2 = OP >= kAdam;
  const float scale = (m.flags & kClip) ? *m.scale : 1.f;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(m.p) | reinterpret_cast<uintptr_t>(m.g)
                         | reinterpret_cast<uintptr_t>(m.s1) | reinterpret_cast<uintptr_t>(m.s2)
                         | reinterpret_cast<uintptr_t>(m.low);
  long long tail = begin;
  if ((bits & 15) == 0) {
    const long long groups = (end - begin) / 4;
    for (long long k = threadIdx.x; k < groups; k += kThreads) {
      const long long i = begin + 4 * k;
      float p[4], g[4], s1[4] = {}, s2[4] = {};
      load4(m.p, DT, i, p);
      load4(m.g, m.gdtype, i, g);
      if (kS1) load4(m.s1, DT, i, s1);
      if (kS2) load4(m.s2, DT, i, s2);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        update<DT, OP>(m, p[e], prepare<DT>(m, g[e], scale), s1[e], s2[e]);
      store4(m.p, DT, i, p);
      if (kS1) store4(m.s1, DT, i, s1);
      if (kS2) store4(m.s2, DT, i, s2);
      if (m.low) store4(m.low, m.lowdtype, i, p);
    }
    tail = begin + 4 * groups;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    float p = load1(m.p, DT, i), s1 = kS1 ? load1(m.s1, DT, i) : 0.f;
    float s2 = kS2 ? load1(m.s2, DT, i) : 0.f;
    update<DT, OP>(m, p, prepare<DT>(m, load1(m.g, m.gdtype, i), scale), s1, s2);
    store1(m.p, DT, i, p);
    if (kS1) store1(m.s1, DT, i, s1);
    if (kS2) store1(m.s2, DT, i, s2);
    if (m.low) store1(m.low, m.lowdtype, i, p);
  }
}

template <int DT>
__device__ void run_dtype(const Meta& m, long long begin, long long end) {
  switch (m.op) {
    case kSGD: run_chunk<DT, kSGD>(m, begin, end); break;
    case kMomentum: run_chunk<DT, kMomentum>(m, begin, end); break;
    case kAdam: run_chunk<DT, kAdam>(m, begin, end); break;
    default: run_chunk<DT, kAdamW>(m, begin, end); break;
  }
}

// One block a chunk; block b updates chunk b - first_chunk of the last
// tensor whose first_chunk <= b.
__global__ void __launch_bounds__(kThreads)
multi_tensor_update_kernel(const Meta* __restrict__ meta, int ntensors) {
  const long long chunk = blockIdx.x;
  int lo = 0, hi = ntensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (meta[mid].first_chunk <= chunk) lo = mid; else hi = mid - 1;
  }
  const Meta m = meta[lo];
  const long long begin = (chunk - m.first_chunk) * kChunk;
  const long long end = begin + kChunk < m.n ? begin + kChunk : m.n;
  switch (m.dtype) {
    case kBF16: run_dtype<kBF16>(m, begin, end); break;
    case kF16: run_dtype<kF16>(m, begin, end); break;
    default: run_dtype<kF32>(m, begin, end); break;
  }
}

}  // namespace

// The layout constants the host must share: sizeof(Meta), kChunk, kMaxTensors.
extern "C" void fused_optimizer_abi(long long* out) {
  out[0] = (long long)sizeof(Meta);
  out[1] = kChunk;
  out[2] = kMaxTensors;
}

// meta: ntensors Meta rows in device memory (1 <= ntensors <= kMaxTensors,
// each n >= 1, first_chunk the running sum of ceil(n / kChunk) from 0),
// nchunks their total. Returns the cudaError_t of the launch (0 on success).
extern "C" int multi_tensor_update(const void* meta, int ntensors, long long nchunks,
                                   void* stream) {
  if (ntensors < 1 || ntensors > kMaxTensors || nchunks < 1 || nchunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  multi_tensor_update_kernel<<<(unsigned)nchunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Meta*>(meta), ntensors);
  return (int)cudaGetLastError();
}
