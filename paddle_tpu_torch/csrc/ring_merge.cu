// The lse merge of ring attention, in place, for Hopper (sm_90a), bound
// through a plain C interface and loaded with ctypes by
// paddle_tpu_torch/ops/ring_flash.py.
//
// Replaces: paddle_tpu/ops/pallas/ring_flash.py:44 `_merge`, the one piece of
// arithmetic the ring adds to the FA2 kernels (the TPU leaves it to its
// compiler's fusion). Per row (batch n, position s, head h) of a running f32
// accumulator `acc` [N, S, H, D] with its lse [N, H, S], and a new normalized
// partial `out_b` [N, S, H, D] (bf16, fp16 or f32) with lse_b [N, H, S]:
//   m = max(lse, lse_b),  w = exp(lse - m),  w_b = exp(lse_b - m)
//   d = max(w + w_b, 1e-30)
//   acc = (acc * w + f32(out_b) * w_b) / d,   lse = m + log(d)
// in that order, each product and sum rounded on its own (no fused
// multiply-add), as the composed version computes it. Rows below `out_rows`
// also write acc rounded to out_b's type into `out`: the ring finishes one
// rank's rows at a time, and this spares a separate cast pass.
//
// Bound on the H100: bytes. Each element reads 4 + 2 bytes and writes 4
// (plus 2 for a finished row) against a handful of f32 operations, far
// under the ridge point. So the design is one pass: each thread takes 8
// consecutive elements of one row (two 16-byte loads and stores of acc, one
// 16-byte load of a 16-bit out_b, two of an f32 one), D / 8 threads a row,
// whole rows a block. Every
// thread of a row computes the row's weights from the two lse values (a
// broadcast load); the block reads all its lse values before its first lane
// of each row writes the new one back.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;          // elements a thread
constexpr int kThreads = 256;    // at most, per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// kVec consecutive elements of T: 16 bytes each for 16-bit types, 32 for f32
template <typename T>
struct alignas(16) Vec {
  T e[kVec];
};
template <typename T>
__device__ __forceinline__ Vec<T> load_vec(const T* p) {
  Vec<T> v;
  const uint4* s = reinterpret_cast<const uint4*>(p);
  uint4* d = reinterpret_cast<uint4*>(&v);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(Vec<T>) / 16); ++i) d[i] = __ldg(s + i);
  return v;
}
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const Vec<T>& v) {
  uint4* d = reinterpret_cast<uint4*>(p);
  const uint4* s = reinterpret_cast<const uint4*>(&v);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(Vec<T>) / 16); ++i) d[i] = s[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_merge_kernel(float* __restrict__ acc, float* __restrict__ lse, const T* __restrict__ out_b,
                  const float* __restrict__ lse_b, T* __restrict__ out, long long out_rows,
                  long long rows, long long S, long long H, int D, int group,
                  int rows_per_block) {
  const int local = threadIdx.x / group;
  const int lane = threadIdx.x - local * group;
  const long long row = (long long)blockIdx.x * rows_per_block + local;
  const bool live = row < rows;
  long long li = 0;
  float w = 0.f, wb = 0.f, d = 1.f, m = 0.f;
  if (live) {
    // row = (n * S + s) * H + h; the lse rows are [N, H, S]
    const long long n = row / (S * H);
    const long long rem = row - n * S * H;
    const long long s = rem / H, h = rem - (rem / H) * H;
    li = (n * H + h) * S + s;
    const float a = lse[li], b = lse_b[li];
    m = fmaxf(a, b);
    w = expf(a - m);
    wb = expf(b - m);
    d = fmaxf(__fadd_rn(w, wb), 1e-30f);
  }
  __syncthreads();  // every lse of this block is read before any is written
  if (!live) return;
  if (lane == 0) lse[li] = __fadd_rn(m, logf(d));

  const long long base = row * D + (long long)lane * kVec;
  float4* a4 = reinterpret_cast<float4*>(acc + base);
  const Vec<T> vb = load_vec(out_b + base);
  const T* eb = vb.e;
  float va[kVec];
  *reinterpret_cast<float4*>(va) = a4[0];
  *reinterpret_cast<float4*>(va + 4) = a4[1];
  Vec<T> vo;
  T* eo = vo.e;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    va[e] = __fdiv_rn(__fadd_rn(__fmul_rn(va[e], w), __fmul_rn(to_f(eb[e]), wb)), d);
    eo[e] = from_f<T>(va[e]);
  }
  a4[0] = *reinterpret_cast<float4*>(va);
  a4[1] = *reinterpret_cast<float4*>(va + 4);
  if (row < out_rows) store_vec(out + base, vo);
}

template <typename T>
int merge(void* acc, void* lse, const void* out_b, const void* lse_b, void* out,
          long long out_rows, long long N, long long S, long long H, int D, cudaStream_t st) {
  const int group = D / kVec;
  const int rows_per_block = kThreads / group;
  const long long rows = N * S * H;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  ring_merge_kernel<T><<<(unsigned)blocks, rows_per_block * group, 0, st>>>(
      static_cast<float*>(acc), static_cast<float*>(lse), static_cast<const T*>(out_b),
      static_cast<const float*>(lse_b), static_cast<T*>(out), out_rows, rows, S, H, D, group,
      rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// acc f32 [N, S, H, D] and lse f32 [N, H, S] are updated in place from
// out_b [N, S, H, D] (dtype 1 bf16, 2 fp16, 3 f32) and lse_b f32 [N, H, S]; the
// first out_rows rows (of N * S * H) are also written, rounded, to out (of
// out_b's type; may be null when out_rows is 0). Everything contiguous,
// acc, out_b and out 16-byte aligned, D a multiple of 8 up to 2048 (checked
// by the caller). Returns the cudaError_t of the launch (0 on success).
extern "C" int ring_merge(void* acc, void* lse, const void* out_b, const void* lse_b, void* out,
                          long long out_rows, long long N, long long S, long long H, int D,
                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % kVec || D / kVec > kThreads) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 1: return merge<__nv_bfloat16>(acc, lse, out_b, lse_b, out, out_rows, N, S, H, D, st);
    case 2: return merge<__half>(acc, lse, out_b, lse_b, out, out_rows, N, S, H, D, st);
    case 3: return merge<float>(acc, lse, out_b, lse_b, out, out_rows, N, S, H, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
