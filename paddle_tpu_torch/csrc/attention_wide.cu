// Paged decode attention past 256 columns, on the CUDA cores (SIMT), for
// Hopper (sm_90a): head dims or pages past 256. Bound through a plain C
// interface and loaded with ctypes by
// paddle_tpu_torch/ops/paged_attention.py.
//
// Replaces, for the shapes the tensor-core kernel (paged_attention.cu: tiles
// and TMA boxes of at most 256 columns) does not take,
// paddle_tpu/ops/pallas/paged_attention.py:68 `paged_decode_attention`,
// whose composed path serves any size.
//
// Bound on the H100: bytes (each visible K and V row read once); speed is
// not this kernel's aim yet (PERF.md).
//
// Design: a block per (lane, query head), sixteen warps; warp w takes the
// visible slots w, w + 16, ... of the lane, reads each K and V row through
// the block table (a lane of the warp takes columns lane, lane + 32, ...),
// reduces the score by shuffles and keeps its own online softmax (max, sum,
// f32 accumulator); the warps merge in warp order. Each warp's slots form a
// chain of dependent loads and shuffles, so the warps of a block are what
// hides their latency (four warps: 0.59 ms at hd 320, ragged lengths,
// PERF.md). Slots 0 .. min(max(length, 0), MB * bs - 1) are visible, as
// paged_attention.cu counts them. No scratch, a grid fixed by the shapes: a
// CUDA graph holds the call.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kInit = -4e30f;  // the running maximum before the first slot
constexpr int kMaxHeadDim = 1024;
constexpr int kPagedThreads = 512;
constexpr int kPagedWarps = kPagedThreads / 32;
constexpr int kPagedJ = kMaxHeadDim / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, float>::value)
    return v;
  else if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn(v);
  else
    return __float2half_rn(v);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// ---------------------------------------------------------------------------
// paged decode attention
// ---------------------------------------------------------------------------

struct PagedArgs {
  const void* q; const void* pk; const void* pv;
  const int* table; const int* lengths;
  void* out;
  int H, Hk, hd, bs, mb;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kPagedThreads) paged_wide_kernel(const PagedArgs a) {
  __shared__ float part_m[kPagedWarps], part_l[kPagedWarps];
  extern __shared__ float part_acc[];          // [kPagedWarps][hd]
  const int lane_id = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.x, h = blockIdx.y;
  const int hk = h / (a.H / a.Hk);
  const int cap = a.mb * a.bs;
  const int nvis = min(max(a.lengths[b], 0), cap - 1) + 1;
  const T* q = static_cast<const T*>(a.q) + ((long long)b * a.H + h) * a.hd;
  float qv[kPagedJ], acc[kPagedJ];
#pragma unroll
  for (int j = 0; j < kPagedJ; ++j) {
    const int d = lane_id + 32 * j;
    qv[j] = d < a.hd ? to_f(q[d]) : 0.f;
    acc[j] = 0.f;
  }
  float m = kInit, l = 0.f;
  for (int s = warp; s < nvis; s += kPagedWarps) {
    const long long page = a.table[(long long)b * a.mb + s / a.bs];
    const long long row = ((page * a.bs + s % a.bs) * a.Hk + hk) * a.hd;
    const T* kr = static_cast<const T*>(a.pk) + row;
    const T* vr = static_cast<const T*>(a.pv) + row;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kPagedJ; ++j) {
      const int d = lane_id + 32 * j;
      if (d < a.hd) dot = fmaf(qv[j], to_f(kr[d]), dot);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    const float sc = dot * a.scale;
    const float mx = fmaxf(m, sc);
    const float alpha = expf(m - mx), p = expf(sc - mx);
    l = l * alpha + p;
#pragma unroll
    for (int j = 0; j < kPagedJ; ++j) {
      const int d = lane_id + 32 * j;
      acc[j] = fmaf(p, d < a.hd ? to_f(vr[d]) : 0.f, acc[j] * alpha);
    }
    m = mx;
  }
  if (lane_id == 0) {
    part_m[warp] = m;
    part_l[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < kPagedJ; ++j) {
    const int d = lane_id + 32 * j;
    if (d < a.hd) part_acc[warp * a.hd + d] = acc[j];
  }
  __syncthreads();
  float mm = kInit;
#pragma unroll
  for (int w = 0; w < kPagedWarps; ++w) mm = fmaxf(mm, part_m[w]);
  float total = 0.f, wt[kPagedWarps];
#pragma unroll
  for (int w = 0; w < kPagedWarps; ++w) {
    wt[w] = expf(part_m[w] - mm);
    total += wt[w] * part_l[w];
  }
  T* out = static_cast<T*>(a.out) + ((long long)b * a.H + h) * a.hd;
  for (int d = threadIdx.x; d < a.hd; d += kPagedThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kPagedWarps; ++w) v += wt[w] * part_acc[w * a.hd + d];
    out[d] = from_f<T>(v / total);
  }
}

}  // namespace

// Paged decode attention: q [lanes, H, hd], pages_k/v [nb, bs, Hk, hd],
// table int32 [lanes, mb], lengths int32 [lanes], out like q, all
// contiguous; dtype 0 f32, 1 bf16, 2 fp16; hd up to 1024, any bs. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int paged_wide(const void* q, const void* pk, const void* pv, const void* table,
                          const void* lengths, void* out, int lanes, int H, int Hk, int hd,
                          int bs, int mb, float scale, int dtype, void* stream) {
  if (hd <= 0 || hd > kMaxHeadDim || lanes <= 0 || bs <= 0 || mb <= 0)
    return (int)cudaErrorInvalidValue;
  const PagedArgs a{q, pk, pv, static_cast<const int*>(table),
                    static_cast<const int*>(lengths), out, H, Hk, hd, bs, mb, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)kPagedWarps * hd * sizeof(float);
  const dim3 grid(lanes, H);
  auto run = [&](auto kernel) {
    if (int e = set_smem(kernel, smem)) return e;
    kernel<<<grid, kPagedThreads, smem, s>>>(a);
    return (int)cudaGetLastError();
  };
  if (dtype == 0) return run(paged_wide_kernel<float>);
  if (dtype == 1) return run(paged_wide_kernel<__nv_bfloat16>);
  if (dtype == 2) return run(paged_wide_kernel<__half>);
  return (int)cudaErrorInvalidValue;
}
