// Int8 weight-only GEMM for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes by paddle_tpu_torch/ops/quant_matmul.py.
//
// Replaces: paddle_tpu/ops/pallas/quant_matmul.py:116 `int8_matmul` (its
// forward body `_fwd_kernel`, :56-70), which the serving engine reaches
// through `matmul_gate` and `decode_matmul` for every projection of an
// int8 engine. Computes out[M, N] = bf16((x[M, K] @ W[K, N]) * scales[N]):
// each bf16 x int8 product is exact in f32, products are summed in f32 over
// K, the sum is multiplied by the per-output-channel scale in f32 and cast
// to bf16 once.
//
// Bound on the H100: bytes. At decode sizes (M = lanes, or a prefill chunk)
// the weight matrix is the traffic, one byte per element against
// 3.35 TB/s; 2 x M FLOPs per weight byte stays far under the ridge point.
//
// Design, a weight stream that follows the reference's small-M branch: a
// block of 256 threads owns 128 output columns for a tile of MT rows of x
// and one slice of K. W streams through a ring of shared-memory stages
// (64 rows x 128 columns, 16-byte cp.async per thread, several stages in
// flight), so the loads in flight do not depend on registers, which the
// MT x 4 f32 sums of each thread need. The x tile is widened to f32 once,
// into shared memory, transposed so the MT values of one k are vector
// loads. Each thread takes 4 columns of a W row per step (a warp reads
// one 128-byte row segment, conflict-free), widens the bytes to f32
// with a byte-permute into the mantissa of 2^23 (exact for int8, no
// int-to-float conversions) and accumulates with FMAs. The 8 row groups (one
// per warp) of a block are summed through shared memory in a fixed order.
// When K is split over several blocks to fill the SMs, each slice writes
// an f32 partial and a second kernel adds the slices in order, applies the
// scale and casts, so the result does not depend on scheduling. Rows of x
// past M and rows of W past K are zeros in shared memory and never stored,
// so any M is taken. Not done yet: tensor cores (mma) for larger M, TMA, a
// persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 128;       // output columns per block
constexpr int kColThreads = 32;  // threads across one row segment, 4 columns each
constexpr int kRowGroups = kThreads / kColThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;          // W rows per pipeline stage (8 KB)
constexpr int kStages = 4;
constexpr int kCopies = kBK * kCols / 16 / kThreads;  // 16-byte copies per thread per stage

// int8 byte i of v -> exact float, via 0x4B0000xx = 2^23 + xx with the
// byte biased to unsigned (x ^ 0x80 == x + 128).
__device__ __forceinline__ void widen4(uint32_t v, float* f) {
  const uint32_t u = v ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int MT>
__device__ __forceinline__ void load_x(const float* p, float* xv) {
  if constexpr (MT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < MT; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      xv[i] = v.x; xv[i + 1] = v.y; xv[i + 2] = v.z; xv[i + 3] = v.w;
    }
  } else if constexpr (MT == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    xv[0] = v.x; xv[1] = v.y;
  } else {
    xv[0] = p[0];
  }
}

__host__ __device__ inline int stages_of(int klen) { return (klen + kBK - 1) / kBK; }

template <int MT>
__host__ __device__ inline size_t smem_of(int kc) {
  const size_t main = (size_t)stages_of(kc) * kBK * MT * sizeof(float) +
                      (size_t)kStages * kBK * kCols;
  const size_t red = (size_t)kWarps * MT * kCols * sizeof(float);
  return main > red ? main : red;
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const __nv_bfloat16* __restrict__ x,   // [M, K]
                 const int8_t* __restrict__ w,          // [K, N]
                 const float* __restrict__ scales,      // [N]
                 float* __restrict__ partial,           // [ksplit, M, N] or null
                 __nv_bfloat16* __restrict__ out,       // [M, N]
                 int M, int K, int N, int kc) {
  const int tid = threadIdx.x;
  const int c = tid % kColThreads;
  const int r = tid / kColThreads;
  const int n_blk = blockIdx.x * kCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int k0 = split * kc;
  const int klen = min(kc, K - k0);
  const int nst = stages_of(klen);
  const int rows = nst * kBK;

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);                     // [rows][MT]
  int8_t* ws = reinterpret_cast<int8_t*>(xs + (size_t)rows * MT);  // [kStages][kBK][kCols]

  // W stage copy: thread -> rows tid / 8 + 32 i, 16-byte chunk tid % 8;
  // rows past the slice and columns past N are zero-filled
  const int cr = tid >> 3;
  const int cc = (tid & 7) * 16;
  const bool col_in = n_blk + cc < N;
  auto issue = [&](int st) {
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int row = cr + i * (kThreads / 8);
      const int kr = st * kBK + row;
      const bool ok = col_in && kr < klen;
      const int8_t* src = ok ? w + (size_t)(k0 + kr) * N + n_blk + cc : w;
      cp_async16(ws + ((size_t)(st % kStages) * kBK + row) * kCols + cc, src, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nst) issue(st);
    cp_async_commit();
  }

  // x tile, widened and transposed; zeros past M and past the slice
  for (int i = tid; i < MT * rows; i += kThreads) {
    const int mm = i / rows;
    const int kk = i - mm * rows;
    const int m = m0 + mm;
    xs[kk * MT + mm] =
        (m < M && kk < klen) ? __bfloat162float(x[(size_t)m * K + k0 + kk]) : 0.f;
  }

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();  // stage st has landed (this thread's part)
    __syncthreads();               // ... everyone's; slot of stage st - 1 is free
    if (st + kStages - 1 < nst) issue(st + kStages - 1);
    cp_async_commit();
    const int8_t* wst = ws + (size_t)(st % kStages) * kBK * kCols;
#pragma unroll
    for (int j = 0; j < kBK / kRowGroups; ++j) {
      const int row = r + j * kRowGroups;
      float wf[4];
      widen4(*reinterpret_cast<const uint32_t*>(wst + row * kCols + c * 4), wf);
      float xv[MT];
      load_x<MT>(xs + (size_t)(st * kBK + row) * MT, xv);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][q] = fmaf(xv[m], wf[q], acc[m][q]);
    }
  }
  cp_async_wait<0>();

  __syncthreads();  // the tiles are dead; reuse shared memory for the reduction
  float* red = reinterpret_cast<float*>(smem4);  // [kWarps][MT][kCols]
  const int warp = tid / 32;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(warp * MT + m) * kCols + c * 4 + j] = acc[m][j];
  __syncthreads();

  for (int o = tid; o < MT * kCols; o += kThreads) {
    const int m = o / kCols;
    const int col = o - m * kCols;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[(wi * MT + m) * kCols + col];
    const int gm = m0 + m;
    const int gn = n_blk + col;
    if (gm < M && gn < N) {
      if (partial != nullptr)
        partial[((size_t)split * M + gm) * N + gn] = s;
      else
        out[(size_t)gm * N + gn] = __float2bfloat16(s * scales[gn]);
    }
  }
}

__global__ void finalize_kernel(const float* __restrict__ partial, const float* __restrict__ scales,
                                __nv_bfloat16* __restrict__ out, int M, int N, int ksplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < ksplit; ++sp) s += partial[(size_t)sp * total + i];
  out[i] = __float2bfloat16(s * scales[i % N]);
}

template <int MT>
int launch(const void* x, const void* w, const void* scales, void* partial, void* out, int M,
           int K, int N, int kc, int ksplit, cudaStream_t stream) {
  const size_t smem = smem_of<MT>(kc);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(int8_gemm_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + kCols - 1) / kCols, ksplit, (M + MT - 1) / MT);
  float* part = ksplit > 1 ? static_cast<float*>(partial) : nullptr;
  int8_gemm_kernel<MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), part, static_cast<__nv_bfloat16*>(out), M, K, N, kc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ksplit == 1) return (int)e;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  finalize_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
      part, static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(out), M, N, ksplit);
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [M, K], w int8 [K, N], scales f32 [N], out bf16 [M, N]; partial is
// f32 [ksplit, M, N] scratch when ksplit > 1. mt is the row tile (1, 2, 4
// or 8); kc is the K slice per block (kc * ksplit >= K). The caller has
// checked K % 16 == 0, N % 16 == 0, 16-byte alignment, contiguity and
// dtypes. Returns the cudaError_t of the launches (0 on success).
extern "C" int int8_matmul(const void* x, const void* w, const void* scales, void* partial,
                           void* out, int M, int K, int N, int mt, int kc, int ksplit,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 1: return launch<1>(x, w, scales, partial, out, M, K, N, kc, ksplit, s);
    case 2: return launch<2>(x, w, scales, partial, out, M, K, N, kc, ksplit, s);
    case 4: return launch<4>(x, w, scales, partial, out, M, K, N, kc, ksplit, s);
    case 8: return launch<8>(x, w, scales, partial, out, M, K, N, kc, ksplit, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
