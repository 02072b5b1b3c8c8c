// Paged decode attention for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes by paddle_tpu_torch/ops/paged_attention.py.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py:68
// `paged_decode_attention`, which hands every serving decode attention to
// the bundled Mosaic paged-attention kernel on the TPU. Semantics follow the
// reference's composed path instead (`masked_attend` over
// `gather_lane_window`, paddle_tpu/models/llama.py:446 and
// paddle_tpu/inference/serving/paged_attention.py:88): logits scaled by
// 1/sqrt(hd), slots 0..lengths[lane] visible, query head h reads KV head
// h / (H/Hk), softmax in f32, output in q's dtype. The bundled TPU kernel
// applies no 1/sqrt(hd) scale; this kernel does.
//
// Bound on the H100: bytes. Each visible K and V row is read once
// (lanes x visible slots x Hk x hd x 2 tensors x 2 B in bf16) against
// 3.35 TB/s; the arithmetic is 4 FLOPs per element read, far below the
// ridge point.
//
// Design (split-KV, as in flash-decoding): the TPU kernel walks a lane's
// pages in order on one core; here the visible slots of a lane are cut
// into tiles of whole pages and every (KV head, lane, tile) is its own
// block, so a few lanes still fill the 132 SMs. A block reads its lane's
// block-table row itself and copies the tile's K and V rows into shared
// memory with 16-byte cp.async (K and V in two groups, so the scores run
// while V is still landing); rows past the last visible slot are never
// read, so stale bytes in a last page or in pages past the length never
// enter the sum, and tiles wholly past the length return at once. One warp
// per query head of the GQA group: the group's H/Hk heads share every
// staged row. Scores are one slot per lane (rows padded by 16 bytes so the
// lanes' vector reads hit distinct banks), the tile's softmax is in f32,
// and each lane accumulates hd/32 output elements. Each tile leaves its
// (max, sum, f32 accumulator); a second kernel merges the tiles of a lane
// in order, so the result does not depend on scheduling. Inactive lanes
// (length 0, table row on trash block 0) see exactly one slot, as in the
// composed path. Not done yet: TMA, keeping K/V in bf16 through
// tensor-core products, one pass without the merge kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxPerLane = 8;  // hd <= 256

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of T widened to floats
__device__ __forceinline__ void widen16(uint4 u, float* f, float) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen16(uint4 u, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ inline int visible_slots(int length, int cap) {
  int n = length + 1;  // slots 0..length
  return n > cap ? cap : (n < 1 ? 1 : n);
}

template <typename T>
__global__ void paged_decode_kernel(const T* __restrict__ q,            // [lanes, H, hd]
                                    const T* __restrict__ pages_k,      // [nb, bs, Hk, hd]
                                    const T* __restrict__ pages_v,      // [nb, bs, Hk, hd]
                                    const int* __restrict__ block_table,  // [lanes, MB]
                                    const int* __restrict__ lengths,      // [lanes]
                                    float* __restrict__ part_acc,  // [lanes, H, splits, hd]
                                    float* __restrict__ part_ml,   // [lanes, H, splits, 2]
                                    T* __restrict__ out,           // [lanes, H, hd]
                                    int H, int Hk, int hd, int bs, int MB, int tile, int splits,
                                    float scale) {
  const int g = blockIdx.x;   // KV head
  const int b = blockIdx.y;   // lane
  const int sp = blockIdx.z;  // tile of the lane's slots
  const int n = visible_slots(lengths[b], MB * bs);
  const int base = sp * tile;
  const int rows = min(tile, n - base);
  if (rows <= 0) return;  // the merge reads only tiles below the length

  const int rep = H / Hk;
  const int warp = threadIdx.x >> 5;  // query head within the group
  const int lane = threadIdx.x & 31;
  const int h = g * rep + warp;
  const int per = hd >> 5;
  constexpr int kVec = 16 / sizeof(T);
  const int ld = hd + kVec;  // padded row, in elements

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                             // [tile, ld]
  T* vs = ks + (size_t)tile * ld;                                 // [tile, ld]
  float* qs = reinterpret_cast<float*>(vs + (size_t)tile * ld);   // [rep, hd]
  float* ps = qs + rep * hd;                                      // [rep, tile]

  const int* bt = block_table + (size_t)b * MB;
  const int vec_per_row = hd / kVec;
  const size_t row_stride = (size_t)Hk * hd;
  for (int i = threadIdx.x; i < rows * vec_per_row; i += blockDim.x) {
    const int s = i / vec_per_row;
    const int c = i - s * vec_per_row;
    const int slot = base + s;
    const size_t src = ((size_t)bt[slot / bs] * bs + slot % bs) * row_stride + (size_t)g * hd;
    cp_async16(ks + (size_t)s * ld + c * kVec, pages_k + src + c * kVec);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < rows * vec_per_row; i += blockDim.x) {
    const int s = i / vec_per_row;
    const int c = i - s * vec_per_row;
    const int slot = base + s;
    const size_t src = ((size_t)bt[slot / bs] * bs + slot % bs) * row_stride + (size_t)g * hd;
    cp_async16(vs + (size_t)s * ld + c * kVec, pages_v + src + c * kVec);
  }
  cp_async_commit();
  const T* qg = q + ((size_t)b * H + (size_t)g * rep) * hd;
  for (int i = threadIdx.x; i < rep * hd; i += blockDim.x) qs[i] = to_f(qg[i]) * scale;
  cp_async_wait<1>();  // this thread's K rows have landed
  __syncthreads();     // everyone's K rows and q

  // scores: one slot per lane
  const float* qh = qs + warp * hd;
  float* pw = ps + warp * tile;
  float m = -CUDART_INF_F;
  for (int s = lane; s < rows; s += 32) {
    const T* kr = ks + (size_t)s * ld;
    float acc = 0.f;
    for (int d = 0; d < hd; d += kVec) {
      float kf[kVec];
      widen16(*reinterpret_cast<const uint4*>(kr + d), kf, T());
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc = fmaf(qh[d + j], kf[j], acc);
    }
    pw[s] = acc;
    m = fmaxf(m, acc);
  }
  m = warp_max(m);
  float l = 0.f;
  for (int s = lane; s < rows; s += 32) {
    const float e = expf(pw[s] - m);
    pw[s] = e;
    l += e;
  }
  l = warp_sum(l);
  cp_async_wait<0>();
  __syncthreads();  // V rows have landed; the warp's probabilities are visible

  float acc[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) acc[i] = 0.f;
  for (int s = 0; s < rows; ++s) {
    const float p = pw[s];
    const T* vr = vs + (size_t)s * ld + lane * per;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i)
      if (i < per) acc[i] = fmaf(p, to_f(vr[i]), acc[i]);
  }

  const size_t row = (size_t)b * H + h;
  if (splits == 1) {
    const float inv = 1.f / l;
    T* oh = out + row * hd + lane * per;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i)
      if (i < per) oh[i] = from_f<T>(acc[i] * inv);
    return;
  }
  float* pa = part_acc + (row * splits + sp) * hd + lane * per;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i)
    if (i < per) pa[i] = acc[i];
  if (lane == 0) {
    part_ml[(row * splits + sp) * 2] = m;
    part_ml[(row * splits + sp) * 2 + 1] = l;
  }
}

// out[lane, h, :] from the lane's tiles, merged in tile order
template <typename T>
__global__ void merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                             const int* __restrict__ lengths, T* __restrict__ out, int H, int hd,
                             int cap, int tile, int splits) {
  const size_t row = blockIdx.x;  // lane * H + head
  const int b = (int)(row / H);
  const int used = (visible_slots(lengths[b], cap) + tile - 1) / tile;
  const float* ml = part_ml + row * splits * 2;
  float mstar = -CUDART_INF_F;
  for (int s = 0; s < used; ++s) mstar = fmaxf(mstar, ml[2 * s]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < used; ++s) {
      const float w = expf(ml[2 * s] - mstar);
      l = fmaf(ml[2 * s + 1], w, l);
      acc = fmaf(part_acc[(row * splits + s) * hd + d], w, acc);
    }
    out[row * hd + d] = from_f<T>(acc / l);
  }
}

template <typename T>
int launch(const void* q, const void* pages_k, const void* pages_v, const int* block_table,
           const int* lengths, void* part_acc, void* part_ml, void* out, int lanes, int H, int Hk,
           int hd, int bs, int MB, int tile, float scale, cudaStream_t stream) {
  const int rep = H / Hk;
  const int ld = hd + 16 / (int)sizeof(T);
  const int splits = (MB * bs + tile - 1) / tile;
  const size_t smem = 2 * (size_t)tile * ld * sizeof(T) + (size_t)rep * hd * sizeof(float) +
                      (size_t)rep * tile * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(Hk, lanes, splits);
  paged_decode_kernel<T><<<grid, 32 * rep, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pages_k), static_cast<const T*>(pages_v),
      block_table, lengths, static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<T*>(out), H, Hk, hd, bs, MB, tile, splits, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  merge_kernel<T><<<lanes * H, hd < 128 ? hd : 128, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml), lengths,
      static_cast<T*>(out), H, hd, MB * bs, tile, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. tile: slots per block, a multiple of
// bs; with splits = ceil(MB * bs / tile) > 1 the caller passes f32 scratch
// part_acc [lanes, H, splits, hd] and part_ml [lanes, H, splits, 2]. The
// caller has checked shapes, dtypes and alignment: H % Hk == 0,
// H / Hk <= 32, hd % 32 == 0, hd <= 256. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int paged_decode_attention(const void* q, const void* pages_k, const void* pages_v,
                                      const void* block_table, const void* lengths,
                                      void* part_acc, void* part_ml, void* out, int lanes, int H,
                                      int Hk, int hd, int bs, int MB, int tile, float scale,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_table);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pages_k, pages_v, bt, ln, part_acc, part_ml, out, lanes, H,
                                 Hk, hd, bs, MB, tile, scale, s);
  if (dtype == 0)
    return launch<float>(q, pages_k, pages_v, bt, ln, part_acc, part_ml, out, lanes, H, Hk, hd,
                         bs, MB, tile, scale, s);
  return (int)cudaErrorInvalidValue;
}
