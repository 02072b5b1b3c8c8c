// The numerics sentinels' reduction for Hopper (sm_90a): one launch reads a
// list of tensors once and gives, for each, its sum of squares (f32), the
// wrapping 32-bit sum of its elements' f32 bit patterns (the digest) and its
// count of NaN and Inf elements. Bound through a plain C interface and
// loaded with ctypes by paddle_tpu_torch/ops/sentinels.py.
//
// Replaces no TPU kernel: the reference computes its sentinels inside its
// compiled training step (paddle_tpu/profiler/numerics.py `sentinel_tree`),
// where XLA fuses the reads into the step's program. Composed of eager torch
// ops, the same values take a pass over each tensor for the norm, one for
// the digest and a mask and its sum for the count: about four times the
// bytes of one read.
//
// Semantics: a bf16 or fp16 element widens to f32 exactly; the square is
// summed in f32 (a fused multiply-add a element), NaN and Inf propagating;
// the digest of an element is the u32 of its f32 bits (a bf16's bits shifted
// left by 16), summed modulo 2^32; the count tests the exponent field (all
// ones: NaN or Inf). The sums are taken in a fixed order (per chunk: each
// thread's elements in order, then the warps' in order; per tensor: its
// chunks by a fixed tree), so a call on the same bits gives the same bits.
//
// Bound on the H100: bytes, one read of every element. A block takes a
// chunk of kChunk elements of one tensor (found by a binary search over the
// per-tensor rows the host sends in one copy), four 16-byte vector loads in
// flight a thread when the tensor's base is 16-byte aligned, and writes its
// chunk's three partials; a second kernel of the same call reduces each
// tensor's partials, one block a tensor.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 65536;  // elements a block
constexpr int kUnroll = 4;           // vector loads in flight a thread

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// One tensor; the host builds the same 32-byte row (META in
// ops/sentinels.py, checked through sentinels_abi).
struct Meta {
  const void* p;
  long long n;            // elements, >= 1
  long long first_chunk;  // running sum of ceil(n / kChunk)
  int dtype;
  int pad;
};
static_assert(sizeof(Meta) == 32, "Meta must be the host's 32-byte row");

struct Partial {
  float sq;
  uint32_t dig;
  uint32_t cnt;
  uint32_t pad;
};
static_assert(sizeof(Partial) == 16, "Partial is 16 bytes");

struct Acc {
  float sq = 0.f;
  uint32_t dig = 0u;
  uint32_t cnt = 0u;
};

__device__ __forceinline__ void take_f32(Acc& a, uint32_t bits) {
  const float x = __uint_as_float(bits);
  a.sq = fmaf(x, x, a.sq);
  a.dig += bits;
  a.cnt += (bits & 0x7f800000u) == 0x7f800000u;
}

__device__ __forceinline__ void take_bf16(Acc& a, uint32_t h) {
  take_f32(a, h << 16);
}

__device__ __forceinline__ void take_f16(Acc& a, uint32_t h) {
  const float x = __half2float(__ushort_as_half(static_cast<unsigned short>(h)));
  const uint32_t bits = __float_as_uint(x);
  a.sq = fmaf(x, x, a.sq);
  a.dig += bits;
  a.cnt += (h & 0x7c00u) == 0x7c00u;
}

template <int DT>
__device__ __forceinline__ void take16(Acc& a, uint32_t w) {
  if (DT == kBF16) {
    take_bf16(a, w & 0xffffu);
    take_bf16(a, w >> 16);
  } else {
    take_f16(a, w & 0xffffu);
    take_f16(a, w >> 16);
  }
}

template <int DT>
__device__ __forceinline__ void take_vec(Acc& a, uint4 v) {
  if (DT == kF32) {
    take_f32(a, v.x); take_f32(a, v.y); take_f32(a, v.z); take_f32(a, v.w);
  } else {
    take16<DT>(a, v.x); take16<DT>(a, v.y); take16<DT>(a, v.z); take16<DT>(a, v.w);
  }
}

template <int DT>
__device__ void chunk_acc(Acc& a, const Meta& m, long long begin, long long end) {
  // elements a 16-byte vector: 4 f32 or 8 bf16 / fp16
  constexpr int kVec = DT == kF32 ? 4 : 8;
  long long tail = begin;
  if ((reinterpret_cast<uintptr_t>(m.p) & 15) == 0) {
    const long long groups = (end - begin) / kVec;
    const uint4* base = reinterpret_cast<const uint4*>(m.p) + begin / kVec;
    long long g = threadIdx.x;
    for (; g + (kUnroll - 1) * kThreads < groups; g += kUnroll * kThreads) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(base + g + u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) take_vec<DT>(a, v[u]);
    }
    for (; g < groups; g += kThreads) take_vec<DT>(a, __ldg(base + g));
    tail = begin + groups * kVec;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    if (DT == kF32) {
      take_f32(a, static_cast<const uint32_t*>(m.p)[i]);
    } else {
      const uint32_t h = static_cast<const unsigned short*>(m.p)[i];
      if (DT == kBF16) take_bf16(a, h); else take_f16(a, h);
    }
  }
}

// Block-wide sum in a fixed order: each warp's tree, then the warps in
// order by thread 0. Counts add in 64 bits.
struct Acc64 {
  float sq;
  uint32_t dig;
  unsigned long long cnt;
};

__device__ __forceinline__ Acc64 block_sum(Acc64 a) {
  __shared__ Acc64 warps[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    a.sq += __shfl_down_sync(0xffffffffu, a.sq, o);
    a.dig += __shfl_down_sync(0xffffffffu, a.dig, o);
    a.cnt += __shfl_down_sync(0xffffffffu, a.cnt, o);
  }
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = a;
  __syncthreads();
  Acc64 s = warps[0];
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      s.sq += warps[w].sq;
      s.dig += warps[w].dig;
      s.cnt += warps[w].cnt;
    }
  }
  return s;  // thread 0's is the block's
}

// One block a chunk; block b reads chunk b - first_chunk of the last
// tensor whose first_chunk <= b.
__global__ void __launch_bounds__(kThreads)
sentinel_stats_kernel(const Meta* __restrict__ meta, int ntensors,
                      Partial* __restrict__ part) {
  const long long chunk = blockIdx.x;
  int lo = 0, hi = ntensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (meta[mid].first_chunk <= chunk) lo = mid; else hi = mid - 1;
  }
  const Meta m = meta[lo];
  const long long begin = (chunk - m.first_chunk) * kChunk;
  const long long end = begin + kChunk < m.n ? begin + kChunk : m.n;
  Acc a;
  switch (m.dtype) {
    case kBF16: chunk_acc<kBF16>(a, m, begin, end); break;
    case kF16: chunk_acc<kF16>(a, m, begin, end); break;
    default: chunk_acc<kF32>(a, m, begin, end); break;
  }
  const Acc64 s = block_sum(Acc64{a.sq, a.dig, a.cnt});
  if (threadIdx.x == 0) part[chunk] = Partial{s.sq, s.dig, static_cast<uint32_t>(s.cnt), 0u};
}

// One block a tensor: thread i takes its chunks i, i + kThreads, ... in order.
__global__ void __launch_bounds__(kThreads)
sentinel_finish_kernel(const Meta* __restrict__ meta, int ntensors, long long nchunks,
                       const Partial* __restrict__ part, float* __restrict__ out_sq,
                       long long* __restrict__ out_int) {
  const int t = blockIdx.x;
  const long long first = meta[t].first_chunk;
  const long long last = t + 1 < ntensors ? meta[t + 1].first_chunk : nchunks;
  Acc64 a{0.f, 0u, 0ull};
  for (long long c = first + threadIdx.x; c < last; c += kThreads) {
    const Partial p = part[c];
    a.sq += p.sq;
    a.dig += p.dig;
    a.cnt += p.cnt;
  }
  const Acc64 s = block_sum(a);
  if (threadIdx.x == 0) {
    out_sq[t] = s.sq;
    out_int[t] = static_cast<long long>(s.dig);
    out_int[ntensors + t] = static_cast<long long>(s.cnt);
  }
}

}  // namespace

// The layout constants the host must share: sizeof(Meta), kChunk, sizeof(Partial).
extern "C" void sentinels_abi(long long* out) {
  out[0] = (long long)sizeof(Meta);
  out[1] = kChunk;
  out[2] = (long long)sizeof(Partial);
}

// meta: ntensors Meta rows in device memory (each n >= 1, first_chunk the
// running sum of ceil(n / kChunk) from 0), nchunks their total; part:
// nchunks Partial rows of scratch; out_sq: ntensors floats; out_int: 2 *
// ntensors long longs (the digests, then the counts). Returns the
// cudaError_t of the launches (0 on success).
extern "C" int sentinel_stats(const void* meta, int ntensors, long long nchunks, void* part,
                              void* out_sq, void* out_int, void* stream) {
  if (ntensors < 1 || nchunks < 1 || nchunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Meta* m = static_cast<const Meta*>(meta);
  sentinel_stats_kernel<<<(unsigned)nchunks, kThreads, 0, st>>>(m, ntensors,
                                                                static_cast<Partial*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sentinel_finish_kernel<<<ntensors, kThreads, 0, st>>>(
      m, ntensors, nchunks, static_cast<const Partial*>(part), static_cast<float*>(out_sq),
      static_cast<long long*>(out_int));
  return (int)cudaGetLastError();
}
