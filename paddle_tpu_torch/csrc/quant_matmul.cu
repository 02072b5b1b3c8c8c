// Int8 weight-only GEMM for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes by paddle_tpu_torch/ops/quant_matmul.py.
//
// Replaces: paddle_tpu/ops/pallas/quant_matmul.py:116 `int8_matmul` (its
// forward body `_fwd_kernel`, :56-70), which the serving engine reaches
// through `matmul_gate` and `decode_matmul` for every projection of an
// int8 engine, and which `nn.quant` fine-tuning reaches for every frozen
// projection, and `_dx_pallas` (:143-162, body `_bwd_dx_kernel` :73-87),
// its backward dX. Computes out[M, N] = T((x[M, K] @ W[K, N]) * scales[N])
// for x of type T (bf16 or f32): each product is exact in f32, products are
// summed in f32 over K, the sum is multiplied by the per-output-channel
// scale in f32 and cast to T once.
//
// Two designs, switched by M as the reference's `_fwd_blocks` (:98-113)
// switches to compute-shaped blocks past M = 64:
// - M <= 64, the weight stream (bound by the weight bytes);
// - M > 64 and dX, the tensor-core kernel (bound by operations), below.

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// the weight stream, M <= 64
// ---------------------------------------------------------------------------
//
// Bound on the H100: bytes. At decode sizes (M = lanes, or a prefill chunk)
// the weight matrix is the traffic, one byte per element against
// 3.35 TB/s; 2 x M FLOPs per weight byte stays far under the ridge point.
//
// Design: a block of 256 threads owns 128 output columns for a tile of MT
// rows of x and one slice of K. W streams through a ring of shared-memory
// stages (64 rows x 128 columns, 16-byte cp.async per thread, several
// stages in flight), so the loads in flight do not depend on registers,
// which the MT x 4 f32 sums of each thread need. The x tile is widened to
// f32 once (a copy for f32 x), into shared memory, transposed so the MT
// values of one k are vector loads. Each thread takes 4 columns of a W row
// per step (a warp reads one 128-byte row segment, conflict-free), widens
// the bytes to f32 with a byte-permute into the mantissa of 2^23 (exact for
// int8, no int-to-float conversions) and accumulates with FMAs. The 8 row
// groups (one per warp) of a block are summed through shared memory in a
// fixed order. When K is split over several blocks to fill the SMs, each
// slice writes an f32 partial and a second kernel adds the slices in order,
// applies the scale and casts, so the result does not depend on
// scheduling. Rows of x past M and rows of W past K are zeros in shared
// memory and never stored, so any M is taken. Not done yet: TMA, a
// persistent schedule.

constexpr int kThreads = 256;
constexpr int kCols = 128;       // output columns per block
constexpr int kColThreads = 32;  // threads across one row segment, 4 columns each
constexpr int kRowGroups = kThreads / kColThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;          // W rows per pipeline stage (8 KB)
constexpr int kStages = 4;
constexpr int kCopies = kBK * kCols / 16 / kThreads;  // 16-byte copies per thread per stage

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const T* __restrict__ x,               // [M, K]
                 const int8_t* __restrict__ w,          // [K, N]
                 const float* __restrict__ scales,      // [N]
                 float* __restrict__ partial,           // [ksplit, M, N] or null
                 T* __restrict__ out,                   // [M, N]
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
    xs[kk * MT + mm] = (m < M && kk < klen) ? to_f32(x[(size_t)m * K + k0 + kk]) : 0.f;
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
        out[(size_t)gm * N + gn] = from_f32<T>(s * scales[gn]);
    }
  }
}

template <typename T>
__global__ void finalize_kernel(const float* __restrict__ partial, const float* __restrict__ scales,
                                T* __restrict__ out, int M, int N, int ksplit) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < ksplit; ++sp) s += partial[(size_t)sp * total + i];
  out[i] = from_f32<T>(s * scales[i % N]);
}

template <typename T, int MT>
int launch(const void* x, const void* w, const void* scales, void* partial, void* out, int M,
           int K, int N, int kc, int ksplit, cudaStream_t stream) {
  const size_t smem = smem_of<MT>(kc);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(int8_gemm_kernel<T, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + kCols - 1) / kCols, ksplit, (M + MT - 1) / MT);
  float* part = ksplit > 1 ? static_cast<float*>(partial) : nullptr;
  int8_gemm_kernel<T, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), part, static_cast<T*>(out), M, K, N, kc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ksplit == 1) return (int)e;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  finalize_kernel<T><<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
      part, static_cast<const float*>(scales), static_cast<T*>(out), M, N, ksplit);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stream(const void* x, const void* w, const void* scales, void* partial, void* out,
                  int M, int K, int N, int mt, int kc, int ksplit, cudaStream_t s) {
  switch (mt) {
    case 1: return launch<T, 1>(x, w, scales, partial, out, M, K, N, kc, ksplit, s);
    case 2: return launch<T, 2>(x, w, scales, partial, out, M, K, N, kc, ksplit, s);
    case 4: return launch<T, 4>(x, w, scales, partial, out, M, K, N, kc, ksplit, s);
    case 8: return launch<T, 8>(x, w, scales, partial, out, M, K, N, kc, ksplit, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the tensor-core kernel: the forward for M > 64 and the backward dX
// ---------------------------------------------------------------------------
//
// Forward, large M (the `m > 64` branch of `_fwd_blocks`, same
// `_fwd_kernel` :56-70): out[M, N] = T((x[M, K] @ W[K, N]) * scales[N]).
// dX (`_bwd_dx_kernel` :73-87): dx[M, K] = T(sum_n g[m, n] W[k, n]) with
// g = bf16(dO * bf16(s)) for bf16 dO, rounded there as the TPU kernel
// rounds `do * sb`; the scale runs along dX's reduction axis and cannot
// move past the sum, so a pre-pass (`prepass_kernel`) writes g, one bf16x2
// multiply rounding each exact product once. Both are one GEMM out[rows,
// C] = A[rows, R] @ B[R, C] with B the int8 W: the forward reads B[r][c] =
// W[r, c] (R = K, C = N), dX reads B[r][c] = W[c, r] (R = N, C = K).
//
// f32 activations (the reference's `_dot` at Precision.HIGHEST) run on the
// same kernel through an exact split: an int8 weight is exact in bf16, and
// x = h + m + l with h = bf16(x), m = bf16(x - h), l = bf16(x - h - m)
// carries all 24 bits of an f32, so x @ W = h @ W + m @ W + l @ W, three
// bf16 reductions into one f32 accumulator. The pre-pass writes the pieces
// as [3, rows, R] bf16 (for dX from g = dO * s formed in f32, as the
// reference's `do * sb` rounds there) and the kernel walks them as a third
// dimension of its activation tensor map. Output is f32.
//
// Bound on the H100: operations. At Llama-3-8B training shapes (M = 8192
// tokens) each call does 2 M K N FLOPs against 989 TFLOP/s bf16 (the f32
// split three times that), and its bytes take a twentieth of that.
//
// Design (wgmma fed by TMA, warp-specialised; the machinery of
// flash_attention.cu):
// - A block owns a 256 x 128 output tile: two consumer warpgroups of 128
//   rows each (two m64n128k16 accumulators, 128 f32 registers a thread),
//   so each int8 W tile is widened once per 256 rows.
// - The reduction runs in stages of 64 through a ring of four: the
//   activation tile [256 x 64] bf16 (one 128-byte swizzled box) and the
//   int8 W tile arrive by TMA (one thread of the producer warpgroup issues
//   both on one full barrier); the other three producer warps widen the W
//   tile to bf16 (exact: a byte-permute into the mantissa of 2^23, a
//   subtraction, and the f32's high half) into a 128-byte swizzled tile in
//   the layout wgmma's B descriptor reads: the forward's W is MN-major (N
//   contiguous, read transposed, two 64-column boxes one leading-byte
//   offset apart), dX's is K-major. They fence the generic-proxy writes for
//   the async proxy and arrive on the stage's ready barrier; the consumers
//   wait for it, issue the stage's eight wgmma, keep one stage's group in
//   flight and release the stage before it (one arrival per warp).
// - Epilogue from the registers: the forward multiplies by the column's
//   scale in f32 and casts once, dX only casts. No split of the reduction,
//   so each output is one accumulator's sum in a fixed order.
// - Block order: groups of 8 row tiles walked column tile by column tile,
//   so the activation rows and W columns in flight stay in L2.
// - Rows past M and reduction columns past R are zero-filled by TMA and
//   never stored, so any M is taken; K and N are multiples of 16.
// What bounds it: the producer side, the TMA loads and the widening (a copy
// that skips the products takes 4.75 ms of the forward's 6.87, below), not
// the tensor cores; a stage also moves ~160 KB through shared memory for
// 4.2 MFLOP, where a bf16 GEMM's 128 x 256 tile moves ~128 KB.
// Tried on the H100 (80GB HBM3, 700 W), one Llama-3-8B layer's seven
// projections at M = 8192 (kernel_ab --quant), cuBLAS 4.59-4.81 ms each way:
// - this design with dX's dO scaled in place by two producer warps (a
//   third widening) and four stages: 7.28 / 9.42 ms (three stages: 8.03 /
//   9.83);
// - dX scaling dO in registers (ldmatrix, then wgmma with A from
//   registers): 11.04-11.78 ms, ptxas serialises the wgmma (C7513);
// - W loaded by the producer warps straight into registers, one stage
//   ahead, instead of by TMA: 8.96 / 13.76 ms; with a 128 x 256 tile (one
//   m64n256 accumulator a consumer, twice the widening per FLOP): 11.88 /
//   16.66 ms;
// - dX with all three warps widening and two of them then scaling (each
//   thread's two jobs in series): 13.02-13.24 ms;
// - what bounds this design, by copies that skip a part (same call,
//   cuBLAS 4.64-4.68 ms): forward 6.87 ms, without the
//   widening 5.36, without the products 4.75; dX 9.30 ms, without the
//   widening 9.25, without the scaling 8.51, without the products 8.27:
//   the producer side (loads, widening, scaling) bounds both;
// - dX's scaling moved into the consumer warpgroups (their own 128 rows,
//   while the stage before's products run, then a named barrier): 10.09
//   ms; a cluster of two blocks on adjacent column tiles, each loading half
//   of the shared activation tile by TMA multicast (half the L2 traffic for
//   it): 12.40 / 14.40 ms;
// - dX's scaling in the producer warps, in place in the activation tile
//   (one warp widening while two scale): 9.27802 ms in chip_smoke.py's
//   phase 8 (forward 7.06748, its yardsticks 6.00615 / 6.66771); with
//   the pre-pass instead, the producer warps only widening: dX 6.88868
//   ms with its pre-pass (0.48635 of it), forward 6.79203 (yardsticks
//   6.03173 / 6.66303), 500-550 TFLOP/s at the gate, up and down shapes;
// - then all four producer warps widening, the TMA loads issued by the
//   first consumer thread after each release: 6.78 / 7.16 ms against this
//   design's 7.01 / 7.06 in the same call, within the spread.
// Not done yet: a persistent schedule with the epilogue overlapping the
// next tile's loads, stores through shared memory, clusters sharing the
// widened W tile.

namespace tc {

constexpr int kWG = 128;
constexpr int kThreads = 3 * kWG;           // producer + two consumers
constexpr int kConsumerWarps = 8;           // arrivals that empty a stage
constexpr int kHelperWarps = 3;             // producer warps that load and widen W
constexpr int kHelpers = 32 * kHelperWarps;

constexpr int kBM = 256;                    // output rows of a block
constexpr int kBN = 128;                    // output columns of a block
constexpr int kHalves = kBM / 128;          // m64 row blocks of a consumer
constexpr int kBK = 64;                     // reduction depth of a stage
constexpr int kStages = 4;
constexpr int kGroup = 8;                   // row tiles per group of the block order
constexpr int kABytes = kBM * kBK * 2;      // activation tile, bf16, swizzled
constexpr int kBBytes = kBK * kBN * 2;      // widened W tile, bf16, swizzled
constexpr int kWBytes = kBK * kBN;          // raw W tile, int8
constexpr int kStageBytes = kABytes + kBBytes + kWBytes;
constexpr int kBar = kStages * kStageBytes;
constexpr int kSmem = kBar + 128 + 1024;    // barriers, alignment slack
constexpr int kUnits = kWBytes / 16;        // 16-byte pieces of a raw W tile
constexpr int kTmaError = 10000;            // + CUresult of a failed tensor map

static_assert(kStageBytes % 1024 == 0 && kABytes % 1024 == 0, "swizzled tiles align to 1024");

struct Args {
  const float* scales;
  void* out;
  int M, R, C;
  int pieces;    // activation pieces summed (1, or 3 for the f32 split)
};

// 16 int8 -> 16 bf16 (exact), in order, as two 16-byte vectors. The f32
// value of an int8 has its low 16 bits zero, so its bf16 is its high half.
__device__ __forceinline__ void widen16(const uint4& v, uint4* out) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    widen4(w[i], f);
    o[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    o[2 * i + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  }
}

// The raw W tile (forward [64 r][128 c], dX [128 c][64 r], int8, packed
// rows, as TMA lands it) to the swizzled bf16 B tile (forward: two boxes of
// 64 columns c by 64 rows r; dX: one box of 128 rows c by 64 columns r),
// pieces t, t + kHelpers, ... of 16 int8 each; every load is issued before
// the first store.
template <bool kDx>
__device__ __forceinline__ void widen_tile(const unsigned char* raw, unsigned char* b, int t) {
  constexpr int kPerRow = kDx ? kBK / 16 : kBN / 16;
  constexpr int kStride = kHelpers;
  constexpr int kIters = (kUnits + kStride - 1) / kStride;
  uint4 v[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int u = t + i * kStride;
    if (u < kUnits) v[i] = *reinterpret_cast<const uint4*>(raw + u * 16);
  }
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int u = t + i * kStride;
    if (u >= kUnits) break;
    const int row = u / kPerRow, col16 = u % kPerRow;
    uint4 h[2];
    widen16(v[i], h);
    unsigned char* rp = b + (kDx ? 0 : (col16 >> 2) * (kBK * 128)) + row * 128;
    const int ch = (col16 & 3) * 2, sw = row & 7;
    *reinterpret_cast<uint4*>(rp + ((ch ^ sw) << 4)) = h[0];
    *reinterpret_cast<uint4*>(rp + (((ch + 1) ^ sw) << 4)) = h[1];
  }
}

template <typename OutT>
__device__ __forceinline__ void store2(OutT* p, float a, float b) {
  if constexpr (std::is_same<OutT, float>::value)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *reinterpret_cast<uint32_t*>(p) = pack2<__nv_bfloat16>(a, b);
}

template <bool kDx, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    int8_tc_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                   const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kBar);  // [kStages] TMA landed
  uint64_t* ready = full + kStages;                          // [kStages] B widened
  uint64_t* empty = ready + kStages;                         // [kStages] consumed

  // block order: groups of kGroup row tiles, walked column tile by column tile
  const int mtiles = (a.M + kBM - 1) / kBM;
  const int ctiles = (a.C + kBN - 1) / kBN;
  const int per_group = kGroup * ctiles;
  const int grp = blockIdx.x / per_group;
  const int first = grp * kGroup;
  const int gsize = min(mtiles - first, kGroup);
  const int in = blockIdx.x - grp * per_group;
  const int m0 = (first + in % gsize) * kBM;
  const int c0 = (in / gsize) * kBN;
  const int nk = (a.R + kBK - 1) / kBK;
  const int total = nk * a.pieces;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(ready + i, kHelperWarps);
      mbar_init(empty + i, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    if (lane == 0) {
      for (int it = 0; it < total; ++it) {
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int k0 = (it % nk) * kBK;
        unsigned char* base = sm + st * kStageBytes;
        mbar_wait(empty + st, ph ^ 1);
        mbar_expect_tx(full + st, kABytes + kWBytes);
        tma_load_3d(base, &ta, full + st, k0, m0, it / nk);
        if (kDx)
          tma_load_2d(base + kABytes + kBBytes, &tw, full + st, k0, c0);
        else
          tma_load_2d(base + kABytes + kBBytes, &tw, full + st, c0, k0);
      }
    }
  } else if (warp < 1 + kHelperWarps) {
    const int ht = threadIdx.x - 32;
    for (int it = 0; it < total; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      unsigned char* base = sm + st * kStageBytes;
      mbar_wait(full + st, ph);
      widen_tile<kDx>(base + kABytes + kBBytes, base + kABytes, ht);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(ready + st);
    }
  } else {
    const int c = warp / 4 - 1;                    // rows c * kBM / 2 .. of the block
    float acc[kHalves][kBN / 2];
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[h][i] = 0.f;

    for (int it = 0; it < total; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const uint32_t as = smem_u32(sm + st * kStageBytes) + c * (kBM / 2) * 128;
      const uint32_t bs = smem_u32(sm + st * kStageBytes + kABytes);
      mbar_wait(full + st, ph);
      mbar_wait(ready + st, ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = kDx ? kmajor(bs + kk * 32) : mnmajor(bs + kk * 16 * 128, kBK * 128);
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
          Mma<__nv_bfloat16, kBN>::template ss<kDx ? 0 : 1>(
              acc[h], kmajor(as + h * 64 * 128 + kk * 32), db, 1);
      }
      wg_commit();
      wg_wait<1>();                                // the stage before is read
      if (it > 0) release(empty + (it - 1) % kStages);
    }
    wg_wait<0>();
#pragma unroll
    for (int h = 0; h < kHalves; ++h) fence_regs(acc[h]);

    const int t = threadIdx.x % kWG, t4 = t % 4;
    const int row0 = m0 + c * (kBM / 2) + (t / 32) * 16 + (t % 32) / 4;   // and + 8
    OutT* out = static_cast<OutT*>(a.out);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = c0 + 8 * j + 2 * t4;
      if (col >= a.C) continue;
      float s0 = 1.f, s1 = 1.f;
      if constexpr (!kDx) {
        s0 = a.scales[col];
        s1 = a.scales[col + 1];
      }
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 64 * h + 8 * r;
          if (row < a.M)
            store2<OutT>(out + (size_t)row * a.C + col, acc[h][4 * j + 2 * r] * s0,
                         acc[h][4 * j + 2 * r + 1] * s1);
        }
    }
  }
}

// The activation map: [pieces, rows, R] bf16 as (R, rows, pieces), boxes of
// 64 x 256 x 1, 128-byte swizzle. The W map: [K, N] int8 as (N, K), boxes
// of 128 x 64 (forward: 64 rows of W, 128 columns) or 64 x 128 (dX: 128
// rows of W, 64 columns), unswizzled. Reads past an edge give zeros.
int map_a(CUtensorMap* map, const void* base, int pieces, int rows, int R) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTmaError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)R, (cuuint64_t)rows, (cuuint64_t)pieces};
  const cuuint64_t strides[2] = {(cuuint64_t)R * 2, (cuuint64_t)rows * R * 2};
  const cuuint32_t box[3] = {kBK, kBM, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTmaError + (int)r;
}

int map_w(CUtensorMap* map, const void* w, int K, int N, bool dx) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTmaError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {dx ? (cuuint32_t)kBK : (cuuint32_t)kBN,
                             dx ? (cuuint32_t)kBN : (cuuint32_t)kBK};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTmaError + (int)r;
}

template <bool kDx, typename OutT>
int launch_tc(const void* act, int pieces, const void* w, const void* scales, void* out, int M,
              int K, int N, cudaStream_t stream) {
  const int R = kDx ? N : K, C = kDx ? K : N;
  CUtensorMap ma, mw;
  if (int e = map_a(&ma, act, pieces, M, R)) return e;
  if (int e = map_w(&mw, w, K, N, kDx)) return e;
  auto kernel = int8_tc_kernel<kDx, OutT>;
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmem))
    return (int)e;
  const long long blocks = (long long)((M + kBM - 1) / kBM) * ((C + kBN - 1) / kBN);
  const Args a{static_cast<const float*>(scales), out, M, R, C, pieces};
  kernel<<<(unsigned)blocks, kThreads, kSmem, stream>>>(ma, mw, a);
  return (int)cudaGetLastError();
}

// The pre-pass, 8 consecutive elements of a row a thread (C % 8 == 0):
// - f32 x: v = x (times s[col] in f32 when s is given) -> h, m, l bf16 with
//   v = h + m + l exactly, written to out [3, rows, C];
// - bf16 x (dX): g = bf16(x * bf16(s[col])), one bf16x2 multiply rounding
//   each exact product once, written to out [rows, C].
// Bound on the H100: bytes (read 4 or 2, write 6 or 2 per element).
template <typename T>
__global__ void prepass_kernel(const T* __restrict__ x, const float* __restrict__ s,
                               __nv_bfloat16* __restrict__ out, long long n, int C) {
  constexpr int kVec = 8;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kVec; i < n;
       i += (long long)gridDim.x * blockDim.x * kVec) {
    const int col = (int)(i % C);
    float sv[kVec];
    if (s != nullptr) {
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(s + col));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(s + col + 4));
      sv[0] = s0.x; sv[1] = s0.y; sv[2] = s0.z; sv[3] = s0.w;
      sv[4] = s1.x; sv[5] = s1.y; sv[6] = s1.z; sv[7] = s1.w;
    }
    if constexpr (std::is_same<T, float>::value) {
      const float4 x0 = *reinterpret_cast<const float4*>(x + i);
      const float4 x1 = *reinterpret_cast<const float4*>(x + i + 4);
      const float xv[kVec] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      uint4 ph, pm, pl;
      uint32_t* h = reinterpret_cast<uint32_t*>(&ph);
      uint32_t* m = reinterpret_cast<uint32_t*>(&pm);
      uint32_t* l = reinterpret_cast<uint32_t*>(&pl);
#pragma unroll
      for (int e = 0; e < kVec; e += 2) {
        float v[2], r[2], q[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          v[k] = s != nullptr ? __fmul_rn(xv[e + k], sv[e + k]) : xv[e + k];
          r[k] = __fsub_rn(v[k], __bfloat162float(__float2bfloat16_rn(v[k])));
          q[k] = __fsub_rn(r[k], __bfloat162float(__float2bfloat16_rn(r[k])));
        }
        h[e / 2] = pack2<__nv_bfloat16>(v[0], v[1]);
        m[e / 2] = pack2<__nv_bfloat16>(r[0], r[1]);
        l[e / 2] = pack2<__nv_bfloat16>(q[0], q[1]);
      }
      *reinterpret_cast<uint4*>(out + i) = ph;
      *reinterpret_cast<uint4*>(out + n + i) = pm;
      *reinterpret_cast<uint4*>(out + 2 * n + i) = pl;
    } else {
      uint4 v = *reinterpret_cast<const uint4*>(x + i);
      uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int e = 0; e < kVec / 2; ++e) {
        uint32_t sb = pack2<__nv_bfloat16>(sv[2 * e], sv[2 * e + 1]);
        __nv_bfloat162 g = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&u[e]),
                                   *reinterpret_cast<__nv_bfloat162*>(&sb));
        u[e] = *reinterpret_cast<uint32_t*>(&g);
      }
      *reinterpret_cast<uint4*>(out + i) = v;
    }
  }
}

}  // namespace tc

}  // namespace

// The tensor-core kernel. Forward (dx 0): act [pieces, M, K] bf16, w int8
// [K, N], scales f32 [N] -> out [M, N]. dX (dx 1): act [pieces, M, N] bf16,
// already scaled by the pre-pass -> out [M, K]. out is f32 when out_f32 is
// set, else bf16. The caller has checked K % 16 == 0, N % 16 == 0, 16-byte
// alignment, contiguity and dtypes. Returns the cudaError_t of the launch
// (0 on success), or 10000 + the CUresult of a tensor map the driver
// refused.
extern "C" int int8_matmul_tc(const void* act, int pieces, const void* w, const void* scales,
                              void* out, int M, int K, int N, int dx, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pieces < 1) return (int)cudaErrorInvalidValue;
  if (dx)
    return out_f32 ? tc::launch_tc<true, float>(act, pieces, w, scales, out, M, K, N, s)
                   : tc::launch_tc<true, __nv_bfloat16>(act, pieces, w, scales, out, M, K, N, s);
  return out_f32 ? tc::launch_tc<false, float>(act, pieces, w, scales, out, M, K, N, s)
                 : tc::launch_tc<false, __nv_bfloat16>(act, pieces, w, scales, out, M, K, N, s);
}

// The pre-pass: x [rows, C] (dtype 0 f32: the split into out bf16 [3, rows,
// C], times scales f32 [C] first when not null; dtype 1 bf16: out bf16
// [rows, C] = bf16(x * bf16(scales))). C is a multiple of 8, x and out
// 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int int8_prepass(const void* x, const void* scales, void* out, long long rows, int C,
                            int dtype, void* stream) {
  const long long n = rows * C;
  if (n == 0) return 0;
  if (C % 8 || dtype < 0 || dtype > 1 || (dtype == 1 && scales == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long want = (n / 8 + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 8192 ? want : 8192);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scales);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (dtype == 0)
    tc::prepass_kernel<float><<<blocks, threads, 0, st>>>(static_cast<const float*>(x), s, o, n,
                                                          C);
  else
    tc::prepass_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), s, o, n, C);
  return (int)cudaGetLastError();
}

// The weight stream: x [M, K] (dtype 0 f32, 1 bf16), w int8 [K, N], scales
// f32 [N], out [M, N] of x's type; partial is f32 [ksplit, M, N] scratch
// when ksplit > 1. mt is the row tile (1, 2, 4 or 8); kc is the K slice per
// block (kc * ksplit >= K). The caller has checked K % 16 == 0,
// N % 16 == 0, 16-byte alignment, contiguity and dtypes. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int int8_matmul(const void* x, const void* w, const void* scales, void* partial,
                           void* out, int M, int K, int N, int mt, int kc, int ksplit, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_stream<float>(x, w, scales, partial, out, M, K, N, mt, kc, ksplit, s);
  if (dtype == 1)
    return launch_stream<__nv_bfloat16>(x, w, scales, partial, out, M, K, N, mt, kc, ksplit, s);
  return (int)cudaErrorInvalidValue;
}
