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
// so any M is taken. The wrapper sends M <= 64 here (decode lanes and
// prefill chunks) and larger M to the tensor-core forward below, as the
// reference's `_fwd_blocks` (:98-113) switches to compute-shaped blocks
// past M = 64. Not done yet: TMA, a persistent schedule.
//
// The tensor-core section also holds the backward dX that replaces
// `_dx_pallas` (:143-162, body `_bwd_dx_kernel` :73-87).

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

// ---------------------------------------------------------------------------
// tensor-core kernels: the forward for M > 64 and the backward dX
// ---------------------------------------------------------------------------
//
// Forward, large M (the `m > 64` branch of `_fwd_blocks`, same
// `_fwd_kernel` :56-70): out[M, N] = bf16((x[M, K] @ W[K, N]) * scales[N]).
// dX (`_bwd_dx_kernel` :73-87): dx[M, K] = bf16(sum_n bf16(dO[m, n] *
// bf16(s[n])) * W[k, n]). The scale runs along dX's reduction axis, so it
// is applied to dO while the tile is staged, rounded to bf16 there as the
// TPU kernel rounds `do * sb`, and cannot move past the sum.
//
// Bound on the H100: operations. At Llama-3-8B training shapes (M = 8192
// tokens) each call does 2 M K N FLOPs against 989 TFLOP/s bf16, and its
// bytes take a twentieth of that. So both run their products on the tensor
// cores, as the TPU kernels run theirs on the MXU: mma.sync m16n8k16 (bf16
// operands, f32 sums), the int8 weights widened to bf16 in shared memory
// (exact: |w| <= 128 needs 8 significant bits).
//
// Design, simple and exact first: one block of 4 warps per 128 x 128
// output tile, each warp a 64 x 64 piece (4 x 8 mma tiles, 128 f32 sums a
// thread, two blocks an SM). The reduction runs in stages of 64, double-buffered in shared
// memory: the activation tile (x or dO, bf16) comes by 16-byte cp.async,
// the int8 weight tile through registers (loaded before the products of
// the current stage, widened and stored after them). dX scales its own
// cp.async chunks of dO by bf16(s) in place before the barrier. A operands
// come from shared memory by ldmatrix; B by ldmatrix.trans in the forward
// (the reduction axis K runs down W's rows) and by plain ldmatrix in dX
// (the reduction axis N is contiguous in both operands). The forward's
// epilogue multiplies by scales[n] in f32 and rounds once. Blocks walk the
// output in groups of 16 row tiles, column by column, so the x rows and W
// columns in flight stay in L2. No split of the reduction, so no atomics
// and no second pass: each output is one thread's sum in a fixed order.
// Rows past M, and reduction columns past K or N, are zero-filled and
// never stored, so any M is taken; K and N are multiples of 16.
// Not done yet: wgmma, TMA, a persistent schedule.

namespace tc {

constexpr int kWarpsM = 2;                        // warps along the rows, 64 rows each
constexpr int kWarpsN = 2;                        // warps along the columns
constexpr int kWN = 64;                           // columns of a warp's tile
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kBM = 64 * kWarpsM;                 // output rows per block
constexpr int kBN = kWN * kWarpsN;                // output columns per block
constexpr int kBK = 64;                           // reduction depth of one stage
constexpr int kNT = kWN / 8;                      // 8-column mma tiles of a warp
constexpr int kLdA = kBK + 8;                     // padded activation tile row (bf16)
constexpr int kLdB = kBN + 8;                     // padded row of the forward's W tile
constexpr int kGroup = 16;                        // row tiles per group of the block order

// shared memory: two stages of the activation tile and of the W tile
// (forward [kBK][kLdB], dX [kBN][kLdA])
template <bool kDx>
__host__ __device__ constexpr int b_stage() { return kDx ? kBN * kLdA : kBK * kLdB; }
template <bool kDx>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * (size_t)(kBM * kLdA + b_stage<kDx>()) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ldmatrix: four 8 x 8 b16 matrices; lanes 8 i .. 8 i + 7 give the row
// addresses of matrix i, and register i of every lane receives matrix i's
// fragment (lane 4 g + t: row g, columns 2 t, 2 t + 1; with .trans, of the
// transposed matrix)
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Fragments of mma.m16n8k16 (lane = 4 g + t):
//   A (16 x 16, row major): a0 (g, 2t..2t+1), a1 (g+8, ..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16 x 8, k by n):     b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16 x 8, f32):        c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)
// Row strides of the tiles are multiples of 8 elements and not of 64, so
// the eight 16-byte rows of an 8 x 8 matrix fall in distinct banks.

// A fragment from a row-major tile: rows r0..r0+15, columns c0..c0+15
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* s, int r0, int c0,
                                       int lane) {
  const int mi = lane >> 3, ri = lane & 7;
  ldsm_x4(a, s + (r0 + ri + (mi & 1) * 8) * LD + c0 + (mi >> 1) * 8);
}

// B fragments of two n-tiles where B[k][n] = M[n][k] of a row-major tile
// M: b[0..1] for M's rows n0..n0+7, b[2..3] for rows n0+8..n0+15, k =
// columns k0..k0+15
template <int LD>
__device__ __forceinline__ void frag_b_rows2(uint32_t* b, const __nv_bfloat16* s, int n0, int k0,
                                             int lane) {
  const int mi = lane >> 3, ri = lane & 7;
  ldsm_x4(b, s + (n0 + ri + (mi >> 1) * 8) * LD + k0 + (mi & 1) * 8);
}

// B fragments of two n-tiles where B[k][n] = M[k][n] of a row-major tile
// M: k = rows k0..k0+15, b[0..1] for columns n0..n0+7, b[2..3] for
// n0+8..n0+15
template <int LD>
__device__ __forceinline__ void frag_b_cols2(uint32_t* b, const __nv_bfloat16* s, int k0, int n0,
                                             int lane) {
  const int mi = lane >> 3, ri = lane & 7;
  ldsm_x4_trans(b, s + (k0 + ri + (mi & 1) * 8) * LD + n0 + (mi >> 1) * 8);
}

// 16 int8 -> 16 bf16 (exact), in order, as two 16-byte vectors
__device__ __forceinline__ void widen16(const uint4& v, uint4* out) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    widen4(w[i], f);
    o[2 * i] = pack2(f[0], f[1]);
    o[2 * i + 1] = pack2(f[2], f[3]);
  }
}

// The GEMM of both kernels, out[rows, C] = A[rows, R] @ B[R, C] with B the
// int8 W: the forward reads B[r][c] = W[r * C + c] (R = K, C = N), dX reads
// B[r][c] = W[c * R + r] (R = N, C = K), where A = bf16(dO * bf16(s)).
template <bool kDx>
__device__ __forceinline__ void int8_mma_body(const __nv_bfloat16* __restrict__ a,
                                              const int8_t* __restrict__ w,
                                              const float* __restrict__ scales,
                                              __nv_bfloat16* __restrict__ out, int M, int R,
                                              int C) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem4);  // [2][kBM][kLdA]
  __nv_bfloat16* bs = as + 2 * kBM * kLdA;                       // [2][b_stage]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / kWarpsN) * 64, wn = (warp % kWarpsN) * kWN;

  // block order: groups of kGroup row tiles, walked column tile by column tile
  const int mtiles = (M + kBM - 1) / kBM;
  const int ctiles = (C + kBN - 1) / kBN;
  const int per_group = kGroup * ctiles;
  const int grp = blockIdx.x / per_group;
  const int first = grp * kGroup;
  const int gsize = min(mtiles - first, kGroup);
  const int in = blockIdx.x - grp * per_group;
  const int m0 = (first + in % gsize) * kBM;
  const int c0 = (in / gsize) * kBN;

  // activation chunks of this thread: rows a_row + kAStep i, 8 columns at a_col
  constexpr int kAStep = kThreads / 8, kAChunks = kBM / kAStep;
  const int a_row = tid >> 3, a_col = (tid & 7) * 8;
  // W chunks of this thread (16 bytes each): rows w_r + kWStep i of the
  // forward's [kBK][kBN] tile or of dX's [kBN][kBK] tile
  constexpr int kWCpr = (kDx ? kBK : kBN) / 16;   // chunks per tile row
  constexpr int kWStep = kThreads / kWCpr;
  constexpr int kWChunks = (kDx ? kBN : kBK) / kWStep;
  const int w_r = tid / kWCpr, w_c = (tid % kWCpr) * 16;

  uint4 wreg[kWChunks];
  float4 sreg[2];  // dX: the scales of this thread's 8 dO columns

  auto fetch = [&](int r0, int st) {
    __nv_bfloat16* ad = as + st * kBM * kLdA;
    const int col = r0 + a_col;
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int row = m0 + a_row + kAStep * i;
      const bool ok = row < M && col < R;
      const __nv_bfloat16* src = ok ? a + (size_t)row * R + col : a;
      cp_async16(ad + (a_row + kAStep * i) * kLdA + a_col, src, ok ? 16 : 0);
    }
    cp_async_commit();
    if constexpr (kDx) {
      if (col < R) {
        sreg[0] = __ldg(reinterpret_cast<const float4*>(scales + col));
        sreg[1] = __ldg(reinterpret_cast<const float4*>(scales + col + 4));
      } else {
        sreg[0] = sreg[1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      int rr, cc;
      if constexpr (kDx) {
        cc = c0 + w_r + kWStep * i;
        rr = r0 + w_c;
      } else {
        rr = r0 + w_r + kWStep * i;
        cc = c0 + w_c;
      }
      const bool ok = rr < R && cc < C;
      const size_t off = kDx ? (size_t)cc * R + rr : (size_t)rr * C + cc;
      wreg[i] = ok ? __ldg(reinterpret_cast<const uint4*>(w + off)) : make_uint4(0, 0, 0, 0);
    }
  };

  // after the products of the other stage: widen W into stage st, and (dX)
  // scale this thread's landed dO chunks of stage st in place
  auto stage = [&](int st) {
    __nv_bfloat16* bd = bs + st * b_stage<kDx>();
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      uint4 h[2];
      widen16(wreg[i], h);
      __nv_bfloat16* dst = kDx ? bd + (w_r + kWStep * i) * kLdA + w_c
                               : bd + (w_r + kWStep * i) * kLdB + w_c;
      reinterpret_cast<uint4*>(dst)[0] = h[0];
      reinterpret_cast<uint4*>(dst)[1] = h[1];
    }
    cp_async_wait<0>();
    if constexpr (kDx) {
      float sb[8] = {sreg[0].x, sreg[0].y, sreg[0].z, sreg[0].w,
                     sreg[1].x, sreg[1].y, sreg[1].z, sreg[1].w};
#pragma unroll
      for (int e = 0; e < 8; ++e) sb[e] = __bfloat162float(__float2bfloat16_rn(sb[e]));
      __nv_bfloat16* ad = as + st * kBM * kLdA;
#pragma unroll
      for (int i = 0; i < kAChunks; ++i) {
        uint4* p = reinterpret_cast<uint4*>(ad + (a_row + kAStep * i) * kLdA + a_col);
        uint4 v = *p;
        uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u[j]));
          u[j] = pack2(f.x * sb[2 * j], f.y * sb[2 * j + 1]);
        }
        *p = v;
      }
    }
  };

  float acc[4][kNT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (R + kBK - 1) / kBK;
  fetch(0, 0);
  stage(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) fetch((kt + 1) * kBK, cur ^ 1);
    const __nv_bfloat16* ad = as + cur * kBM * kLdA;
    const __nv_bfloat16* bd = bs + cur * b_stage<kDx>();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t b[kNT / 2][4];
#pragma unroll
      for (int j2 = 0; j2 < kNT / 2; ++j2) {
        if constexpr (kDx)
          frag_b_rows2<kLdA>(b[j2], bd, wn + j2 * 16, kk * 16, lane);
        else
          frag_b_cols2<kLdB>(b[j2], bd, kk * 16, wn + j2 * 16, lane);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t af[4];
        frag_a<kLdA>(af, ad, wm + i * 16, kk * 16, lane);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma16816(acc[i][j], af, &b[j >> 1][(j & 1) * 2]);
      }
    }
    if (more) stage(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = c0 + wn + j * 8 + 2 * t;
    if (col >= C) continue;
    float s0 = 1.f, s1 = 1.f;
    if constexpr (!kDx) {
      s0 = scales[col];
      s1 = scales[col + 1];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + 8 * h;
        if (row < M)
          *reinterpret_cast<uint32_t*>(out + (size_t)row * C + col) =
              pack2(acc[i][j][2 * h] * s0, acc[i][j][2 * h + 1] * s1);
      }
    }
  }
}

}  // namespace tc

__global__ void __launch_bounds__(tc::kThreads, 2)
int8_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scales, __nv_bfloat16* __restrict__ out, int M,
                    int K, int N) {
  tc::int8_mma_body<false>(x, w, scales, out, M, K, N);
}

__global__ void __launch_bounds__(tc::kThreads, 2)
int8_dx_mma_kernel(const __nv_bfloat16* __restrict__ dout, const int8_t* __restrict__ w,
                   const float* __restrict__ scales, __nv_bfloat16* __restrict__ dx, int M,
                   int K, int N) {
  tc::int8_mma_body<true>(dout, w, scales, dx, M, N, K);
}

template <bool kDx>
int launch_mma(const void* a, const void* w, const void* scales, void* out, int M, int K, int N,
               cudaStream_t stream) {
  auto kernel = kDx ? int8_dx_mma_kernel : int8_fwd_mma_kernel;
  const size_t smem = tc::smem_bytes<kDx>();
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int cols = kDx ? K : N;
  const long long blocks =
      (long long)((M + tc::kBM - 1) / tc::kBM) * ((cols + tc::kBN - 1) / tc::kBN);
  kernel<<<(unsigned)blocks, tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(out), M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// The forward on tensor cores, for M > 64: x bf16 [M, K], w int8 [K, N],
// scales f32 [N], out bf16 [M, N]. The caller has checked K % 16 == 0,
// N % 16 == 0, 16-byte alignment, contiguity and dtypes. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int int8_matmul_mma(const void* x, const void* w, const void* scales, void* out,
                               int M, int K, int N, void* stream) {
  return launch_mma<false>(x, w, scales, out, M, K, N, static_cast<cudaStream_t>(stream));
}

// dX: dout bf16 [M, N], w int8 [K, N], scales f32 [N] -> dx bf16 [M, K],
// under the same checks.
extern "C" int int8_matmul_dx(const void* dout, const void* w, const void* scales, void* dx,
                              int M, int K, int N, void* stream) {
  return launch_mma<true>(dout, w, scales, dx, M, K, N, static_cast<cudaStream_t>(stream));
}

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
