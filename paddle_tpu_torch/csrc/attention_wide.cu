// Attention past 256 columns, on the CUDA cores (SIMT), for Hopper (sm_90a):
// flash attention forward and backward at head dims past 256, and paged
// decode attention at head dims or pages past 256. Bound through a plain C
// interface and loaded with ctypes by paddle_tpu_torch/ops/flash_attention.py
// and paddle_tpu_torch/ops/paged_attention.py.
//
// Replaces, for the shapes the tensor-core kernels (flash_attention.cu,
// paged_attention.cu: tiles and TMA boxes of at most 256 columns) do not
// take:
// - the bundled Mosaic `flash_attention` that the reference's gate sends
//   any head_dim % 8 == 0 to (paddle_tpu/ops/pallas/flash_attention.py:91,
//   :112-133), with the interface of its own kernels (flash_kernel.py:173
//   `flash_fwd_partial`, :208 `flash_bwd_partial`): the forward returns
//   (out, lse), the backward takes lse and delta = rowsum(dO * O);
// - paddle_tpu/ops/pallas/paged_attention.py:68 `paged_decode_attention`,
//   whose composed path serves any size.
//
// Flash semantics, those of the tensor-core kernels: scores q.k in f32 times
// `scale`; causal aligned bottom-right (query row i sees keys j <= i + Sk -
// Sq); a masked score is -1e30, so a row that sees no key is uniform over
// all Sk keys (out the mean of V, lse -1e30; in the backward P = 1 / Sk for
// dV and dS = 0). Online softmax statistics in f32; P rounded to the input
// type before P.V; the backward recomputes P = exp(min(s - lse, 60)),
// rounds P for dV += P^T dO and dS = P (dP - delta) scale for dK += dS^T Q
// and dQ += dS K; GQA: dK, dV sum their group in f32 before one rounding.
// Deterministic: fixed orders, no atomics.
//
// Bound on the H100: operations (4 FLOPs per kept (query, key, dim)
// forward, 10 backward), here at the SIMT f32 rate, a fraction of the
// tensor cores'; speed is not this kernel's aim (PERF.md).
//
// Flash design, simple first: blocks of 128 threads over tiles of 32 rows,
// four threads a row, each 8 of a tile's 32 scores; the head dim is walked
// in chunks of 128 columns through shared memory (f32, row stride 129, so
// column reads do not conflict), so any head dim fits. A block owns one
// chunk of 128 output columns (a thread 32 of them): blocks of the other
// chunks of the same rows recompute the same scores in the same order, so
// their softmax statistics agree bit for bit. The backward runs a dK/dV
// kernel (a block per key tile, KV head and output chunk, looping over the
// group's heads and the query tiles that see it) and a dQ kernel.
//
// Paged design: a block per (lane, query head), sixteen warps; warp w
// takes the visible slots w, w + 16, ... of the lane, reads each K and V
// row through the block table (a lane of the warp takes columns lane, lane
// + 32, ...), reduces the score by shuffles and keeps its own online
// softmax (max, sum, f32 accumulator); the warps merge in warp order. Each
// warp's slots form a chain of dependent loads and shuffles, so the warps
// of a block are what hides their latency (four warps: 0.59 ms at hd 320,
// ragged lengths, PERF.md). Slots
// 0 .. min(max(length, 0), MB * bs - 1) are visible, as paged_attention.cu
// counts them. No scratch, a grid fixed by the shapes: a CUDA graph holds
// the call.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kT = 32;                  // rows of a query or key tile
constexpr int kPT = kT + 1;             // row stride of a score tile
constexpr int kDc = 128;                // columns of a chunk
constexpr int kLd = kDc + 1;            // row stride of a chunk tile
constexpr int kNJ = kDc / 4;            // output columns a thread
constexpr float kNegInf = -1e30f;       // a masked score, as the composed path's
constexpr float kPad = 2.f * kNegInf;   // a key past Sk: weightless even in a row with no key
constexpr float kInit = 4.f * kNegInf;  // the running maximum before the first key
constexpr float kClamp = 60.f;
constexpr int kMaxHeadDim = 1024;
constexpr int kPagedThreads = 512;
constexpr int kPagedWarps = kPagedThreads / 32;
constexpr int kPagedJ = kMaxHeadDim / 32;

struct Strides {
  long long b, s, h;
};

struct FwdArgs {
  const void* q; const void* k; const void* v; void* o; float* lse;
  Strides sq, sk, sv, so;
  int H, Hk, Sq, Sk, D;
  float scale;
  int causal;
};

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* dout;
  const float* lse; const float* delta;
  void* dq; void* dk; void* dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int H, Hk, Sq, Sk, D;
  float scale;
  int causal;
};

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

// a value rounded to the input type, back in f32
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// rows [0, kT) and columns [d0, d0 + kDc) of a [S, D] slice (row stride rs
// elements) into shared memory, f32; rows at or past `valid` and columns at
// or past D are zeros
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* src, long long rs, int valid,
                                           int d0, int D) {
  for (int i = threadIdx.x; i < kT * kDc; i += kThreads) {
    const int r = i / kDc, d = i - r * kDc;
    dst[r * kLd + d] = r < valid && d0 + d < D ? to_f(src[r * rs + d0 + d]) : 0.f;
  }
}

__device__ __forceinline__ int chunks(int D) { return (D + kDc - 1) / kDc; }

// the causal tile range of a query tile at q0: key tiles [0, nk)
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk, int causal) {
  const int all = (Sk + kT - 1) / kT;
  if (!causal) return all;
  const int off = Sk - Sq;
  if (q0 + off < 0) return all;  // a row that sees no key is uniform over all keys
  return min(all, (q0 + kT - 1 + off) / kT + 1);
}

// s[i] += a[ra] . b[rb(i)] over one chunk: rows of a and b as stored by
// load_chunk, rb(i) = t4 + 4 i
__device__ __forceinline__ void dot_rows(float* s, const float* a, int ra, const float* b,
                                         int t4) {
  for (int d = 0; d < kDc; ++d) {
    const float av = a[ra * kLd + d];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = fmaf(av, b[(t4 + 4 * i) * kLd + d], s[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_wide_fwd_kernel(const FwdArgs a) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kT * kLd;
  float* vs = ks + kT * kLd;
  float* ps = vs + kT * kLd;             // [kT][kPT]

  const int nc = chunks(a.D);
  const int oc = blockIdx.x % nc, q0 = blockIdx.x / nc * kT;
  const int tid = threadIdx.x, r = tid / 4, t4 = tid % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const int off = a.Sk - a.Sq, row = q0 + r;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h + q0 * a.sq.s;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + hk * a.sv.h;

  float o[kNJ];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) o[j] = 0.f;
  float m = kInit, l = 0.f;
  const int nk = key_tiles(q0, a.Sq, a.Sk, a.causal);
  for (int it = 0; it < nk; ++it) {
    const int k0 = it * kT;
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    for (int c = 0; c < nc; ++c) {
      __syncthreads();
      load_chunk<T>(qs, q, a.sq.s, a.Sq - q0, c * kDc, a.D);
      load_chunk<T>(ks, k + k0 * a.sk.s, a.sk.s, a.Sk - k0, c * kDc, a.D);
      __syncthreads();
      dot_rows(s, qs, r, ks, t4);
    }
    float mx = m;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = k0 + t4 + 4 * i;
      s[i] *= a.scale;
      if (col >= a.Sk)
        s[i] = kPad;
      else if (a.causal && col > row + off)
        s[i] = kNegInf;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = expf(m - mx);
    m = mx;
    l *= alpha;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p = expf(s[i] - m);
      l += p;
      ps[r * kPT + t4 + 4 * i] = round_t<T>(p);
    }
    load_chunk<T>(vs, v + k0 * a.sv.s, a.sv.s, a.Sk - k0, oc * kDc, a.D);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kNJ; ++j) o[j] *= alpha;
#pragma unroll 4
    for (int cc = 0; cc < kT; ++cc) {
      const float p = ps[r * kPT + cc];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) o[j] = fmaf(p, vs[cc * kLd + t4 + 4 * j], o[j]);
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l = fmaxf(l, 1e-30f);
  if (row < a.Sq) {
    T* out = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h + row * a.so.s;
    const float inv = 1.f / l;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int d = oc * kDc + t4 + 4 * j;
      if (d < a.D) out[d] = from_f<T>(o[j] * inv);
    }
    if (oc == 0 && t4 == 0) a.lse[((long long)b * a.H + h) * a.Sq + row] = m + logf(l);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_wide_bwd_kv_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kT * kLd;
  float* qs = vs + kT * kLd;
  float* dos = qs + kT * kLd;
  float* pt = dos + kT * kLd;            // P^T [kT keys][kPT]
  float* dst = pt + kT * kPT;            // dS^T
  float* stat = dst + kT * kPT;          // lse [kT], delta [kT]

  const int nc = chunks(a.D);
  const int oc = blockIdx.x % nc, k0 = blockIdx.x / nc * kT;
  const int tid = threadIdx.x, j = tid / 4, t4 = tid % 4;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rep = a.H / a.Hk, off = a.Sk - a.Sq, krow = k0 + j;
  const float inv_sk = 1.f / a.Sk;
  const T* kp = static_cast<const T*>(a.k) + b * a.sk.b + hk * a.sk.h + k0 * a.sk.s;
  const T* vp = static_cast<const T*>(a.v) + b * a.sv.b + hk * a.sv.h + k0 * a.sv.s;

  float dk[kNJ], dv[kNJ];
#pragma unroll
  for (int jj = 0; jj < kNJ; ++jj) dk[jj] = dv[jj] = 0.f;
  const int nq = (a.Sq + kT - 1) / kT;
  // query tiles that see this key tile; with rows that see no key (causal,
  // Sk < Sq), all of them: such rows give dV 1 / Sk of their dO
  int start = 0;
  if (a.causal && off >= 0) start = max(0, k0 - off) / kT;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
    const T* dout = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
    const long long so = ((long long)b * a.H + h) * a.Sq;
    for (int qt = start; qt < nq; ++qt) {
      const int q0 = qt * kT;
      float s[8], dp[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = dp[i] = 0.f;
      for (int c = 0; c < nc; ++c) {
        __syncthreads();
        load_chunk<T>(ks, kp, a.sk.s, a.Sk - k0, c * kDc, a.D);
        load_chunk<T>(vs, vp, a.sv.s, a.Sk - k0, c * kDc, a.D);
        load_chunk<T>(qs, q + q0 * a.sq.s, a.sq.s, a.Sq - q0, c * kDc, a.D);
        load_chunk<T>(dos, dout + q0 * a.sdo.s, a.sdo.s, a.Sq - q0, c * kDc, a.D);
        if (c == 0 && tid < kT) {
          const bool ok = q0 + tid < a.Sq;
          stat[tid] = ok ? a.lse[so + q0 + tid] : 0.f;
          stat[kT + tid] = ok ? a.delta[so + q0 + tid] : 0.f;
        }
        __syncthreads();
        dot_rows(s, ks, j, qs, t4);
        dot_rows(dp, vs, j, dos, t4);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qi = t4 + 4 * i, qrow = q0 + qi;
        const bool valid = qrow < a.Sq;
        const bool masked = a.causal && krow > qrow + off;
        const float p =
            valid && !masked ? expf(fminf(s[i] * a.scale - stat[qi], kClamp)) : 0.f;
        const float pv = valid && masked && qrow + off < 0 ? inv_sk : p;
        pt[j * kPT + qi] = round_t<T>(pv);
        dst[j * kPT + qi] = round_t<T>(p * (dp[i] - stat[kT + qi]) * a.scale);
      }
      __syncthreads();
      load_chunk<T>(qs, q + q0 * a.sq.s, a.sq.s, a.Sq - q0, oc * kDc, a.D);
      load_chunk<T>(dos, dout + q0 * a.sdo.s, a.sdo.s, a.Sq - q0, oc * kDc, a.D);
      __syncthreads();
#pragma unroll 4
      for (int qi = 0; qi < kT; ++qi) {
        const float p = pt[j * kPT + qi], ds = dst[j * kPT + qi];
#pragma unroll
        for (int jj = 0; jj < kNJ; ++jj) {
          dv[jj] = fmaf(p, dos[qi * kLd + t4 + 4 * jj], dv[jj]);
          dk[jj] = fmaf(ds, qs[qi * kLd + t4 + 4 * jj], dk[jj]);
        }
      }
    }
  }
  if (krow < a.Sk) {
    T* gk = static_cast<T*>(a.dk) + b * a.sdk.b + hk * a.sdk.h + krow * a.sdk.s;
    T* gv = static_cast<T*>(a.dv) + b * a.sdv.b + hk * a.sdv.h + krow * a.sdv.s;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      const int d = oc * kDc + t4 + 4 * jj;
      if (d < a.D) {
        gk[d] = from_f<T>(dk[jj]);
        gv[d] = from_f<T>(dv[jj]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_wide_bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kT * kLd;
  float* ks = dos + kT * kLd;
  float* vs = ks + kT * kLd;
  float* dss = vs + kT * kLd;            // dS [kT][kPT]

  const int nc = chunks(a.D);
  const int oc = blockIdx.x % nc, q0 = blockIdx.x / nc * kT;
  const int tid = threadIdx.x, r = tid / 4, t4 = tid % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const int off = a.Sk - a.Sq, row = q0 + r;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h + q0 * a.sq.s;
  const T* dout = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h + q0 * a.sdo.s;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + hk * a.sv.h;
  const long long si = ((long long)b * a.H + h) * a.Sq + row;
  const float lse = row < a.Sq ? a.lse[si] : 0.f;
  const float delta = row < a.Sq ? a.delta[si] : 0.f;

  float dq[kNJ];
#pragma unroll
  for (int jj = 0; jj < kNJ; ++jj) dq[jj] = 0.f;
  // key tiles this query tile sees (none for a tile of rows that see no key)
  int nk = (a.Sk + kT - 1) / kT;
  if (a.causal) {
    const int last = q0 + kT - 1 + off;
    nk = last < 0 ? 0 : min(nk, last / kT + 1);
  }
  for (int it = 0; it < nk; ++it) {
    const int k0 = it * kT;
    float s[8], dp[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = dp[i] = 0.f;
    for (int c = 0; c < nc; ++c) {
      __syncthreads();
      load_chunk<T>(qs, q, a.sq.s, a.Sq - q0, c * kDc, a.D);
      load_chunk<T>(dos, dout, a.sdo.s, a.Sq - q0, c * kDc, a.D);
      load_chunk<T>(ks, k + k0 * a.sk.s, a.sk.s, a.Sk - k0, c * kDc, a.D);
      load_chunk<T>(vs, v + k0 * a.sv.s, a.sv.s, a.Sk - k0, c * kDc, a.D);
      __syncthreads();
      dot_rows(s, qs, r, ks, t4);
      dot_rows(dp, dos, r, vs, t4);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = k0 + t4 + 4 * i;
      const bool keep = row < a.Sq && col < a.Sk && !(a.causal && col > row + off);
      const float p = keep ? expf(fminf(s[i] * a.scale - lse, kClamp)) : 0.f;
      dss[r * kPT + t4 + 4 * i] = round_t<T>(p * (dp[i] - delta) * a.scale);
    }
    load_chunk<T>(ks, k + k0 * a.sk.s, a.sk.s, a.Sk - k0, oc * kDc, a.D);
    __syncthreads();
#pragma unroll 4
    for (int cc = 0; cc < kT; ++cc) {
      const float ds = dss[r * kPT + cc];
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) dq[jj] = fmaf(ds, ks[cc * kLd + t4 + 4 * jj], dq[jj]);
    }
  }
  if (row < a.Sq) {
    T* g = static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h + row * a.sdq.s;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      const int d = oc * kDc + t4 + 4 * jj;
      if (d < a.D) g[d] = from_f<T>(dq[jj]);
    }
  }
}

constexpr size_t kFwdSmem = (size_t)(3 * kT * kLd + kT * kPT) * sizeof(float);
constexpr size_t kKvSmem = (size_t)(4 * kT * kLd + 2 * kT * kPT + 2 * kT) * sizeof(float);
constexpr size_t kDqSmem = (size_t)(4 * kT * kLd + kT * kPT) * sizeof(float);

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T>
int run_fwd(const FwdArgs& a, int B, cudaStream_t stream) {
  auto kernel = flash_wide_fwd_kernel<T>;
  if (int e = set_smem(kernel, kFwdSmem)) return e;
  const int nc = (a.D + kDc - 1) / kDc;
  kernel<<<dim3((a.Sq + kT - 1) / kT * nc, a.H, B), kThreads, kFwdSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  auto kv = flash_wide_bwd_kv_kernel<T>;
  auto dq = flash_wide_bwd_dq_kernel<T>;
  if (int e = set_smem(kv, kKvSmem)) return e;
  if (int e = set_smem(dq, kDqSmem)) return e;
  const int nc = (a.D + kDc - 1) / kDc;
  kv<<<dim3((a.Sk + kT - 1) / kT * nc, a.Hk, B), kThreads, kKvSmem, stream>>>(a);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  dq<<<dim3((a.Sq + kT - 1) / kT * nc, a.H, B), kThreads, kDqSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename F>
int by_dtype(int dtype, int D, F&& f) {
  if (D <= 0 || D % 8 || D > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return f(__nv_bfloat16{});
  if (dtype == 2) return f(__half{});
  if (dtype == 3) return f(float{});
  return (int)cudaErrorInvalidValue;
}

Strides strides_of(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
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

// q/o [B, Sq, H, D], k/v [B, Sk, Hk, D] with unit stride along D; strides
// holds the (batch, seq, head) element strides of q, k, v, o. lse is f32
// [B, H, Sq], contiguous. dtype 1 bf16, 2 fp16, 3 f32; D a multiple of 8 up
// to 1024. The caller has checked H % Hk == 0 and the shapes. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_wide_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              const long long* strides, int B, int H, int Hk, int Sq, int Sk,
                              int D, float scale, int causal, int dtype, void* stream) {
  const FwdArgs a{q, k, v, o, static_cast<float*>(lse), strides_of(strides, 0),
                  strides_of(strides, 1), strides_of(strides, 2), strides_of(strides, 3),
                  H, Hk, Sq, Sk, D, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, D, [&](auto tv) { return run_fwd<decltype(tv)>(a, B, s); });
}

// The backward's two kernels. dout/dq like q, dk/dv like k; lse and delta
// f32 [B, H, Sq]; strides holds (batch, seq, head) of q, k, v, dout, dq,
// dk, dv.
extern "C" int flash_wide_bwd(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dq, void* dk, void* dv,
                              const long long* strides, int B, int H, int Hk, int Sq, int Sk,
                              int D, float scale, int causal, int dtype, void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
                  dq, dk, dv, strides_of(strides, 0), strides_of(strides, 1),
                  strides_of(strides, 2), strides_of(strides, 3), strides_of(strides, 4),
                  strides_of(strides, 5), strides_of(strides, 6), H, Hk, Sq, Sk, D, scale,
                  causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, D, [&](auto tv) { return run_bwd<decltype(tv)>(a, B, s); });
}

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
