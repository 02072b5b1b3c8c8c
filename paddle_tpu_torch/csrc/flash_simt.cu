// FlashAttention forward and backward on the CUDA cores (SIMT), for what
// the wgmma kernels of flash_attention.cu do not take: f32 inputs, and any
// head_dim that is a multiple of 8 up to 256 in bf16, fp16 or f32. Bound
// through a plain C interface and loaded with ctypes by
// paddle_tpu_torch/ops/flash_attention.py.
//
// Replaces: the bundled Mosaic `flash_attention` that the reference's gate
// sends f32, sq != sk and other head dims to on a TPU
// (paddle_tpu/ops/pallas/flash_attention.py:112-133), with the interface of
// its own kernels (flash_kernel.py:173 `flash_fwd_partial`, :208
// `flash_bwd_partial`): the forward returns (out, lse), the backward takes
// lse and delta = rowsum(dO * O).
//
// Semantics, those of the wgmma kernels: scores q.k in f32 times `scale`;
// causal aligned bottom-right, as the composed `_sdpa_ref`
// (paddle_tpu/nn/functional/attention.py:38-41): query row i sees keys
// j <= i + (Sk - Sq). A masked score is -1e30, as the composed path masks,
// so a row that sees no key (causal, Sk < Sq) is uniform over all Sk keys:
// its output is the mean of V, its lse -1e30, and in the backward its
// probabilities are 1 / Sk for dV and its dS is 0 (the composed path's
// gradient does not pass its mask). Online softmax statistics in f32; the
// probabilities are rounded to the input type before P.V; O in the input
// type, lse = m + log(l) in f32. The backward recomputes
// P = exp(min(s - lse, 60)), rounds P to the input type for dV += P^T dO
// and dS = P (dP - delta) scale for dK += dS^T Q and dQ += dS K; GQA:
// query head h reads KV head h / (H / Hk), and dK, dV sum their group in
// f32 before one rounding. Deterministic: no atomics, fixed orders.
//
// Bound on the H100: operations, 4 FLOPs per kept (query, key, dim) in the
// forward and 10 in the backward; what this kernel reaches is the SIMT f32
// rate (67 TFLOP/s), a fraction of the tensor cores'. The cheapest
// f32-accurate tensor-core route would be three TF32 products (3xTF32),
// 494.7 / 3 TFLOP/s, which is the bound written beside its times.
//
// Design, simple first: blocks of 128 threads, query and key tiles of 32
// rows, held in shared memory as f32 with an odd row stride (head_dim + 1,
// conflict-free column reads). Four threads share a row: each computes 8 of
// the row's 32 scores (keys t, t + 4, ...), the row statistics reduce over
// the four lanes by shuffles, and each keeps every fourth column of the
// row's output (head_dim / 4 registers at most 64). The forward walks the
// key tiles up to the causal edge (all of them for a tile with a row that
// sees no key); the backward runs a dK/dV kernel (one block per key tile
// and KV head, looping over the group's query heads and the query tiles
// that see it) and a dQ kernel (one block per query tile and head).
// Not done yet: tensor cores (3xTF32 for f32, wgmma for bf16/fp16 at other
// head dims), larger tiles.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kT = 32;                  // rows of a query or key tile
constexpr int kPT = kT + 1;             // row stride of a score tile
constexpr float kNegInf = -1e30f;       // a masked score, as the composed path's
constexpr float kPad = 2.f * kNegInf;   // a key past Sk: weightless even in a row with no key
constexpr float kInit = 4.f * kNegInf;  // the running maximum before the first key
constexpr float kClamp = 60.f;

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

// rows [0, kT) of a [S, D] slice (row stride rs elements) into shared
// memory with row stride ld, f32; rows at or past `valid` are zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, long long rs,
                                          int valid, int D) {
  for (int i = threadIdx.x; i < kT * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = r < valid ? to_f(src[r * rs + d]) : 0.f;
  }
}

// the causal tile range of a query tile at q0: key tiles [0, nk)
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk, int causal) {
  const int all = (Sk + kT - 1) / kT;
  if (!causal) return all;
  const int off = Sk - Sq;
  if (q0 + off < 0) return all;  // a row that sees no key is uniform over all keys
  return min(all, (q0 + kT - 1 + off) / kT + 1);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_simt_fwd_kernel(const FwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* qs = smem;
  float* ks = qs + kT * ld;
  float* vs = ks + kT * ld;
  float* ps = vs + kT * ld;              // [kT][kPT]

  const int tid = threadIdx.x, r = tid / 4, t4 = tid % 4;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const int off = a.Sk - a.Sq, row = q0 + r;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + hk * a.sv.h;
  load_tile<T>(qs, ld, q + q0 * a.sq.s, a.sq.s, a.Sq - q0, D);

  float o[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) o[j] = 0.f;
  float m = kInit, l = 0.f;
  const int nk = key_tiles(q0, a.Sq, a.Sk, a.causal);
  for (int it = 0; it < nk; ++it) {
    const int k0 = it * kT;
    __syncthreads();
    load_tile<T>(ks, ld, k + k0 * a.sk.s, a.sk.s, a.Sk - k0, D);
    load_tile<T>(vs, ld, v + k0 * a.sv.s, a.sv.s, a.Sk - k0, D);
    __syncthreads();

    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r * ld + d];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = fmaf(qv, ks[(t4 + 4 * i) * ld + d], s[i]);
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
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p = expf(s[i] - m);
      l += p;
      ps[r * kPT + t4 + 4 * i] = round_t<T>(p);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[j] *= alpha;
    __syncwarp();  // the row's four threads share a warp
#pragma unroll 4
    for (int c = 0; c < kT; ++c) {
      const float p = ps[r * kPT + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = t4 + 4 * j;
        if (d < D) o[j] = fmaf(p, vs[c * ld + d], o[j]);
      }
    }
    __syncwarp();
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l = fmaxf(l, 1e-30f);
  if (row < a.Sq) {
    T* out = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h + row * a.so.s;
    const float inv = 1.f / l;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = t4 + 4 * j;
      if (d < D) out[d] = from_f<T>(o[j] * inv);
    }
    if (t4 == 0) a.lse[((long long)b * a.H + h) * a.Sq + row] = m + logf(l);
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_simt_bwd_kv_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* ks = smem;
  float* vs = ks + kT * ld;
  float* qs = vs + kT * ld;
  float* dos = qs + kT * ld;
  float* pt = dos + kT * ld;             // P^T [kT keys][kPT]
  float* dst = pt + kT * kPT;            // dS^T
  float* stat = dst + kT * kPT;          // lse [kT], delta [kT]

  const int tid = threadIdx.x, j = tid / 4, t4 = tid % 4;
  const int k0 = blockIdx.x * kT, hk = blockIdx.y, b = blockIdx.z;
  const int rep = a.H / a.Hk, off = a.Sk - a.Sq, krow = k0 + j;
  const float inv_sk = 1.f / a.Sk;
  load_tile<T>(ks, ld, static_cast<const T*>(a.k) + b * a.sk.b + hk * a.sk.h + k0 * a.sk.s,
               a.sk.s, a.Sk - k0, D);
  load_tile<T>(vs, ld, static_cast<const T*>(a.v) + b * a.sv.b + hk * a.sv.h + k0 * a.sv.s,
               a.sv.s, a.Sk - k0, D);

  float dk[NJ], dv[NJ];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) dk[jj] = dv[jj] = 0.f;
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
      __syncthreads();
      load_tile<T>(qs, ld, q + q0 * a.sq.s, a.sq.s, a.Sq - q0, D);
      load_tile<T>(dos, ld, dout + q0 * a.sdo.s, a.sdo.s, a.Sq - q0, D);
      if (tid < kT) {
        const bool ok = q0 + tid < a.Sq;
        stat[tid] = ok ? a.lse[so + q0 + tid] : 0.f;
        stat[kT + tid] = ok ? a.delta[so + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[8], dp[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = dp[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = ks[j * ld + d], vv = vs[j * ld + d];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i] = fmaf(kv, qs[(t4 + 4 * i) * ld + d], s[i]);
          dp[i] = fmaf(vv, dos[(t4 + 4 * i) * ld + d], dp[i]);
        }
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
      __syncwarp();
#pragma unroll 4
      for (int qi = 0; qi < kT; ++qi) {
        const float p = pt[j * kPT + qi], ds = dst[j * kPT + qi];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int d = t4 + 4 * jj;
          if (d < D) {
            dv[jj] = fmaf(p, dos[qi * ld + d], dv[jj]);
            dk[jj] = fmaf(ds, qs[qi * ld + d], dk[jj]);
          }
        }
      }
      __syncwarp();
    }
  }
  if (krow < a.Sk) {
    T* gk = static_cast<T*>(a.dk) + b * a.sdk.b + hk * a.sdk.h + krow * a.sdk.s;
    T* gv = static_cast<T*>(a.dv) + b * a.sdv.b + hk * a.sdv.h + krow * a.sdv.s;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = t4 + 4 * jj;
      if (d < D) {
        gk[d] = from_f<T>(dk[jj]);
        gv[d] = from_f<T>(dv[jj]);
      }
    }
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_simt_bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* qs = smem;
  float* dos = qs + kT * ld;
  float* ks = dos + kT * ld;
  float* vs = ks + kT * ld;
  float* dss = vs + kT * ld;             // dS [kT][kPT]

  const int tid = threadIdx.x, r = tid / 4, t4 = tid % 4;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const int off = a.Sk - a.Sq, row = q0 + r;
  load_tile<T>(qs, ld, static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h + q0 * a.sq.s,
               a.sq.s, a.Sq - q0, D);
  load_tile<T>(dos, ld,
               static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h + q0 * a.sdo.s,
               a.sdo.s, a.Sq - q0, D);
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + hk * a.sv.h;
  const long long si = ((long long)b * a.H + h) * a.Sq + row;
  const float lse = row < a.Sq ? a.lse[si] : 0.f;
  const float delta = row < a.Sq ? a.delta[si] : 0.f;

  float dq[NJ];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) dq[jj] = 0.f;
  // key tiles this query tile sees (none for a tile of rows that see no key)
  int nk = (a.Sk + kT - 1) / kT;
  if (a.causal) {
    const int last = q0 + kT - 1 + off;
    nk = last < 0 ? 0 : min(nk, last / kT + 1);
  }
  for (int it = 0; it < nk; ++it) {
    const int k0 = it * kT;
    __syncthreads();
    load_tile<T>(ks, ld, k + k0 * a.sk.s, a.sk.s, a.Sk - k0, D);
    load_tile<T>(vs, ld, v + k0 * a.sv.s, a.sv.s, a.Sk - k0, D);
    __syncthreads();
    float s[8], dp[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r * ld + d], gv = dos[r * ld + d];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i] = fmaf(qv, ks[(t4 + 4 * i) * ld + d], s[i]);
        dp[i] = fmaf(gv, vs[(t4 + 4 * i) * ld + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = k0 + t4 + 4 * i;
      const bool keep = row < a.Sq && col < a.Sk && !(a.causal && col > row + off);
      const float p = keep ? expf(fminf(s[i] * a.scale - lse, kClamp)) : 0.f;
      dss[r * kPT + t4 + 4 * i] = round_t<T>(p * (dp[i] - delta) * a.scale);
    }
    __syncwarp();
#pragma unroll 4
    for (int c = 0; c < kT; ++c) {
      const float ds = dss[r * kPT + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = t4 + 4 * jj;
        if (d < D) dq[jj] = fmaf(ds, ks[c * ld + d], dq[jj]);
      }
    }
    __syncwarp();
  }
  if (row < a.Sq) {
    T* g = static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h + row * a.sdq.s;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = t4 + 4 * jj;
      if (d < D) g[d] = from_f<T>(dq[jj]);
    }
  }
}

size_t fwd_smem(int D) { return (size_t)(3 * kT * (D + 1) + kT * kPT) * sizeof(float); }
size_t kv_smem(int D) {
  return (size_t)(4 * kT * (D + 1) + 2 * kT * kPT + 2 * kT) * sizeof(float);
}
size_t dq_smem(int D) { return (size_t)(4 * kT * (D + 1) + kT * kPT) * sizeof(float); }

template <typename T, int NJ>
int run_fwd(const FwdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = fwd_smem(a.D);
  auto kernel = flash_simt_fwd_kernel<T, NJ>;
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem))
    return (int)e;
  kernel<<<dim3((a.Sq + kT - 1) / kT, a.H, B), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int NJ>
int run_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  auto kv = flash_simt_bwd_kv_kernel<T, NJ>;
  auto dq = flash_simt_bwd_dq_kernel<T, NJ>;
  const size_t skv = kv_smem(a.D), sdq = dq_smem(a.D);
  if (cudaError_t e = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)skv))
    return (int)e;
  if (cudaError_t e = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)sdq))
    return (int)e;
  kv<<<dim3((a.Sk + kT - 1) / kT, a.Hk, B), kThreads, skv, stream>>>(a);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  dq<<<dim3((a.Sq + kT - 1) / kT, a.H, B), kThreads, sdq, stream>>>(a);
  return (int)cudaGetLastError();
}

// the instantiation for dtype (1 bf16, 2 fp16, 3 f32) and head_dim (a
// multiple of 8 up to 256): head_dim / 4 output columns a thread, at most
template <typename F>
int dispatch(int dtype, int D, F&& f) {
  if (D <= 0 || D % 8 || D > 256) return (int)cudaErrorInvalidValue;
  auto by_d = [&](auto tv) {
    if (D <= 64) return f(tv, std::integral_constant<int, 16>{});
    if (D <= 128) return f(tv, std::integral_constant<int, 32>{});
    return f(tv, std::integral_constant<int, 64>{});
  };
  if (dtype == 1) return by_d(__nv_bfloat16{});
  if (dtype == 2) return by_d(__half{});
  if (dtype == 3) return by_d(float{});
  return (int)cudaErrorInvalidValue;
}

Strides strides_of(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

}  // namespace

// q/o [B, Sq, H, D], k/v [B, Sk, Hk, D] with unit stride along D; strides
// holds the (batch, seq, head) element strides of q, k, v, o. lse is f32
// [B, H, Sq], contiguous. dtype 1 bf16, 2 fp16, 3 f32; D a multiple of 8 up
// to 256. The caller has checked H % Hk == 0 and the shapes. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_simt_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              const long long* strides, int B, int H, int Hk, int Sq, int Sk,
                              int D, float scale, int causal, int dtype, void* stream) {
  const FwdArgs a{q, k, v, o, static_cast<float*>(lse), strides_of(strides, 0),
                  strides_of(strides, 1), strides_of(strides, 2), strides_of(strides, 3),
                  H, Hk, Sq, Sk, D, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, [&](auto tv, auto nj) {
    return run_fwd<decltype(tv), decltype(nj)::value>(a, B, s);
  });
}

// The backward's two kernels. dout/dq like q, dk/dv like k; lse and delta
// f32 [B, H, Sq]; strides holds (batch, seq, head) of q, k, v, dout, dq,
// dk, dv.
extern "C" int flash_simt_bwd(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dq, void* dk, void* dv,
                              const long long* strides, int B, int H, int Hk, int Sq, int Sk,
                              int D, float scale, int causal, int dtype, void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
                  dq, dk, dv, strides_of(strides, 0), strides_of(strides, 1),
                  strides_of(strides, 2), strides_of(strides, 3), strides_of(strides, 4),
                  strides_of(strides, 5), strides_of(strides, 6), H, Hk, Sq, Sk, D, scale,
                  causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, [&](auto tv, auto nj) {
    return run_bwd<decltype(tv), decltype(nj)::value>(a, B, s);
  });
}
