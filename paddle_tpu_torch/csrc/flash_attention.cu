// FlashAttention-2 forward and backward for Hopper (sm_90a), bound through a
// plain C interface and loaded with ctypes by
// paddle_tpu_torch/ops/flash_attention.py.
//
// Replaces: paddle_tpu/ops/pallas/flash_kernel.py:173 `flash_fwd_partial`
// (its body `_fwd_kernel`, :48-85) and :208 `flash_bwd_partial` (the dK/dV
// pass `_bwd_dkv_kernel`, :88-129, and the dQ pass `_bwd_dq_kernel`,
// :132-160), which every Llama attention call reaches through
// `flash_attention_bsnd` and the `custom_vjp` of `flash_attention_bhsd`.
// The same function stands for the bundled TPU kernel the gate used when
// its own kernel failed a probe (ops/pallas/flash_attention.py:115-132).
//
// Semantics, as the TPU kernels: scores q.k in f32 from bf16 (or fp16)
// products, times `scale`; causal rows see columns <= row; online softmax
// statistics (m, l) in f32; the probabilities are rounded to the input type
// before the P.V product; O in the input type, lse = m + log(l) in f32. The
// backward takes lse and delta = rowsum(dO * O) (f32), recomputes
// P = exp(min(s - lse, 60)) (the clamp keeps masked or foreign rows finite),
// rounds P to the input type for dV += P^T dO and dS = P (dP - delta) scale
// to the input type for dK += dS^T Q and dQ += dS K.
//
// Bound on the H100: operations. At Llama-3-8B training shapes (S = 8192,
// head_dim 128) a causal forward does 4 S^2 H hd / 2 FLOPs against 989
// TFLOP/s bf16 (0.556 ms per layer), the backward 2.5 times that; the bytes
// (each input read once) take a tenth of it. So the design keeps every
// product on the tensor cores, the S x S scores on chip (registers), and
// does no work above the causal diagonal. The forward runs at about a fifth
// of the bound's rate and the backward an eighth (PERF.md): mma.sync from
// shared memory, not wgmma.
//
// Design, simple and exact first:
// - Layout: q/o [B, S, H, D] and k/v [B, S, Hk, D] read in place through
//   their batch/sequence/head strides (the last dimension is contiguous);
//   query head h reads KV head h / (H / Hk), the head order a repeat of the
//   KV heads gives. K and V are never repeated in memory.
// - Forward: one block of 4 warps per (Q tile of 64 rows, head, batch);
//   each warp owns 16 query rows, held in registers. K/V tiles of 64 rows
//   are staged in shared memory by 16-byte cp.async in two stages, so the
//   next tile's copy overlaps this tile's products. Products are mma.sync
//   m16n8k16 with f32 accumulation, their operands loaded from shared
//   memory by ldmatrix (.trans where the product needs a tile's columns);
//   the score tile stays in registers and becomes the A operand of P.V. A
//   causal block stops at its diagonal tile, and blocks are issued
//   heaviest first.
// - Backward, the reference's two passes, deterministic (no atomics):
//   dK/dV: one block per (K tile, KV head, batch) holds its K and V rows in
//   shared memory and loops over the query heads of its group and over the
//   Q tiles from the causal start, so the group sum of dK and dV happens in
//   the f32 accumulators. dQ: one block per (Q tile, head, batch), its Q and
//   dO fragments held in registers, loops over the K tiles up to the
//   diagonal. Score tiles are taken 32 columns at a time to keep the
//   accumulators within the register file.
// - Any S: rows past S are zero-filled in shared memory, masked, and never
//   stored. head_dim 64 and 128 are compiled.
// Not done yet: wgmma, TMA, warp specialisation, a persistent schedule.
// Tried and dropped in the forward (each slower on the H100): two 16-row
// slices per warp (128-row Q tiles, each K/V fragment feeding two products;
// 255 registers); the Q tile staged in K's second stage (four tiles of
// shared memory) with exp2 scores, with or without skipping the mask on
// interior tiles (188-190 registers, so still two blocks per SM).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;       // rows of a Q or K/V tile
constexpr int kChunk = 32;      // score columns taken at once in the backward
constexpr float kNegInf = -1e30f;
constexpr float kClamp = 60.f;

template <int D>
struct Geo {
  static constexpr int LD = D + 8;                  // padded row, in elements
  static constexpr int kTileElems = kTile * LD;
};

struct Strides {
  long long b, s, h;
};

struct FwdArgs {
  const void* q; const void* k; const void* v; void* o; float* lse;
  Strides sq, sk, sv, so;
  int H, Hk, S;
  float scale;
  int causal;
};

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* dout;
  const float* lse; const float* delta;
  void* dq; void* dk; void* dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int H, Hk, S;
  float scale;
  int causal;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, const uint32_t* b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// two floats rounded to the input type, the lower column in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
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
// Tiles in shared memory are row major with LD elements per row (a multiple
// of 8 and not of 64, so the eight 16-byte rows of an 8 x 8 matrix fall in
// distinct banks).

// A fragment from a row-major tile: rows r0..r0+15, columns c0..c0+15
template <int LD, typename T>
__device__ __forceinline__ void frag_a(uint32_t* a, const T* s, int r0, int c0, int lane) {
  const int mi = lane >> 3, ri = lane & 7;
  ldsm_x4(a, s + (r0 + ri + (mi & 1) * 8) * LD + c0 + (mi >> 1) * 8);
}

// B fragments of two n-tiles where B[k][n] = M[n][k] of a row-major tile M:
// b[0..1] for M's rows n0..n0+7, b[2..3] for rows n0+8..n0+15, k = columns
// k0..k0+15
template <int LD, typename T>
__device__ __forceinline__ void frag_b_rows2(uint32_t* b, const T* s, int n0, int k0, int lane) {
  const int mi = lane >> 3, ri = lane & 7;
  ldsm_x4(b, s + (n0 + ri + (mi >> 1) * 8) * LD + k0 + (mi & 1) * 8);
}

// B fragments of two n-tiles where B[k][n] = M[k][n] of a row-major tile M:
// k = rows k0..k0+15, b[0..1] for columns n0..n0+7, b[2..3] for n0+8..n0+15
template <int LD, typename T>
__device__ __forceinline__ void frag_b_cols2(uint32_t* b, const T* s, int k0, int n0, int lane) {
  const int mi = lane >> 3, ri = lane & 7;
  ldsm_x4_trans(b, s + (k0 + ri + (mi & 1) * 8) * LD + n0 + (mi >> 1) * 8);
}

// A fragment (16 rows x 16 columns) from two 16 x 8 accumulator tiles
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// cp.async a tile of kTile rows x D from global rows row0.. (row stride rs);
// rows at or past S are zero-filled
template <int D, typename T>
__device__ __forceinline__ void load_tile(T* s, const T* g, long long rs, int row0, int S,
                                          int tid) {
  constexpr int kCh = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int c = tid; c < kTile * kCh; c += kThreads) {
    const int r = c / kCh;
    const int ch = c - r * kCh;
    const bool ok = row0 + r < S;
    const T* src = ok ? g + (long long)(row0 + r) * rs + ch * 8 : g;
    cp_async16(s + r * Geo<D>::LD + ch * 8, src, ok ? 16 : 0);
  }
}

// cp.async kTile floats from v[row0..], zeros past S
__device__ __forceinline__ void load_row_stats(float* s, const float* v, int row0, int S,
                                               int tid) {
  if (tid < kTile) {
    const bool ok = row0 + tid < S;
    cp_async4(s + tid, ok ? v + row0 + tid : v, ok ? 4 : 0);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack2<T>(lo, hi);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdArgs a) {
  constexpr int LD = Geo<D>::LD;
  constexpr int KS = D / 16;   // k-steps over head_dim
  constexpr int NT = D / 8;    // 8-wide column tiles of O
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);
  T* ks = qs + Geo<D>::kTileElems;          // [2][kTile][LD]
  T* vs = ks + 2 * Geo<D>::kTileElems;      // [2][kTile][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nq = (a.S + kTile - 1) / kTile;
  const int qi = nq - 1 - blockIdx.x;       // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const int q0 = qi * kTile;
  const T* qg = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kg = static_cast<const T*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.sv.b + hk * a.sv.h;
  const int nk = a.causal ? qi + 1 : nq;

  load_tile<D>(qs, qg, a.sq.s, q0, a.S, tid);
  cp_async_commit();
  load_tile<D>(ks, kg, a.sk.s, 0, a.S, tid);
  load_tile<D>(vs, vg, a.sv.s, 0, a.S, tid);
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk) {
      const int st = (it + 1) & 1;
      load_tile<D>(ks + st * Geo<D>::kTileElems, kg, a.sk.s, (it + 1) * kTile, a.S, tid);
      load_tile<D>(vs + st * Geo<D>::kTileElems, vg, a.sv.s, (it + 1) * kTile, a.S, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) frag_a<LD>(qf[kk], qs, warp * 16, kk * 16, lane);
    }
    const T* kt = ks + (it & 1) * Geo<D>::kTileElems;
    const T* vt = vs + (it & 1) * Geo<D>::kTileElems;
    const int k0 = it * kTile;

    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kTile / 8; j += 2) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bf[4];
        frag_b_rows2<LD>(bf, kt, j * 8, kk * 16, lane);
        mma16816<T>(s[j], qf[kk], bf);
        mma16816<T>(s[j + 1], qf[kk], bf + 2);
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int r = row[e >> 1];
        float v = s[j][e] * a.scale;
        if (col >= a.S || (a.causal && col > r)) v = kNegInf;
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      alpha[i] = __expf(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pf[4];
      acc_to_a<T>(pf, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bf[4];
        frag_b_cols2<LD>(bf, vt, kk * 16, n * 8, lane);
        mma16816<T>(acc[n], pf, bf);
        mma16816<T>(acc[n + 1], pf, bf + 2);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();

  T* og = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float ls = fmaxf(l[i], 1e-30f);
    if (row[i] < a.S) {
      const float inv = 1.f / ls;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        store2<T>(og + (long long)row[i] * a.so.s + n * 8 + 2 * t, acc[n][2 * i] * inv,
                  acc[n][2 * i + 1] * inv);
      if (t == 0) a.lse[((long long)b * a.H + h) * a.S + row[i]] = m[i] + logf(ls);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dK and dV
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int LD = Geo<D>::LD;
  constexpr int KS = D / 16;
  constexpr int NT = D / 8;
  constexpr int TE = Geo<D>::kTileElems;
  extern __shared__ float4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);
  T* vs = ks + TE;
  T* qs = vs + TE;                 // [2][kTile][LD]
  T* dos = qs + 2 * TE;            // [2][kTile][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * TE);   // [2][kTile]
  float* delta_s = lse_s + 2 * kTile;                      // [2][kTile]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nq = (a.S + kTile - 1) / kTile;
  const int ki = blockIdx.x;       // low K tiles see the most Q tiles: first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rep = a.H / a.Hk;
  const int k0 = ki * kTile;
  const int q_start = a.causal ? ki : 0;
  const int per_head = nq - q_start;
  const int total = rep * per_head;

  load_tile<D>(ks, static_cast<const T*>(a.k) + b * a.sk.b + hk * a.sk.h, a.sk.s, k0, a.S, tid);
  load_tile<D>(vs, static_cast<const T*>(a.v) + b * a.sv.b + hk * a.sv.h, a.sv.s, k0, a.S, tid);

  auto issue = [&](int it, int st) {
    const int h = hk * rep + it / per_head;
    const int qrow0 = (q_start + it % per_head) * kTile;
    load_tile<D>(qs + st * TE, static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h, a.sq.s,
                 qrow0, a.S, tid);
    load_tile<D>(dos + st * TE, static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h,
                 a.sdo.s, qrow0, a.S, tid);
    const long long off = ((long long)b * a.H + h) * a.S;
    load_row_stats(lse_s + st * kTile, a.lse + off, qrow0, a.S, tid);
    load_row_stats(delta_s + st * kTile, a.delta + off, qrow0, a.S, tid);
  };
  issue(0, 0);
  cp_async_commit();

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) issue(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = it & 1;
    const T* qt = qs + st * TE;
    const T* dot = dos + st * TE;
    const float* lt = lse_s + st * kTile;
    const float* dt = delta_s + st * kTile;
    const int qrow0 = (q_start + it % per_head) * kTile;

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kChunk) {
      // S^T and dP^T for 16 K rows x kChunk query columns
      float p[kChunk / 8][4], dp[kChunk / 8][4];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kf[4], vf[4];
        frag_a<LD>(kf, ks, warp * 16, kk * 16, lane);
        frag_a<LD>(vf, vs, warp * 16, kk * 16, lane);
#pragma unroll
        for (int j = 0; j < kChunk / 8; j += 2) {
          uint32_t bq[4], bo[4];
          frag_b_rows2<LD>(bq, qt, c0 + j * 8, kk * 16, lane);
          frag_b_rows2<LD>(bo, dot, c0 + j * 8, kk * 16, lane);
          mma16816<T>(p[j], kf, bq);
          mma16816<T>(p[j + 1], kf, bq + 2);
          mma16816<T>(dp[j], vf, bo);
          mma16816<T>(dp[j + 1], vf, bo + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c0 + j * 8 + 2 * t + (e & 1);
          const int qrow = qrow0 + qc;
          const int kr = krow[e >> 1];
          float pv = 0.f;
          if (qrow < a.S && kr < a.S && !(a.causal && kr > qrow))
            pv = __expf(fminf(p[j][e] * a.scale - lt[qc], kClamp));
          p[j][e] = pv;
          dp[j][e] = pv * (dp[j][e] - dt[qc]) * a.scale;
        }
      // dV += P^T dO and dK += dS^T Q over these kChunk query rows
#pragma unroll
      for (int kq = 0; kq < kChunk / 16; ++kq) {
        uint32_t pf[4], sf[4];
        acc_to_a<T>(pf, p[2 * kq], p[2 * kq + 1]);
        acc_to_a<T>(sf, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t bo[4], bq[4];
          frag_b_cols2<LD>(bo, dot, c0 + kq * 16, n * 8, lane);
          frag_b_cols2<LD>(bq, qt, c0 + kq * 16, n * 8, lane);
          mma16816<T>(dv[n], pf, bo);
          mma16816<T>(dv[n + 1], pf, bo + 2);
          mma16816<T>(dk[n], sf, bq);
          mma16816<T>(dk[n + 1], sf, bq + 2);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  T* dkg = static_cast<T*>(a.dk) + b * a.sdk.b + hk * a.sdk.h;
  T* dvg = static_cast<T*>(a.dv) + b * a.sdv.b + hk * a.sdv.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (krow[i] >= a.S) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      store2<T>(dkg + (long long)krow[i] * a.sdk.s + n * 8 + 2 * t, dk[n][2 * i], dk[n][2 * i + 1]);
      store2<T>(dvg + (long long)krow[i] * a.sdv.s + n * 8 + 2 * t, dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dQ
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int LD = Geo<D>::LD;
  constexpr int KS = D / 16;
  constexpr int NT = D / 8;
  constexpr int TE = Geo<D>::kTileElems;
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);
  T* dos = qs + TE;
  T* ks = dos + TE;                // [2][kTile][LD]
  T* vs = ks + 2 * TE;             // [2][kTile][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nq = (a.S + kTile - 1) / kTile;
  const int qi = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const int q0 = qi * kTile;
  const T* kg = static_cast<const T*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.sv.b + hk * a.sv.h;
  const int nk = a.causal ? qi + 1 : nq;

  load_tile<D>(qs, static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h, a.sq.s, q0, a.S, tid);
  load_tile<D>(dos, static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h, a.sdo.s, q0,
               a.S, tid);
  cp_async_commit();
  load_tile<D>(ks, kg, a.sk.s, 0, a.S, tid);
  load_tile<D>(vs, vg, a.sv.s, 0, a.S, tid);
  cp_async_commit();

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long off = ((long long)b * a.H + h) * a.S + row[i];
    lse[i] = row[i] < a.S ? a.lse[off] : 0.f;
    delta[i] = row[i] < a.S ? a.delta[off] : 0.f;
  }
  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  // this warp's Q and dO rows stay in registers for the whole K loop
  uint32_t qf[KS][4], of[KS][4];
  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk) {
      const int st = (it + 1) & 1;
      load_tile<D>(ks + st * TE, kg, a.sk.s, (it + 1) * kTile, a.S, tid);
      load_tile<D>(vs + st * TE, vg, a.sv.s, (it + 1) * kTile, a.S, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        frag_a<LD>(qf[kk], qs, warp * 16, kk * 16, lane);
        frag_a<LD>(of[kk], dos, warp * 16, kk * 16, lane);
      }
    }
    const T* kt = ks + (it & 1) * TE;
    const T* vt = vs + (it & 1) * TE;
    const int k0 = it * kTile;

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kChunk) {
      float p[kChunk / 8][4], dp[kChunk / 8][4];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int j = 0; j < kChunk / 8; j += 2) {
          uint32_t bk[4], bv[4];
          frag_b_rows2<LD>(bk, kt, c0 + j * 8, kk * 16, lane);
          frag_b_rows2<LD>(bv, vt, c0 + j * 8, kk * 16, lane);
          mma16816<T>(p[j], qf[kk], bk);
          mma16816<T>(p[j + 1], qf[kk], bk + 2);
          mma16816<T>(dp[j], of[kk], bv);
          mma16816<T>(dp[j + 1], of[kk], bv + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + c0 + j * 8 + 2 * t + (e & 1);
          const int r = row[e >> 1];
          float pv = 0.f;
          if (r < a.S && col < a.S && !(a.causal && col > r))
            pv = __expf(fminf(p[j][e] * a.scale - lse[e >> 1], kClamp));
          dp[j][e] = pv * (dp[j][e] - delta[e >> 1]) * a.scale;
        }
#pragma unroll
      for (int kq = 0; kq < kChunk / 16; ++kq) {
        uint32_t sf[4];
        acc_to_a<T>(sf, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t bk[4];
          frag_b_cols2<LD>(bk, kt, c0 + kq * 16, n * 8, lane);
          mma16816<T>(dq[n], sf, bk);
          mma16816<T>(dq[n + 1], sf, bk + 2);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  T* dqg = static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= a.S) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      store2<T>(dqg + (long long)row[i] * a.sdq.s + n * 8 + 2 * t, dq[n][2 * i], dq[n][2 * i + 1]);
  }
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

Strides strides_of(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <typename T, int D>
int launch_fwd(const FwdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = 5 * Geo<D>::kTileElems * sizeof(T);
  if (int e = prepare(flash_fwd_kernel<T, D>, smem)) return e;
  dim3 grid((a.S + kTile - 1) / kTile, a.H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  const int nt = (a.S + kTile - 1) / kTile;
  const size_t smem_dkv = 6 * Geo<D>::kTileElems * sizeof(T) + 4 * kTile * sizeof(float);
  if (int e = prepare(flash_bwd_dkv_kernel<T, D>, smem_dkv)) return e;
  flash_bwd_dkv_kernel<T, D><<<dim3(nt, a.Hk, B), kThreads, smem_dkv, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem_dq = 6 * Geo<D>::kTileElems * sizeof(T);
  if (int e2 = prepare(flash_bwd_dq_kernel<T, D>, smem_dq)) return e2;
  flash_bwd_dq_kernel<T, D><<<dim3(nt, a.H, B), kThreads, smem_dq, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename F>
int dispatch(int dtype, int D, F&& f) {
  if (dtype == 1 && D == 128) return f(__nv_bfloat16{}, std::integral_constant<int, 128>{});
  if (dtype == 1 && D == 64) return f(__nv_bfloat16{}, std::integral_constant<int, 64>{});
  if (dtype == 2 && D == 128) return f(__half{}, std::integral_constant<int, 128>{});
  if (dtype == 2 && D == 64) return f(__half{}, std::integral_constant<int, 64>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/o [B, S, H, D], k/v [B, S, Hk, D] with unit stride along D; strides holds
// the (batch, seq, head) element strides of q, k, v, o in that order. lse is
// f32 [B, H, S], contiguous. dtype 1 is bf16, 2 is fp16; D is 64 or 128. The
// caller has checked H % Hk == 0, shapes, 16-byte alignment of every row and
// even strides. Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, const long long* strides, int B, int H, int Hk,
                                   int S, int D, float scale, int causal, int dtype,
                                   void* stream) {
  FwdArgs a{q, k, v, o, static_cast<float*>(lse),
            strides_of(strides, 0), strides_of(strides, 1), strides_of(strides, 2),
            strides_of(strides, 3), H, Hk, S, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, [&](auto tv, auto dv) {
    return launch_fwd<decltype(tv), decltype(dv)::value>(a, B, s);
  });
}

// The backward's two passes. dout/dq like q, dk/dv like k; lse and delta f32
// [B, H, S]; strides holds (batch, seq, head) of q, k, v, dout, dq, dk, dv.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, const long long* strides,
                                   int B, int H, int Hk, int S, int D, float scale, int causal,
                                   int dtype, void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
            dq, dk, dv,
            strides_of(strides, 0), strides_of(strides, 1), strides_of(strides, 2),
            strides_of(strides, 3), strides_of(strides, 4), strides_of(strides, 5),
            strides_of(strides, 6), H, Hk, S, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, [&](auto tv, auto dv_) {
    return launch_bwd<decltype(tv), decltype(dv_)::value>(a, B, s);
  });
}
