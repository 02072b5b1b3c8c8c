// FlashAttention forward and backward for Hopper (sm_90a): wgmma fed by TMA
// through mbarrier pipelines, one producer warpgroup and two consumer
// warpgroups per block. Bound through a plain C interface and loaded with
// ctypes by paddle_tpu_torch/ops/flash_attention.py.
//
// Replaces: paddle_tpu/ops/pallas/flash_kernel.py:173 `flash_fwd_partial`
// (its body `_fwd_kernel`, :48-85) and :208 `flash_bwd_partial` (the dK/dV
// pass `_bwd_dkv_kernel`, :88-129, and the dQ pass `_bwd_dq_kernel`,
// :132-160), which every Llama attention call reaches through
// `flash_attention_bsnd` and the `custom_vjp` of `flash_attention_bhsd`.
// With Sq != Sk it also stands for the bundled Mosaic kernel the reference's
// gate sends those calls to (ops/pallas/flash_attention.py:112-133), which
// aligns its causal mask top-left, unlike the reference's composed path.
//
// Semantics, as the TPU kernels: scores q.k in f32 from bf16 (or fp16)
// products, times `scale`; causal rows align bottom-right, as the composed
// `_sdpa_ref` (paddle_tpu/nn/functional/attention.py:38-41): query row i sees
// keys j <= i + (Sk - Sq), the TPU kernels' rule when Sq == Sk. A masked
// score is -1e30, as the composed path masks, so a row that sees no key
// (causal, Sk < Sq) is uniform over all Sk keys: its output is the mean of
// V and its lse -1e30; the backward gives it dQ = 0 and dV += dO / Sk on
// every key (the composed path's gradient does not pass its mask); online softmax
// statistics (m, l) in f32; the probabilities are rounded to the input type
// before the P.V product; O in the input type, lse = m + log(l) in f32. The
// backward takes lse and delta = rowsum(dO * O) (f32), recomputes
// P = exp(min(s - lse, 60)) (the clamp keeps masked or foreign rows finite),
// rounds P to the input type for dV += P^T dO and dS = P (dP - delta) scale
// to the input type for dK += dS^T Q and dQ += dS K. Exponentials are taken
// as exp2 with log2(e) folded into the scale; lse is stored in natural log.
//
// Bound on the H100: operations. At Llama-3-8B training shapes (B 1, S 8192,
// H 32, Hk 8, head_dim 128, causal) the forward does 4 FLOPs per kept (query,
// key, dim): 0.55594 ms at 989 TFLOP/s bf16; the backward counts its five
// products, 1.38985 ms. The three deterministic passes below compute eight
// products (S^T in the dV and the dK pass, S and dP again in the dQ pass):
// 2.224 ms at peak (the reference's two passes, seven: 1.946). The bytes
// (each input read once) take a tenth of that. So every product runs on
// the tensor cores through wgmma, the S x S scores stay in registers, and no
// work is done above the causal diagonal beyond the diagonal tiles.
//
// Design:
// - Layout: q/o [B, S, H, D] and k/v [B, S, Hk, D], read in place. Each
//   input gets a 4-D TMA tensor map over (D, heads, S, B) with the tensor's
//   own byte strides, so a ragged S reads zeros past each sequence's end and
//   never the next batch's rows; head-slices of a fused qkv tensor work as
//   they are. A box is 64 columns (128 bytes, the most a 128-byte swizzle
//   takes) by a tile's rows; head_dim 128 arrives as two boxes. The maps are
//   encoded per call on the host (cuTensorMapEncodeTiled, taken from the
//   driver through cudaGetDriverEntryPoint, so the library needs no -lcuda)
//   and passed by value as __grid_constant__ parameters, which a CUDA graph
//   captures with the launch.
// - Roles: warpgroup 0 produces (one thread issues every TMA load; in the
//   dV and dK passes its first warp also copies lse and delta), warpgroups
//   1 and 2 consume, 64 rows each. Shared-memory stages ring through
//   full/empty mbarriers: the producer waits for a stage to be empty, sets
//   the bytes it expects and issues the copy; a consumer waits for it to be
//   full, runs its products and releases it (one arrival per warp).
// - Products: wgmma m64nNk16 with f32 accumulators. A score product (S =
//   Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T) takes both operands from
//   shared memory, K-major, 128-byte swizzled (a k-step advances the
//   descriptor by 32 bytes inside the swizzle atom). The accumulator,
//   rounded to the input type in pairs, is the register A operand of the
//   next product (P V, dS K, P^T dO, dS^T Q), whose B operand is the
//   row-major tile read MN-major (transposed), its two 64-column boxes one
//   leading-byte offset apart.
// - Registers: 384 threads hold ptxas to 168 registers a thread, and
//   setmaxnreg does not raise that (a first dK/dV pass spilled 688-704
//   bytes whether the consumers asked for 232 or 240), so none is used.
//   Each pass keeps one 64 x D accumulator: the forward O and S, the dQ
//   pass dQ, S and dP, the dV pass dV and S^T, the dK pass dK, S^T and dP^T.
// - Forward: one block per (128 query rows, head, batch), heaviest causal
//   tiles first. Q arrives once; K and V tiles of 128 rows ring through two
//   stages with their own barriers, so S = Q K^T starts before V lands. The
//   online softmax runs on the accumulator layout in registers; only the
//   diagonal tile and the ragged tail are masked.
// - Backward, deterministic (no atomics), in three passes. dV and dK: one
//   block per (128 K rows, KV head, batch) holds K and V and loops over the
//   query heads of its group and the 64-row Q tiles from the causal start,
//   Q, dO, lse and delta ringing through three stages; the accumulator stays
//   in f32 registers for the whole loop, so the GQA group sum happens there,
//   rounded once. The dV pass forms P^T only; the dK pass forms P^T while
//   dP^T is computed, then dS^T. dQ: one block per (128 Q rows, head,
//   batch); Q, dO and the row statistics stay, K and V tiles of 64 rows
//   stream through two stages, P formed while dP is computed.
// - head_dim 64 and 128, bf16 and fp16 are compiled; any Sq and Sk.
//   flash_simt.cu takes f32 and the other head dims.
//
// Tried on the H100 (80GB HBM3, 700 W) at the shape above, with SDPA's
// forward at 0.86-0.89 ms and its backward at 2.68-2.88 ms in the same calls:
// - the first version of this file (mma.sync m16n8k16 from ldmatrix, 64 x 64
//   tiles on four warps, cp.async in two stages): 3.00156 / 11.12041 ms;
// - this forward: 1.02-1.03 ms. With one tile's softmax overlapping the
//   previous tile's P V inside a warpgroup: 1.27-1.30 ms (O, S and P live
//   together spill 208 bytes and ptxas serializes the wgmma); dropped;
// - one dK/dV pass holding both accumulators, as the reference: 6.1-6.3 ms
//   of a 7.53-7.61 ms backward (688 bytes spilled, wgmma serialized); with
//   each tile's last product left in flight into the next: 8.63-8.66 ms;
//   with 9 warps (224 registers): 808 bytes spilled; dropped for a dV and a
//   dK pass, which make the backward 4.12-4.32 ms;
// - lse and delta by TMA through a one-row tensor map: the pipeline never
//   completed (the bounded wait trapped); the producer warp copies them.
//
// Not done yet: a persistent schedule, a one-pass backward (dQ reduced
// across blocks in order, FA3-style) and a fused delta = rowsum(dO * O).

#include "hopper.cuh"

namespace {

constexpr int kWG = 128;                  // threads of a warpgroup
constexpr int kThreads = 3 * kWG;         // producer + two consumers
constexpr int kConsumerWarps = 8;         // arrivals that empty a stage
constexpr int kBox = 64;                  // columns of a TMA box
constexpr int kRowBytes = kBox * 2;       // one swizzled box row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// scores in log2 units: a masked one is -1e30 in natural units, as the
// composed path masks (a row that sees no key is uniform over all Sk keys,
// lse -1e30); a key past Sk weighs nothing even there; the running maximum
// starts below both
constexpr float kMask2 = kNegInf * kLog2e;
constexpr float kPad2 = 2.f * kMask2;
constexpr float kInit2 = 4.f * kMask2;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kClamp2 = 60.f * kLog2e;  // the clamp exp(min(x, 60)) in log2
constexpr int kTmaError = 10000;          // + CUresult of a failed tensor map

struct Strides {
  long long b, s, h;
};

struct FwdArgs {
  void* o; float* lse;
  Strides so;
  int H, Hk, Sq, Sk;
  float scale;
  int causal;
};

struct BwdArgs {
  const float* lse; const float* delta;
  void* dq; void* dk; void* dv;
  Strides sdq, sdk, sdv;
  int H, Hk, Sq, Sk;
  float scale;
  int causal;
};


// the A fragments of a 64 x N accumulator, k-step by k-step
template <typename T, int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[k][r] = pack2<T>(d[8 * k + 2 * r], d[8 * k + 2 * r + 1]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows row and row + 8 of a 64 x D accumulator to a [rows, D] slice with
// row stride rs (elements), rows at or past S skipped
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* g, long long rs, int row, int S, int t4,
                                           const float (&d)[D / 2], const float* mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= S) continue;
    T* p = g + (long long)(row + 8 * r) * rs + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack2<T>(d[4 * j + 2 * r] * mul[r], d[4 * j + 2 * r + 1] * mul[r]);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
struct FwdGeo {
  static constexpr int kBoxes = D / kBox;
  static constexpr int kM = 128;                     // query rows of a block
  static constexpr int kN = 128;                     // K/V rows of a tile
  static constexpr int kQBox = kM * kRowBytes;
  static constexpr int kBoxBytes = kN * kRowBytes;   // one box of a K or V tile
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kBoxes * kQBox;          // [2 stages]
  static constexpr int kV = kK + 2 * kTileBytes;     // [2 stages]
  static constexpr int kBar = kV + 2 * kTileBytes;
  static constexpr int kSmem = kBar + 128 + 1024;    // barriers, alignment slack
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const FwdArgs a) {
  using G = FwdGeo<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + G::kBar);
  uint64_t* k_full = q_full + 1;   // [2]
  uint64_t* k_empty = q_full + 3;  // [2]
  uint64_t* v_full = q_full + 5;   // [2]
  uint64_t* v_empty = q_full + 7;  // [2]

  const int nq = (a.Sq + G::kM - 1) / G::kM;
  const int qi = nq - 1 - blockIdx.x;              // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const int q0 = qi * G::kM;
  const int off = a.Sk - a.Sq;                     // row i sees keys j <= i + off (causal)
  const int nk_all = (a.Sk + G::kN - 1) / G::kN;
  // a tile with a row that sees no key walks all keys: that row is uniform
  const int nk = !a.causal || q0 + off < 0 ? nk_all
                                           : min(nk_all, (q0 + G::kM - 1 + off) / G::kN + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(v_full + i, 1);
      mbar_init(k_empty + i, kConsumerWarps);
      mbar_init(v_empty + i, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, G::kBoxes * G::kQBox);
      for (int x = 0; x < G::kBoxes; ++x)
        tma_load(sm + G::kQ + x * G::kQBox, &tq, q_full, x * kBox, h, q0, b);
      for (int it = 0; it < nk; ++it) {
        const int st = it & 1;
        const uint32_t ph = (it >> 1) & 1;
        mbar_wait(k_empty + st, ph ^ 1);
        mbar_expect_tx(k_full + st, G::kTileBytes);
        for (int x = 0; x < G::kBoxes; ++x)
          tma_load(sm + G::kK + st * G::kTileBytes + x * G::kBoxBytes, &tk, k_full + st, x * kBox,
                   hk, it * G::kN, b);
        mbar_wait(v_empty + st, ph ^ 1);
        mbar_expect_tx(v_full + st, G::kTileBytes);
        for (int x = 0; x < G::kBoxes; ++x)
          tma_load(sm + G::kV + st * G::kTileBytes + x * G::kBoxBytes, &tv, v_full + st, x * kBox,
                   hk, it * G::kN, b);
      }
    }
  } else {
    const int c = threadIdx.x / kWG - 1;           // query rows c * 64 .. of the block
    const int t = threadIdx.x % kWG, t4 = t % 4;
    const int row = q0 + c * 64 + (t / 32) * 16 + (t % 32) / 4;   // and row + 8
    const float sl2 = a.scale * kLog2e;
    const uint32_t qs = smem_u32(sm + G::kQ) + c * 64 * kRowBytes;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kInit2, kInit2}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int it = 0; it < nk; ++it) {
      const int st = it & 1;
      const uint32_t ph = (it >> 1) & 1;
      const int k0 = it * G::kN;
      const uint32_t ks = smem_u32(sm + G::kK + st * G::kTileBytes);
      const uint32_t vs = smem_u32(sm + G::kV + st * G::kTileBytes);

      float s[G::kN / 2];
      mbar_wait(k_full + st, ph);
      wg_fence();
#pragma unroll
      for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
        for (int kk = 0; kk < kBox / 16; ++kk)
          Mma<T, G::kN>::template ss<0>(s, kmajor(qs + x * G::kQBox + kk * 32),
                                        kmajor(ks + x * G::kBoxBytes + kk * 32), x + kk);
      wg_commit();
      wg_wait();
      fence_regs(s);
      release(k_empty + st);

#pragma unroll
      for (int i = 0; i < G::kN / 2; ++i) s[i] *= sl2;
      // only the diagonal tiles and the ragged tail hold masked columns
      if (k0 + G::kN > a.Sk || (a.causal && k0 + G::kN - 1 > q0 + c * 64 + off)) {
#pragma unroll
        for (int i = 0; i < G::kN / 2; ++i) {
          const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          if (col >= a.Sk)
            s[i] = kPad2;
          else if (a.causal && col > row + 8 * ((i >> 1) & 1) + off)
            s[i] = kMask2;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < G::kN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < G::kN / 2; ++i) {
        s[i] = ex2(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      uint32_t pa[G::kN / 16][4];
      to_a<T, G::kN>(pa, s);

      mbar_wait(v_full + st, ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < G::kN / 16; ++kk)
        Mma<T, D>::template rs<1>(o, pa[kk], mnmajor(vs + kk * 16 * kRowBytes, G::kBoxBytes), 1);
      wg_commit();
      wg_wait();
      fence_regs(o);
      release(v_empty + st);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
      inv[r] = 1.f / l[r];
      if (t4 == 0 && row + 8 * r < a.Sq)
        a.lse[((long long)b * a.H + h) * a.Sq + row + 8 * r] = m[r] * kLn2 + logf(l[r]);
    }
    store_rows<T, D>(static_cast<T*>(a.o) + b * a.so.b + h * a.so.h, a.so.s, row, a.Sq, t4, o,
                     inv);
  }
}

// ---------------------------------------------------------------------------
// backward: dV, then dK
// ---------------------------------------------------------------------------

template <int D>
struct KvGeo {
  static constexpr int kBoxes = D / kBox;
  static constexpr int kN = 128;                     // K/V rows of a block
  static constexpr int kM = 64;                      // query rows of a tile
  static constexpr int kKBox = kN * kRowBytes;
  static constexpr int kQBox = kM * kRowBytes;
  static constexpr int kQBytes = kBoxes * kQBox;     // one Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kBoxes * kKBox;
  static constexpr int kStages = 3;
  static constexpr int kQ = 2 * kV;                        // [kStages]
  static constexpr int kDO = kQ + kStages * kQBytes;       // [kStages]
  static constexpr int kStat = kDO + kStages * kQBytes;    // [kStages][lse | delta][kM] f32
  static constexpr int kStatBytes = 2 * kM * 4;
  static constexpr int kBar = kStat + kStages * kStatBytes;
  static constexpr int kSmem = kBar + 128 + 1024;
};

// kDV: dV += P^T dO (S^T, then one product); else dK += dS^T Q (S^T and
// dP^T, then one product)
template <typename T, int D, bool kDV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, const BwdArgs a) {
  using G = KvGeo<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + G::kBar);
  uint64_t* full = kv_full + 1;                 // [kStages]
  uint64_t* empty = kv_full + 1 + G::kStages;   // [kStages]
  float* stat = reinterpret_cast<float*>(sm + G::kStat);

  const int ki = blockIdx.x;                       // low K tiles see the most Q tiles: first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rep = a.H / a.Hk;
  const int k0 = ki * G::kN;
  const int off = a.Sk - a.Sq;                     // query i sees keys j <= i + off (causal)
  const int nq = (a.Sq + G::kM - 1) / G::kM;
  // the Q tiles that see this block's keys; in the dV pass, when some rows
  // see no key (causal, Sk < Sq), all of them: such a row gives dV 1 / Sk of
  // its dO
  const int q_start = !a.causal || (kDV && off < 0) ? 0 : max(0, k0 - off) / G::kM;
  const int per_head = max(0, nq - q_start);
  const int total = rep * per_head;
  const float inv_sk = 1.f / a.Sk;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < G::kStages; ++i) {
      mbar_init(full + i, 32);                     // the producer warp's lanes
      mbar_init(empty + i, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * G::kBoxes * G::kKBox);
      for (int x = 0; x < G::kBoxes; ++x) {
        tma_load(sm + G::kK + x * G::kKBox, &tk, kv_full, x * kBox, hk, k0, b);
        tma_load(sm + G::kV + x * G::kKBox, &tv, kv_full, x * kBox, hk, k0, b);
      }
    }
    if (threadIdx.x < 32) {
      for (int it = 0; it < total; ++it) {
        const int st = it % G::kStages;
        const uint32_t ph = (it / G::kStages) & 1;
        const int h = hk * rep + it / per_head;
        const int q0 = (q_start + it % per_head) * G::kM;
        // lse and delta of the tile's rows, read before the stage is free;
        // zeros past S
        const long long so = ((long long)b * a.H + h) * a.Sq + q0;
        float lse[2], delta[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool ok = q0 + lane + 32 * r < a.Sq;
          lse[r] = ok ? a.lse[so + lane + 32 * r] : 0.f;
          delta[r] = ok ? a.delta[so + lane + 32 * r] : 0.f;
        }
        mbar_wait(empty + st, ph ^ 1);
        float* ls = stat + st * 2 * G::kM;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          ls[lane + 32 * r] = lse[r];
          ls[G::kM + lane + 32 * r] = delta[r];
        }
        if (lane == 0) {
          mbar_expect_tx(full + st, 2 * G::kQBytes);
          for (int x = 0; x < G::kBoxes; ++x) {
            tma_load(sm + G::kQ + st * G::kQBytes + x * G::kQBox, &tq, full + st, x * kBox, h,
                     q0, b);
            tma_load(sm + G::kDO + st * G::kQBytes + x * G::kQBox, &tdo, full + st, x * kBox, h,
                     q0, b);
          }
        } else {
          mbar_arrive(full + st);
        }
      }
    }
  } else {
    const int c = threadIdx.x / kWG - 1;           // K rows c * 64 .. of the block
    const int t = threadIdx.x % kWG, t4 = t % 4;
    const int krow = k0 + c * 64 + (t / 32) * 16 + (t % 32) / 4;   // and krow + 8
    const float sl2 = a.scale * kLog2e;
    const uint32_t ks = smem_u32(sm + G::kK) + c * 64 * kRowBytes;
    const uint32_t vs = smem_u32(sm + G::kV) + c * 64 * kRowBytes;
    float acc[D / 2];                              // dV or dK of this warpgroup's rows
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int it = 0; it < total; ++it) {
      const int st = it % G::kStages;
      const uint32_t ph = (it / G::kStages) & 1;
      const int q0 = (q_start + it % per_head) * G::kM;
      const uint32_t qs = smem_u32(sm + G::kQ + st * G::kQBytes);
      const uint32_t dos = smem_u32(sm + G::kDO + st * G::kQBytes);
      const float* ls = stat + st * 2 * G::kM;

      // S^T (and dP^T): 64 K rows x kM query columns
      float s[G::kM / 2], dp[G::kM / 2];
      mbar_wait(full + st, ph);
      wg_fence();
#pragma unroll
      for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
        for (int kk = 0; kk < kBox / 16; ++kk)
          Mma<T, G::kM>::template ss<0>(s, kmajor(ks + x * G::kKBox + kk * 32),
                                        kmajor(qs + x * G::kQBox + kk * 32), x + kk);
      wg_commit();
      if constexpr (!kDV) {
#pragma unroll
        for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
          for (int kk = 0; kk < kBox / 16; ++kk)
            Mma<T, G::kM>::template ss<0>(dp, kmajor(vs + x * G::kKBox + kk * 32),
                                          kmajor(dos + x * G::kQBox + kk * 32), x + kk);
        wg_commit();
        wg_wait<1>();                              // P^T while dP^T is computed
      } else {
        wg_wait();
      }
      fence_regs(s);

#pragma unroll
      for (int i = 0; i < G::kM / 2; ++i) {
        const int qc = 8 * (i >> 2) + 2 * t4 + (i & 1);
        s[i] = ex2(fminf(s[i] * sl2 - ls[qc] * kLog2e, kClamp2));
      }
      // masked: query rows past Sq, and K rows after the query's last key
      // (causal); dV gives a row that sees no key 1 / Sk on every key
      if (q0 + G::kM > a.Sq || (a.causal && k0 + c * 64 + 63 > q0 + off)) {
#pragma unroll
        for (int i = 0; i < G::kM / 2; ++i) {
          const int q = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          if constexpr (kDV) {
            if (q >= a.Sq)
              s[i] = 0.f;
            else if (a.causal && krow + 8 * ((i >> 1) & 1) > q + off)
              s[i] = q + off < 0 ? inv_sk : 0.f;
          } else if (q >= a.Sq || (a.causal && krow + 8 * ((i >> 1) & 1) > q + off)) {
            s[i] = 0.f;
          }
        }
      }
      uint32_t fa[G::kM / 16][4];                  // P^T or dS^T as the A operand
      if constexpr (kDV) {
        to_a<T, G::kM>(fa, s);
      } else {
        wg_wait();
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < G::kM / 2; ++i) {
          const int qc = 8 * (i >> 2) + 2 * t4 + (i & 1);
          dp[i] = s[i] * (dp[i] - ls[G::kM + qc]) * a.scale;
        }
        to_a<T, G::kM>(fa, dp);
      }

      // dV += P^T dO, or dK += dS^T Q
      const uint32_t bs = kDV ? dos : qs;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < G::kM / 16; ++kk)
        Mma<T, D>::template rs<1>(acc, fa[kk], mnmajor(bs + kk * 16 * kRowBytes, G::kQBox), 1);
      wg_commit();
      wg_wait();
      fence_regs(acc);
      release(empty + st);
    }

    const float one[2] = {1.f, 1.f};
    if constexpr (kDV)
      store_rows<T, D>(static_cast<T*>(a.dv) + b * a.sdv.b + hk * a.sdv.h, a.sdv.s, krow, a.Sk,
                       t4, acc, one);
    else
      store_rows<T, D>(static_cast<T*>(a.dk) + b * a.sdk.b + hk * a.sdk.h, a.sdk.s, krow, a.Sk,
                       t4, acc, one);
  }
}

// ---------------------------------------------------------------------------
// backward: dQ
// ---------------------------------------------------------------------------

template <int D>
struct DqGeo {
  static constexpr int kBoxes = D / kBox;
  static constexpr int kM = 128;                     // query rows of a block
  static constexpr int kN = 64;                      // K/V rows of a tile
  static constexpr int kQBox = kM * kRowBytes;
  static constexpr int kBoxBytes = kN * kRowBytes;   // one box of a K or V tile
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kDO = kBoxes * kQBox;
  static constexpr int kK = 2 * kDO;                 // [2 stages]
  static constexpr int kV = kK + 2 * kTileBytes;     // [2 stages]
  static constexpr int kBar = kV + 2 * kTileBytes;
  static constexpr int kSmem = kBar + 128 + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const BwdArgs a) {
  using G = DqGeo<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(sm + G::kBar);
  uint64_t* kv_full = qd_full + 1;   // [2]
  uint64_t* kv_empty = qd_full + 3;  // [2]

  const int nq = (a.Sq + G::kM - 1) / G::kM;
  const int qi = nq - 1 - blockIdx.x;              // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const int q0 = qi * G::kM;
  const int off = a.Sk - a.Sq;                     // row i sees keys j <= i + off (causal)
  const int last = q0 + G::kM - 1 + off;           // the block's last visible key
  const int nk_all = (a.Sk + G::kN - 1) / G::kN;
  // a row that sees no key has dQ = 0: a block of such rows loads no key
  const int nk = !a.causal ? nk_all : last < 0 ? 0 : min(nk_all, last / G::kN + 1);

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(kv_full + i, 1);
      mbar_init(kv_empty + i, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(qd_full, 2 * G::kBoxes * G::kQBox);
      for (int x = 0; x < G::kBoxes; ++x) {
        tma_load(sm + G::kQ + x * G::kQBox, &tq, qd_full, x * kBox, h, q0, b);
        tma_load(sm + G::kDO + x * G::kQBox, &tdo, qd_full, x * kBox, h, q0, b);
      }
      for (int it = 0; it < nk; ++it) {
        const int st = it & 1;
        const uint32_t ph = (it >> 1) & 1;
        mbar_wait(kv_empty + st, ph ^ 1);
        mbar_expect_tx(kv_full + st, 2 * G::kTileBytes);
        for (int x = 0; x < G::kBoxes; ++x) {
          tma_load(sm + G::kK + st * G::kTileBytes + x * G::kBoxBytes, &tk, kv_full + st,
                   x * kBox, hk, it * G::kN, b);
          tma_load(sm + G::kV + st * G::kTileBytes + x * G::kBoxBytes, &tv, kv_full + st,
                   x * kBox, hk, it * G::kN, b);
        }
      }
    }
  } else {
    const int c = threadIdx.x / kWG - 1;           // query rows c * 64 .. of the block
    const int t = threadIdx.x % kWG, t4 = t % 4;
    const int row = q0 + c * 64 + (t / 32) * 16 + (t % 32) / 4;   // and row + 8
    const float sl2 = a.scale * kLog2e;
    const uint32_t qs = smem_u32(sm + G::kQ) + c * 64 * kRowBytes;
    const uint32_t dos = smem_u32(sm + G::kDO) + c * 64 * kRowBytes;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = row + 8 * r < a.Sq;
      const long long i = ((long long)b * a.H + h) * a.Sq + row + 8 * r;
      lse2[r] = ok ? a.lse[i] * kLog2e : 0.f;
      dl[r] = ok ? a.delta[i] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    mbar_wait(qd_full, 0);

    for (int it = 0; it < nk; ++it) {
      const int st = it & 1;
      const uint32_t ph = (it >> 1) & 1;
      const int k0 = it * G::kN;
      const uint32_t ks = smem_u32(sm + G::kK + st * G::kTileBytes);
      const uint32_t vs = smem_u32(sm + G::kV + st * G::kTileBytes);

      float s[G::kN / 2], dp[G::kN / 2];
      mbar_wait(kv_full + st, ph);
      wg_fence();
#pragma unroll
      for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
        for (int kk = 0; kk < kBox / 16; ++kk)
          Mma<T, G::kN>::template ss<0>(s, kmajor(qs + x * G::kQBox + kk * 32),
                                        kmajor(ks + x * G::kBoxBytes + kk * 32), x + kk);
      wg_commit();
#pragma unroll
      for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
        for (int kk = 0; kk < kBox / 16; ++kk)
          Mma<T, G::kN>::template ss<0>(dp, kmajor(dos + x * G::kQBox + kk * 32),
                                        kmajor(vs + x * G::kBoxBytes + kk * 32), x + kk);
      wg_commit();
      wg_wait<1>();                                // P while dP is computed
      fence_regs(s);

#pragma unroll
      for (int i = 0; i < G::kN / 2; ++i)
        s[i] = ex2(fminf(s[i] * sl2 - lse2[(i >> 1) & 1], kClamp2));
      if (k0 + G::kN > a.Sk || (a.causal && k0 + G::kN - 1 > q0 + c * 64 + off)) {
#pragma unroll
        for (int i = 0; i < G::kN / 2; ++i) {
          const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          if (col >= a.Sk || (a.causal && col > row + 8 * ((i >> 1) & 1) + off)) s[i] = 0.f;
        }
      }
      wg_wait();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < G::kN / 2; ++i)
        dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]) * a.scale;
      uint32_t da[G::kN / 16][4];
      to_a<T, G::kN>(da, dp);

      // dQ += dS K
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < G::kN / 16; ++kk)
        Mma<T, D>::template rs<1>(dq, da[kk], mnmajor(ks + kk * 16 * kRowBytes, G::kBoxBytes), 1);
      wg_commit();
      wg_wait();
      fence_regs(dq);
      release(kv_empty + st);
    }

    const float one[2] = {1.f, 1.f};
    store_rows<T, D>(static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h, a.sdq.s, row, a.Sq, t4,
                     dq, one);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and launches
// ---------------------------------------------------------------------------


// A 4-D map over (D, heads, S, B) of a [B, S, heads, D] tensor with element
// strides st (unit along D), boxes of 64 columns by `rows` rows, 128-byte
// swizzle; reads past an edge give zeros. A dimension of size 1 gets the
// packed stride, whatever torch reports for it.
template <typename T>
int tensor_map(CUtensorMap* map, const void* base, int B, int S, int heads, int D, Strides st,
               int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTmaError + CUDA_ERROR_NOT_FOUND;
  const long long sh = heads > 1 ? st.h : D;
  const long long ss = S > 1 ? st.s : sh * heads;
  const long long sb = B > 1 ? st.b : ss * S;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * sizeof(T), (cuuint64_t)ss * sizeof(T),
                                 (cuuint64_t)sb * sizeof(T)};
  const cuuint32_t box[4] = {kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTmaError + (int)r;
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

Strides strides_of(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const long long* st, const FwdArgs& a,
               int B, cudaStream_t stream) {
  using G = FwdGeo<D>;
  CUtensorMap mq, mk, mv;
  if (int e = tensor_map<T>(&mq, q, B, a.Sq, a.H, D, strides_of(st, 0), G::kM)) return e;
  if (int e = tensor_map<T>(&mk, k, B, a.Sk, a.Hk, D, strides_of(st, 1), G::kN)) return e;
  if (int e = tensor_map<T>(&mv, v, B, a.Sk, a.Hk, D, strides_of(st, 2), G::kN)) return e;
  if (int e = prepare(flash_fwd_kernel<T, D>, G::kSmem)) return e;
  const dim3 grid((a.Sq + G::kM - 1) / G::kM, a.H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, G::kSmem, stream>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const long long* st,
               const BwdArgs& a, int B, cudaStream_t stream) {
  // dK/dV: Q and dO boxes of 64 rows, K and V of 128; dQ the other way round
  using GK = KvGeo<D>;
  using GQ = DqGeo<D>;
  CUtensorMap mq, mk, mv, mdo;
  if (int e = tensor_map<T>(&mq, q, B, a.Sq, a.H, D, strides_of(st, 0), GK::kM)) return e;
  if (int e = tensor_map<T>(&mk, k, B, a.Sk, a.Hk, D, strides_of(st, 1), GK::kN)) return e;
  if (int e = tensor_map<T>(&mv, v, B, a.Sk, a.Hk, D, strides_of(st, 2), GK::kN)) return e;
  if (int e = tensor_map<T>(&mdo, dout, B, a.Sq, a.H, D, strides_of(st, 3), GK::kM)) return e;
  const dim3 grid_kv((a.Sk + GK::kN - 1) / GK::kN, a.Hk, B);
  if (int e = prepare(flash_bwd_kv_kernel<T, D, true>, GK::kSmem)) return e;
  flash_bwd_kv_kernel<T, D, true><<<grid_kv, kThreads, GK::kSmem, stream>>>(mq, mk, mv, mdo, a);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (int e = prepare(flash_bwd_kv_kernel<T, D, false>, GK::kSmem)) return e;
  flash_bwd_kv_kernel<T, D, false><<<grid_kv, kThreads, GK::kSmem, stream>>>(mq, mk, mv, mdo, a);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (int e = tensor_map<T>(&mq, q, B, a.Sq, a.H, D, strides_of(st, 0), GQ::kM)) return e;
  if (int e = tensor_map<T>(&mk, k, B, a.Sk, a.Hk, D, strides_of(st, 1), GQ::kN)) return e;
  if (int e = tensor_map<T>(&mv, v, B, a.Sk, a.Hk, D, strides_of(st, 2), GQ::kN)) return e;
  if (int e = tensor_map<T>(&mdo, dout, B, a.Sq, a.H, D, strides_of(st, 3), GQ::kM)) return e;
  if (int e = prepare(flash_bwd_dq_kernel<T, D>, GQ::kSmem)) return e;
  flash_bwd_dq_kernel<T, D><<<dim3((a.Sq + GQ::kM - 1) / GQ::kM, a.H, B), kThreads, GQ::kSmem,
                              stream>>>(mq, mk, mv, mdo, a);
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

// q/o [B, Sq, H, D], k/v [B, Sk, Hk, D] with unit stride along D; strides
// holds the (batch, seq, head) element strides of q, k, v, o in that order.
// lse is f32 [B, H, Sq], contiguous. dtype 1 is bf16, 2 is fp16; D is 64 or
// 128. Causal rows align bottom-right (row i sees keys j <= i + Sk - Sq).
// The caller has checked H % Hk == 0, shapes, 16-byte alignment of the data
// and strides that are positive multiples of 8 (16 bytes, as TMA needs).
// Returns the cudaError_t of the launch (0 on success), or 10000 + the
// CUresult of a tensor map the driver refused.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, const long long* strides, int B, int H, int Hk,
                                   int Sq, int Sk, int D, float scale, int causal, int dtype,
                                   void* stream) {
  const FwdArgs a{o, static_cast<float*>(lse), strides_of(strides, 3), H, Hk, Sq, Sk, scale,
                  causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, [&](auto tv, auto dv) {
    return launch_fwd<decltype(tv), decltype(dv)::value>(q, k, v, strides, a, B, s);
  });
}

// The backward's three passes. dout/dq like q, dk/dv like k; lse and delta
// f32 [B, H, Sq]; strides holds (batch, seq, head) of q, k, v, dout, dq, dk,
// dv.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, const long long* strides,
                                   int B, int H, int Hk, int Sq, int Sk, int D, float scale,
                                   int causal, int dtype, void* stream) {
  const BwdArgs a{static_cast<const float*>(lse), static_cast<const float*>(delta), dq, dk, dv,
                  strides_of(strides, 4), strides_of(strides, 5), strides_of(strides, 6),
                  H, Hk, Sq, Sk, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, [&](auto tv, auto dv_) {
    return launch_bwd<decltype(tv), decltype(dv_)::value>(q, k, v, dout, strides, a, B, s);
  });
}
