// FlashAttention forward and backward for Hopper (sm_90a): wgmma fed by TMA
// through mbarrier pipelines, one producer warpgroup and one or two consumer
// warpgroups per block. Bound through a plain C interface and loaded with
// ctypes by paddle_tpu_torch/ops/flash_attention.py.
//
// Replaces: paddle_tpu/ops/pallas/flash_kernel.py:173 `flash_fwd_partial`
// (its body `_fwd_kernel`, :48-85) and :208 `flash_bwd_partial` (the dK/dV
// pass `_bwd_dkv_kernel`, :88-129, and the dQ pass `_bwd_dq_kernel`,
// :132-160), which every Llama attention call reaches through
// `flash_attention_bsnd` and the `custom_vjp` of `flash_attention_bhsd`.
// It also stands for the bundled Mosaic kernel the reference's gate sends
// every other call to (ops/pallas/flash_attention.py:112-133): Sq != Sk
// (that kernel aligns its causal mask top-left, unlike the reference's
// composed path), f32, and any head_dim that is a multiple of 8.
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
// f32 inputs round nothing to a narrower type: every operand (Q, K, V, dO,
// and P and dS in registers) is split into two bf16 pieces, x = h + l with
// h = bf16(x) and l = bf16(x - h) (16 significant bits), and each product
// is the three products h.h' + h.l' + l.h' (about 2^-17 relative); O, dQ,
// dK and dV are f32. dK and dV sum each KV head's group in f32 in both.
//
// Bound on the H100: operations. At Llama-3-8B training shapes (B 1, S 8192,
// H 32, Hk 8, head_dim 128, causal) the forward does 4 FLOPs per kept (query,
// key, dim): 0.55594 ms at 989 TFLOP/s bf16; the backward counts its five
// products, 1.38985 ms. The three deterministic passes below compute eight
// products (S^T in the dV and the dK pass, S and dP again in the dQ pass):
// 2.224 ms at peak (the reference's two passes, seven: 1.946). The bytes
// (each input read once) take a tenth of that. So every product runs on
// the tensor cores through wgmma, the S x S scores stay in registers, and no
// work is done above the causal diagonal beyond the diagonal tiles. In f32
// every product is three bf16 products: the bound is 989 / 3 TFLOP/s.
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
// - Head dims: a head_dim D runs as Dp = 64 ceil(D / 64) columns (64, 128,
//   192 or 256). The maps keep D as the innermost extent, so TMA fills the
//   box columns past D with zeros on every load and the products are
//   unchanged; the outputs' register stores mask the columns past D. At D
//   == Dp the mask is compiled out (kPad).
// - f32: a pre-pass kernel (split_kernel) writes the two bf16 pieces of each
//   input as a packed [2 B, S, heads, D] tensor, the pieces walked as
//   batches B apart; the kernels load both pieces of every tile and issue
//   each product as its three piece products, smallest first. The register
//   operand (P or dS) is split where it is formed. Where the registers
//   allow (Dp <= 128), each tile's product accumulates from zero and is
//   added to the running f32 sum in registers (kPromote): the tensor cores
//   truncate their f32 sums at each 16-deep step, and a sum over thousands
//   of keys or queries would carry that bias.
// - Roles: warpgroup 0 produces (one thread issues every TMA load; in the
//   dV and dK passes its first warp also copies lse and delta), the others
//   consume, 64 rows each. Shared-memory stages ring through
//   full/empty mbarriers: the producer waits for a stage to be empty, sets
//   the bytes it expects and issues the copy; a consumer waits for it to be
//   full, runs its products and releases it (one arrival per warp).
// - Products: wgmma m64nNk16 with f32 accumulators. A score product (S =
//   Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T) takes both operands from
//   shared memory, K-major, 128-byte swizzled (a k-step advances the
//   descriptor by 32 bytes inside the swizzle atom). The accumulator,
//   rounded to the input type in pairs, is the register A operand of the
//   next product (P V, dS K, P^T dO, dS^T Q), whose B operand is the
//   row-major tile read MN-major (transposed), its 64-column boxes one
//   leading-byte offset apart (n64 or n128 per product, two of them past
//   128 columns).
// - Registers: 384 threads hold ptxas to 168 registers a thread, and
//   setmaxnreg does not raise that (a first dK/dV pass spilled 688-704
//   bytes whether the consumers asked for 232 or 240), so none is used.
//   Each pass keeps one 64 x Dp accumulator: the forward O and S, the dQ
//   pass dQ, S and dP, the dV pass dV and S^T, the dK pass dK, S^T and dP^T.
//   bf16 and fp16 up to Dp 128 run two consumer warpgroups (384 threads);
//   Dp 192 and 256, and f32 (two pieces and a second accumulator), one
//   consumer warpgroup (256 threads, 255 registers), with key or query
//   tiles of 32 to 128 rows and 1 to 3 stages, as shared memory allows
//   (the Geo structs below).
// - Forward: one block per (64 or 128 query rows, head, batch), heaviest
//   causal tiles first. Q arrives once; K and V tiles ring through two
//   stages with their own barriers, so S = Q K^T starts before V lands. The
//   online softmax runs on the accumulator layout in registers; only the
//   diagonal tile and the ragged tail are masked.
// - Backward, deterministic (no atomics), in three passes. dV and dK: one
//   block per (64 or 128 K rows, KV head, batch) holds K and V and loops
//   over the query heads of its group and the Q tiles from the causal start,
//   Q, dO, lse and delta ringing through the stages; the accumulator stays
//   in f32 registers for the whole loop, so the GQA group sum happens there,
//   rounded once. The dV pass forms P^T only; the dK pass forms P^T while
//   dP^T is computed, then dS^T. dQ: one block per (64 or 128 Q rows, head,
//   batch); Q, dO and the row statistics stay, K and V tiles stream through
//   the stages, P formed while dP is computed.
// - bf16, fp16 and f32; every head_dim that is a multiple of 8 up to 1024
//   (past 256 the wide kernels below); any Sq and Sk.
// - Past 256 columns (wide_fwd_kernel, wide_bwd_kernel): the two widths of
//   a product are split. The score products (S = Q K^T, dP = dO V^T, S^T =
//   K Q^T, dP^T = V dO^T) contract over the whole Dp = 64 ceil(D / 64), up
//   to 1024, their operands streaming through the contraction stages in
//   64-column boxes (a stage holds box x of each operand of the pass's one
//   or two score products, so shared memory does not grow with D; Q, or K
//   and V, is read again from L2 for every tile). The products that write
//   the output (O = P V, dQ = dS K, dK = dS^T Q, dV = P^T dO) write one
//   chunk of at most 256 columns, a multiple of 64: a block owns one (query
//   or key tile of 64 rows, chunk, head, batch) and its accumulator,
//   registers and epilogue are those of a Dp <= 256 block with one consumer
//   warpgroup. The chunk plan (wide_plan; ops/flash_attention.py
//   chunk_plan) cuts Dp into c = ceil(Dp / 256) chunks of whole boxes, the
//   widest at most one box wider than the rest: 192 + 128 at D 320, 4 x 256
//   at 1024. The blocks of one tile's chunks compute S in the same order, so
//   m, l and lse agree bit for bit; the first chunk's blocks write lse. The
//   backward's three passes (dV, dK, dQ; GQA sums in f32 registers, no
//   atomics, the exp(min(s - lse, 60)) clamp, bottom-right causal rows)
//   run as one launch, heaviest blocks first, so the few dK and dV blocks
//   (Sk / 64 x Hk x c) share the card with the dQ blocks; the forward is one
//   launch too. Every chunk recomputes the scores: with c chunks the forward
//   does (c + 1) / 2 of its 4-FLOP bound's work and the backward (5 c + 3) /
//   5 of its 10-FLOP bound's (1.5x and 2.6x at c = 2, 2.5x and 4.6x at c =
//   4). The alternative, two consumer warpgroups each holding half of the
//   output columns and sharing one P tile through shared memory, removes the
//   recompute only at c = 2 and needs 384 threads, which ptxas holds to 168
//   registers, below the 202-251 these blocks use. f32 runs through the
//   same split pre-pass and two pieces (one chunk stage in the dK and dQ
//   passes).
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
// - f32 and other head dims on SIMT kernels (FMA, no tensor cores): f32 at
//   S 2048 3.38 / 13.14 ms, bf16 at head_dim 96 2.92 / 11.24 ms; replaced
//   by the pieces and the padding above.
// - Past 256 columns, at head_dim 320, S 2048, H 8, Hk 2, causal, bf16
//   (SDPA's memory-efficient kernel 0.282-0.285 / 4.40-4.55 ms): SIMT
//   kernels, 128-column chunks in f32 shared memory, 8.17 / 33.04 ms;
//   these kernels with the backward as six launches (three passes x two
//   chunk widths, 64 dK or dV blocks a launch) 0.184 / 1.676 ms; with one
//   launch each way 0.150 / 0.630 ms; with each pass's A operands (Q; K
//   and V; Q and dO) resident in shared memory where they fit, only the B
//   side streamed, 0.144 / 0.628 ms (hd 1024 forward 0.074 -> 0.068):
//   the bytes from L2 are not what bounds them, and a second
//   instantiation of every kernel was not worth 5%; dropped.
//
// Not done yet: a persistent schedule, a one-pass backward (dQ reduced
// across blocks in order, FA3-style) and a fused delta = rowsum(dO * O);
// past 256 columns, more than one commit group of score products in flight
// and wider score tiles.

#include "hopper.cuh"

// The build compiles this file in parts, one nvcc each, started together,
// and links them (ops/_build.py PARTS): part 0 (-DKERNEL_PART=0) holds the
// C interface, the dispatch and the split pre-pass; parts 1 to 5 each
// instantiate the launches of the configurations listed for them after the
// kernels. Compiled whole (no KERNEL_PART), as tools/kernel_ab.py builds a
// variant, it is all of them in one library.
#ifdef KERNEL_PART
#define FLASH_HOST (KERNEL_PART == 0)
#define FLASH_KERNELS (KERNEL_PART != 0)
#else
#define FLASH_HOST 1
#define FLASH_KERNELS 1
#endif

namespace flash {

constexpr int kWG = 128;                  // threads of a warpgroup
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
constexpr int kMaxSmem = 232448;          // dynamic shared memory a block can have

struct Strides {
  long long b, s, h;
};

// B is the batch of the call (piece p of an f32 input is batch b + p B of
// its packed pieces); D the true head_dim
struct FwdArgs {
  void* o; float* lse;
  Strides so;
  int B, H, Hk, Sq, Sk, D;
  float scale;
  int causal;
};

struct BwdArgs {
  const float* lse; const float* delta;
  void* dq; void* dk; void* dv;
  Strides sdq, sdk, sdv;
  int B, H, Hk, Sq, Sk, D;
  float scale;
  int causal;
};

inline Strides strides_of(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// one kernel configuration: product type T, output type TO, padded head dim
// Dp, pieces NP, whether D < Dp is possible (kPad)
template <typename T_, typename TO_, int Dp_, int NP_, bool kPad_>
struct Cfg {
  using T = T_;
  using TO = TO_;
  static constexpr int Dp = Dp_, NP = NP_;
  static constexpr bool kPad = kPad_;
};

using bf = __nv_bfloat16;

// a configuration's launches: defined with the kernels, instantiated by the
// part that builds that configuration
template <typename C>
int launch_fwd(const void* q, const void* k, const void* v, const long long* st, const FwdArgs& a,
               cudaStream_t stream);
template <typename C>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const long long* st,
               const BwdArgs& a, cudaStream_t stream);

// past 256 columns: a configuration of the wide kernels (product type T,
// output type TO, pieces NP) and a call's plan: the score products contract
// over nbox boxes of 64 columns; the output is n0 chunks of Dc0 columns,
// then n1 chunks of Dc0 - 64 (wide_plan)
template <typename T_, typename TO_, int NP_>
struct WideCfg {
  using T = T_;
  using TO = TO_;
  static constexpr int NP = NP_;
};

struct WidePlan {
  int nbox, n0, n1;
};

template <typename C, int Dc0>
int launch_wide_fwd(const void* q, const void* k, const void* v, const long long* st,
                    const FwdArgs& a, WidePlan w, cudaStream_t stream);
template <typename C, int Dc0>
int launch_wide_bwd(const void* q, const void* k, const void* v, const void* dout,
                    const long long* st, const BwdArgs& a, WidePlan w, cudaStream_t stream);

#if FLASH_KERNELS

// A block of one pass: a producer warpgroup and kC consumer warpgroups for
// head dim Dp (a multiple of 64) with operands in NP bf16/fp16 pieces (1:
// the input itself; 2: an f32 input's split)
template <int Dp, int NP>
struct Shape {
  static_assert(Dp % kBox == 0 && Dp <= 256 && (NP == 1 || NP == 2), "tile shape");
  static constexpr int kC = NP == 1 && Dp <= 128 ? 2 : 1;
  static constexpr int kThreads = kWG * (1 + kC);
  static constexpr int kConsumerWarps = 4 * kC;   // arrivals that empty a stage
  static constexpr int kBoxes = Dp / kBox;
  static constexpr bool kPromote = NP > 1 && Dp <= 128;
};

// the pairs of pieces (i, j), i + j < NP, of a split product, smallest first
__host__ __device__ constexpr int npairs(int np) { return np == 1 ? 1 : 3; }
__host__ __device__ constexpr int pair_a(int np, int p) { return np == 1 ? 0 : p == 0; }
__host__ __device__ constexpr int pair_b(int np, int p) { return np == 1 ? 0 : p == 1; }

// the A fragments of a 64 x N accumulator, k-step by k-step, in NP pieces:
// piece 0 rounds to T, piece 1 rounds what piece 0 missed
template <typename T, int N, int NP>
__device__ __forceinline__ void to_a(uint32_t (&a)[NP][N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = d[8 * k + 2 * r], x1 = d[8 * k + 2 * r + 1];
      a[0][k][r] = pack2<T>(x0, x1);
      if constexpr (NP == 2) {
        static_assert(std::is_same<T, __nv_bfloat16>::value, "pieces are bf16");
        const float h0 = __uint_as_float(a[0][k][r] << 16);
        const float h1 = __uint_as_float(a[0][k][r] & 0xFFFF0000u);
        a[1][k][r] = pack2<T>(x0 - h0, x1 - h1);
      }
    }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S[64 x N] = A B^T over Dp columns: A and B K-major tiles of Dp / 64 boxes
// (a_box, b_box bytes apart), their pieces a_piece, b_piece bytes apart;
// acc != 0 adds to S
template <typename T, int N, int Dp, int NP>
__device__ __forceinline__ void mma_scores(float* s, uint32_t a, uint32_t a_box, uint32_t a_piece,
                                           uint32_t b, uint32_t b_box, uint32_t b_piece,
                                           int acc = 0) {
#pragma unroll
  for (int p = 0; p < npairs(NP); ++p)
#pragma unroll
    for (int x = 0; x < Dp / kBox; ++x)
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk)
        Mma<T, N>::template ss<0>(s, kmajor(a + pair_a(NP, p) * a_piece + x * a_box + kk * 32),
                                  kmajor(b + pair_b(NP, p) * b_piece + x * b_box + kk * 32),
                                  acc + p + x + kk);
}

// D[64 x Dp] (+)= A[64 x 16] B[16 x Dp], B MN-major in boxes box_bytes apart
template <typename T, int Dp>
__device__ __forceinline__ void mma_cols(float* d, const uint32_t* a, uint32_t b,
                                         uint32_t box_bytes, int acc) {
  if constexpr (Dp <= 128) {
    Mma<T, Dp>::template rs<1>(d, a, mnmajor(b, box_bytes), acc);
  } else {
    Mma<T, 128>::template rs<1>(d, a, mnmajor(b, box_bytes), acc);
    Mma<T, Dp - 128>::template rs<1>(d + 64, a, mnmajor(b + 2 * box_bytes, box_bytes), acc);
  }
}

// D[64 x Dp] (+)= A B over 16 KS rows: A the register fragments in NP
// pieces, B an MN-major tile (pieces b_piece bytes apart); acc 0 starts
// from zero
template <typename T, int KS, int Dp, int NP>
__device__ __forceinline__ void mma_rows(float* d, const uint32_t (&a)[NP][KS][4], uint32_t b,
                                         uint32_t box_bytes, uint32_t b_piece, int acc) {
#pragma unroll
  for (int p = 0; p < npairs(NP); ++p)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      mma_cols<T, Dp>(d, a[pair_a(NP, p)][kk], b + pair_b(NP, p) * b_piece + kk * 16 * kRowBytes,
                      box_bytes, acc | p | kk);
}

// rows row and row + 8 of a 64 x Dp accumulator to a [rows, D] slice with
// row stride rs (elements), rows at or past S skipped, columns past D too
// (kPad)
template <typename TO, int Dp, bool kPad>
__device__ __forceinline__ void store_rows(TO* g, long long rs, int row, int S, int D, int t4,
                                           const float (&d)[Dp / 2], const float* mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= S) continue;
    TO* p = g + (long long)(row + 8 * r) * rs + 2 * t4;
#pragma unroll
    for (int j = 0; j < Dp / 8; ++j) {
      if (kPad && 8 * j >= D) continue;
      const float x0 = d[4 * j + 2 * r] * mul[r], x1 = d[4 * j + 2 * r + 1] * mul[r];
      if constexpr (std::is_same<TO, float>::value)
        *reinterpret_cast<float2*>(p + 8 * j) = make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(p + 8 * j) = pack2<TO>(x0, x1);
    }
  }
}

// The scores of one tile to probabilities, on the accumulator layout: a
// warpgroup's 64 rows start at r0 (this thread's rows are row and row + 8),
// its N or M columns at k0 or q0; causal row i sees keys j <= i + Sk - Sq.

// forward: the scores s to log2 units, masked past Sk (kPad2) and, causal,
// past the row's last key (kMask2; only the diagonal tiles and the ragged
// tail hold such columns); the running maximum m and sum l updated; P left
// in s, and in alpha the factor that rescales the rows' earlier sums
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const FwdArgs& a, int k0, int r0,
                                             int row, int t4) {
  const float sl2 = a.scale * kLog2e;
  const int off = a.Sk - a.Sq;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] *= sl2;
  if (k0 + N > a.Sk || (a.causal && k0 + N - 1 > r0 + off)) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (col >= a.Sk)
        s[i] = kPad2;
      else if (a.causal && col > row + 8 * ((i >> 1) & 1) + off)
        s[i] = kMask2;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    s[i] = ex2(s[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];
  }
}

// the rows' lse in log2 units and delta (zeros past Sq)
__device__ __forceinline__ void row_stats(float (&lse2)[2], float (&dl)[2], const BwdArgs& a,
                                          int b, int h, int row) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row + 8 * r < a.Sq;
    const long long i = ((long long)b * a.H + h) * a.Sq + row + 8 * r;
    lse2[r] = ok ? a.lse[i] * kLog2e : 0.f;
    dl[r] = ok ? a.delta[i] : 0.f;
  }
}

// dQ pass: P = exp(min(s - lse, 60)) (lse2 in log2 units), zero past Sk
// and, causal, past the row's last key
template <int N>
__device__ __forceinline__ void probs(float (&s)[N / 2], const BwdArgs& a, const float (&lse2)[2],
                                      int k0, int r0, int row, int t4) {
  const float sl2 = a.scale * kLog2e;
  const int off = a.Sk - a.Sq;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = ex2(fminf(s[i] * sl2 - lse2[(i >> 1) & 1], kClamp2));
  if (k0 + N > a.Sk || (a.causal && k0 + N - 1 > r0 + off)) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (col >= a.Sk || (a.causal && col > row + 8 * ((i >> 1) & 1) + off)) s[i] = 0.f;
    }
  }
}

// dK and dV passes, transposed (rows are keys from r0, this thread's krow
// and krow + 8; M query columns from q0, their lse at ls and delta at ls +
// M): P^T = exp(min(s - lse, 60)), zero for queries past Sq and, causal,
// keys after the query's last; in the dV pass (kDV) a query that sees no
// key gives 1 / Sk to every key
template <int M, bool kDV>
__device__ __forceinline__ void probs_t(float (&s)[M / 2], const BwdArgs& a, const float* ls,
                                        int q0, int r0, int krow, int t4) {
  const float sl2 = a.scale * kLog2e;
  const int off = a.Sk - a.Sq;
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const int qc = 8 * (i >> 2) + 2 * t4 + (i & 1);
    s[i] = ex2(fminf(s[i] * sl2 - ls[qc] * kLog2e, kClamp2));
  }
  if (q0 + M > a.Sq || (a.causal && r0 + 63 > q0 + off)) {
    const float inv_sk = 1.f / a.Sk;
#pragma unroll
    for (int i = 0; i < M / 2; ++i) {
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
}

// dK pass: dS^T = P^T (dP^T - delta) scale, in dp
template <int M>
__device__ __forceinline__ void ds_t(float (&dp)[M / 2], const float (&s)[M / 2],
                                     const BwdArgs& a, const float* ls, int t4) {
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const int qc = 8 * (i >> 2) + 2 * t4 + (i & 1);
    dp[i] = s[i] * (dp[i] - ls[M + qc]) * a.scale;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int Dp, int NP>
struct FwdGeo : Shape<Dp, NP> {
  using S = Shape<Dp, NP>;
  static constexpr int kM = 64 * S::kC;              // query rows of a block
  static constexpr int kN =                          // K/V rows of a tile
      NP == 1 ? (Dp <= 192 ? 128 : 64) : (Dp == 64 ? 128 : Dp == 128 ? 64 : 32);
  static constexpr int kStages = 2;
  static constexpr int kQBox = kM * kRowBytes;
  static constexpr int kQPiece = S::kBoxes * kQBox;
  static constexpr int kBoxBytes = kN * kRowBytes;   // one box of a K or V tile
  static constexpr int kPiece = S::kBoxes * kBoxBytes;
  static constexpr int kTileBytes = NP * kPiece;
  static constexpr int kQ = 0;
  static constexpr int kK = NP * kQPiece;            // [kStages]
  static constexpr int kV = kK + kStages * kTileBytes;   // [kStages]
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kSmem = kBar + 128 + 1024;    // barriers, alignment slack
};

template <typename T, typename TO, int Dp, int NP, bool kPad>
__global__ void __launch_bounds__(Shape<Dp, NP>::kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const FwdArgs a) {
  using G = FwdGeo<Dp, NP>;
  constexpr int kS = G::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + G::kBar);
  uint64_t* k_full = q_full + 1;            // [kS]
  uint64_t* k_empty = q_full + 1 + kS;      // [kS]
  uint64_t* v_full = q_full + 1 + 2 * kS;   // [kS]
  uint64_t* v_empty = q_full + 1 + 3 * kS;  // [kS]

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
    for (int i = 0; i < kS; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(v_full + i, 1);
      mbar_init(k_empty + i, G::kConsumerWarps);
      mbar_init(v_empty + i, G::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, NP * G::kQPiece);
      for (int p = 0; p < NP; ++p)
        for (int x = 0; x < G::kBoxes; ++x)
          tma_load(sm + G::kQ + p * G::kQPiece + x * G::kQBox, &tq, q_full, x * kBox, h, q0,
                   b + p * a.B);
      for (int it = 0; it < nk; ++it) {
        const int st = it % kS;
        const uint32_t ph = (it / kS) & 1;
        mbar_wait(k_empty + st, ph ^ 1);
        mbar_expect_tx(k_full + st, G::kTileBytes);
        for (int p = 0; p < NP; ++p)
          for (int x = 0; x < G::kBoxes; ++x)
            tma_load(sm + G::kK + st * G::kTileBytes + p * G::kPiece + x * G::kBoxBytes, &tk,
                     k_full + st, x * kBox, hk, it * G::kN, b + p * a.B);
        mbar_wait(v_empty + st, ph ^ 1);
        mbar_expect_tx(v_full + st, G::kTileBytes);
        for (int p = 0; p < NP; ++p)
          for (int x = 0; x < G::kBoxes; ++x)
            tma_load(sm + G::kV + st * G::kTileBytes + p * G::kPiece + x * G::kBoxBytes, &tv,
                     v_full + st, x * kBox, hk, it * G::kN, b + p * a.B);
      }
    }
  } else {
    const int c = threadIdx.x / kWG - 1;           // query rows c * 64 .. of the block
    const int t = threadIdx.x % kWG, t4 = t % 4;
    const int row = q0 + c * 64 + (t / 32) * 16 + (t % 32) / 4;   // and row + 8
    const uint32_t qs = smem_u32(sm + G::kQ) + c * 64 * kRowBytes;
    float o[Dp / 2];
#pragma unroll
    for (int i = 0; i < Dp / 2; ++i) o[i] = 0.f;
    float m[2] = {kInit2, kInit2}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int it = 0; it < nk; ++it) {
      const int st = it % kS;
      const uint32_t ph = (it / kS) & 1;
      const int k0 = it * G::kN;
      const uint32_t ks = smem_u32(sm + G::kK + st * G::kTileBytes);
      const uint32_t vs = smem_u32(sm + G::kV + st * G::kTileBytes);

      float s[G::kN / 2];
      mbar_wait(k_full + st, ph);
      wg_fence();
      mma_scores<T, G::kN, Dp, NP>(s, qs, G::kQBox, G::kQPiece, ks, G::kBoxBytes, G::kPiece);
      wg_commit();
      wg_wait();
      fence_regs(s);
      release(k_empty + st);

      float alpha[2];
      softmax_tile<G::kN>(s, m, l, alpha, a, k0, q0 + c * 64, row, t4);
      if constexpr (!G::kPromote) {
#pragma unroll
        for (int i = 0; i < Dp / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
      uint32_t pa[NP][G::kN / 16][4];
      to_a<T, G::kN, NP>(pa, s);

      mbar_wait(v_full + st, ph);
      wg_fence();
      if constexpr (G::kPromote) {
        float pv[Dp / 2];                          // this tile's P V, then O = O alpha + P V
        mma_rows<T, G::kN / 16, Dp, NP>(pv, pa, vs, G::kBoxBytes, G::kPiece, 0);
        wg_commit();
        wg_wait();
        fence_regs(pv);
#pragma unroll
        for (int i = 0; i < Dp / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], pv[i]);
      } else {
        mma_rows<T, G::kN / 16, Dp, NP>(o, pa, vs, G::kBoxBytes, G::kPiece, 1);
        wg_commit();
        wg_wait();
        fence_regs(o);
      }
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
    store_rows<TO, Dp, kPad>(static_cast<TO*>(a.o) + b * a.so.b + h * a.so.h, a.so.s, row, a.Sq,
                             a.D, t4, o, inv);
  }
}

// ---------------------------------------------------------------------------
// backward: dV, then dK
// ---------------------------------------------------------------------------

template <int Dp, int NP>
struct KvGeo : Shape<Dp, NP> {
  using S = Shape<Dp, NP>;
  static constexpr int kN = 64 * S::kC;              // K/V rows of a block
  static constexpr int kM = NP == 2 && Dp >= 192 ? 32 : 64;   // query rows of a tile
  static constexpr int kStages =
      NP == 1 ? (Dp <= 192 ? 3 : 2) : (Dp == 64 ? 3 : Dp <= 192 ? 2 : 1);
  static constexpr int kKBox = kN * kRowBytes;
  static constexpr int kKPiece = S::kBoxes * kKBox;
  static constexpr int kQBox = kM * kRowBytes;
  static constexpr int kQPiece = S::kBoxes * kQBox;
  static constexpr int kQBytes = NP * kQPiece;       // one Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = NP * kKPiece;
  static constexpr int kQ = 2 * kV;                        // [kStages]
  static constexpr int kDO = kQ + kStages * kQBytes;       // [kStages]
  static constexpr int kStat = kDO + kStages * kQBytes;    // [kStages][lse | delta][kM] f32
  static constexpr int kStatBytes = 2 * kM * 4;
  static constexpr int kBar = kStat + kStages * kStatBytes;
  static constexpr int kSmem = kBar + 128 + 1024;
};

// kDV: dV += P^T dO (S^T, then one product); else dK += dS^T Q (S^T and
// dP^T, then one product)
template <typename T, typename TO, int Dp, int NP, bool kPad, bool kDV>
__global__ void __launch_bounds__(Shape<Dp, NP>::kThreads, 1)
    flash_bwd_kv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, const BwdArgs a) {
  using G = KvGeo<Dp, NP>;
  constexpr int kS = G::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + G::kBar);
  uint64_t* full = kv_full + 1;          // [kS]
  uint64_t* empty = kv_full + 1 + kS;    // [kS]
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

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < kS; ++i) {
      mbar_init(full + i, 32);                     // the producer warp's lanes
      mbar_init(empty + i, G::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * NP * G::kKPiece);
      for (int p = 0; p < NP; ++p)
        for (int x = 0; x < G::kBoxes; ++x) {
          tma_load(sm + G::kK + p * G::kKPiece + x * G::kKBox, &tk, kv_full, x * kBox, hk, k0,
                   b + p * a.B);
          tma_load(sm + G::kV + p * G::kKPiece + x * G::kKBox, &tv, kv_full, x * kBox, hk, k0,
                   b + p * a.B);
        }
    }
    if (threadIdx.x < 32) {
      constexpr int kR = G::kM / 32;               // rows a lane copies
      for (int it = 0; it < total; ++it) {
        const int st = it % kS;
        const uint32_t ph = (it / kS) & 1;
        const int h = hk * rep + it / per_head;
        const int q0 = (q_start + it % per_head) * G::kM;
        // lse and delta of the tile's rows, read before the stage is free;
        // zeros past S
        const long long so = ((long long)b * a.H + h) * a.Sq + q0;
        float lse[kR], delta[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const bool ok = q0 + lane + 32 * r < a.Sq;
          lse[r] = ok ? a.lse[so + lane + 32 * r] : 0.f;
          delta[r] = ok ? a.delta[so + lane + 32 * r] : 0.f;
        }
        mbar_wait(empty + st, ph ^ 1);
        float* ls = stat + st * 2 * G::kM;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          ls[lane + 32 * r] = lse[r];
          ls[G::kM + lane + 32 * r] = delta[r];
        }
        if (lane == 0) {
          mbar_expect_tx(full + st, 2 * G::kQBytes);
          for (int p = 0; p < NP; ++p)
            for (int x = 0; x < G::kBoxes; ++x) {
              tma_load(sm + G::kQ + st * G::kQBytes + p * G::kQPiece + x * G::kQBox, &tq,
                       full + st, x * kBox, h, q0, b + p * a.B);
              tma_load(sm + G::kDO + st * G::kQBytes + p * G::kQPiece + x * G::kQBox, &tdo,
                       full + st, x * kBox, h, q0, b + p * a.B);
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
    const uint32_t ks = smem_u32(sm + G::kK) + c * 64 * kRowBytes;
    const uint32_t vs = smem_u32(sm + G::kV) + c * 64 * kRowBytes;
    float acc[Dp / 2];                             // dV or dK of this warpgroup's rows
#pragma unroll
    for (int i = 0; i < Dp / 2; ++i) acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int it = 0; it < total; ++it) {
      const int st = it % kS;
      const uint32_t ph = (it / kS) & 1;
      const int q0 = (q_start + it % per_head) * G::kM;
      const uint32_t qs = smem_u32(sm + G::kQ + st * G::kQBytes);
      const uint32_t dos = smem_u32(sm + G::kDO + st * G::kQBytes);
      const float* ls = stat + st * 2 * G::kM;

      // S^T (and dP^T): 64 K rows x kM query columns
      float s[G::kM / 2], dp[G::kM / 2];
      mbar_wait(full + st, ph);
      wg_fence();
      mma_scores<T, G::kM, Dp, NP>(s, ks, G::kKBox, G::kKPiece, qs, G::kQBox, G::kQPiece);
      wg_commit();
      if constexpr (!kDV) {
        mma_scores<T, G::kM, Dp, NP>(dp, vs, G::kKBox, G::kKPiece, dos, G::kQBox, G::kQPiece);
        wg_commit();
        wg_wait<1>();                              // P^T while dP^T is computed
      } else {
        wg_wait();
      }
      fence_regs(s);

      probs_t<G::kM, kDV>(s, a, ls, q0, k0 + c * 64, krow, t4);
      uint32_t fa[NP][G::kM / 16][4];              // P^T or dS^T as the A operand
      if constexpr (kDV) {
        to_a<T, G::kM, NP>(fa, s);
      } else {
        wg_wait();
        fence_regs(dp);
        ds_t<G::kM>(dp, s, a, ls, t4);
        to_a<T, G::kM, NP>(fa, dp);
      }

      // dV += P^T dO, or dK += dS^T Q
      const uint32_t bs = kDV ? dos : qs;
      wg_fence();
      if constexpr (G::kPromote) {
        float part[Dp / 2];                        // this tile's product, added in f32
        mma_rows<T, G::kM / 16, Dp, NP>(part, fa, bs, G::kQBox, G::kQPiece, 0);
        wg_commit();
        wg_wait();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < Dp / 2; ++i) acc[i] += part[i];
      } else {
        mma_rows<T, G::kM / 16, Dp, NP>(acc, fa, bs, G::kQBox, G::kQPiece, 1);
        wg_commit();
        wg_wait();
        fence_regs(acc);
      }
      release(empty + st);
    }

    const float one[2] = {1.f, 1.f};
    if constexpr (kDV)
      store_rows<TO, Dp, kPad>(static_cast<TO*>(a.dv) + b * a.sdv.b + hk * a.sdv.h, a.sdv.s,
                               krow, a.Sk, a.D, t4, acc, one);
    else
      store_rows<TO, Dp, kPad>(static_cast<TO*>(a.dk) + b * a.sdk.b + hk * a.sdk.h, a.sdk.s,
                               krow, a.Sk, a.D, t4, acc, one);
  }
}

// ---------------------------------------------------------------------------
// backward: dQ
// ---------------------------------------------------------------------------

template <int Dp, int NP>
struct DqGeo : Shape<Dp, NP> {
  using S = Shape<Dp, NP>;
  static constexpr int kM = 64 * S::kC;              // query rows of a block
  static constexpr int kN = NP == 2 && Dp >= 192 ? 32 : 64;   // K/V rows of a tile
  static constexpr int kStages = NP == 2 && Dp == 256 ? 1 : 2;
  static constexpr int kQBox = kM * kRowBytes;
  static constexpr int kQPiece = S::kBoxes * kQBox;
  static constexpr int kBoxBytes = kN * kRowBytes;   // one box of a K or V tile
  static constexpr int kPiece = S::kBoxes * kBoxBytes;
  static constexpr int kTileBytes = NP * kPiece;
  static constexpr int kQ = 0;
  static constexpr int kDO = NP * kQPiece;
  static constexpr int kK = 2 * kDO;                 // [kStages]
  static constexpr int kV = kK + kStages * kTileBytes;   // [kStages]
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kSmem = kBar + 128 + 1024;
};

template <typename T, typename TO, int Dp, int NP, bool kPad>
__global__ void __launch_bounds__(Shape<Dp, NP>::kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const BwdArgs a) {
  using G = DqGeo<Dp, NP>;
  constexpr int kS = G::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(sm + G::kBar);
  uint64_t* kv_full = qd_full + 1;         // [kS]
  uint64_t* kv_empty = qd_full + 1 + kS;   // [kS]

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
    for (int i = 0; i < kS; ++i) {
      mbar_init(kv_full + i, 1);
      mbar_init(kv_empty + i, G::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(qd_full, 2 * NP * G::kQPiece);
      for (int p = 0; p < NP; ++p)
        for (int x = 0; x < G::kBoxes; ++x) {
          tma_load(sm + G::kQ + p * G::kQPiece + x * G::kQBox, &tq, qd_full, x * kBox, h, q0,
                   b + p * a.B);
          tma_load(sm + G::kDO + p * G::kQPiece + x * G::kQBox, &tdo, qd_full, x * kBox, h, q0,
                   b + p * a.B);
        }
      for (int it = 0; it < nk; ++it) {
        const int st = it % kS;
        const uint32_t ph = (it / kS) & 1;
        mbar_wait(kv_empty + st, ph ^ 1);
        mbar_expect_tx(kv_full + st, 2 * G::kTileBytes);
        for (int p = 0; p < NP; ++p)
          for (int x = 0; x < G::kBoxes; ++x) {
            tma_load(sm + G::kK + st * G::kTileBytes + p * G::kPiece + x * G::kBoxBytes, &tk,
                     kv_full + st, x * kBox, hk, it * G::kN, b + p * a.B);
            tma_load(sm + G::kV + st * G::kTileBytes + p * G::kPiece + x * G::kBoxBytes, &tv,
                     kv_full + st, x * kBox, hk, it * G::kN, b + p * a.B);
          }
      }
    }
  } else {
    const int c = threadIdx.x / kWG - 1;           // query rows c * 64 .. of the block
    const int t = threadIdx.x % kWG, t4 = t % 4;
    const int row = q0 + c * 64 + (t / 32) * 16 + (t % 32) / 4;   // and row + 8
    const uint32_t qs = smem_u32(sm + G::kQ) + c * 64 * kRowBytes;
    const uint32_t dos = smem_u32(sm + G::kDO) + c * 64 * kRowBytes;
    float lse2[2], dl[2];
    row_stats(lse2, dl, a, b, h, row);
    float dq[Dp / 2];
#pragma unroll
    for (int i = 0; i < Dp / 2; ++i) dq[i] = 0.f;
    mbar_wait(qd_full, 0);

    for (int it = 0; it < nk; ++it) {
      const int st = it % kS;
      const uint32_t ph = (it / kS) & 1;
      const int k0 = it * G::kN;
      const uint32_t ks = smem_u32(sm + G::kK + st * G::kTileBytes);
      const uint32_t vs = smem_u32(sm + G::kV + st * G::kTileBytes);

      float s[G::kN / 2], dp[G::kN / 2];
      mbar_wait(kv_full + st, ph);
      wg_fence();
      mma_scores<T, G::kN, Dp, NP>(s, qs, G::kQBox, G::kQPiece, ks, G::kBoxBytes, G::kPiece);
      wg_commit();
      mma_scores<T, G::kN, Dp, NP>(dp, dos, G::kQBox, G::kQPiece, vs, G::kBoxBytes, G::kPiece);
      wg_commit();
      wg_wait<1>();                                // P while dP is computed
      fence_regs(s);

      probs<G::kN>(s, a, lse2, k0, q0 + c * 64, row, t4);
      wg_wait();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < G::kN / 2; ++i)
        dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]) * a.scale;
      uint32_t da[NP][G::kN / 16][4];
      to_a<T, G::kN, NP>(da, dp);

      // dQ += dS K
      wg_fence();
      if constexpr (G::kPromote) {
        float part[Dp / 2];                        // this tile's product, added in f32
        mma_rows<T, G::kN / 16, Dp, NP>(part, da, ks, G::kBoxBytes, G::kPiece, 0);
        wg_commit();
        wg_wait();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < Dp / 2; ++i) dq[i] += part[i];
      } else {
        mma_rows<T, G::kN / 16, Dp, NP>(dq, da, ks, G::kBoxBytes, G::kPiece, 1);
        wg_commit();
        wg_wait();
        fence_regs(dq);
      }
      release(kv_empty + st);
    }

    const float one[2] = {1.f, 1.f};
    store_rows<TO, Dp, kPad>(static_cast<TO*>(a.dq) + b * a.sdq.b + h * a.sdq.h, a.sdq.s, row,
                             a.Sq, a.D, t4, dq, one);
  }
}

// ---------------------------------------------------------------------------
// past 256 columns: the contraction streamed in boxes, the output in chunks
// ---------------------------------------------------------------------------

// A block of a wide kernel: a producer and one consumer warpgroup, query and
// key tiles of 64 rows. A contraction stage holds one 64-column box (NP
// pieces) of each operand of kPairs score products, operand j's piece p
// (j NP + p) boxes in (A0 B0 A1 B1); a chunk stage the Dc columns of one
// tile of the chunk product's B operand (NP pieces of Dc / 64 boxes) and
// the tile's lse and delta. The chunk stages take their share first; the
// contraction stages (at most 4) what shared memory is left.
template <int Dc, int NP, int kPairs>
struct WideGeo {
  static_assert(Dc % kBox == 0 && Dc <= 256 && (NP == 1 || NP == 2), "chunk shape");
  static constexpr int kConsumerWarps = 4;
  static constexpr int kR = 64;                                // rows of a tile
  static constexpr bool kPromote = NP > 1 && Dc <= 128;
  static constexpr int kBoxBytes = kR * kRowBytes;
  static constexpr int kCBytes = 2 * kPairs * NP * kBoxBytes;  // a contraction stage
  static constexpr int kTPiece = Dc / kBox * kBoxBytes;
  static constexpr int kTBytes = NP * kTPiece;                 // a chunk stage
  static constexpr int kStatBytes = 2 * kR * 4;                // lse | delta, f32
  static constexpr int kTStages = NP == 2 && kPairs == 2 ? 1 : 2;
  static constexpr int kLeft = 230400 - kTStages * (kTBytes + kStatBytes);
  static constexpr int kCStages = kLeft / kCBytes < 4 ? kLeft / kCBytes : 4;
  static_assert(kCStages >= 2, "contraction stages");
  static constexpr int kC = 0;                                 // [kCStages]
  static constexpr int kT = kCStages * kCBytes;                // [kTStages]
  static constexpr int kStat = kT + kTStages * kTBytes;        // [kTStages]
  static constexpr int kBar = kStat + kTStages * kStatBytes;
  static constexpr int kSmem = kBar + 128 + 1024;
  static_assert(kSmem <= kMaxSmem, "shared memory");
};

// The score products (S, and with kPairs 2 dP) of one tile: the nbox boxes
// of the contraction stream through the contraction stages, n counting the
// stages the block has taken. A box's products are one commit group; a
// stage is released once the next box's group is issued and its own done.
template <typename T, typename G, int NP, int kPairs>
__device__ __forceinline__ void contract(float* s, float* dp, unsigned char* sm, uint64_t* full,
                                         uint64_t* empty, int& n, int nbox) {
  constexpr int kB = G::kBoxBytes, kA = NP * kB;
  for (int x = 0; x < nbox; ++x, ++n) {
    const int st = n % G::kCStages;
    mbar_wait(full + st, (n / G::kCStages) & 1);
    const uint32_t c = smem_u32(sm + G::kC + st * G::kCBytes);
    wg_fence();
    mma_scores<T, G::kR, kBox, NP>(s, c, 0, kB, c + kA, 0, kB, x);
    if constexpr (kPairs == 2)
      mma_scores<T, G::kR, kBox, NP>(dp, c + 2 * kA, 0, kB, c + 3 * kA, 0, kB, x);
    wg_commit();
    if (x > 0) {
      wg_wait<1>();
      release(empty + (n - 1) % G::kCStages);
    }
  }
  wg_wait();
  release(empty + (n - 1) % G::kCStages);
}

// the producer's loads of one tile's contraction: each box x of the 2
// kPairs operands j (map[j] at head[j], rows from row[j]), NP pieces each
template <typename G, int NP, int kPairs>
__device__ __forceinline__ void load_contraction(unsigned char* sm, uint64_t* full,
                                                 uint64_t* empty, int& n, int nbox,
                                                 const CUtensorMap* const* map, const int* head,
                                                 const int* row, int b, int B) {
  for (int x = 0; x < nbox; ++x, ++n) {
    const int st = n % G::kCStages;
    mbar_wait(empty + st, ((n / G::kCStages) & 1) ^ 1);
    mbar_expect_tx(full + st, G::kCBytes);
    unsigned char* c = sm + G::kC + st * G::kCBytes;
    for (int j = 0; j < 2 * kPairs; ++j)
      for (int p = 0; p < NP; ++p)
        tma_load(c + (j * NP + p) * G::kBoxBytes, map[j], full + st, x * kBox, head[j], row[j],
                 b + p * B);
  }
}

// the producer's load of one chunk stage: rows row.. of head `head`,
// columns c0 .. c0 + Dc, NP pieces
template <typename G, int NP, int Dc>
__device__ __forceinline__ void load_chunk(unsigned char* dst, const CUtensorMap* map,
                                           uint64_t* full, int c0, int head, int row, int b,
                                           int B) {
  mbar_expect_tx(full, G::kTBytes);
  for (int p = 0; p < NP; ++p)
    for (int j = 0; j < Dc / kBox; ++j)
      tma_load(dst + p * G::kTPiece + j * G::kBoxBytes, map, full, c0 + j * kBox, head, row,
               b + p * B);
}

// D[64 x Dc] += A B over one 64-row tile (A the register fragments, B a
// chunk stage); with kPromote the tile's product starts from zero and is
// added in f32
template <typename T, typename G, int Dc, int NP>
__device__ __forceinline__ void chunk_product(float (&d)[Dc / 2],
                                              const uint32_t (&fa)[NP][G::kR / 16][4],
                                              uint32_t bs) {
  wg_fence();
  if constexpr (G::kPromote) {
    float part[Dc / 2];
    mma_rows<T, G::kR / 16, Dc, NP>(part, fa, bs, G::kBoxBytes, G::kTPiece, 0);
    wg_commit();
    wg_wait();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < Dc / 2; ++i) d[i] += part[i];
  } else {
    mma_rows<T, G::kR / 16, Dc, NP>(d, fa, bs, G::kBoxBytes, G::kTPiece, 1);
    wg_commit();
    wg_wait();
    fence_regs(d);
  }
}

// The blocks of the wide kernels, each one (tile, output chunk, head,
// batch): the tile's 64 rows from q0 or k0, the chunk's Dc columns from c0,
// the contraction over nbox boxes; sm is the block's shared memory, laid
// out by WideGeo.

// forward: O of the chunk and (the first chunk's blocks) lse
template <typename T, typename TO, int Dc, int NP>
__device__ __forceinline__ void fwd_block(const CUtensorMap* tq, const CUtensorMap* tk,
                                          const CUtensorMap* tv, const FwdArgs& a, int nbox,
                                          int q0, int c0, int h, int b, unsigned char* sm) {
  using G = WideGeo<Dc, NP, 1>;
  constexpr int kCS = G::kCStages, kTS = G::kTStages, kR = G::kR;
  uint64_t* c_full = reinterpret_cast<uint64_t*>(sm + G::kBar);   // [kCS]
  uint64_t* c_empty = c_full + kCS;                                // [kCS]
  uint64_t* t_full = c_full + 2 * kCS;                             // [kTS]
  uint64_t* t_empty = t_full + kTS;                                // [kTS]
  const int hk = h / (a.H / a.Hk);
  const int off = a.Sk - a.Sq;
  const int nk_all = (a.Sk + kR - 1) / kR;
  // a tile with a row that sees no key walks all keys: that row is uniform
  const int nk = !a.causal || q0 + off < 0 ? nk_all : min(nk_all, (q0 + kR - 1 + off) / kR + 1);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kCS; ++i) {
      mbar_init(c_full + i, 1);
      mbar_init(c_empty + i, G::kConsumerWarps);
    }
    for (int i = 0; i < kTS; ++i) {
      mbar_init(t_full + i, 1);
      mbar_init(t_empty + i, G::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    if (threadIdx.x == 0) {
      const CUtensorMap* const maps[2] = {tq, tk};
      const int heads[2] = {h, hk};
      int n = 0;
      for (int it = 0; it < nk; ++it) {
        // V's chunk first: its stage was freed two tiles ago
        const int ts = it % kTS;
        mbar_wait(t_empty + ts, ((it / kTS) & 1) ^ 1);
        load_chunk<G, NP, Dc>(sm + G::kT + ts * G::kTBytes, tv, t_full + ts, c0, hk, it * kR, b,
                              a.B);
        const int rows[2] = {q0, it * kR};
        load_contraction<G, NP, 1>(sm, c_full, c_empty, n, nbox, maps, heads, rows, b, a.B);
      }
    }
  } else {
    const int t = threadIdx.x - kWG, t4 = t % 4;
    const int row = q0 + (t / 32) * 16 + (t % 32) / 4;   // and row + 8
    float o[Dc / 2];
#pragma unroll
    for (int i = 0; i < Dc / 2; ++i) o[i] = 0.f;
    float m[2] = {kInit2, kInit2}, l[2] = {0.f, 0.f};
    int n = 0;
    for (int it = 0; it < nk; ++it) {
      float s[kR / 2];
      contract<T, G, NP, 1>(s, s, sm, c_full, c_empty, n, nbox);
      fence_regs(s);
      float alpha[2];
      softmax_tile<kR>(s, m, l, alpha, a, it * kR, q0, row, t4);
#pragma unroll
      for (int i = 0; i < Dc / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      uint32_t pa[NP][kR / 16][4];
      to_a<T, kR, NP>(pa, s);
      const int ts = it % kTS;
      mbar_wait(t_full + ts, (it / kTS) & 1);
      chunk_product<T, G, Dc, NP>(o, pa, smem_u32(sm + G::kT + ts * G::kTBytes));
      release(t_empty + ts);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
      inv[r] = 1.f / l[r];
      // every chunk's block has the same m and l: the first chunk's writes lse
      if (c0 == 0 && t4 == 0 && row + 8 * r < a.Sq)
        a.lse[((long long)b * a.H + h) * a.Sq + row + 8 * r] = m[r] * kLn2 + logf(l[r]);
    }
    store_rows<TO, Dc, true>(static_cast<TO*>(a.o) + b * a.so.b + h * a.so.h + c0, a.so.s, row,
                             a.Sq, a.D - c0, t4, o, inv);
  }
}

// dV (kDV) or dK of one key tile's chunk, summed over the KV head hk's group
template <typename T, typename TO, int Dc, int NP, bool kDV>
__device__ __forceinline__ void kv_block(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const CUtensorMap* tdo,
                                         const BwdArgs& a, int nbox, int k0, int c0, int hk,
                                         int b, unsigned char* sm) {
  constexpr int kPairs = kDV ? 1 : 2;
  using G = WideGeo<Dc, NP, kPairs>;
  constexpr int kCS = G::kCStages, kTS = G::kTStages, kR = G::kR;
  uint64_t* c_full = reinterpret_cast<uint64_t*>(sm + G::kBar);
  uint64_t* c_empty = c_full + kCS;
  uint64_t* t_full = c_full + 2 * kCS;
  uint64_t* t_empty = t_full + kTS;
  float* stat = reinterpret_cast<float*>(sm + G::kStat);

  const int rep = a.H / a.Hk;
  const int off = a.Sk - a.Sq;
  const int nq = (a.Sq + kR - 1) / kR;
  // the Q tiles that see this block's keys; in the dV pass, when some rows
  // see no key (causal, Sk < Sq), all of them
  const int q_start = !a.causal || (kDV && off < 0) ? 0 : max(0, k0 - off) / kR;
  const int per_head = max(0, nq - q_start);
  const int total = rep * per_head;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kCS; ++i) {
      mbar_init(c_full + i, 1);
      mbar_init(c_empty + i, G::kConsumerWarps);
    }
    for (int i = 0; i < kTS; ++i) {
      mbar_init(t_full + i, 32);                  // the producer warp's lanes
      mbar_init(t_empty + i, G::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const CUtensorMap* const maps[4] = {tk, tq, tv, tdo};
    int n = 0;
    for (int it = 0; it < total; ++it) {
      const int h = hk * rep + it / per_head;
      const int q0 = (q_start + it % per_head) * kR;
      // the chunk stage: lse and delta of the tile's rows (zeros past Sq),
      // then dO's (dV) or Q's (dK) chunk
      const long long so = ((long long)b * a.H + h) * a.Sq + q0;
      float lse[2], delta[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool ok = q0 + lane + 32 * r < a.Sq;
        lse[r] = ok ? a.lse[so + lane + 32 * r] : 0.f;
        delta[r] = ok ? a.delta[so + lane + 32 * r] : 0.f;
      }
      const int ts = it % kTS;
      mbar_wait(t_empty + ts, ((it / kTS) & 1) ^ 1);
      float* ls = stat + ts * 2 * kR;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ls[lane + 32 * r] = lse[r];
        ls[kR + lane + 32 * r] = delta[r];
      }
      if (lane == 0) {
        load_chunk<G, NP, Dc>(sm + G::kT + ts * G::kTBytes, kDV ? tdo : tq, t_full + ts, c0, h,
                              q0, b, a.B);
        const int heads[4] = {hk, h, hk, h}, rows[4] = {k0, q0, k0, q0};
        load_contraction<G, NP, kPairs>(sm, c_full, c_empty, n, nbox, maps, heads, rows, b, a.B);
      } else {
        mbar_arrive(t_full + ts);
      }
    }
  } else if (threadIdx.x >= kWG) {
    const int t = threadIdx.x - kWG, t4 = t % 4;
    const int krow = k0 + (t / 32) * 16 + (t % 32) / 4;   // and krow + 8
    float acc[Dc / 2];                                    // dV or dK of the chunk
#pragma unroll
    for (int i = 0; i < Dc / 2; ++i) acc[i] = 0.f;
    int n = 0;
    for (int it = 0; it < total; ++it) {
      const int q0 = (q_start + it % per_head) * kR;
      float s[kR / 2], dp[kR / 2];                        // S^T (and dP^T)
      contract<T, G, NP, kPairs>(s, dp, sm, c_full, c_empty, n, nbox);
      fence_regs(s);
      const int ts = it % kTS;
      mbar_wait(t_full + ts, (it / kTS) & 1);
      const float* ls = stat + ts * 2 * kR;
      probs_t<kR, kDV>(s, a, ls, q0, k0, krow, t4);
      uint32_t fa[NP][kR / 16][4];                       // P^T or dS^T
      if constexpr (kDV) {
        to_a<T, kR, NP>(fa, s);
      } else {
        fence_regs(dp);
        ds_t<kR>(dp, s, a, ls, t4);
        to_a<T, kR, NP>(fa, dp);
      }
      chunk_product<T, G, Dc, NP>(acc, fa, smem_u32(sm + G::kT + ts * G::kTBytes));
      release(t_empty + ts);
    }
    const float one[2] = {1.f, 1.f};
    if constexpr (kDV)
      store_rows<TO, Dc, true>(static_cast<TO*>(a.dv) + b * a.sdv.b + hk * a.sdv.h + c0,
                               a.sdv.s, krow, a.Sk, a.D - c0, t4, acc, one);
    else
      store_rows<TO, Dc, true>(static_cast<TO*>(a.dk) + b * a.sdk.b + hk * a.sdk.h + c0,
                               a.sdk.s, krow, a.Sk, a.D - c0, t4, acc, one);
  }
}

// dQ of one query tile's chunk
template <typename T, typename TO, int Dc, int NP>
__device__ __forceinline__ void dq_block(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const CUtensorMap* tdo,
                                         const BwdArgs& a, int nbox, int q0, int c0, int h, int b,
                                         unsigned char* sm) {
  using G = WideGeo<Dc, NP, 2>;
  constexpr int kCS = G::kCStages, kTS = G::kTStages, kR = G::kR;
  uint64_t* c_full = reinterpret_cast<uint64_t*>(sm + G::kBar);
  uint64_t* c_empty = c_full + kCS;
  uint64_t* t_full = c_full + 2 * kCS;
  uint64_t* t_empty = t_full + kTS;

  const int hk = h / (a.H / a.Hk);
  const int last = q0 + kR - 1 + a.Sk - a.Sq;              // the block's last visible key
  const int nk_all = (a.Sk + kR - 1) / kR;
  // a row that sees no key has dQ = 0: a block of such rows loads no key
  const int nk = !a.causal ? nk_all : last < 0 ? 0 : min(nk_all, last / kR + 1);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kCS; ++i) {
      mbar_init(c_full + i, 1);
      mbar_init(c_empty + i, G::kConsumerWarps);
    }
    for (int i = 0; i < kTS; ++i) {
      mbar_init(t_full + i, 1);
      mbar_init(t_empty + i, G::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    if (threadIdx.x == 0) {
      const CUtensorMap* const maps[4] = {tq, tk, tdo, tv};
      const int heads[4] = {h, hk, h, hk};
      int n = 0;
      for (int it = 0; it < nk; ++it) {
        const int ts = it % kTS;
        mbar_wait(t_empty + ts, ((it / kTS) & 1) ^ 1);
        load_chunk<G, NP, Dc>(sm + G::kT + ts * G::kTBytes, tk, t_full + ts, c0, hk, it * kR, b,
                              a.B);
        const int rows[4] = {q0, it * kR, q0, it * kR};
        load_contraction<G, NP, 2>(sm, c_full, c_empty, n, nbox, maps, heads, rows, b, a.B);
      }
    }
  } else {
    const int t = threadIdx.x - kWG, t4 = t % 4;
    const int row = q0 + (t / 32) * 16 + (t % 32) / 4;   // and row + 8
    float lse2[2], dl[2];
    row_stats(lse2, dl, a, b, h, row);
    float dq[Dc / 2];
#pragma unroll
    for (int i = 0; i < Dc / 2; ++i) dq[i] = 0.f;
    int n = 0;
    for (int it = 0; it < nk; ++it) {
      float s[kR / 2], dp[kR / 2];
      contract<T, G, NP, 2>(s, dp, sm, c_full, c_empty, n, nbox);
      fence_regs(s);
      fence_regs(dp);
      probs<kR>(s, a, lse2, it * kR, q0, row, t4);
#pragma unroll
      for (int i = 0; i < kR / 2; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]) * a.scale;
      uint32_t da[NP][kR / 16][4];
      to_a<T, kR, NP>(da, dp);
      const int ts = it % kTS;
      mbar_wait(t_full + ts, (it / kTS) & 1);
      chunk_product<T, G, Dc, NP>(dq, da, smem_u32(sm + G::kT + ts * G::kTBytes));
      release(t_empty + ts);
    }
    const float one[2] = {1.f, 1.f};
    store_rows<TO, Dc, true>(static_cast<TO*>(a.dq) + b * a.sdq.b + h * a.sdq.h + c0, a.sdq.s,
                             row, a.Sq, a.D - c0, t4, dq, one);
  }
}

// the first column of chunk ci of a plan whose widest chunks are dc0
__device__ __forceinline__ int chunk_col(const WidePlan& w, int ci, int dc0) {
  return ci < w.n0 ? ci * dc0 : w.n0 * dc0 + (ci - w.n0) * (dc0 - kBox);
}

// a launch's shared memory: the larger of its chunk widths' layouts
template <int Dc0, int NP, int kPairs>
constexpr int wide_smem() {
  using G0 = WideGeo<Dc0, NP, kPairs>;
  using G1 = WideGeo<Dc0 - kBox, NP, kPairs>;
  return G0::kSmem > G1::kSmem ? G0::kSmem : G1::kSmem;
}

// the forward: a block per (query tile, chunk, head, batch), the heaviest
// causal tiles first, every chunk of a tile together
template <typename T, typename TO, int NP, int Dc0>
__global__ void __launch_bounds__(2 * kWG, 1)
    wide_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const FwdArgs a, const WidePlan w) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const int nc = w.n0 + w.n1, ci = (int)blockIdx.x % nc;
  const int q0 = ((a.Sq + 63) / 64 - 1 - (int)blockIdx.x / nc) * 64;
  const int c0 = chunk_col(w, ci, Dc0);
  if (ci < w.n0)
    fwd_block<T, TO, Dc0, NP>(&tq, &tk, &tv, a, w.nbox, q0, c0, blockIdx.y, blockIdx.z, sm);
  else
    fwd_block<T, TO, Dc0 - kBox, NP>(&tq, &tk, &tv, a, w.nbox, q0, c0, blockIdx.y, blockIdx.z,
                                     sm);
}

// the backward's three passes in one launch, a block per (tile, chunk,
// head, batch), heaviest first: the dK blocks, then the dV blocks (low key
// tiles see the most query tiles), then the dQ blocks (high query tiles see
// the most keys); chunks and heads innermost
template <typename T, typename TO, int NP, int Dc0>
__global__ void __launch_bounds__(2 * kWG, 1)
    wide_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const BwdArgs a, const WidePlan w) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  constexpr int Dc1 = Dc0 - kBox;
  const int nc = w.n0 + w.n1, b = blockIdx.z;
  const int kv = (a.Sk + 63) / 64 * nc * a.Hk;     // the blocks of the dK or the dV pass
  int i = blockIdx.x;
  if (i < 2 * kv) {
    const bool dv = i >= kv;
    i -= dv ? kv : 0;
    const int k0 = i / (nc * a.Hk) * 64, ci = i / a.Hk % nc, hk = i % a.Hk;
    const int c0 = chunk_col(w, ci, Dc0);
    if (dv && ci < w.n0)
      kv_block<T, TO, Dc0, NP, true>(&tq, &tk, &tv, &tdo, a, w.nbox, k0, c0, hk, b, sm);
    else if (dv)
      kv_block<T, TO, Dc1, NP, true>(&tq, &tk, &tv, &tdo, a, w.nbox, k0, c0, hk, b, sm);
    else if (ci < w.n0)
      kv_block<T, TO, Dc0, NP, false>(&tq, &tk, &tv, &tdo, a, w.nbox, k0, c0, hk, b, sm);
    else
      kv_block<T, TO, Dc1, NP, false>(&tq, &tk, &tv, &tdo, a, w.nbox, k0, c0, hk, b, sm);
  } else {
    i -= 2 * kv;
    const int q0 = ((a.Sq + 63) / 64 - 1 - i / (nc * a.H)) * 64, ci = i / a.H % nc, h = i % a.H;
    const int c0 = chunk_col(w, ci, Dc0);
    if (ci < w.n0)
      dq_block<T, TO, Dc0, NP>(&tq, &tk, &tv, &tdo, a, w.nbox, q0, c0, h, b, sm);
    else
      dq_block<T, TO, Dc1, NP>(&tq, &tk, &tv, &tdo, a, w.nbox, q0, c0, h, b, sm);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and launches
// ---------------------------------------------------------------------------


// A 4-D map over (D, heads, S, B) of a [B, S, heads, D] tensor with element
// strides st (unit along D), boxes of 64 columns by `rows` rows, 128-byte
// swizzle; reads past an edge (columns past D too) give zeros. A dimension
// of size 1 gets the packed stride, whatever torch reports for it.
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

// the maps read q, k, v (the inputs, or an f32 call's pieces: NP B batches)
// with the (batch, seq, head) element strides st of q, k, v
template <typename C>
int launch_fwd(const void* q, const void* k, const void* v, const long long* st, const FwdArgs& a,
               cudaStream_t stream) {
  using T = typename C::T;
  using G = FwdGeo<C::Dp, C::NP>;
  const int nb = C::NP * a.B;
  CUtensorMap mq, mk, mv;
  if (int e = tensor_map<T>(&mq, q, nb, a.Sq, a.H, a.D, strides_of(st, 0), G::kM)) return e;
  if (int e = tensor_map<T>(&mk, k, nb, a.Sk, a.Hk, a.D, strides_of(st, 1), G::kN)) return e;
  if (int e = tensor_map<T>(&mv, v, nb, a.Sk, a.Hk, a.D, strides_of(st, 2), G::kN)) return e;
  auto kernel = flash_fwd_kernel<T, typename C::TO, C::Dp, C::NP, C::kPad>;
  if (int e = prepare(kernel, G::kSmem)) return e;
  const dim3 grid((a.Sq + G::kM - 1) / G::kM, a.H, a.B);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

template <typename C>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const long long* st,
               const BwdArgs& a, cudaStream_t stream) {
  // dK/dV: Q and dO boxes of kM rows, K and V of kN; dQ the other way round
  using T = typename C::T;
  using TO = typename C::TO;
  using GK = KvGeo<C::Dp, C::NP>;
  using GQ = DqGeo<C::Dp, C::NP>;
  const int nb = C::NP * a.B;
  CUtensorMap mq, mk, mv, mdo;
  if (int e = tensor_map<T>(&mq, q, nb, a.Sq, a.H, a.D, strides_of(st, 0), GK::kM)) return e;
  if (int e = tensor_map<T>(&mk, k, nb, a.Sk, a.Hk, a.D, strides_of(st, 1), GK::kN)) return e;
  if (int e = tensor_map<T>(&mv, v, nb, a.Sk, a.Hk, a.D, strides_of(st, 2), GK::kN)) return e;
  if (int e = tensor_map<T>(&mdo, dout, nb, a.Sq, a.H, a.D, strides_of(st, 3), GK::kM)) return e;
  const dim3 grid_kv((a.Sk + GK::kN - 1) / GK::kN, a.Hk, a.B);
  auto kv_dv = flash_bwd_kv_kernel<T, TO, C::Dp, C::NP, C::kPad, true>;
  auto kv_dk = flash_bwd_kv_kernel<T, TO, C::Dp, C::NP, C::kPad, false>;
  if (int e = prepare(kv_dv, GK::kSmem)) return e;
  kv_dv<<<grid_kv, GK::kThreads, GK::kSmem, stream>>>(mq, mk, mv, mdo, a);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (int e = prepare(kv_dk, GK::kSmem)) return e;
  kv_dk<<<grid_kv, GK::kThreads, GK::kSmem, stream>>>(mq, mk, mv, mdo, a);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (int e = tensor_map<T>(&mq, q, nb, a.Sq, a.H, a.D, strides_of(st, 0), GQ::kM)) return e;
  if (int e = tensor_map<T>(&mk, k, nb, a.Sk, a.Hk, a.D, strides_of(st, 1), GQ::kN)) return e;
  if (int e = tensor_map<T>(&mv, v, nb, a.Sk, a.Hk, a.D, strides_of(st, 2), GQ::kN)) return e;
  if (int e = tensor_map<T>(&mdo, dout, nb, a.Sq, a.H, a.D, strides_of(st, 3), GQ::kM)) return e;
  auto dq = flash_bwd_dq_kernel<T, TO, C::Dp, C::NP, C::kPad>;
  if (int e = prepare(dq, GQ::kSmem)) return e;
  dq<<<dim3((a.Sq + GQ::kM - 1) / GQ::kM, a.H, a.B), GQ::kThreads, GQ::kSmem, stream>>>(
      mq, mk, mv, mdo, a);
  return (int)cudaGetLastError();
}

// past 256 columns: one launch each way, every map with boxes of 64 rows
template <typename C, int Dc0>
int launch_wide_fwd(const void* q, const void* k, const void* v, const long long* st,
                    const FwdArgs& a, WidePlan w, cudaStream_t stream) {
  using T = typename C::T;
  const int nb = C::NP * a.B;
  CUtensorMap mq, mk, mv;
  if (int e = tensor_map<T>(&mq, q, nb, a.Sq, a.H, a.D, strides_of(st, 0), 64)) return e;
  if (int e = tensor_map<T>(&mk, k, nb, a.Sk, a.Hk, a.D, strides_of(st, 1), 64)) return e;
  if (int e = tensor_map<T>(&mv, v, nb, a.Sk, a.Hk, a.D, strides_of(st, 2), 64)) return e;
  auto kernel = wide_fwd_kernel<T, typename C::TO, C::NP, Dc0>;
  constexpr int smem = wide_smem<Dc0, C::NP, 1>();
  if (int e = prepare(kernel, smem)) return e;
  const dim3 grid((a.Sq + 63) / 64 * (w.n0 + w.n1), a.H, a.B);
  kernel<<<grid, 2 * kWG, smem, stream>>>(mq, mk, mv, a, w);
  return (int)cudaGetLastError();
}

template <typename C, int Dc0>
int launch_wide_bwd(const void* q, const void* k, const void* v, const void* dout,
                    const long long* st, const BwdArgs& a, WidePlan w, cudaStream_t stream) {
  using T = typename C::T;
  const int nb = C::NP * a.B;
  CUtensorMap mq, mk, mv, mdo;
  if (int e = tensor_map<T>(&mq, q, nb, a.Sq, a.H, a.D, strides_of(st, 0), 64)) return e;
  if (int e = tensor_map<T>(&mk, k, nb, a.Sk, a.Hk, a.D, strides_of(st, 1), 64)) return e;
  if (int e = tensor_map<T>(&mv, v, nb, a.Sk, a.Hk, a.D, strides_of(st, 2), 64)) return e;
  if (int e = tensor_map<T>(&mdo, dout, nb, a.Sq, a.H, a.D, strides_of(st, 3), 64)) return e;
  auto kernel = wide_bwd_kernel<T, typename C::TO, C::NP, Dc0>;
  constexpr int smem = wide_smem<Dc0, C::NP, 1>() > wide_smem<Dc0, C::NP, 2>()
                           ? wide_smem<Dc0, C::NP, 1>() : wide_smem<Dc0, C::NP, 2>();
  if (int e = prepare(kernel, smem)) return e;
  const int nc = w.n0 + w.n1;
  const dim3 grid(2 * ((a.Sk + 63) / 64) * nc * a.Hk + (a.Sq + 63) / 64 * nc * a.H, 1, a.B);
  kernel<<<grid, 2 * kWG, smem, stream>>>(mq, mk, mv, mdo, a, w);
  return (int)cudaGetLastError();
}

#ifdef KERNEL_PART
// the configurations of each part (dispatch, below, takes every one): the
// main path's, bf16 padded, fp16 padded, f32 up to 128 columns, f32 past
#define FLASH_INSTANTIATE(T, TO, Dp, NP, kPad)                                             \
  template int launch_fwd<Cfg<T, TO, Dp, NP, kPad>>(const void*, const void*, const void*,  \
                                                    const long long*, const FwdArgs&,       \
                                                    cudaStream_t);                          \
  template int launch_bwd<Cfg<T, TO, Dp, NP, kPad>>(const void*, const void*, const void*,  \
                                                    const void*, const long long*,          \
                                                    const BwdArgs&, cudaStream_t);
#if KERNEL_PART == 1
FLASH_INSTANTIATE(bf, bf, 128, 1, false)
FLASH_INSTANTIATE(bf, bf, 64, 1, false)
FLASH_INSTANTIATE(__half, __half, 128, 1, false)
FLASH_INSTANTIATE(__half, __half, 64, 1, false)
#elif KERNEL_PART == 2
FLASH_INSTANTIATE(bf, bf, 64, 1, true)
FLASH_INSTANTIATE(bf, bf, 128, 1, true)
FLASH_INSTANTIATE(bf, bf, 192, 1, true)
FLASH_INSTANTIATE(bf, bf, 256, 1, true)
#elif KERNEL_PART == 3
FLASH_INSTANTIATE(__half, __half, 64, 1, true)
FLASH_INSTANTIATE(__half, __half, 128, 1, true)
FLASH_INSTANTIATE(__half, __half, 192, 1, true)
FLASH_INSTANTIATE(__half, __half, 256, 1, true)
#elif KERNEL_PART == 4
FLASH_INSTANTIATE(bf, float, 64, 2, true)
FLASH_INSTANTIATE(bf, float, 128, 2, true)
#elif KERNEL_PART == 5
FLASH_INSTANTIATE(bf, float, 192, 2, true)
FLASH_INSTANTIATE(bf, float, 256, 2, true)
#endif
#undef FLASH_INSTANTIATE
// parts 6 to 8: past 256 columns, bf16, fp16 and f32, for the widest
// chunk of 192 and of 256 columns
#define WIDE_INSTANTIATE(T, TO, NP, Dc0)                                                 \
  template int launch_wide_fwd<WideCfg<T, TO, NP>, Dc0>(                                 \
      const void*, const void*, const void*, const long long*, const FwdArgs&, WidePlan, \
      cudaStream_t);                                                                     \
  template int launch_wide_bwd<WideCfg<T, TO, NP>, Dc0>(                                 \
      const void*, const void*, const void*, const void*, const long long*,              \
      const BwdArgs&, WidePlan, cudaStream_t);
#define WIDE_WIDTHS(T, TO, NP) WIDE_INSTANTIATE(T, TO, NP, 192) WIDE_INSTANTIATE(T, TO, NP, 256)
#if KERNEL_PART == 6
WIDE_WIDTHS(bf, bf, 1)
#elif KERNEL_PART == 7
WIDE_WIDTHS(__half, __half, 1)
#elif KERNEL_PART == 8
WIDE_WIDTHS(bf, float, 2)
#endif
#undef WIDE_WIDTHS
#undef WIDE_INSTANTIATE
#endif  // KERNEL_PART
#endif  // FLASH_KERNELS

#if FLASH_HOST

// ---------------------------------------------------------------------------
// f32: the split pre-pass
// ---------------------------------------------------------------------------

// up to four f32 [B, S, heads, D] tensors (strided, unit along D) to their
// two bf16 pieces, packed as [2, B, S, heads, D]: h = bf16(x), l = bf16(x - h)
struct SplitArgs {
  const float* x[4];
  __nv_bfloat16* out[4];
  Strides st[4];
  int S[4], heads[4];
  int B, D;
};

__global__ void __launch_bounds__(256) split_kernel(const SplitArgs a) {
  const int j = blockIdx.y;
  const float* x = a.x[j];
  const Strides st = a.st[j];
  const int S = a.S[j], heads = a.heads[j], d4 = a.D / 4;
  const long long n = (long long)a.B * S * heads * d4;   // groups of 4 columns
  __nv_bfloat16* hi = a.out[j];
  __nv_bfloat16* lo = hi + 4 * n;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long r = i / d4;
    const int d = 4 * (int)(i - r * d4);
    const int h = (int)(r % heads);
    r /= heads;
    const int s = (int)(r % S);
    const long long b = r / S;
    const float4 v = *reinterpret_cast<const float4*>(x + b * st.b + s * st.s + h * st.h + d);
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
    const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(v.x - f01.x, v.y - f01.y);
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(v.z - f23.x, v.w - f23.y);
    __nv_bfloat162* ph = reinterpret_cast<__nv_bfloat162*>(hi + 4 * i);
    __nv_bfloat162* pl = reinterpret_cast<__nv_bfloat162*>(lo + 4 * i);
    ph[0] = h01;
    ph[1] = h23;
    pl[0] = l01;
    pl[1] = l23;
  }
}

// the configuration of (dtype, D): bf16 or fp16 at D 64 or 128 as they are,
// other D padded; f32 (dtype 3) as two bf16 pieces
template <typename F>
int dispatch(int dtype, int D, F&& f) {
  const int Dp = (D + kBox - 1) / kBox * kBox;
  if (dtype == 1) {
    if (D == 128) return f(Cfg<bf, bf, 128, 1, false>{});
    if (D == 64) return f(Cfg<bf, bf, 64, 1, false>{});
    if (Dp == 64) return f(Cfg<bf, bf, 64, 1, true>{});
    if (Dp == 128) return f(Cfg<bf, bf, 128, 1, true>{});
    if (Dp == 192) return f(Cfg<bf, bf, 192, 1, true>{});
    if (Dp == 256) return f(Cfg<bf, bf, 256, 1, true>{});
  }
  if (dtype == 2) {
    if (D == 128) return f(Cfg<__half, __half, 128, 1, false>{});
    if (D == 64) return f(Cfg<__half, __half, 64, 1, false>{});
    if (Dp == 64) return f(Cfg<__half, __half, 64, 1, true>{});
    if (Dp == 128) return f(Cfg<__half, __half, 128, 1, true>{});
    if (Dp == 192) return f(Cfg<__half, __half, 192, 1, true>{});
    if (Dp == 256) return f(Cfg<__half, __half, 256, 1, true>{});
  }
  if (dtype == 3) {
    if (Dp == 64) return f(Cfg<bf, float, 64, 2, true>{});
    if (Dp == 128) return f(Cfg<bf, float, 128, 2, true>{});
    if (Dp == 192) return f(Cfg<bf, float, 192, 2, true>{});
    if (Dp == 256) return f(Cfg<bf, float, 256, 2, true>{});
  }
  return (int)cudaErrorInvalidValue;
}

// past 256 columns (D up to 1024): the configuration of the dtype
template <typename F>
int wide_dispatch(int dtype, F&& f) {
  if (dtype == 1) return f(WideCfg<bf, bf, 1>{});
  if (dtype == 2) return f(WideCfg<__half, __half, 1>{});
  if (dtype == 3) return f(WideCfg<bf, float, 2>{});
  return (int)cudaErrorInvalidValue;
}

// The chunk plan (ops/flash_attention.py chunk_plan): the Dp / 64 boxes of
// the output go into c = ceil(Dp / 256) chunks, the first (Dp / 64) mod c
// of them one box wider than the rest, so the chunks cover Dp exactly; the
// widest chunk has 3 or 4 boxes for every D in (256, 1024]. f(widest
// chunk's columns, plan).
template <typename F>
int wide_plan(int D, F&& f) {
  if (D <= 4 * kBox || D > 16 * kBox) return (int)cudaErrorInvalidValue;
  const int boxes = (D + kBox - 1) / kBox, c = (boxes + 3) / 4;
  const int base = boxes / c, extra = boxes % c;
  const WidePlan w = extra ? WidePlan{boxes, extra, c - extra} : WidePlan{boxes, c, 0};
  if ((extra ? base + 1 : base) == 3) return f(std::integral_constant<int, 3 * kBox>{}, w);
  return f(std::integral_constant<int, 4 * kBox>{}, w);
}

// the split of n f32 tensors (q, k, v[, dout]) into `work`, tensor j taking
// 2 B S_j heads_j D elements after the ones before it; fills `packed` with
// the pieces' (batch, seq, head) strides
int split(int n, const void* const* xs, const long long* strides, const int* S,
          const int* heads, int B, int D, void* work, long long* packed, cudaStream_t stream) {
  if (work == nullptr || D % 8) return (int)cudaErrorInvalidValue;
  SplitArgs sa{};
  sa.B = B;
  sa.D = D;
  __nv_bfloat16* w = static_cast<__nv_bfloat16*>(work);
  long long most = 0;
  for (int j = 0; j < n; ++j) {
    const long long numel = (long long)B * S[j] * heads[j] * D;
    sa.x[j] = static_cast<const float*>(xs[j]);
    sa.out[j] = w;
    sa.st[j] = strides_of(strides, j);
    sa.S[j] = S[j];
    sa.heads[j] = heads[j];
    packed[3 * j] = (long long)S[j] * heads[j] * D;
    packed[3 * j + 1] = (long long)heads[j] * D;
    packed[3 * j + 2] = D;
    w += 2 * numel;
    most = numel > most ? numel : most;
  }
  const long long blocks = (most / 4 + 255) / 256;
  const dim3 grid((unsigned)(blocks < 1056 ? (blocks > 0 ? blocks : 1) : 1056), n);
  split_kernel<<<grid, 256, 0, stream>>>(sa);
  return (int)cudaGetLastError();
}

#endif  // FLASH_HOST

}  // namespace flash

#if FLASH_HOST
using namespace flash;

// q/o [B, Sq, H, D], k/v [B, Sk, Hk, D] with unit stride along D; strides
// holds the (batch, seq, head) element strides of q, k, v, o in that order.
// lse is f32 [B, H, Sq], contiguous. dtype 1 is bf16, 2 is fp16, 3 is f32;
// D is a multiple of 8 up to 1024 (past 256 the wide kernels). f32 needs `work`: bf16 scratch of 2 (B Sq
// H + 2 B Sk Hk) D elements for the pieces, 16-byte aligned. Causal rows
// align bottom-right (row i sees keys j <= i + Sk - Sq). The caller has
// checked H % Hk == 0, shapes, 16-byte alignment of the data and strides
// that are positive multiples of 8 (16 bytes, as TMA needs). Returns the
// cudaError_t of the launch (0 on success), or 10000 + the CUresult of a
// tensor map the driver refused.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, const long long* strides, int B, int H, int Hk,
                                   int Sq, int Sk, int D, float scale, int causal, int dtype,
                                   void* stream, void* work) {
  const FwdArgs a{o, static_cast<float*>(lse), strides_of(strides, 3), B, H, Hk, Sq, Sk, D,
                  scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[3] = {q, k, v};
  long long packed[9];
  if (dtype == 3) {
    const int S[3] = {Sq, Sk, Sk}, heads[3] = {H, Hk, Hk};
    if (int e = split(3, in, strides, S, heads, B, D, work, packed, s)) return e;
    const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(work);
    in[0] = w;
    in[1] = w + 2LL * B * Sq * H * D;
    in[2] = w + 2LL * B * (Sq * H + Sk * Hk) * D;
  }
  const long long* st = dtype == 3 ? packed : strides;
  if (D > 4 * kBox)
    return wide_dispatch(dtype, [&](auto c) {
      return wide_plan(D, [&](auto dc, WidePlan w) {
        return launch_wide_fwd<decltype(c), decltype(dc)::value>(in[0], in[1], in[2], st, a, w,
                                                                  s);
      });
    });
  return dispatch(dtype, D, [&](auto c) {
    return launch_fwd<decltype(c)>(in[0], in[1], in[2], st, a, s);
  });
}

// The backward's three passes. dout/dq like q, dk/dv like k; lse and delta
// f32 [B, H, Sq]; strides holds (batch, seq, head) of q, k, v, dout, dq, dk,
// dv. f32 needs `work` of 4 (B Sq H + B Sk Hk) D bf16 elements.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, const long long* strides,
                                   int B, int H, int Hk, int Sq, int Sk, int D, float scale,
                                   int causal, int dtype, void* stream, void* work) {
  const BwdArgs a{static_cast<const float*>(lse), static_cast<const float*>(delta), dq, dk, dv,
                  strides_of(strides, 4), strides_of(strides, 5), strides_of(strides, 6),
                  B, H, Hk, Sq, Sk, D, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[4] = {q, k, v, dout};
  long long packed[12];
  if (dtype == 3) {
    const int S[4] = {Sq, Sk, Sk, Sq}, heads[4] = {H, Hk, Hk, H};
    if (int e = split(4, in, strides, S, heads, B, D, work, packed, s)) return e;
    const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(work);
    const long long nq = 2LL * B * Sq * H * D, nk = 2LL * B * Sk * Hk * D;
    in[0] = w;
    in[1] = w + nq;
    in[2] = w + nq + nk;
    in[3] = w + nq + 2 * nk;
  }
  const long long* st = dtype == 3 ? packed : strides;
  if (D > 4 * kBox)
    return wide_dispatch(dtype, [&](auto c) {
      return wide_plan(D, [&](auto dc, WidePlan w) {
        return launch_wide_bwd<decltype(c), decltype(dc)::value>(in[0], in[1], in[2], in[3], st,
                                                                  a, w, s);
      });
    });
  return dispatch(dtype, D, [&](auto c) {
    return launch_bwd<decltype(c)>(in[0], in[1], in[2], in[3], st, a, s);
  });
}
#endif  // FLASH_HOST
