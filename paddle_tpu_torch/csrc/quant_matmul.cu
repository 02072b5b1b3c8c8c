// Int8 weight-only GEMM for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes by paddle_tpu_torch/ops/quant_matmul.py.
//
// Replaces: paddle_tpu/ops/pallas/quant_matmul.py:116 `int8_matmul` (its
// forward body `_fwd_kernel`, :56-70), which the serving engine reaches
// through `matmul_gate` and `decode_matmul` for every projection of an
// int8 engine, and which `nn.quant` fine-tuning reaches for every frozen
// projection, and `_dx_pallas` (:143-162, body `_bwd_dx_kernel` :73-87),
// its backward dX. Computes out[M, N] = T((x[M, K] @ W[K, N]) * scales[N])
// for x of type T (bf16, fp16 or f32; the reference's `matmul_gate` sends
// an fp16 serving engine's projections here too): each product is exact in
// f32, products are summed in f32 over K, the sum is multiplied by the
// per-output-channel scale in f32 and cast to T once. dX takes bf16 or f32.
//
// Two designs, switched by M as the reference's `_fwd_blocks` (:98-113)
// switches to compute-shaped blocks past M = 64:
// - M <= 64, the weight stream (bound by the weight bytes);
// - M > 64 and dX, the tensor-core kernel (bound by operations), below.

#include "hopper.cuh"

namespace {

// int8 byte i of v -> exact float, via 0x4B0000xx = 2^23 + xx with the
// byte biased to unsigned (x ^ 0x80 == x + 128).
__device__ __forceinline__ void widen4(uint32_t v, float* f) {
  const uint32_t u = v ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// ---------------------------------------------------------------------------
// the weight stream, M <= 64
// ---------------------------------------------------------------------------
//
// Replaces `_fwd_kernel` (:56-70) at M <= 64, the `m <= 64` branch of
// `_fwd_blocks` (:98-113), which widens each W block to x's dtype and runs one
// `_dot` on the matrix unit with f32 accumulation. Here too the products run
// on the tensor cores: outT[N, M] = WT[N, K] . xT[K, M], the weight as the
// 16-row side of `mma.sync m16n8k16` and the lanes, padded to a multiple of
// 8 (up to 64), as its n side.
//
// Bound on the H100: bytes. The int8 weight is the traffic, one byte an
// element against 3.35 TB/s; 2 M FLOPs a weight byte stays far under the
// ridge point even at M = 64. What bounds this kernel at the decode shapes
// is what a call costs besides its stream: between its first and last stage
// the stream runs at 3.0-3.3 TB/s (tools/stream_trace.py), but each call
// also pays its launch (~1.2 us in a CUDA graph), one DRAM round trip before
// the first stage lands (~1.3 us) and the clusters' reduction (~1.5 us), and
// the SMs do not get equal shares of the bandwidth, so the last blocks of a
// large call trail the median by several us (PERF.md, PR 10).
//
// Design:
// - A block owns 128 output columns and one K slice. One producer thread
//   keeps a ring of stages in flight by TMA: the W box [BK k][128 n] int8
//   and the x box [MP lanes][BK k] (bf16, or f32 in boxes of 32 k), both
//   with the 128-byte swizzle, on one full barrier. No register holds a load.
// - Consumer warps take one 16-deep step each of a stage: eight warps and
//   128-row stages up to 8 lanes (16 of bf16 x), else four warps and 64-row
//   stages (past 32 lanes two warps share a step, each for half the lanes).
//   A thread reads its four W rows (2t, 2t + 1, 2t + 8, 2t + 9 of the step)
//   as 16-byte loads of columns 16 g .. 16 g + 15 (conflict-free under the
//   swizzle) and widens them straight into A fragments, exactly, two weights
//   an instruction group: a byte permute puts the bytes of two rows into the
//   low bytes of a bf16 pair, one LOP3 makes 128 + (b & 127) (0x43 in the
//   high byte), one makes -(128 + (b & 128)), and one bf16x2 add gives
//   b - 256 (b >> 7), the int8 value. For fp16 x the weights widen to fp16
//   pairs, as exactly: one LOP3 puts the byte, biased to unsigned, into
//   the mantissa of 1024 (0x6400: 1024 + (b + 128)), and one f16x2 add of
//   -1152 gives b; the products then run as `mma.sync` f16 with f32 sums. Output column order within a tile is
//   free: the m16 tile j of a warp holds columns 16 g + 2 j (rows g) and
//   16 g + 2 j + 1 (rows g + 8), so each 16-byte load feeds eight tiles and
//   no widened copy of W is written to shared memory. x's B fragments come
//   by ldmatrix (bf16); f32 x is split in registers into its three exact
//   bf16 pieces h, m, l (as `split3`), three products a fragment.
// - Sums: bf16 x accumulates in the tensor cores' f32 sum. f32 x adds each
//   16-deep step's three piece products into f32 registers, since the
//   tensor cores truncate their running sum (about an ulp a step, PERF.md).
// - One launch, no scratch: where the column tiles leave more than a quarter
//   of the SMs idle, K is cut into ksplit <= 8 slices (at most 1.75 blocks
//   an SM: clusters of eight then fit one wave), one thread-block cluster of
//   ksplit blocks a column tile. Each block adds its warps in a fixed order
//   and sends each four outputs to the rank that owns them (distributed
//   shared memory); after one cluster barrier each rank adds its outputs
//   over the slices in slice order, applies the scale and casts once.
//   Deterministic, no finalize kernel, no memset, nothing allocated: one
//   CUDA graph holds the call.
// - Programmatic dependent launch: the producer issues the first two W
//   stages, which no kernel writes, before `griddepcontrol.wait`, then x;
//   once it has issued its last stage it lets the next kernel on the stream
//   start its blocks, which do the same during this call's tail.
// - Rows past M and past K are zero-filled by TMA and never stored.
// Tried on the H100 (80GB HBM3, 700 W), a Llama-3-8B decode step at M = 8
// (225 calls, kernel_ab --stream; PR 9's SIMT stream 6.88 ms in the same
// calls, its byte bound 2.26 ms):
// - four warps, 64-row stages, the slices' partials pulled by each rank over
//   distributed shared memory one load after another, two cluster barriers:
//   4.45 ms; copies without the products 3.83, without the loads 3.86,
//   without the cluster reduction 3.94, without all three 1.55, a kernel
//   that returns at once 0.29;
// - the tiles' stages shared evenly by two blocks an SM (stream-K) with a
//   ticketed reduction: the SMs streamed equal shares at unequal rates (the
//   median block of `gate` 21.5 us, the slowest 35), slower than above;
// - test_wait spinning instead of try_wait: no change; 128-row stages with
//   four warps: 4.73;
// - sums pushed to their rank, one cluster barrier, no dependent launch:
//   4.53; with it, the next kernel started at once: 4.35, after the last
//   stage is issued: 4.10 (2 W stages ahead; 4: 4.05, the ring: 4.13), once
//   the stages are consumed: 4.31; pulled in one batch instead: 4.20;
// - a 72 KB ring (two blocks an SM at most): 4.29; 144 KB, one block an SM:
//   5.50;
// - eight warps and 128-row stages: 4.02; with the grid at 1.75 blocks an
//   SM: 3.65; with gate and up unsplit: 3.51 (kept); 16-block clusters for
//   k and v: 3.58; three blocks an SM: 3.83;
// - eight warps at 16 lanes: M = 16 4.45 ms against 4.68; for f32 at 8
//   lanes: 4.20 ms against 4.89.

namespace ws {

constexpr int kCols = 128;                    // output columns of a block
constexpr int kSliceRows = 128;               // a K slice holds a multiple of this
constexpr int kMaxStages = 8;
constexpr int kMaxSplit = 8;                  // a portable cluster
constexpr int kTmaError = 10000;              // + CUresult of a refused tensor map

struct Args {
  const float* scales;
  void* out;
  int M, K, N;
  int kc;       // K rows of a slice, a multiple of kSliceRows
  int ksplit;   // slices of K: the blocks of a cluster
  int stages;
};

// shared memory from a 1024-byte aligned base: the ring (reused for the
// warps' sums), the receive buffer of the slices' sums, the barriers
template <typename T, int NTW, int LG>
struct Geometry {
  // up to 8 lanes, or 16 of bf16 x: eight consumer warps, each one
  // 16-deep step of a 128-row stage; more lanes: four (their accumulators
  // take the registers)
  static constexpr int kWarps = LG == 1 && (NTW == 1 || (NTW == 2 && sizeof(T) == 2)) ? 8 : 4;
  static constexpr int kThreads = 32 * (kWarps + 1);  // + the producer warp
  static constexpr int kBK = 16 * kWarps;             // K rows of a stage
  static constexpr int kWBytes = kBK * kCols;         // the W box, int8, swizzled
  static constexpr int kRingBytes = (kWarps == 8 ? 80 : 64) * 1024;
  static constexpr int MP = 8 * NTW * LG;
  static constexpr int kXBoxes = kBK * (int)sizeof(T) / 128;   // x boxes of 128-byte rows
  static constexpr int kXBytes = kXBoxes * MP * 128;
  static constexpr int kStage = kWBytes + kXBytes;
  static constexpr int kRed = kWarps * NTW * 8 * kCols * 4;  // each warp's lanes
  __host__ __device__ static int stages() {
    const int s = (kRingBytes > kRed ? kRingBytes : kRed) / kStage;
    return s < 2 ? 2 : s > kMaxStages ? kMaxStages : s;
  }
  __host__ __device__ static int ring(int stages) {
    const int r = stages * kStage;
    return r > kRed ? r : kRed;
  }
  __host__ __device__ static int smem(int stages) {
    return ring(stages) + (MP * kCols + 4 * kMaxSplit) * 4 + 2 * stages * 8 + 1024;
  }
};

// two weights of rows u and v (byte b of each) -> a pair of x's 16-bit
// type (bf16 for bf16 and f32 x, fp16 for fp16 x), exactly. bf16:
// (128 + (b & 127)) - (128 + (b & 128)) == b as an int8; fp16: (1024 +
// (b ^ 0x80)) - 1152 == b.
template <typename T, int B>
__device__ __forceinline__ uint32_t widen2(uint32_t u, uint32_t v) {
  const uint32_t p = __byte_perm(u, v, B | B << 4 | (4 + B) << 8 | (4 + B) << 12);
  uint32_t r;
  if constexpr (std::is_same<T, __half>::value) {
    const uint32_t x = (p & 0x00FF00FFu) ^ 0x64806480u;
    asm("add.rn.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(x), "r"(0xE480E480u));
  } else {
    const uint32_t x = (p & 0x007F007Fu) | 0x43004300u;
    const uint32_t c = (p & 0x00800080u) | 0xC300C300u;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(x), "r"(0x3F803F80u), "r"(c));
  }
  return r;
}

// D[16 x 8] (+)= A[16 x 16] B[16 x 8], bf16 (or, for fp16 x, f16) inputs,
// f32 sums. A: a0 (row g, k 2t..2t+1), a1 (row g + 8), a2 (row g, k
// 2t+8..2t+9), a3 (row g + 8). B: b0 (k 2t..2t+1 of column g), b1 (k
// 2t+8..2t+9). D: d0, d1 row g columns 2t, 2t + 1; d2, d3 row g + 8.
template <typename T>
__device__ __forceinline__ void mma_acc(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// f32 pair -> its three exact bf16 pieces, each a packed pair (low = first)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t* piece) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    uint32_t h;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(h) : "f"(x1), "f"(x0));
    piece[p] = h;
    x0 = __fsub_rn(x0, __uint_as_float(h << 16));
    x1 = __fsub_rn(x1, __uint_as_float(h & 0xFFFF0000u));
  }
}

template <int kWarps>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kWarps) : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// 16 bytes to the same offset of the shared memory of block `rank` of the
// cluster (visible there after the next cluster barrier)
__device__ __forceinline__ void st_cluster(float* p, int rank, float4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)),
               "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void add4(float4& v, const float4& x) {
  v.x += x.x;
  v.y += x.y;
  v.z += x.z;
  v.w += x.w;
}

// NTW: n tiles of 8 lanes a warp; LG: lane groups (warps that share a step)
template <typename T, int NTW, int LG>
__global__ void __launch_bounds__(Geometry<T, NTW, LG>::kThreads, 2)
    int8_stream_kernel(const __grid_constant__ CUtensorMap tw,
                       const __grid_constant__ CUtensorMap tx, const Args a) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  using W = typename std::conditional<std::is_same<T, __half>::value, __half,
                                      __nv_bfloat16>::type;   // the widened weights' type
  using G = Geometry<T, NTW, LG>;
  constexpr int MP = G::MP;                       // lanes of the x box
  constexpr int kWarps = G::kWarps, kBK = G::kBK, kWBytes = G::kWBytes;
  constexpr int kClass = kWarps / LG;             // warps of one lane group
  constexpr int kSteps = kBK / 16 / kClass;       // steps a warp takes a stage
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const int S = a.stages;
  // the slices' sums of this block's share of the tile: [ks][share] float4
  float* recv = reinterpret_cast<float*>(sm + G::ring(S));
  uint64_t* full = reinterpret_cast<uint64_t*>(recv + MP * kCols + 4 * kMaxSplit);
  uint64_t* empty = full + S;

  const int ks = a.ksplit;
  const int slice = blockIdx.x % ks;              // the block's rank in its cluster
  const int c0 = blockIdx.x / ks * kCols;
  const int k0 = slice * a.kc;
  const int nst = (min(a.kc, a.K - k0) + kBK - 1) / kBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int units = a.M * (kCols / 4), share = (units + ks - 1) / ks;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kWarps) {
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tw)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
      // the weights do not depend on the kernel before: the first stages'
      // W boxes go out before waiting for it, their x boxes after
      const int pre = nst < 2 ? nst : 2;
      for (int it = 0; it < pre; ++it) {
        mbar_expect_tx(full + it, G::kStage);
        tma_load_2d(sm + it * G::kStage, &tw, full + it, c0, k0 + it * kBK);
      }
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int it = 0; it < nst; ++it) {
        const int st = it % S;
        const uint32_t ph = (it / S) & 1;
        unsigned char* base = sm + st * G::kStage;
        const int k = k0 + it * kBK;
        if (it >= pre) {
          mbar_wait(empty + st, ph ^ 1);
          mbar_expect_tx(full + st, G::kStage);
          tma_load_2d(base, &tw, full + st, c0, k);
        }
#pragma unroll
        for (int b = 0; b < G::kXBoxes; ++b)
          tma_load_2d(base + kWBytes + b * MP * 128, &tx, full + st, k + b * 128 / (int)sizeof(T),
                      0);
      }
      asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    }
    __syncwarp();
  } else {
    // x and the output only once the kernel before has finished
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const int lg = warp / kClass, sc = warp % kClass;
    const int g = lane >> 2, t = lane & 3;
    float acc[8][NTW][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][n][i] = 0.f;

    for (int it = 0; it < nst; ++it) {
      const int st = it % S;
      const uint32_t ph = (it / S) & 1;
      const unsigned char* base = sm + st * G::kStage;
      mbar_wait(full + st, ph);
#pragma unroll
      for (int p = 0; p < kSteps; ++p) {
        const int s = sc + p * kClass;            // the 16-deep step of the stage
        // W rows 16 s + {2t, 2t + 1, 2t + 8, 2t + 9}, columns 16 g .. 16 g + 15
        uint4 w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 16 * s + 2 * t + (r & 1) + 8 * (r >> 1);
          w[r] = *reinterpret_cast<const uint4*>(base + row * 128 + ((g ^ (row & 7)) << 4));
        }
        // x's B fragments of each n tile: lanes 8 nt + g, k 16 s + 2t.. (+8)
        uint32_t b[NTW][kF32 ? 3 : 1][2];
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          const int nt = lg * NTW + n;
          if constexpr (kF32) {
            const int r = 8 * nt + g;
            const unsigned char* xb = base + kWBytes + (s >> 1) * MP * 128 + r * 128;  // 32 k a box
            const int ch = 4 * (s & 1) + (t >> 1);
            const float2 lo = *reinterpret_cast<const float2*>(
                xb + ((ch ^ (r & 7)) << 4) + (t & 1) * 8);
            const float2 hi = *reinterpret_cast<const float2*>(
                xb + (((ch + 2) ^ (r & 7)) << 4) + (t & 1) * 8);
            uint32_t pl[3], ph3[3];
            split_pair(lo.x, lo.y, pl);
            split_pair(hi.x, hi.y, ph3);
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              b[n][q][0] = pl[q];
              b[n][q][1] = ph3[q];
            }
          } else {
            const int r = 8 * nt + (lane & 7);                  // 64 k a box
            const int ch = 2 * (s & 3) + ((lane >> 3) & 1);
            ldsm_x2(smem_u32(base + kWBytes + (s >> 2) * MP * 128 + r * 128 +
                             ((ch ^ (r & 7)) << 4)),
                    b[n][0][0], b[n][0][1]);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&w[0]) + (j >> 1);
          const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&w[1]) + (j >> 1);
          const uint32_t* w2 = reinterpret_cast<const uint32_t*>(&w[2]) + (j >> 1);
          const uint32_t* w3 = reinterpret_cast<const uint32_t*>(&w[3]) + (j >> 1);
          uint32_t af[4];
          if (j & 1) {
            af[0] = widen2<W, 2>(*w0, *w1);
            af[1] = widen2<W, 3>(*w0, *w1);
            af[2] = widen2<W, 2>(*w2, *w3);
            af[3] = widen2<W, 3>(*w2, *w3);
          } else {
            af[0] = widen2<W, 0>(*w0, *w1);
            af[1] = widen2<W, 1>(*w0, *w1);
            af[2] = widen2<W, 0>(*w2, *w3);
            af[3] = widen2<W, 1>(*w2, *w3);
          }
#pragma unroll
          for (int n = 0; n < NTW; ++n) {
            if constexpr (kF32) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int q = 0; q < 3; ++q) mma_acc<W>(d, af, b[n][q][0], b[n][q][1]);
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[j][n][i] += d[i];
            } else {
              mma_acc<W>(acc[j][n], af, b[n][0][0], b[n][0][1]);
            }
          }
        }
      }
      release(empty + st);
    }

    // the warps' sums, in a fixed order: each warp's tile into the dead ring,
    // then lane group by lane group, class 0 .. kClass - 1, summed per unit
    consumers_sync<kWarps>();
    float* red = reinterpret_cast<float*>(sm) + warp * (NTW * 8) * kCols;  // [NTW * 8][kCols]
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        float* row = red + (n * 8 + 2 * t) * kCols + 16 * g + 2 * j;
        *reinterpret_cast<float2*>(row) = make_float2(acc[j][n][0], acc[j][n][2]);
        *reinterpret_cast<float2*>(row + kCols) = make_float2(acc[j][n][1], acc[j][n][3]);
      }
    consumers_sync<kWarps>();
    // the block's sums, four outputs a unit, each sent to the rank that adds
    // them: units [q share, (q + 1) share) of the tile's M x kCols outputs to
    // rank q, into slot `slice` of its receive buffer
    for (int u = tid; u < units; u += 32 * kWarps) {
      const int m = u / (kCols / 4), c = (u % (kCols / 4)) * 4;
      const int grp = m / (NTW * 8), lm = m % (NTW * 8);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kClass; ++w)
        add4(v, *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(sm) +
                                                 ((grp * kClass + w) * NTW * 8 + lm) * kCols + c));
      const int q = u / share;
      float* dst = recv + ((size_t)slice * share + (u - q * share)) * 4;
      if (ks > 1)
        st_cluster(dst, q, v);
      else
        *reinterpret_cast<float4*>(dst) = v;
    }
  }

  // rank `slice` adds its units over the slices in order, scales and stores;
  // after the barrier no block reads another's shared memory
  if (ks > 1)
    cluster_sync();
  else
    __syncthreads();
  T* out = static_cast<T*>(a.out);
  const int u0 = slice * share;
  for (int j = tid; j < share && u0 + j < units; j += G::kThreads) {
    const int u = u0 + j, m = u / (kCols / 4), c = (u % (kCols / 4)) * 4;
    const int col = c0 + c;
    if (col >= a.N) continue;
    float4 v = *reinterpret_cast<const float4*>(recv + (size_t)j * 4);
    for (int q = 1; q < ks; ++q)
      add4(v, *reinterpret_cast<const float4*>(recv + ((size_t)q * share + j) * 4));
    const float4 sc = *reinterpret_cast<const float4*>(a.scales + col);
    v.x *= sc.x;
    v.y *= sc.y;
    v.z *= sc.z;
    v.w *= sc.w;
    if constexpr (kF32) {
      *reinterpret_cast<float4*>(out + (size_t)m * a.N + col) = v;
    } else {
      *reinterpret_cast<uint2*>(out + (size_t)m * a.N + col) =
          make_uint2(pack2<T>(v.x, v.y), pack2<T>(v.z, v.w));
    }
  }
}

// W [K, N] int8 as (N, K), boxes of 128 columns x a stage's rows; x [M, K]
// as (K, M), boxes of 64 (bf16, fp16) or 32 (f32) columns x MP rows; 128-byte
// swizzle, zeros past every edge
int map_stream(CUtensorMap* map, const void* base, CUtensorMapDataType type, int es, int cols,
               int rows, int box_cols, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTmaError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * es};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTmaError + (int)r;
}

template <typename T, int NTW, int LG>
int launch(const void* x, const void* w, const void* scales, void* out, int M, int K, int N,
           int kc, int ksplit, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  using G = Geometry<T, NTW, LG>;
  CUtensorMap mw, mx;
  if (int e = map_stream(&mw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, kCols, G::kBK))
    return e;
  const CUtensorMapDataType xt = kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (int e = map_stream(&mx, x, xt, sizeof(T), K, M, kF32 ? 32 : 64, G::MP))
    return e;
  const Args a{static_cast<const float*>(scales), out, M, K, N, kc, ksplit, G::stages()};
  const int smem = G::smem(a.stages);
  auto kernel = int8_stream_kernel<T, NTW, LG>;
  if (cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + kCols - 1) / kCols * ksplit));
  cfg.blockDim = dim3(G::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ksplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // programmatic dependent launch: the blocks may start while the kernel
  // before finishes (griddepcontrol.wait guards what depends on it)
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  if (cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, mw, mx, a)) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const void* scales, void* out, int M, int K, int N,
             int kc, int ksplit, cudaStream_t s) {
  if (M <= 8) return launch<T, 1, 1>(x, w, scales, out, M, K, N, kc, ksplit, s);
  if (M <= 16) return launch<T, 2, 1>(x, w, scales, out, M, K, N, kc, ksplit, s);
  if (M <= 32) return launch<T, 4, 1>(x, w, scales, out, M, K, N, kc, ksplit, s);
  return launch<T, 4, 2>(x, w, scales, out, M, K, N, kc, ksplit, s);
}

}  // namespace ws

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

// 16 int8 -> 16 of type In (exact), in order, as two 16-byte vectors. The
// f32 value of an int8 has its low 16 bits zero, so its bf16 is its high
// half; an int8 is exact in fp16 too.
template <typename In>
__device__ __forceinline__ void widen16(const uint4& v, uint4* out) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    widen4(w[i], f);
    if constexpr (std::is_same<In, __half>::value) {
      o[2 * i] = pack2<__half>(f[0], f[1]);
      o[2 * i + 1] = pack2<__half>(f[2], f[3]);
    } else {
      o[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
      o[2 * i + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
    }
  }
}

// The raw W tile (forward [64 r][128 c], dX [128 c][64 r], int8, packed
// rows, as TMA lands it) to the swizzled bf16 B tile (forward: two boxes of
// 64 columns c by 64 rows r; dX: one box of 128 rows c by 64 columns r),
// pieces t, t + kHelpers, ... of 16 int8 each; every load is issued before
// the first store.
template <bool kDx, typename In>
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
    widen16<In>(v[i], h);
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
    *reinterpret_cast<uint32_t*>(p) = pack2<OutT>(a, b);
}

// The activation type of an output type: fp16 runs fp16 products, bf16 and
// f32 (as its split) bf16 ones.
template <typename OutT>
using InOf = typename std::conditional<std::is_same<OutT, __half>::value, __half,
                                       __nv_bfloat16>::type;

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
      widen_tile<kDx, InOf<OutT>>(base + kABytes + kBBytes, base + kABytes, ht);
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
          Mma<InOf<OutT>, kBN>::template ss<kDx ? 0 : 1>(
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

// The activation map: [pieces, rows, R] bf16 (or fp16) as (R, rows,
// pieces), boxes of 64 x 256 x 1, 128-byte swizzle. The W map: [K, N] int8 as (N, K), boxes
// of 128 x 64 (forward: 64 rows of W, 128 columns) or 64 x 128 (dX: 128
// rows of W, 64 columns), unswizzled. Reads past an edge give zeros.
int map_a(CUtensorMap* map, const void* base, int pieces, int rows, int R, bool f16) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTmaError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)R, (cuuint64_t)rows, (cuuint64_t)pieces};
  const cuuint64_t strides[2] = {(cuuint64_t)R * 2, (cuuint64_t)rows * R * 2};
  const cuuint32_t box[3] = {kBK, kBM, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            3, const_cast<void*>(base),
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
  if (int e = map_a(&ma, act, pieces, M, R, std::is_same<OutT, __half>::value)) return e;
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

// The tensor-core kernel. Forward (dx 0): act [pieces, M, K] bf16 (fp16
// when out is), w int8 [K, N], scales f32 [N] -> out [M, N]. dX (dx 1): act
// [pieces, M, N] bf16, already scaled by the pre-pass -> out [M, K]. out is
// bf16 (out_type 0), f32 (1) or, for the forward, fp16 (2). The caller has
// checked K % 16 == 0, N % 16 == 0, 16-byte alignment, contiguity and
// dtypes. Returns the cudaError_t of the launch (0 on success), or 10000 +
// the CUresult of a tensor map cuTensorMapEncodeTiled refused.
extern "C" int int8_matmul_tc(const void* act, int pieces, const void* w, const void* scales,
                              void* out, int M, int K, int N, int dx, int out_type,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pieces < 1 || out_type < 0 || out_type > 2 || (dx && out_type == 2))
    return (int)cudaErrorInvalidValue;
  if (dx)
    return out_type == 1 ? tc::launch_tc<true, float>(act, pieces, w, scales, out, M, K, N, s)
                         : tc::launch_tc<true, __nv_bfloat16>(act, pieces, w, scales, out, M, K,
                                                              N, s);
  if (out_type == 2)
    return tc::launch_tc<false, __half>(act, pieces, w, scales, out, M, K, N, s);
  return out_type == 1 ? tc::launch_tc<false, float>(act, pieces, w, scales, out, M, K, N, s)
                       : tc::launch_tc<false, __nv_bfloat16>(act, pieces, w, scales, out, M, K,
                                                             N, s);
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

// The interface version: kernel_ab tells this source from the earlier
// stream (a K-split kernel writing f32 partials, then a finalize kernel) by it.
extern "C" int int8_stream_abi() { return 2; }

// The weight stream: x [M, K] (dtype 0 f32, 1 bf16, 2 fp16), w int8 [K, N], scales
// f32 [N], out [M, N] of x's type, 1 <= M <= 64. kc: K rows a slice, a
// multiple of 64; ksplit: slices, 1..8 (one cluster of ksplit blocks a
// column tile of 128), kc * (ksplit - 1) < K <= kc * ksplit. The caller has
// checked K % 16 == 0, N % 16 == 0, 16-byte alignment, contiguity and
// dtypes. Returns the cudaError_t of the launch (0 on success), or 10000 +
// the CUresult of a tensor map the driver refused.
extern "C" int int8_matmul(const void* x, const void* w, const void* scales, void* out, int M,
                           int K, int N, int kc, int ksplit, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || M > 64 || ksplit < 1 || ksplit > ws::kMaxSplit || kc < ws::kSliceRows ||
      kc % ws::kSliceRows || (long long)kc * (ksplit - 1) >= K || (long long)kc * ksplit < K)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return ws::dispatch<float>(x, w, scales, out, M, K, N, kc, ksplit, s);
  if (dtype == 1) return ws::dispatch<__nv_bfloat16>(x, w, scales, out, M, K, N, kc, ksplit, s);
  if (dtype == 2) return ws::dispatch<__half>(x, w, scales, out, M, K, N, kc, ksplit, s);
  return (int)cudaErrorInvalidValue;
}
