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
// h / (H/Hk), softmax in f32, output in q's dtype; an inactive lane (length
// 0 on trash block 0) sees exactly one slot. The bundled TPU kernel applies
// no 1/sqrt(hd) scale; this kernel does. bf16, fp16 and f32, any head_dim
// up to 1024, any page size, any H % Hk == 0.
//
// Bound on the H100: bytes. Each visible K and V row is read once (lanes x
// visible slots x Hk x hd x 2 tensors x 2 B in bf16) against 3.35 TB/s; the
// arithmetic is 4 FLOPs per element read, far below the ridge point. At the
// serving shape (8 lanes, H 32, Hk 8, hd 128) a call moves ~14 MB: 4.3 us,
// so the fixed costs of a launch are of the same order as the stream.
//
// Design: one launch per call, its grid fixed by the shapes (the wrapper
// passes two blocks an SM, one past 256 columns), so a CUDA graph can hold
// it.
// - Split-KV, each lane on its own. Each (lane, KV head, pass) pair's
//   visible units (pages; in the wide mode below, boxes of rows of a page)
//   are cut into chunks of Kc units, Kc passed by the wrapper from the
//   shapes alone (ops/paged_attention.py chunk_units), so a lane's split
//   points, and its result's bits, depend on its own length only; block j
//   takes chunks j, j + grid, ..., and a block's warps take a chunk's
//   stages counted from the chunk's first. Every block reads `lengths`
//   itself and finds its chunk on the device: no host read of `lengths`,
//   ever. (A Kc found from this call's lengths balanced skewed lanes, but
//   moved one lane's split points when another lane grew: PERF.md.)
// - A page ring fed by TMA. A 4-D tensor map over the pool [nb, bs, Hk, hd]
//   loads one KV head's rows of one page, K and V, per stage (a page of more
//   than 8 KB as several boxes of rows); the block-table entry is the page
//   coordinate. Each box row is read 8 elements wider than hd (the map's
//   extent is hd, so TMA fills them with zeros): rows 16 bytes apart from
//   a power of two keep ldmatrix free of bank conflicts. One producer warp
//   (one thread issues, the warp reads the table 32 pages at a time) keeps
//   up to 64 KB in flight, through full/empty mbarriers with bounded waits.
//   A pool whose rows are not a multiple of 16 bytes (hd % 8 != 0 in
//   bf16/fp16, hd % 4 != 0 in f32) has no tensor map: there the whole
//   producer warp copies each box with plain loads, at the widest unit
//   (8, 4 or 2 bytes) that divides a row, into the same ring slot at a
//   pitch of round_up(hd, 8) + 8, zero-fills the columns past hd and
//   arrives on the stage's full barrier, one arrival a lane (the kernel's
//   kTma = false instantiations, so the TMA ones hold no copy code). A
//   partial's row is then round_up(hd, 8) floats, and q and out rows that
//   are not whole 16-byte chunks are read and written element by element.
// - Consumers, bf16 and fp16: tensor cores (mma.sync m16n8k16). Each of the
//   four consumer warps takes every fourth stage and keeps its own online
//   softmax: S = Q K^T for the GQA group's query heads (up to 8 a pass, the
//   rows of M = 16; a larger group takes more passes, each a pair of its
//   own) over 16 slots at a time, then O += P V with P rounded to the input
//   type as the plain version rounds it. SIMT arithmetic took ~2000 cycles
//   a 16-slot page against ~1000 for the page's share of the stream
//   (PERF.md), so the consumers, not the loads, had set the pace.
//   f32: every warp reads every stage, a row split over up to 32 lanes (16
//   bytes each), two rows a slot group at a time, f32 FMAs.
// - Stale bytes never enter the result: TMA loads whole boxes of rows, but
//   a slot past the lane's length is masked out of the scores before the
//   max, and its V row (NaN or Inf in a torch.empty pool) is zeroed in
//   registers before the product (SIMT: never read). Pages past the length
//   are never loaded.
// - One launch, no merge kernel and no memset: a pair cut into several
//   chunks leaves each chunk's (max, sum, f32 accumulator) in scratch at
//   slot = chunk; the block that finishes the pair last, found through a
//   per-pair atomic ticket, merges the partials in chunk order, so the
//   result does not depend on scheduling, writes the output and resets the
//   ticket to zero for the next call. A pair of one chunk writes its output
//   directly.
//
// The wide mode (`paged_decode_wide_kernel`): head dims past 256 or pages
// past 256 slots. A box's inner dimension stops at 256 elements, and so
// does a warp's f32 accumulator at 256 columns; a page of 512 slots as the
// schedule's unit leaves the longest lane two chunks of 512 rows.
// - Column split: each of the four consumer warps owns one slice of
//   wc = round_up(ceil(hd / 4), 8) columns (80 at hd 320, 256 at 1024) and
//   reads every stage; a stage holds one K box and one V box per slice, each
//   wc + 8 columns wide (wc at wc 256) at column w * wc. Each warp's score
//   product covers its slice (its Q fragment is zero past it); the four
//   partial scores are added in warp order through shared memory, behind a
//   named barrier of the consumers, so every warp holds the same S, running
//   max and sum bit for bit, and adds P V over its own columns. The block's
//   reduction area is then one row a query head (33 KB at hd 1024, hp 8).
// - O is kept transposed: O^T += V^T P^T (m16n8k16 with V's 16 columns as
//   the rows, P^T's 16 slots x 8 heads as B), so a slice of 256 columns
//   holds 64 accumulators a thread, where Q's 16-row side would hold 128
//   with half of them the zero rows past 8 heads.
// - Units: boxes of `rows` rows of a page (16 at most widths, so a 512-slot
//   page is 32 units and a long lane spreads over many blocks); a box may
//   reach past its page's end, where TMA reads zeros (the map's page extent
//   is bs) and the copying producer stops. Any page size, prime ones too.
// - f32: the same slices on the CUDA cores, two rows at a time, each warp's
//   partial dot products reduced by shuffles and added in warp order
//   through shared memory.

#include "hopper.cuh"

namespace paged {

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kMaxStages = 16;
constexpr int kE = 8;              // f32 elements of a row a SIMT thread holds (two 16-byte chunks)
constexpr int kBoxBytes = 8192;    // rows of one box (K or V) at most
constexpr int kRingBytes = 64 * 1024;
constexpr int kTmaError = 10000;   // + CUresult of a refused tensor map
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNarrow = 256;       // head dims and page sizes of the narrow mode
constexpr int kSlices = kConsumerWarps;  // wide: column slices, one a consumer warp
constexpr int kXsBytes = 2 * kSlices * 32 * 16;  // wide: partial scores, two parities

struct Args {
  const void* q;          // [lanes, H, hd]
  void* out;              // [lanes, H, hd]
  const int* table;       // [lanes, MB]
  const int* lengths;     // [lanes]
  float* part;            // [slots, hp, hdp] accumulators, then [slots, hp, 2] (max, sum);
                          // slots: pairs x ceil(units a full lane / kc)
  int* tickets;           // [pairs], zero between calls
  const void* pool_k;     // [nb, bs, Hk, hd]: read directly where tma is 0 (kTma false)
  const void* pool_v;
  int lanes, H, Hk, hd, bs, MB, grid;
  int kc;                 // units a chunk (the wrapper's, from the shapes)
  int hdp;                // hd rounded up to 8: a partial row's floats
  int tma;                // 1: TMA boxes; 0: rows not 16-byte multiples, the warp copies
  int rows;               // rows of a box: a divisor of bs (narrow), at most bs (wide)
  int pitch;              // elements of a row in shared memory: hd + 8 (TMA; hd up to
                          // 248), round_up(hd, 8) + 8 (copies); wide: wc + 8 (wc at 256)
  int wc;                 // wide: columns of a warp's slice, a multiple of 8; narrow: 0
  int upp;                // the schedule's units a page: 1 (narrow), ceil(bs / rows) (wide)
  int stages;             // boxes of K and V in the ring
  int hp;                 // query heads a pass: a power of two up to 8
  int npass;              // passes over a GQA group of H / Hk heads
  int T;                  // f32: lanes sharing a row
  float scale2;           // log2(e) / sqrt(hd)
};

// shared memory in bytes from a 128-byte aligned base (host and device); a
// box holds whole 16-row groups, so the tensor cores' reads past its rows
// stay inside it. Wide: a stage is kSlices K boxes, then kSlices V boxes
// (f32 boxes are not padded), one reduction row a query head, and the
// exchange of partial scores.
struct Layout {
  int box, stage, bars, prefix, red, flag, xs, total;
  __host__ __device__ Layout(const Args& a, int es) {
    const bool wide = a.wc > 0;
    const int brows = wide && es == 4 ? a.rows : (a.rows + 15) / 16 * 16;
    box = (brows * a.pitch * es + 127) / 128 * 128;
    stage = (wide ? 2 * kSlices : 2) * box;            // K box(es), then V box(es)
    bars = a.stages * stage;                           // full[stages], empty[stages]
    prefix = bars + 2 * a.stages * 8;                  // chunks before lane [lanes + 1], slots [lanes]
    red = (prefix + 4 * (2 * a.lanes + 1) + 15) / 16 * 16;  // [warps][hp][hdp], [warps][hp][2]
    flag = red + (wide ? 1 : kConsumerWarps) * a.hp * (a.hdp + 2) * 4;
    xs = (flag + 16 + 15) / 16 * 16;                   // after the ticket's verdict
    total = wide ? xs + kXsBytes : flag + 16;
  }
};

// 16 bytes of T as floats, and back
template <typename T>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ uint4 narrow(const float* f) {
    return make_uint4(pack2<__nv_bfloat16>(f[0], f[1]), pack2<__nv_bfloat16>(f[2], f[3]),
                      pack2<__nv_bfloat16>(f[4], f[5]), pack2<__nv_bfloat16>(f[6], f[7]));
  }
};
template <>
struct Chunk<__half> {
  static constexpr int V = 8;
  static __device__ __forceinline__ uint4 narrow(const float* f) {
    return make_uint4(pack2<__half>(f[0], f[1]), pack2<__half>(f[2], f[3]),
                      pack2<__half>(f[4], f[5]), pack2<__half>(f[6], f[7]));
  }
};
template <>
struct Chunk<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void widen(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 narrow(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

template <typename T>
__device__ __forceinline__ T to_type(float v);
template <>
__device__ __forceinline__ float to_type<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_type<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half to_type<__half>(float v) { return __float2half_rn(v); }

// V output values from column col of a row: one 16-byte store where the row
// holds whole chunks, else element by element up to hd
template <typename T>
__device__ __forceinline__ void store_chunk(T* row, int col, int hd, const float* av) {
  constexpr int V = Chunk<T>::V;
  if (hd % V == 0) {
    *reinterpret_cast<uint4*>(row + col) = Chunk<T>::narrow(av);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (col + i < hd) row[col + i] = to_type<T>(av[i]);
  }
}

// the warp copies rows [row0, row0 + nrows) of KV head g of page pk, columns
// [col0, col0 + cols), into a ring slot, U bytes a load, zeros past them up
// to the pitch (pools that TMA cannot map)
template <typename U>
__device__ __forceinline__ void copy_box(unsigned char* dst, const void* pool, const Args& a,
                                         int es, int pk, int g, int row0, int lane, int col0,
                                         int cols, int nrows) {
  const size_t row_stride = (size_t)a.Hk * a.hd * es;
  const unsigned char* src =
      static_cast<const unsigned char*>(pool) + ((size_t)pk * a.bs + row0) * row_stride +
      ((size_t)g * a.hd + col0) * es;
  const int data = cols * es / (int)sizeof(U), per_row = a.pitch * es / (int)sizeof(U);
  const int n = nrows * per_row;
  for (int i0 = lane; i0 < n; i0 += 4 * 32) {
    U v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 32 * u, r = i / per_row, c = i - r * per_row;
      v[u] = U{};
      if (i < n && c < data) v[u] = reinterpret_cast<const U*>(src + r * row_stride)[c];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 32 * u;
      if (i < n) reinterpret_cast<U*>(dst)[i] = v[u];
    }
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// weight of a partial with max m in a merge whose max is mm (a partial that
// saw no slot has m = -inf and weighs nothing)
__device__ __forceinline__ float weight(float m, float mm) {
  return m == neg_inf() ? 0.f : exp2f(m - mm);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D[16 x 8] += A[16 x 16] B[16 x 8], f32 sums. A: rows g and g + 8 of lane
// 4 g + t, columns 2t, 2t + 1 (a0) and 2t + 8, 2t + 9 (a2); this kernel's
// rows g + 8 are zero. B: rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of
// column g. D: row g columns 2t, 2t + 1 (d0, d1), row g + 8 (d2, d3).
template <typename T>
__device__ __forceinline__ void mma16816(float* d, uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
  }
}

// D[16 x 8] += A[16 x 16] B[16 x 8] with all 16 rows of A: a0 (row g,
// columns 2t, 2t + 1), a1 (row g + 8), a2 (row g, columns 2t + 8, 2t + 9),
// a3 (row g + 8, columns 2t + 8, 2t + 9); B and D as mma16816
template <typename T>
__device__ __forceinline__ void mma_full(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// the low or high 16 bits of a pair zeroed where a slot is not visible
__device__ __forceinline__ uint32_t keep(uint32_t v, bool lo, bool hi) {
  return v & ((lo ? 0x0000ffffu : 0u) | (hi ? 0xffff0000u : 0u));
}

// chunk c -> lane b, pair within the lane, chunk within the pair (of cpp)
__device__ __forceinline__ void locate(const int* cpre, int lanes, int per_lane, int c, int& b,
                                       int& sub, int& ci, int& cpp) {
  int lo = 0, hi = lanes - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cpre[mid] * per_lane <= c) lo = mid; else hi = mid - 1;
  }
  b = lo;
  cpp = cpre[b + 1] - cpre[b];
  const int r = c - cpre[b] * per_lane;
  sub = r / cpp;
  ci = r - sub * cpp;
}

// SIMT (f32): the 16-byte chunks t, t + TL of row s of a staged box as
// floats (zeros for a chunk past the row or a row that is not read)
__device__ __forceinline__ void load_row(const float* box, int s, bool ok, int t, int TL, int C,
                                         int pitch, float* f) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ch = t + k * TL;
    if (ok && ch < C) {
      Chunk<float>::widen(*reinterpret_cast<const uint4*>(box + (size_t)s * pitch + ch * 4),
                          f + k * 4);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[k * 4 + i] = 0.f;
    }
  }
}

// Tensor cores (bf16, fp16): DP >= hd rounded up to 16 columns.
template <typename T, int DP>
struct MmaConsumer {
  static constexpr int kNT = DP / 8;  // n-tiles of the output
  uint32_t qa[DP / 16][2];            // A fragments of q, rows g (heads), per 16 columns
  float o[kNT][4];
  float m, l;                         // row g: running max (log2 units), this thread's sum

  __device__ __forceinline__ void start(const Args& a, const T* qrow, bool head_ok, int t) {
    const uint16_t* q16 = reinterpret_cast<const uint16_t*>(qrow);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int col = kk * 16 + hf * 8 + 2 * t;
        if (a.hd % 2 == 0) {  // a pair a load; an odd head dim's rows are 2-byte aligned
          qa[kk][hf] = head_ok && col < a.hd ? *reinterpret_cast<const uint32_t*>(q16 + col) : 0u;
        } else {
          const uint32_t lo = head_ok && col < a.hd ? q16[col] : 0u;
          const uint32_t hi = head_ok && col + 1 < a.hd ? q16[col + 1] : 0u;
          qa[kk][hf] = lo | hi << 16;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
    m = neg_inf();
    l = 0.f;
  }

  // rows 0 .. rv - 1 of a staged box (K at ks, V at vs)
  __device__ __forceinline__ void box(const Args& a, uint32_t ks, uint32_t vs, int rv, int lane) {
    const int t = lane & 3, i4 = lane >> 3, r8 = lane & 7;
    const uint32_t row_bytes = a.pitch * sizeof(T);
    for (int s16 = 0; s16 < rv; s16 += 16) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      // S = Q K^T over slots s16 .. s16 + 15: matrices (slots 0-7 | 8-15) x (k 0-7 | 8-15)
      const uint32_t kaddr = ks + (s16 + (i4 >> 1) * 8 + r8) * row_bytes + (i4 & 1) * 16;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        if (kk * 16 < a.hd) {
          uint32_t b[4];
          ldsm_x4(kaddr + kk * 32, b);
          mma16816<T>(s[0], qa[kk][0], qa[kk][1], b[0], b[1]);
          mma16816<T>(s[1], qa[kk][0], qa[kk][1], b[2], b[3]);
        }
      }
      // online softmax of row g over this thread's slots 2t, 2t + 1, 8 + 2t, 9 + 2t
      const int n = rv - s16;  // visible slots of this group
      float x[4];
      float mx = neg_inf();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int slot = (i >> 1) * 8 + 2 * t + (i & 1);
        x[i] = slot < n ? s[i >> 1][i & 1] * a.scale2 : neg_inf();
        mx = fmaxf(mx, x[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m, mx);  // finite: slot s16 is visible
      const float al = weight(m, mn);
      m = mn;
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = x[i] == neg_inf() ? 0.f : exp2f(x[i] - mn);
      l = l * al + (p[0] + p[1]) + (p[2] + p[3]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        o[nt][0] *= al;
        o[nt][1] *= al;
      }
      const uint32_t pa0 = pack2<T>(p[0], p[1]), pa2 = pack2<T>(p[2], p[3]);
      // O += P V: matrices (slots 0-7 | 8-15) x (columns n0 .. n0 + 7 | + 8 .. 15), transposed
      const uint32_t vaddr = vs + (s16 + (i4 & 1) * 8 + r8) * row_bytes + (i4 >> 1) * 16;
      const bool partial = n < 16;
      const bool v0 = 2 * t < n, v1 = 2 * t + 1 < n, v8 = 2 * t + 8 < n, v9 = 2 * t + 9 < n;
#pragma unroll
      for (int n0 = 0; n0 < DP; n0 += 16) {
        if (n0 < a.hd) {
          uint32_t b[4];
          ldsm_x4_t(vaddr + n0 * sizeof(T), b);
          if (partial) {  // a V row past the length may hold NaN: 0 * NaN is NaN
            b[0] = keep(b[0], v0, v1);
            b[1] = keep(b[1], v8, v9);
            b[2] = keep(b[2], v0, v1);
            b[3] = keep(b[3], v8, v9);
          }
          mma16816<T>(o[n0 / 8], pa0, pa2, b[0], b[1]);
          mma16816<T>(o[n0 / 8 + 1], pa0, pa2, b[2], b[3]);
        }
      }
    }
  }

  // this warp's (max, sum, accumulator) of heads g < nh into red
  __device__ __forceinline__ void reduce(const Args& a, float* red_acc, float* red_ml, int warp,
                                         int lane, int nh) {
    const int g = lane >> 2, t = lane & 3;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (g < nh) {
      float* dst = red_acc + (warp * a.hp + g) * a.hdp;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = nt * 8 + 2 * t;
        if (col < a.hdp) {
          dst[col] = o[nt][0];
          dst[col + 1] = o[nt][1];
        }
      }
      if (t == 0) {
        red_ml[(warp * a.hp + g) * 2] = m;
        red_ml[(warp * a.hp + g) * 2 + 1] = l;
      }
    }
  }
};

// SIMT (f32): slot group sg of TL lanes; lane t holds chunks t, t + TL of a row
template <int HP>
struct SimtConsumer {
  float qv[HP][kE], acc[HP][kE], m[HP], l[HP];

  __device__ __forceinline__ void start(const Args& a, const float* q0, int nh, int t) {
    const int TL = a.T, C = (a.hd + 3) / 4;
#pragma unroll
    for (int h = 0; h < HP; ++h) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ch = t + k * TL;
        if (h < nh && ch < C) {
          const float* src = q0 + h * a.hd + ch * 4;
          if (a.hd % 4 == 0) {
            Chunk<float>::widen(*reinterpret_cast<const uint4*>(src), &qv[h][k * 4]);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[h][k * 4 + i] = ch * 4 + i < a.hd ? src[i] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) qv[h][k * 4 + i] *= a.scale2;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) qv[h][k * 4 + i] = 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[h][e] = 0.f;
      m[h] = neg_inf();
      l[h] = 0.f;
    }
  }

  __device__ __forceinline__ void box(const Args& a, const float* ks, const float* vs, int rv,
                                      int tid) {
    const int TL = a.T, t = tid & (TL - 1), sg = tid / TL, SG = kConsumers / TL;
    const int C = (a.hd + 3) / 4;
    // two rows a slot group at a time; the loop is uniform over the warp (shuffles)
    for (int s0 = 0; s0 < rv; s0 += 2 * SG) {
      const int sa = s0 + sg, sb = sa + SG;
      const bool va = sa < rv, vb = sb < rv;
      float ka[kE], kb[kE];
      load_row(ks, sa, va, t, TL, C, a.pitch, ka);
      load_row(ks, sb, vb, t, TL, C, a.pitch, kb);
      float xa[HP], xb[HP];
#pragma unroll
      for (int h = 0; h < HP; ++h) {
        float da = 0.f, db = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          da = fmaf(qv[h][e], ka[e], da);
          db = fmaf(qv[h][e], kb[e], db);
        }
        xa[h] = da;
        xb[h] = db;
      }
      for (int o = TL >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int h = 0; h < HP; ++h) {
          xa[h] += __shfl_xor_sync(0xffffffffu, xa[h], o);
          xb[h] += __shfl_xor_sync(0xffffffffu, xb[h], o);
        }
      }
      if (va) {  // vb implies va; a row that is not visible is never read
        float wa[kE], wb[kE];
        load_row(vs, sa, true, t, TL, C, a.pitch, wa);
        load_row(vs, sb, vb, t, TL, C, a.pitch, wb);
#pragma unroll
        for (int h = 0; h < HP; ++h) {
          const float mx = vb ? fmaxf(xa[h], xb[h]) : xa[h];
          if (mx > m[h]) {
            const float al = exp2f(m[h] - mx);
            l[h] *= al;
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[h][e] *= al;
            m[h] = mx;
          }
          const float pa = exp2f(xa[h] - m[h]);
          const float pb = vb ? exp2f(xb[h] - m[h]) : 0.f;
          l[h] += pa + pb;
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[h][e] = fmaf(pa, wa[e], fmaf(pb, wb[e], acc[h][e]));
        }
      }
    }
  }

  // the slot groups of a warp merged by shuffles, then into red
  __device__ __forceinline__ void reduce(const Args& a, float* red_acc, float* red_ml, int warp,
                                         int lane, int nh) {
    const int TL = a.T, t = lane & (TL - 1), C = (a.hd + 3) / 4;
    for (int o = TL; o < 32; o <<= 1) {
#pragma unroll
      for (int h = 0; h < HP; ++h) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[h], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[h], o);
        const float mm = fmaxf(m[h], mo);
        const float wa = weight(m[h], mm), wb = weight(mo, mm);
        l[h] = l[h] * wa + lo * wb;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[h][e], o);
          acc[h][e] = acc[h][e] * wa + ao * wb;
        }
        m[h] = mm;
      }
    }
    if (lane < TL) {
#pragma unroll
      for (int h = 0; h < HP; ++h) {
        if (h >= nh) continue;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int ch = t + k * TL;
          if (ch < C) {
            float* dst = red_acc + (warp * a.hp + h) * a.hdp + ch * 4;
#pragma unroll
            for (int i = 0; i < 4; ++i) dst[i] = acc[h][k * 4 + i];
          }
        }
        if (t == 0) {
          red_ml[(warp * a.hp + h) * 2] = m[h];
          red_ml[(warp * a.hp + h) * 2 + 1] = l[h];
        }
      }
    }
  }
};

// Wide, tensor cores (bf16, fp16): this warp's slice of a.wc columns at
// column col0, DP >= wc rounded up to 16. S's partials go through xs
// ([2][warps][32] float4: a parity, a warp, a lane), so every warp adds the
// four in warp order and holds the same S. O is kept transposed: o[mt] is
// O^T over columns mt * 16 + g (d0, d1: heads 2t, 2t + 1) and + 8 (d2, d3).
template <typename T, int DP>
struct SplitConsumer {
  static constexpr int kKT = DP / 16;  // 16-column steps of a slice, at most
  uint32_t qa[kKT][2];                 // A fragments of q, rows g (heads), per 16 columns
  float o[kKT][4];
  float m, l;                          // head g: running max (log2 units), this thread's sum

  __device__ __forceinline__ void start(const Args& a, const T* qrow, bool head_ok, int t,
                                        int col0) {
    const uint16_t* q16 = reinterpret_cast<const uint16_t*>(qrow);
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int col = kk * 16 + hf * 8 + 2 * t, gc = col0 + col;
        const bool ok = head_ok && col < a.wc && gc < a.hd;
        if (a.hd % 2 == 0) {  // col0 is even: a pair a load
          qa[kk][hf] = ok ? *reinterpret_cast<const uint32_t*>(q16 + gc) : 0u;
        } else {
          const uint32_t lo = ok ? q16[gc] : 0u;
          const uint32_t hi = ok && gc + 1 < a.hd ? q16[gc + 1] : 0u;
          qa[kk][hf] = lo | hi << 16;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kKT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
    m = neg_inf();
    l = 0.f;
  }

  // rows 0 .. rv - 1 of this warp's staged slice (K at ks, V at vs)
  __device__ __forceinline__ void box(const Args& a, uint32_t ks, uint32_t vs, int rv, int lane,
                                      int warp, float4* xs, int& ex) {
    const int t = lane & 3, i4 = lane >> 3, r8 = lane & 7;
    const uint32_t row_bytes = a.pitch * sizeof(T);
    const int kt = (a.wc + 15) / 16;
    for (int s16 = 0; s16 < rv; s16 += 16) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      // this slice's S = Q K^T over slots s16 .. s16 + 15, as MmaConsumer
      const uint32_t kaddr = ks + (s16 + (i4 >> 1) * 8 + r8) * row_bytes + (i4 & 1) * 16;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        if (kk < kt) {
          uint32_t b[4];
          ldsm_x4(kaddr + kk * 32, b);
          mma16816<T>(s[0], qa[kk][0], qa[kk][1], b[0], b[1]);
          mma16816<T>(s[1], qa[kk][0], qa[kk][1], b[2], b[3]);
        }
      }
      // the slices' partials added in warp order (the parities alternate, so
      // one barrier a group keeps a write from overtaking the last read)
      xs[(ex * kSlices + warp) * 32 + lane] = make_float4(s[0][0], s[0][1], s[1][0], s[1][1]);
      consumers_sync();
      const float4* all = xs + ex * kSlices * 32 + lane;
      float4 sum = all[0];
#pragma unroll
      for (int w = 1; w < kSlices; ++w) {
        const float4 p = all[w * 32];
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      ex ^= 1;
      // online softmax of head g over this thread's slots 2t, 2t + 1, 8 + 2t, 9 + 2t
      const int n = rv - s16;
      const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
      float x[4];
      float mx = neg_inf();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int slot = (i >> 1) * 8 + 2 * t + (i & 1);
        x[i] = slot < n ? sv[i] * a.scale2 : neg_inf();
        mx = fmaxf(mx, x[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m, mx);  // finite: slot s16 is visible
      const float al = weight(m, mn);
      m = mn;
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = x[i] == neg_inf() ? 0.f : exp2f(x[i] - mn);
      l = l * al + (p[0] + p[1]) + (p[2] + p[3]);
      // O^T's columns hold heads 2t, 2t + 1: their factors from groups 2t, 2t + 1
      const float al0 = __shfl_sync(0xffffffffu, al, 8 * t);
      const float al1 = __shfl_sync(0xffffffffu, al, 8 * t + 4);
#pragma unroll
      for (int mt = 0; mt < kKT; ++mt) {
        o[mt][0] *= al0;
        o[mt][1] *= al1;
        o[mt][2] *= al0;
        o[mt][3] *= al1;
      }
      // P^T as B: head g's slots 2t, 2t + 1 (b0) and 8 + 2t, 9 + 2t (b1)
      const uint32_t pb0 = pack2<T>(p[0], p[1]), pb1 = pack2<T>(p[2], p[3]);
      // O^T += V^T P^T: A = V^T, matrices (columns 0-7 | 8-15) x (slots 0-7 | 8-15)
      const uint32_t vaddr = vs + (s16 + (i4 >> 1) * 8 + r8) * row_bytes + (i4 & 1) * 16;
      const bool partial = n < 16;
      const bool v0 = 2 * t < n, v1 = 2 * t + 1 < n, v8 = 2 * t + 8 < n, v9 = 2 * t + 9 < n;
#pragma unroll
      for (int mt = 0; mt < kKT; ++mt) {
        if (mt < kt) {
          uint32_t va[4];
          ldsm_x4_t(vaddr + mt * 32, va);
          if (partial) {  // a V row past the length may hold NaN: 0 * NaN is NaN
            va[0] = keep(va[0], v0, v1);
            va[1] = keep(va[1], v0, v1);
            va[2] = keep(va[2], v8, v9);
            va[3] = keep(va[3], v8, v9);
          }
          mma_full<T>(o[mt], va, pb0, pb1);
        }
      }
    }
  }

  // this warp's columns of heads < nh into red (one row a head); every warp
  // holds the same max and sum, warp 0 writes them
  __device__ __forceinline__ void reduce(const Args& a, float* red_acc, float* red_ml, int warp,
                                         int lane, int nh) {
    const int g = lane >> 2, t = lane & 3, col0 = warp * a.wc;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
#pragma unroll
    for (int mt = 0; mt < kKT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = 2 * t + (e & 1), col = mt * 16 + g + (e >> 1) * 8;
        if (h < nh && col < a.wc && col0 + col < a.hdp) red_acc[h * a.hdp + col0 + col] = o[mt][e];
      }
    }
    if (warp == 0 && t == 0 && g < nh) {
      red_ml[g * 2] = m;
      red_ml[g * 2 + 1] = l;
    }
  }
};

// Wide, SIMT (f32): this warp's slice of a.wc columns at column col0; lane
// holds the 16-byte chunks lane, lane + 32 of it. Two rows at a time: the
// warp's partial dot products reduced by shuffles, added in warp order
// through xs ([2][warps][HP][2] floats), so every thread holds the same
// scores and softmax state.
template <int HP>
struct SimtSplit {
  float qv[HP][kE], acc[HP][kE], m[HP], l[HP];

  __device__ __forceinline__ void start(const Args& a, const float* q0, int nh, int lane,
                                        int col0) {
    const int C = a.wc / 4;
#pragma unroll
    for (int h = 0; h < HP; ++h) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int ch = lane + (e / 4) * 32, gc = col0 + ch * 4 + e % 4;
        qv[h][e] = h < nh && ch < C && gc < a.hd ? q0[h * a.hd + gc] * a.scale2 : 0.f;
        acc[h][e] = 0.f;
      }
      m[h] = neg_inf();
      l[h] = 0.f;
    }
  }

  __device__ __forceinline__ void box(const Args& a, const float* ks, const float* vs, int rv,
                                      int lane, int warp, float* xs, int& ex) {
    const int C = a.wc / 4;
    for (int s0 = 0; s0 < rv; s0 += 2) {
      const int sb = s0 + 1;
      const bool vb = sb < rv;
      float ka[kE], kb[kE];
      load_row(ks, s0, true, lane, 32, C, a.pitch, ka);
      load_row(ks, sb, vb, lane, 32, C, a.pitch, kb);
      float xa[HP], xb[HP];
#pragma unroll
      for (int h = 0; h < HP; ++h) {
        float da = 0.f, db = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          da = fmaf(qv[h][e], ka[e], da);
          db = fmaf(qv[h][e], kb[e], db);
        }
        xa[h] = da;
        xb[h] = db;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int h = 0; h < HP; ++h) {
          xa[h] += __shfl_xor_sync(0xffffffffu, xa[h], o);
          xb[h] += __shfl_xor_sync(0xffffffffu, xb[h], o);
        }
      }
      float* mine = xs + (ex * kSlices + warp) * HP * 2;
      if (lane == 0) {
#pragma unroll
        for (int h = 0; h < HP; ++h) {
          mine[h * 2] = xa[h];
          mine[h * 2 + 1] = xb[h];
        }
      }
      consumers_sync();
      const float* all = xs + ex * kSlices * HP * 2;
#pragma unroll
      for (int h = 0; h < HP; ++h) {
        xa[h] = all[h * 2];
        xb[h] = all[h * 2 + 1];
#pragma unroll
        for (int w = 1; w < kSlices; ++w) {
          xa[h] += all[(w * HP + h) * 2];
          xb[h] += all[(w * HP + h) * 2 + 1];
        }
      }
      ex ^= 1;
      float wa[kE], wb[kE];  // a row that is not visible is never read
      load_row(vs, s0, true, lane, 32, C, a.pitch, wa);
      load_row(vs, sb, vb, lane, 32, C, a.pitch, wb);
#pragma unroll
      for (int h = 0; h < HP; ++h) {
        const float mx = vb ? fmaxf(xa[h], xb[h]) : xa[h];
        if (mx > m[h]) {
          const float al = exp2f(m[h] - mx);
          l[h] *= al;
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[h][e] *= al;
          m[h] = mx;
        }
        const float pa = exp2f(xa[h] - m[h]);
        const float pb = vb ? exp2f(xb[h] - m[h]) : 0.f;
        l[h] += pa + pb;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[h][e] = fmaf(pa, wa[e], fmaf(pb, wb[e], acc[h][e]));
      }
    }
  }

  __device__ __forceinline__ void reduce(const Args& a, float* red_acc, float* red_ml, int warp,
                                         int lane, int nh) {
    const int C = a.wc / 4, col0 = warp * a.wc;
#pragma unroll
    for (int h = 0; h < HP; ++h) {
      if (h >= nh) continue;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int ch = lane + (e / 4) * 32, col = col0 + ch * 4 + e % 4;
        if (ch < C && col < a.hdp) red_acc[h * a.hdp + col] = acc[h][e];
      }
      if (warp == 0 && lane == 0) {
        red_ml[h * 2] = m[h];
        red_ml[h * 2 + 1] = l[h];
      }
    }
  }
};

// the schedule's units of a lane that sees n slots: its pages (narrow), or
// boxes of a.rows rows of a page, a.upp a page, the last page's cut short
template <bool kWide>
__device__ __forceinline__ int units(const Args& a, int n) {
  if constexpr (kWide) {
    const int whole = n / a.bs;
    return whole * a.upp + (n - whole * a.bs + a.rows - 1) / a.rows;
  } else {
    return (n + a.bs - 1) / a.bs;
  }
}

// the warp's copies of one slice's K and V boxes, U bytes a load
template <typename U>
__device__ __forceinline__ void copy_slice(unsigned char* k, unsigned char* v, const Args& a,
                                           int es, int pk, int g, int r0, int lane, int col0) {
  const int cols = max(0, min(a.pitch, a.hd - col0)), nrows = min(a.rows, a.bs - r0);
  copy_box<U>(k, a.pool_k, a, es, pk, g, r0, lane, col0, cols, nrows);
  copy_box<U>(v, a.pool_v, a, es, pk, g, r0, lane, col0, cols, nrows);
}

// wide producer: one stage a unit (a box of rows of a page), each slice's K
// and V boxes at column w * wc; units u of lane b's pages from p0, np of them
template <typename T, bool kTma>
__device__ __forceinline__ void produce_wide(const Args& a, const Layout& lay, unsigned char* sm,
                                             uint64_t* full, uint64_t* empty,
                                             const CUtensorMap* tk, const CUtensorMap* tv,
                                             uint32_t stage_tx, int b, int g, int p0, int np,
                                             int lane, int& it) {
  for (int base = 0; base < np; base += 32) {
    int phys = 0, first = 0;
    if (base + lane < np) {
      const int u = p0 + base + lane, pi = u / a.upp;
      phys = a.table[(size_t)b * a.MB + pi];
      first = (u - pi * a.upp) * a.rows;
    }
    const int cnt = min(32, np - base);
    for (int k = 0; k < cnt; ++k, ++it) {
      const int pk = __shfl_sync(0xffffffffu, phys, k);
      const int r0 = __shfl_sync(0xffffffffu, first, k);
      const int st = it % a.stages;
      const uint32_t ph = (it / a.stages) & 1;
      unsigned char* dst = sm + st * lay.stage;
      if constexpr (kTma) {
        if (lane == 0) {
          mbar_wait(empty + st, ph ^ 1);
          mbar_expect_tx(full + st, stage_tx);
          for (int w = 0; w < kSlices; ++w) {  // rows past the page's end read as zeros
            tma_load(dst + w * lay.box, tk, full + st, w * a.wc, g, r0, pk);
            tma_load(dst + (kSlices + w) * lay.box, tv, full + st, w * a.wc, g, r0, pk);
          }
        }
      } else {
        constexpr int es = (int)sizeof(T);
        const int rb = a.hd * es;  // bytes of a pool row
        mbar_wait(empty + st, ph ^ 1);
        for (int w = 0; w < kSlices; ++w) {
          unsigned char* kd = dst + w * lay.box;
          unsigned char* vd = dst + (kSlices + w) * lay.box;
          if (rb % 8 == 0) {
            copy_slice<uint2>(kd, vd, a, es, pk, g, r0, lane, w * a.wc);
          } else if (rb % 4 == 0) {
            copy_slice<uint32_t>(kd, vd, a, es, pk, g, r0, lane, w * a.wc);
          } else {
            copy_slice<uint16_t>(kd, vd, a, es, pk, g, r0, lane, w * a.wc);
          }
        }
        mbar_arrive(full + st);
      }
    }
  }
}

// HP: SIMT heads a pass (f32); DP: tensor-core columns (bf16, fp16; wide: of
// a slice); kTma: the pool's rows are 16-byte multiples (else the producer
// warp copies); kWide: head dims or pages past 256 (the column split)
template <typename T, int HP, int DP, bool kTma, bool kWide>
__device__ __forceinline__ void decode(const CUtensorMap& tk, const CUtensorMap& tv,
                                       const Args& a) {
  constexpr bool kMma = !std::is_same<T, float>::value;
  constexpr int kSets = kWide ? 1 : kConsumerWarps;  // partial results merged in the block
  constexpr int V = Chunk<T>::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const Layout lay(a, sizeof(T));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + lay.bars);
  uint64_t* empty = full + a.stages;
  int* cpre = reinterpret_cast<int*>(sm + lay.prefix);  // chunks of a pair, summed over lanes < b
  int* nvis = cpre + a.lanes + 1;                        // visible slots of lane b
  float* red_acc = reinterpret_cast<float*>(sm + lay.red);
  float* red_ml = red_acc + kSets * a.hp * a.hdp;
  int* flag = reinterpret_cast<int*>(sm + lay.flag);     // the ticket's verdict
  float* xs = reinterpret_cast<float*>(sm + lay.xs);     // wide: the slices' partial scores

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cap = a.MB * a.bs;
  const int per_lane = a.Hk * a.npass;  // pairs (KV head, pass) of a lane
  if (tid == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full + i, kTma ? 1 : 32);               // copies: one arrival a lane
      mbar_init(empty + i, kMma && !kWide ? 1 : kConsumerWarps);  // narrow tensor cores:
                                                                  // one warp a stage
    }
    fence_barrier_init();
  }
  if (tid == kConsumers && kTma) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tk)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tv)) : "memory");
  }
  const int Kc = a.kc;
  if (warp == 0) {
    // visible slots of every lane, and a pair's chunks summed over the
    // lanes before lane b (cpre[b])
    int carry = 0;
    for (int base = 0; base < a.lanes; base += 32) {
      const int b = base + lane;
      int p = 0;
      if (b < a.lanes) {
        const int n = min(max(a.lengths[b], 0), cap - 1) + 1;
        nvis[b] = n;
        p = (units<kWide>(a, n) + Kc - 1) / Kc;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, p, o);
        if (lane >= o) p += y;
      }
      if (b < a.lanes) cpre[b + 1] = carry + p;
      carry += __shfl_sync(0xffffffffu, p, 31);
    }
    if (lane == 0) cpre[0] = 0;
  }
  __syncthreads();

  const int nchunks = cpre[a.lanes] * per_lane;
  const int j = blockIdx.x;
  if (j >= nchunks) return;
  const uint32_t stage_tx = (kWide ? 2u * kSlices : 2u) * a.rows * a.pitch * sizeof(T);

  if (warp == kConsumerWarps) {  // producer: the warp reads the table, one thread loads
    int it = 0;
    for (int c = j; c < nchunks; c += a.grid) {
      int b, sub, ci, cpp;
      locate(cpre, a.lanes, per_lane, c, b, sub, ci, cpp);
      const int g = sub / a.npass;
      const int p0 = ci * Kc;
      const int np = min(units<kWide>(a, nvis[b]), p0 + Kc) - p0;
      if constexpr (kWide) {
        produce_wide<T, kTma>(a, lay, sm, full, empty, &tk, &tv, stage_tx, b, g, p0, np, lane,
                              it);
      } else {
        for (int base = 0; base < np; base += 32) {
          int phys = 0, rows = 0;
          if (base + lane < np) {
            const int pi = p0 + base + lane;
            phys = a.table[(size_t)b * a.MB + pi];
            rows = min(a.bs, nvis[b] - pi * a.bs);
          }
          const int cnt = min(32, np - base);
          for (int k = 0; k < cnt; ++k) {
            const int pk = __shfl_sync(0xffffffffu, phys, k);
            const int rk = __shfl_sync(0xffffffffu, rows, k);
            if constexpr (kTma) {
              if (lane == 0) {
                for (int row0 = 0; row0 < rk; row0 += a.rows, ++it) {
                  const int st = it % a.stages;
                  const uint32_t ph = (it / a.stages) & 1;
                  mbar_wait(empty + st, ph ^ 1);
                  mbar_expect_tx(full + st, stage_tx);
                  unsigned char* dst = sm + st * lay.stage;
                  tma_load(dst, &tk, full + st, 0, g, row0, pk);
                  tma_load(dst + lay.box, &tv, full + st, 0, g, row0, pk);
                }
              }
              continue;
            }
            constexpr int es = (int)sizeof(T);
            const int rb = a.hd * es;  // bytes of a pool row
            for (int row0 = 0; row0 < rk; row0 += a.rows, ++it) {
              const int st = it % a.stages;
              const uint32_t ph = (it / a.stages) & 1;
              mbar_wait(empty + st, ph ^ 1);
              unsigned char* dst = sm + st * lay.stage;
              if (rb % 8 == 0) {
                copy_box<uint2>(dst, a.pool_k, a, es, pk, g, row0, lane, 0, a.hd, a.rows);
                copy_box<uint2>(dst + lay.box, a.pool_v, a, es, pk, g, row0, lane, 0, a.hd,
                                a.rows);
              } else if (rb % 4 == 0) {
                copy_box<uint32_t>(dst, a.pool_k, a, es, pk, g, row0, lane, 0, a.hd, a.rows);
                copy_box<uint32_t>(dst + lay.box, a.pool_v, a, es, pk, g, row0, lane, 0, a.hd,
                                   a.rows);
              } else {
                copy_box<uint16_t>(dst, a.pool_k, a, es, pk, g, row0, lane, 0, a.hd, a.rows);
                copy_box<uint16_t>(dst + lay.box, a.pool_v, a, es, pk, g, row0, lane, 0, a.hd,
                                   a.rows);
              }
              mbar_arrive(full + st);
            }
          }
        }
      }
    }
    return;
  }

  // consumers
  const int rep = a.H / a.Hk;
  const T* qg = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);
  const int C = (a.hd + V - 1) / V;  // 16-byte chunks of an output row, the last maybe partial
  const int nslots = a.lanes * per_lane * ((units<kWide>(a, cap) + Kc - 1) / Kc);
  float* part_acc = a.part;
  float* part_ml = a.part + (size_t)nslots * a.hp * a.hdp;
  using Narrow = typename std::conditional<kMma, MmaConsumer<T, DP>, SimtConsumer<HP>>::type;
  using Wide = typename std::conditional<kMma, SplitConsumer<T, DP>, SimtSplit<HP>>::type;
  typename std::conditional<kWide, Wide, Narrow>::type cs;
  int it = 0, ex = 0;
  for (int c = j; c < nchunks; c += a.grid) {
    const int it0 = it;  // the chunk's first stage: its warps count from there
    int b, sub, ci, nsplit;
    locate(cpre, a.lanes, per_lane, c, b, sub, ci, nsplit);
    const int g = sub / a.npass, pass = sub - g * a.npass;
    const int p0 = ci * Kc;
    const int np = min(units<kWide>(a, nvis[b]), p0 + Kc) - p0;
    const int first = c - ci;  // the pair's chunks are first .. first + nsplit - 1
    const int pair = b * per_lane + sub;
    const int h0 = g * rep + pass * a.hp;  // first query head of this pass
    const int nh = min(a.hp, rep - pass * a.hp);
    const T* q0 = qg + ((size_t)b * a.H + h0) * a.hd;
    if constexpr (kWide && kMma) {
      cs.start(a, q0 + (lane >> 2) * a.hd, (lane >> 2) < nh, lane & 3, warp * a.wc);
    } else if constexpr (kWide) {
      cs.start(a, q0, nh, lane, warp * a.wc);
    } else if constexpr (kMma) {
      cs.start(a, q0 + (lane >> 2) * a.hd, (lane >> 2) < nh, lane & 3);
    } else {
      cs.start(a, q0, nh, lane & (a.T - 1));
    }

    if constexpr (kWide) {  // every warp reads every unit, its own slice of each stage
      for (int u = p0; u < p0 + np; ++u, ++it) {
        const int pi = u / a.upp, r0 = (u - pi * a.upp) * a.rows;
        const int rv = min(min(a.rows, a.bs - r0), nvis[b] - pi * a.bs - r0);
        const int st = it % a.stages;
        const uint32_t ph = (it / a.stages) & 1;
        mbar_wait(full + st, ph);
        unsigned char* stage = sm + st * lay.stage;
        if constexpr (kMma) {
          const uint32_t ks = smem_u32(stage + warp * lay.box);
          cs.box(a, ks, ks + kSlices * lay.box, rv, lane, warp, reinterpret_cast<float4*>(xs),
                 ex);
        } else {
          const float* ks = reinterpret_cast<const float*>(stage + warp * lay.box);
          cs.box(a, ks, ks + kSlices * lay.box / 4, rv, lane, warp, xs, ex);
        }
        release(empty + st);
      }
    } else {
      for (int pi = p0; pi < p0 + np; ++pi) {
        const int rows = min(a.bs, nvis[b] - pi * a.bs);
        for (int row0 = 0; row0 < rows; row0 += a.rows, ++it) {
          const int st = it % a.stages;
          if (kMma && ((it - it0) & (kConsumerWarps - 1)) != warp) continue;  // another warp's
          const uint32_t ph = (it / a.stages) & 1;
          mbar_wait(full + st, ph);
          const int rv = min(a.rows, rows - row0);  // rows of this box that are visible
          if constexpr (kMma) {
            const uint32_t ks = smem_u32(sm + st * lay.stage);
            cs.box(a, ks, ks + lay.box, rv, lane);
          } else {
            const float* ks = reinterpret_cast<const float*>(sm + st * lay.stage);
            cs.box(a, ks, ks + lay.box / 4, rv, tid);
          }
          release(empty + st);
        }
      }
    }
    cs.reduce(a, red_acc, red_ml, warp, lane, nh);
    consumers_sync();

    // the warps merged in order, per (head, chunk): the output, or a partial
    const size_t slot = c;
    for (int idx = tid; idx < nh * C; idx += kConsumers) {
      const int h = idx / C, ch = idx - h * C;
      float mm = neg_inf();
      for (int w = 0; w < kSets; ++w) mm = fmaxf(mm, red_ml[(w * a.hp + h) * 2]);
      float ls = 0.f, av[V];
#pragma unroll
      for (int i = 0; i < V; ++i) av[i] = 0.f;
      for (int w = 0; w < kSets; ++w) {
        const float wt = weight(red_ml[(w * a.hp + h) * 2], mm);
        if (wt == 0.f) continue;  // a warp that saw no slot of this chunk
        ls += red_ml[(w * a.hp + h) * 2 + 1] * wt;
        const float* src = red_acc + (w * a.hp + h) * a.hdp + ch * V;
#pragma unroll
        for (int i = 0; i < V; ++i) av[i] += src[i] * wt;
      }
      if (nsplit == 1) {
#pragma unroll
        for (int i = 0; i < V; ++i) av[i] /= ls;
        store_chunk<T>(out + ((size_t)b * a.H + h0 + h) * a.hd, ch * V, a.hd, av);
      } else {
        float4* dst = reinterpret_cast<float4*>(part_acc + (slot * a.hp + h) * a.hdp + ch * V);
#pragma unroll
        for (int i = 0; i < V / 4; ++i)
          dst[i] = make_float4(av[4 * i], av[4 * i + 1], av[4 * i + 2], av[4 * i + 3]);
        if (ch == 0) {
          part_ml[(slot * a.hp + h) * 2] = mm;
          part_ml[(slot * a.hp + h) * 2 + 1] = ls;
        }
      }
    }
    consumers_sync();
    if (nsplit == 1) continue;

    // the last block of the pair merges its partials in chunk order (the
    // barrier above orders every thread's partial before this fence)
    if (tid == 0) {
      __threadfence();
      const int old = atomicAdd(a.tickets + pair, 1);
      *flag = old == nsplit - 1;
      __threadfence();
    }
    consumers_sync();
    if (*flag) {
      // split k of this pair at slot first + k; loads batched ahead of
      // their use (the sums stay in split order)
      const float* ml0 = part_ml + (size_t)first * a.hp * 2;
      const float* acc0 = part_acc + (size_t)first * a.hp * a.hdp;
      for (int idx = tid; idx < nh * C; idx += kConsumers) {
        const int h = idx / C, ch = idx - h * C;
        float mm = neg_inf();
        for (int k0 = 0; k0 < nsplit; k0 += 8) {
          float mk[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            mk[u] = k0 + u < nsplit ? __ldcg(ml0 + (size_t)(k0 + u) * a.hp * 2 + h * 2)
                                    : neg_inf();
#pragma unroll
          for (int u = 0; u < 8; ++u) mm = fmaxf(mm, mk[u]);
        }
        float ls = 0.f, av[V];
#pragma unroll
        for (int i = 0; i < V; ++i) av[i] = 0.f;
        for (int k0 = 0; k0 < nsplit; k0 += 4) {
          float mk[4], lk[4], ak[4][V];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool in = k0 + u < nsplit;
            const size_t k = in ? k0 + u : 0;
            mk[u] = in ? __ldcg(ml0 + k * a.hp * 2 + h * 2) : neg_inf();
            lk[u] = __ldcg(ml0 + k * a.hp * 2 + h * 2 + 1);
            const float4* src =
                reinterpret_cast<const float4*>(acc0 + (k * a.hp + h) * a.hdp + ch * V);
#pragma unroll
            for (int i = 0; i < V / 4; ++i) {
              const float4 f = __ldcg(src + i);
              ak[u][4 * i] = f.x;
              ak[u][4 * i + 1] = f.y;
              ak[u][4 * i + 2] = f.z;
              ak[u][4 * i + 3] = f.w;
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float wt = weight(mk[u], mm);
            ls += lk[u] * wt;
#pragma unroll
            for (int i = 0; i < V; ++i) av[i] += ak[u][i] * wt;
          }
        }
#pragma unroll
        for (int i = 0; i < V; ++i) av[i] /= ls;
        store_chunk<T>(out + ((size_t)b * a.H + h0 + h) * a.hd, ch * V, a.hd, av);
      }
      if (tid == 0) a.tickets[pair] = 0;
    }
    consumers_sync();  // the flag and the reduction buffers are reused
  }
}

// the narrow mode: head dims and pages up to 256
template <typename T, int HP, int DP, bool kTma>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const Args a) {
  decode<T, HP, DP, kTma, false>(tk, tv, a);
}

// the wide mode: head dims or pages past 256 (column split, units of boxes)
// (one block an SM at least: ptxas then keeps every instantiation's
// registers without spills)
template <typename T, int HP, int DP, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    paged_decode_wide_kernel(const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const Args a) {
  decode<T, HP, DP, kTma, true>(tk, tv, a);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, float>::value    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// a 4-D map over (hd, Hk, bs, nb) of a pool [nb, bs, Hk, hd], boxes of one
// KV head's `rows` rows of one page, `pitch` columns wide (columns past hd,
// and rows past bs, read as zeros)
template <typename T>
static int pool_map(CUtensorMap* map, const void* pool, int nb, int bs, int Hk, int hd, int rows,
                    int pitch) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTmaError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)Hk, (cuuint64_t)bs, (cuuint64_t)nb};
  const cuuint64_t row = (cuuint64_t)hd * sizeof(T);
  const cuuint64_t strides[3] = {row, row * Hk, row * Hk * bs};
  const cuuint32_t box[4] = {(cuuint32_t)pitch, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, map_type<T>(), 4, const_cast<void*>(pool), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTmaError + (int)r;
}

template <typename T, int HP, int DP, bool kTma, bool kWide>
static int launch(const void* pages_k, const void* pages_v, int nb, const Args& a,
                  cudaStream_t stream) {
  CUtensorMap mk{}, mv{};  // no map where the rows are not 16-byte multiples: the warp copies
  if (kTma) {
    if (int e = pool_map<T>(&mk, pages_k, nb, a.bs, a.Hk, a.hd, a.rows, a.pitch)) return e;
    if (int e = pool_map<T>(&mv, pages_v, nb, a.bs, a.Hk, a.hd, a.rows, a.pitch)) return e;
  }
  const int smem = Layout(a, sizeof(T)).total + 128;
  void (*kernel)(CUtensorMap, CUtensorMap, Args);
  if constexpr (kWide) {
    kernel = paged_decode_wide_kernel<T, HP, DP, kTma>;
  } else {
    kernel = paged_decode_kernel<T, HP, DP, kTma>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<a.grid, kThreads, smem, stream>>>(mk, mv, a);
  return (int)cudaGetLastError();
}

// DP: the narrow mode's head dim, or the wide mode's slice, rounded up
template <typename T, bool kTma, bool kWide>
static int dispatch(const void* pk, const void* pv, int nb, const Args& a, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    switch (a.hp) {
      case 1: return launch<T, 1, 0, kTma, kWide>(pk, pv, nb, a, s);
      case 2: return launch<T, 2, 0, kTma, kWide>(pk, pv, nb, a, s);
      case 4: return launch<T, 4, 0, kTma, kWide>(pk, pv, nb, a, s);
      case 8: return launch<T, 8, 0, kTma, kWide>(pk, pv, nb, a, s);
    }
  } else {
    const int cols = kWide ? a.wc : a.hd;
    if (cols <= 64) return launch<T, 0, 64, kTma, kWide>(pk, pv, nb, a, s);
    if (cols <= 128) return launch<T, 0, 128, kTma, kWide>(pk, pv, nb, a, s);
    return launch<T, 0, 256, kTma, kWide>(pk, pv, nb, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool kWide>
static int dispatch(const void* pk, const void* pv, int nb, const Args& a, cudaStream_t s) {
  return a.tma ? dispatch<T, true, kWide>(pk, pv, nb, a, s)
               : dispatch<T, false, kWide>(pk, pv, nb, a, s);
}

// the mode of a call's dtype (0 f32, 1 bf16, 2 fp16); the build may compile
// the two modes apart (ops/_build.py PARTS: -DKERNEL_PART=0 the interface and
// the narrow kernels, 1 the wide ones)
int dispatch_wide(const void* pk, const void* pv, int nb, const Args& a, int dtype,
                  cudaStream_t s);

#if !defined(KERNEL_PART) || KERNEL_PART == 1
int dispatch_wide(const void* pk, const void* pv, int nb, const Args& a, int dtype,
                  cudaStream_t s) {
  if (dtype == 1) return dispatch<__nv_bfloat16, true>(pk, pv, nb, a, s);
  if (dtype == 2) return dispatch<__half, true>(pk, pv, nb, a, s);
  if (dtype == 0) return dispatch<float, true>(pk, pv, nb, a, s);
  return (int)cudaErrorInvalidValue;
}
#endif

// narrow: rows of a box (the largest divisor of bs within kBoxBytes, so a
// box never reaches past its page), its pitch and the stages of the ring;
// TMA only where a pool row is a multiple of 16 bytes (its strides must
// be). Wide: the slice, its pitch, boxes of whole 16-row groups (f32: 8)
// within kBoxBytes a slice, at least one group and at most a page (a box
// may reach past the page's end), ceil(bs / rows) units a page, and at
// least two stages however large.
inline void geometry(Args* a, int es) {
  a->hdp = (a->hd + 7) / 8 * 8;
  a->tma = a->hd * es % 16 == 0;
  if (a->hd > kNarrow || a->bs > kNarrow) {
    a->wc = ((a->hd + kSlices - 1) / kSlices + 7) / 8 * 8;
    a->pitch = a->tma && a->wc + 8 > 256 ? a->wc : a->wc + 8;
    const int group = es == 2 ? 16 : 8;
    const int fit = kBoxBytes / (kSlices * a->pitch * es) / group * group;
    a->rows = fit > group ? fit : group;
    if (a->rows > a->bs) a->rows = a->bs;
    a->upp = (a->bs + a->rows - 1) / a->rows;
  } else {
    a->wc = 0;
    a->upp = 1;
    a->pitch = !a->tma ? a->hdp + 8 : a->hd + 8 <= 256 ? a->hd + 8 : a->hd;
    const int most = kBoxBytes / (a->pitch * es) > 0 ? kBoxBytes / (a->pitch * es) : 1;
    int r = 1;
    for (int d = 1; d <= a->bs && d <= most; ++d)
      if (a->bs % d == 0) r = d;
    a->rows = r;
  }
  a->stages = 2;  // Layout's box does not depend on the stages
  const int s = kRingBytes / Layout(*a, es).stage;
  a->stages = s < 2 ? 2 : (s > kMaxStages ? kMaxStages : s);
}

}  // namespace paged

#if !defined(KERNEL_PART) || KERNEL_PART == 0
// The interface version: kernel_ab tells this source from the earlier
// ones by it (1: two kernels, a decode then a merge; 2: Kc found on the
// device from the lengths; 3: Kc passed from the shapes).
extern "C" int paged_attention_abi() { return 3; }

namespace paged {
// the arguments of a call, the pointers aside
inline Args shape(int lanes, int H, int Hk, int hd, int bs, int MB, int grid, int hp, int es) {
  Args a{};
  a.lanes = lanes;
  a.H = H;
  a.Hk = Hk;
  a.hd = hd;
  a.bs = bs;
  a.MB = MB;
  a.grid = grid;
  a.hp = hp;
  a.npass = (H / Hk + hp - 1) / hp;
  geometry(&a, es);
  int T = 1;  // f32: lanes a row takes, two 16-byte chunks each
  while (T * 2 < (hd + 3) / 4) T <<= 1;
  a.T = T;
  return a;
}
}  // namespace paged

// Dynamic shared memory of one block, in bytes.
extern "C" int paged_attention_smem(int lanes, int hd, int bs, int hp, int dtype) {
  const int es = dtype == 0 ? 4 : 2;
  return paged::Layout(paged::shape(lanes, hp, 1, hd, bs, 1, 1, hp, es), es).total + 128;
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. hp: the query heads a
// pass, 1, 2, 4 or 8; a GQA group of H / Hk heads takes passes = ceil(H /
// Hk / hp). kc: units a chunk (pages; wide: boxes of rows of a page), from
// the shapes alone. part: f32 scratch of lanes * Hk * passes * ceil(units a
// full lane / kc) * hp * (round_up(hd, 8) + 2) floats; tickets: int32
// [lanes * Hk * passes], zero
// before the first call (each call leaves them zero). The caller has
// checked shapes, dtypes and alignment: H % Hk == 0, hd <= 1024, any bs,
// every pointer 16-byte aligned. Head dims or pages past 256 run the wide
// mode. Returns the cudaError_t of the launch, or 10000
// + the CUresult of a refused tensor map (0 on success).
extern "C" int paged_decode_attention(const void* q, const void* pages_k, const void* pages_v,
                                      const void* block_table, const void* lengths, void* part,
                                      void* tickets, void* out, int lanes, int H, int Hk, int hd,
                                      int bs, int MB, int nb, int grid, int hp, int kc,
                                      float scale, int dtype, void* stream) {
  if (hp != 1 && hp != 2 && hp != 4 && hp != 8) return (int)cudaErrorInvalidValue;
  if (kc < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int es = dtype == 0 ? 4 : 2;
  paged::Args a = paged::shape(lanes, H, Hk, hd, bs, MB, grid, hp, es);
  a.q = q;
  a.out = out;
  a.pool_k = pages_k;
  a.pool_v = pages_v;
  a.table = static_cast<const int*>(block_table);
  a.lengths = static_cast<const int*>(lengths);
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<int*>(tickets);
  a.kc = kc;
  a.scale2 = scale * paged::kLog2e;
  if (a.wc > 0) return paged::dispatch_wide(pages_k, pages_v, nb, a, dtype, s);
  if (dtype == 1) return paged::dispatch<__nv_bfloat16, false>(pages_k, pages_v, nb, a, s);
  if (dtype == 2) return paged::dispatch<__half, false>(pages_k, pages_v, nb, a, s);
  if (dtype == 0) return paged::dispatch<float, false>(pages_k, pages_v, nb, a, s);
  return (int)cudaErrorInvalidValue;
}
#endif  // KERNEL_PART
