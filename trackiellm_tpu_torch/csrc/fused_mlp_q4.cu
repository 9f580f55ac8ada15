// One-launch Q4 decode MLP block for Hopper (sm_90a).
//
// Replaces trackiellm_tpu/ops/fused.py:fused_mlp_q4_pallas (its body is
// _fused_mlp_kernel), the route the JAX package takes under
// TRACKIE_FUSED_MLP=1 for M <= 8. Computes, for x (M, D) in bf16 or f32:
//   h2  = x * rsqrt(mean(x^2) + eps) * norm          (f32)
//   gu  = h2 @ W_gu                                   (M, 2H) f32
//   act = silu(gu[:, :H]) * gu[:, H:]                 (f32, never rounded)
//   out = (x + act @ W_down) cast to x's dtype once
// with W_gu Q4 (D/2, 2H) u8 + (D/G, 2H) f32 scales and W_down Q4 (H/2, D) u8
// + (H/G, D) f32 scales in the layout of q4_w4a8.cu (packed across the K
// halves). As in _q4_dot, each group's dot x . q runs in f32 and is folded
// once per group and column: acc += dot_lo * s_lo + dot_hi * s_hi, in group
// order.
//
// What bounds it on the H100: at M <= 8 every weight byte feeds at most 2M
// multiply-adds, so bytes bound it: 88.1 MB of packed W_gu and W_down and
// 2.8 MB of scales for one Mistral-7B layer (D 4096, H 14336, G 256), 90.8 MB
// in all, 0.0271 ms at 3.35 TB/s. At M = 8 with f32 x the f32 FMAs come
// close: 2.82 GFLOP, 0.042 ms at 67 TFLOP/s.
//
// Design: one block on each SM (a cooperative launch; the shared memory
// asks for more than half an SM, so no SM gets two), in two phases with one
// grid barrier between them. The shape depends on M rounded up to KM rows
// (1, 2, 4, 8; the table above Cfg): 512 threads (256 at KM = 8), 4 or 2
// columns a thread.
//   Phase A (gate/up): the hidden pairs (j, j + H/2) are cut into tiles of
//   TP (128 at KM <= 2, 64 at 4, 32 at 8), each with its four TP-byte row
//   segments of W_gu (gate-lo, gate-hi, up-lo, up-hi), and each tile's D/2
//   packed rows into chunks of 16 or 32. The (tile, chunk) units, in
//   tile-major order, are split evenly over the blocks as contiguous ranges,
//   so every SM streams the same bytes, within one chunk. A block first
//   normalises all of x into shared memory (f32 h2, KM x D), then streams
//   its units through an 8-stage cp.async ring of 4-8 KB chunks (16-byte
//   copies, neighbouring threads on neighbouring 16 bytes of a row; 28-56
//   KB of weights in flight per SM) with the group's scale rows riding in
//   the stage where the group folds. Each thread owns 4 (or 2) neighbouring
//   columns of the tile over 4 (or 8) rows of each chunk; the nibbles widen
//   with q4_unpack4 (common.cuh). At a tile's end the row subsets' sums add
//   in subset order, and silu(gate) * up goes to an (H/2, 2, KM) f32
//   scratch that stays in L2.
//   Phase B (down + residual): the output columns are cut into slices of
//   128 (64 at KM = 8) and W_down's H/2 packed rows into chunks of 64, split
//   over the blocks the same way, through the same kind of ring, with the
//   chunk's act rows copied from L2 beside the weights. The block that
//   holds a slice's first chunk adds the residual and casts.
// A tile or slice whose units fall to two or more blocks is summed by its
// first block: the others write their (KM, 4 TP) or (KM, NB) partial, one
// per block at most, and raise a flag; the first block waits for the flags
// (all blocks are resident), adds the partials in block order (that is,
// chunk order) on all its threads, and clears the flags for the next
// launch. Every sum therefore has a fixed order and the result does not
// depend on scheduling. The partials take 2.5 KB x KM a block at most
// (0.8 MB at M = 8 on 132 SMs); no 224-way (M, D) partial is left.
//
// Measured (tools/kernel_times.py, device only, bf16 x, Mistral-7B shapes,
// NVIDIA H100 80GB HBM3, 700.00 W): M = 1 0.0757 ms (2.8x the bound; the
// one-byte-a-thread kernel this replaced took 0.43), M = 4 0.111, M = 8
// 0.176. At M = 1 the widening (a byte permute and a subtract a weight)
// and the FMAs take about as many instruction slots as the bytes take to
// arrive; at M = 8 the f32 FMAs run at a quarter of their peak. More
// threads, 4 to 12 stages and wider tiles did not move M = 8.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStages = 8;
constexpr int kMaxM = 8;
constexpr int kKB = 64;          // packed W_down rows a phase-B chunk
// Dynamic shared memory a block may ask for: Hopper's 232,448 bytes less
// room for the kernel's static shared memory.
constexpr int kMaxSmem = 232448 - 1024;
// At least this much dynamic shared memory, so that no SM holds two blocks.
constexpr int kMinSmem = 120 * 1024;

// The shape of a block for KM rows (1, 2, 4 or 8), chosen so that a
// block's partials stay 2.5 KB x KM at most:
//   NT  threads: 512, or 256 at KM = 8, whose 3 x 8 x 4 accumulators a
//       thread need more than 512 threads' 128 registers (spilling, or
//       splitting the rows over two thread groups, measured slower);
//   TP  hidden pairs a phase-A tile: the four row segments of W_gu
//       (gate-lo, gate-hi, up-lo, up-hi) are TP bytes each, a whole
//       128-byte line where the partials allow it (KM <= 2);
//   KA  packed W_gu rows a phase-A chunk (8 KB, or 4 KB where h2 is large);
//   NB  output columns a phase-B slice (chunks of 64 W_down rows);
//   CPT columns a thread: 4, or 2 at KM = 4 so that 512 threads fit.
// Each thread multiplies 4 or 8 rows of CPT columns of every chunk.
__host__ __device__ constexpr int threads_for(int km) {
  return km == 8 ? 256 : 512;
}
__host__ __device__ constexpr int tile_pairs(int km) {
  return km <= 2 ? 128 : km == 4 ? 64 : 32;
}
__host__ __device__ constexpr int chunk_rows_a(int km) {
  return km <= 2 ? 16 : 32;
}
__host__ __device__ constexpr int slice_cols(int km) {
  return km <= 4 ? 128 : 64;
}
__host__ __device__ constexpr int cols_a_thread(int km) {
  return km == 4 ? 2 : 4;
}

template <int KM>
struct Cfg {
  static constexpr int NT = threads_for(KM);
  static constexpr int kWarps = NT / 32;
  static constexpr int TP = tile_pairs(KM);
  static constexpr int RB = 4 * TP;          // bytes of a tile's W_gu row
  static constexpr int KA = chunk_rows_a(KM);
  static constexpr int NB = slice_cols(KM);
  static constexpr int CPT = cols_a_thread(KM);
  static constexpr int kRowA = RB / CPT;     // threads on a W_gu row
  static constexpr int kSubA = NT / kRowA;   // row subsets of a chunk
  static constexpr int kRptA = KA / kSubA;
  static constexpr int kRowB = NB / CPT;
  static constexpr int kSubB = NT / kRowB;
  static constexpr int kRptB = kKB / kSubB;
  static constexpr int kStageA = KA * RB + 2 * RB * 4;
  static_assert(kRowA >= 32 && kRptA * kSubA == KA &&
                kRptB * kSubB == kKB, "whole warps on a row, whole rows");
};

struct Layout {
  int h2, stage_b, region0, red, total;
};

__host__ __device__ inline int max_int(int a, int b) { return a > b ? a : b; }

// Dynamic shared memory for KM rows and width D: phase A holds h2 and its
// ring, phase B its ring over the same bytes; then the row subsets' sums
// and the block's (KM, max(4 TP, NB)) tile.
__host__ __device__ inline Layout layout(int km, int d) {
  const int rb = 4 * tile_pairs(km), nb = slice_cols(km);
  Layout l;
  l.h2 = d * km * 4;
  const int stage_a = chunk_rows_a(km) * rb + 2 * rb * 4;
  l.stage_b = kKB * nb + kKB * 2 * km * 4 + 2 * nb * 4;
  l.region0 = max_int(l.h2 + kStages * stage_a, kStages * l.stage_b);
  l.red = threads_for(km) * cols_a_thread(km) * km * 4;
  l.total = max_int(l.region0 + l.red + km * max_int(rb, nb) * 4, kMinSmem);
  return l;
}

struct Args {
  const void* x;
  const void* norm;
  const uint8_t* gu;
  const float* gu_scales;
  const uint8_t* down;
  const float* down_scales;
  float* act;        // (H/2, 2, KM): hidden j at (j, 0), H/2 + j at (j, 1)
  float* part_a;     // (blocks, KM, 4 TP)
  float* part_b;     // (blocks, KM, NB)
  unsigned* flags;   // 2 x blocks, zero between launches
  void* out;
  int M, D, H, G;
  float eps;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The first unit of block b: the units are split into nb contiguous ranges
// whose sizes differ by one at most.
__device__ __forceinline__ int unit_begin(int units, int b, int nb) {
  return (int)((long long)units * b / nb);
}

// Whether block bb, after the owner of a tile or slice that ends at unit
// `end`, holds part of it: its range is not empty and starts before `end`.
// Returns -1 past the last such block.
__device__ __forceinline__ int contributes(int units, int end, int bb,
                                           int nb) {
  if (bb >= nb) return -1;
  const int s0 = unit_begin(units, bb, nb);
  if (s0 >= end) return -1;
  return unit_begin(units, bb + 1, nb) > s0;
}

// A walk over units in order, with each unit's tile (or slice), its chunk
// in the tile and its chunk in the scale group, kept without divisions.
struct Walk {
  int u, tile, c, g;
  __device__ Walk(int u0, int chunks, int gchunks)
      : u(u0), tile(u0 / chunks), c(u0 % chunks), g(u0 % chunks % gchunks) {}
  __device__ void next(int chunks, int gchunks) {
    ++u;
    if (++g == gchunks) g = 0;
    if (++c == chunks) c = 0, ++tile;
  }
  // The group's scale rows fold after this unit.
  __device__ bool folds(int gchunks, int end) const {
    return g == gchunks - 1 || u == end - 1;
  }
  __device__ bool ends_tile(int chunks, int end) const {
    return c == chunks - 1 || u == end - 1;
  }
};

template <int KM>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[KM]) {
  if constexpr (KM % 4 == 0) {
#pragma unroll
    for (int m = 0; m < KM; m += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + m);
      v[m] = f.x; v[m + 1] = f.y; v[m + 2] = f.z; v[m + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < KM; ++m) v[m] = p[m];
  }
}

// The sums of this block's part of a tile (phase A, width 4 TP) or slice
// (phase B, width NB), rows subs x KM x W in sRed, are added in row subset
// order. A block that does not own the tile writes them to its partial and
// raises its flag; the owner adds the later blocks' partials in block order
// and hands the (KM, W) sums to `emit`.
template <int NT, int KM, int W, typename Emit>
__device__ void finish(const float* sRed, int subs, float* sTile,
                       bool owner, int end, int units, float* part,
                       unsigned* flags, Emit emit) {
  const int tid = threadIdx.x, b = blockIdx.x, nb = gridDim.x;
  __syncthreads();
  for (int i = tid; i < KM * W; i += NT) {
    float v = 0.f;
    for (int s = 0; s < subs; ++s) v += sRed[s * KM * W + i];
    if (owner)
      sTile[i] = v;
    else
      part[(size_t)b * KM * W + i] = v;
  }
  if (!owner) {
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicExch(flags + b, 1u);
    return;
  }
  if (tid == 0) {
    for (int bb = b + 1, c; (c = contributes(units, end, bb, nb)) >= 0; ++bb)
      if (c) {
        while (ld_acquire(flags + bb) == 0) {
        }
        flags[bb] = 0;   // ready for the next launch
      }
    __threadfence();
  }
  __syncthreads();
  for (int i = tid; i < KM * W; i += NT) {
    float v = sTile[i];
    for (int bb = b + 1, c; (c = contributes(units, end, bb, nb)) >= 0; ++bb)
      if (c) v += __ldcg(part + (size_t)bb * KM * W + i);
    sTile[i] = v;
  }
  __syncthreads();
  emit(sTile);
  __syncthreads();
}

// Eight consecutive activations from 16-byte aligned p, as floats.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // a bf16 is the high half of its float
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
  }
}

// The CPT bytes (4 or 2) at p, as the low bytes of a word.
template <int CPT>
__device__ __forceinline__ uint32_t load_bytes(const unsigned char* p) {
  if constexpr (CPT == 4)
    return *reinterpret_cast<const uint32_t*>(p);
  else
    return *reinterpret_cast<const uint16_t*>(p);
}

// acc += x . w over the CPT columns of one packed row: lo nibbles against
// the row's K-low activations, hi nibbles against its K-high ones.
template <int KM, int CPT>
__device__ __forceinline__ void fma_row(uint32_t word, const float* xlo,
                                        const float* xhi,
                                        float (&acc_lo)[KM][CPT],
                                        float (&acc_hi)[KM][CPT]) {
  float wl[4], wh[4], hl[KM], hh[KM];
  q4_unpack4(word, wl, wh);
  load_rows<KM>(xlo, hl);
  load_rows<KM>(xhi, hh);
#pragma unroll
  for (int m = 0; m < KM; ++m)
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      acc_lo[m][e] = fmaf(hl[m], wl[e], acc_lo[m][e]);
      acc_hi[m][e] = fmaf(hh[m], wh[e], acc_hi[m][e]);
    }
}

// tot += acc_lo * s_lo + acc_hi * s_hi per column, then acc = 0.
template <int KM, int CPT>
__device__ __forceinline__ void fold(const float* s_lo, const float* s_hi,
                                     float (&acc_lo)[KM][CPT],
                                     float (&acc_hi)[KM][CPT],
                                     float (&tot)[KM][CPT]) {
  float sl[CPT], sh[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) sl[e] = s_lo[e], sh[e] = s_hi[e];
#pragma unroll
  for (int m = 0; m < KM; ++m)
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      tot[m][e] += acc_lo[m][e] * sl[e] + acc_hi[m][e] * sh[e];
      acc_lo[m][e] = acc_hi[m][e] = 0.f;
    }
}

// sRed[(sub * KM + m) * W + col + e] = tot[m][e], then tot = 0.
template <int KM, int CPT>
__device__ __forceinline__ void stash(float* sRed, int sub, int W, int col,
                                      float (&tot)[KM][CPT]) {
#pragma unroll
  for (int m = 0; m < KM; ++m)
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      sRed[(sub * KM + m) * W + col + e] = tot[m][e];
      tot[m][e] = 0.f;
    }
}

template <typename TX, typename TN, int KM>
__global__ void __launch_bounds__(Cfg<KM>::NT, 1)
    fused_mlp_q4_kernel(const Args a) {
  using C = Cfg<KM>;
  constexpr int NT = C::NT, TP = C::TP, RB = C::RB, CPT = C::CPT;
  constexpr int kNB = C::NB;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sSum[C::kWarps][KM];
  __shared__ float sInv[KM];

  const int M = a.M, D = a.D, H = a.H, G = a.G;
  const int half_d = D / 2, half_h = H / 2, two_h = 2 * H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x, nb = gridDim.x;
  const Layout L = layout(KM, D);
  float* sH = reinterpret_cast<float*>(smem);            // (D/2, 2, KM)
  unsigned char* ringA = smem + L.h2;
  unsigned char* ringB = smem;
  float* sRed = reinterpret_cast<float*>(smem + L.region0);
  float* sTile = sRed + L.red / 4;
  const TX* x = static_cast<const TX*>(a.x);
  const TN* norm = static_cast<const TN*>(a.norm);

  // ---- phase A plan and loader ------------------------------------------
  const int chunks_a = half_d / C::KA;
  const int gchunks_a = G / C::KA;               // chunks a scale group
  const int ngh = half_d / G;                    // W_gu scale rows a half
  const int units_a = (half_h / TP) * chunks_a;
  const int a0 = unit_begin(units_a, b, nb);
  const int a1 = unit_begin(units_a, b + 1, nb);
  // Column of segment seg (gate-lo, gate-hi, up-lo, up-hi) of pair p0.
  auto seg_col = [&](int seg, int p0) {
    return (seg & 1) * half_h + (seg >> 1) * H + p0;
  };
  auto load_a = [&](const Walk& w, int slot) {
    unsigned char* st = ringA + slot * C::kStageA;
    const int p0 = w.tile * TP, r0 = w.c * C::KA;
    for (int k = tid; k < C::KA * RB / 16; k += NT) {
      const int row = k / (RB / 16), piece = k % (RB / 16);
      const int seg = piece / (TP / 16), within = piece % (TP / 16);
      cp_async16(st + row * RB + piece * 16,
                 a.gu + (size_t)(r0 + row) * two_h + seg_col(seg, p0) +
                     16 * within);
    }
    if (w.folds(gchunks_a, a1) && tid < 2 * TP) {
      const int hrow = tid / TP, piece = tid % TP;
      const int seg = piece / (TP / 4), within = piece % (TP / 4);
      const int srow = (hrow ? ngh : 0) + r0 / G;
      cp_async16(st + C::KA * RB + hrow * RB * 4 + piece * 16,
                 a.gu_scales + (size_t)srow * two_h + seg_col(seg, p0) +
                     4 * within);
    }
  };

  Walk la(a0, chunks_a, gchunks_a);
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (la.u < a1) {
      load_a(la, s);
      la.next(chunks_a, gchunks_a);
    }
    cp_async_commit();
  }

  // ---- h2 = x * rsqrt(mean(x^2) + eps) * norm, into shared memory --------
  {
    float ss[KM];
#pragma unroll
    for (int m = 0; m < KM; ++m) ss[m] = 0.f;
    for (int c = tid; c < D / 8; c += NT) {
#pragma unroll
      for (int m = 0; m < KM; ++m)
        if (m < M) {
          float v[8];
          load8(x + (size_t)m * D + 8 * c, v);
#pragma unroll
          for (int i = 0; i < 8; ++i) ss[m] += v[i] * v[i];
        }
    }
#pragma unroll
    for (int m = 0; m < KM; ++m) {
      float v = ss[m];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) sSum[warp][m] = v;
    }
    __syncthreads();
    if (tid < KM) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < C::kWarps; ++w) total += sSum[w][tid];
      sInv[tid] = 1.f / sqrtf(total / static_cast<float>(D) + a.eps);
    }
    __syncthreads();
#pragma unroll 4
    for (int p = tid; p < half_d; p += NT) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = half * half_d + p;
        const float nv = to_f32(__ldg(norm + d));
        float* dst = sH + ((size_t)p * 2 + half) * KM;
#pragma unroll
        for (int m = 0; m < KM; ++m)
          dst[m] = m < M ? to_f32(__ldg(x + (size_t)m * D + d)) * sInv[m] * nv
                         : 0.f;
      }
    }
  }

  // ---- phase A: gate and up, silu(gate) * up into act --------------------
  float acc_lo[KM][CPT], acc_hi[KM][CPT], tot[KM][CPT];
#pragma unroll
  for (int m = 0; m < KM; ++m)
#pragma unroll
    for (int e = 0; e < CPT; ++e)
      acc_lo[m][e] = acc_hi[m][e] = tot[m][e] = 0.f;

  const int col_a = tid % C::kRowA * CPT, sub_a = tid / C::kRowA;
  int slot = 0, load_slot = kStages - 1;
#pragma unroll 1
  for (Walk w(a0, chunks_a, gchunks_a); w.u < a1;
       w.next(chunks_a, gchunks_a)) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (la.u < a1) {
      load_a(la, load_slot);
      la.next(chunks_a, gchunks_a);
    }
    cp_async_commit();
    if (++load_slot == kStages) load_slot = 0;
    const unsigned char* st = ringA + slot * C::kStageA;
    if (++slot == kStages) slot = 0;
    const float* h = sH + (size_t)w.c * C::KA * 2 * KM;
#pragma unroll
    for (int j = 0; j < C::kRptA; ++j) {
      const int row = sub_a + j * C::kSubA;
      fma_row<KM, CPT>(load_bytes<CPT>(st + row * RB + col_a),
                       h + row * 2 * KM, h + row * 2 * KM + KM, acc_lo,
                       acc_hi);
    }
    if (w.folds(gchunks_a, a1)) {
      const float* sc = reinterpret_cast<const float*>(st + C::KA * RB);
      fold<KM, CPT>(sc + col_a, sc + RB + col_a, acc_lo, acc_hi, tot);
    }
    if (w.ends_tile(chunks_a, a1)) {
      stash<KM, CPT>(sRed, sub_a, RB, col_a, tot);
      // silu(gate) * up for the tile's 2 TP hidden units: column j < 2 TP
      // is gate-lo, then gate-hi; column 2 TP + j the matching up.
      const int tile = w.tile, start = tile * chunks_a;
      finish<NT, KM, RB>(
          sRed, C::kSubA, sTile, start >= a0, start + chunks_a, units_a,
          a.part_a, a.flags, [&](const float* g) {
            for (int k = tid; k < 2 * TP * KM; k += NT) {
              const int j = k % (2 * TP), m = k / (2 * TP);
              const float gate = g[m * RB + j];
              const float up = g[m * RB + 2 * TP + j];
              const float v =
                  m < M ? gate * (1.f / (1.f + expf(-gate))) * up : 0.f;
              const int p = tile * TP + j % TP;
              a.act[((size_t)p * 2 + j / TP) * KM + m] = v;
            }
          });
    }
  }
  cp_async_wait<0>();

  // Every act row is written.
  __threadfence();
  cg::this_grid().sync();

  // ---- phase B plan and loader ------------------------------------------
  const int chunks_b = half_h / kKB;
  const int gchunks_b = G / kKB;
  const int units_b = (D / kNB) * chunks_b;
  const int b0 = unit_begin(units_b, b, nb);
  const int b1 = unit_begin(units_b, b + 1, nb);
  constexpr int kActBytes = kKB * 2 * KM * 4;
  auto load_b = [&](const Walk& w, int slot) {
    unsigned char* st = ringB + slot * L.stage_b;
    const int n0 = w.tile * kNB, p0 = w.c * kKB;
    for (int k = tid; k < kKB * kNB / 16; k += NT) {
      const int row = k / (kNB / 16), piece = k % (kNB / 16);
      cp_async16(st + row * kNB + piece * 16,
                 a.down + (size_t)(p0 + row) * D + n0 + 16 * piece);
    }
    const unsigned char* act =
        reinterpret_cast<const unsigned char*>(a.act + (size_t)p0 * 2 * KM);
    for (int k = tid; k < kActBytes / 16; k += NT)
      cp_async16(st + kKB * kNB + k * 16, act + k * 16);
    if (w.folds(gchunks_b, b1) && tid < kNB / 2) {
      const int hrow = tid / (kNB / 4), piece = tid % (kNB / 4);
      const int srow = (hrow ? half_h / G : 0) + p0 / G;
      cp_async16(st + kKB * kNB + kActBytes + hrow * kNB * 4 + piece * 16,
                 a.down_scales + (size_t)srow * D + n0 + 4 * piece);
    }
  };

  Walk lb(b0, chunks_b, gchunks_b);
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (lb.u < b1) {
      load_b(lb, s);
      lb.next(chunks_b, gchunks_b);
    }
    cp_async_commit();
  }

  // ---- phase B: act @ W_down, residual, one cast --------------------------
  TX* out = static_cast<TX*>(a.out);
  const int col_b = tid % C::kRowB * CPT, sub_b = tid / C::kRowB;
  slot = 0;
  load_slot = kStages - 1;
#pragma unroll 1
  for (Walk w(b0, chunks_b, gchunks_b); w.u < b1;
       w.next(chunks_b, gchunks_b)) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (lb.u < b1) {
      load_b(lb, load_slot);
      lb.next(chunks_b, gchunks_b);
    }
    cp_async_commit();
    if (++load_slot == kStages) load_slot = 0;
    const unsigned char* st = ringB + slot * L.stage_b;
    if (++slot == kStages) slot = 0;
    const float* sAct = reinterpret_cast<const float*>(st + kKB * kNB);
#pragma unroll
    for (int j = 0; j < C::kRptB; ++j) {
      const int row = sub_b + j * C::kSubB;
      fma_row<KM, CPT>(load_bytes<CPT>(st + row * kNB + col_b),
                       sAct + row * 2 * KM, sAct + row * 2 * KM + KM, acc_lo,
                       acc_hi);
    }
    if (w.folds(gchunks_b, b1)) {
      const float* sc =
          reinterpret_cast<const float*>(st + kKB * kNB + kActBytes);
      fold<KM, CPT>(sc + col_b, sc + kNB + col_b, acc_lo, acc_hi, tot);
    }
    if (w.ends_tile(chunks_b, b1)) {
      stash<KM, CPT>(sRed, sub_b, kNB, col_b, tot);
      // The residual and the one cast.
      const int n0 = w.tile * kNB, start = w.tile * chunks_b;
      finish<NT, KM, kNB>(
          sRed, C::kSubB, sTile, start >= b0, start + chunks_b, units_b,
          a.part_b, a.flags + nb, [&](const float* v) {
            for (int k = tid; k < M * kNB; k += NT) {
              const size_t o = (size_t)(k / kNB) * D + n0 + k % kNB;
              store(out + o, to_f32(x[o]) + v[k]);
            }
          });
    }
  }
  cp_async_wait<0>();
}

template <typename TX, typename TN, int KM>
int launch(Args a, int blocks, cudaStream_t stream) {
  using C = Cfg<KM>;
  auto kernel = fused_mlp_q4_kernel<TX, TN, KM>;
  static unsigned long long raised = 0;
  int err = raise_smem_cap(kernel, kMaxSmem, raised);
  if (err) return err;
  const int smem = layout(KM, a.D).total;
  if (smem > kMaxSmem || a.D % C::NB || (a.D / 2) % C::KA || a.G % C::KA ||
      (a.H / 2) % C::TP)
    return -1;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::NT,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // The grid barrier and the flags need every block resident at once.
  if (blocks > per_sm * sms) return -1;
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      (void*)kernel, dim3(blocks), dim3(C::NT), args, smem, stream));
}

template <typename TX, typename TN>
int launch_rows(const Args& a, int blocks, cudaStream_t s) {
  if (a.M == 1) return launch<TX, TN, 1>(a, blocks, s);
  if (a.M == 2) return launch<TX, TN, 2>(a, blocks, s);
  if (a.M <= 4) return launch<TX, TN, 4>(a, blocks, s);
  return launch<TX, TN, 8>(a, blocks, s);
}

}  // namespace

// x (M, D) and out (M, D) share x_dtype, norm (D,) has norm_dtype (0 = f32,
// 1 = bf16); gu (D/2, 2H) u8 + gu_scales (D/G, 2H) f32; down (H/2, D) u8 +
// down_scales (H/G, D) f32; scratch holds act (H * KM f32), then
// blocks * KM * 4 tile_pairs(KM) and blocks * KM * slice_cols(KM) f32
// partials, KM being M rounded up to 1, 2, 4 or 8; flags holds 2 * blocks
// zeros and is left zero. The weights and scales are 16-byte aligned.
// Returns a cudaError_t, or -1 for arguments the kernel does not take
// (including a grid that cannot be resident all at once).
extern "C" int trackie_fused_mlp_q4(const void* x, const void* norm,
                                    const void* gu, const void* gu_scales,
                                    const void* down, const void* down_scales,
                                    void* scratch, void* flags, void* out,
                                    int M, int D, int H, int G, int x_dtype,
                                    int norm_dtype, float eps, int blocks,
                                    void* stream) {
  if (M < 1 || M > kMaxM || D < 128 || H % 2 || (H / 2) % 128 || G < kKB ||
      G % kKB || (D / 2) % G || (H / 2) % G || blocks < 1)
    return -1;
  const int km = M == 1 ? 1 : M == 2 ? 2 : M <= 4 ? 4 : 8;
  Args a;
  a.x = x;
  a.norm = norm;
  a.gu = static_cast<const uint8_t*>(gu);
  a.gu_scales = static_cast<const float*>(gu_scales);
  a.down = static_cast<const uint8_t*>(down);
  a.down_scales = static_cast<const float*>(down_scales);
  a.act = static_cast<float*>(scratch);
  a.part_a = a.act + (size_t)H * km;
  a.part_b = a.part_a + (size_t)blocks * km * 4 * tile_pairs(km);
  a.flags = static_cast<unsigned*>(flags);
  a.out = out;
  a.M = M;
  a.D = D;
  a.H = H;
  a.G = G;
  a.eps = eps;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && norm_dtype == 0)
    return launch_rows<float, float>(a, blocks, s);
  if (x_dtype == 0 && norm_dtype == 1)
    return launch_rows<float, __nv_bfloat16>(a, blocks, s);
  if (x_dtype == 1 && norm_dtype == 0)
    return launch_rows<__nv_bfloat16, float>(a, blocks, s);
  if (x_dtype == 1 && norm_dtype == 1)
    return launch_rows<__nv_bfloat16, __nv_bfloat16>(a, blocks, s);
  return -1;
}
