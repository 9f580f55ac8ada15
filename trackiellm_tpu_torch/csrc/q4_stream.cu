// Q4 group-quantized matmul with the whole of K streamed per column tile, for
// Hopper (sm_90a).
//
// Replaces trackiellm_tpu/ops/quant.py:q4_matmul_pallas_v2 (its body is
// _q4_stream_kernel). Computes out (M, N) f32 = x (M, K) @ W (K, N), where x
// is f32 or bf16 and W is Q4 packed across the K halves (the layout
// q4_f32a.cu reads), with f32 group scales (K/G, N). The nibbles are
// unbiased as they are unpacked, as the TPU kernel does:
//   lo = (p & 0xF) - 8,   hi = ((p >> 4 & 0xF) ^ 8) - 8
// and per group g: acc += (x_lo . lo) * s_lo[g] + (x_hi . hi) * s_hi[g].
//
// What defines it, as on the TPU: no split-K. One block owns a column tile
// of tile_n columns and a tile of rows of x, and streams every packed row of
// its columns, tile_k rows a stage. Nothing is carried between blocks, so
// there is no partials buffer and no second kernel.
//
// What bounds it on the H100: at decode (M = 1 or 8) each packed byte feeds
// 2M multiply-adds, so the weight bytes bound it (the Mistral-7B w_gu
// projection is 58.7 MB of packed Q4 and 0.9 MB of scales, 0.0181 ms at
// 3.35 TB/s). What the design does about it:
//   - a deep ring fed by TMA, the counterpart of pltpu.make_async_copy and
//     its semaphores. One producer warp keeps up to `stages` stages in
//     flight (enough for 32 KiB of packed weights where shared memory
//     allows, ops/quant.py:_stream_plan). A stage holds a tile_k x tile_n
//     box of packed bytes (one TMA copy per box of at most 128 columns and
//     256 rows, swizzled by the box's width so that the reads below are free
//     of bank conflicts), the block's x rows for those packed rows, both K
//     halves (cp.async.bulk, one copy a row), and both scale rows of every
//     group the stage ends (one copy a row). A full and an empty mbarrier a
//     stage hand it between the producer and the consumer warps: no
//     __syncthreads in the loop, and no consumer thread issues a copy. x is
//     read from shared memory only.
//   - no conversion instructions. bf16 x (the model's) runs bf16
//     mma.sync m16n8k16 with f32 accumulation on 16-row tiles: ldmatrix.trans
//     reads packed byte pairs and widen_frag (common.cuh) widens each
//     register into the B fragments of two weights exactly, by a byte
//     permute under 0x43 and one bf16x2 FMA of -136, as q4_f32a.cu does. A
//     bf16 x times a Q4 weight is exact in f32, so the dots differ from the
//     plain version's only in the order of their f32 sums. f32 x keeps f32
//     products on the CUDA cores (the 1e-5 tolerance rules out rounding x
//     to bf16) on 1- or 8-row tiles; its nibbles are widened by a byte
//     permute that builds 2^23 + q + 8 in a float's bits and one FADD
//     (q4_unpack4).
//   - column tiles as wide as N allows: without split-K the grid is
//     N / tile_n blocks, and a TMA box is fetched one row of tile_n bytes at
//     a time, so narrow tiles fill the SMs and wide ones stream faster. The
//     default tile_n is the widest of 128 down to 16 that still gives every
//     SM a block (ops/quant.py:_stream_tile_n; 16 at N = 4096, from a sweep
//     in PERF.md).
//
// Warps: W consumer warps (4, or tile_n / 64 above 256 columns) and one
// producer warp. bf16: a 16-column segment of the tile is one pair of n8
// mma tiles (its even and odd columns); with at least W segments each warp
// owns tile_n / 16W of them over all of K, otherwise W / segments warps
// share a segment and take its 32-row units of each group in turn. f32:
// consumer thread t owns a 4-column word (t % (tile_n / 4)) and a slice of
// the rows (t / (tile_n / 4)). Each thread scales its per-group dots and
// adds them to its accumulator in group order; at the end the warps (bf16)
// or slices (f32) that shared a column are summed in a fixed order through
// shared memory, so a call gives the same bits every time.

#include <cuda.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxSmem = 232448 - 1024;  // an H100 block's opt-in cap
constexpr int kMaxStages = 32;           // 2 x 32 barriers in the first KiB
constexpr int kHead = 2048;              // alignment slack + barriers

struct StreamArgs {
  const void* x;
  const float* scales;
  float* out;
  int M, K, N, G, tile_k, box_rows, stages, rows_alloc;
};

template <int TN>
struct StreamTile {
  static constexpr int kSegs = TN / 16;
  static constexpr int kWarps = TN <= 256 ? 4 : TN / 64;  // consumers
  static constexpr int kThreads = (kWarps + 1) * 32;
  static constexpr int kBoxW = TN < 128 ? TN : 128;  // TMA box columns
  // bf16: segments a warp owns, warps that share a segment
  static constexpr int kSegsPerWarp = kSegs >= kWarps ? kSegs / kWarps : 1;
  static constexpr int kSplitK = kSegs >= kWarps ? 1 : kWarps / kSegs;
};

// Byte offset of 16-byte unit `seg` of packed row r in a stage: column box
// j = seg / (BW / 16) holds tile_k rows of BW bytes, and the TMA swizzle of
// width BW (CU_TENSOR_MAP_SWIZZLE_{32,64,128}B; none for 16) xors the unit's
// index within its row with address bits 7 and up.
template <int BW>
__device__ __forceinline__ int packed_off(int r, int seg, int tile_k) {
  constexpr int kUnits = BW / 16;
  const int j = seg / kUnits, c = seg % kUnits;
  return j * tile_k * BW + r * BW + 16 * (c ^ ((r * BW >> 7) & (kUnits - 1)));
}

// Barrier 1 among the first N threads (the consumer warps).
template <int N>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// ROWS: rows of x a block computes (16 for bf16; 1 or 8 for f32).
template <typename T, int TN, int ROWS>
__global__ void __launch_bounds__(StreamTile<TN>::kThreads)
    q4_stream_kernel(const __grid_constant__ CUtensorMap tmap, StreamArgs a) {
  using Tile = StreamTile<TN>;
  constexpr int BW = Tile::kBoxW;
  constexpr int CT = Tile::kWarps * 32;  // consumer threads
  extern __shared__ uint8_t smem_raw[];
  // 1 KiB alignment keeps every swizzled box on its pattern's period.
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t bars = smem_addr(base);  // full[s], then empty[s]
  uint8_t* ring = base + 1024;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = a.K / 2, ngh = half / a.G;
  const int n_chunks = half / a.tile_k;
  const int gps = a.tile_k / a.G;  // groups a stage ends
  const int col0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * ROWS;
  const int rv = min(ROWS, a.M - m0);  // rows of x this block has
  const int stages = a.stages;
  const int xld = a.tile_k * (int)sizeof(T) + 16;  // padded x row, bytes
  const int packed_bytes = a.tile_k * TN;
  const int x_bytes = 2 * a.rows_alloc * xld;
  uint8_t* pk_ring = ring;
  uint8_t* x_ring = pk_ring + stages * packed_bytes;
  uint8_t* sc_ring = x_ring + stages * x_bytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kMaxStages + s); };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), Tile::kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == Tile::kWarps) {
    // The producer: for each chunk, wait until its slot is free, announce
    // the bytes, then the lanes issue the copies in turn.
    const int n_box_r = a.tile_k / a.box_rows;
    const int n_boxes = (TN / BW) * n_box_r;
    const int n_items = n_boxes + 2 * rv + 2 * gps;
    const uint32_t tx = packed_bytes + 2 * rv * a.tile_k * (int)sizeof(T) +
                        2 * gps * TN * 4;
    const T* x = static_cast<const T*>(a.x);
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % stages;
      if (c >= stages) mbar_wait(empty(s), ((c / stages) - 1) & 1);
      if (lane == 0) mbar_arrive_expect_tx(full(s), tx);
      __syncwarp();
      const uint32_t pk = smem_addr(pk_ring + s * packed_bytes);
      const uint32_t xs = smem_addr(x_ring + s * x_bytes);
      const uint32_t sc = smem_addr(sc_ring + s * 2 * gps * TN * 4);
      for (int i = lane; i < n_items; i += 32) {
        if (i < n_boxes) {
          const int j = i / n_box_r, rb = i % n_box_r;
          tma_load_2d(pk + j * a.tile_k * BW + rb * a.box_rows * BW, &tmap,
                      col0 + j * BW, c * a.tile_k + rb * a.box_rows, full(s));
        } else if (i < n_boxes + 2 * rv) {
          const int h = (i - n_boxes) / rv, r = (i - n_boxes) % rv;
          bulk_load(xs + (h * a.rows_alloc + r) * xld,
                    x + (size_t)(m0 + r) * a.K + h * half + c * a.tile_k,
                    a.tile_k * sizeof(T), full(s));
        } else {
          const int q = i - n_boxes - 2 * rv;
          const int h = q / gps, gl = q % gps;
          bulk_load(sc + (h * gps + gl) * TN * 4,
                    a.scales + (size_t)(h * ngh + c * gps + gl) * a.N + col0,
                    TN * 4, full(s));
        }
      }
    }
    return;  // the consumers' closing barrier counts only them
  }

  // Consumers. At the end, red (stage memory, free by then) holds the
  // per-warp or per-slice sums.
  float* red = reinterpret_cast<float*>(ring);

  if constexpr (sizeof(T) == 2) {
    constexpr int SPW = Tile::kSegsPerWarp, KW = Tile::kSplitK;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int seg0 = KW == 1 ? warp * SPW : warp % Tile::kSegs;
    const int kq = KW == 1 ? 0 : warp / Tile::kSegs;
    const int ug = a.G / 32;  // 32-row units a group
    float acc[SPW][2][4], plo[SPW][2][4], phi[SPW][2][4];
#pragma unroll
    for (int i = 0; i < SPW; ++i)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][p][e] = plo[i][p][e] = phi[i][p][e] = 0.f;

    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % stages;
      mbar_wait(full(s), (c / stages) & 1);
      const uint8_t* pk = pk_ring + s * packed_bytes;
      const uint8_t* xs = x_ring + s * x_bytes;
      const float* sc =
          reinterpret_cast<const float*>(sc_ring + s * 2 * gps * TN * 4);
      for (int gl = 0; gl < gps; ++gl) {
        for (int u = gl * ug + kq; u < (gl + 1) * ug; u += KW) {
          // A: rows g and g + 8 of both halves at k 2t, 2t + 1 (+8) of each
          // k16 step; rows past this block's x are zero.
          uint32_t af[2][2][4];  // [half][k16 step]
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              const uint8_t* row = xs + h * a.rows_alloc * xld +
                                   (u * 32 + ks * 16 + 2 * t4) * 2;
              auto ld = [&](int r, int dk) -> uint32_t {
                return r < rv ? *reinterpret_cast<const uint32_t*>(
                                    row + r * xld + dk * 2)
                              : 0u;
              };
              af[h][ks][0] = ld(g8, 0);
              af[h][ks][1] = ld(g8 + 8, 0);
              af[h][ks][2] = ld(g8, 8);
              af[h][ks][3] = ld(g8 + 8, 8);
            }
#pragma unroll
          for (int i = 0; i < SPW; ++i) {
            // k rows 0-7, 8-15, 16-23, 24-31 of the unit, one 16-byte
            // segment: lane l gives the address of row l.
            uint32_t b[4];
            ldmatrix_x4_trans(
                b, pk + packed_off<BW>(u * 32 + lane, seg0 + i, a.tile_k));
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              uint32_t lo0[2], hi0[2], lo1[2], hi1[2];
              widen_frag(b[2 * ks], lo0, hi0);      // k 0-7 of the step
              widen_frag(b[2 * ks + 1], lo1, hi1);  // k 8-15
#pragma unroll
              for (int p = 0; p < 2; ++p) {         // even, odd columns
                mma_bf16(plo[i][p], af[0][ks], lo0[p], lo1[p]);
                mma_bf16(phi[i][p], af[1][ks], hi0[p], hi1[p]);
              }
            }
          }
        }
        // The group's dots times its scale rows, into the accumulator. A
        // thread owns columns 4t .. 4t + 3 of each segment.
#pragma unroll
        for (int i = 0; i < SPW; ++i) {
          const int col = (seg0 + i) * 16 + 4 * t4;
          const float4 sl =
              *reinterpret_cast<const float4*>(sc + gl * TN + col);
          const float4 sh =
              *reinterpret_cast<const float4*>(sc + (gps + gl) * TN + col);
          const float s_lo[4] = {sl.x, sl.y, sl.z, sl.w};
          const float s_hi[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int k = 2 * (e & 1) + p;
              acc[i][p][e] += plo[i][p][e] * s_lo[k];
              acc[i][p][e] += phi[i][p][e] * s_hi[k];
              plo[i][p][e] = phi[i][p][e] = 0.f;
            }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // d[p][e] is row g + 8 (e >> 1), column 4t + 2 (e & 1) + p of a segment.
    auto store_rows = [&](float (&v)[2][4], int seg) {
#pragma unroll
      for (int er = 0; er < 2; ++er) {
        const int m = m0 + g8 + 8 * er;
        if (m < a.M)
          *reinterpret_cast<float4*>(a.out + (size_t)m * a.N + col0 +
                                     seg * 16 + 4 * t4) =
              make_float4(v[0][2 * er], v[1][2 * er], v[0][2 * er + 1],
                          v[1][2 * er + 1]);
      }
    };
    if constexpr (KW == 1) {
#pragma unroll
      for (int i = 0; i < SPW; ++i) store_rows(acc[i], seg0 + i);
    } else {
      // The KW warps of a segment, summed in kq order.
      named_sync<CT>();
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(warp * 32 + lane) * 8 + p * 4 + e] = acc[0][p][e];
      named_sync<CT>();
      if (kq == 0) {
#pragma unroll
        for (int q = 1; q < KW; ++q)
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[0][p][e] +=
                  red[((q * Tile::kSegs + warp) * 32 + lane) * 8 + p * 4 + e];
        store_rows(acc[0], seg0);
      }
    }
  } else {
    constexpr int WORDS = TN / 4;
    constexpr int SLICES = CT / WORDS;
    static_assert(SLICES >= 1, "a consumer thread per 4-column word");
    const int word = tid % WORDS, slice = tid / WORDS;
    const int seg = word / 4;
    float acc[ROWS][4], plo[ROWS][4], phi[ROWS][4];
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;

    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % stages;
      mbar_wait(full(s), (c / stages) & 1);
      const uint8_t* pk = pk_ring + s * packed_bytes;
      const float* xs = reinterpret_cast<const float*>(x_ring + s * x_bytes);
      const float* sc =
          reinterpret_cast<const float*>(sc_ring + s * 2 * gps * TN * 4);
      const int xrow = xld / 4;  // floats a padded x row
      for (int gl = 0; gl < gps; ++gl) {
#pragma unroll
        for (int m = 0; m < ROWS; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) plo[m][e] = phi[m][e] = 0.f;
        for (int r = gl * a.G + slice; r < (gl + 1) * a.G; r += SLICES) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
              pk + packed_off<BW>(r, seg, a.tile_k) + 4 * (word % 4));
          float lo[4], hi[4];
          q4_unpack4(w, lo, hi);
#pragma unroll
          for (int m = 0; m < ROWS; ++m) {
            if (m < rv) {
              const float xl = xs[m * xrow + r];
              const float xh = xs[(a.rows_alloc + m) * xrow + r];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                plo[m][e] += xl * lo[e];
                phi[m][e] += xh * hi[e];
              }
            }
          }
        }
        const float4 sl =
            *reinterpret_cast<const float4*>(sc + gl * TN + word * 4);
        const float4 sh =
            *reinterpret_cast<const float4*>(sc + (gps + gl) * TN + word * 4);
        const float s_lo[4] = {sl.x, sl.y, sl.z, sl.w};
        const float s_hi[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
        for (int m = 0; m < ROWS; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[m][e] += plo[m][e] * s_lo[e] + phi[m][e] * s_hi[e];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // The row slices, summed in slice order: red[slice][m][column].
    named_sync<CT>();
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(slice * ROWS + m) * TN + word * 4 + e] = acc[m][e];
    named_sync<CT>();
    for (int i = tid; i < ROWS * TN; i += CT) {
      const int m = i / TN, col = i % TN;
      if (m >= rv) continue;
      float v = 0.f;
      for (int j = 0; j < SLICES; ++j) v += red[(j * ROWS + m) * TN + col];
      a.out[(size_t)(m0 + m) * a.N + col0 + col] = v;
    }
  }
}

// --- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so that
// the library does not link against libcuda; null where it is missing.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Shared memory bytes of a launch with these tiles, or -1 where it exceeds
// the cap (ops/quant.py:_stream_plan computes the same).
int smem_bytes(int TN, int T_bytes, int ROWS, int M, int G, int tile_k,
               int stages) {
  const int rows_alloc = ROWS < M ? ROWS : M;
  const int stage = tile_k * TN + 2 * rows_alloc * (tile_k * T_bytes + 16) +
                    2 * (tile_k / G) * TN * 4;
  const int cw = TN <= 256 ? 4 : TN / 64;
  const int red = T_bytes == 2 ? cw * 32 * 8 * 4
                               : (cw * 32 / (TN / 4)) * ROWS * TN * 4;
  const long long ring = (long long)stages * stage;
  const long long need = kHead + (ring > red ? ring : red);
  return need > kMaxSmem ? -1 : static_cast<int>(need);
}

template <typename T, int TN, int ROWS>
int launch(const CUtensorMap& tmap, const StreamArgs& a, cudaStream_t stream) {
  using Tile = StreamTile<TN>;
  const int smem =
      smem_bytes(TN, sizeof(T), ROWS, a.M, a.G, a.tile_k, a.stages);
  if (smem < 0) return -1;
  auto kernel = q4_stream_kernel<T, TN, ROWS>;
  static unsigned long long raised = 0;  // devices whose cap is set
  const int err = raise_smem_cap(kernel, kMaxSmem, raised);
  if (err != 0) return err;
  dim3 grid(a.N / TN, (a.M + ROWS - 1) / ROWS);
  kernel<<<grid, Tile::kThreads, smem, stream>>>(tmap, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ROWS>
int launch_tn(int tile_n, const CUtensorMap& tmap, const StreamArgs& a,
              cudaStream_t s) {
  switch (tile_n) {
    case 16: return launch<T, 16, ROWS>(tmap, a, s);
    case 32: return launch<T, 32, ROWS>(tmap, a, s);
    case 64: return launch<T, 64, ROWS>(tmap, a, s);
    case 128: return launch<T, 128, ROWS>(tmap, a, s);
    case 256: return launch<T, 256, ROWS>(tmap, a, s);
    case 512: return launch<T, 512, ROWS>(tmap, a, s);
    case 1024: return launch<T, 1024, ROWS>(tmap, a, s);
    default: return -1;
  }
}

}  // namespace

// dtype of x: 0 = f32 (CUDA-core FMAs, 1-row tiles for M = 1, else 8),
// 1 = bf16 (mma.sync, 16-row tiles). tile_n is a power of two in [16, 1024]
// dividing N; G is a multiple of 32; tile_k divides K/2 and is a multiple of
// G; `stages` (1 to 32, at most the K/2 / tile_k chunks) stages fit the
// block's shared memory with the epilogue's sums (ops/quant.py:_stream_plan
// chooses them). x, packed, scales and out must be 16-byte aligned and x
// contiguous. Returns a cudaError_t, -1 for arguments the kernel does not
// take, or -2 where the driver has no cuTensorMapEncodeTiled.
extern "C" int trackie_q4_stream(const void* x, const void* packed,
                                 const void* scales, void* out, int M, int K,
                                 int N, int G, int dtype, int tile_k,
                                 int tile_n, int stages, void* stream) {
  const int half = K / 2;
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  if (M < 1 || K < 2 || K % 2 || G < 32 || G % 32 || tile_k < G ||
      tile_k % G || half % tile_k || tile_n < 16 || tile_n > 1024 ||
      (tile_n & (tile_n - 1)) || N % tile_n || stages < 1 ||
      stages > kMaxStages || stages > half / tile_k ||
      (dtype != 0 && dtype != 1) || addr(x) % 16 || addr(packed) % 16 ||
      addr(scales) % 16 || addr(out) % 16)
    return -1;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  // The packed weight as a (K/2, N) uint8 tensor; a box is tile_k rows (at
  // most 256 at a time) of at most 128 columns, swizzled by its width.
  const int bw = tile_n < 128 ? tile_n : 128;
  int box_rows = 256;
  while (tile_k % box_rows) box_rows /= 2;  // tile_k is a multiple of 32
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)half};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {(cuuint32_t)bw, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      bw == 16    ? CU_TENSOR_MAP_SWIZZLE_NONE
      : bw == 32  ? CU_TENSOR_MAP_SWIZZLE_32B
      : bw == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
                  : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tmap;
  if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<void*>(packed), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -1;
  StreamArgs a{x, static_cast<const float*>(scales), static_cast<float*>(out),
               M, K, N, G, tile_k, box_rows, stages, 0};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    a.rows_alloc = M < 16 ? M : 16;
    return launch_tn<__nv_bfloat16, 16>(tile_n, tmap, a, s);
  }
  if (M == 1) {
    a.rows_alloc = 1;
    return launch_tn<float, 1>(tile_n, tmap, a, s);
  }
  a.rows_alloc = M < 8 ? M : 8;
  return launch_tn<float, 8>(tile_n, tmap, a, s);
}
