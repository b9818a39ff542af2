// Greedy-step out-projection and argmax for Hopper (sm_90a).
//
// Replaces s2vt_tpu/ops/pallas_decode.py::_kernel (launched by argmax_linear).
// For each row b of h [B, H]:
//
//   out[b] = argmax_v mask(h[b] . W[v] + bias[v])     (W [V, H], torch layout)
//
// where mask sets the columns v >= valid to -1e30 (the pad-vocab mask of
// ops/layers.py::mask_invalid_vocab) and the FIRST maximum wins, as
// torch.argmax and jnp.argmax pick it. h and the bias are float32. With
// bf16 != 0, h and W are rounded to bf16 as product operands and the sums
// stay float32, as the port's apply_linear does. The bias is added in
// float32 after the sum.
//
// Two routes, chosen by the caller (ops/fused_decode.py::argmax_linear_route):
//
// "mma" (rows of h and W that are whole 16-byte chunks: H % 4 == 0 with a
// float32 W in float32 mode, H % 8 == 0 with a bf16 W in bf16 mode; h and W
// 16-byte aligned) -- a GEMM on the tensor cores with the argmax in its
// epilogue: GEMM-M = the B rows of h in m16 tiles, GEMM-N = the vocab,
// GEMM-K = H.
//  - Block: kBN = 64 vocab columns in float32 and 128 in bf16 (16 per column
//    warp: two n8 tiles) by 16 rows of h (MI = 1 m16 tile, B <= 16) or 64
//    (MI = 4; a tile past B is skipped). With one m tile two warps share each
//    column warp's work, each taking half of every step's k slices (their
//    sums meet through shared memory at the end), so that the block has 8
//    (float32) or 16 (bf16) warps to hide the mma.sync chains' latency; with
//    four, 4 or 8 warps. Grid: ceil(V / kBN) vocab tiles x ceil(B / (16 MI))
//    row tiles, the row tile fastest, so the blocks that read one W tile run
//    together and all but the first find it in L2. The warps of a block read
//    h once for all kBN columns.
//  - The block walks K in steps of 128 bytes of each W row (32 float32 or 64
//    bf16 values) through a ring of kStages stages (6 for MI = 1, 3 for
//    MI = 4) in dynamic shared memory. A stage holds the step's kBN W rows
//    and the same k range of the block's h rows, in float32 in both modes,
//    filled by 16-byte cp.async.cg copies; a source past V, B or H is copied
//    with src-size 0 (zeros), so ragged edges cost no branch in the
//    products. Rows are padded so that the fragment loads hit distinct
//    banks. h comes in K chunks with W, so a block's shared memory (55-138
//    KB) does not grow with H.
//  - W [V, H] as it lies is the .col B operand of mma.sync .row.col: its
//    fragments come by ldmatrix without .trans. Each W fragment serves all
//    MI m tiles of the block.
//  - bf16: mma.sync m16n8k16 bf16 -> f32. W is read as bf16 (the caller
//    converts the weight once per greedy decode); h is rounded to bf16 where
//    its fragments are built from the staged float32 (8-byte loads,
//    cvt.rn.bf16x2).
//  - float32 as 3xTF32, as conv3x3_bn_relu.cu's mma route: each operand
//    splits into big = tf32(v) and small = v - big (mma.cuh); mma.sync
//    m16n8k8 sums small*big + big*small + big*big. The tensor cores truncate
//    as they accumulate, so each 8-wide k slice's passes (each 16-wide
//    slice's product in bf16) go into a fresh partial that joins the running
//    sum by a round-to-nearest add.
//  - Epilogue in registers: the [B, V] logits never reach device memory. A
//    thread's accumulators hold rows g, g + 8 of each m tile and columns
//    2 * (lane % 4) + {0, 1} of each n8 tile. It adds the bias, applies the
//    mask and keeps a running (max, index) per row with a strict `>` over
//    its columns in increasing order; the lanes of a quad and the warps of
//    the block combine by beats() (the larger value, then the lower index),
//    and the block writes one candidate per row to scratch.
//
// "direct" (every other shape: H not a multiple of 4 or 8, an unaligned
// view, a float32 W in bf16 mode) -- the CUDA cores:
//  - Grid (vocab tiles, row tiles of RB rows of h): RB = 16 with VR = 4 W rows
//    per warp (32 per block, 320 blocks at V = 10240) for B <= 16, else
//    RB = 32 with VR = 2. Each block stages its h rows in shared memory
//    (rounded to bf16 first in bf16 mode, zero past B), in chunks of k of
//    at most kHChunk = 1792 values so that any H fits, and reads its W rows
//    once, coalesced: W is [V, H], so the H values of one logit column are
//    contiguous. The lanes of a warp split the k range; each lane keeps
//    VR x RB partial sums in registers, loads VR x 4 values of W at a time,
//    and uses each value of h it reads from shared memory for VR products.
//    A warp reduce-scatter per W row leaves the sum of h row `lane` with
//    lane `lane`.
//  - Each lane then keeps a running (max, index) for its h row with a strict
//    `>` over increasing vocab index; the block combines its 8 warps and
//    writes one (max, index) per row and vocab tile to scratch.
//  - Products and sums float32 on the CUDA cores; W is read as float32.
//
// Both routes end alike (finish_row_tile): the last block of a row tile to
// finish (an atomic counter per row tile, after a __threadfence) reduces the
// tiles' candidates: the larger value wins, the lower index on a tie, so the
// result does not depend on the order in which the blocks ran. It resets the
// counter to 0 for the next launch. One launch per call.
//
// The "_value" entry points launch the same kernels and write, beside each
// row's token, its winning logit (float32; -inf where the token is a masked
// column, so a vocab shard with no valid column never wins). A model whose
// vocab is split over ranks (parallel/vocab.py) launches one per shard and
// merges the (value, global index) pairs: the larger value, the lower index
// on a tie, which is the whole vocab's first maximum. A column's sum does not
// depend on V, so the shards' values are the whole launch's bit for bit.
//
// Bounds on an H100 SXM at the MSVD width (V = 10240, H = 512). B = 16,
// float32: W is 21 MB -> ~6.3 us at 3.35 TB/s; 2*B*H*V = 0.17 GFLOP, as
// three TF32 passes -> ~1.0 us at 495 TFLOP/s (on the CUDA cores: ~2.5 us at
// 67 TFLOP/s). bf16 with W read as bf16: 10.5 MB -> ~3.2 us. B = 96,
// float32: 21.2 MB -> ~6.3 us against 3 x 1.0 GFLOP -> ~6.1 us at the TF32
// peak. The bytes of W set the bound. What the mma route does about the
// direct route's limits:
//  1. CUDA cores only (bf16 mode rounds operands, then does float32 FMAs):
//     the products run on the tensor cores, in bf16 or as 3xTF32.
//  2. At B = 96 the direct route is bound by the float32 CUDA-core rate,
//     each W value reused across 32 rows at one shared-memory read of h per
//     two products: here a W fragment serves up to 64 rows, and an h
//     fragment 16 columns, in mma.sync.
//  3. W read as float32 in bf16 mode: here it is read as bf16, half the bytes.
//  4. No overlap of loads and math in a block, and h re-staged whole by each
//     of 320 blocks (10.5 MB from L2 at B = 16): here the ring keeps up to
//     5 stages (40 KB of W in float32) in flight per block while the oldest
//     one's products run, and h is read once per 64 (float32) or 128 (bf16)
//     columns: 5.2 or 2.6 MB from L2 at B = 16.
// What holds the route back (tools/argmax_mma_variants.py times the copies
// alone and the products alone): at B = 16 each half takes ~3/4 of the
// whole, so neither hides the other; a block's ~16 serial steps and the
// cross-block finish set a floor of several microseconds even for a small
// vocab. At B = 96 the products are most of the time: 3xTF32 runs far
// below the TF32 peak, and each block re-reads h.
// chip_smoke.py recomputes these figures from the shapes it runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;            // ops/layers.py NEG_INF

// (v1, i1) beats (v2, i2): larger value, lower index on a tie.
__device__ __forceinline__ bool beats(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// The cross-block finish of row tile `rt` (rows row0 .. row0 + rows - 1),
// called by every thread of a block once the block's candidates for its
// vocab tile are in pmax / pidx [n_vt, B]: the last of the n_vt blocks of
// the row tile to arrive reduces all candidates of each row and writes the
// token, then leaves the tile's counter at 0 for the next launch.
__device__ __forceinline__ void finish_row_tile(const float* __restrict__ pmax,
                                                const int* __restrict__ pidx,
                                                long long* __restrict__ out,
                                                float* __restrict__ out_val,
                                                unsigned int* __restrict__ counter, int rt,
                                                int n_vt, int B, int row0, int rows,
                                                int valid) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter + rt, 1u) == (unsigned)n_vt - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps) {
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll 4
    for (int t = lane; t < n_vt; t += 32) {
      const float cv = __ldcg(pmax + (size_t)t * B + row0 + r);
      const int ci = __ldcg(pidx + (size_t)t * B + row0 + r);
      if (beats(cv, ci, bv, bi)) {
        bv = cv;
        bi = ci;
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, s);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, s);
      if (beats(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      out[row0 + r] = bi;
      if (out_val != nullptr) out_val[row0 + r] = bi < valid ? bv : -INFINITY;
    }
  }
  if (threadIdx.x == 0) counter[rt] = 0u;     // ready for the next launch
}

// ---------------------------------------------------------------------------
// The "direct" route
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;                    // k positions each lane loads at once
constexpr int kHChunk = 14 * 32 * kLoads;    // k values of h staged at once: 1792, so that a
                                             // 32-row tile fits 227 KB of shared memory

// RB rows of h per block, VR rows of W per warp (kVT = 8 * VR per block).
template <int RB, int VR>
__global__ void __launch_bounds__(kThreads)
argmax_linear_kernel(const float* __restrict__ h, const float* __restrict__ w,
                     const float* __restrict__ bias, long long* __restrict__ out,
                     float* __restrict__ out_val, float* __restrict__ pmax,
                     int* __restrict__ pidx, unsigned int* __restrict__ counter, int B, int H,
                     int V, int valid, int bf16) {
  extern __shared__ float hs[];                // [RB][kc]: the chunk of k in flight
  __shared__ float red_v[kWarps][32];
  __shared__ int red_i[kWarps][32];

  const int vt = blockIdx.x, rt = blockIdx.y;
  const int row0 = rt * RB;
  const int rows = min(RB, B - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int vbase = (vt * kWarps + warp) * VR;   // this warp's W rows vbase .. + VR - 1
  float acc[VR][RB];
#pragma unroll
  for (int j = 0; j < VR; ++j)
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[j][r] = 0.0f;
  // k in chunks of kHChunk (one chunk up to H = 1792), each summed in the
  // order of one pass over the whole row.
  for (int c0 = 0; c0 < H; c0 += kHChunk) {
    const int kc = min(kHChunk, H - c0);
    if (c0 > 0) __syncthreads();               // the previous chunk's products have read hs
    for (int i = threadIdx.x; i < RB * kc; i += kThreads) {
      const int r = i / kc;
      float v = r < rows ? h[(size_t)(row0 + r) * H + c0 + (i - r * kc)] : 0.0f;
      hs[i] = bf16 ? round_bf16(v) : v;
    }
    __syncthreads();

    for (int k0 = lane; k0 < kc; k0 += 32 * kLoads) {
      float wv[VR][kLoads];                    // VR * kLoads loads in flight
#pragma unroll
      for (int j = 0; j < VR; ++j) {
        const float* wr = w + (size_t)min(vbase + j, V - 1) * H + c0;
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
          const int k = k0 + 32 * q;
          float x = k < kc ? __ldg(wr + k) : 0.0f;
          wv[j][q] = bf16 ? round_bf16(x) : x;
        }
      }
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int k = min(k0 + 32 * q, kc - 1);  // past the chunk: wv is 0, any h will do
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float hv = hs[r * kc + k];     // one shared-memory read for VR products
#pragma unroll
          for (int j = 0; j < VR; ++j) acc[j][r] = fmaf(wv[j][q], hv, acc[j][r]);
        }
      }
    }
  }
  float best = -INFINITY;
  int best_i = INT_MAX;
#pragma unroll
  for (int j = 0; j < VR; ++j) {
    reduce_scatter(acc[j], lane);              // acc[j][0]: the sum of h row (lane % RB)
    const int v = vbase + j;
    if (v < V) {
      const float logit = v < valid ? acc[j][0] + bias[v] : kNegInf;
      if (logit > best) {                      // strict: the earlier column wins a tie
        best = logit;
        best_i = v;
      }
    }
  }
  red_v[warp][lane] = best;
  red_i[warp][lane] = best_i;
  __syncthreads();
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float bv = red_v[0][r];
    int bi = red_i[0][r];
    for (int q = 1; q < kWarps; ++q) {
      if (beats(red_v[q][r], red_i[q][r], bv, bi)) {
        bv = red_v[q][r];
        bi = red_i[q][r];
      }
    }
    pmax[(size_t)vt * B + row0 + r] = bv;
    pidx[(size_t)vt * B + row0 + r] = bi;
  }
  finish_row_tile(pmax, pidx, out, out_val, counter, rt, gridDim.x, B, row0, rows, valid);
}

template <int RB, int VR>
int launch(const float* h, const float* w, const float* bias, long long* out, float* out_val,
           float* pmax, int* pidx, unsigned int* counter, int B, int H, int V, int valid,
           int bf16, cudaStream_t stream) {
  const size_t smem = (size_t)RB * (H < kHChunk ? H : kHChunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(argmax_linear_kernel<RB, VR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kVT = kWarps * VR;
  const dim3 grid((V + kVT - 1) / kVT, (B + RB - 1) / RB), block(kThreads);
  argmax_linear_kernel<RB, VR><<<grid, block, smem, stream>>>(
      h, w, bias, out, out_val, pmax, pidx, counter, B, H, V, valid, bf16);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The "mma" route (cp.async, ldmatrix, mma.sync and the TF32 split: mma.cuh)
// ---------------------------------------------------------------------------

constexpr int kWRowBytes = 128;              // bytes of each W row per step

// The tile geometry of one (T, MI) instance: W read as T (float, or
// __nv_bfloat16 in bf16 mode), MI m16 tiles of h rows per block.
template <typename T, int MI>
struct MmaTile {
  static constexpr int kES = sizeof(T);
  // Column warps: bf16 8, so that a block reads h once for 128 vocab columns
  // (h is float32, as many bytes as the W rows it meets); float32 4 and 64
  // columns, twice the blocks, since its products take longer than its
  // copies. With one m tile, kSplitK warps share a column warp's 16 columns,
  // each taking its share of every step's k slices, so that twice the warps
  // hide the latency of the mma.sync chains.
  static constexpr int kWarpsN = kES == 2 ? 8 : 4;
  static constexpr int kSplitK = MI == 1 ? 2 : 1;
  static constexpr int kWarps = kWarpsN * kSplitK;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBN = 16 * kWarpsN;                   // vocab columns: 16 per warp
  static constexpr int kBK = kWRowBytes / kES;              // k per step: 32 or 64
  static constexpr int kRows = 16 * MI;                      // h rows per block
  static constexpr int kWStride = kWRowBytes + 16;           // padded: rows on distinct banks
  // h stays float32 in both modes. bf16 builds its fragments from 8-byte
  // loads, whose half-warps read 4 rows: rows 8 banks apart then hit 32.
  static constexpr int kHRowBytes = kBK * 4;
  static constexpr int kHStride = kHRowBytes + (kES == 2 ? 32 : 16);
  static constexpr int kWBytes = kBN * kWStride;
  static constexpr int kStageBytes = kWBytes + kRows * kHStride;
  static constexpr int kStages = MI == 1 ? 6 : 3;
  static constexpr int kSlices = kWRowBytes / 32 / kSplitK;  // 32-byte k slices per warp and step
  static constexpr int kSmem = kStages * kStageBytes;
  static constexpr int kWRowChunks = kWRowBytes / 16;
  static constexpr int kWChunks = kBN * kWRowChunks / kThreads;      // copies per thread
  static constexpr int kHRowChunks = kHRowBytes / 16;
  static constexpr int kHCopies = kRows * kHRowChunks;
  static constexpr int kHChunks = (kHCopies + kThreads - 1) / kThreads;
  static_assert(kWChunks * kThreads == kBN * kWRowChunks, "W copies must tile");
  static_assert(kStageBytes % 16 == 0, "stages must stay 16-byte aligned");
  static_assert(kSplitK == 1 || (kSplitK - 1) * kWarpsN * 32 * MI * 8 * 4 <= kSmem,
                "the k shares' sums fit the drained ring");
};

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {   // v.x in the low half
  __nv_bfloat162 p = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<uint32_t*>(&p);
}

template <typename T, int MI>
__global__ void __launch_bounds__(MmaTile<T, MI>::kThreads)
argmax_linear_kernel_mma(const float* __restrict__ h, const T* __restrict__ w,
                         const float* __restrict__ bias, long long* __restrict__ out,
                         float* __restrict__ out_val, float* __restrict__ pmax,
                         int* __restrict__ pidx, unsigned int* __restrict__ counter, int B,
                         int H, int V, int valid, int row_tiles) {
  using G = MmaTile<T, MI>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_v[G::kWarpsN][G::kRows];
  __shared__ int red_i[G::kWarpsN][G::kRows];
  const uint32_t smem_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % G::kWarpsN, wk = warp / G::kWarpsN;   // column warp, k share
  const int g = lane >> 2, tig = lane & 3;
  const int rt = blockIdx.x % row_tiles, vt = blockIdx.x / row_tiles;
  const int n_vt = gridDim.x / row_tiles;
  const int row0 = rt * G::kRows, n0 = vt * G::kBN;
  const int rows = min(G::kRows, B - row0);
  const int active = (rows + 15) >> 4;      // m16 tiles with a row below B
  const int n_steps = (H + G::kBK - 1) / G::kBK;

  // Step `step`'s 64 W rows and h rows into ring slot `slot`: W row n0 + r
  // in 16-byte chunks, thread tid taking chunks tid + i * 128 (8 threads per
  // 128-byte row); h row row0 + r likewise, 4 float32 per chunk.
  auto load_stage = [&](int step, int slot) {
    const uint32_t sw = smem_base + slot * G::kStageBytes, sh = sw + G::kWBytes;
    const int k0 = step * G::kBK;
#pragma unroll
    for (int i = 0; i < G::kWChunks; ++i) {
      const int id = tid + i * G::kThreads;
      const int r = id / G::kWRowChunks, c = id % G::kWRowChunks;
      const int k = k0 + c * (16 / G::kES);
      const bool ok = n0 + r < V && k < H;
      cp_async16(sw + r * G::kWStride + c * 16, ok ? w + (size_t)(n0 + r) * H + k : w, ok);
    }
#pragma unroll
    for (int i = 0; i < G::kHChunks; ++i) {
      const int id = tid + i * G::kThreads;
      if (G::kHCopies % G::kThreads != 0 && id >= G::kHCopies) break;
      const int r = id / G::kHRowChunks, c = id % G::kHRowChunks;
      const int k = k0 + c * 4;
      const bool ok = r < rows && k < H;
      cp_async16(sh + r * G::kHStride + c * 16, ok ? h + (size_t)(row0 + r) * H + k : h, ok);
    }
  };

  float acc[MI][2][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) {
    if (s < n_steps) load_stage(s, s);
    cp_async_commit();
  }

  // This lane's ldmatrix row of the warp's 16 W rows: lanes 0-7 and 8-15
  // address the low and high 16 bytes of a 32-byte k slice of rows 0-7,
  // lanes 16-31 the same of rows 8-15, so that the four matrices are the
  // two b registers of n8 tiles 0 and 1.
  const uint32_t w_lane = (wn * 16 + (lane & 7) + ((lane >> 4) << 3)) * G::kWStride +
                          ((lane >> 3) & 1) * 16;
  const int k_share = wk * G::kSlices;      // this warp's first 32-byte k slice of a step
  // This thread's columns are c0 + 8 * ni + j, in increasing order; their
  // bias is loaded now, so that the epilogue does not wait for it.
  const int c0 = n0 + wn * 16 + 2 * tig;
  float bias_c[2][2];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int v = c0 + 8 * ni + j;
      bias_c[ni][j] = v < valid ? bias[v] : 0.0f;
    }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<G::kStages - 2>();  // this step's stage has landed (for this thread)
    __syncthreads();                  // ... for every thread; the slot refilled below is free
    const int next = step + G::kStages - 1;
    if (next < n_steps) load_stage(next, next % G::kStages);
    cp_async_commit();

    const int slot = step % G::kStages;
    const uint32_t sw = smem_base + slot * G::kStageBytes, sh = sw + G::kWBytes;
    const float* hs = reinterpret_cast<const float*>(smem + slot * G::kStageBytes + G::kWBytes);
    // This warp's share of the step: kSlices 32-byte k slices (k16 in bf16,
    // k8 in float32). Each slice's products go round by round over the
    // (m tile, n tile) pairs, so that an mma does not wait on the one before
    // it (asm volatile keeps program order).
#pragma unroll
    for (int kq = 0; kq < G::kSlices; ++kq) {
      const int k0 = k_share + kq;
      uint32_t r[4], b[2][2], b_small[2][2], a[MI][4], a_small[MI][4];
      float part[MI][2][4];
      ldsm_x4(r, sw + w_lane + k0 * 32);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kBf16) b[j >> 1][j & 1] = r[j];
        else split_tf32(__uint_as_float(r[j]), b[j >> 1][j & 1], b_small[j >> 1][j & 1]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[mi][ni][j] = 0.0f;
        if (mi >= active) continue;         // warp-uniform: a tile wholly past B
        if constexpr (kBf16) {
          const float* hr = hs + (mi * 16 + g) * (G::kHStride / 4) + k0 * 16 + 2 * tig;
          constexpr int kDown = 8 * (G::kHStride / 4);       // 8 rows on
          a[mi][0] = pack_bf16(*reinterpret_cast<const float2*>(hr));
          a[mi][1] = pack_bf16(*reinterpret_cast<const float2*>(hr + kDown));
          a[mi][2] = pack_bf16(*reinterpret_cast<const float2*>(hr + 8));
          a[mi][3] = pack_bf16(*reinterpret_cast<const float2*>(hr + kDown + 8));
        } else {
          ldsm_x4(r, sh + (mi * 16 + (lane & 15)) * G::kHStride + k0 * 32 + (lane >> 4) * 16);
#pragma unroll
          for (int j = 0; j < 4; ++j) split_tf32(__uint_as_float(r[j]), a[mi][j], a_small[mi][j]);
        }
      }
      // float32: small*big, then big*small, then big*big into each fresh
      // partial, one round over all (m tile, n tile) pairs at a time.
#pragma unroll
      for (int pass = 0; pass < (kBf16 ? 1 : 3); ++pass)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          if (mi >= active) continue;
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            if constexpr (kBf16) mma_bf16(part[mi][ni], a[mi], b[ni]);
            else if (pass == 0) mma_tf32(part[mi][ni], a_small[mi], b[ni]);
            else if (pass == 1) mma_tf32(part[mi][ni], a[mi], b_small[ni]);
            else mma_tf32(part[mi][ni], a[mi], b[ni]);
          }
        }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)       // round-to-nearest adds, in k order
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] += part[mi][ni][j];
    }
  }
  cp_async_wait<0>();
  if constexpr (G::kSplitK > 1) {
    // The k shares' sums meet in share 0's warps, in share order, through
    // the drained ring: [share - 1][column warp][accumulator][lane].
    float* part_sums = reinterpret_cast<float*>(smem);
    constexpr int kAcc = MI * 2 * 4;
    __syncthreads();
#pragma unroll
    for (int q = 1; q < G::kSplitK; ++q) {
      float* ps = part_sums + ((q - 1) * G::kWarpsN + wn) * kAcc * 32 + lane;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (wk == q) ps[((mi * 2 + ni) * 4 + j) * 32] = acc[mi][ni][j];
    }
    __syncthreads();
#pragma unroll
    for (int q = 1; q < G::kSplitK; ++q) {
      const float* ps = part_sums + ((q - 1) * G::kWarpsN + wn) * kAcc * 32 + lane;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (wk == 0) acc[mi][ni][j] += ps[((mi * 2 + ni) * 4 + j) * 32];
    }
  }

  // Epilogue: bias, mask and the running (max, index) of each row.
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    if (wk > 0) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float best = -INFINITY;
      int best_i = INT_MAX;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int v = c0 + 8 * ni + j;
          if (v < V) {
            const float logit = v < valid ? acc[mi][ni][2 * half + j] + bias_c[ni][j] : kNegInf;
            if (logit > best) {              // strict: the earlier column wins a tie
              best = logit;
              best_i = v;
            }
          }
        }
      }
#pragma unroll
      for (int s = 1; s < 4; s <<= 1) {      // the quad's lanes hold the row's other columns
        const float ov = __shfl_xor_sync(0xffffffffu, best, s);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i, s);
        if (beats(ov, oi, best, best_i)) {
          best = ov;
          best_i = oi;
        }
      }
      if (tig == 0) {
        red_v[wn][mi * 16 + half * 8 + g] = best;
        red_i[wn][mi * 16 + half * 8 + g] = best_i;
      }
    }
  }
  __syncthreads();
  if (tid < rows) {
    float bv = red_v[0][tid];
    int bi = red_i[0][tid];
#pragma unroll
    for (int q = 1; q < G::kWarpsN; ++q) {
      if (beats(red_v[q][tid], red_i[q][tid], bv, bi)) {
        bv = red_v[q][tid];
        bi = red_i[q][tid];
      }
    }
    pmax[(size_t)vt * B + row0 + tid] = bv;
    pidx[(size_t)vt * B + row0 + tid] = bi;
  }
  finish_row_tile(pmax, pidx, out, out_val, counter, rt, n_vt, B, row0, rows, valid);
}

template <typename T, int MI>
int launch_mma(const void* h, const void* w, const void* bias, void* out, void* out_val,
               void* pmax, void* pidx, void* counter, int B, int H, int V, int valid,
               cudaStream_t stream) {
  using G = MmaTile<T, MI>;
  const int row_tiles = (B + G::kRows - 1) / G::kRows;
  const long long blocks = (long long)((V + G::kBN - 1) / G::kBN) * row_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  auto* kernel = argmax_linear_kernel_mma<T, MI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, G::kThreads, G::kSmem, stream>>>(
      static_cast<const float*>(h), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<long long*>(out), static_cast<float*>(out_val), static_cast<float*>(pmax),
      static_cast<int*>(pidx),
      static_cast<unsigned int*>(counter), B, H, V, valid, row_tiles);
  return (int)cudaGetLastError();
}

// One m16 tile of rows per block for B <= 16, else four.
template <typename T>
int launch_mma_for(const void* h, const void* w, const void* bias, void* out, void* out_val,
                   void* pmax, void* pidx, void* counter, int B, int H, int V, int valid,
                   cudaStream_t stream) {
  if (B <= 16)
    return launch_mma<T, 1>(h, w, bias, out, out_val, pmax, pidx, counter, B, H, V, valid,
                            stream);
  return launch_mma<T, 4>(h, w, bias, out, out_val, pmax, pidx, counter, B, H, V, valid, stream);
}

// The "direct" route, with or without the winning values (out_val may be null).
int direct_entry(const void* h, const void* w, const void* bias, void* out, void* out_val,
                 void* pmax, void* pidx, void* counter, int B, int H, int V, int valid, int bf16,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto* ph = static_cast<const float*>(h);
  auto* pw = static_cast<const float*>(w);
  auto* pb = static_cast<const float*>(bias);
  auto* po = static_cast<long long*>(out);
  auto* pv = static_cast<float*>(out_val);
  auto* pm = static_cast<float*>(pmax);
  auto* pi = static_cast<int*>(pidx);
  auto* pc = static_cast<unsigned int*>(counter);
  auto* st = static_cast<cudaStream_t>(stream);
  if (B <= 16) return launch<16, 4>(ph, pw, pb, po, pv, pm, pi, pc, B, H, V, valid, bf16, st);
  return launch<32, 2>(ph, pw, pb, po, pv, pm, pi, pc, B, H, V, valid, bf16, st);
}

// The "mma" route, with or without the winning values (out_val may be null).
int mma_entry(const void* h, const void* w, const void* bias, void* out, void* out_val,
              void* pmax, void* pidx, void* counter, int B, int H, int V, int valid, int bf16,
              int device, void* stream) {
  if (H % (bf16 ? 8 : 4) != 0 || reinterpret_cast<uintptr_t>(h) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto* st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_mma_for<__nv_bfloat16>(h, w, bias, out, out_val, pmax, pidx, counter, B, H, V,
                                         valid, st);
  return launch_mma_for<float>(h, w, bias, out, out_val, pmax, pidx, counter, B, H, V, valid,
                               st);
}

}  // namespace

extern "C" {

// The "direct" route's vocab tiles (blocks along the vocab) for V columns and
// B rows: the scratch holds one candidate per tile and row.
int argmax_linear_vocab_tiles(int B, int V) {
  const int vt = kWarps * (B <= 16 ? 4 : 2);
  return (V + vt - 1) / vt;
}

// The "mma" route's vocab tiles for V columns, at any B, in float32 mode
// (bf16 == 0) or bf16 mode.
int argmax_linear_mma_vocab_tiles(int V, int bf16) {
  const int bn = bf16 ? MmaTile<__nv_bfloat16, 1>::kBN : MmaTile<float, 1>::kBN;
  static_assert(MmaTile<float, 1>::kBN == MmaTile<float, 4>::kBN &&
                MmaTile<__nv_bfloat16, 1>::kBN == MmaTile<__nv_bfloat16, 4>::kBN,
                "the vocab tile does not depend on B");
  return (V + bn - 1) / bn;
}

// Dynamic shared memory a "direct" block needs for hidden size H (the 32-row
// tile of a chunk of k: at most 224 KB, at H >= 1792). The "mma" route's does
// not depend on H (at most 111 KB).
size_t argmax_linear_smem_bytes(int H) {
  return (size_t)32 * (H < kHChunk ? H : kHChunk) * sizeof(float);
}

// The "direct" route. h [B, H], w [V, H], bias [V] float32; out [B] int64;
// pmax [tiles, B] float32 and pidx [tiles, B] int32 scratch
// (argmax_linear_vocab_tiles); counter [ceil(B / 16)] uint32, zero before
// the first launch (each launch leaves it zero). All contiguous on card
// `device`. Columns >= valid are masked. Launches on `stream`; returns the
// cudaError_t of the launch.
int argmax_linear(const void* h, const void* w, const void* bias, void* out, void* pmax,
                  void* pidx, void* counter, int B, int H, int V, int valid, int bf16, int device,
                  void* stream) {
  return direct_entry(h, w, bias, out, nullptr, pmax, pidx, counter, B, H, V, valid, bf16,
                      device, stream);
}

// The "mma" route: the same arguments, but w is bf16 when bf16 != 0 (float32
// otherwise), the scratch has argmax_linear_mma_vocab_tiles(V, bf16) rows, and h
// and w must be 16-byte aligned with H % 8 == 0 in bf16 mode and H % 4 == 0
// in float32 mode (cudaErrorInvalidValue otherwise).
int argmax_linear_mma(const void* h, const void* w, const void* bias, void* out, void* pmax,
                      void* pidx, void* counter, int B, int H, int V, int valid, int bf16,
                      int device, void* stream) {
  return mma_entry(h, w, bias, out, nullptr, pmax, pidx, counter, B, H, V, valid, bf16, device,
                   stream);
}

// Both routes once more, writing also each row's winning logit to out_val [B]
// float32: the value of the token in out, or -inf where that token is a
// masked column (index >= valid; with valid == 0, every row). A vocab shard's
// launch: the caller merges the shards' (value, offset + index) pairs.
int argmax_linear_value(const void* h, const void* w, const void* bias, void* out,
                        void* out_val, void* pmax, void* pidx, void* counter, int B, int H, int V,
                        int valid, int bf16, int device, void* stream) {
  return direct_entry(h, w, bias, out, out_val, pmax, pidx, counter, B, H, V, valid, bf16,
                      device, stream);
}

int argmax_linear_mma_value(const void* h, const void* w, const void* bias, void* out,
                            void* out_val, void* pmax, void* pidx, void* counter, int B, int H,
                            int V, int valid, int bf16, int device, void* stream) {
  return mma_entry(h, w, bias, out, out_val, pmax, pidx, counter, B, H, V, valid, bf16, device,
                   stream);
}

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
