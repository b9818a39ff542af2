// Fused 3x3 convolution + folded BatchNorm + ReLU for Hopper (sm_90a).
//
// Replaces s2vt_tpu/ops/pallas_conv.py::_conv_kernel (launched by
// fused_conv3x3_bn_relu). NHWC, stride 1, SAME (one pixel of zeros around):
//
//   out[n, y, x, k] = relu(scale[k] * sum_{dy, dx, c} xin[n, y+dy-1, x+dx-1, c]
//                                               * w[dy, dx, c, k] + shift[k])
//
// with w in HWIO [3, 3, C, K]. The inference BatchNorm and the conv bias are
// folded into (scale, shift) by the caller. T is float (float32 mode) or
// __nv_bfloat16 (bf16 mode): x, w and the output are of type T, the sums
// float32, so in bf16 mode the output is rounded to bf16 once, as the TPU
// kernel's is.
//
// Two routes, chosen by the caller (ops/fused_conv.py::conv3x3_route):
//
// "mma" (C % 16 == 0 and K % 8 == 0: every VGG16 layer but the first) -- an
// implicit GEMM on the tensor cores. M = N*H*W output pixels, GEMM-N = K,
// GEMM-K = 9*C walked tap by tap (dy, dx) and, within a tap, in chunks of BK
// channels. The A tile of a (tap, chunk) step is BM = 128 pixel rows x BK
// channels read at x[n, y+dy-1, x+dx-1, c0 : c0+BK]; HWIO w is already a
// row-major [9C, K] matrix, and the B tile is its rows tap*C + c0 ... and
// columns k0 ... k0+BN. No im2col buffer exists anywhere.
//  - Each 64-byte row of a tile is 16-byte cp.async.cg copies into a ring of
//    kStages = 4 stages in dynamic shared memory, so the loads of step s+3
//    overlap the products of step s. A source outside the image, past C or
//    past K is copied with src-size 0 (zeros): the SAME halo and the ragged
//    edges cost no branch in the products. Rows are padded (A by 16 bytes, B
//    by 16 or 32) so that the fragment loads hit 32 distinct banks.
//  - bf16: BK = 32; mma.sync m16n8k16 bf16 -> f32, fragments by ldmatrix
//    (.trans for the row-major B tile).
//  - float32, as 3xTF32: BK = 16; each operand v splits at fragment load into
//    big = tf32(v) (cvt.rna's rounding, in two integer operations, which the
//    H100 runs faster than the cvt) and small = v - big, whose upper
//    10 mantissa bits the tensor cores read; mma.sync m16n8k8 TF32 -> f32
//    sums small*big + big*small + big*big, and small*small (~2^-21 relative)
//    is dropped. One TF32 pass keeps ~3 decimal digits, too few for the
//    float32 check over GEMM-K = 4608 (tests/test_torch_conv_mma.py). A
//    fragments come by ldmatrix (a 32-bit value is a pair of b16), B
//    fragments by 32-bit shared loads. The tensor cores truncate where they
//    add into their accumulator, a bias that grows with the number of mma
//    adds (3e-4 at C = 512 when all went into one accumulator), so each
//    8-channel slice's passes sum into a fresh partial that joins the
//    running sum by a round-to-nearest add.
//  - Block: BM = 128 pixels x BN output channels; warp tiles of 64 x 32 in
//    bf16 (BN = 64 with 4 warps for K <= 64, else BN = 128 with 8) and of
//    32 x 32 in float32 (BN = 64, 8 warps), so that each instance fits 128
//    registers without spills and an SM holds 16 warps. Grid: ceil(M/BM) *
//    ceil(K/BN) blocks, the channel tile fastest, so the blocks that share a
//    pixel tile run together and find it in L2. A block's rows may span
//    image rows and images: each row's in-image taps are found once.
//  - Epilogue: relu(acc * scale + shift) in registers, stored as pairs of T,
//    the ragged M edge masked.
//
// "direct" (every other shape: VGG16's first layer, C = 3, and widths that
// divide nothing) -- a direct convolution on the CUDA cores:
//  - Block (tile of 8 x 8 output pixels, tile of 64 output channels, image n).
//    The grid walks the image in such tiles; partial tiles at the right and
//    bottom edges are masked, so any H, W, C and K work (C = 3 included).
//  - Over C in chunks of 16 channels, the block stages in shared memory the
//    10 x 10 x 16 input patch with its one-pixel halo (zeros outside the
//    image and past C) and the matching 3 x 3 x 16 x 64 weights (zeros past
//    C and K), both as float32.
//  - Each of the 256 threads owns 4 neighbouring pixels of one row x 4
//    neighbouring channels: per input channel and kernel row it reads the 6
//    input values its 4 pixels need across the 3 taps, and one float4 of
//    weights per tap, and accumulates 48 products in registers.
//  - The epilogue applies scale, shift and ReLU and writes T.
//
// Bounds on an H100 SXM for VGG16's 13 layers at N = 80 frames (224 x 224
// input): 2*N*H*W*9*C*K summed over the layers = 2.46 TFLOP, 2.45 of them on
// the mma route. bf16: ~2.5 ms at the 989 TFLOP/s bf16 tensor-core peak.
// float32 on the mma route: three TF32 passes, 3 * 2.45 TFLOP at the 495
// TFLOP/s TF32 peak, ~14.8 ms; on the direct route (the first layer, 0.014
// TFLOP) the 67 TFLOP/s float32 peak or its ~1.1 GB of float32 bytes at
// 3.35 TB/s, ~0.3 ms. The activations and weights of all layers, each read
// or written once, are ~7.3 GB in float32 -> ~2.2 ms, so the operations set
// the bound. chip_smoke.py recomputes these figures from the shapes it runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// The "direct" route
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTH = 8, kTW = 8;          // output pixels per block
constexpr int kPH = kTH + 2, kPW = kTW + 2;  // the staged patch, with its halo
constexpr int kTK = 64;                  // output channels per block
constexpr int kCC = 16;                  // input channels per staged chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ scale, const float* __restrict__ shift,
                       T* __restrict__ out, int H, int W, int C, int K) {
  __shared__ __align__(16) float xs[kPH * kPW * kCC];
  __shared__ __align__(16) float ws[9 * kCC * kTK];

  const int tiles_w = (W + kTW - 1) / kTW;
  const int y0 = (blockIdx.x / tiles_w) * kTH, x0 = (blockIdx.x % tiles_w) * kTW;
  const int k0 = blockIdx.y * kTK;
  const size_t n = blockIdx.z;
  const int tid = threadIdx.x;
  const int kg = tid % 16;               // channels k0 + 4*kg .. + 3
  const int pg = tid / 16;               // pixels (py, px0 .. px0 + 3)
  const int py = pg / 2, px0 = (pg % 2) * 4;

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    const int cc = min(kCC, C - c0);
    for (int i = tid; i < kPH * kPW * kCC; i += kThreads) {
      const int pix = i / kCC, c = i % kCC;
      const int yy = y0 - 1 + pix / kPW, xx = x0 - 1 + pix % kPW;
      float v = 0.0f;
      if (c < cc && yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = to_f(x[((n * H + yy) * W + xx) * C + c0 + c]);
      xs[i] = v;
    }
    for (int i = tid; i < 9 * kCC * kTK; i += kThreads) {
      const int k = i % kTK, c = (i / kTK) % kCC, tap = i / (kTK * kCC);
      float v = 0.0f;
      if (c < cc && k0 + k < K) v = to_f(w[((size_t)tap * C + c0 + c) * K + k0 + k]);
      ws[i] = v;
    }
    __syncthreads();
    for (int c = 0; c < cc; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xv[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) xv[j] = xs[((py + dy) * kPW + px0 + j) * kCC + c];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv =
              *reinterpret_cast<const float4*>(&ws[((dy * 3 + dx) * kCC + c) * kTK + kg * 4]);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float xin = xv[p + dx];
            acc[p][0] = fmaf(xin, wv.x, acc[p][0]);
            acc[p][1] = fmaf(xin, wv.y, acc[p][1]);
            acc[p][2] = fmaf(xin, wv.z, acc[p][2]);
            acc[p][3] = fmaf(xin, wv.w, acc[p][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = y0 + py;
  if (oy >= H) return;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int ox = x0 + px0 + p;
    if (ox >= W) continue;
    T* o = out + ((n * H + oy) * W + ox) * K;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + kg * 4 + j;
      if (k < K) o[k] = from_f<T>(fmaxf(fmaf(acc[p][j], scale[k], shift[k]), 0.0f));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* shift, void* out, int N,
           int H, int W, int C, int K, cudaStream_t stream) {
  const dim3 grid(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), (K + kTK - 1) / kTK, N);
  conv3x3_bn_relu_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(out), H, W, C, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The "mma" route (cp.async, ldmatrix, mma.sync and the TF32 split: mma.cuh)
// ---------------------------------------------------------------------------

constexpr int kBM = 128;                // output pixels per block
constexpr int kStages = 4;               // cp.async ring depth
constexpr int kRowBytes = 64;            // one A row of a step: BK channels
constexpr int kAStride = kRowBytes + 16; // padded: ldmatrix rows on distinct banks

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The tile geometry of one (T, BN) instance.
template <typename T, int BN>
struct MmaTile {
  static constexpr int kES = sizeof(T);
  static constexpr int kBK = kRowBytes / kES;               // channels per step
  // Warp tiles of kMI m16 tiles x 32 channels: 64 x 32 in bf16; 32 x 32 in
  // float32, whose split fragments would not fit 128 registers beside a
  // 64 x 32 accumulator without spills.
  static constexpr int kMI = kES == 2 ? 4 : 2;
  static constexpr int kWarpsM = kBM / (16 * kMI);
  static constexpr int kThreads = 32 * kWarpsM * (BN / 32);
  static constexpr int kMinBlocks = 512 / kThreads;          // 16 warps per SM: <= 128 registers
  static constexpr int kBStride = BN * kES + (kES == 2 ? 16 : 32);  // conflict-free rows
  static constexpr int kABytes = kBM * kAStride;
  static constexpr int kStageBytes = kABytes + kBK * kBStride;
  static constexpr int kSmem = kStages * kStageBytes;
  static constexpr int kPerChunk = 16 / kES;                 // elements per 16-byte copy
  static constexpr int kAChunks = kBM * (kRowBytes / 16) / kThreads;  // copies per thread
  static constexpr int kBRowChunks = BN * kES / 16;
  static constexpr int kBChunks = kBK * kBRowChunks / kThreads;
  static_assert(kAChunks * kThreads == kBM * (kRowBytes / 16), "A copies must tile");
  static_assert(kBChunks * kThreads == kBK * kBRowChunks, "B copies must tile");
  static_assert(kStageBytes % 16 == 0, "stages must stay 16-byte aligned");
};

template <typename T, int BN>
__global__ void __launch_bounds__(MmaTile<T, BN>::kThreads, MmaTile<T, BN>::kMinBlocks)
conv3x3_bn_relu_kernel_mma(const T* __restrict__ x, const T* __restrict__ w,
                           const float* __restrict__ scale, const float* __restrict__ shift,
                           T* __restrict__ out, int M, int H, int W, int C, int K,
                           int k_tiles) {
  using G = MmaTile<T, BN>;
  constexpr int kThr = G::kThreads, kBK = G::kBK, kBStride = G::kBStride;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  constexpr int kMI = G::kMI;
  const int wm = warp % G::kWarpsM, wn = warp / G::kWarpsM;  // rows wm*16*kMI, cols wn*32
  const int n0 = (blockIdx.x % k_tiles) * BN;      // first output channel of the block
  const int m0 = (blockIdx.x / k_tiles) * kBM;     // first output pixel of the block

  // Copy duties of this thread, fixed over the steps. A: rows a_row0 +
  // i * kThr / 4, the 16-byte chunk a_chunk of each, with the pixel a_m[i]
  // and a_taps[i], bit dy*3+dx set where tap (dy, dx) of the pixel lies in
  // the image (none for a row past M); B: chunks tid + i * kThr.
  const int a_chunk = tid & 3, a_row0 = tid >> 2;
  int a_m[G::kAChunks], a_taps[G::kAChunks];
#pragma unroll
  for (int i = 0; i < G::kAChunks; ++i) {
    const int m = m0 + a_row0 + i * (kThr / 4);
    const int yx = m % (H * W), y = yx / W, xx = yx % W;
    const int rows = (y > 0 ? 1 : 0) | 2 | (y < H - 1 ? 4 : 0);
    const int cols = (xx > 0 ? 1 : 0) | 2 | (xx < W - 1 ? 4 : 0);
    a_m[i] = m;
    a_taps[i] = 0;
#pragma unroll
    for (int t = 0; t < 9; ++t)
      if (m < M && (rows >> (t / 3) & 1) && (cols >> (t % 3) & 1)) a_taps[i] |= 1 << t;
  }
  const int n_cchunks = (C + kBK - 1) / kBK;
  const int n_steps = 9 * n_cchunks;

  auto load_stage = [&](int step, int slot) {
    const int tap = step / n_cchunks;
    const int c0 = (step - tap * n_cchunks) * kBK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const uint32_t sa = smem_base + slot * G::kStageBytes, sb = sa + G::kABytes;
    const int c = c0 + a_chunk * G::kPerChunk;
    const int shift_px = dy * W + dx;
#pragma unroll
    for (int i = 0; i < G::kAChunks; ++i) {
      const bool ok = c < C && (a_taps[i] >> tap & 1);
      cp_async16(sa + (a_row0 + i * (kThr / 4)) * kAStride + a_chunk * 16,
                 ok ? x + ((ptrdiff_t)a_m[i] + shift_px) * C + c : x, ok);
    }
#pragma unroll
    for (int i = 0; i < G::kBChunks; ++i) {
      const int id = tid + i * kThr;
      const int r = id / G::kBRowChunks, cj = id % G::kBRowChunks;
      const int col = n0 + cj * G::kPerChunk;
      const bool ok = c0 + r < C && col < K;
      cp_async16(sb + r * kBStride + cj * 16,
                 ok ? w + ((size_t)tap * C + c0 + r) * K + col : w, ok);
    }
  };

  float acc[kMI][4][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_stage(s, s);
    cp_async_commit();
  }

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();     // this step's stage has landed (for this thread)
    __syncthreads();                  // ... for every thread; the slot refilled below is free
    const int next = step + kStages - 1;
    if (next < n_steps) load_stage(next, next % kStages);
    cp_async_commit();

    const int slot = step % kStages;
    const uint32_t sa = smem_base + slot * G::kStageBytes, sb = sa + G::kABytes;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t b[4][2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t r[4];
          ldsm_x4_trans(r, sb + (kk + (lane & 15)) * kBStride +
                               (wn * 32 + p * 16 + (lane >> 4) * 8) * 2);
          b[2 * p][0] = r[0];
          b[2 * p][1] = r[1];
          b[2 * p + 1][0] = r[2];
          b[2 * p + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          uint32_t a[4];
          ldsm_x4(a, sa + (wm * 16 * kMI + mi * 16 + (lane & 15)) * kAStride +
                         (kk + (lane >> 4) * 8) * 2);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a, b[ni]);
        }
      }
    } else {
      // The tensor cores truncate as they add into an accumulator, so ~1 ulp
      // of the running sum per mma would pile up over 3 * 9C / 8 of them
      // (~3e-4 at C = 512). The three passes of each 8-channel slice and
      // m-tile sum into a fresh partial, added to acc with round-to-nearest
      // FADDs.
      const float* bs = reinterpret_cast<const float*>(smem + slot * G::kStageBytes + G::kABytes);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        uint32_t b_big[4][2], b_small[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = wn * 32 + ni * 8 + g;
          split_tf32(bs[(kk + tig) * (kBStride / 4) + col], b_big[ni][0], b_small[ni][0]);
          split_tf32(bs[(kk + tig + 4) * (kBStride / 4) + col], b_big[ni][1], b_small[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          uint32_t r[4], a_big[4], a_small[4];
          ldsm_x4(r, sa + (wm * 16 * kMI + mi * 16 + (lane & 15)) * kAStride +
                         (kk + (lane >> 4) * 4) * 4);
#pragma unroll
          for (int j = 0; j < 4; ++j) split_tf32(__uint_as_float(r[j]), a_big[j], a_small[j]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_tf32(part, a_small, b_big[ni]);
            mma_tf32(part, a_big, b_small[ni]);
            mma_tf32(part, a_big, b_big[ni]);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[mi][ni][j] += part[j];
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + tig * 2;
    if (col >= K) continue;                   // K % 8 == 0: a pair is all in or all out
    const float s0 = scale[col], s1 = scale[col + 1], h0 = shift[col], h1 = shift[col + 1];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 16 * kMI + mi * 16 + g + half * 8;
        if (m >= M) continue;
        store_pair(out + (size_t)m * K + col,
                   fmaxf(fmaf(acc[mi][ni][2 * half], s0, h0), 0.0f),
                   fmaxf(fmaf(acc[mi][ni][2 * half + 1], s1, h1), 0.0f));
      }
    }
  }
}

template <typename T, int BN>
int launch_mma(const void* x, const void* w, const void* scale, const void* shift, void* out,
               int N, int H, int W, int C, int K, cudaStream_t stream) {
  using G = MmaTile<T, BN>;
  const long long M = (long long)N * H * W;
  const int k_tiles = (K + BN - 1) / BN;
  const long long blocks = (M + kBM - 1) / kBM * k_tiles;
  if (M + kBM > INT_MAX || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  auto* kernel = conv3x3_bn_relu_kernel_mma<T, BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, G::kThreads, G::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(out), (int)M, H, W, C, K, k_tiles);
  return (int)cudaGetLastError();
}

// Float32 always on 64-channel tiles (8 warps of 32 x 32); bf16 on 64-channel
// tiles (4 warps) for K <= 64, else on 128-channel tiles (8 warps of 64 x 32).
template <typename T>
int launch_mma_for(const void* x, const void* w, const void* scale, const void* shift, void* out,
                   int N, int H, int W, int C, int K, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (K > 64) return launch_mma<T, 128>(x, w, scale, shift, out, N, H, W, C, K, stream);
  }
  return launch_mma<T, 64>(x, w, scale, shift, out, N, H, W, C, K, stream);
}

}  // namespace

extern "C" {

// The "direct" route. x [N, H, W, C] and w [3, 3, C, K] (HWIO) of type float
// (bf16 == 0) or bfloat16 (bf16 != 0); scale, shift [K] float32; out
// [N, H, W, K] of x's type. All contiguous on card `device`. N <= 65535.
// Launches on `stream`; returns the cudaError_t of the launch.
int conv3x3_bn_relu(const void* x, const void* w, const void* scale, const void* shift,
                    void* out, int N, int H, int W, int C, int K, int bf16, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto* st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, w, scale, shift, out, N, H, W, C, K, st);
  return launch<float>(x, w, scale, shift, out, N, H, W, C, K, st);
}

// The "mma" route: the same arguments, with C % 16 == 0, K % 8 == 0, x and w
// 16-byte aligned, and N * H * W below 2^31 - 128 (cudaErrorInvalidValue
// otherwise).
int conv3x3_bn_relu_mma(const void* x, const void* w, const void* scale, const void* shift,
                        void* out, int N, int H, int W, int C, int K, int bf16, int device,
                        void* stream) {
  if (C % 16 != 0 || K % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto* st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_mma_for<__nv_bfloat16>(x, w, scale, shift, out, N, H, W, C, K, st);
  return launch_mma_for<float>(x, w, scale, shift, out, N, H, W, C, K, st);
}

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
