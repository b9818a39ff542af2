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
// __nv_bfloat16 (bf16 mode): x, w and the output are of type T, the products
// and sums float32, so in bf16 mode the output is rounded to bf16 once, as the
// TPU kernel's is.
//
// Design (a direct convolution, simple first):
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
//  - Products float32 on the CUDA cores (no tensor cores, no cp.async or TMA
//    pipelining in this version).
//
// Bounds on an H100 SXM for VGG16's 13 layers at N = 80 frames (224 x 224
// input): 2*N*H*W*9*C*K summed over the layers = 2.46 TFLOP -> ~36.8 ms at
// the 67 TFLOP/s float32 peak, ~2.5 ms at the 989 TFLOP/s bf16 tensor-core
// peak; the activations and weights, each read or written once, are ~7.3 GB
// in float32 -> ~2.2 ms. The operations set the bound.
//  chip_smoke.py recomputes these figures from the shapes it runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

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

}  // namespace

extern "C" {

// x [N, H, W, C] and w [3, 3, C, K] (HWIO) of type float (bf16 == 0) or
// bfloat16 (bf16 != 0); scale, shift [K] float32; out [N, H, W, K] of x's
// type. All contiguous on card `device`. N <= 65535. Launches on `stream`;
// returns the cudaError_t of the launch.
int conv3x3_bn_relu(const void* x, const void* w, const void* scale, const void* shift,
                    void* out, int N, int H, int W, int C, int K, int bf16, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto* st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, w, scale, shift, out, N, H, W, C, K, st);
  return launch<float>(x, w, scale, shift, out, N, H, W, C, K, st);
}

// Message for a cudaError_t returned above.
const char* s2vt_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
