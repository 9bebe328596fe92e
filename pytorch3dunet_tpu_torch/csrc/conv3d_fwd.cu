// Fused 3x3x3 stride-1 pad-1 convolution forward for Hopper (sm_90a).
//
// Replaces pytorch3dunet_tpu/ops/conv_pallas.py `_fwd_kernel_roll` (the default
// variant of its `conv3d_fwd`) and keeps its contract:
//   x (N, D, H, W, C) channels-last, w (3, 3, 3, C, F), b (F,)
//   -> y (N, D, H, W, F) in x's dtype; f32 accumulation; bias added in the epilogue.
//
// Design (a direct convolution, one block per output tile):
// - A block owns 1 x TH x 32 output voxels of one depth plane and BF output
//   features. It walks C in chunks of kCK channels. Per chunk it stages the
//   halo'd input brick (3 x (TH+2) x 34 x kCK) and the weights of all 27 taps
//   (27 x kCK x BF) in shared memory as f32, then every thread accumulates an
//   8 voxel x 8 feature micro-tile in registers over the 27 taps.
// - Out-of-range taps are masked to zero while staging, so no padded copy of x
//   is made and any D, H, W >= 1 works (the Pallas wrapper pads x in HBM and needs
//   an H tile that divides H). The block loops over the three depth taps itself:
//   the TPU kernel's f32 ring that carried partial sums across a sequential
//   depth grid has no counterpart here, since blocks run in parallel.
// - Lane i of a warp owns output column i, so shared-memory reads of x are
//   consecutive words; all lanes of a warp share one feature group, so weight
//   reads are broadcasts.
//
// What bounds it on the H100: f32 FFMA on the CUDA cores (67 TFLOP/s dense peak
// on the SXM part); no tensor cores are used yet, and the staging of each chunk
// is not overlapped with compute. A later design runs the same implicit GEMM
// (M = voxels, N = F, K = 27 C) on wgmma in bf16 with a TMA-fed shared-memory
// ring and a producer warp, which is where the K = 9C and K = 3C tilings of the
// other two TPU variants (im2col, packw) fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCK = 8;   // input channels per shared-memory stage
constexpr int kTW = 32;  // output tile width: one warp lane per column
constexpr int kVM = 8;   // output voxels per thread
constexpr int kVF = 8;   // output features per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

template <int BF>
struct Tile {
  static constexpr int kFG = BF / kVF;         // feature groups per block
  static constexpr int kTMG = kThreads / kFG;  // threads per feature group
  static constexpr int kHStep = kTMG / kTW;    // rows between one thread's voxels
  static constexpr int kTH = kVM * kHStep;     // output tile height
  static constexpr int kXH = kTH + 2;
  static constexpr int kXW = kTW + 2;
  static constexpr int kXPlane = kXH * kXW;
  static constexpr int kWElems = 27 * kCK * BF;
  static constexpr int kXElems = 3 * kCK * kXPlane;
  static constexpr int kSmemBytes = (kWElems + kXElems) * static_cast<int>(sizeof(float));
  static_assert(kTMG % kTW == 0, "a feature group spans whole warps");
  static_assert(kWElems % 4 == 0, "x brick stays 16-byte aligned after the weights");
};

template <typename T, int BF>
__global__ void __launch_bounds__(kThreads, 2)
conv3d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                  T* __restrict__ y, int D, int H, int W, int C, int F, int tiles_w, int f_blocks) {
  using L = Tile<BF>;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [27][kCK][BF]
  float* xs = ws + L::kWElems;                  // [3][kCK][kXH][kXW]

  const int tid = threadIdx.x;
  const int fg = tid / L::kTMG;
  const int vg = tid % L::kTMG;
  const int col = vg % kTW;
  const int row = vg / kTW;

  const int h0 = (blockIdx.x / tiles_w) * L::kTH;
  const int w0 = (blockIdx.x % tiles_w) * kTW;
  const int d = blockIdx.y;
  const int n = blockIdx.z / f_blocks;
  const int f0 = (blockIdx.z % f_blocks) * BF;

  float acc[kVM][kVF];
#pragma unroll
  for (int i = 0; i < kVM; ++i)
#pragma unroll
    for (int j = 0; j < kVF; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCK) {
    // halo'd input brick; consecutive threads read consecutive channels
    for (int e = tid; e < L::kXElems; e += kThreads) {
      const int c = e % kCK;
      int r = e / kCK;
      const int ww = r % L::kXW;
      r /= L::kXW;
      const int hh = r % L::kXH;
      const int kd = r / L::kXH;
      const int zd = d + kd - 1;
      const int yh = h0 + hh - 1;
      const int xw = w0 + ww - 1;
      const int ch = c0 + c;
      float v = 0.f;
      if (zd >= 0 && zd < D && yh >= 0 && yh < H && xw >= 0 && xw < W && ch < C) {
        const int64_t voxel = ((static_cast<int64_t>(n) * D + zd) * H + yh) * static_cast<int64_t>(W) + xw;
        v = to_f32(x[voxel * C + ch]);
      }
      xs[(kd * kCK + c) * L::kXPlane + hh * L::kXW + ww] = v;
    }
    // weights of all 27 taps for this channel chunk; e == (tap * kCK + c) * BF + f
    for (int e = tid; e < L::kWElems; e += kThreads) {
      const int f = e % BF;
      const int r = e / BF;
      const int c = r % kCK;
      const int tap = r / kCK;
      float v = 0.f;
      if (c0 + c < C && f0 + f < F) v = to_f32(w[(static_cast<int64_t>(tap) * C + c0 + c) * F + f0 + f]);
      ws[e] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int kd = 0; kd < 3; ++kd) {
#pragma unroll 1
      for (int kh = 0; kh < 3; ++kh) {
        const float* xrow = xs + kd * kCK * L::kXPlane + (row + kh) * L::kXW + col;
        const float* wrow = ws + (kd * 3 + kh) * 3 * kCK * BF + fg * kVF;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
          for (int c = 0; c < kCK; ++c) {
            const float4 b0 = *reinterpret_cast<const float4*>(wrow + (kw * kCK + c) * BF);
            const float4 b1 = *reinterpret_cast<const float4*>(wrow + (kw * kCK + c) * BF + 4);
            const float bv[kVF] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < kVM; ++i) {
              const float a = xrow[c * L::kXPlane + i * L::kHStep * L::kXW + kw];
#pragma unroll
              for (int j = 0; j < kVF; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  float bias[kVF];
#pragma unroll
  for (int j = 0; j < kVF; ++j) {
    const int f = f0 + fg * kVF + j;
    bias[j] = f < F ? to_f32(b[f]) : 0.f;
  }
  const int xw = w0 + col;
  if (xw >= W) return;
#pragma unroll
  for (int i = 0; i < kVM; ++i) {
    const int yh = h0 + row + i * L::kHStep;
    if (yh >= H) continue;
    const int64_t voxel = ((static_cast<int64_t>(n) * D + d) * H + yh) * static_cast<int64_t>(W) + xw;
    T* out = y + voxel * F;
#pragma unroll
    for (int j = 0; j < kVF; ++j) {
      const int f = f0 + fg * kVF + j;
      if (f < F) out[f] = from_f32<T>(acc[i][j] + bias[j]);
    }
  }
}

template <typename T, int BF>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int64_t N, int64_t D, int64_t H,
                   int64_t W, int64_t C, int64_t F, cudaStream_t stream) {
  using L = Tile<BF>;
  if (N <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0) return cudaErrorInvalidValue;
  const int64_t tiles_w = (W + kTW - 1) / kTW;
  const int64_t tiles_h = (H + L::kTH - 1) / L::kTH;
  const int64_t f_blocks = (F + BF - 1) / BF;
  if (tiles_w * tiles_h > INT_MAX || D > 65535 || N * f_blocks > 65535 || H > INT_MAX || W > INT_MAX ||
      C > INT_MAX || F > INT_MAX)
    return cudaErrorInvalidValue;
  auto kernel = conv3d_fwd_kernel<T, BF>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(tiles_w * tiles_h), static_cast<unsigned>(D),
                  static_cast<unsigned>(N * f_blocks));
  kernel<<<grid, kThreads, L::kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<int>(D), static_cast<int>(H), static_cast<int>(W), static_cast<int>(C), static_cast<int>(F),
      static_cast<int>(tiles_w), static_cast<int>(f_blocks));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const void* b, void* y, int64_t N, int64_t D, int64_t H, int64_t W,
             int64_t C, int64_t F, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = F <= 32 ? launch<T, 32>(x, w, b, y, N, D, H, W, C, F, s)
                                  : launch<T, 64>(x, w, b, y, N, D, H, W, C, F, s);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, bound with ctypes. All tensors are contiguous on the
// current device; the return value is the cudaError_t of the launch (0 = ok).
extern "C" int conv3d_fwd_f32(const void* x, const void* w, const void* b, void* y, int64_t N, int64_t D,
                              int64_t H, int64_t W, int64_t C, int64_t F, void* stream) {
  return dispatch<float>(x, w, b, y, N, D, H, W, C, F, stream);
}

extern "C" int conv3d_fwd_bf16(const void* x, const void* w, const void* b, void* y, int64_t N, int64_t D,
                               int64_t H, int64_t W, int64_t C, int64_t F, void* stream) {
  return dispatch<__nv_bfloat16>(x, w, b, y, N, D, H, W, C, F, stream);
}

extern "C" const char* conv3d_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
