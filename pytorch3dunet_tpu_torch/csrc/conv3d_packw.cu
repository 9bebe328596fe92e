// 3x3x3 stride-1 pad-1 convolution for Hopper (sm_90a), in the packed-weight
// formulation; it carries the conv's input gradient in training.
//
// Replaces pytorch3dunet_tpu/ops/conv_pallas.py `_fwd_kernel_packw` (variant
// "packw" of its `conv3d_fwd`) and keeps its contract:
//   x (N, D, H, W, C) channels-last, w (3, 3, 3, C, F), b (F,) or null
//   -> y (N, D, H, W, F) in x's dtype; f32 accumulation; bias added in the epilogue.
// The input gradient of a 3x3x3 pad-1 conv is this conv run on dy with the
// taps flipped and C and F swapped, so the wrapper (ops/conv3d.py
// `conv3d_input_grad`) calls it with w~[a,b,e,f,c] = w[2-a,2-b,2-e,c,f] and no bias.
//
// Design (K3's GEMM, one block per output tile):
// - A block owns one output plane d, a kTH x kTW output tile and kBF output
//   features. For each depth tap kd it reads input plane d+kd-1 over a tile
//   two columns wider than the output (kTW+2 = 32: lane i of every warp owns
//   wide column i).
// - Per kd the block runs one GEMM z = P . Wp, walking C in chunks of kCK:
//     P[(r, j'), (kh, c)]  = x[d+kd-1, h0+r+kh-1, w0+j'-1, c]   K = 3C
//     Wp[(kh, c), (kw, f)] = w[kd, kh, kw, c, f]                N = 3 kBF
//   Each chunk stages the (kTH+2) x 32 x kCK input rows (zero outside the
//   volume) and the 3 x kCK x 3 x kBF weight slice in shared memory as f32.
//   Warp g owns features 4g..4g+3 in all three kw columns; every thread
//   accumulates an 8 row x 12 column micro-tile of z in registers.
// - The kw shift is the f32 epilogue of each kd, through a per-warp buffer in
//   shared memory: out[r, j, f] += z[r, j+kw, (kw, f)]. Wide columns 30 and 31
//   only feed the shift.
// - kd is a loop inside the block. The TPU kernel's f32 ring that carried
//   partial sums across a sequential grid of depth planes has no counterpart:
//   blocks run in parallel, each over its own output plane. Nor do the Pallas
//   wrapper's WP/CP padding and its M+8 sublane rows: there is no padded copy of
//   x in HBM, and any D, H, W >= 1 works.
//
// What bounds it on the H100: f32 FFMA on the CUDA cores (67 TFLOP/s dense
// peak on the SXM part), 32 of every 30 columns computed (the two shift
// columns), and staging that is not overlapped with compute (ptxas gives 250
// registers a thread, so one 256-thread block per SM). The GEMM's depth K = 3C is a multiple of 16
// at every dgrad shape of the UNet (C = 32..256), which is what a later design
// feeds to wgmma in bf16 from a TMA-fed shared-memory ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 8;           // output rows per block; every thread covers all of them
constexpr int kXW = 32;          // wide tile columns, one per lane
constexpr int kTW = kXW - 2;     // output columns per block
constexpr int kFT = 4;           // output features per warp
constexpr int kBF = kWarps * kFT;  // output features per block
constexpr int kCK = 16;          // input channels per shared-memory stage
constexpr int kXH = kTH + 2;
// channel stride of the staged rows, padded by one word so that the staging
// stores of consecutive channels fall in different banks
constexpr int kXC = kXH * kXW + 1;
constexpr int kXElems = kCK * kXC;
constexpr int kWElems = 3 * kCK * 3 * kBF;  // [kh][c][kw][f]
constexpr int kEStride = kXW + 2;           // epilogue row: lanes 30, 31 read two past the warp
constexpr int kEElems = kWarps * 2 * kFT * kEStride;
constexpr int kSmemBytes = (kWElems + kXElems + kEElems) * static_cast<int>(sizeof(float));
static_assert(kWElems % 4 == 0, "the staged rows stay 16-byte aligned after the weights");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_packw_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                    T* __restrict__ y, int D, int H, int W, int C, int F, int tiles_w, int f_blocks) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [3 kh][kCK][3 kw][kBF]
  float* xs = ws + kWElems;                     // [kCK][kXH][kXW], channel stride kXC
  float* es = xs + kXElems;                     // [kWarps][2 kw][kFT][kEStride]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  float* ebuf = es + warp * 2 * kFT * kEStride;

  const int h0 = (blockIdx.x / tiles_w) * kTH;
  const int w0 = (blockIdx.x % tiles_w) * kTW;
  const int d = blockIdx.y;
  const int n = blockIdx.z / f_blocks;
  const int f0 = (blockIdx.z % f_blocks) * kBF;

  float out[kTH][kFT];
#pragma unroll
  for (int r = 0; r < kTH; ++r)
#pragma unroll
    for (int t = 0; t < kFT; ++t) out[r][t] = 0.f;

#pragma unroll 1
  for (int kd = 0; kd < 3; ++kd) {
    const int zd = d + kd - 1;
    if (zd < 0 || zd >= D) continue;  // the same for the whole block

    float z[kTH][3][kFT];
#pragma unroll
    for (int r = 0; r < kTH; ++r)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int t = 0; t < kFT; ++t) z[r][kw][t] = 0.f;

    for (int c0 = 0; c0 < C; c0 += kCK) {
      // input rows of plane zd; consecutive threads read consecutive channels
      for (int e = tid; e < kCK * kXH * kXW; e += kThreads) {
        const int c = e % kCK;
        const int r = e / kCK;
        const int jw = r % kXW;
        const int hh = r / kXW;
        const int yh = h0 + hh - 1;
        const int xw = w0 + jw - 1;
        const int ch = c0 + c;
        float v = 0.f;
        if (yh >= 0 && yh < H && xw >= 0 && xw < W && ch < C) {
          const int64_t voxel = ((static_cast<int64_t>(n) * D + zd) * H + yh) * static_cast<int64_t>(W) + xw;
          v = to_f32(x[voxel * C + ch]);
        }
        xs[c * kXC + hh * kXW + jw] = v;
      }
      // packed weight slice of depth tap kd; e == ((kh * kCK + c) * 3 + kw) * kBF + f
      for (int e = tid; e < kWElems; e += kThreads) {
        const int f = e % kBF;
        int r = e / kBF;
        const int kw = r % 3;
        r /= 3;
        const int c = r % kCK;
        const int kh = r / kCK;
        float v = 0.f;
        if (c0 + c < C && f0 + f < F)
          v = to_f32(w[(static_cast<int64_t>((kd * 3 + kh) * 3 + kw) * C + c0 + c) * F + f0 + f]);
        ws[e] = v;
      }
      __syncthreads();

      // z[(r, lane), (kw, warp's features)] += P[(r, lane), (kh, c)] * Wp[(kh, c), (kw, f)]
#pragma unroll 1
      for (int kh = 0; kh < 3; ++kh) {
        const float* xrow = xs + kh * kXW + lane;
        const float* wrow = ws + kh * kCK * 3 * kBF + warp * kFT;
#pragma unroll
        for (int c = 0; c < kCK; ++c) {
          float a[kTH];
#pragma unroll
          for (int r = 0; r < kTH; ++r) a[r] = xrow[c * kXC + r * kXW];
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const float4 bv = *reinterpret_cast<const float4*>(wrow + (c * 3 + kw) * kBF);
#pragma unroll
            for (int r = 0; r < kTH; ++r) {
              z[r][kw][0] = fmaf(a[r], bv.x, z[r][kw][0]);
              z[r][kw][1] = fmaf(a[r], bv.y, z[r][kw][1]);
              z[r][kw][2] = fmaf(a[r], bv.z, z[r][kw][2]);
              z[r][kw][3] = fmaf(a[r], bv.w, z[r][kw][3]);
            }
          }
        }
      }
      __syncthreads();
    }

    // kw-shift epilogue: out[r, j] += z[r, j, kw 0] + z[r, j+1, kw 1] + z[r, j+2, kw 2];
    // the neighbours' columns come through this warp's buffer
#pragma unroll
    for (int r = 0; r < kTH; ++r) {
#pragma unroll
      for (int t = 0; t < kFT; ++t) {
        ebuf[t * kEStride + lane] = z[r][1][t];
        ebuf[(kFT + t) * kEStride + lane] = z[r][2][t];
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kFT; ++t)
        out[r][t] += z[r][0][t] + ebuf[t * kEStride + lane + 1] + ebuf[(kFT + t) * kEStride + lane + 2];
      __syncwarp();
    }
  }

  const int xw = w0 + lane;
  if (lane >= kTW || xw >= W) return;
  float bias[kFT];
#pragma unroll
  for (int t = 0; t < kFT; ++t) {
    const int f = f0 + warp * kFT + t;
    bias[t] = (b != nullptr && f < F) ? to_f32(b[f]) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kTH; ++r) {
    const int yh = h0 + r;
    if (yh >= H) continue;
    const int64_t voxel = ((static_cast<int64_t>(n) * D + d) * H + yh) * static_cast<int64_t>(W) + xw;
    T* dst = y + voxel * F;
#pragma unroll
    for (int t = 0; t < kFT; ++t) {
      const int f = f0 + warp * kFT + t;
      if (f < F) dst[f] = from_f32<T>(out[r][t] + bias[t]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int64_t N, int64_t D, int64_t H, int64_t W,
           int64_t C, int64_t F, void* stream) {
  if (N <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0) return cudaErrorInvalidValue;
  const int64_t tiles_w = (W + kTW - 1) / kTW;
  const int64_t tiles_h = (H + kTH - 1) / kTH;
  const int64_t f_blocks = (F + kBF - 1) / kBF;
  if (tiles_w * tiles_h > INT_MAX || D > 65535 || N * f_blocks > 65535 || H > INT_MAX || W > INT_MAX ||
      C > INT_MAX || F > INT_MAX)
    return cudaErrorInvalidValue;
  auto kernel = conv3d_packw_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(tiles_w * tiles_h), static_cast<unsigned>(D),
                  static_cast<unsigned>(N * f_blocks));
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<int>(D), static_cast<int>(H), static_cast<int>(W), static_cast<int>(C), static_cast<int>(F),
      static_cast<int>(tiles_w), static_cast<int>(f_blocks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. All tensors are contiguous on the
// current device; b may be null (no bias). The return value is the cudaError_t
// of the launch (0 = ok).
extern "C" int conv3d_packw_f32(const void* x, const void* w, const void* b, void* y, int64_t N, int64_t D,
                                int64_t H, int64_t W, int64_t C, int64_t F, void* stream) {
  return launch<float>(x, w, b, y, N, D, H, W, C, F, stream);
}

extern "C" int conv3d_packw_bf16(const void* x, const void* w, const void* b, void* y, int64_t N, int64_t D,
                                 int64_t H, int64_t W, int64_t C, int64_t F, void* stream) {
  return launch<__nv_bfloat16>(x, w, b, y, N, D, H, W, C, F, stream);
}

extern "C" const char* conv3d_packw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block, for the build report.
extern "C" int conv3d_packw_smem_bytes() { return kSmemBytes; }
