// 3x3x3 stride-1 pad-1 convolution for Hopper (sm_90a) on the tensor cores, as
// a straight 27-tap implicit GEMM; it carries the conv's input gradient in
// training.
//
// Replaces pytorch3dunet_tpu/ops/conv_pallas.py `_fwd_kernel_packw` (:218, its
// wrapper :275 and `pallas_call` :289; variant "packw" of its `conv3d_fwd`) and
// keeps its contract:
//   x (N, D, H, W, C) channels-last, w (3, 3, 3, C, F), b (F,) or null
//   -> y (N, D, H, W, F) in x's dtype; f32 accumulation; bias added in the epilogue.
// The input gradient of a 3x3x3 pad-1 conv is this conv run on dy with the
// taps flipped and C and F swapped, so the wrapper (ops/conv3d.py
// `conv3d_input_grad`) calls it with w~[a,b,e,f,c] = w[2-a,2-b,2-e,c,f] and no bias.
//
// Design (the tensor-core core is conv3d_tc.cuh; see its note for the operands,
// the brick and the 3xTF32 split):
// - A block owns one output plane d, 256 output pixels of it (a tile of
//   256 / BW rows x BW - 2 columns; each warpgroup 128 of them as two m64n64
//   accumulators sharing one A fragment) and 64 output features. It walks the
//   depth taps kd whose input plane d+kd-1 lies in the volume, and for each the
//   32-byte channel chunks: one staged brick serves the 9 in-plane taps, so the
//   GEMM is y^T[f, pixel] = sum over (kd, kh, kw, c) of w[kd, kh, kw, c, f] x[..]
//   with K = 27C and no epilogue but the bias.
// - Why not the TPU kernel's packing (K = 3C with kh folded, N = 9F with kd and
//   kw folded, then a kw shift in f32): on the TPU it makes one large MXU
//   matmul per plane out of a lane-dense weight slab. Here the brick already
//   gives every (kh, kw) tap as a shifted descriptor for free, so the packing
//   would only add a shift epilogue through shared memory and 3x the
//   accumulators (the input gradients' F = 32 to 512 outputs by 256 pixels at
//   three kw columns do not fit the 255 registers a thread has). K3 keeps the
//   function, not the packing.
// - Blocks run in parallel, each over its own output plane; the TPU kernel's
//   f32 ring across a sequential depth grid has no counterpart, nor do the
//   Pallas wrapper's WP/CP padding and its M+8 sublane rows: out-of-range taps,
//   pixels, channels and features are zero-filled while staging or dropped at
//   the store, and any D, H, W >= 1 and any C, F work (dx of a first conv has
//   F = 1: one feature row of the m64 tile is kept, the rest are zeros).
//
// What bounds it on the H100 (SXM, 700 W): the tensor cores. f32 issues three
// TF32 products per MAC (3xTF32 at 495 TFLOP/s dense), bf16 one (989 TFLOP/s).
// The 14 input gradients of one 80x170x170 UNet3D train step are 1.041 TFLOP:
// 6.3 ms of 3xTF32 MMAs at full use of the m64 tile (15.6 ms at the 67 TFLOP/s
// FFMA rate of the kernel this one replaced). What the design does about it: a
// 4-stage cp.async ring (41,728 bytes a stage in f32: the brick, its lo part
// and 9 x 8 x 64 weights) keeps three chunks in flight during the MMAs, and the
// A fragments of tap + 1 are loaded and split while the 6 wgmmas of tap run.
// What holds it back: dx with fewer than 64 channels (C = 1, 16 and 32 at
// levels 0-1, 14.3 of the step's 33.8 ms) leaves rows of the m64 tile empty:
// the MMAs issued for the whole step are 1.6x the useful ones; and one block of
// two warpgroups per SM (166,912 bytes of shared memory in f32).
// ptxas (sm_90a): 184 registers in f32, 170 in bf16, no spills; ptxas adds a
// warpgroup wait where the chunk's sums are read.
// Measured (chip_smoke.py phase 8; NVIDIA H100 80GB HBM3, 700.00 W): those 14
// input gradients in 33.8 ms f32 (0.7-53 TFLOP/s by shape), against 39.6 ms for
// one cuDNN F.conv3d each on the flipped weights; details in PERF.md.

#include "conv3d_tc.cuh"

#include <climits>
#include <cstdint>

namespace {

using namespace tc;

constexpr int kPix = 256;    // output pixels per block, 128 per warpgroup
constexpr int kStages = 4;
constexpr int kBP = 328;     // brick pixels: (TH + 2) * BW + 2 = 322 (BW 32) or 290 (BW 16)
static_assert(kBP % 8 == 0 && kBP >= (kPix / 32 + 2) * 32 + 2 && kBP >= (kPix / 16 + 2) * 16 + 2, "brick fits");

template <typename T>
constexpr int kStageBytes = stage_bytes<T>(kBP, 1);
constexpr int kLoOff = kChunkBytes * kBP;  // f32: the brick's lo part
template <typename T>
constexpr int kWOff = weights_offset<T>(kBP);
template <typename T>
constexpr int kSmemBytes = kStages * kStageBytes<T>;
static_assert(kSmemBytes<float> <= 232448 && kSmemBytes<__nv_bfloat16> <= 232448, "fits one SM");

// acc[j] += W . brick(pixels pix0 + 64 j) over the 9 taps of one staged chunk
template <typename T>
__device__ __forceinline__ void compute_stage(float (&acc)[2][32], const char* stage, int pix0, int bw, int r0,
                                              int t) {
  float d[2][32];
  zero(d[0]);
  zero(d[1]);
  chunk_mma<T, 2, kLoOff, 16 * kBP>(d, stage + kWOff<T>, 0, smem_u32(stage) + pix0 * 16, bw, r0, t);
  add_to(acc[0], d[0]);
  add_to(acc[1], d[1]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_packw_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b, T* __restrict__ y,
                    int D, int H, int W, int C, int F, int f_blocks, int tiles_w, int bw, int piece_x, int piece_w) {
  extern __shared__ __align__(128) char smem[];
  constexpr int kCK = chunk_channels<T>();
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wq = (tid / 32) % 4;
  const int pix0 = 128 * (tid / 128);
  const int r0 = 16 * wq + lane / 4;
  const int t = lane % 4;

  const int th = kPix / bw;
  const Brick br{static_cast<int>(blockIdx.x / tiles_w) * th, static_cast<int>(blockIdx.x % tiles_w) * (bw - 2), bw,
                 th, kBP};
  const int d = blockIdx.y;
  const int n = blockIdx.z / f_blocks;
  const int f0 = (blockIdx.z % f_blocks) * kBM;
  // depth taps whose input plane d + kd - 1 is inside the volume
  const int kd_first = d == 0 ? 1 : 0;
  const int kd_last = d == D - 1 ? 1 : 2;
  const int nch = (C + kCK - 1) / kCK;
  const int total = (kd_last - kd_first + 1) * nch;

  auto issue = [&](int s) {
    if (s < total) {
      const int kd = kd_first + s / nch;
      const int c0 = (s % nch) * kCK;
      char* st = smem + (s % kStages) * kStageBytes<T>;
      load_brick<T>(st, x, static_cast<int64_t>(n) * D + d + kd - 1, H, W, C, c0, br, piece_x, tid);
      load_weights<T>(st + kWOff<T>, w, C, F, c0, f0, 1 << kd, true, piece_w, tid);
    }
    cp_async_commit();
  };

  float acc[2][32];
  zero(acc[0]);
  zero(acc[1]);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
#pragma unroll 1
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();
    char* st = smem + (s % kStages) * kStageBytes<T>;
    if constexpr (Elem<T>::kSplit) split_brick(st, kLoOff, br, tid);
    fence_async_smem();
    __syncthreads();
    issue(s + kStages - 1);
    compute_stage<T>(acc, st, pix0, bw, r0, t);
  }
  cp_async_wait<0>();

  const int64_t plane = static_cast<int64_t>(n) * D + d;
  store_tile<T>(y, acc[0], b, plane, H, W, F, f0, pix0, br, wq, lane);
  store_tile<T>(y, acc[1], b, plane, H, W, F, f0, pix0 + 64, br, wq, lane);
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int64_t N, int64_t D, int64_t H, int64_t W,
           int64_t C, int64_t F, void* stream) {
  if (N <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0) return cudaErrorInvalidValue;
  const int bw = brick_width(W);
  const int64_t tiles_w = (W + bw - 3) / (bw - 2);
  const int64_t tiles = tiles_w * ((H + kPix / bw - 1) / (kPix / bw));
  const int64_t f_blocks = (F + kBM - 1) / kBM;
  if (N * D * H * W > INT_MAX || tiles > INT_MAX || D > 65535 || N * f_blocks > 65535 || C > INT_MAX ||
      F > INT_MAX)
    return cudaErrorInvalidValue;
  auto kernel = conv3d_packw_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<T>);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(D), static_cast<unsigned>(N * f_blocks));
  kernel<<<grid, kThreads, kSmemBytes<T>, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<int>(D), static_cast<int>(H), static_cast<int>(W), static_cast<int>(C), static_cast<int>(F),
      static_cast<int>(f_blocks), static_cast<int>(tiles_w), bw, piece_bytes(C, Elem<T>::kSize),
      piece_bytes(F, Elem<T>::kSize));
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

// Dynamic shared memory of one block (f32), for the build report.
extern "C" int conv3d_packw_smem_bytes() { return kSmemBytes<float>; }
