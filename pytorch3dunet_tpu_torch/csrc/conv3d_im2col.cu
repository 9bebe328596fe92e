// 3x3x3 stride-1 pad-1 convolution forward for Hopper (sm_90a) on the tensor
// cores, in K1's formulation: the depth taps folded into the GEMM, a 3-slot
// accumulator ring across input planes.
//
// Replaces pytorch3dunet_tpu/ops/conv_pallas.py `_fwd_kernel` (:53), its wrapper
// `_conv3d_fwd_impl` (:91) and `pallas_call` (:111) (variant "im2col" of its
// `conv3d_fwd`), and keeps its contract:
//   x (N, D, H, W, C) channels-last, w (3, 3, 3, C, F), b (F,) or null
//   -> y (N, D, H, W, F) in x's dtype; f32 accumulation; bias added in the epilogue.
// In the port it is the forward of every conv with F >= 64 when P3DUNET_TAPFOLD=1
// (ops/conv3d.py), the counterpart of the JAX package's tap-folded forward.
//
// Design (the tensor-core core is conv3d_tc.cuh; see its note for the operands,
// the brick and the 3xTF32 split):
// - A block owns 128 output pixels of a plane (a tile of 128 / BW rows x BW - 2
//   columns; each warpgroup 64 of them), 64 output features, and a run of DB
//   output planes [d0, d1). It walks the input planes p = d0-1 .. d1 in order,
//   stages each one once per 32-byte channel chunk, and runs per plane
//     z[(kd, f), pixel] = sum over (kh, kw, c) of w[kd, kh, kw, c, f] x[p, pixel + (kh, kw), c]
//   i.e. K = 9C with the three depth taps kd folded into the output side. With
//   features on wgmma's M, the fold is three m64n64 accumulators per
//   warpgroup, one per kd, each fed by its own A fragment and the same brick.
// - Slot kd of plane p belongs to output plane p+1-kd. The TPU kernel's 3-slot
//   f32 ring over its sequential plane grid is these three accumulators (96
//   registers a thread): after plane p the slot of plane p-1 is complete, gets
//   the bias and is written once; the ring then rotates by register moves.
// - Slots whose output plane lies outside [d0, d1) are not issued (a template
//   mask), nor are their weights staged, so the MMAs are the direct conv's for
//   any DB; DB trades re-staging the 2 boundary planes against the number of
//   blocks (the launcher aims at about 4 blocks per SM).
// - Out-of-range taps, pixels, channels and features are zero-filled while
//   staging or dropped at the store: no padded copy of x in HBM, any D, H, W >= 1
//   and any C, F (the Pallas wrapper pads x to (8, 128) tiles and needs a
//   divisor of H).
//
// What bounds it on the H100 (SXM, 700 W): the tensor cores. f32 issues three
// TF32 products per MAC (3xTF32 at 495 TFLOP/s dense), bf16 one (989 TFLOP/s).
// The 14 K1 convs of one 112x234x234 ResidualUNet3D forward are 1.217 TFLOP:
// 7.4 ms of 3xTF32 MMAs, 1.2 ms in bf16 (18.2 ms at the 67 TFLOP/s FFMA rate
// of the kernel this one replaced). What the design does about it: a 3-stage
// cp.async ring (75,008 bytes a stage in f32: the brick, its lo part and 3 x 9
// x 8 x 64 weights) keeps the next two chunks in flight during the MMAs, and
// the A fragments of tap + 1 are loaded and split while the wgmmas of tap run.
// The three slots are issued one after the other, each summed apart and added
// to the ring (conv3d_tc.cuh `chunk_mma`). What holds it back: one block of
// two warpgroups per SM (225,024 bytes of shared memory in f32, 205,824 in
// bf16), so the tensor pipe drains at every slot's end; the weights are
// re-staged for every input plane of a 128-pixel tile, which at the 29x29 and
// 14x14 planes is as much traffic as the brick; and 1/16 of the MMAs go to
// the tile's 2 wrap columns.
// ptxas (sm_90a): 255 registers in f32, 252 in bf16, no spills.
// Measured (chip_smoke.py phase 14; NVIDIA H100 80GB HBM3, 700.00 W): those 14
// convs in 27.6 ms f32 (26-53 TFLOP/s by shape), 10.7 ms bf16, against 34.9 ms
// for one cuDNN F.conv3d each in f32; details in PERF.md.

#include "conv3d_tc.cuh"

#include <climits>
#include <cstdint>

namespace {

using namespace tc;

constexpr int kPix = 128;    // output pixels per block, 64 per warpgroup
constexpr int kStages = 3;
constexpr int kBP = 200;     // brick pixels: (TH + 2) * BW + 2 = 194 (BW 32) or 162 (BW 16)
static_assert(kBP % 8 == 0 && kBP >= (kPix / 32 + 2) * 32 + 2 && kBP >= (kPix / 16 + 2) * 16 + 2, "brick fits");

template <typename T>
constexpr int kStageBytes = stage_bytes<T>(kBP, 3);
constexpr int kLoOff = kChunkBytes * kBP;  // f32: the brick's lo part
template <typename T>
constexpr int kWOff = weights_offset<T>(kBP);
template <typename T>
constexpr int kSmemBytes = kStages * kStageBytes<T>;
static_assert(kSmemBytes<float> <= 232448 && kSmemBytes<__nv_bfloat16> <= 232448, "fits one SM");

// acc[2 - kd] += W[kd] . brick over the 9 taps of one staged chunk, for the
// slots kd set in MASK, one slot after the other
template <typename T, int MASK>
__device__ __forceinline__ void compute_stage(float (&acc)[3][32], const char* stage, int pix0, int bw, int r0,
                                              int t) {
  const uint32_t brick = smem_u32(stage) + pix0 * 16;
  float d[1][32];
#pragma unroll
  for (int kd = 0; kd < 3; ++kd) {
    if (!(MASK & (1 << kd))) continue;
    zero(d[0]);
    chunk_mma<T, 1, kLoOff, 16 * kBP>(d, stage + kWOff<T>, kd, brick, bw, r0, t);
    add_to(acc[2 - kd], d[0]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_im2col_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b, T* __restrict__ y,
                     int D, int H, int W, int C, int F, int DB, int f_blocks, int tiles_w, int bw, int piece_x,
                     int piece_w) {
  extern __shared__ __align__(128) char smem[];
  constexpr int kCK = chunk_channels<T>();
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wq = (tid / 32) % 4;
  const int pix0 = 64 * (tid / 128);
  const int r0 = 16 * wq + lane / 4;
  const int t = lane % 4;

  const int th = kPix / bw;
  const Brick br{static_cast<int>(blockIdx.x / tiles_w) * th, static_cast<int>(blockIdx.x % tiles_w) * (bw - 2), bw,
                 th, kBP};
  const int d0 = blockIdx.y * DB;
  const int d1 = min(d0 + DB, D);
  const int n = blockIdx.z / f_blocks;
  const int f0 = (blockIdx.z % f_blocks) * kBM;
  const int p_first = max(d0 - 1, 0);
  const int nch = (C + kCK - 1) / kCK;
  const int total = (min(d1, D - 1) - p_first + 1) * nch;

  // slot kd of input plane p feeds output plane p+1-kd; keep those in [d0, d1)
  auto mask_of = [&](int p) {
    int m = 0;
#pragma unroll
    for (int kd = 0; kd < 3; ++kd)
      if (p + 1 - kd >= d0 && p + 1 - kd < d1) m |= 1 << kd;
    return m;
  };
  // copies of stage s (plane p_first + s / nch, chunk s % nch) into its ring slot
  auto issue = [&](int s) {
    if (s < total) {
      const int p = p_first + s / nch;
      const int c0 = (s % nch) * kCK;
      char* st = smem + (s % kStages) * kStageBytes<T>;
      load_brick<T>(st, x, static_cast<int64_t>(n) * D + p, H, W, C, c0, br, piece_x, tid);
      load_weights<T>(st + kWOff<T>, w, C, F, c0, f0, mask_of(p), false, piece_w, tid);
    }
    cp_async_commit();
  };

  float acc[3][32];
#pragma unroll
  for (int s = 0; s < 3; ++s) zero(acc[s]);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  int s = 0;
#pragma unroll 1
  for (int p = d0 - 1; p <= d1; ++p) {
    if (p >= 0 && p < D) {
      const int mask = mask_of(p);
#pragma unroll 1
      for (int ch = 0; ch < nch; ++ch, ++s) {
        cp_async_wait<kStages - 2>();
        char* st = smem + (s % kStages) * kStageBytes<T>;
        if constexpr (Elem<T>::kSplit) split_brick(st, kLoOff, br, tid);
        fence_async_smem();
        __syncthreads();
        issue(s + kStages - 1);
        switch (mask) {
          case 1: compute_stage<T, 1>(acc, st, pix0, bw, r0, t); break;
          case 2: compute_stage<T, 2>(acc, st, pix0, bw, r0, t); break;
          case 3: compute_stage<T, 3>(acc, st, pix0, bw, r0, t); break;
          case 4: compute_stage<T, 4>(acc, st, pix0, bw, r0, t); break;
          case 6: compute_stage<T, 6>(acc, st, pix0, bw, r0, t); break;
          default: compute_stage<T, 7>(acc, st, pix0, bw, r0, t); break;
        }
      }
    }
    // slot 0 holds output plane p-1, which no later input plane reaches
    if (p - 1 >= d0 && p - 1 < d1)
      store_tile<T>(y, acc[0], b, static_cast<int64_t>(n) * D + p - 1, H, W, F, f0, pix0, br, wq, lane);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[0][i] = acc[1][i];
      acc[1][i] = acc[2][i];
      acc[2][i] = 0.f;
    }
  }
  cp_async_wait<0>();
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int64_t N, int64_t D, int64_t H, int64_t W,
           int64_t C, int64_t F, void* stream) {
  if (N <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0) return cudaErrorInvalidValue;
  const int bw = brick_width(W);
  const int64_t tiles_w = (W + bw - 3) / (bw - 2);
  const int64_t tiles = tiles_w * ((H + kPix / bw - 1) / (kPix / bw));
  const int64_t f_blocks = (F + kBM - 1) / kBM;
  if (N * D * H * W > INT_MAX || tiles > INT_MAX || N * f_blocks > 65535 || C > INT_MAX || F > INT_MAX)
    return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // the longest runs of planes that still give about 4 blocks per SM
  const int64_t per_plane = tiles * N * f_blocks;
  int64_t db = (D * per_plane) / (4 * static_cast<int64_t>(sms));
  db = db < 1 ? 1 : (db > D ? D : db);
  const int64_t d_blocks = (D + db - 1) / db;
  db = (D + d_blocks - 1) / d_blocks;
  if (d_blocks > 65535) return cudaErrorInvalidValue;
  auto kernel = conv3d_im2col_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<T>);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(d_blocks), static_cast<unsigned>(N * f_blocks));
  kernel<<<grid, kThreads, kSmemBytes<T>, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<int>(D), static_cast<int>(H), static_cast<int>(W), static_cast<int>(C), static_cast<int>(F),
      static_cast<int>(db), static_cast<int>(f_blocks), static_cast<int>(tiles_w), bw,
      piece_bytes(C, Elem<T>::kSize), piece_bytes(F, Elem<T>::kSize));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. All tensors are contiguous on the
// current device; b may be null (no bias). The return value is the cudaError_t
// of the launch (0 = ok).
extern "C" int conv3d_im2col_f32(const void* x, const void* w, const void* b, void* y, int64_t N, int64_t D,
                                 int64_t H, int64_t W, int64_t C, int64_t F, void* stream) {
  return launch<float>(x, w, b, y, N, D, H, W, C, F, stream);
}

extern "C" int conv3d_im2col_bf16(const void* x, const void* w, const void* b, void* y, int64_t N, int64_t D,
                                  int64_t H, int64_t W, int64_t C, int64_t F, void* stream) {
  return launch<__nv_bfloat16>(x, w, b, y, N, D, H, W, C, F, stream);
}

extern "C" const char* conv3d_im2col_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block (f32), for the build report.
extern "C" int conv3d_im2col_smem_bytes() { return kSmemBytes<float>; }
