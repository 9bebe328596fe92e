// 3x3x3 stride-1 pad-1 convolution forward for Hopper (sm_90a), in the
// im2col formulation with the depth taps folded into the GEMM's N.
//
// Replaces pytorch3dunet_tpu/ops/conv_pallas.py `_fwd_kernel` (:53), its wrapper
// `_conv3d_fwd_impl` (:91) and `pallas_call` (:111) (variant "im2col" of its
// `conv3d_fwd`), and keeps its contract:
//   x (N, D, H, W, C) channels-last, w (3, 3, 3, C, F), b (F,) or null
//   -> y (N, D, H, W, F) in x's dtype; f32 accumulation; bias added in the epilogue.
// In the port it is the forward of every conv with F >= 64 when P3DUNET_TAPFOLD=1
// (ops/conv3d.py), the counterpart of the JAX package's tap-folded forward.
//
// Design (K1's GEMM, one block per column of output planes):
// - A block owns kM = 256 consecutive pixels of the flattened H x W plane, kBF
//   output features, and a run of DB consecutive output planes [d0, d1). It
//   walks the input planes p = d0-1 .. d1 in order and reads each one once.
// - Per input plane it runs one GEMM z = P . Wc, walking C in chunks of kCK:
//     P[m, (kh, kw, c)]   = x[p, h(m)+kh-1, w(m)+kw-1, c]      K = 9C
//     Wc[(kh, kw, c), (kd, f)] = w[kd, kh, kw, c, f]          N = 3 kBF
//   Each chunk stages the im2col patch (kM x 9 kCK, zero outside the volume)
//   and the weight slice (9 kCK x 3 kBF) in shared memory as f32; the whole
//   weight matrix (28 MB at C = F = 512) is never staged at once.
// - Column block kd of z belongs to output plane p+1-kd. The TPU kernel's
//   3-slot f32 ring over its sequential plane grid becomes a ring of three
//   register micro-tiles per thread (planes p-1, p, p+1): after plane p the
//   slot of plane p-1 is complete, gets the bias and is written once; the ring
//   then rotates. No block needs another's partial sums.
// - Column blocks whose output plane lies outside [d0, d1) are skipped (the
//   `mask` template argument), so the FLOPs are exactly the direct conv's for
//   any DB; DB only trades the re-reading of the 2 boundary planes against
//   the number of blocks.
// - Out-of-range taps, pixels, channels and features are masked while staging
//   or writing: no padded copy of x in HBM, any D, H, W >= 1 and any C, F (the
//   Pallas wrapper pads x to (8, 128) tiles and needs a divisor of H).
// - Thread (vg, fg) owns pixels vg + 64 i (i < 4) and features 8 fg .. 8 fg + 7
//   in all three slots: 96 f32 accumulators. The patch is stored pixel-major
//   with an odd row stride, so the 32 lanes of a warp read 32 banks; all lanes
//   of a warp share fg, so weight reads are broadcasts.
//
// What bounds it on the H100: f32 FFMA on the CUDA cores (67 TFLOP/s dense peak
// on the SXM part). The 14 K1 convs of one 112x234x234 ResidualUNet3D forward
// are 1.22 TFLOP, about 18 ms at that peak; their bytes (x, w, y once each) are
// far below the 3.35 TB/s line. The ring takes ptxas to 236 registers a thread
// (no spills), so one 256-thread block of 8 warps runs on an SM (a bound of two
// blocks caps it at 128 and spills). With so few warps the latency of staging
// decides the speed: each thread starts a tap's (or a weight group's) global
// loads together before it stores them, which made the kernel 1.6-1.9x faster
// than one load-store pair at a time. Staging is still not overlapped with
// compute, and the im2col patch repeats each input element 9 times in shared
// memory. The GEMM's K = 9C is a
// multiple of 16 at every K1 shape (C >= 64), which is what a later design feeds
// to wgmma in bf16 from a TMA-fed shared-memory ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kM = 256;             // flattened plane pixels per block
constexpr int kVM = 4;              // pixels per thread
constexpr int kVF = 8;              // features per thread (per slot)
constexpr int kFG = 4;              // feature groups per block
constexpr int kVG = kThreads / kFG; // threads per feature group (pixel stride)
constexpr int kBF = kFG * kVF;      // output features per block
constexpr int kN = 3 * kBF;         // GEMM columns: (kd, f)
constexpr int kCK = 8;              // input channels per shared-memory stage
constexpr int kK = 9 * kCK;         // GEMM depth per stage: (kh, kw, c)
constexpr int kKP = kK + 1;         // patch row stride, odd: conflict-free reads
constexpr int kWElems = kK * kN;    // [k][kd][f]
constexpr int kPElems = kM * kKP;   // [m][k]
constexpr int kSmemBytes = (kWElems + kPElems) * static_cast<int>(sizeof(float)) + 2 * kM * static_cast<int>(sizeof(int));
constexpr int kPRows = kM * kCK / kThreads;  // patch pixels one thread stages per tap
constexpr int kWGroup = 9;                   // weight elements one thread loads at once
static_assert(kVG * kVM == kM, "every pixel of the tile has one owner per feature group");
static_assert(kThreads % kCK == 0 && kM * kCK % kThreads == 0, "staging threads tile the patch exactly");
static_assert(kWElems % (kWGroup * kThreads) == 0, "weight staging groups tile the slice exactly");
static_assert(kVG % 32 == 0, "a feature group spans whole warps");
static_assert(kWElems % 4 == 0 && kPElems % 4 == 0, "shared arrays stay 16-byte aligned");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// ring[2 - kd] += P . Wc[:, kd block] for the column blocks kd set in MASK
template <int MASK>
__device__ __forceinline__ void gemm_stage(const float* __restrict__ ps, const float* __restrict__ ws, int vg, int fg,
                                           float (&ring)[3][kVM][kVF]) {
  const float* prow = ps + vg * kKP;
  const float* wcol = ws + fg * kVF;
#pragma unroll 4
  for (int k = 0; k < kK; ++k) {
    float a[kVM];
#pragma unroll
    for (int i = 0; i < kVM; ++i) a[i] = prow[i * kVG * kKP + k];
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      if (!(MASK & (1 << kd))) continue;
      const float4 b0 = *reinterpret_cast<const float4*>(wcol + k * kN + kd * kBF);
      const float4 b1 = *reinterpret_cast<const float4*>(wcol + k * kN + kd * kBF + 4);
      const float bv[kVF] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kVM; ++i)
#pragma unroll
        for (int j = 0; j < kVF; ++j) ring[2 - kd][i][j] = fmaf(a[i], bv[j], ring[2 - kd][i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_im2col_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                     T* __restrict__ y, int D, int H, int W, int C, int F, int DB, int f_blocks) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [kK][kN]
  float* ps = ws + kWElems;                     // [kM][kKP]
  int* pix_h = reinterpret_cast<int*>(ps + kPElems);
  int* pix_w = pix_h + kM;

  const int tid = threadIdx.x;
  const int fg = tid / kVG;
  const int vg = tid % kVG;
  const int hw = H * W;
  const int m0 = blockIdx.x * kM;
  const int d0 = blockIdx.y * DB;
  const int d1 = min(d0 + DB, D);
  const int n = blockIdx.z / f_blocks;
  const int f0 = (blockIdx.z % f_blocks) * kBF;

  // (h, w) of every pixel of the tile; pixels past the plane get a row that
  // no tap reaches, so staging masks them
  for (int m = tid; m < kM; m += kThreads) {
    const int pixel = m0 + m;
    pix_h[m] = pixel < hw ? pixel / W : INT_MIN / 2;
    pix_w[m] = pixel < hw ? pixel % W : 0;
  }

  float ring[3][kVM][kVF];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int i = 0; i < kVM; ++i)
#pragma unroll
      for (int j = 0; j < kVF; ++j) ring[s][i][j] = 0.f;

  __syncthreads();

#pragma unroll 1
  for (int p = d0 - 1; p <= d1; ++p) {
    // column block kd feeds output plane p+1-kd; keep those inside [d0, d1)
    int mask = 0;
    if (p >= 0 && p < D) {
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const int d = p + 1 - kd;
        if (d >= d0 && d < d1) mask |= 1 << kd;
      }
    }
    if (mask != 0) {
      const int64_t plane = static_cast<int64_t>(n) * D + p;
      // the channel of each chunk that this thread stages, and its first pixel
      const int c_own = tid % kCK;
      const int m_own = tid / kCK;
#pragma unroll 1
      for (int c0 = 0; c0 < C; c0 += kCK) {
        const int ch = c0 + c_own;
        // im2col patch: pixels m_own + j * kThreads / kCK of every tap; a
        // tap's loads are all in flight before their stores
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const int dh = tap / 3 - 1;
          const int dw = tap % 3 - 1;
          float v[kPRows];
#pragma unroll
          for (int j = 0; j < kPRows; ++j) {
            const int m = m_own + j * (kThreads / kCK);
            const int yh = pix_h[m] + dh;
            const int xw = pix_w[m] + dw;
            v[j] = (yh >= 0 && yh < H && xw >= 0 && xw < W && ch < C)
                       ? to_f32(x[((plane * H + yh) * W + xw) * C + ch]) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < kPRows; ++j) ps[(m_own + j * (kThreads / kCK)) * kKP + tap * kCK + c_own] = v[j];
        }
        // weight slice; e == ((tap * kCK + c) * 3 + kd) * kBF + f, loaded in
        // groups of kWGroup before they are stored
#pragma unroll 1
        for (int e0 = tid; e0 < kWElems; e0 += kWGroup * kThreads) {
          float v[kWGroup];
#pragma unroll
          for (int g = 0; g < kWGroup; ++g) {
            const int e = e0 + g * kThreads;
            const int f = e % kBF;
            int r = e / kBF;
            const int kd = r % 3;
            r /= 3;
            const int c = r % kCK;
            const int tap = r / kCK;
            v[g] = (c0 + c < C && f0 + f < F)
                       ? to_f32(w[(static_cast<int64_t>(kd * 9 + tap) * C + c0 + c) * F + f0 + f]) : 0.f;
          }
#pragma unroll
          for (int g = 0; g < kWGroup; ++g) ws[e0 + g * kThreads] = v[g];
        }
        __syncthreads();
        switch (mask) {
          case 1: gemm_stage<1>(ps, ws, vg, fg, ring); break;
          case 2: gemm_stage<2>(ps, ws, vg, fg, ring); break;
          case 3: gemm_stage<3>(ps, ws, vg, fg, ring); break;
          case 4: gemm_stage<4>(ps, ws, vg, fg, ring); break;
          case 6: gemm_stage<6>(ps, ws, vg, fg, ring); break;
          default: gemm_stage<7>(ps, ws, vg, fg, ring); break;
        }
        __syncthreads();
      }
    }

    // slot 0 holds output plane p-1, which no later input plane reaches
    const int d = p - 1;
    if (d >= d0 && d < d1) {
      float bias[kVF];
#pragma unroll
      for (int j = 0; j < kVF; ++j) {
        const int f = f0 + fg * kVF + j;
        bias[j] = (b != nullptr && f < F) ? to_f32(b[f]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVM; ++i) {
        const int pixel = m0 + vg + i * kVG;
        if (pixel >= hw) continue;
        T* out = y + ((static_cast<int64_t>(n) * D + d) * hw + pixel) * F;
#pragma unroll
        for (int j = 0; j < kVF; ++j) {
          const int f = f0 + fg * kVF + j;
          if (f < F) out[f] = from_f32<T>(ring[0][i][j] + bias[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kVM; ++i)
#pragma unroll
      for (int j = 0; j < kVF; ++j) {
        ring[0][i][j] = ring[1][i][j];
        ring[1][i][j] = ring[2][i][j];
        ring[2][i][j] = 0.f;
      }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int64_t N, int64_t D, int64_t H, int64_t W,
           int64_t C, int64_t F, void* stream) {
  if (N <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0) return cudaErrorInvalidValue;
  const int64_t tiles = (H * W + kM - 1) / kM;
  const int64_t f_blocks = (F + kBF - 1) / kBF;
  if (H * W > INT_MAX || tiles > INT_MAX || N * f_blocks > 65535 || D > INT_MAX || C > INT_MAX || F > INT_MAX)
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
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(d_blocks), static_cast<unsigned>(N * f_blocks));
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<int>(D), static_cast<int>(H), static_cast<int>(W), static_cast<int>(C), static_cast<int>(F),
      static_cast<int>(db), static_cast<int>(f_blocks));
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

// Dynamic shared memory of one block, for the build report.
extern "C" int conv3d_im2col_smem_bytes() { return kSmemBytes; }
