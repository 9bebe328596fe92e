// 3x3x3 stride-1 pad-1 convolution forward for Hopper (sm_90a) on the tensor
// cores, with the output pixels on wgmma's M and the features on N: the conv
// forward of every 3x3x3 conv by default.
//
// Replaces pytorch3dunet_tpu/ops/conv_pallas.py `_fwd_kernel_roll` (:135, its
// wrapper :181 and `pallas_call` :194; the default variant "roll" of its
// `conv3d_fwd`) and keeps its contract:
//   x (N, D, H, W, C) channels-last, w (3, 3, 3, C, F), b (F,) or null
//   -> y (N, D, H, W, F) in x's dtype; f32 accumulation; bias added in the epilogue.
// The entry points take the weights K-major, wk (3, 3, 3, F, C) =
// w.transpose(3, 4) (ops/conv3d.py `kmajor_weight`, at most 27 x 384 x 128
// elements a call): a tf32 wgmma reads B from shared memory K-major only.
//
// Design (the tensor-core core is conv3d_tc.cuh; see its note for the brick,
// the descriptors and the 3xTF32 split):
// - GEMM  y[pixel, f] = sum over (kd, kh, kw, c) of x[.., pixel + (kh, kw), c] w[kd, kh, kw, c, f].
//   A is 64 output pixels of the brick by descriptor; the 9 in-plane taps are
//   the same brick 16 * (kh * BW + kw) bytes on, the TPU roll kernel's
//   flat-buffer offset kh * WP + kw (conv_pallas.py:135-163). B is the weights
//   of one tap, N = 16, 32 or 64 features (F rounded up; above 64, more
//   feature blocks). So the F = 16 and F = 32 convs of a UNet's level 0, which
//   carry 57% of its conv FLOPs, fill the tile; K1 and K3's m64 feature tile
//   would leave 75% or 50% of it empty there.
// - A block owns one output plane d, up to kPix output pixels of it (a tile of
//   TH rows x BW - 2 columns on a brick BW wide; 640 pixels at N <= 32, 256 at
//   N = 64, so that the accumulators and the chunk's own sums are at most 160
//   registers a thread) and N features; its 2 warpgroups take the tile's m64
//   rows in turn, the same number each. It walks the depth taps kd whose input plane d + kd - 1 lies
//   in the volume, and for each the 32-byte channel chunks (K3's form): each
//   stage holds one chunk's brick, its lo part and the 9 taps' weights of that
//   kd. K1's form (walk input planes, a 3-slot accumulator ring as in the TPU
//   kernel's `ring`, conv_pallas.py:165-177) would stage each input plane once
//   instead of three times, but needs three times the accumulators and 27
//   taps of weights a stage: the tile would shrink to a third. The brick is
//   1.1-1.5x the tile, so the 3x staging is the cheaper of the two.
// - The launcher picks BW (3 .. 128, any, not a power of 2) and TH for each
//   plane size, minimising the MMAs issued plus the brick's staging, with an
//   even number of m64 tiles (both warpgroups take the same count, a kernel
//   parameter: a tile count that a thread computes from its warpgroup would
//   be a divergent branch around the wgmmas, and ptxas then serialises every
//   one of them, C7520). At 234 columns and N = 32: BW = 49 (5 tiles of 47
//   columns), TH = 13, 10 m64 tiles. Over the 14 UNet3D convs of a 112x234x234
//   patch the MMAs issued are 1.0892x the useful ones (chip_smoke.py phase 5):
//   the 2 wrap columns of each brick row, the ragged tile edges, and C = 1
//   padded to an 8-channel chunk (8.4x at the first conv, 0.2% of the FLOPs).
//   `conv3d_fwd_issued_macs` reports them.
// - A stage runs 9 taps x up to 5 m64 tiles x 3 wgmmas (f32) back to back into
//   the chunk's own sums (the first with scale-d = 0: no zeroing). While they
//   run, the threads issue the copies of stage s + 2 and split stage s + 1;
//   then they wait, add the sums to the running f32 sums (the tensor cores'
//   truncating accumulation never spans more than one chunk, 72 products a
//   row), and meet at the barrier that frees the stage's slot.
// - A could come from registers instead (loaded from the same brick and
//   split there, as K1 and K3 load their weights): it reads the brick once
//   per tap instead of three times. It measured slower on an H100 at every
//   level-0 F = 32 shape and at F = 64 and 128, so A stays a descriptor.
// - Out-of-range taps, pixels, channels and features are zero-filled while
//   staging or dropped at the store: no padded copy of x in HBM, any D, H, W >= 1
//   and any C, F. The Pallas wrapper's WP/CP padding, its H tile that must
//   divide H and its f32 ring over a sequential depth grid have no counterpart.
//
// What bounds it on the H100 (SXM, 700 W): the tensor cores, at three TF32
// products per MAC in f32 (495 TFLOP/s dense) and one in bf16 (989). The 14
// convs of one 112x234x234 UNet3D forward are 2.764 TFLOP: 16.75 ms of 3xTF32
// MMAs, 2.79 ms in bf16 (41.30 ms at the 67 TFLOP/s FFMA rate of the kernel
// this one replaced). What the design does about it: a 3-stage cp.async ring
// keeps the next two chunks in flight during the MMAs; the wgmmas of a stage
// are issued without a wait between them. What holds it back: both operands
// come from shared memory, so an m64nNk8 tf32 wgmma reads 2048 + 32 N bytes of
// it in N / 2 tensor-core clocks: at N = 32 that is 192 bytes a clock against
// the SM's 128, so the F = 32 convs can reach at most 2/3 of the tensor rate;
// one block of two warpgroups per SM, whose tensor pipe drains at each stage's
// end; the weight split in shared memory, repeated by every block.
// ptxas (sm_90a): 161-196 registers in f32 and 115-194 in bf16 by N, no
// spills; 228,864 bytes of shared memory at N = 32 in f32, one block per SM.
// Measured (chip_smoke.py phase 5; NVIDIA H100 80GB HBM3, 700.00 W): those 14
// convs in 50.0 ms f32 (39-65 TFLOP/s by shape but 3 at C = 1), 15.5 ms bf16,
// against 92.0 ms for one cuDNN F.conv3d each in f32; details in PERF.md.

#include "conv3d_tc.cuh"

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

using namespace tc;

constexpr int kStages = 3;
constexpr int kMaxBW = 128;  // widest brick the launcher may pick

// the tile of N features: at most kTiles m64 tiles a warpgroup, pixels and
// brick capacity a block
template <int N>
struct Tile {
  static constexpr int kTiles = N == 64 ? 2 : 5;
  static constexpr int kPix = 2 * 64 * kTiles;
  static constexpr int kBP = kPix + 2 * kMaxBW + 8;  // >= tiles * 64 + 2 BW + 2, a multiple of 8
  static_assert(kBP % 8 == 0, "brick rows stay 128-byte core matrices");
};

template <int N>
constexpr int kLoOff = kChunkBytes * Tile<N>::kBP;  // f32: the brick's lo part

template <typename T, int N>
struct Stage {
  static constexpr int kWOff = weights_offset<T>(Tile<N>::kBP);
  static constexpr int kWBytes = 9 * N * kChunkBytes;  // one part of the weights: 9 taps x N x 32 bytes
  static constexpr int kBytes = kWOff + kWBytes * (Elem<T>::kSplit ? 2 : 1);
  static constexpr int kSmem = kStages * kBytes;
  static_assert(kBytes % 128 == 0 && kSmem <= 232448, "fits one SM");
};

// Issues d[j] = sum over the 9 taps of brick(tile pixels + tap shift) . W[tap]
// for the `half` m64 tiles j of this warpgroup (tile 2 j + wg of the block),
// one commit group, and returns while the tensor cores run it. `half` is a
// kernel parameter, the same in every thread: a branch on anything a thread
// computes would make ptxas serialise the wgmmas.
template <typename T, int N, int TILES>
__device__ __forceinline__ void issue_mma(float (&d)[TILES][N / 2], const char* stage, int wg, int half, int bw,
                                          int bp) {
  using S = Stage<T, N>;
  const uint32_t brick = smem_u32(stage);
  const uint32_t wts = smem_u32(stage + S::kWOff);
  const uint32_t lbo_a = 16 * bp;
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const uint32_t shift = ((tap / 3) * bw + tap % 3) * 16;
    const uint64_t b_hi = make_desc(wts + tap * N * kChunkBytes, 16 * N);
#pragma unroll
    for (int j = 0; j < TILES; ++j) {
      if (j >= half) continue;
      const uint32_t a = brick + (2 * j + wg) * 64 * 16 + shift;
      if constexpr (Elem<T>::kSplit) {
        const uint64_t b_lo = make_desc(wts + S::kWBytes + tap * N * kChunkBytes, 16 * N);
        wgmma_ss<T>(d[j], make_desc(a + kLoOff<N>, lbo_a), b_hi, tap);
        wgmma_ss<T>(d[j], make_desc(a, lbo_a), b_lo, 1);
        wgmma_ss<T>(d[j], make_desc(a, lbo_a), b_hi, 1);
      } else {
        wgmma_ss<T>(d[j], make_desc(a, lbo_a), b_hi, tap);
      }
    }
  }
  wgmma_commit();
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wk, const T* __restrict__ b, T* __restrict__ y,
                  int D, int H, int W, int C, int F, int f_blocks, int tiles_w, int bw, int th, int half, int bp,
                  int piece) {
  using S = Stage<T, N>;
  constexpr int kTiles = Tile<N>::kTiles;
  constexpr int kCK = chunk_channels<T>();
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wq = (tid / 32) % 4;
  const int wg = tid / 128;

  const Brick br{static_cast<int>(blockIdx.x / tiles_w) * th, static_cast<int>(blockIdx.x % tiles_w) * (bw - 2), bw,
                 th, bp};
  const int d = blockIdx.y;
  const int n = blockIdx.z / f_blocks;
  const int f0 = (blockIdx.z % f_blocks) * N;
  // depth taps whose input plane d + kd - 1 is inside the volume
  const int kd_first = d == 0 ? 1 : 0;
  const int kd_last = d == D - 1 ? 1 : 2;
  const int nch = (C + kCK - 1) / kCK;
  const int total = (kd_last - kd_first + 1) * nch;

  // copies of stage s (depth tap kd_first + s / nch, chunk s % nch) into its ring slot
  auto issue = [&](int s) {
    if (s < total) {
      const int kd = kd_first + s / nch;
      const int c0 = (s % nch) * kCK;
      char* st = smem + (s % kStages) * S::kBytes;
      load_brick<T>(st, x, static_cast<int64_t>(n) * D + d + kd - 1, H, W, C, c0, br, piece, tid);
      load_weights_kmajor<T, N>(st + S::kWOff, wk, C, F, c0, f0, kd, piece, tid);  // rows of C too
    }
    cp_async_commit();
  };
  // f32: the split of stage s, by the threads that copied it
  auto split = [&](int s) {
    if constexpr (Elem<T>::kSplit) {
      char* st = smem + (s % kStages) * S::kBytes;
      split_brick(st, kLoOff<N>, br, tid);
      split_weights<N>(st + S::kWOff, S::kWBytes, tid);
    }
    fence_async_smem();
  };

  float acc[kTiles][N / 2], part[kTiles][N / 2];
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[j][i] = 0.f;
  static_assert(kStages == 3, "the loop below keeps one stage landing while another computes");
  issue(0);
  issue(1);
  cp_async_wait<1>();
  split(0);
  __syncthreads();
  // stage s: its wgmmas run while stage s + 2 is issued into the slot of stage
  // s - 1 (done at the barrier of s - 1) and stage s + 1 lands and is split;
  // then its sums are added in f32 and the barrier frees its slot
#pragma unroll 1
  for (int s = 0; s < total; ++s) {
    issue_mma<T, N, kTiles>(part, smem + (s % kStages) * S::kBytes, wg, half, bw, bp);
    issue(s + 2);
    cp_async_wait<1>();
    if (s + 1 < total) split(s + 1);
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      if (j >= half) continue;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[j][i] += part[j][i];
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  const int64_t plane = static_cast<int64_t>(n) * D + d;
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
    if (j < half) store_pixels<T, N>(y, acc[j], b, plane, H, W, F, f0, (2 * j + wg) * 64, br, wq, lane);
}

// The tile of a plane H x W: brick width bw (bw - 2 output columns), th rows,
// `tiles` m64 tiles (th * bw pixels rounded up to an even count: both
// warpgroups take tiles / 2), bp staged brick pixels.
struct Geometry {
  int bw, th, tiles, bp;
  int64_t tiles_w, tiles_h;
};

// The (bw, th) that minimise the blocks' tensor-core and staging clocks, in a
// model: an m64nNk wgmma takes N / 2 clocks or (2048 + 32 N) / 128 for its
// shared-memory reads, whichever is more, 27 (f32) or 9 (bf16) of them a
// staged chunk; staging and splitting a brick pixel or one of the 9 N weight
// rows takes a clock (f32: 128 bytes of shared-memory traffic) or a quarter
// (bf16).
template <typename T, int N>
Geometry pick_geometry(int64_t H, int64_t W) {
  constexpr double kMmaClocks = (Elem<T>::kSplit ? 27 : 9) * (N / 2 > 16 + N / 4 ? N / 2 : 16 + N / 4) / 64.0;
  constexpr double kStageClocks = Elem<T>::kSplit ? 1.0 : 0.25;
  Geometry best{};
  double best_cost = -1;
  const int64_t max_bw = W + 2 < kMaxBW ? W + 2 : kMaxBW;
  for (int bw = 3; bw <= max_bw; ++bw) {
    const int64_t tiles_w = (W + bw - 3) / (bw - 2);
    for (int th = 1; th * bw <= Tile<N>::kPix; ++th) {
      const int tiles = (th * bw + 127) / 128 * 2;
      const int bp = (tiles * 64 + 2 * bw + 2 + 7) / 8 * 8;
      if (bp > Tile<N>::kBP) continue;
      const int64_t tiles_h = (H + th - 1) / th;
      const double cost =
          static_cast<double>(tiles_w * tiles_h) * (tiles * 64 * kMmaClocks + (bp + 9 * N) * kStageClocks);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best = {bw, th, tiles, bp, tiles_w, tiles_h};
      }
    }
  }
  return best;
}

template <typename T, int N>
int launch(const void* x, const void* wk, const void* b, void* y, int64_t Nb, int64_t D, int64_t H, int64_t W,
           int64_t C, int64_t F, void* stream) {
  using S = Stage<T, N>;
  const Geometry g = pick_geometry<T, N>(H, W);
  const int64_t f_blocks = (F + N - 1) / N;
  if (Nb * D * H * W > INT_MAX || g.tiles_w * g.tiles_h > INT_MAX || D > 65535 || Nb * f_blocks > 65535 ||
      C > INT_MAX || F > INT_MAX)
    return cudaErrorInvalidValue;
  auto kernel = conv3d_fwd_kernel<T, N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(g.tiles_w * g.tiles_h), static_cast<unsigned>(D),
                  static_cast<unsigned>(Nb * f_blocks));
  kernel<<<grid, kThreads, S::kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(wk), static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<int>(D), static_cast<int>(H), static_cast<int>(W), static_cast<int>(C), static_cast<int>(F),
      static_cast<int>(f_blocks), static_cast<int>(g.tiles_w), g.bw, g.th, g.tiles / 2, g.bp,
      piece_bytes(C, Elem<T>::kSize));
  return static_cast<int>(cudaGetLastError());
}

// fn(std::integral_constant<int, N>) for the feature tile N of F outputs:
// F rounded up to 16 or 32, else tiles of 64
template <typename Fn>
auto with_tile(int64_t F, Fn&& fn) {
  if (F <= 16) return fn(std::integral_constant<int, 16>{});
  if (F <= 32) return fn(std::integral_constant<int, 32>{});
  return fn(std::integral_constant<int, 64>{});
}

bool valid_sizes(int64_t Nb, int64_t D, int64_t H, int64_t W, int64_t C, int64_t F) {
  return Nb > 0 && D > 0 && H > 0 && W > 0 && C > 0 && F > 0;
}

template <typename T>
int dispatch(const void* x, const void* wk, const void* b, void* y, int64_t Nb, int64_t D, int64_t H, int64_t W,
             int64_t C, int64_t F, void* stream) {
  if (!valid_sizes(Nb, D, H, W, C, F)) return cudaErrorInvalidValue;
  return with_tile(F, [&](auto n) { return launch<T, decltype(n)::value>(x, wk, b, y, Nb, D, H, W, C, F, stream); });
}

// MACs of one pass that the launch issues to the tensor cores (channels
// padded to chunks, features to N, every m64 tile whole).
template <typename T, int N>
int64_t issued_macs(int64_t Nb, int64_t D, int64_t H, int64_t W, int64_t C, int64_t F) {
  const Geometry g = pick_geometry<T, N>(H, W);
  const int64_t planes = D == 1 ? 1 : 3 * D - 2;  // depth taps inside the volume, over all output planes
  const int64_t chunks = (C + chunk_channels<T>() - 1) / chunk_channels<T>();
  return Nb * ((F + N - 1) / N) * g.tiles_w * g.tiles_h * planes * chunks * 9 * g.tiles * 64 * chunk_channels<T>() * N;
}

template <typename T>
int64_t issued(int64_t Nb, int64_t D, int64_t H, int64_t W, int64_t C, int64_t F) {
  if (!valid_sizes(Nb, D, H, W, C, F)) return 0;
  return with_tile(F, [&](auto n) { return issued_macs<T, decltype(n)::value>(Nb, D, H, W, C, F); });
}

}  // namespace

// Plain C entry points, bound with ctypes. All tensors are contiguous on the
// current device; wk is (3, 3, 3, F, C); b may be null (no bias). The return
// value is the cudaError_t of the launch (0 = ok).
extern "C" int conv3d_fwd_f32(const void* x, const void* wk, const void* b, void* y, int64_t N, int64_t D,
                              int64_t H, int64_t W, int64_t C, int64_t F, void* stream) {
  return dispatch<float>(x, wk, b, y, N, D, H, W, C, F, stream);
}

extern "C" int conv3d_fwd_bf16(const void* x, const void* wk, const void* b, void* y, int64_t N, int64_t D,
                               int64_t H, int64_t W, int64_t C, int64_t F, void* stream) {
  return dispatch<__nv_bfloat16>(x, wk, b, y, N, D, H, W, C, F, stream);
}

extern "C" const char* conv3d_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block (f32, the largest of the tiles), for the build report.
extern "C" int conv3d_fwd_smem_bytes() {
  const int smem[] = {Stage<float, 16>::kSmem, Stage<float, 32>::kSmem, Stage<float, 64>::kSmem};
  return *std::max_element(smem, smem + 3);
}

// MACs of one pass issued for a conv of these sizes (f32 unless bf16 != 0):
// against 27 C F per voxel, the MMAs issued over the useful ones.
extern "C" int64_t conv3d_fwd_issued_macs(int64_t N, int64_t D, int64_t H, int64_t W, int64_t C, int64_t F,
                                          int bf16) {
  return bf16 ? issued<__nv_bfloat16>(N, D, H, W, C, F) : issued<float>(N, D, H, W, C, F);
}
