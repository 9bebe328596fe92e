// GroupNorm forward for Hopper (sm_90a): a split reduction of the per-(sample,
// group) statistics over every SM, then the affine, both reading the input
// where and as it lies.
//
// Replaces no Pallas kernel: the JAX package computes GroupNorm in XLA (its
// fused Pallas GroupNorm went in its round 2). It replaces, in the port's
// inference forward, torch's `nn.GroupNorm` on CUDA, which makes the input
// NCDHW-contiguous (a copy of K2's channels-last output), reduces each
// (sample, group) row in one block (`RowwiseMomentsCUDAKernel`: 8 blocks on
// 132 SMs at batch 1 and 8 groups, 24.5 M elements a block at a UNet's level
// 0), and writes an NCDHW output that the next conv copies back to NDHWC;
// in bf16 the port's norm also staged an f32 copy of the input and a cast back.
//
// Contract (ops/group_norm.py `group_norm_op`):
//   x (N, C, *spatial) f32 or bf16, stored either NC-contiguous (channel
//   stride S = prod(spatial): the 2D families, cuDNN's deconv and 1x1 outputs,
//   a decoder's concat) or channels-last (channel stride 1: K2's output, the
//   pooled and summed tensors after it); weight, bias (C,) f32 or null;
//   -> y with x's shape, dtype and strides,
//   y = x * a[n, c] + b[n, c], a = rstd[n, g] * weight[c],
//   b = bias[c] - mean[n, g] * a, with a and b in f32, each y computed in f32
//   and rounded once to x's dtype; rstd = 1 / sqrt(var + eps), var biased.
//
// Design:
// - Two launches. The statistics kernel cuts the storage into contiguous
//   chunks, a few blocks per SM (`make_plan`, from the element count): in the
//   NC layout a chunk of one (sample, group) row, which is contiguous; in the
//   channels-last layout a run of spatial rows of one sample, all C channels,
//   each thread owning one 16-byte vector of channels, so that its channels
//   never change and no index is divided per element.
// - 16-byte loads, 4 f32 or 8 bf16 values, kUnroll of them in flight a
//   thread. A thread keeps f32 (count, mean, M2): for each batch of loads the
//   batch's own mean and squared deviations (two passes over registers), then
//   Chan's parallel formula into its running triple; never E[x^2] - E[x]^2.
// - A block merges its threads' triples by warp shuffles and shared memory
//   (channels-last: per channel over the block's rows, then the channels of
//   a group), and writes one triple per (row, chunk). The last block to finish
//   (a threadfence and an atomic ticket) merges each row's chunks in f64 by
//   the same formula, in a fixed order, and writes mean and rstd (N, G) and
//   the f32 affine a and b (N, C). No sum is taken by atomics: a repeat is
//   bitwise equal. The ticket is one word the caller keeps per stream, zeroed
//   once: atomicInc wraps it back to 0 at the last block, so no launch
//   clears it and the workspace needs no initial value.
// - The apply kernel reads x in its dtype, computes x * a + b in f32 and
//   writes y in x's dtype at x's offsets, so a channels-last input gives a
//   channels-last output and the next conv makes no copy.
// - A row or channel count that is not a multiple of the vector width, or a
//   misaligned pointer, takes the same kernels one value a load (V = 1).
//
// What bounds it on the H100 (SXM, 700 W): memory, two reads and one write of
// x at 3.35 TB/s (the statistics read x, the apply reads it again and writes
// y; x does not fit the 50 MB L2 at the shapes that matter). The 12
// GroupNorms of a UNet3D forward of a 112x234x234 f32 patch read 2.29 GB:
// 2.05 ms. What the design does about it: every SM on both passes, vector
// loads with several in flight, no copy of x, and no f32 staging of a bf16 x;
// per element a thread does a few FLOPs, far under the card's FLOP rate.
// ptxas (sm_90a): 48-64 registers in f32 and 58-80 in bf16 with 16-byte
// loads, no spills (the one-value-a-load channels-last statistics spill 8
// bytes in f32); the channels-last statistics take at most 16.4 KB of
// dynamic shared memory. Measured (chip_smoke.py phase 32; NVIDIA H100 80GB
// HBM3, 700.00 W): those 12 in 3.69 ms, the level-0 ones at 69-73% of their
// bound, against 77.9 ms for torch's GroupNorm as the port called it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads of every block
constexpr int kUnroll = 4;     // loads in flight a thread
constexpr int kStatsBlocksPerSm = 4;
constexpr int kApplyBlocksPerSm = 8;
// the most elements one (row, chunk) triple counts: its f32 count stays exact
constexpr int64_t kMaxChunkCount = int64_t{1} << 23;
constexpr int kMaxDevices = 64;

enum Layout { kNC = 0, kCL = 1 };

template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int kVec = 4;
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kVec = 8;
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same_v<T, float>) {
      v[0] = *p;
    } else {
      v[0] = __bfloat162float(*p);
    }
  } else if constexpr (std::is_same_v<T, float>) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same_v<T, float>) {
      *p = v[0];
    } else {
      *p = __float2bfloat16_rn(v[0]);
    }
  } else if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
}

// Chan's parallel formula: (n, mean, m2) absorbs (nb, meanb, m2b)
template <typename F>
__device__ __forceinline__ void merge(F& n, F& mean, F& m2, F nb, F meanb, F m2b) {
  if (nb == F(0)) return;
  const F total = n + nb;
  const F w = nb / total;
  const F delta = meanb - mean;
  mean += delta * w;
  m2 += m2b + delta * delta * n * w;
  n = total;
}

// lane 0 ends with the warp's triple; the order is fixed
template <typename F>
__device__ __forceinline__ void warp_merge(F& n, F& mean, F& m2) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const F nb = __shfl_down_sync(0xffffffffu, n, offset);
    const F meanb = __shfl_down_sync(0xffffffffu, mean, offset);
    const F m2b = __shfl_down_sync(0xffffffffu, m2, offset);
    merge(n, mean, m2, nb, meanb, m2b);
  }
}

struct Out {
  float* partial;     // (rows, parts, 3): each chunk's (count, mean, M2)
  float* mean;        // (N, G)
  float* rstd;        // (N, G)
  float* scale;       // (N, C): a
  float* shift;       // (N, C): b
  unsigned* ticket;   // 0 before the launch, and after it
  const float* weight;
  const float* bias;
  int64_t N, C, G;
  int parts;
  double eps;
};

// The last block to finish merges each row's chunks (one warp a row, each
// lane a strided set of chunks, then the warp's tree: a fixed order) in f64,
// and writes mean, rstd and the affine.
__device__ void finish(const Out& o) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  // the last of gridDim.x increments sees gridDim.x - 1 and wraps the ticket to 0
  if (threadIdx.x == 0) last = atomicInc(o.ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t rows = o.N * o.G;
  for (int64_t r = warp; r < rows; r += kThreads / 32) {
    double n = 0, mean = 0, m2 = 0;
    for (int k = lane; k < o.parts; k += 32) {
      const float* p = o.partial + 3 * (r * o.parts + k);
      merge<double>(n, mean, m2, __ldcg(p), __ldcg(p + 1), __ldcg(p + 2));
    }
    warp_merge<double>(n, mean, m2);
    if (lane == 0) {
      const double var = n > 0 ? m2 / n : 0.0;
      o.mean[r] = static_cast<float>(mean);
      o.rstd[r] = static_cast<float>(1.0 / sqrt((var > 0 ? var : 0.0) + o.eps));
    }
  }
  __syncthreads();
  const int64_t per_group = o.C / o.G;
  for (int64_t i = threadIdx.x; i < o.N * o.C; i += kThreads) {
    const int64_t c = i % o.C, r = (i / o.C) * o.G + c / per_group;
    const float a = o.rstd[r] * (o.weight ? o.weight[c] : 1.0f);
    o.scale[i] = a;
    o.shift[i] = (o.bias ? o.bias[c] : 0.0f) - o.mean[r] * a;
  }
}

// The NC layout: row r = (n, g) is contiguous, row_len = (C / G) S values;
// block b takes chunk b % parts of row b / parts.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) group_norm_stats_nc_kernel(const T* __restrict__ x, int64_t row_len,
                                                                       Out o) {
  const int64_t row = blockIdx.x / o.parts;
  const int part = blockIdx.x % o.parts;
  const int64_t vecs = row_len / V, per = (vecs + o.parts - 1) / o.parts;
  const int64_t v0 = part * per, v1 = v0 + per < vecs ? v0 + per : vecs;
  const T* base = x + row * row_len;
  float n = 0, mean = 0, m2 = 0;
  for (int64_t i = v0 + threadIdx.x; i < v1; i += kThreads * kUnroll) {
    float v[kUnroll][V];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = i + u * kThreads;
      ok[u] = j < v1;
      if (ok[u]) load<T, V>(base + j * V, v[u]);
    }
    float count = 0, sum = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      count += V;
#pragma unroll
      for (int e = 0; e < V; ++e) sum += v[u][e];
    }
    const float local_mean = sum / count;
    float local_m2 = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = v[u][e] - local_mean;
        local_m2 += d * d;
      }
    }
    merge(n, mean, m2, count, local_mean, local_m2);
  }
  __shared__ float sh[3][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_merge(n, mean, m2);
  if (lane == 0) {
    sh[0][warp] = n;
    sh[1][warp] = mean;
    sh[2][warp] = m2;
  }
  __syncthreads();
  if (warp == 0) {
    const bool has = lane < kThreads / 32;
    n = has ? sh[0][lane] : 0.0f;
    mean = has ? sh[1][lane] : 0.0f;
    m2 = has ? sh[2][lane] : 0.0f;
    warp_merge(n, mean, m2);
    if (lane == 0) {
      float* p = o.partial + 3 * static_cast<int64_t>(blockIdx.x);
      p[0] = n;
      p[1] = mean;
      p[2] = m2;
    }
  }
  finish(o);
}

// The channels-last layout: sample n is S rows of C channels; block b takes
// chunk b % parts of the rows of sample b / parts. Thread (tx, ty) owns the
// channels [tx V, tx V + V) of rows ty, ty + rows_in_flight, ...; the threads
// past cols x rows_in_flight idle.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) group_norm_stats_cl_kernel(const T* __restrict__ x, int64_t S, Out o) {
  extern __shared__ float smem[];
  const int C = static_cast<int>(o.C), G = static_cast<int>(o.G);
  const int cols = C / V, row_threads = kThreads / cols;
  const int tx = threadIdx.x % cols, ty = threadIdx.x / cols;
  const bool active = ty < row_threads;
  const int64_t sample = blockIdx.x / o.parts;
  const int part = blockIdx.x % o.parts;
  const int64_t per = (S + o.parts - 1) / o.parts;
  const int64_t s0 = part * per, s1 = s0 + per < S ? s0 + per : S;
  const T* base = x + sample * S * C + tx * V;
  float n = 0, mean[V], m2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) mean[e] = m2[e] = 0.0f;
  if (active) {
    for (int64_t s = s0 + ty; s < s1; s += static_cast<int64_t>(row_threads) * kUnroll) {
      float v[kUnroll][V];
      bool ok[kUnroll];
      float count = 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t row = s + static_cast<int64_t>(u) * row_threads;
        ok[u] = row < s1;
        if (ok[u]) {
          load<T, V>(base + row * C, v[u]);
          count += 1.0f;
        }
      }
      const float total = n + count, w = count / total, inv = 1.0f / count;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float sum = 0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) sum += ok[u] ? v[u][e] : 0.0f;
        const float local_mean = sum * inv;
        float local_m2 = 0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float d = ok[u] ? v[u][e] - local_mean : 0.0f;
          local_m2 += d * d;
        }
        const float delta = local_mean - mean[e];
        mean[e] += delta * w;
        m2[e] += local_m2 + delta * delta * n * w;
      }
      n = total;
    }
  }
  // per channel over the block's rows, then per group over its channels
  float* sh_mean = smem;
  float* sh_m2 = sh_mean + row_threads * C;
  float* sh_n = sh_m2 + row_threads * C;
  if (active) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      sh_mean[ty * C + tx * V + e] = mean[e];
      sh_m2[ty * C + tx * V + e] = m2[e];
    }
    if (tx == 0) sh_n[ty] = n;
  }
  __syncthreads();
  float rows = 0;
  for (int t = 0; t < row_threads; ++t) rows += sh_n[t];
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float cn = 0, cmean = 0, cm2 = 0;
    for (int t = 0; t < row_threads; ++t) merge(cn, cmean, cm2, sh_n[t], sh_mean[t * C + c], sh_m2[t * C + c]);
    sh_mean[c] = cmean;  // row 0 of column c: read above by this thread alone
    sh_m2[c] = cm2;
  }
  __syncthreads();
  const int per_group = C / G;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float gn = 0, gmean = 0, gm2 = 0;
    for (int c = g * per_group; c < (g + 1) * per_group; ++c) merge(gn, gmean, gm2, rows, sh_mean[c], sh_m2[c]);
    float* p = o.partial + 3 * ((sample * G + g) * o.parts + part);
    p[0] = gn;
    p[1] = gmean;
    p[2] = gm2;
  }
  finish(o);
}

// NC: block b takes chunk b % parts of channel run b / parts = (n, c), S values.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) group_norm_apply_nc_kernel(const T* __restrict__ x, T* __restrict__ y,
                                                                       int64_t S, int parts,
                                                                       const float* __restrict__ scale,
                                                                       const float* __restrict__ shift) {
  const int64_t run = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  const float a = scale[run], b = shift[run];
  const int64_t vecs = S / V, per = (vecs + parts - 1) / parts;
  const int64_t v0 = part * per, v1 = v0 + per < vecs ? v0 + per : vecs;
  const T* xs = x + run * S;
  T* ys = y + run * S;
  for (int64_t i = v0 + threadIdx.x; i < v1; i += kThreads * kUnroll) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = i + u * kThreads;
      if (j < v1) load<T, V>(xs + j * V, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = i + u * kThreads;
      if (j >= v1) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) v[u][e] = v[u][e] * a + b;
      store<T, V>(ys + j * V, v[u]);
    }
  }
}

// channels-last: block b takes chunk b % parts of the rows of sample b / parts
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) group_norm_apply_cl_kernel(const T* __restrict__ x, T* __restrict__ y,
                                                                       int64_t S, int C, int parts,
                                                                       const float* __restrict__ scale,
                                                                       const float* __restrict__ shift) {
  const int cols = C / V, row_threads = kThreads / cols;
  const int tx = threadIdx.x % cols, ty = threadIdx.x / cols;
  if (ty >= row_threads) return;
  const int64_t sample = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  const int64_t per = (S + parts - 1) / parts;
  const int64_t s0 = part * per, s1 = s0 + per < S ? s0 + per : S;
  float a[V], b[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    a[e] = scale[sample * C + tx * V + e];
    b[e] = shift[sample * C + tx * V + e];
  }
  const int64_t offset = sample * S * C + tx * V;
  for (int64_t s = s0 + ty; s < s1; s += static_cast<int64_t>(row_threads) * kUnroll) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = s + static_cast<int64_t>(u) * row_threads;
      if (row < s1) load<T, V>(x + offset + row * C, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = s + static_cast<int64_t>(u) * row_threads;
      if (row >= s1) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) v[u][e] = v[u][e] * a[e] + b[e];
      store<T, V>(y + offset + row * C, v[u]);
    }
  }
}

int sm_count() {
  static int cached[kMaxDevices] = {0};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) return 132;
  if (cached[device] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cached[device] = sms > 0 ? sms : 132;
  }
  return cached[device];
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

int64_t clamp(int64_t v, int64_t lo, int64_t hi) { return v < lo ? lo : (v > hi ? hi : v); }

// chunks a row (stats) or a channel run / sample (apply) is cut into
struct Plan {
  int64_t rows, parts, apply_parts, smem_bytes;
};

Plan make_plan(int64_t N, int64_t C, int64_t S, int64_t G, int layout, int V) {
  const int64_t sms = sm_count(), per_group = C / G;
  Plan p{N * G, 1, 1, 0};
  if (layout == kNC) {
    const int64_t row_vecs = per_group * S / V, run_vecs = S / V, block_vecs = kThreads * kUnroll;
    p.parts = clamp(ceil_div(kStatsBlocksPerSm * sms, p.rows), 1, row_vecs / block_vecs > 1 ? row_vecs / block_vecs : 1);
    p.apply_parts = clamp(ceil_div(kApplyBlocksPerSm * sms, N * C), 1, run_vecs / block_vecs > 1 ? run_vecs / block_vecs : 1);
    const int64_t exact = ceil_div(per_group * S, kMaxChunkCount);
    p.parts = p.parts > exact ? p.parts : exact;
  } else {
    const int64_t row_threads = kThreads / (C / V), block_rows = row_threads * kUnroll;
    p.parts = clamp(ceil_div(kStatsBlocksPerSm * sms, N), 1, S / block_rows > 1 ? S / block_rows : 1);
    p.apply_parts = clamp(ceil_div(kApplyBlocksPerSm * sms, N), 1, S / block_rows > 1 ? S / block_rows : 1);
    const int64_t exact = ceil_div(per_group * S, kMaxChunkCount);
    p.parts = p.parts > exact ? p.parts : exact;
    p.smem_bytes = (2 * row_threads * C + row_threads) * static_cast<int64_t>(sizeof(float));
  }
  return p;
}

// f32 values of the workspace: the chunks' triples, mean, rstd, a and b
int64_t workspace_floats(int64_t N, int64_t C, int64_t S, int64_t G, int layout, int V) {
  const Plan p = make_plan(N, C, S, G, layout, V);
  return 3 * p.rows * p.parts + 2 * p.rows + 2 * N * C;
}

bool valid(int64_t N, int64_t C, int64_t S, int64_t G, int layout, int V) {
  if (N < 1 || C < 1 || S < 1 || G < 1 || C % G != 0 || (layout != kNC && layout != kCL)) return false;
  if (layout == kNC) return S % V == 0;
  return C % V == 0 && C / V <= kThreads;
}

template <typename T, int V>
cudaError_t launch(const T* x, T* y, float* ws, unsigned* ticket, int64_t S, const Out& proto, int layout,
                   cudaStream_t stream) {
  const Plan p = make_plan(proto.N, proto.C, S, proto.G, layout, V);
  Out o = proto;
  o.parts = static_cast<int>(p.parts);
  o.partial = ws;
  o.mean = ws + 3 * p.rows * p.parts;
  o.rstd = o.mean + p.rows;
  o.scale = o.rstd + p.rows;
  o.shift = o.scale + proto.N * proto.C;
  o.ticket = ticket;
  if (layout == kNC) {
    group_norm_stats_nc_kernel<T, V><<<static_cast<unsigned>(p.rows * p.parts), kThreads, 0, stream>>>(
        x, proto.C / proto.G * S, o);
    group_norm_apply_nc_kernel<T, V><<<static_cast<unsigned>(proto.N * proto.C * p.apply_parts), kThreads, 0,
                                       stream>>>(x, y, S, static_cast<int>(p.apply_parts), o.scale, o.shift);
  } else {
    group_norm_stats_cl_kernel<T, V><<<static_cast<unsigned>(proto.N * p.parts), kThreads, p.smem_bytes, stream>>>(
        x, S, o);
    group_norm_apply_cl_kernel<T, V><<<static_cast<unsigned>(proto.N * p.apply_parts), kThreads, 0, stream>>>(
        x, y, S, static_cast<int>(proto.C), static_cast<int>(p.apply_parts), o.scale, o.shift);
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* weight, const void* bias, void* y, void* workspace, void* ticket, int64_t N,
             int64_t C, int64_t S, int64_t G, int layout, int vectorized, double eps, void* stream) {
  const int V = vectorized ? Pack<T>::kVec : 1;
  if (!valid(N, C, S, G, layout, V)) return static_cast<int>(cudaErrorInvalidValue);
  Out proto{};
  proto.weight = static_cast<const float*>(weight);
  proto.bias = static_cast<const float*>(bias);
  proto.N = N;
  proto.C = C;
  proto.G = G;
  proto.eps = eps;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  float* ws = static_cast<float*>(workspace);
  unsigned* tk = static_cast<unsigned*>(ticket);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = vectorized ? launch<T, Pack<T>::kVec>(xt, yt, ws, tk, S, proto, layout, st)
                                     : launch<T, 1>(xt, yt, ws, tk, S, proto, layout, st);
  return static_cast<int>(err);
}

}  // namespace

// x, y: N x C x S values in `layout` (0: NC-contiguous, 1: channels-last);
// weight, bias: C f32 values or null; workspace: group_norm_workspace_floats
// f32 values, any; ticket: one 32-bit word, 0, used by one stream at a time
// (0 again when the launch ends); vectorized: 16-byte loads (x and y 16-byte
// aligned, S (NC) or C (channels-last) a multiple of 16 / itemsize).
// Returns a cudaError_t.
extern "C" int group_norm_fwd_f32(const void* x, const void* weight, const void* bias, void* y, void* workspace,
                                  void* ticket, int64_t N, int64_t C, int64_t S, int64_t G, int layout,
                                  int vectorized, double eps, void* stream) {
  return dispatch<float>(x, weight, bias, y, workspace, ticket, N, C, S, G, layout, vectorized, eps, stream);
}

extern "C" int group_norm_fwd_bf16(const void* x, const void* weight, const void* bias, void* y, void* workspace,
                                   void* ticket, int64_t N, int64_t C, int64_t S, int64_t G, int layout,
                                   int vectorized, double eps, void* stream) {
  return dispatch<__nv_bfloat16>(x, weight, bias, y, workspace, ticket, N, C, S, G, layout, vectorized, eps,
                                 stream);
}

extern "C" int64_t group_norm_workspace_floats(int64_t N, int64_t C, int64_t S, int64_t G, int layout,
                                               int vectorized, int bf16) {
  const int V = vectorized ? (bf16 ? Pack<__nv_bfloat16>::kVec : Pack<float>::kVec) : 1;
  return valid(N, C, S, G, layout, V) ? workspace_floats(N, C, S, G, layout, V) : -1;
}

extern "C" const char* group_norm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
