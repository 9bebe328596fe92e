// Tensor-core core shared by the 3x3x3 conv kernels on Hopper (sm_90a): K1
// (conv3d_im2col.cu), K2 (conv3d_fwd.cu) and K3 (conv3d_packw.cu). The staging
// ring, the 3xTF32 split, the wgmma wrappers and the output stores.
//
// K1 and K3 are implicit GEMMs on `wgmma.mma_async` with the output features on
// M (64 per warpgroup) and the output pixels on N:
//   D^T[f, pixel] += W^T[f, (tap, c)] . X[(tap, c), pixel]
// - A (the weights) comes from registers. A chunk of the weights is staged raw
//   in shared memory by cp.async and each thread reads its fragment with plain
//   shared loads (any layout works that way: the global weights are F-major,
//   which a tf32 shared-memory A operand, K-major only, could not take), then,
//   in f32, splits it into TF32 hi and lo parts in registers.
// - B (the input) comes from shared memory by descriptor. A block stages a
//   halo'd brick of one input plane, (TH + 2) rows x BW columns of pixels and
//   32 bytes of channels (8 f32 or 16 bf16), in the no-swizzle K-major layout:
//   each 16-byte channel group is a run of pixel rows 16 bytes apart. A core
//   matrix is 8 consecutive pixels, so a descriptor may start at ANY pixel:
//   tap (kh, kw) of the tile's pixels m is brick row m + kh * BW + kw, i.e. the
//   same brick shifted by 16 * (kh * BW + kw) bytes. The brick is read once per
//   channel chunk and serves all 9 in-plane taps (the reuse K1's TPU form gets
//   from VMEM); no im2col copy exists anywhere. Output pixels are indexed on
//   the brick's width BW, so the last 2 columns of each tile row are computed
//   and dropped (BW = 32: 6.25% of the MMAs).
// K2 turns the GEMM around, for the small F of a UNet's first levels (an m64
// feature tile would leave 75% of its rows empty at F = 16):
//   D[pixel, f] += X[pixel, (tap, c)] . W[(tap, c), f]
// - A (64 output pixels) is the same brick by descriptor: the no-swizzle
//   K-major layout is valid for A exactly as for B, at the same shifted starts.
// - B (the weights, N = F rounded up to 16, 32 or 64) is staged K-major by
//   `load_weights_kmajor` from a (3, 3, 3, F, C) copy, and split in shared
//   memory like the brick; both operands come by descriptor (`wgmma_ss`).
// - The fragment holds two pixels x feature pairs a thread, so the NDHWC output
//   takes 8-byte stores (`store_pixels`).
// Common to all three:
// - f32 runs 3xTF32: x = hi + lo with hi = rna_tf32(x), lo = rna_tf32(x - hi),
//   and A.B ~ A_hi.B_hi + A_hi.B_lo + A_lo.B_hi, three tf32 wgmmas into one f32
//   accumulator (a single TF32 pass misses the 1e-4 bound that the kernels are
//   held to; tests/test_torch_port_tc.py pins that). The brick is split in
//   place after it lands (hi over the raw copy, lo beside it) by the thread
//   that copied it, before the barrier that the ring needs anyway.
//   bf16 runs one bf16 wgmma (k16); bf16 products are exact in f32.
// - Staging: cp.async with zero-fill (src-size 0 outside the volume, partial
//   for the channel and feature tails), in 16-, 8- or 4-byte pieces, whichever
//   the row stride allows, so any C and F work without a padded copy of x. Only
//   bf16 rows with an odd element count (2-byte alignment) are staged by plain
//   loads. The kernels keep kStages stages in flight: the copies of stage
//   t + kStages - 1 are issued after the barrier of stage t and overlap its
//   wgmmas.
// - Each staged chunk is summed in registers of its own and added to the
//   running f32 sum (`chunk_mma` in K1 and K3; K2 likewise). In K1 and K3,
//   within a stage the 9 taps are 9 k-steps; the A fragments of tap + 1 are
//   loaded and split while the wgmmas of tap run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

constexpr int kThreads = 256;           // two warpgroups
constexpr int kBM = 64;                 // output features per block (one m64 tile)
constexpr int kFS = kBM + 8;            // staged weight row stride (elements): conflict-free fragment loads
constexpr int kChunkBytes = 32;         // channel bytes per stage: one k-step (k8 tf32, k16 bf16)

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kSize = 4;
  static constexpr bool kSplit = true;  // 3xTF32
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kSize = 2;
  static constexpr bool kSplit = false;
};

template <typename T>
__host__ __device__ constexpr int chunk_channels() { return kChunkBytes / Elem<T>::kSize; }

// bytes of one stage: the brick of `bp` pixels (and its lo part in f32) and
// `kd_slots` depth taps of weights (9 taps x chunk channels rows of kFS elements)
template <typename T>
__host__ __device__ constexpr int weights_offset(int bp) {
  return kChunkBytes * bp * (Elem<T>::kSplit ? 2 : 1);
}
template <typename T>
__host__ __device__ constexpr int stage_bytes(int bp, int kd_slots) {
  return weights_offset<T>(bp) + kd_slots * 9 * chunk_channels<T>() * kFS * Elem<T>::kSize;
}

// ---- copies -----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(kBytes), "r"(src_bytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The widest piece (16, 8, 4 or 2 bytes) that every row start of a tensor
// with `row_elems` elements per row keeps aligned.
__host__ __device__ inline int piece_bytes(int64_t row_elems, int elem_size) {
  const int64_t row = row_elems * elem_size;
  return row % 16 == 0 ? 16 : row % 8 == 0 ? 8 : row % 4 == 0 ? 4 : 2;
}

// 16 bytes at `dst` <- the first `valid` bytes at `src`, zeros after them
// (`valid` <= 0: all zeros, src unread). `src` is aligned to `piece`.
// (`any` is a valid global address, given to the zero-byte copies.)
__device__ __forceinline__ void copy16(char* dst, const char* src, int valid, int piece, const void* any) {
  const uint32_t d = smem_u32(dst);
  if (piece == 16) {
    cp_async<16>(d, valid > 0 ? src : any, valid > 0 ? min(valid, 16) : 0);
  } else if (piece == 8) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int v = min(max(valid - 8 * k, 0), 8);
      cp_async<8>(d + 8 * k, v > 0 ? src + 8 * k : any, v);
    }
  } else if (piece == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = min(max(valid - 4 * k, 0), 4);
      cp_async<4>(d + 4 * k, v > 0 ? src + 4 * k : any, v);
    }
  } else {  // 2-byte rows (bf16, odd element count): plain loads
    uint16_t* out = reinterpret_cast<uint16_t*>(dst);
    const uint16_t* in = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = 2 * k < valid ? in[k] : static_cast<uint16_t>(0);
  }
}

// ---- 3xTF32 -----------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// ---- the brick ----------------------------------------------------------------

// Brick geometry of one block: output tile rows [h0, h0 + TH) x columns
// [w0, w0 + BW - 2), brick pixel q = rr * BW + jj <-> input (h0 - 1 + rr, w0 - 1 + jj),
// q < bp. Pixels past (TH + 2) * BW, or outside the plane, are zeros.
struct Brick {
  int h0, w0, bw, th, bp;
};

// Issues this thread's copies of the brick of input plane `plane` (index n * D
// + p into x), channels [c0, c0 + chunk), into `dst`: chunk e = (q, cg), cg
// fastest, so two neighbouring threads read a pixel's 32 bytes.
template <typename T>
__device__ __forceinline__ void load_brick(char* dst, const T* __restrict__ x, int64_t plane, int H, int W, int C,
                                           int c0, const Brick& br, int piece, int tid) {
  constexpr int kGroupElems = 16 / Elem<T>::kSize;
  const int pixels_in = (br.th + 2) * br.bw;
  for (int e = tid; e < 2 * br.bp; e += kThreads) {
    const int cg = e & 1;
    const int q = e >> 1;
    const int rr = q / br.bw;
    const int h = br.h0 - 1 + rr;
    const int w = br.w0 - 1 + (q - rr * br.bw);
    const int ch = c0 + cg * kGroupElems;
    const bool inside = q < pixels_in && h >= 0 && h < H && w >= 0 && w < W;
    const int valid = inside ? min(C - ch, kGroupElems) * Elem<T>::kSize : 0;
    const T* src = x + ((plane * H + h) * W + w) * C + ch;
    copy16(dst + (cg * br.bp + q) * 16, reinterpret_cast<const char*>(src), valid, piece, x);
  }
}

// f32: splits the 16 bytes at `p` into hi (in place) and lo (at p + lo_off).
__device__ __forceinline__ void split16(char* p, int lo_off) {
  float4 v = *reinterpret_cast<float4*>(p);
  uint4 hi, lo;
  split_tf32(v.x, hi.x, lo.x);
  split_tf32(v.y, hi.y, lo.y);
  split_tf32(v.z, hi.z, lo.z);
  split_tf32(v.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(p) = hi;
  *reinterpret_cast<uint4*>(p + lo_off) = lo;
}

// f32: splits the chunks this thread copied into hi (in place) and lo (at +lo_off).
__device__ __forceinline__ void split_brick(char* brick, int lo_off, const Brick& br, int tid) {
  for (int e = tid; e < 2 * br.bp; e += kThreads) split16(brick + ((e & 1) * br.bp + (e >> 1)) * 16, lo_off);
}

// ---- the weights ---------------------------------------------------------------

// Issues this thread's copies of w[kd, tap, c0 + c, f0 .. f0 + 63] for the
// depth taps kd set in `kd_mask` into slot `slot_of(kd)` of `dst`: row
// ((slot * 9 + tap) * chunk + c), kFS elements a row. Rows of c >= C and
// features >= F are zeros.
template <typename T>
__device__ __forceinline__ void load_weights(char* dst, const T* __restrict__ w, int C, int F, int c0, int f0,
                                             int kd_mask, bool compact, int piece, int tid) {
  constexpr int kCK = chunk_channels<T>();
  constexpr int kRowChunks = kBM * Elem<T>::kSize / 16;
  constexpr int kGroupElems = 16 / Elem<T>::kSize;
  constexpr int kPerKd = 9 * kCK * kRowChunks;
  for (int e = tid; e < 3 * kPerKd; e += kThreads) {
    const int kd = e / kPerKd;
    if (!(kd_mask & (1 << kd))) continue;
    const int r = e - kd * kPerKd;
    const int chunk = r % kRowChunks;
    const int row = r / kRowChunks;  // tap * kCK + c
    const int c = row % kCK;
    const int tap = row / kCK;
    const int f = f0 + chunk * kGroupElems;
    const int valid = c0 + c < C ? min(max(F - f, 0), kGroupElems) * Elem<T>::kSize : 0;
    const T* src = w + (static_cast<int64_t>(kd * 9 + tap) * C + c0 + c) * F + f;
    const int slot = compact ? 0 : kd;
    copy16(dst + (((slot * 9 + tap) * kCK + c) * kFS + chunk * kGroupElems) * Elem<T>::kSize,
              reinterpret_cast<const char*>(src), valid, piece, w);
  }
}

// K2's B operand. Issues this thread's copies of wk[kd, tap, f0 + r, c0 .. c0 +
// chunk) (wk (3, 3, 3, F, C): the weights K-major) into `dst`, 9 taps x 2
// channel groups x N rows of 16 bytes: row r of group cg of tap at
// ((tap * 2 + cg) * N + r) * 16, so one tap is a K-major N x 32-byte tile (LBO
// 16 N, SBO 128). Rows of features >= F and channels >= C are zeros.
template <typename T, int N>
__device__ __forceinline__ void load_weights_kmajor(char* dst, const T* __restrict__ wk, int C, int F, int c0,
                                                    int f0, int kd, int piece, int tid) {
  constexpr int kGroupElems = 16 / Elem<T>::kSize;
  for (int e = tid; e < 9 * N * 2; e += kThreads) {
    const int cg = e & 1;
    const int r = (e >> 1) % N;
    const int tap = (e >> 1) / N;
    const int ch = c0 + cg * kGroupElems;
    const int valid = f0 + r < F ? min(C - ch, kGroupElems) * Elem<T>::kSize : 0;
    const T* src = wk + (static_cast<int64_t>(kd * 9 + tap) * F + f0 + r) * C + ch;
    copy16(dst + ((tap * 2 + cg) * N + r) * 16, reinterpret_cast<const char*>(src), valid, piece, wk);
  }
}

// f32: splits the weight chunks this thread copied (`load_weights_kmajor`).
template <int N>
__device__ __forceinline__ void split_weights(char* ws, int lo_off, int tid) {
  for (int e = tid; e < 9 * N * 2; e += kThreads) {
    const int tap = (e >> 1) / N;
    split16(ws + ((tap * 2 + (e & 1)) * N + (e >> 1) % N) * 16, lo_off);
  }
}

// A fragments of one k-step (one tap) of one weight slot. Thread (warp wq of
// its warpgroup, lane = 4 g + t) holds rows r0 = 16 wq + g and r0 + 8; tf32
// k8: columns t and t + 4; bf16 k16: column pairs (2t, 2t+1) and (2t+8, 2t+9).
struct FragF32 {
  uint32_t hi[4], lo[4];
};
struct FragBF16 {
  uint32_t a[4];
};

__device__ __forceinline__ void load_frag(FragF32& fr, const char* ws, int slot, int tap, int r0, int t) {
  const float* rows = reinterpret_cast<const float*>(ws) + (slot * 9 + tap) * chunk_channels<float>() * kFS;
  const float v[4] = {rows[t * kFS + r0], rows[t * kFS + r0 + 8], rows[(t + 4) * kFS + r0],
                      rows[(t + 4) * kFS + r0 + 8]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], fr.hi[i], fr.lo[i]);
}

__device__ __forceinline__ void load_frag(FragBF16& fr, const char* ws, int slot, int tap, int r0, int t) {
  const uint16_t* rows = reinterpret_cast<const uint16_t*>(ws) + (slot * 9 + tap) * chunk_channels<__nv_bfloat16>() * kFS;
  const int k0 = 2 * t;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + (i >> 1) * 8;
    const int r = r0 + (i & 1) * 8;
    fr.a[i] = static_cast<uint32_t>(rows[k * kFS + r]) | (static_cast<uint32_t>(rows[(k + 1) * kFS + r]) << 16);
  }
}

// ---- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor, no swizzle: start address, LBO = byte
// distance of the two 16-byte core-matrix columns along K, SBO = byte distance
// of consecutive 8-row core matrices (128: the rows are contiguous).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

#define TC_ACC32(d)                                                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),   \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),    \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define TC_REGS32                                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 f32, accumulated) += a (64 x 8 tf32, registers) . b (8 x 64 tf32, descriptor)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TC_REGS32
               ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : TC_ACC32(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 64 f32, accumulated) += a (64 x 16 bf16, registers) . b (16 x 64 bf16, descriptor, K-major)
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_REGS32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
               : TC_ACC32(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

#define TC_ACC8(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define TC_ACC16(d)                                                                                           \
  TC_ACC8(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define TC_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define TC_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// K2: d (64 x N f32) = a (64 x k, descriptor, K-major) . b (k x N, descriptor,
// K-major) + (accumulate ? d : 0), for N = 2 x the size of d: k8 tf32, k16 bf16
template <typename T>
__device__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b, int accumulate);
template <typename T>
__device__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate);
template <typename T>
__device__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate);

#define TC_WGMMA_SS(T, NR, NN, KIND, TAIL, REGS, ACC, IA, IB, IP)                                             \
  template <>                                                                                                \
  __device__ __forceinline__ void wgmma_ss<T>(float(&d)[NR], uint64_t a, uint64_t b, int accumulate) {       \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IP ", 0;\n"                                            \
                 "wgmma.mma_async.sync.aligned.m64n" #NN KIND " " REGS ", %" #IA ", %" #IB ", p, 1, 1" TAIL  \
                 ";\n}\n"                                                                                    \
                 : ACC(d)                                                                                    \
                 : "l"(a), "l"(b), "r"(accumulate));                                                         \
  }
TC_WGMMA_SS(float, 8, 16, "k8.f32.tf32.tf32", "", TC_REGS8, TC_ACC8, 8, 9, 10)
TC_WGMMA_SS(float, 16, 32, "k8.f32.tf32.tf32", "", TC_REGS16, TC_ACC16, 16, 17, 18)
TC_WGMMA_SS(float, 32, 64, "k8.f32.tf32.tf32", "", TC_REGS32, TC_ACC32, 32, 33, 34)
TC_WGMMA_SS(__nv_bfloat16, 8, 16, "k16.f32.bf16.bf16", ", 0, 0", TC_REGS8, TC_ACC8, 8, 9, 10)
TC_WGMMA_SS(__nv_bfloat16, 16, 32, "k16.f32.bf16.bf16", ", 0, 0", TC_REGS16, TC_ACC16, 16, 17, 18)
TC_WGMMA_SS(__nv_bfloat16, 32, 64, "k16.f32.bf16.bf16", ", 0, 0", TC_REGS32, TC_ACC32, 32, 33, 34)
#undef TC_WGMMA_SS

// d += A . X over one k-step: 3xTF32 in f32 (x's hi at desc, lo at desc_lo)
__device__ __forceinline__ void mma_step(float (&d)[32], const FragF32& fr, uint64_t desc, uint64_t desc_lo) {
  wgmma_tf32(d, fr.lo, desc);
  wgmma_tf32(d, fr.hi, desc_lo);
  wgmma_tf32(d, fr.hi, desc);
}
__device__ __forceinline__ void mma_step(float (&d)[32], const FragBF16& fr, uint64_t desc, uint64_t) {
  wgmma_bf16(d, fr.a, desc);
}

template <typename T>
struct Frag;
template <>
struct Frag<float> {
  using type = FragF32;
};
template <>
struct Frag<__nv_bfloat16> {
  using type = FragBF16;
};

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// One staged chunk through the tensor cores: d[j] = sum over the 9 taps of
// W[slot, tap] . brick(pixels + 64 j + tap shift), where `brick` is the shared
// address of the chunk's brick plus 16 x the warpgroup's first pixel. d must be
// zero on entry: each chunk is summed apart (K = 72 f32 or 144 bf16 products a
// row) and the caller adds it to its accumulator with an f32 add. The tensor
// cores' own f32 accumulation truncates; over the whole K = 27C (up to 13,824)
// that drifts to ~1e-4 of max|y|, the bound the kernels are held to, while a
// chunk's few truncations stay at f32 noise. The fragments of tap + 1 load
// into the other buffer while the wgmmas of tap run.
template <typename T, int NACC, int kLoOff, int kLbo>
__device__ __forceinline__ void chunk_mma(float (&d)[NACC][32], const char* ws, int slot, uint32_t brick, int bw,
                                          int r0, int t) {
  typename Frag<T>::type fr[2];
  load_frag(fr[0], ws, slot, 0, r0, t);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const uint32_t at = brick + ((tap / 3) * bw + tap % 3) * 16;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      mma_step(d[j], fr[tap & 1], make_desc(at + j * 64 * 16, kLbo), make_desc(at + kLoOff + j * 64 * 16, kLbo));
    wgmma_commit();
    if (tap < 8) {
      wgmma_wait<1>();  // tap - 1 is done with the other buffer
      load_frag(fr[(tap + 1) & 1], ws, slot, tap + 1, r0, t);
    }
  }
  wgmma_wait<0>();
}

__device__ __forceinline__ void add_to(float (&acc)[32], const float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += d[i];
}

// ---- output ------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// Writes d (features f0 + 16 wq + g (+8) by brick pixels pix0 + 8 j + 2 t (+1))
// with the bias to output plane `plane` (n * D + d) of y; drops the tile's 2
// wrap columns and everything outside the volume or past F.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ y, const float (&d)[32], const T* __restrict__ b,
                                           int64_t plane, int H, int W, int F, int f0, int pix0, const Brick& br,
                                           int wq, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  float bias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = f0 + 16 * wq + g + 8 * i;
    bias[i] = (b != nullptr && f < F) ? to_f32(b[f]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = pix0 + 8 * j + 2 * t + e;
      const int rr = m / br.bw;
      const int jj = m - rr * br.bw;
      const int h = br.h0 + rr;
      const int w = br.w0 + jj;
      if (jj >= br.bw - 2 || h >= H || w >= W) continue;
      T* out = y + ((plane * H + h) * W + w) * F;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int f = f0 + 16 * wq + g + 8 * i;
        if (f < F) out[f] = from_f32<T>(d[4 * j + 2 * i + e] + bias[i]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* out, float v0, float v1);
template <>
__device__ __forceinline__ void store_pair<float>(float* out, float v0, float v1) {
  *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* out, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
}

// K2: writes d (brick pixels m0 + 16 wq + g (+8) by features f0 + 8 j + 2 t
// (+1), j < N / 8) with the bias to output plane `plane` (n * D + d) of y: a
// thread's two features are adjacent in NDHWC, one 8-byte store (4 in bf16)
// when F is even. Drops the tile's 2 wrap columns, rows past the tile's TH and
// everything outside the volume or past F.
template <typename T, int N>
__device__ __forceinline__ void store_pixels(T* __restrict__ y, const float (&d)[N / 2], const T* __restrict__ b,
                                             int64_t plane, int H, int W, int F, int f0, int m0, const Brick& br,
                                             int wq, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + 16 * wq + g + 8 * i;
    const int rr = m / br.bw;
    const int jj = m - rr * br.bw;
    const int h = br.h0 + rr;
    const int w = br.w0 + jj;
    if (rr >= br.th || jj >= br.bw - 2 || h >= H || w >= W) continue;
    T* out = y + ((plane * H + h) * W + w) * F;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int f = f0 + 8 * j + 2 * t;
      const float v0 = d[4 * j + 2 * i] + (b != nullptr && f < F ? to_f32(b[f]) : 0.f);
      const float v1 = d[4 * j + 2 * i + 1] + (b != nullptr && f + 1 < F ? to_f32(b[f + 1]) : 0.f);
      if (f + 1 < F && F % 2 == 0) {
        store_pair<T>(out + f, v0, v1);
      } else {
        if (f < F) out[f] = from_f32<T>(v0);
        if (f + 1 < F) out[f + 1] = from_f32<T>(v1);
      }
    }
  }
}

// Brick width for planes W wide: 16 up to W = 14 (one tile of 14 columns),
// else 32 (tiles of 30 columns).
__host__ __device__ inline int brick_width(int64_t W) { return W <= 14 ? 16 : 32; }

}  // namespace tc
