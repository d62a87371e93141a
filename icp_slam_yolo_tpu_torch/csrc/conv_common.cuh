// Shared by conv.cu (K5-K7) and c2f.cu (K8): one block-level tile of a matrix
// product C = A x W with a float32 sum, where A is read through a functor (so
// a caller can gather an im2col row from an image or from shared memory) and
// W is a row-major K x N weight matrix in device memory.
//
// A block of 256 threads computes a BM x BN tile (BM * BN = 4096).  The K
// axis is walked in chunks of 32: the chunk of A (BM x 32) and of W (32 x BN)
// are staged in shared memory, then multiplied.  Ragged edges (rows past the
// end, K or N not a multiple of the tile) are zero-filled at staging and
// masked by the caller's epilogue.  Two bodies, by the operands' type:
//
//   float32:  staged as float32; each thread owns a 4 x 4 patch and runs 32
//             steps of 4 + 4 shared loads and 16 FMAs.
//   bfloat16: staged as bfloat16 (W transposed, so both operands have K
//             contiguous); each warp owns four 16 x 8 tiles and multiplies
//             them on the tensor cores, `mma.sync.m16n8k16` with a float32
//             sum, two K steps a chunk.  Rows are padded to 40 values (80
//             bytes), which spreads a fragment's eight rows over all banks.
//
// With 64 x 64 tiles the next chunk is fetched into registers while this one
// is multiplied; the wider row tiles would hold 16 or 32 values a thread in
// flight and measured slower that way, so they stage directly.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace slamconv {

constexpr int kThreads = 256;
constexpr int kBK = 32;               // K chunk
constexpr int kAStride = kBK + 1;     // float32 body: padded row of the staged A chunk
constexpr int kHalfStride = kBK + 8;  // bfloat16 body: padded row of either staged operand

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// Floats of shared memory the staging areas need (the float32 body's: the W
// chunk first, read as float4, then the A chunk; the bfloat16 body needs less
// and uses the same area).
template <int BN>
__host__ __device__ constexpr int stage_floats() { return kBK * BN + (4096 / BN) * kAStride; }

// The chunk loop both bodies share.  A thread's i-th value of the A chunk is
// at row tid / 32 + 8 i, column tid % 32; its i-th value of the W chunk at
// flat index tid + 256 i of the 32 x BN chunk.  `store_a(row, col, v)` and
// `store_b(k, n, v)` put a value into the staged operands, `multiply()`
// consumes a staged chunk.  Per chunk: stage (directly, or from the registers
// a prefetch filled), barrier, prefetch the next chunk, multiply, barrier.
template <int BN, typename T, typename ALoad, typename StoreA, typename StoreB, typename Multiply>
__device__ __forceinline__ void chunk_loop(const ALoad& aload, const T* __restrict__ w, int K, int N,
                                           int n0, const StoreA& store_a, const StoreB& store_b,
                                           const Multiply& multiply) {
  constexpr int BM = 4096 / BN;
  constexpr int A_PER = BM * kBK / kThreads, B_PER = kBK * BN / kThreads;
  constexpr bool kPrefetch = BN == 64;
  const int tid = threadIdx.x;
  const int kk = tid % kBK, mrow = tid / kBK;

  auto load = [&](int k0, auto&& sink_a, auto&& sink_b) {
    // every load is issued whether or not its element exists (at a clamped
    // address) and masked afterwards, so the loads of a chunk go out together
    const int k = k0 + kk;
    const bool kok = k < K;
    const auto kc = aload.prep(kok ? k : 0);
    float va[A_PER], vb[B_PER];
#pragma unroll
    for (int i = 0; i < A_PER; ++i) va[i] = aload.load(mrow + i * (kThreads / kBK), kc);
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * kThreads;
      const int kb = k0 + idx / BN, n = n0 + idx % BN;
      const bool ok = kb < K && n < N;
      vb[i] = to_f32(w[ok ? (size_t)kb * N + n : 0]);
      vb[i] = ok ? vb[i] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < A_PER; ++i) sink_a(i, kok ? va[i] : 0.f);
#pragma unroll
    for (int i = 0; i < B_PER; ++i) sink_b(i, vb[i]);
  };
  auto stage_a = [&](int i, float v) { store_a(mrow + i * (kThreads / kBK), kk, v); };
  auto stage_b = [&](int i, float v) {
    const int idx = tid + i * kThreads;
    store_b(idx / BN, idx % BN, v);
  };
  float ra[kPrefetch ? A_PER : 1], rb[kPrefetch ? B_PER : 1];
  auto reg_a = [&](int i, float v) { ra[i] = v; };
  auto reg_b = [&](int i, float v) { rb[i] = v; };

  if constexpr (kPrefetch) load(0, reg_a, reg_b);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    if constexpr (kPrefetch) {
#pragma unroll
      for (int i = 0; i < A_PER; ++i) stage_a(i, ra[i]);
#pragma unroll
      for (int i = 0; i < B_PER; ++i) stage_b(i, rb[i]);
    } else {
      load(k0, stage_a, stage_b);
    }
    __syncthreads();
    if constexpr (kPrefetch) {
      if (k0 + kBK < K) load(k0 + kBK, reg_a, reg_b);
    }
    multiply();
    __syncthreads();
  }
}

// One BM x BN tile.  `aload.prep(k)` decodes a K index once per chunk for
// the calling thread; `aload.load(m, kc)` returns A[m, k] as float for the
// tile's local row m (0 for rows that do not exist).  `epi(m, n, v)` takes
// the finished sums: local row m, global column n (it masks n >= N).
// Ends with all threads past a barrier; the epilogue runs after it.
template <int BN, typename T, typename ALoad, typename Epi>
__device__ __forceinline__ void gemm_tile(float* __restrict__ stage, const ALoad& aload,
                                          const T* __restrict__ w, int K, int N, int n0,
                                          const Epi& epi) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int BM = 4096 / BN;
    constexpr int TILES_N = BN / 8;                 // 16 x 8 tiles across the block tile
    constexpr int WN = TILES_N >= 4 ? 4 : TILES_N;  // tiles of a warp across ...
    constexpr int WM = 4 / WN;                      // ... and down: four in all
    constexpr int WARPS_N = TILES_N / WN;
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(stage);  // BM rows of 40
    __nv_bfloat16* Bt = As + BM * kHalfStride;                    // BN rows of 40: W transposed
    const int lane = tid % 32, wid = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int mt0 = (wid / WARPS_N) * WM, nt0 = (wid % WARPS_N) * WN;
    float acc[WM][WN][4];
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    auto store_a = [&](int m, int c, float v) { As[m * kHalfStride + c] = __float2bfloat16_rn(v); };
    auto store_b = [&](int k, int n, float v) { Bt[n * kHalfStride + k] = __float2bfloat16_rn(v); };
    // Fragments of m16n8k16 (lane = 4 g + t): A holds rows g and g + 8 at
    // columns 2t, 2t + 1 and 2t + 8, 2t + 9; B holds column g at the same
    // four K indices; C holds rows g and g + 8 at columns 2t, 2t + 1.
    auto multiply = [&]() {
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        uint32_t b[WN][2];
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const __nv_bfloat16* p = &Bt[((nt0 + j) * 8 + g) * kHalfStride + ks + 2 * t];
          b[j][0] = *reinterpret_cast<const uint32_t*>(p);
          b[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
        }
#pragma unroll
        for (int i = 0; i < WM; ++i) {
          const __nv_bfloat16* p = &As[((mt0 + i) * 16 + g) * kHalfStride + ks + 2 * t];
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(p);
          const uint32_t a1 = *reinterpret_cast<const uint32_t*>(p + 8 * kHalfStride);
          const uint32_t a2 = *reinterpret_cast<const uint32_t*>(p + 8);
          const uint32_t a3 = *reinterpret_cast<const uint32_t*>(p + 8 * kHalfStride + 8);
#pragma unroll
          for (int j = 0; j < WN; ++j) {
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                : "+f"(acc[i][j][0]), "+f"(acc[i][j][1]), "+f"(acc[i][j][2]), "+f"(acc[i][j][3])
                : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b[j][0]), "r"(b[j][1]));
          }
        }
      }
    };
    chunk_loop<BN>(aload, w, K, N, n0, store_a, store_b, multiply);
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const int r = (mt0 + i) * 16 + g, c = n0 + (nt0 + j) * 8 + 2 * t;
        epi(r, c, acc[i][j][0]);
        epi(r, c + 1, acc[i][j][1]);
        epi(r + 8, c, acc[i][j][2]);
        epi(r + 8, c + 1, acc[i][j][3]);
      }
  } else {
    constexpr int TX = BN / 4;
    float* Bs = stage;
    float* As = stage + kBK * BN;
    const int tx = tid % TX, ty = tid / TX;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    auto store_a = [&](int m, int c, float v) { As[m * kAStride + c] = v; };
    auto store_b = [&](int k, int n, float v) { Bs[k * BN + n] = v; };
    auto multiply = [&]() {
#pragma unroll 8
      for (int r = 0; r < kBK; ++r) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[(ty * 4 + i) * kAStride + r];
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[r * BN + tx * 4]);
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    };
    chunk_loop<BN>(aload, w, K, N, n0, store_a, store_b, multiply);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(ty * 4 + i, n0 + tx * 4 + j, acc[i][j]);
  }
}

}  // namespace slamconv
