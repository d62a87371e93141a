// Shared by conv.cu (K5-K7) and c2f.cu (K8).  Two kinds of block tile of a
// matrix product C = A x W with a float32 sum:
//
//   float32 (`gemm_tile`): 256 threads, a BM x BN tile (BM * BN = 4096).  The
//     K axis is walked in chunks of 32; the chunk of A (read through a functor,
//     so a caller can gather an im2col row from an image or from shared
//     memory) and of W (row-major K x N in device memory) are staged in shared
//     memory as float32, then each thread multiplies its 4 x 4 patch with
//     FMAs.  Ragged edges are zero-filled at staging and masked by the
//     caller's epilogue.  With 64 x 64 tiles the next chunk is fetched into
//     registers while this one is multiplied.  No TF32: the sums are float32.
//   bfloat16: the helpers below, from which conv.cu and c2f.cu build their
//     pipelined tiles: 16-byte `cp.async` copies (zero-filled where the
//     source does not exist) into a ring of shared-memory stages, fragments
//     read with `ldmatrix` (A) and `ldmatrix.trans` (W, stored K x N as it is
//     in device memory), `mma.sync.m16n8k16` on the tensor cores.  Every
//     shared row that `ldmatrix` reads is padded to an odd number of 16-byte
//     units, so the eight rows of one `ldmatrix` phase fall in eight distinct
//     bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace slamconv {

constexpr int kThreads = 256;
constexpr int kBK = 32;               // K chunk
constexpr int kAStride = kBK + 1;     // float32 body: padded row of the staged A chunk
constexpr int kARow = kBK + 8;        // bfloat16: staged A row, 40 values = 5 units of 16 bytes

// ---- bfloat16 building blocks (sm_90a)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; `bytes` 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// A fragment of m16n8k16 from a row-major 16 x 16 tile: lane l gives the
// address of row (l % 8) + 8 ((l / 8) % 2), columns 8 (l / 16) .. + 7
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// B fragments of two m16n8k16 (n 0-7 in r[0..1], n 8-15 in r[2..3]) from a
// K x N tile stored row-major: lane l gives the address of K row
// (l % 8) + 8 ((l / 8) % 2), columns 8 (l / 16) .. + 7
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
// The bfloat16 kernels' SiLU: the fast exponential and division (relative
// error ~1e-6, far below a bfloat16 step); below -80 the result is -0.
__device__ __forceinline__ float silu_fast(float v) {
  return v < -80.f ? -0.f : __fdividef(v, 1.0f + __expf(-v));
}

// ---- distributed shared memory (a thread-block cluster)

// the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t saddr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(saddr), "r"(rank));
  return r;
}
// stores into another block's shared memory: they wait for no answer
__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}
// the two halves of a cluster barrier: arrive (no ordering) early, wait
// before the first store into another block (every block then runs)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// Floats of shared memory the float32 staging areas need: the W chunk
// first, read as float4, then the A chunk.
template <int BN>
__host__ __device__ constexpr int stage_floats() { return kBK * BN + (4096 / BN) * kAStride; }

// The float32 chunk loop.  A thread's i-th value of the A chunk is
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

// One float32 BM x BN tile.  `aload.prep(k)` decodes a K index once per
// chunk for the calling thread; `aload.load(m, kc)` returns A[m, k] as float
// for the tile's local row m (0 for rows that do not exist).  `epi(m, n, v)`
// takes the finished sums: local row m, global column n (it masks n >= N).
// Ends with all threads past a barrier; the epilogue runs after it.
template <int BN, typename ALoad, typename Epi>
__device__ __forceinline__ void gemm_tile(float* __restrict__ stage, const ALoad& aload,
                                          const float* __restrict__ w, int K, int N, int n0,
                                          const Epi& epi) {
  constexpr int TX = BN / 4;
  float* Bs = stage;
  float* As = stage + kBK * BN;
  const int tid = threadIdx.x;
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

// ---- warpgroup products (wgmma), operands in shared memory

// Descriptor of an operand tile in the 128-byte swizzled layout, built of
// 64-value-wide (128-byte) atoms: row r of an atom at byte 128 r, its 16-byte
// chunk j at chunk j ^ (r % 8); groups of 8 rows 1024 bytes apart; 1024-byte
// aligned.  `atoms`: the stride of 64-wide atoms along N of an N-major (K x N)
// operand, which a 64-wide tile does not use.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr, uint32_t atoms = 1024) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)((atoms >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
// cp.async's writes become visible to the tensor cores' reads (another proxy)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// keeps the compiler from moving reads of d across an asynchronous product
template <int N>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16, K-major) x B (16 x 64, stored K x N: N-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same, 128 columns: B is two 64-column atoms `atoms` bytes apart (wgmma_desc)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- barriers in shared memory (mbarrier), named barriers, register shares

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// the initialised barriers become visible to every thread (then a block barrier)
__device__ __forceinline__ void fence_mbar_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar) : "memory");
}
// until the barrier's phase of this parity has completed; a phase that
// never completes is a fault of the kernel: after 2^24 polls the launch
// fails rather than hold the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
  }
}
// a barrier of `count` threads (whole warps) under the hardware barrier `id` (0 is __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// a warpgroup gives up registers, or takes them, down or up to N a thread
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N)); }
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N)); }

// One k16 step of a warp on the tensor cores: MT row tiles of 16 (lane
// addresses `a[i]` for `ldmatrix_x4`; tiles i >= `mt_count` are skipped)
// times NP pairs of 8-column tiles (lane addresses `b[j]` for
// `ldmatrix_x4_trans`), summed into `acc[i][2 j + h]`.
template <int MT, int NP>
__device__ __forceinline__ void warp_k16(float (&acc)[MT][2 * NP][4], const uint32_t (&a)[MT], int mt_count,
                                         const uint32_t (&b)[NP]) {
  uint32_t bf[NP][4];
#pragma unroll
  for (int j = 0; j < NP; ++j) ldmatrix_x4_trans(bf[j], b[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i < mt_count) {
      uint32_t af[4];
      ldmatrix_x4(af, a[i]);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        mma_bf16(acc[i][2 * j], af, bf[j][0], bf[j][1]);
        mma_bf16(acc[i][2 * j + 1], af, bf[j][2], bf[j][3]);
      }
    }
  }
}

}  // namespace slamconv
