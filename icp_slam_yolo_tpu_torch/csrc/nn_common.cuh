// What K1 (icp.cu) and K3 (nn.cu) share: the nearest-neighbour scan over
// targets staged in shared memory, the (d^2, index) order that merges
// partial minima, the 64-bit key that lets atomicMin merge them, and the
// distributed-shared-memory stores of a thread-block cluster (K2 and K4,
// raster.cu, use the cluster helpers too).
//
// Both sources are built with -fmad=false: d^2 = dx*dx + dy*dy rounds as the
// plain PyTorch version's separate multiplies and add do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace slam_nn {

constexpr float kBig = 1e30f;  // d^2 of "no valid target"
constexpr float kFar = 1e18f;  // coordinates of an invalid target slot: d^2 ~1e36 never beats kBig
constexpr int kNoIndex = 0x7fffffff;
// the key of "no match yet": above every key of a real d^2 (d^2 >= 0 is
// never NaN, so its bits as an unsigned integer keep the float order)
constexpr unsigned long long kNoKey = ~0ull;

// (d, i) before (bd, bi) in the order (d^2, index): the lower index wins on
// equal d^2, so any merge of partial minima keeps the first index overall
__device__ __forceinline__ bool nn_before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__device__ __forceinline__ unsigned long long nn_key(float d2, int idx) {
  return (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) | static_cast<unsigned>(idx);
}
__device__ __forceinline__ int nn_key_index(unsigned long long key) {
  return static_cast<int>(static_cast<unsigned>(key));
}

__device__ __forceinline__ float nn_d2(float px, float py, float2 t) {
  const float dx = px - t.x;
  const float dy = py - t.y;
  return dx * dx + dy * dy;
}

// R source points (px, py) against the staged targets tile[k] for k = k0,
// k0 + step, ... < k1: each keeps its minimum d^2 in best and, where this
// call lowered it, base + k for the first k that reaches it in arg.  One
// shared-memory load feeds R pairs, and the R chains interleave.
//
// G = 1: a compare and select per pair (strict `<` in increasing k), about 8
// instructions a pair.  G > 1: the targets go in groups of G; a row takes
// the minimum over a group (a tree of min instructions) and compares that
// with its best, keeping the first group that holds its minimum; at the end
// the first k of that group at the minimum is found again.  The same result
// at about 6 instructions a pair, for one more group's work a row: worth it
// when a thread has many groups (K1), not for K3's short scans.  The lanes
// of a warp find their groups again at addresses of their own, so give
// G > 1 contiguous targets (step 1): a stride that is a multiple of the 32
// banks puts every lane's loads into one bank.
template <int R, int G>
__device__ __forceinline__ void nn_scan(const float2* __restrict__ tile, int base, int k0, int k1, int step,
                                        const float (&px)[R], const float (&py)[R], float (&best)[R],
                                        int (&arg)[R]) {
  if (G == 1) {
#pragma unroll 4
    for (int k = k0; k < k1; k += step) {
      const float2 t = tile[k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = nn_d2(px[r], py[r], t);
        if (d < best[r]) {
          best[r] = d;
          arg[r] = base + k;
        }
      }
    }
    return;
  }
  int first[R];  // first k of the group that holds the minimum (-1: not lowered here)
#pragma unroll
  for (int r = 0; r < R; ++r) first[r] = -1;
  int k = k0;
  for (; k + (G - 1) * step < k1; k += G * step) {
    float2 t[G];
#pragma unroll
    for (int g = 0; g < G; ++g) t[g] = tile[k + g * step];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float d[G];
#pragma unroll
      for (int g = 0; g < G; ++g) d[g] = nn_d2(px[r], py[r], t[g]);
#pragma unroll
      for (int w = 1; w < G; w *= 2) {
#pragma unroll
        for (int g = 0; g + w < G; g += 2 * w) d[g] = fminf(d[g], d[g + w]);
      }
      if (d[0] < best[r]) {
        best[r] = d[0];
        first[r] = k;
      }
    }
  }
  for (; k < k1; k += step) {  // the rest, as groups of one
    const float2 t = tile[k];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float d = nn_d2(px[r], py[r], t);
      if (d < best[r]) {
        best[r] = d;
        first[r] = k;
      }
    }
  }
  // the group again, its loads all at once: the first k at the minimum
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (first[r] < 0) continue;
    int hit = first[r];
#pragma unroll
    for (int g = G - 1; g >= 0; --g) {
      const int kk = first[r] + g * step;
      const float2 t = tile[min(kk, k1 - 1)];
      if (kk < k1 && nn_d2(px[r], py[r], t) == best[r]) hit = kk;
    }
    arg[r] = base + hit;
  }
}

// ---- distributed shared memory (a thread-block cluster)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t saddr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(saddr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float d, int i) {
  asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(__float_as_uint(d)), "r"(i)
               : "memory");
}
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
// a cluster barrier in two halves: arrive early without ordering, wait
// before the first store into another block (every block then runs)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }
// a whole cluster barrier that makes the stores before it visible after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace slam_nn
