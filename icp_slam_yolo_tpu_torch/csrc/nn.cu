// K3: nearest valid target per source point, as (min d^2, argmin).
//
// Replaces the TPU kernel `nn_argmin_pallas` (icp_slam_yolo_tpu/ops/pallas/
// nn_kernel.py, `_nn_kernel`).  Same semantics: the distance is taken in
// difference form (sx-tx)^2 + (sy-ty)^2, an invalid target never matches, and
// ties go to the first index.  With no valid target the result is (1e30, 0).
//
// One launch serves B independent problems (the fleet's robot axis):
// blockIdx.y picks the problem, and every pointer is offset by it.
//
// Bound on this card: operations, in principle.  S x T pairs at ~6 FP32
// operations each.  At the step's shapes (S = T = 512, the dynamic-point
// filter, ~1.6 MFLOP per problem) what a launch costs is latency; the GICP
// rescue's 512 x 24576 (~75 MFLOP, ~1 us at the FP32 roof) needs the whole
// card.  Design:
//   - a block of 8 warps owns 16 or 64 source points (LANES = 4 or 16
//     source lanes a warp, R = 4 points a thread held in registers), so one
//     shared-memory load of a target feeds 4 pairs and 4 independent chains
//     of compares interleave;
//   - the other lanes and the warps split the targets between them (32 / LANES
//     parts a warp, 8 warps; part p takes targets p, p + P, ...), so a
//     thread's chain is T / P targets long;
//   - on long target axes the targets are split further over a thread-block
//     cluster of C blocks along the grid's x axis, rank r owning the r-th
//     contiguous slice; the partial minima are merged through distributed
//     shared memory: each block stores its partial for a source into the
//     block that owns that source (rank = source % C), one cluster barrier,
//     and the owner merges the C partials in rank order;
//   - invalid targets are staged at far-away coordinates, so the inner loop
//     has no branch on validity.
// Every merge (lanes by shuffles, warps in shared memory, ranks) takes the
// lower index on equal d^2, and each thread scans its targets in increasing
// index with a strict `<`, so the result is the first index overall whatever
// the layout: every (LANES, C) gives the same bits.  `nn_kernel.nn_plan`
// picks the layout from the shape (the small shapes are not split).
//
// Built with -fmad=false: d^2 rounds exactly as the plain PyTorch version's
// separate multiply and add, so kernel and plain version agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nn_common.cuh"

using namespace slam_nn;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 4;          // source points a thread
constexpr int kChunk = 4096;   // targets staged at a time (32 KB)
constexpr int kMaxCluster = 8;

template <int LANES>
__global__ void __launch_bounds__(kThreads) nn_argmin_kernel(
    const float* __restrict__ src, const float* __restrict__ tgt, const uint8_t* __restrict__ valid,
    int S, int T, int C, int slice, float* __restrict__ out_d2, int* __restrict__ out_idx) {
  constexpr int PW = 32 / LANES;   // target parts a warp
  constexpr int P = PW * kWarps;   // target parts a block
  constexpr int SB = LANES * kR;   // source points a block
  extern __shared__ float2 tile[];
  __shared__ float red_d[kWarps][SB];
  __shared__ int red_i[kWarps][SB];
  __shared__ float2 part[kMaxCluster][SB];  // (d^2, index as bits) stored by each rank of the cluster

  const size_t b = blockIdx.y;  // problem (robot)
  src += b * S * 2;
  tgt += b * T * 2;
  valid += b * T;
  out_d2 += b * S;
  out_idx += b * S;
  const int rank = C > 1 ? cluster_rank() : 0;
  if (C > 1) cluster_arrive_relaxed();  // waited for before the first store into another block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l = lane % LANES, q = lane / LANES, p = warp * PW + q;
  const int s0 = (blockIdx.x / C) * SB;

  float px[kR], py[kR], best[kR];
  int arg[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = s0 + l + LANES * r;
    px[r] = i < S ? src[2 * i] : 0.f;
    py[r] = i < S ? src[2 * i + 1] : 0.f;
    best[r] = kBig;
    arg[r] = kNoIndex;
  }
  const int t0 = rank * slice, t1 = min(T, t0 + slice);
  for (int c0 = t0; c0 < t1; c0 += kChunk) {
    const int n = min(kChunk, t1 - c0);
    for (int j = tid; j < n; j += kThreads) {
      const bool v = valid[c0 + j] != 0;
      const float2 t = reinterpret_cast<const float2*>(tgt)[c0 + j];
      tile[j] = v ? t : make_float2(kFar, kFar);
    }
    __syncthreads();
    nn_scan<kR, 1>(tile, c0, p, n, P, px, py, best, arg);
    __syncthreads();  // the next chunk overwrites the tile
  }
  // the parts of a warp (lane bits above the source lanes), then the warps
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[r], off);
      if (nn_before(ob, oa, best[r], arg[r])) {
        best[r] = ob;
        arg[r] = oa;
      }
    }
  }
  if (q == 0) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      red_d[warp][l + LANES * r] = best[r];
      red_i[warp][l + LANES * r] = arg[r];
    }
  }
  __syncthreads();
  float bd = kBig;
  int bi = kNoIndex;
  if (tid < SB) {
    for (int w = 0; w < kWarps; ++w) {
      if (nn_before(red_d[w][tid], red_i[w][tid], bd, bi)) {
        bd = red_d[w][tid];
        bi = red_i[w][tid];
      }
    }
  }
  if (C > 1) {
    // the owner of source tid is rank tid % C; lower ranks hold lower indices
    cluster_wait();
    if (tid < SB) st_cluster(cluster_addr(smem_addr(&part[rank][tid]), tid % C), bd, bi);
    cluster_sync();
    if (tid < SB && tid % C == rank) {
      bd = kBig;
      bi = kNoIndex;
      for (int r = 0; r < C; ++r) {
        const float d = part[r][tid].x;
        const int i = __float_as_int(part[r][tid].y);
        if (nn_before(d, i, bd, bi)) {
          bd = d;
          bi = i;
        }
      }
    } else {
      return;
    }
  }
  const int i = s0 + tid;
  if (tid < SB && i < S) {
    out_d2[i] = bd;
    out_idx[i] = bd < kBig ? bi : 0;
  }
}

template <int LANES>
cudaError_t launch(const float* src, const float* tgt, const uint8_t* valid, int B, int S, int T, int C,
                   float* out_d2, int* out_idx, cudaStream_t stream) {
  constexpr int SB = LANES * kR;
  const int tiles = (S + SB - 1) / SB;
  const int slice = (T + C - 1) / C;
  const int staged = slice < kChunk ? (slice > 0 ? slice : 1) : kChunk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * C, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = staged * sizeof(float2);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = C;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = C > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, nn_argmin_kernel<LANES>, src, tgt, valid, S, T, C, slice,
                                             out_d2, out_idx);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" const char* slam_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// src (B, S, 2), tgt (B, T, 2), valid (B, T) -> out_d2 (B, S), out_idx (B, S);
// `lanes` (4 or 16) source lanes a warp, `cluster` (1, 2, 4 or 8) blocks
// splitting the targets (`nn_kernel.nn_plan`)
extern "C" int slam_nn_argmin(const void* src, const void* tgt, const void* valid, int B, int S, int T,
                              int lanes, int cluster, void* out_d2, void* out_idx, void* stream) {
  if (S <= 0 || B <= 0) return 0;
  if (B > 65535 || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<const float*>(src);
  const auto t = static_cast<const float*>(tgt);
  const auto v = static_cast<const uint8_t*>(valid);
  const auto d = static_cast<float*>(out_d2);
  const auto i = static_cast<int*>(out_idx);
  const auto st = static_cast<cudaStream_t>(stream);
  if (lanes == 4) return static_cast<int>(launch<4>(s, t, v, B, S, T, cluster, d, i, st));
  if (lanes == 16) return static_cast<int>(launch<16>(s, t, v, B, S, T, cluster, d, i, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
