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
// operations each; at the step's shapes (S = T = 512, the dynamic-point
// filter) the whole call is ~1.6 MFLOP and ~10 KB per problem, far below a
// microsecond of either roof, so what a launch costs is latency; the GICP
// rescue's 512 x 24576 is ~75 MFLOP, ~1 us at the FP32 roof, and there 16
// blocks of 32 sources leave most of the card idle.  Design: a block holds
// 32 source points (one per lane) and 8 warps that split the targets
// between them (warp y takes targets y, y+8, ...), so each thread's chain of
// dependent compares is T/8 long; targets are staged through shared memory
// in tiles and read as warp-wide broadcasts.  Each thread keeps the first
// index of its own minimum (strict `<` in index order); the 8 partial
// minima of a source are then merged in shared memory, equal d^2 going to
// the lower index, which is the first index overall.
//
// Built with -fmad=false: d^2 rounds exactly as the plain PyTorch version's
// separate multiply and add, so kernel and plain version agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kLanes = 32;  // source points per block
constexpr int kParts = 8;   // target partitions (warps) per block
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kLanes * kParts) nn_argmin_kernel(
    const float* __restrict__ src, const float* __restrict__ tgt,
    const uint8_t* __restrict__ valid, int S, int T,
    float* __restrict__ out_d2, int* __restrict__ out_idx) {
  const size_t b = blockIdx.y;  // problem (robot)
  src += b * S * 2;
  tgt += b * T * 2;
  valid += b * T;
  out_d2 += b * S;
  out_idx += b * S;
  __shared__ float tx[kTile];
  __shared__ float ty[kTile];
  __shared__ uint8_t tv[kTile];
  __shared__ float red_d[kParts][kLanes];
  __shared__ int red_i[kParts][kLanes];
  const int lane = threadIdx.x, part = threadIdx.y;
  const int flat = part * kLanes + lane;
  const int i = blockIdx.x * kLanes + lane;
  float sx = 0.f, sy = 0.f;
  if (i < S) {
    sx = src[2 * i];
    sy = src[2 * i + 1];
  }
  float best = kBig;
  int arg = 0x7fffffff;
  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    for (int j = flat; j < n; j += kLanes * kParts) {
      tx[j] = tgt[2 * (base + j)];
      ty[j] = tgt[2 * (base + j) + 1];
      tv[j] = valid[base + j];
    }
    __syncthreads();
    for (int j = part; j < n; j += kParts) {
      if (tv[j]) {
        const float dx = sx - tx[j];
        const float dy = sy - ty[j];
        const float d2 = dx * dx + dy * dy;
        if (d2 < best) {
          best = d2;
          arg = base + j;
        }
      }
    }
    __syncthreads();
  }
  red_d[part][lane] = best;
  red_i[part][lane] = arg;
  __syncthreads();
  if (part == 0 && i < S) {
    for (int p = 1; p < kParts; ++p) {
      const float d = red_d[p][lane];
      const int a = red_i[p][lane];
      if (d < best || (d == best && a < arg)) {
        best = d;
        arg = a;
      }
    }
    out_d2[i] = best;
    out_idx[i] = best < kBig ? arg : 0;
  }
}

}  // namespace

extern "C" const char* slam_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// src (B, S, 2), tgt (B, T, 2), valid (B, T) -> out_d2 (B, S), out_idx (B, S)
extern "C" int slam_nn_argmin(const void* src, const void* tgt, const void* valid,
                              int B, int S, int T, void* out_d2, void* out_idx,
                              void* stream) {
  if (S <= 0 || B <= 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (S + kLanes - 1) / kLanes;
  nn_argmin_kernel<<<dim3(blocks, B), dim3(kLanes, kParts), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const uint8_t*>(valid), S, T, static_cast<float*>(out_d2),
      static_cast<int*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}
