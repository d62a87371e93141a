// K9: the statistical outlier filter in one launch: each valid point's mean
// distance to its k nearest other valid points, the cloud's mean and standard
// deviation of that statistic, and the keep-mask `mean <= mu + ratio * std`.
//
// Replaces no TPU kernel.  The JAX package leaves the filter to XLA
// (icp_slam_yolo_tpu/ops/nn.py `knn_mean_distance`: a Gram-form distance
// matrix, then `approx_max_k` on the TPU or `lax.top_k`).  The port did the
// same with a (B, N, N) matrix and `torch.topk`, some fifty launches and a
// 268 MB matrix a step at the fleet's (256, 512); this kernel does the same
// work from the 1.2 MB of points.
//
// Same arithmetic as the plain version (`ops/pallas/knn_kernel.py`):
//   - centre on the masked mean (summed in float64, rounded once), move to
//     metres: p = (xy - c) * 1e-3 in float32;
//   - d^2 = (|p_i|^2 + |p_j|^2) - 2 (x_i x_j + y_i y_j), clamped at 0, every
//     product and sum rounded on its own (built with -fmad=false);
//   - the exact k smallest d^2 over the other valid points; the mean of
//     sqrt(d^2) * 1e3 (a correctly rounded sqrtf) over the real ones (fewer
//     than k where fewer exist), summed in float64 and rounded once;
//   - mu and the biased variance of the valid points' means, summed in
//     float64 and rounded once, denominators max(count, 1).
// A float64 sum of these float32 terms is exact (or off by less than 2^-53 of
// it), so its order does not move the rounded result: the kernel gives the
// plain version's bits.
//
// Bound on this card: operations.  A robot of m valid points needs the ~7
// operations of d^2 once a pair, m (m - 1) / 2 of them, and one compare per
// query and candidate, m (m - 1); after the fleet's front-arc gate m <= 270
// of 512 slots, under 19 M ordered pairs at B = 256 (~0.08 GFLOP, ~1 us at 67
// TFLOP/s).  Bytes (1.2 MB in, 0.66 MB out) take under 1 us.  Design:
//   - a block of 256 threads owns a robot: it stages the robot's points, and
//     one warp compacts the valid ones in slot order in shared memory and
//     sums the centre in a fixed order, so only valid points are queries or
//     candidates;
//   - one thread a query: the query keeps the k smallest d^2 in registers as
//     a sorted list of K = 32 (k <= K; the K - k slots below are -1, which no
//     d^2 displaces), a candidate costs one compare against the k-th, and an
//     insertion is K min/max pairs;
//   - candidates go outward from the query's own slot (q + 1, q - 1, q + 2,
//     ...; a scan's slots follow its beams), so the true neighbours come first,
//     the k-th falls fast and insertions after the first k are rare; the
//     query's own slot is never visited;
//   - one warp sums mu and the variance in a fixed order (lane strides, then
//     a butterfly).
// At B = 1 a query's ~270 candidates in series set the time (~28 us); more
// blocks a robot, over a thread-block cluster, took at most 2 us off it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nn_common.cuh"

using namespace slam_nn;

namespace {

constexpr int kMaxK = 32;      // the sorted list's length: k <= kMaxK
constexpr int kMaxN = 2048;    // slots a robot: 21 bytes of shared memory each
constexpr int kThreads = 256;
constexpr float kReal = 1e29f;  // a d^2 below this is a real neighbour (kBig marks an empty slot)

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;  // every lane holds the same bits (each step adds a pair in both orders)
}

// d into the ascending list (its largest entry above d): entry j becomes the
// larger of entry j - 1 and the smaller of entry j and d
template <int K>
__device__ __forceinline__ void insert_sorted(float (&top)[K], float d) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) top[j] = fmaxf(top[j - 1], fminf(top[j], d));
  top[0] = fminf(top[0], d);
}

// mean distance (mm) from compacted point q to its k nearest others of m
template <int K>
__device__ float knn_mean(const float2* __restrict__ pts, const float* __restrict__ sn, int m, int q, int k) {
  float top[K];
#pragma unroll
  for (int j = 0; j < K; ++j) top[j] = j < K - k ? -1.f : kBig;
  const float2 a = pts[q];
  const float sa = sn[q];
  auto consider = [&](int j) {
    const float2 b = pts[j];
    const float cross = a.x * b.x + a.y * b.y;
    const float d = fmaxf((sa + sn[j]) - 2.f * cross, 0.f);
    if (d < top[K - 1]) insert_sorted(top, d);
  };
  const int half = (m - 1) >> 1;
  for (int s = 1; s <= half; ++s) {
    const int up = q + s, down = q - s;
    consider(up >= m ? up - m : up);
    consider(down < 0 ? down + m : down);
  }
  if (m > 1 && (m & 1) == 0) {  // the slot opposite q, once
    const int j = q + (m >> 1);
    consider(j >= m ? j - m : j);
  }
  double sum = 0.0;
  int real = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {  // ascending
    if (top[j] >= 0.f && top[j] < kReal) {
      sum += static_cast<double>(sqrtf(top[j]) * 1000.f);
      ++real;
    }
  }
  return static_cast<float>(sum / static_cast<double>(max(real, 1)));
}

template <int K>
__global__ void __launch_bounds__(kThreads) knn_outlier_kernel(
    const float* __restrict__ xy, const uint8_t* __restrict__ valid, int N, int k, float ratio,
    float* __restrict__ out_mean, uint8_t* __restrict__ out_keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* pts = reinterpret_cast<float2*>(smem);  // raw, then compacted and in metres
  float* sn = reinterpret_cast<float*>(pts + N);  // |p|^2 of each compacted point
  float* mean = sn + N;                           // each compacted point's mean
  int* slot = reinterpret_cast<int*>(mean + N);   // the slot of each compacted point
  uint8_t* vs = reinterpret_cast<uint8_t*>(slot + N);
  __shared__ float s_cx, s_cy, s_thr;
  __shared__ int s_m;

  const size_t b = blockIdx.x;  // robot
  xy += b * N * 2;
  valid += b * N;
  out_mean += b * N;
  out_keep += b * N;
  const int tid = threadIdx.x, T = blockDim.x;

  for (int s = tid; s < N; s += T) {
    const bool v = valid[s] != 0;
    pts[s] = reinterpret_cast<const float2*>(xy)[s];
    vs[s] = v;
    if (!v) {
      out_mean[s] = kBig;
      out_keep[s] = 0;
    }
  }
  __syncthreads();
  if (tid < 32) {  // compact in place in slot order; the centre's sums in a fixed order
    double sx = 0.0, sy = 0.0;
    int m = 0;
    for (int s0 = 0; s0 < N; s0 += 32) {
      const int s = s0 + tid;
      const bool v = s < N && vs[s] != 0;
      const float2 p = v ? pts[s] : make_float2(0.f, 0.f);
      if (v) {
        sx += static_cast<double>(p.x);
        sy += static_cast<double>(p.y);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, v);
      __syncwarp();  // every lane has read its slot before any writes (positions <= slots)
      if (v) {
        const int pos = m + __popc(ballot & ((1u << tid) - 1u));
        pts[pos] = p;
        slot[pos] = s;
      }
      __syncwarp();
      m += __popc(ballot);
    }
    sx = warp_sum(sx);
    sy = warp_sum(sy);
    if (tid == 0) {
      const double n = static_cast<double>(max(m, 1));
      s_cx = static_cast<float>(sx / n);
      s_cy = static_cast<float>(sy / n);
      s_m = m;
    }
  }
  __syncthreads();
  const float cx = s_cx, cy = s_cy;
  const int m = s_m;
  const float milli = static_cast<float>(1e-3);  // as PyTorch casts the scalar
  for (int q = tid; q < m; q += T) {
    const float2 p = pts[q];
    const float x = (p.x - cx) * milli, y = (p.y - cy) * milli;
    pts[q] = make_float2(x, y);
    sn[q] = x * x + y * y;
  }
  __syncthreads();

  for (int q = tid; q < m; q += T) mean[q] = knn_mean<K>(pts, sn, m, q, k);
  __syncthreads();

  if (tid < 32) {  // mu and the biased variance over the valid points, in a fixed order
    double s1 = 0.0;
    for (int q = tid; q < m; q += 32) s1 += static_cast<double>(mean[q]);
    const double n = static_cast<double>(max(m, 1));
    const float mu = static_cast<float>(warp_sum(s1) / n);
    double s2 = 0.0;
    for (int q = tid; q < m; q += 32) {
      const float d = mean[q] - mu;
      s2 += static_cast<double>(d * d);
    }
    const float var = static_cast<float>(warp_sum(s2) / n);
    if (tid == 0) s_thr = mu + ratio * sqrtf(var);
  }
  __syncthreads();
  const float thr = s_thr;
  for (int q = tid; q < m; q += T) {
    const int s = slot[q];
    out_mean[s] = mean[q];
    out_keep[s] = mean[q] <= thr;
  }
}

size_t smem_bytes(int N) { return static_cast<size_t>(N) * (8 + 4 + 4 + 4 + 1); }

}  // namespace

// xy (B, N, 2) f32, valid (B, N) bool -> out_mean (B, N) f32 (1e30 where
// invalid), out_keep (B, N) bool; k <= 32 neighbours, mu + ratio * std the
// threshold; a block of 256 threads a robot
extern "C" int slam_knn_outlier(const void* xy, const void* valid, int B, int N, int k, float ratio, void* out_mean,
                                void* out_keep, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (N > kMaxN || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  knn_outlier_kernel<kMaxK><<<B, kThreads, smem_bytes(N), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xy), static_cast<const uint8_t*>(valid), N, k, ratio, static_cast<float*>(out_mean),
      static_cast<uint8_t*>(out_keep));
  return static_cast<int>(cudaGetLastError());
}
