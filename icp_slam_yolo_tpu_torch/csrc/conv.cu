// K5, K6, K7: convolution + bias (+ SiLU) in one kernel, NHWC activations,
// HWIO weights, bfloat16 or float32 in and out with a float32 sum.
//
// Replaces the TPU kernels `conv1x1_silu` (K5), `conv3x3_silu` (K6, stride 1,
// SAME zero padding) and `conv3x3s2_silu` (K7, stride 2, padding 1, even H
// and W) of icp_slam_yolo_tpu/ops/pallas/conv_fused.py.  Same function:
//   out[b, oy, ox, :] = act(sum_{dy,dx,ci} x[b, oy*s+dy-p, ox*s+dx-p, ci]
//                           * w[dy, dx, ci, :] + bias),   p = k / 2,
// with zero outside the image; `act` is SiLU or, for the 1x1 head outputs,
// nothing.  The TPU versions pack pixel groups into lanes with block-diagonal
// and banded weights; none of that is needed here and none is kept: the
// kernel takes the tensors as they are and indexes its own halo.
//
// Design: an implicit matrix product.  Rows are the B*Ho*Wo output pixels,
// columns the Cout channels, and the K axis is (dy, dx, ci) flattened, which
// is the HWIO weight read as a row-major K x Cout matrix.  A block computes a
// BM x BN tile (conv_common.cuh); BN is 16, 32 or 64 by Cout, so narrow
// layers (the stem's 16 channels, the class head's 1) waste fewer columns.
// Any Cin (3, 192, 384) and Cout (1) is taken: K and N are masked, and every
// load is a scalar, so no channel count has to divide a vector width.
//
// Bound on this card: bytes for the 1x1s and for every layer at batch 1
// (yolo-n's layers do 8-150 operations per byte moved, below the ~295 at
// which the bf16 tensor cores would bound them).  In fact this version is
// bound by latency: a chunk of 32 K values is loaded, staged, multiplied
// (bfloat16 on the tensor cores, float32 with FMAs) and fenced by two
// barriers before the next, with 8 warps a block, and at batch 1 and small
// feature maps it has few blocks (20 x 20 pixels x 64 channels is 7 blocks on
// 132 SMs).  The gathers are loaded at clamped addresses and masked, not
// branched around, so that a chunk's loads are in flight together: that
// alone halved the kernels' times.

#include "conv_common.cuh"

namespace {

using namespace slamconv;

template <typename T, int KS, int STRIDE>
struct ImageRows {
  const T* x;
  const int* pb;   // per tile row: image index
  const int* piy;  // input row of tap (0, 0); far negative for a row past the end
  const int* pix;  // input column of tap (0, 0)
  int H, W, Cin;
  struct KC { int dy, dx, ci; };
  __device__ __forceinline__ KC prep(int k) const {
    const int tap = k / Cin;
    return KC{tap / KS, tap % KS, k - tap * Cin};
  }
  __device__ __forceinline__ float load(int m, const KC& kc) const {
    const int iy = piy[m] + kc.dy, ix = pix[m] + kc.dx;
    const bool ok = (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W;
    const float v = to_f32(x[ok ? (((size_t)pb[m] * H + iy) * W + ix) * Cin + kc.ci : 0]);
    return ok ? v : 0.f;  // loaded at a clamped address and masked: no branch around the load
  }
};

template <typename T, int KS, int STRIDE, int BN>
__global__ void __launch_bounds__(kThreads) conv_bias_act_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    T* __restrict__ out, int B, int H, int W, int Cin, int Cout, int Ho, int Wo, int act) {
  constexpr int BM = 4096 / BN;
  __shared__ __align__(16) float stage[stage_floats<BN>()];
  __shared__ int pb[BM], piy[BM], pix[BM];
  const long long M = (long long)B * Ho * Wo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  constexpr int pad = KS / 2;
  for (int m = threadIdx.x; m < BM; m += kThreads) {
    const long long gm = m0 + m;
    if (gm < M) {
      const int ox = (int)(gm % Wo);
      const long long t = gm / Wo;
      pb[m] = (int)(t / Ho);
      piy[m] = (int)(t % Ho) * STRIDE - pad;
      pix[m] = ox * STRIDE - pad;
    } else {
      pb[m] = 0;
      piy[m] = -(1 << 28);
      pix[m] = 0;
    }
  }
  __syncthreads();
  const ImageRows<T, KS, STRIDE> rows{x, pb, piy, pix, H, W, Cin};
  auto epi = [&](int m, int n, float v) {
    const long long gm = m0 + m;
    if (gm < M && n < Cout) {
      v += to_f32(bias[n]);
      if (act) v = silu(v);
      out[(size_t)gm * Cout + n] = from_f32<T>(v);
    }
  };
  gemm_tile<BN, T>(stage, rows, w, KS * KS * Cin, Cout, n0, epi);
}

template <typename T, int KS, int STRIDE, int BN>
cudaError_t launch_one(const void* x, const void* w, const void* bias, void* out, int B, int H,
                       int W, int Cin, int Cout, int Ho, int Wo, int act, cudaStream_t s) {
  constexpr int BM = 4096 / BN;
  const long long M = (long long)B * Ho * Wo;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  conv_bias_act_kernel<T, KS, STRIDE, BN><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), B, H, W, Cin, Cout, Ho, Wo, act);
  return cudaGetLastError();
}

template <typename T, int KS, int STRIDE>
cudaError_t launch_by_width(const void* x, const void* w, const void* bias, void* out, int B,
                            int H, int W, int Cin, int Cout, int act, cudaStream_t s) {
  const int Ho = (H + 2 * (KS / 2) - KS) / STRIDE + 1, Wo = (W + 2 * (KS / 2) - KS) / STRIDE + 1;
  if (Cout <= 16) return launch_one<T, KS, STRIDE, 16>(x, w, bias, out, B, H, W, Cin, Cout, Ho, Wo, act, s);
  if (Cout <= 32) return launch_one<T, KS, STRIDE, 32>(x, w, bias, out, B, H, W, Cin, Cout, Ho, Wo, act, s);
  return launch_one<T, KS, STRIDE, 64>(x, w, bias, out, B, H, W, Cin, Cout, Ho, Wo, act, s);
}

template <typename T>
cudaError_t launch_by_shape(const void* x, const void* w, const void* bias, void* out, int B, int H,
                            int W, int Cin, int Cout, int ks, int stride, int act, cudaStream_t s) {
  if (ks == 1 && stride == 1) return launch_by_width<T, 1, 1>(x, w, bias, out, B, H, W, Cin, Cout, act, s);
  if (ks == 3 && stride == 1) return launch_by_width<T, 3, 1>(x, w, bias, out, B, H, W, Cin, Cout, act, s);
  if (ks == 3 && stride == 2) return launch_by_width<T, 3, 2>(x, w, bias, out, B, H, W, Cin, Cout, act, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, H, W, Cin), w (ks, ks, Cin, Cout), bias (Cout), all of one type
// (bf16 != 0: bfloat16, else float32) -> out (B, Ho, Wo, Cout) of that type.
// (ks, stride) is (1, 1), (3, 1) or (3, 2); act != 0 applies SiLU.
extern "C" int slam_conv_bias_act(const void* x, const void* w, const void* bias, void* out, int B,
                                  int H, int W, int Cin, int Cout, int ks, int stride, int act,
                                  int bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_by_shape<__nv_bfloat16>(x, w, bias, out, B, H, W, Cin, Cout, ks, stride, act, s)
           : launch_by_shape<float>(x, w, bias, out, B, H, W, Cin, Cout, ks, stride, act, s);
  return (int)err;
}
