// K8: the whole v8 C2f block with one bottleneck (n = 1) in one kernel.
//
// Replaces the TPU kernel `c2f_fused` (icp_slam_yolo_tpu/ops/pallas/
// c2f_fused.py, `_c2f_kernel`).  Same function, on BN-folded weights:
//   y      = silu(x @ w1 + b1)                 1x1, Cin -> 2c
//   a | b  = y split at c, rounded to the working type
//   t1     = silu(conv3x3(b,  wm1) + bm1)      SAME zero padding, rounded
//   t2     = silu(conv3x3(t1, wm2) + bm2)      kept in float32
//   p      = (b + t2 if shortcut else t2)      float32 sum, then rounded
//   out    = silu([a | b | p] @ w2 + b2)       1x1, 3c -> F
// y, t1, t2 and the concatenation never reach device memory.  The zero
// padding of the two 3x3s is of the intermediates: where a halo position of
// y or t1 lies outside the image it holds 0, not silu(bias), in rows and in
// columns alike.  The four biases are float32 (the serving path keeps them
// so); weights and activations are bfloat16 or float32.
//
// Design.  A block owns a TH x TW tile of one image's output.  It computes y
// on the tile grown by 2 pixels each way into shared memory, t1 on the tile
// grown by 1, p on the tile, then the output: four matrix products in a row
// through one staging area (conv_common.cuh), each reading its A operand
// from the image or from the previous stage's shared-memory buffer through a
// per-pixel table.  The weights do not fit shared memory at c = 128 (one 3x3
// is 295 KB in bfloat16); they stream from L2 in 32-row chunks, which every
// block shares.  The TPU kernel's pixel-group packing, banded and permuted
// weights and neighbour-block halos are layout workarounds and are dropped.
//
// Bound on this card: bytes in principle (x read once, out written once,
// ~60-190 operations per byte, below the tensor cores' ~295); in fact this
// version is bound by the latency of its chunk loop (load, stage, multiply,
// two barriers per 32 K values, 8 warps a block), by the halo's
// recomputation ((T+4)^2 / T^2 of the first product), by tile rows that hold
// no pixel (a 4 x 4 tile fills 16 to 64 rows of a 64-row tile) and, at 20 x
// 20 and batch 1, by having 25 blocks for 132 SMs.

#include "conv_common.cuh"

namespace {

using namespace slamconv;

template <typename T>
struct Shared {
  T* y;      // (TH+4) x (TW+4) pixels x 2c
  T* t1;     // (TH+2) x (TW+2) pixels x c
  T* p;      // TH x TW pixels x c
  int* ta;   // per-row table of the running stage (A operand)
  int* te;   // per-row table of the running stage (epilogue)
};

// Stage 1 rows: x at a global pixel (ta: its offset b*H*W + gy*W + gx, or -1)
template <typename T>
struct XRows {
  const T* x; const int* ta; int m0, P, Cin;
  __device__ __forceinline__ int prep(int k) const { return k; }
  __device__ __forceinline__ float load(int m, int k) const {
    const int p = m0 + m;
    const int g = p < P ? ta[p] : -1;
    const float v = to_f32(x[g < 0 ? 0 : (size_t)g * Cin + k]);
    return g < 0 ? 0.f : v;  // loaded at a clamped address and masked: no branch around the load
  }
};

// Stages 2 and 3 rows: a 3x3 window of a shared-memory pixel grid `src` with
// `cs` channels per pixel, of which the window reads `c` starting at `c_off`;
// ta[p] is the window's top-left pixel in that grid, `gw` the grid's width
template <typename T>
struct WindowRows {
  const T* src; const int* ta; int m0, P, c, cs, c_off, gw;
  __device__ __forceinline__ int prep(int k) const {
    const int tap = k / c;
    return ((tap / 3) * gw + tap % 3) * cs + c_off + (k - tap * c);
  }
  __device__ __forceinline__ float load(int m, int off) const {
    const int p = m0 + m;
    const float v = to_f32(src[ta[p < P ? p : 0] * cs + off]);
    return p < P ? v : 0.f;
  }
};

// Stage 4 rows: [a | b] from y at the pixel ta[p], then p
template <typename T>
struct ConcatRows {
  const T* y; const T* pbuf; const int* ta; int m0, P, c;
  __device__ __forceinline__ int prep(int k) const { return k; }
  __device__ __forceinline__ float load(int m, int k) const {
    const int p = m0 + m, q = p < P ? p : 0;
    const T* at = k < 2 * c ? y + ta[q] * 2 * c + k : pbuf + q * c + k - 2 * c;
    const float v = to_f32(*at);
    return p < P ? v : 0.f;
  }
};

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads) c2f_kernel(
    const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
    const T* __restrict__ wm1, const float* __restrict__ bm1, const T* __restrict__ wm2,
    const float* __restrict__ bm2, const T* __restrict__ w2, const float* __restrict__ b2,
    T* __restrict__ out, int H, int W, int Cin, int c, int F, int TH, int TW, int tiles_x,
    int shortcut) {
  constexpr int BM = 4096 / BN;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  const int gw1 = TW + 4, gw2 = TW + 2;
  const int P1 = (TH + 4) * gw1, P2 = (TH + 2) * gw2, P3 = TH * TW;
  Shared<T> sh;
  sh.ta = reinterpret_cast<int*>(stage + stage_floats<BN>());
  sh.te = sh.ta + P1;
  sh.y = reinterpret_cast<T*>(sh.te + P1);
  sh.t1 = sh.y + (size_t)P1 * 2 * c;
  sh.p = sh.t1 + (size_t)P2 * c;

  const int img = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TH, tx0 = (blockIdx.x % tiles_x) * TW;
  const int tid = threadIdx.x;

  // ---- stage 1: y on the tile grown by 2, zero outside the image
  for (int p = tid; p < P1; p += kThreads) {
    const int gy = ty0 - 2 + p / gw1, gx = tx0 - 2 + p % gw1;
    sh.ta[p] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? (img * H + gy) * W + gx : -1;
  }
  __syncthreads();
  for (int m0 = 0; m0 < P1; m0 += BM) {
    const XRows<T> rows{x, sh.ta, m0, P1, Cin};
    auto epi = [&](int m, int n, float v) {
      const int p = m0 + m;
      if (p < P1 && n < 2 * c)
        sh.y[p * 2 * c + n] = from_f32<T>(sh.ta[p] < 0 ? 0.f : silu(v + b1[n]));
    };
    for (int n0 = 0; n0 < 2 * c; n0 += BN) gemm_tile<BN, T>(stage, rows, w1, Cin, 2 * c, n0, epi);
  }
  __syncthreads();

  // ---- stage 2: t1 = silu(conv3x3(b) + bm1) on the tile grown by 1
  for (int p = tid; p < P2; p += kThreads) {
    const int py = p / gw2, px = p % gw2;
    const int gy = ty0 - 1 + py, gx = tx0 - 1 + px;
    sh.ta[p] = py * gw1 + px;
    sh.te[p] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? 1 : 0;
  }
  __syncthreads();
  for (int m0 = 0; m0 < P2; m0 += BM) {
    const WindowRows<T> rows{sh.y, sh.ta, m0, P2, c, 2 * c, c, gw1};
    auto epi = [&](int m, int n, float v) {
      const int p = m0 + m;
      if (p < P2 && n < c) sh.t1[p * c + n] = from_f32<T>(sh.te[p] ? silu(v + bm1[n]) : 0.f);
    };
    for (int n0 = 0; n0 < c; n0 += BN) gemm_tile<BN, T>(stage, rows, wm1, 9 * c, c, n0, epi);
  }
  __syncthreads();

  // ---- stage 3: p = b + silu(conv3x3(t1) + bm2) (or without b) on the tile
  for (int p = tid; p < P3; p += kThreads) {
    const int py = p / TW, px = p % TW;
    sh.ta[p] = py * gw2 + px;
    sh.te[p] = (py + 2) * gw1 + px + 2;  // the tile's pixel in y's grid
  }
  __syncthreads();
  for (int m0 = 0; m0 < P3; m0 += BM) {
    const WindowRows<T> rows{sh.t1, sh.ta, m0, P3, c, c, 0, gw2};
    auto epi = [&](int m, int n, float v) {
      const int p = m0 + m;
      if (p < P3 && n < c) {
        float t2 = silu(v + bm2[n]);
        if (shortcut) t2 += to_f32(sh.y[sh.te[p] * 2 * c + c + n]);
        sh.p[p * c + n] = from_f32<T>(t2);
      }
    };
    for (int n0 = 0; n0 < c; n0 += BN) gemm_tile<BN, T>(stage, rows, wm2, 9 * c, c, n0, epi);
  }
  __syncthreads();

  // ---- stage 4: out = silu([a | b | p] @ w2 + b2), written where the tile is in the image
  for (int p = tid; p < P3; p += kThreads) {
    const int py = p / TW, px = p % TW;
    const int gy = ty0 + py, gx = tx0 + px;
    sh.ta[p] = (py + 2) * gw1 + px + 2;
    sh.te[p] = (gy < H && gx < W) ? (img * H + gy) * W + gx : -1;
  }
  __syncthreads();
  for (int m0 = 0; m0 < P3; m0 += BM) {
    const ConcatRows<T> rows{sh.y, sh.p, sh.ta, m0, P3, c};
    auto epi = [&](int m, int n, float v) {
      const int p = m0 + m;
      if (p < P3 && n < F && sh.te[p] >= 0)
        out[(size_t)sh.te[p] * F + n] = from_f32<T>(silu(v + b2[n]));
    };
    for (int n0 = 0; n0 < F; n0 += BN) gemm_tile<BN, T>(stage, rows, w2, 3 * c, F, n0, epi);
  }
}

template <typename T, int BN>
size_t smem_bytes(int c, int TH, int TW) {
  const size_t P1 = (size_t)(TH + 4) * (TW + 4), P2 = (size_t)(TH + 2) * (TW + 2), P3 = (size_t)TH * TW;
  return stage_floats<BN>() * sizeof(float) + 2 * P1 * sizeof(int) +
         (P1 * 2 * c + P2 * c + P3 * c) * sizeof(T);
}

template <typename T, int BN>
cudaError_t launch_one(const void* x, const void* w1, const void* b1, const void* wm1,
                       const void* bm1, const void* wm2, const void* bm2, const void* w2,
                       const void* b2, void* out, int B, int H, int W, int Cin, int c, int F,
                       int TH, int TW, int shortcut, cudaStream_t s) {
  const size_t bytes = smem_bytes<T, BN>(c, TH, TW);
  auto kern = c2f_kernel<T, BN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)B);
  kern<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(wm1), static_cast<const float*>(bm1), static_cast<const T*>(wm2),
      static_cast<const float*>(bm2), static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<T*>(out), H, W, Cin, c, F, TH, TW, tiles_x, shortcut);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_by_width(const void* x, const void* w1, const void* b1, const void* wm1,
                            const void* bm1, const void* wm2, const void* bm2, const void* w2,
                            const void* b2, void* out, int B, int H, int W, int Cin, int c, int F,
                            int TH, int TW, int shortcut, cudaStream_t s) {
  if (c <= 16)
    return launch_one<T, 16>(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, out, B, H, W, Cin, c, F, TH, TW, shortcut, s);
  if (c <= 32)
    return launch_one<T, 32>(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, out, B, H, W, Cin, c, F, TH, TW, shortcut, s);
  return launch_one<T, 64>(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, out, B, H, W, Cin, c, F, TH, TW, shortcut, s);
}

}  // namespace

// Dynamic shared memory one block needs, so the wrapper can pick a tile that fits.
extern "C" int slam_c2f_smem_bytes(int c, int TH, int TW, int bf16) {
  const size_t n = c <= 16 ? (bf16 ? smem_bytes<__nv_bfloat16, 16>(c, TH, TW) : smem_bytes<float, 16>(c, TH, TW))
                 : c <= 32 ? (bf16 ? smem_bytes<__nv_bfloat16, 32>(c, TH, TW) : smem_bytes<float, 32>(c, TH, TW))
                           : (bf16 ? smem_bytes<__nv_bfloat16, 64>(c, TH, TW) : smem_bytes<float, 64>(c, TH, TW));
  return (int)n;
}

// x (B, H, W, Cin), w1 (Cin, 2c), wm1 and wm2 (3, 3, c, c), w2 (3c, F) of one
// type (bf16 != 0: bfloat16, else float32); b1 (2c), bm1 (c), bm2 (c), b2 (F)
// float32 -> out (B, H, W, F) of the activations' type.  TH x TW is the
// output tile of a block.
extern "C" int slam_c2f_fused(const void* x, const void* w1, const void* b1, const void* wm1,
                              const void* bm1, const void* wm2, const void* bm2, const void* w2,
                              const void* b2, void* out, int B, int H, int W, int Cin, int c, int F,
                              int TH, int TW, int shortcut, int bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || c <= 0 || F <= 0 || TH <= 0 || TW <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_by_width<__nv_bfloat16>(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, out, B, H, W, Cin, c, F, TH, TW, shortcut, s)
           : launch_by_width<float>(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, out, B, H, W, Cin, c, F, TH, TW, shortcut, s);
  return (int)err;
}
