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
// is the HWIO weight read as a row-major K x Cout matrix.  A block of 4 warps
// computes a BM x BN tile (BM 32, 64 or 128 pixels, BN 16, 32 or 64
// channels; the wrapper picks both from the shape) in chunks of 64 K values
// (32 with the scalar gather):
//
//   * a ring of 4 shared-memory stages, so chunks k+1..k+3 are in flight
//     while chunk k is multiplied, with one barrier per chunk;
//   * two gathers, picked by the wrapper from the channel counts: where Cin
//     and Cout are multiples of 8 (every yolo-n site but the stem's Cin 3
//     and the class head's Cout 1), 16-byte `cp.async` copies, one per 8
//     channels of one pixel tap and per 8 columns of a weight row, the halo
//     and the rows past the end zero-filled by the copy itself; otherwise
//     scalar loads into registers, issued before chunk k is multiplied and
//     stored into the ring after it;
//   * W is copied K x N as it lies in memory and read with `ldmatrix.trans`,
//     A with `ldmatrix`, rows padded to an odd number of 16-byte units; the
//     products are `mma.sync.m16n8k16` with a float32 sum;
//   * where the output tiles do not fill the card's 132 SMs, the K axis is
//     split over the 2-8 blocks of a thread-block cluster: each sums its
//     share of the chunks and stores its float32 sums of each slice of the
//     tile's rows into the block that owns the slice (`st.shared::cluster`,
//     which waits for no answer); after one cluster barrier each block adds
//     its slice's 8 groups in order and applies bias and SiLU (no atomics:
//     the same bits on every launch); the K axis is summed in 8 fixed groups
//     whatever the split, so every split, tile and gather gives the same
//     bits;
//   * the sites with Cin and Cout multiples of 64 that are not split take
//     the TMA-fed warpgroup loop (`conv_wgmma_kernel<NWG, BN>`, below): a
//     producer thread feeds the ring with TMA boxes, two consumer
//     warpgroups run `wgmma` on 128 x 128 (or 128 x 64) tiles, or one on
//     64 x 64 where 128-row tiles would not fill the card; the 3x3s with
//     Cout a multiple of 64 and other Cin that are neither split nor given
//     32 rows take the 64-row warpgroup kernel (`conv_wgmma_kernel<NWG>`),
//     whose threads gather with 16-byte copies and multiply with
//     `wgmma.m64n64k16`; both give the same bits as `mma.sync`;
//   * the finished tile is staged in shared memory and leaves in 16-byte
//     stores of whole rows (with the scalar gather, where Cout may be odd,
//     each thread stores its own pairs).
//
// float32 keeps the FMA tile of conv_common.cuh (not on the serving path).
//
// Bound on this card: yolo-n's layers are bound by bytes (8-150 operations
// per byte moved, below the ~295 at which the bf16 tensor cores bound
// them); there a launch costs a few microseconds of fixed cost (launch, the
// row tables, the pipeline's prologue and, when split, two cluster
// barriers), then the latency of the chunk loop (PERF.md section 6).
// YOLO12-L's 3x3s at 64-512 channels do 190-750 operations a byte and are
// bound by operations.  There the 64 x 64 tiles, whose threads both gathered
// with 16-byte copies and multiplied, ran at 12-15 % of the tensor cores'
// rate: a block's copies in flight could not cover the latency of the
// shared L2 (its 128 threads ran out of outstanding requests), and each
// 64-column tile gathered the same input rows again.  The warpgroup loop
// moves a chunk in one TMA box per operand, keeps the products of one chunk
// in flight while the next is queued, and halves the gathered bytes per
// product with 128 x 128 tiles.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoders are fetched from libcuda at run time

#include "conv_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace slamconv;

// ---- float32: the FMA tile

template <int KS, int STRIDE>
struct ImageRows {
  const float* x;
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

template <int KS, int STRIDE, int BN>
__global__ void __launch_bounds__(kThreads) conv_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out, int B, int H, int W, int Cin, int Cout, int Ho, int Wo, int act) {
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
  const ImageRows<KS, STRIDE> rows{x, pb, piy, pix, H, W, Cin};
  auto epi = [&](int m, int n, float v) {
    const long long gm = m0 + m;
    if (gm < M && n < Cout) {
      v += bias[n];
      if (act) v = silu(v);
      out[(size_t)gm * Cout + n] = v;
    }
  };
  gemm_tile<BN>(stage, rows, w, KS * KS * Cin, Cout, n0, epi);
}


template <int KS, int STRIDE>
cudaError_t launch_f32(const float* x, const float* w, const float* bias, float* out, int B, int H,
                       int W, int Cin, int Cout, int bn, int act, cudaStream_t s) {
  const int Ho = (H + 2 * (KS / 2) - KS) / STRIDE + 1, Wo = (W + 2 * (KS / 2) - KS) / STRIDE + 1;
  const long long M = (long long)B * Ho * Wo;
  const dim3 grid((unsigned)((M + 4096 / bn - 1) / (4096 / bn)), (unsigned)((Cout + bn - 1) / bn));
  if (bn == 16) conv_f32_kernel<KS, STRIDE, 16><<<grid, kThreads, 0, s>>>(x, w, bias, out, B, H, W, Cin, Cout, Ho, Wo, act);
  else if (bn == 32) conv_f32_kernel<KS, STRIDE, 32><<<grid, kThreads, 0, s>>>(x, w, bias, out, B, H, W, Cin, Cout, Ho, Wo, act);
  else if (bn == 64) conv_f32_kernel<KS, STRIDE, 64><<<grid, kThreads, 0, s>>>(x, w, bias, out, B, H, W, Cin, Cout, Ho, Wo, act);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// ---- bfloat16: the pipelined tensor-core tile

constexpr int kConvThreads = 128;  // 4 warps
constexpr int kStages = 4;         // chunks in the ring

// BK: K values per chunk, 64 for the 16-byte gather (half the chunks, and
// barriers, of 32), 32 for the scalar one (its values pass through registers)
template <int BM, int BN, int BK>
struct Tile {
  static constexpr int WN = BN >= 32 ? 2 : 1, WM = 4 / WN;  // warps across columns and rows
  static constexpr int MT = BM / WM / 16;                   // 16-row tiles of a warp
  static constexpr int NP = BN / WN / 16;                   // pairs of 8-column tiles of a warp
  static constexpr int AROW = BK + 8;                       // staged A row: an odd number of 16-byte units
  static constexpr int BROW = BN + 8;                       // staged W row: the same
  static constexpr int A_ELEMS = BM * AROW, B_ELEMS = BK * BROW;
  static constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * 2;
  static constexpr int RING_BYTES = kStages * STAGE_BYTES;
  static constexpr int SMEM = RING_BYTES + 3 * BM * 4;  // the ring, then three int row tables
  static constexpr int PART_BYTES = BM * BN * 4;          // one float32 partial tile
  static_assert(MT >= 1 && NP >= 1, "tile too small for 4 warps");
};

// The K axis is summed in kGroups fixed groups of whole 64-value blocks,
// each from zero, and the group sums are added in order: the same bits
// whatever the split (a split of s gives each block kGroups / s whole
// groups), the gather and the chunk, so a batch of one and a batch of eight,
// which the wrapper splits differently, agree.
constexpr int kGroups = 8, kGroupUnit = 64;

// first K value of group q (of a K axis of nkb 64-value blocks), in chunks of BK
template <int BK>
__host__ __device__ inline int group_begin(int q, int nkb) {
  return (int)((long long)q * nkb / kGroups) * (kGroupUnit / BK);
}

// an output of column n before its rounding: bias, then SiLU (act != 0)
__device__ __forceinline__ float finish(float v, const __nv_bfloat16* __restrict__ bias, int n, int act) {
  v += __bfloat162float(bias[n]);
  return act ? silu_fast(v) : v;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ bias,
                                           long long gm, int n, int Cout, int act, float v0, float v1) {
  v0 = finish(v0, bias, n, act);
  __nv_bfloat16* o = out + (size_t)gm * Cout + n;
  if (n + 1 >= Cout) {
    o[0] = __float2bfloat16_rn(v0);
    return;
  }
  v1 = finish(v1, bias, n + 1, act);
  if ((Cout & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
  } else {
    o[0] = __float2bfloat16_rn(v0);
    o[1] = __float2bfloat16_rn(v1);
  }
}

// A finished BM x BN tile staged in shared memory (rows `orow` values
// apart) out to rows m0.. and columns n0.. of `out`, Cout a multiple of 8:
// whole rows in 16-byte stores
template <int BM, int BN>
__device__ __forceinline__ void store_rows(const __nv_bfloat16* tile, int orow, __nv_bfloat16* __restrict__ out,
                                           long long M, int Cout, long long m0, int n0, int tid, int threads) {
  constexpr int SEGS = BN / 8;
  for (int e = tid; e < BM * SEGS; e += threads) {
    const int r = e / SEGS, sg = e % SEGS, n = n0 + sg * 8;
    if (m0 + r < M && n < Cout)
      *reinterpret_cast<int4*>(out + (size_t)(m0 + r) * Cout + n) = *reinterpret_cast<const int4*>(tile + r * orow + sg * 8);
  }
}

// VEC: the 16-byte cp.async gather (Cin, Cout multiples of 8); else scalar.
// A cluster of `split` blocks (consecutive in x) shares one output tile.
template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(kConvThreads) conv_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int B, int H, int W,
    int Cin, int Cout, int Ho, int Wo, int ks, int stride, int act, int split) {
  constexpr int BK = VEC ? 64 : 32;
  using TT = Tile<BM, BN, BK>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  int* prow = reinterpret_cast<int*>(smem + TT::RING_BYTES);  // image index * H
  int* piy = prow + BM;                                       // input row of tap (0, 0)
  int* pix = piy + BM;                                        // input column of tap (0, 0)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long M = (long long)B * Ho * Wo;
  const int rank = (int)(blockIdx.x % split);
  const long long m0 = (long long)(blockIdx.x / split) * BM;
  const int n0 = blockIdx.y * BN;
  const int K = ks * ks * Cin, pad = ks / 2;
  const int nkb = (K + kGroupUnit - 1) / kGroupUnit, nch = (K + BK - 1) / BK;
  // first chunk of group q; a chunk wholly past K adds nothing and is skipped
  auto gb = [&](int q) { return min(group_begin<BK>(q, nkb), nch); };
  const int per = kGroups / split;  // groups of this block
  const int c_begin = gb(rank * per);
  const int n_local = gb((rank + 1) * per) - c_begin;
  // split: the group sums of this block's rows (BM / split of them), from every block of the cluster
  float* parts = reinterpret_cast<float*>(smem + TT::SMEM);
  const int rows = BM / split;
  if (split > 1) cluster_arrive_relaxed();  // waited for before the first store into another block

  for (int m = tid; m < BM; m += kConvThreads) {
    if (m0 + m < M) {
      const int gm = (int)(m0 + m), t = gm / Wo;  // 32-bit: M < 2^31 (the host checks)
      prow[m] = t / Ho * H;
      piy[m] = t % Ho * stride - pad;
      pix[m] = (gm - t * Wo) * stride - pad;
    } else {
      prow[m] = 0;
      piy[m] = -(1 << 28);  // every tap outside the image: zeros
      pix[m] = 0;
    }
  }
  __syncthreads();

  auto stage_a = [&](int s) { return ring + s * (TT::A_ELEMS + TT::B_ELEMS); };
  // 16-byte copies of chunk c into stage s
  auto issue = [&](int c, int s) {
    __nv_bfloat16* As = stage_a(s);
    __nv_bfloat16* Bs = As + TT::A_ELEMS;
    constexpr int SEGS = BK / 8;  // 16-byte segments of an A row
    const int k0 = c * BK;
    const int seg = tid % SEGS, k = k0 + seg * 8;
    const int tap = k / Cin, ci = k - tap * Cin;
    const int dy = tap / ks, dx = tap - dy * ks;
    const bool kok = k < K;
#pragma unroll
    for (int m = tid / SEGS; m < BM; m += kConvThreads / SEGS) {
      const int iy = piy[m] + dy, ix = pix[m] + dx;
      const bool ok = kok && (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W;
      const __nv_bfloat16* src = ok ? x + (((size_t)(prow[m] + iy) * W + ix) * Cin + ci) : x;
      cp_async16(smem_addr(As + m * TT::AROW + seg * 8), src, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = tid; i < BK * BN / 8; i += kConvThreads) {
      const int kr = i / (BN / 8), sg = i % (BN / 8);
      const int kw = k0 + kr, n = n0 + sg * 8;
      const bool ok = kw < K && n < Cout;
      cp_async16(smem_addr(Bs + kr * TT::BROW + sg * 8), ok ? w + (size_t)kw * Cout + n : w, ok ? 16 : 0);
    }
  };
  // scalar loads of chunk c into registers, and their store into stage s
  constexpr int A_PER = VEC ? 1 : BM * BK / kConvThreads;
  constexpr int B_PER = VEC ? 1 : (BK * BN + kConvThreads - 1) / kConvThreads;
  __nv_bfloat16 ra[A_PER], rb[B_PER];
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  auto fetch = [&](int c) {
    const int k0 = c * BK, kk = tid % BK, k = k0 + kk;
    const int tap = k / Cin, ci = k - tap * Cin;
    const int dy = tap / ks, dx = tap - dy * ks;
    const bool kok = k < K;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int m = tid / BK + i * (kConvThreads / BK);
      const int iy = piy[m] + dy, ix = pix[m] + dx;
      const bool ok = kok && (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W;
      const __nv_bfloat16 v = x[ok ? (((size_t)(prow[m] + iy) * W + ix) * Cin + ci) : 0];
      ra[i] = ok ? v : zero;  // loaded at a clamped address and masked: no branch around the load
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * kConvThreads;
      const int kw = k0 + idx / BN, n = n0 + idx % BN;
      const bool ok = idx < BK * BN && kw < K && n < Cout;
      const __nv_bfloat16 v = w[ok ? (size_t)kw * Cout + n : 0];
      rb[i] = ok ? v : zero;
    }
  };
  auto put = [&](int s) {
    __nv_bfloat16* As = stage_a(s);
    __nv_bfloat16* Bs = As + TT::A_ELEMS;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) As[(tid / BK + i * (kConvThreads / BK)) * TT::AROW + tid % BK] = ra[i];
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * kConvThreads;
      if (idx < BK * BN) Bs[(idx / BN) * TT::BROW + idx % BN] = rb[i];
    }
  };

  float acc[TT::MT][2 * TT::NP][4], sum[TT::MT][2 * TT::NP][4];
#pragma unroll
  for (int i = 0; i < TT::MT; ++i)
#pragma unroll
    for (int j = 0; j < 2 * TT::NP; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = sum[i][j][q] = 0.f;
  const int wm = warp / TT::WN, wn = warp % TT::WN;
  const int g = lane / 4, t = lane % 4;
  // close every group of this block that ends by chunk `c_end`: unsplit, add
  // its sum to `sum`; split, store it into the block that owns its rows
  int group = rank * per;
  auto close_groups = [&](int c_end) {
    for (; group < (rank + 1) * per && gb(group + 1) <= c_end; ++group) {
#pragma unroll
      for (int i = 0; i < TT::MT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * TT::NP; ++j) {
          if (split == 1) {
#pragma unroll
            for (int q = 0; q < 4; ++q) sum[i][j][q] += acc[i][j][q];
          } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = wm * (BM / TT::WM) + i * 16 + g + 8 * h, cl = wn * (BN / TT::WN) + j * 8 + 2 * t;
              const int owner = r / rows;
              float* dst = parts + ((size_t)group * rows + r - owner * rows) * BN + cl;
              if (owner == rank)
                *reinterpret_cast<float2*>(dst) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
              else
                st_cluster(cluster_addr(smem_addr(dst), owner), acc[i][j][2 * h], acc[i][j][2 * h + 1]);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
        }
    }
  };
  if (split > 1) cluster_wait();
  close_groups(c_begin);  // groups without a chunk sum to zero
  const int lrow = lane % 8 + ((lane / 8) % 2) * 8, lcol = (lane / 16) * 8;
  uint32_t a_off[TT::MT], b_off[TT::NP];
#pragma unroll
  for (int i = 0; i < TT::MT; ++i) a_off[i] = ((wm * (BM / TT::WM) + i * 16 + lrow) * TT::AROW + lcol) * 2;
#pragma unroll
  for (int j = 0; j < TT::NP; ++j) b_off[j] = TT::A_ELEMS * 2 + (lrow * TT::BROW + wn * (BN / TT::WN) + j * 16 + lcol) * 2;
  const uint32_t ring_addr = smem_addr(ring);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_local) {
      if constexpr (VEC) {
        issue(c_begin + s, s);
      } else {
        fetch(c_begin + s);
        put(s);
      }
    }
    cp_async_commit();
  }
  for (int i = 0; i < n_local; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk i has landed for every thread; stage (i - 1) % kStages is free
    const int nxt = i + kStages - 1;
    if constexpr (VEC) {
      if (nxt < n_local) issue(c_begin + nxt, nxt % kStages);
      cp_async_commit();
    } else {
      if (nxt < n_local) fetch(c_begin + nxt);
    }
    const uint32_t st = ring_addr + (i % kStages) * TT::STAGE_BYTES;
#pragma unroll
    for (int ks16 = 0; ks16 < BK; ks16 += 16) {
      uint32_t a[TT::MT], b[TT::NP];
#pragma unroll
      for (int q = 0; q < TT::MT; ++q) a[q] = st + a_off[q] + ks16 * 2;
#pragma unroll
      for (int j = 0; j < TT::NP; ++j) b[j] = st + b_off[j] + ks16 * TT::BROW * 2;
      warp_k16<TT::MT, TT::NP>(acc, a, TT::MT, b);
    }
    if constexpr (!VEC) {
      if (nxt < n_local) put(nxt % kStages);
    }
    close_groups(c_begin + i + 1);
  }

  if (split == 1 && VEC) {
    // through shared memory, so that whole rows leave in 16-byte stores
    constexpr int OROW = BN + 8;  // a staged row: an odd number of 16-byte units
    __syncthreads();              // every warp is done with the ring
#pragma unroll
    for (int i = 0; i < TT::MT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * TT::NP; ++j) {
        const int r = wm * (BM / TT::WM) + i * 16 + g, cl = wn * (BN / TT::WN) + j * 8 + 2 * t;
        const int n = min(n0 + cl, Cout - 2);  // columns past Cout are staged, not stored
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(ring + (r + 8 * h) * OROW + cl) = __floats2bfloat162_rn(
              finish(sum[i][j][2 * h], bias, n, act), finish(sum[i][j][2 * h + 1], bias, n + 1, act));
      }
    __syncthreads();
    store_rows<BM, BN>(ring, OROW, out, M, Cout, m0, n0, tid, kConvThreads);
    return;
  }
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < TT::MT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * TT::NP; ++j) {
        const int r = wm * (BM / TT::WM) + i * 16 + g, n = n0 + wn * (BN / TT::WN) + j * 8 + 2 * t;
        if (n < Cout) {
          if (m0 + r < M) store_pair(out, bias, m0 + r, n, Cout, act, sum[i][j][0], sum[i][j][1]);
          if (m0 + r + 8 < M) store_pair(out, bias, m0 + r + 8, n, Cout, act, sum[i][j][2], sum[i][j][3]);
        }
      }
    return;
  }
  // split K: every block's group sums of this block's rows are here once
  // the cluster has met; added in group order (no block reads another after)
  cg::this_cluster().sync();
  for (int e = tid; e < rows * BN / 2; e += kConvThreads) {
    const int lr = e / (BN / 2), cl = (e % (BN / 2)) * 2;
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const float2 p = *reinterpret_cast<const float2*>(parts + ((size_t)q * rows + lr) * BN + cl);
      v0 += p.x;
      v1 += p.y;
    }
    const long long gm = m0 + rank * rows + lr;
    if (gm < M && n0 + cl < Cout) store_pair(out, bias, gm, n0 + cl, Cout, act, v0, v1);
  }
}

// The 64-row warpgroup kernel (16-byte gather, Cout a multiple of 64, no
// split; the sites whose Cin the TMA-fed loop's 64-channel boxes do not
// take): NWG warpgroups of 64 rows each take 64 columns with `wgmma.m64n64k16`,
// both operands read from shared memory in the 128-byte swizzled layout that
// the gather writes directly; the K axis in chunks of 64, in the same
// groups as the other variants.
constexpr int kWgStageA = 64 * 128;  // bytes of a 64-row A tile of one chunk
template <int NWG>
struct WgTile {
  static constexpr int BM = 64 * NWG, THREADS = 128 * NWG;
  static constexpr int STAGE_BYTES = NWG * kWgStageA + 64 * 128;  // A rows, then W's 64 x 64
  static constexpr int SMEM = 1024 + kStages * STAGE_BYTES + 3 * BM * 4;  // 1024: room to align the ring
};

template <int NWG>
__global__ void __launch_bounds__(128 * NWG) conv_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int B, int H, int W,
    int Cin, int Cout, int Ho, int Wo, int ks, int stride, int act) {
  using TT = WgTile<NWG>;
  constexpr int BM = TT::BM, BK = 64;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem0 = smem_addr(smem), ring_addr = (smem0 + 1023) & ~1023u;
  unsigned char* ring = smem + (ring_addr - smem0);
  int* prow = reinterpret_cast<int*>(smem + 1024 + kStages * TT::STAGE_BYTES);
  int* piy = prow + BM;
  int* pix = piy + BM;
  const int tid = threadIdx.x, lane = tid % 32, wg = tid / 128, wq = (tid % 128) / 32;
  const long long M = (long long)B * Ho * Wo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * 64;
  const int K = ks * ks * Cin, pad = ks / 2;
  const int nkb = (K + kGroupUnit - 1) / kGroupUnit;  // = chunks
  for (int m = tid; m < BM; m += TT::THREADS) {
    if (m0 + m < M) {
      const int gm = (int)(m0 + m), t = gm / Wo;  // 32-bit: M < 2^31 (the host checks)
      prow[m] = t / Ho * H;
      piy[m] = t % Ho * stride - pad;
      pix[m] = (gm - t * Wo) * stride - pad;
    } else {
      prow[m] = 0;
      piy[m] = -(1 << 28);
      pix[m] = 0;
    }
  }
  __syncthreads();

  auto issue = [&](int c, int s) {
    unsigned char* As = ring + s * TT::STAGE_BYTES;
    unsigned char* Bs = As + NWG * kWgStageA;
    const int j = tid % 8, k = c * BK + j * 8;
    const int tap = k / Cin, ci = k - tap * Cin;
    const int dy = tap / ks, dx = tap - dy * ks;
    const bool kok = k < K;
#pragma unroll
    for (int m = tid / 8; m < BM; m += TT::THREADS / 8) {
      const int iy = piy[m] + dy, ix = pix[m] + dx;
      const bool ok = kok && (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W;
      const __nv_bfloat16* src = ok ? x + (((size_t)(prow[m] + iy) * W + ix) * Cin + ci) : x;
      cp_async16(smem_addr(As + m * 128 + ((j ^ (m % 8)) * 16)), src, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = tid; i < 64 * 8; i += TT::THREADS) {
      const int kr = i / 8, sg = i % 8, kw = c * BK + kr, n = n0 + sg * 8;
      const bool ok = kw < K && n < Cout;
      cp_async16(smem_addr(Bs + kr * 128 + ((sg ^ (kr % 8)) * 16)), ok ? w + (size_t)kw * Cout + n : w, ok ? 16 : 0);
    }
  };

  float acc[32], sum[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = sum[q] = 0.f;
  int group = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkb) issue(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < nkb; ++i) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // chunk i has landed; the products of chunk i - 1 are done, so its stage is free
    if (i + kStages - 1 < nkb) issue(i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    const uint32_t a = ring_addr + (i % kStages) * TT::STAGE_BYTES + wg * kWgStageA;
    const uint32_t b = ring_addr + (i % kStages) * TT::STAGE_BYTES + NWG * kWgStageA;
    const bool fresh = group_begin<BK>(group, nkb) == i;  // the first chunk of a group starts its sum from zero
    wgmma_fence();
#pragma unroll
    for (int ks16 = 0; ks16 < BK / 16; ++ks16)
      wgmma_m64n64k16(acc, wgmma_desc(a + ks16 * 32), wgmma_desc(b + ks16 * 16 * 128), fresh && ks16 == 0 ? 0 : 1);
    wgmma_commit();
    wgmma_wait_all();
    wgmma_fence_operands(acc);
    for (; group < kGroups && group_begin<BK>(group + 1, nkb) <= i + 1; ++group) {
      if (group_begin<BK>(group, nkb) == group_begin<BK>(group + 1, nkb)) continue;  // an empty group adds zero
#pragma unroll
      for (int q = 0; q < 32; ++q) sum[q] += acc[q];
    }
  }
  // the accumulator of m64n64: warp wq holds rows 16 wq + lane / 4 (+ 8),
  // columns 8 j + 2 (lane % 4) (+ 1); staged in the ring, then whole rows
  // leave in 16-byte stores
  constexpr int OROW = 64 + 8;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ring);
  __syncthreads();  // every warpgroup is done with the ring
  const int r = wg * 64 + wq * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cl = 8 * j + 2 * (lane % 4), n = n0 + cl;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8 * h) * OROW + cl) = __floats2bfloat162_rn(
          finish(sum[4 * j + 2 * h], bias, n, act), finish(sum[4 * j + 2 * h + 1], bias, n + 1, act));
  }
  __syncthreads();
  store_rows<BM, 64>(tile, OROW, out, M, Cout, m0, n0, tid, TT::THREADS);
}

template <int NWG>
cudaError_t launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* bias,
                         __nv_bfloat16* out, int B, int H, int W, int Cin, int Cout, int ks, int stride,
                         int act, cudaStream_t s) {
  using TT = WgTile<NWG>;
  void (*kern)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*, __nv_bfloat16*, int, int, int,
               int, int, int, int, int, int, int) = conv_wgmma_kernel<NWG>;
  static const cudaError_t attr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TT::SMEM);
  if (attr != cudaSuccess) return attr;
  const int pad = ks / 2;
  const int Ho = (H + 2 * pad - ks) / stride + 1, Wo = (W + 2 * pad - ks) / stride + 1;
  const long long M = (long long)B * Ho * Wo;
  if (M >= (1LL << 31)) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + TT::BM - 1) / TT::BM), (unsigned)((Cout + 63) / 64));
  kern<<<grid, TT::THREADS, TT::SMEM, s>>>(x, w, bias, out, B, H, W, Cin, Cout, Ho, Wo, ks, stride, act);
  return cudaGetLastError();
}

// The TMA-fed warpgroup loop, for the sites whose products can be fed
// at full width (Cin and Cout multiples of 64, no split): a block of NWG
// consumer warpgroups (64 rows each, `wgmma.m64n{BN}k16` on both operands in
// shared memory) and one producer warpgroup, one thread of which keeps a
// ring of kTmaStages chunks full with the Tensor Memory Accelerator (TMA):
// per chunk one box of A (a 1x1: BM rows x 64 channels of the input as an M x
// Cin matrix; a 3x3: an im2col box, the BM output pixels' input pixels at one
// tap, 64 channels, the halo zero-filled by the copy) and BN / 64 boxes of W,
// all in the 128-byte swizzled layout that the products read.  Stages change
// hands on mbarriers; the consumers keep one chunk's products in flight
// (`wgmma.wait_group 1`) and sum the K axis in the same fixed groups as the
// other variants, the group that ends into one of two accumulators while the
// next runs into the other, so the tensor cores never wait for a group's sum.
// Persistent: a block walks the output tiles gridDim.x apart, so the
// producer fills the ring for the next tile while the consumers finish one.
constexpr int kTmaStages = 5;  // chunks in the ring
template <int NWG, int BN>
struct TmaTile {
  static constexpr int BM = 64 * NWG, THREADS = 128 * (NWG + 1);  // consumer warpgroups, then the producer
  static constexpr int A_BYTES = BM * 128;                        // A's rows of a 64-value chunk
  static constexpr int STAGE_BYTES = A_BYTES + BN * 128;          // then W's 64 x BN, in 64-column atoms of 8 KB
  static constexpr int BARS = 2 * kTmaStages * 8;                 // full and empty barriers of each stage
  static constexpr int OROW = BN + 8;                             // a staged output row: an odd number of 16-byte units
  static constexpr int SMEM = 1024 + kTmaStages * STAGE_BYTES + BARS + BM * OROW * 2;
  static_assert(NWG == 1 || NWG == 2, "one or two consumer warpgroups");
  static_assert(BN == 64 || BN == 128, "64 or 128 columns");
};

// arrives on the barrier and adds `bytes` of copies that its phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// a TMA box of a 2-D map at (x0 inner, x1 outer) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int x0, int x1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(x1), "r"(bar)
      : "memory");
}
// an im2col box of an NHWC map: the pixels from (w, h, n) on in the map's
// traversal, shifted by the tap (dw, dh), channels c..
__device__ __forceinline__ void tma_im2col(uint32_t dst, const CUtensorMap* map, int c, int w, int h, int n,
                                           uint16_t dw, uint16_t dh, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(n), "r"(bar), "h"(dw), "h"(dh)
      : "memory");
}

// one chunk of a consumer warpgroup: its products into `cur` (from zero at
// the first chunk of a group), the previous chunk's finished; at the first
// chunk of a group after the first, the previous group's sum (`prv`) is then
// complete and joins `sum`
template <int BN>
__device__ __forceinline__ void tma_chunk(float (&cur)[BN / 2], float (&prv)[BN / 2], float (&sum)[BN / 2],
                                          uint32_t a, uint32_t b, bool fresh, bool add_prv) {
  wgmma_fence_operands(cur);
  wgmma_fence();
#pragma unroll
  for (int k16 = 0; k16 < 4; ++k16) {
    const int scale = fresh && k16 == 0 ? 0 : 1;
    if constexpr (BN == 128)
      wgmma_m64n128k16(cur, wgmma_desc(a + k16 * 32), wgmma_desc(b + k16 * 16 * 128, 8192), scale);
    else
      wgmma_m64n64k16(cur, wgmma_desc(a + k16 * 32), wgmma_desc(b + k16 * 16 * 128), scale);
  }
  wgmma_commit();
  wgmma_fence_operands(cur);
  wgmma_wait<1>();
  if (add_prv) {
    wgmma_fence_operands(prv);
#pragma unroll
    for (int q = 0; q < BN / 2; ++q) sum[q] += prv[q];
  }
}

// xmap: the input (ks 1: a 2-D M x Cin map, boxes of 64 x BM; ks 3: a 4-D
// im2col map, boxes of BM pixels x 64 channels); wmap: W as a 2-D K x Cout
// map, boxes of 64 x 64
template <int NWG, int BN>
__global__ void __launch_bounds__(128 * (NWG + 1), 1) conv_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M, int Cin, int Cout, int Ho,
    int Wo, int ks, int stride, int act, int tiles) {
  using TT = TmaTile<NWG, BN>;
  constexpr int BM = TT::BM, S = kTmaStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem0 = smem_addr(smem), ring_addr = (smem0 + 1023) & ~1023u;
  unsigned char* ring = smem + (ring_addr - smem0);
  const uint32_t full = ring_addr + S * TT::STAGE_BYTES, empty = full + S * 8;
  __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(ring + S * TT::STAGE_BYTES + TT::BARS);
  const int tid = threadIdx.x, wg = tid / 128;
  const int nkb = ks * ks * Cin / 64;  // 64-value chunks of a tile
  const int tiles_n = Cout / BN;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);         // the producer's arrival, then the stage's bytes
      mbar_init(empty + 8 * s, 4 * NWG);  // every consumer warp, once its products of the chunk are done
    }
    fence_mbar_init();
  }
  __syncthreads();  // the last block-wide barrier: the two roles never meet again

  if (wg == NWG) {  // ---- the producer warpgroup: one thread starts every copy
    if constexpr (NWG == 2) setmaxnreg_dec<40>();
    if (tid == 128 * NWG) {
      int it = 0;  // chunks requested by this block so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;  // 32-bit: M < 2^31 (the host checks)
        // the tile's first output pixel, and the input position of its tap (0, 0)
        const int img = m0 / (Ho * Wo), oy = m0 % (Ho * Wo) / Wo, ox = m0 % Wo;
        for (int c = 0; c < nkb; ++c, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(empty + 8 * s, (it / S - 1) & 1);  // the consumers are done with its last chunk
          const uint32_t st = ring_addr + s * TT::STAGE_BYTES, bar = full + 8 * s;
          mbar_expect_tx(bar, TT::STAGE_BYTES);
          if (ks == 1) {
            tma_2d(st, &xmap, c * 64, m0, bar);
          } else {
            const int tap = c * 64 / Cin, ci = c * 64 - tap * Cin;
            tma_im2col(st, &xmap, ci, ox * stride - 1, oy * stride - 1, img, (uint16_t)(tap % 3), (uint16_t)(tap / 3),
                       bar);
          }
#pragma unroll
          for (int h = 0; h < BN / 64; ++h) tma_2d(st + TT::A_BYTES + h * 8192, &wmap, n0 + 64 * h, c * 64, bar);
        }
      }
    }
  } else {  // ---- a consumer warpgroup: rows 64 wg .. 64 wg + 63 of each tile
    if constexpr (NWG == 2) setmaxnreg_inc<232>();
    const int lane = tid % 32, wq = (tid % 128) / 32;
    float acc0[BN / 2], acc1[BN / 2], sum[BN / 2];
#pragma unroll
    for (int q = 0; q < BN / 2; ++q) acc0[q] = acc1[q] = 0.f;
    int it = 0;  // chunks consumed by this block so far
    auto release = [&](int chunk) {  // this warp is done with the chunk's stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (chunk % S));
    };
    // the chunks [lo, hi) of one group, `first`: the tile's first group; after
    // a chunk's products are queued, the previous chunk's stage is free
    auto group = [&](float (&cur)[BN / 2], float (&prv)[BN / 2], int lo, int hi, bool first) {
      for (int c = lo; c < hi; ++c, ++it) {
        mbar_wait(full + 8 * (it % S), (it / S) & 1);
        const uint32_t st = ring_addr + it % S * TT::STAGE_BYTES;
        tma_chunk<BN>(cur, prv, sum, st + wg * 64 * 128, st + TT::A_BYTES, c == lo, c == lo && !first);
        if (c > 0) release(it - 1);
      }
    };
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
#pragma unroll
      for (int q = 0; q < BN / 2; ++q) sum[q] = 0.f;
      // the non-empty groups in order, alternately into acc0 and acc1
      int q = 0;
      auto next = [&](int& lo, int& hi) {
        while (q < kGroups && group_begin<64>(q, nkb) == group_begin<64>(q + 1, nkb)) ++q;
        if (q == kGroups) return false;
        lo = group_begin<64>(q, nkb);
        hi = group_begin<64>(++q, nkb);
        return true;
      };
      bool last_odd = false, first = true;
      for (int lo, hi; next(lo, hi);) {
        group(acc0, acc1, lo, hi, first);
        first = last_odd = false;
        if (!next(lo, hi)) break;
        group(acc1, acc0, lo, hi, false);
        last_odd = true;
      }
      wgmma_wait<0>();
      if (last_odd) {
        wgmma_fence_operands(acc1);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] += acc1[i];
      } else {
        wgmma_fence_operands(acc0);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] += acc0[i];
      }
      release(it - 1);
      // the accumulator of m64nBN: warp wq holds rows 16 wq + lane / 4 (+ 8), columns 8 j + 2 (lane % 4)
      // (+ 1); staged, then whole rows leave in 16-byte stores
      __nv_bfloat16* tile_out = staged + wg * 64 * TT::OROW;
      named_barrier(1 + wg, 128);  // this warpgroup's rows of the last tile have left
      const int r = wq * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = 8 * j + 2 * (lane % 4), n = n0 + cl;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(tile_out + (r + 8 * h) * TT::OROW + cl) = __floats2bfloat162_rn(
              finish(sum[4 * j + 2 * h], bias, n, act), finish(sum[4 * j + 2 * h + 1], bias, n + 1, act));
      }
      named_barrier(1 + wg, 128);
      store_rows<64, BN>(tile_out, TT::OROW, out, M, Cout, m0 + 64 * wg, n0, tid % 128, 128);
    }
  }
}

// libcuda's tensor-map encoders, fetched once through the runtime (no link
// against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*, cuuint32_t, cuuint32_t,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
template <typename F>
F libcuda_entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t e = cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found);
#endif
  return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<F>(fn) : nullptr;
}

template <int NWG, int BN>
cudaError_t launch_tma(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* bias,
                       __nv_bfloat16* out, int B, int H, int W, int Cin, int Cout, int ks, int stride, int act,
                       cudaStream_t s) {
  using TT = TmaTile<NWG, BN>;
  void (*kern)(const CUtensorMap, const CUtensorMap, const __nv_bfloat16*, __nv_bfloat16*, int, int, int, int, int,
               int, int, int, int) = conv_wgmma_kernel<NWG, BN>;
  static const EncodeTiled encode_tiled = libcuda_entry<EncodeTiled>("cuTensorMapEncodeTiled");
  static const EncodeIm2col encode_im2col = libcuda_entry<EncodeIm2col>("cuTensorMapEncodeIm2col");
  // the most blocks the card holds at once (one wave of the persistent grid)
  static int wave = 0;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TT::SMEM);
    int dev = 0, n_sm = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, TT::THREADS, TT::SMEM);
    wave = n_sm * per_sm;
    return e != cudaSuccess ? e : wave > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
  }();
  if (attr != cudaSuccess) return attr;
  if (!encode_tiled || !encode_im2col) return cudaErrorNotSupported;
  const int pad = ks / 2;
  const int Ho = (H + 2 * pad - ks) / stride + 1, Wo = (W + 2 * pad - ks) / stride + 1;
  const long long M = (long long)B * Ho * Wo;
  const long long tiles = (M + TT::BM - 1) / TT::BM * (Cout / BN);
  if ((long long)B * H * W >= (1LL << 31) || tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap xmap, wmap;
  const cuuint64_t wdim[2] = {(cuuint64_t)Cout, (cuuint64_t)ks * ks * Cin}, wstride[1] = {(cuuint64_t)Cout * 2};
  const cuuint32_t wbox[2] = {64, 64};
  CUresult r = encode_tiled(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(w), wdim, wstride,
                            wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (ks == 1) {
    const cuuint64_t dim[2] = {(cuuint64_t)Cin, (cuuint64_t)M}, stride_b[1] = {(cuuint64_t)Cin * 2};
    const cuuint32_t box[2] = {64, TT::BM};
    if (r == CUDA_SUCCESS)
      r = encode_tiled(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(x), dim, stride_b, box,
                       ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    // output pixel (oy, ox) reads input rows oy * stride - 1 + dh and columns ox * stride - 1 + dw, dh and dw
    // in 0..2: the traversal runs from -1 to the far edge less 1 in steps of the stride
    const cuuint64_t dim[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t stride_b[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2, (cuuint64_t)H * W * Cin * 2};
    const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
    const cuuint32_t steps[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
    if (r == CUDA_SUCCESS)
      r = encode_im2col(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<__nv_bfloat16*>(x), dim, stride_b,
                        lower, upper, 64, TT::BM, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < wave ? tiles : wave);
  kern<<<grid, TT::THREADS, TT::SMEM, s>>>(xmap, wmap, bias, out, (int)M, Cin, Cout, Ho, Wo, ks, stride, act,
                                           (int)tiles);
  return cudaGetLastError();
}

template <int BM, int BN, bool VEC>
cudaError_t launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* bias,
                        __nv_bfloat16* out, int B, int H, int W, int Cin, int Cout, int ks, int stride,
                        int act, int split, cudaStream_t s) {
  using TT = Tile<BM, BN, VEC ? 64 : 32>;
  auto kern = conv_bf16_kernel<BM, BN, VEC>;
  const int bytes = TT::SMEM + (split > 1 ? kGroups / split * TT::PART_BYTES : 0);
  static const cudaError_t attr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return attr;
  if (bytes > 232448) return cudaErrorInvalidValue;
  const int pad = ks / 2;
  const int Ho = (H + 2 * pad - ks) / stride + 1, Wo = (W + 2 * pad - ks) / stride + 1;
  const long long M = (long long)B * Ho * Wo;
  const long long blocks_x = (M + BM - 1) / BM * split;
  if (M >= (1LL << 31) || blocks_x >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks_x, (unsigned)((Cout + BN - 1) / BN));
  cfg.blockDim = dim3(kConvThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, x, w, bias, out, B, H, W, Cin, Cout, Ho, Wo, ks,
                                             stride, act, split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_bf16_tile(int bm, int bn, const __nv_bfloat16* x, const __nv_bfloat16* w,
                             const __nv_bfloat16* bias, __nv_bfloat16* out, int B, int H, int W, int Cin,
                             int Cout, int ks, int stride, int act, int split, cudaStream_t s) {
#define SLAM_CONV_TILE(BM_, BN_)                                                                   \
  if (bm == BM_ && bn == BN_)                                                                      \
    return launch_bf16<BM_, BN_, VEC>(x, w, bias, out, B, H, W, Cin, Cout, ks, stride, act, split, s);
  SLAM_CONV_TILE(64, 16) SLAM_CONV_TILE(128, 16)
  SLAM_CONV_TILE(32, 32) SLAM_CONV_TILE(64, 32) SLAM_CONV_TILE(128, 32)
  SLAM_CONV_TILE(32, 64) SLAM_CONV_TILE(64, 64) SLAM_CONV_TILE(128, 64)
#undef SLAM_CONV_TILE
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, H, W, Cin), w (ks, ks, Cin, Cout), bias (Cout), all of one type
// (bf16 != 0: bfloat16, else float32) -> out (B, Ho, Wo, Cout) of that type.
// (ks, stride) is (1, 1), (3, 1) or (3, 2); act != 0 applies SiLU.  The tile
// is the wrapper's choice: bfloat16 takes BM x BN (bm in 32, 64, 128; bn in
// 16, 32, 64), the 16-byte gather (vec != 0; Cin and Cout multiples of 8)
// or the scalar one, and `split` (1, 2, 4, 8) blocks per output tile; or
// with wg 1 the 64-row warpgroup kernel (vec, bn 64, bm 64 or 128, split 1),
// with wg 2 the TMA-fed warpgroup loop (vec, Cin and Cout multiples of 64, bm
// 64 with bn 64, or bm 128 with bn 64 or 128, split 1); float32 takes BN = bn
// with BM = 4096 / bn, vec 0, split 1 and wg 0.
extern "C" int slam_conv_bias_act(const void* x, const void* w, const void* bias, void* out, int B,
                                  int H, int W, int Cin, int Cout, int ks, int stride, int act,
                                  int bf16, int vec, int bm, int bn, int split, int wg, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  const bool shape_ok = (ks == 1 && stride == 1) || (ks == 3 && (stride == 1 || stride == 2));
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    if (vec || wg || split != 1 || bn * bm != 4096) return (int)cudaErrorInvalidValue;
    const float *xf = static_cast<const float*>(x), *wf = static_cast<const float*>(w), *bf = static_cast<const float*>(bias);
    float* of = static_cast<float*>(out);
    if (ks == 1) return (int)launch_f32<1, 1>(xf, wf, bf, of, B, H, W, Cin, Cout, bn, act, s);
    if (stride == 1) return (int)launch_f32<3, 1>(xf, wf, bf, of, B, H, W, Cin, Cout, bn, act, s);
    return (int)launch_f32<3, 2>(xf, wf, bf, of, B, H, W, Cin, Cout, bn, act, s);
  }
  if (!(split == 1 || split == 2 || split == 4 || split == 8) || bm % split) return (int)cudaErrorInvalidValue;
  if (vec && (Cin % 8 || Cout % 8 || ((uintptr_t)x | (uintptr_t)w) % 16)) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16 *xb = static_cast<const __nv_bfloat16*>(x), *wb = static_cast<const __nv_bfloat16*>(w);
  const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(bias);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  if (wg == 1) {  // the 64-row warpgroup kernel
    if (!vec || bn != 64 || Cout % 64 || split != 1 || !(bm == 64 || bm == 128)) return (int)cudaErrorInvalidValue;
    return (int)(bm == 64 ? launch_wgmma<1>(xb, wb, bb, ob, B, H, W, Cin, Cout, ks, stride, act, s)
                          : launch_wgmma<2>(xb, wb, bb, ob, B, H, W, Cin, Cout, ks, stride, act, s));
  }
  if (wg == 2) {  // the TMA-fed warpgroup loop
    if (!vec || split != 1 || !(bn == 64 || bn == 128) || Cout % bn || Cin % 64) return (int)cudaErrorInvalidValue;
    if (bm == 64 && bn == 64) return (int)launch_tma<1, 64>(xb, wb, bb, ob, B, H, W, Cin, Cout, ks, stride, act, s);
    if (bm == 128 && bn == 64) return (int)launch_tma<2, 64>(xb, wb, bb, ob, B, H, W, Cin, Cout, ks, stride, act, s);
    if (bm == 128 && bn == 128) return (int)launch_tma<2, 128>(xb, wb, bb, ob, B, H, W, Cin, Cout, ks, stride, act, s);
    return (int)cudaErrorInvalidValue;
  }
  if (wg) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      vec ? launch_bf16_tile<true>(bm, bn, xb, wb, bb, ob, B, H, W, Cin, Cout, ks, stride, act, split, s)
          : launch_bf16_tile<false>(bm, bn, xb, wb, bb, ob, B, H, W, Cin, Cout, ks, stride, act, split, s);
  return (int)err;
}
