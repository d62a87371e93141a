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
// Design.  A block owns a T x T tile of one image's output (T = 8, 4 or 2,
// the wrapper's choice).  It computes y on the tile grown by 2 pixels each
// way into shared memory, t1 on the tile grown by 1, p on the tile, then the
// output: four matrix products in a row.  The TPU kernel's pixel-group
// packing, banded and permuted weights and neighbour-block halos are layout
// workarounds and are dropped.
//
// bfloat16 (the serving path), 8 warps:
//   * the products' A operands are read with `ldmatrix` straight from the
//     x chunk (stage 1) or the y, t1 and p buffers (stages 2-4): each lane
//     gives the address of its pixel's window position plus the tap's
//     channel offset, so nothing is copied to be multiplied; the buffers'
//     pixel rows are an odd number of 16-byte units long, so the eight rows
//     of an `ldmatrix` phase fall in distinct bank groups (the window's
//     rows wrap now and then and cost a conflict there);
//   * x's chunks (stage 1) and the weights (all stages: they do not fit
//     shared memory at c = 128, one 3x3 is 295 KB) arrive by 16-byte
//     `cp.async` into rings of 3 stages that every block fills from L2, one
//     barrier per chunk of K values (32 in stage 1, whose x is staged; 64 in
//     stages 2-4, whose A is read in place); the weights are read K x N as
//     they lie in memory, through `ldmatrix.trans`;
//   * the rows of a product are its stage's pixels in 16-row tiles (144,
//     100, 64 and 64 rows at T = 8; 64, 36, 16 and 16 at T = 4) spread over
//     the warps, each warp 16 columns wide, so no warp multiplies a tile
//     that holds no pixel; stages 1 and 4, whose outputs are at least twice
//     as wide as t1, walk twice the columns a pass (at most 64), so x is
//     staged, and each A row read, half as often;
//   * where the tiles do not fill the card, a cluster of 2 or 4 blocks
//     shares one tile: each computes a slice of every product's output
//     channels and stores its slice of y, t1 and p into every block's shared
//     memory as it goes (`st.shared::cluster`, which waits for no answer);
//     a cluster barrier after each stage makes them whole, so the halo is
//     computed once per tile, not once per block;
//   * channel counts that are not multiples of 8 take scalar loads instead
//     of the 16-byte copies, and the intermediates are padded with zero
//     channels to a multiple of 8 (the same kernel, another gather).
// float32 keeps the staged FMA tile of conv_common.cuh, one block per tile,
// weights streamed from L2 in 32-row chunks.
//
// Bound on this card: bytes in principle (x read once, out written once,
// ~60-190 operations per byte, below the tensor cores' ~295).  What bounds
// this version, by site, is in PERF.md section 6: the serial chain of four
// products with a barrier per chunk inside one block, the halo's
// recomputation at T = 4, and at 20 x 20 the few tiles a map has.

#include <cooperative_groups.h>

#include "conv_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace slamconv;

// ---- float32: the staged FMA tile, one block per tile

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
__global__ void __launch_bounds__(kThreads) c2f_f32_kernel(
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
    for (int n0 = 0; n0 < 2 * c; n0 += BN) gemm_tile<BN>(stage, rows, w1, Cin, 2 * c, n0, epi);
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
    for (int n0 = 0; n0 < c; n0 += BN) gemm_tile<BN>(stage, rows, wm1, 9 * c, c, n0, epi);
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
    for (int n0 = 0; n0 < c; n0 += BN) gemm_tile<BN>(stage, rows, wm2, 9 * c, c, n0, epi);
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
    for (int n0 = 0; n0 < F; n0 += BN) gemm_tile<BN>(stage, rows, w2, 3 * c, F, n0, epi);
  }
}


size_t f32_smem_bytes(int BN, int c, int T) {
  const size_t P1 = (size_t)(T + 4) * (T + 4), P2 = (size_t)(T + 2) * (T + 2), P3 = (size_t)T * T;
  const size_t stage = (size_t)kBK * BN + (4096 / BN) * kAStride;
  return stage * sizeof(float) + 2 * P1 * sizeof(int) + (P1 * 2 * c + P2 * c + P3 * c) * sizeof(float);
}

int f32_width(int c) { return c <= 16 ? 16 : c <= 32 ? 32 : 64; }

// ---- bfloat16: products on the tensor cores, A read in place

constexpr int kC2fThreads = 256;  // 8 warps
constexpr int kRing = 3;          // stages of the x and W rings
constexpr int kBKVec = 64;        // K values a chunk of stages 2-4 with the 16-byte copies (stage 1: kBK)
constexpr int kMaxMTiles = 9;     // 16-row tiles of the largest product: (8 + 4)^2 = 144 rows

__host__ __device__ inline int round8(int n) { return (n + 7) / 8 * 8; }
// a pixel row of n (a multiple of 8) values, grown to an odd number of 16-byte units
__host__ __device__ inline int odd_row(int n) { return ((n / 8) | 1) * 8; }

// Byte offsets of the shared-memory areas (host and device agree)
struct C2fLayout {
  int cp, P1, P2, P3, MA, ys, ts;  // padded c, pixels of the three grids, stage-1 rows, row strides
  int y, t1, p, xa, w, tab, total;
  int w_stage;  // elements of a W ring stage
};

// the column width of stages 1 and 4, whose outputs are twice t1's channels
// (2c) or more (F): twice the width of stages 2 and 3, at most 64
__host__ __device__ constexpr int c2f_wide(int bn) { return bn >= 32 ? 64 : 32; }

// (vec: the W ring holds chunks of kBKVec rows, else kBK)
__host__ __device__ inline C2fLayout c2f_layout(int c, int T, int bn, bool vec) {
  C2fLayout L;
  L.cp = round8(c);
  L.P1 = (T + 4) * (T + 4);
  L.P2 = (T + 2) * (T + 2);
  L.P3 = T * T;
  L.MA = (L.P1 + 15) / 16 * 16;
  L.ys = odd_row(2 * L.cp);
  L.ts = odd_row(L.cp);
  L.y = 0;
  L.t1 = L.y + L.P1 * L.ys * 2;
  L.p = L.t1 + L.P2 * L.ts * 2;
  L.xa = L.t1;  // x's ring serves stage 1 only, before t1 and p are written: it overlays them
  const int t1p_end = L.p + L.P3 * L.ts * 2, xa_end = L.xa + kRing * L.MA * kARow * 2;
  L.w = t1p_end > xa_end ? t1p_end : xa_end;
  L.w_stage = (vec ? kBKVec : kBK) * (c2f_wide(bn) + 8);
  L.tab = L.w + kRing * L.w_stage * 2;
  L.total = L.tab + L.MA * 4;
  return L;
}

// the column width of a pass: the t1 slice, rounded up to 16, 32 or 64
__host__ __device__ inline int c2f_width(int c, int cluster) {
  const int slice = round8(c) / cluster;
  return slice <= 16 ? 16 : slice <= 32 ? 32 : 64;
}

// A weight matrix in padded coordinates: padded row k is row (k / kgp) * kg
// + k % kgp of `w` (zero where k % kgp >= kg or k >= kp), padded column n is
// column (n / ngp) * ng + n % ngp (zero where n % ngp >= ng); `ld` columns.
struct WMat {
  const __nv_bfloat16* w;
  int ld, kp, kgp, kg, ngp, ng;
};

template <int BN>
struct C2fTile {
  static constexpr int WN = BN / 16, WM = 8 / WN;          // warps across columns (16 each) and rows
  static constexpr int MT = (kMaxMTiles + WM - 1) / WM;    // 16-row tiles of a warp, at most
  static constexpr int BROW = BN + 8;                      // staged W row
};

// One product: rows [0, M) of a stage, padded columns [n_begin, n_end) in
// passes of BN, padded K axis wm.kp in chunks of BK (a W ring stage holds
// kBKVec rows with the 16-byte copies, kBK with scalar loads, of up to
// c2f_wide columns).  `feed` gives
// the lane addresses of A (`base(p, b0, b1)` once per row tile, `at(b0, b1,
// k, xa)` per K step; `xa` is the shared address of x's staged chunk), and,
// for stage 1, stages x's chunks (`issue`, or `fetch` + `put`).  `epi(row,
// col, v0, v1)` takes two neighbouring columns.  Starts and ends with all
// threads past a barrier.
template <int BN, int BK, bool VEC, typename Feed, typename Epi>
__device__ __forceinline__ void product(unsigned char* smem, const C2fLayout& L, int M, int n_begin, int n_end,
                                        const WMat& wm, Feed& feed, const Epi& epi) {
  using TT = C2fTile<BN>;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wmi = warp / TT::WN, wn = warp % TT::WN;
  const int lrow = lane % 8 + ((lane / 8) % 2) * 8, lcol = (lane / 16) * 8;
  const int mtiles = (M + 15) / 16;
  const int mt_count = mtiles > wmi ? min(TT::MT, (mtiles - wmi + TT::WM - 1) / TT::WM) : 0;
  __nv_bfloat16* wring = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  const uint32_t w_addr = smem_addr(wring), xa_addr = smem_addr(smem + L.xa);
  const int w_stage = L.w_stage;
  static_assert(BK == kBK || (VEC && BK == kBKVec), "the scalar loads take chunks of kBK");
  const int xa_stage = L.MA * kARow * 2;                     // bytes
  const int nch = (wm.kp + BK - 1) / BK;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  uint32_t b0[TT::MT], b1[TT::MT];
#pragma unroll
  for (int i = 0; i < TT::MT; ++i) {
    const int r = (wmi + i * TT::WM) * 16 + lrow;
    feed.base(r < M ? r : M - 1, b0[i], b1[i]);
  }

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    constexpr int W_COPIES = BK * BN / 8;  // 16-byte copies of a W chunk
    auto issue_w = [&](int ch, int s) {
#pragma unroll
      for (int j = 0; j < (W_COPIES + kC2fThreads - 1) / kC2fThreads; ++j) {
        const int i = tid + j * kC2fThreads;
        if (i < W_COPIES) {
          const int kr = i / (BN / 8), sg = i % (BN / 8);
          const int k = ch * BK + kr, n = n0 + sg * 8;
          const bool ok = k < wm.kp && n < n_end;
          cp_async16(smem_addr(wring + s * w_stage + kr * TT::BROW + sg * 8),
                     ok ? wm.w + (size_t)k * wm.ld + n : wm.w, ok ? 16 : 0);
        }
      }
    };
    constexpr int W_PER = VEC ? 1 : BK * BN / kC2fThreads;
    __nv_bfloat16 rw[W_PER];
    auto fetch_w = [&](int ch) {
#pragma unroll
      for (int i = 0; i < W_PER; ++i) {
        const int idx = tid + i * kC2fThreads;
        const int k = ch * BK + idx / BN, n = n0 + idx % BN;
        const int kr = k % wm.kgp, nr = n % wm.ngp;
        const bool ok = k < wm.kp && n < n_end && kr < wm.kg && nr < wm.ng;
        const __nv_bfloat16 v =
            wm.w[ok ? (size_t)((k / wm.kgp) * wm.kg + kr) * wm.ld + (n / wm.ngp) * wm.ng + nr : 0];
        rw[i] = ok ? v : zero;  // loaded at a clamped address and masked
      }
    };
    auto put_w = [&](int s) {
#pragma unroll
      for (int i = 0; i < W_PER; ++i) {
        const int idx = tid + i * kC2fThreads;
        wring[s * w_stage + (idx / BN) * TT::BROW + idx % BN] = rw[i];
      }
    };
    auto load = [&](int ch, int s) {  // chunk ch into ring stage s, at once
      if constexpr (VEC) {
        issue_w(ch, s);
        feed.issue(ch, s);
      } else {
        fetch_w(ch);
        put_w(s);
        feed.fetch(ch);
        feed.put(s);
      }
    };

    float acc[TT::MT][2][4];
#pragma unroll
    for (int i = 0; i < TT::MT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
    for (int s = 0; s < kRing - 1; ++s) {
      if (s < nch) load(s, s);
      cp_async_commit();
    }
    for (int ch = 0; ch < nch; ++ch) {
      cp_async_wait<kRing - 2>();
      __syncthreads();  // chunk ch has landed for every thread; stage (ch - 1) % kRing is free
      const int nxt = ch + kRing - 1;
      if constexpr (VEC) {
        if (nxt < nch) load(nxt, nxt % kRing);
        cp_async_commit();
      } else {
        if (nxt < nch) {
          fetch_w(nxt);
          feed.fetch(nxt);
        }
      }
      const int s = ch % kRing;
#pragma unroll
      for (int ks16 = 0; ks16 < BK; ks16 += 16) {
        const int k = ch * BK + ks16 + lcol;
        uint32_t a[TT::MT], b[1];
#pragma unroll
        for (int i = 0; i < TT::MT; ++i) a[i] = feed.at(b0[i], b1[i], k, xa_addr + s * xa_stage);
        b[0] = w_addr + (s * w_stage + (ks16 + lrow) * TT::BROW + wn * 16 + lcol) * 2;
        warp_k16<TT::MT, 1>(acc, a, mt_count, b);
      }
      if constexpr (!VEC) {
        if (nxt < nch) {
          put_w(nxt % kRing);
          feed.put(nxt % kRing);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the rings are free for the next pass

    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < TT::MT; ++i) {
      if (i < mt_count) {
        const int r = (wmi + i * TT::WM) * 16 + g;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn * 16 + j * 8 + 2 * t;
          if (n < n_end) {
            if (r < M) epi(r, n, acc[i][j][0], acc[i][j][1]);
            if (r + 8 < M) epi(r + 8, n, acc[i][j][2], acc[i][j][3]);
          }
        }
      }
    }
  }
  __syncthreads();
}

// Stage 1's A: x at the tile's pixels grown by 2 (tab: global pixel or -1),
// staged in chunks of kBK channels
template <bool VEC>
struct XFeed {
  const __nv_bfloat16* x;
  const int* tab;
  unsigned char* xa;
  int MA, Cin, xa_stage;
  __nv_bfloat16 r[VEC ? 1 : 18];  // scalar: MA / 8 <= 18 values a thread
  __device__ __forceinline__ void base(int p, uint32_t& b0, uint32_t& b1) const {
    b0 = p * kARow * 2;
    b1 = 0;
  }
  __device__ __forceinline__ uint32_t at(uint32_t b0, uint32_t, int k, uint32_t xa_addr) const {
    return xa_addr + b0 + (k % kBK) * 2;
  }
  __device__ __forceinline__ void issue(int ch, int s) {
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(xa + s * xa_stage);
    for (int i = threadIdx.x; i < MA * 4; i += kC2fThreads) {
      const int row = i / 4, seg = i % 4, k = ch * kBK + seg * 8;
      const int gp = tab[row];
      const bool ok = gp >= 0 && k < Cin;
      cp_async16(smem_addr(dst + row * kARow + seg * 8), ok ? x + (size_t)gp * Cin + k : x, ok ? 16 : 0);
    }
  }
  __device__ __forceinline__ void fetch(int ch) {
    if constexpr (!VEC) {
      const int kk = threadIdx.x % kBK, k = ch * kBK + kk;
#pragma unroll
      for (int i = 0; i < 18; ++i) {
        const int row = threadIdx.x / kBK + i * (kC2fThreads / kBK);
        const int gp = row < MA ? tab[row] : -1;
        const bool ok = gp >= 0 && k < Cin;
        const __nv_bfloat16 v = x[ok ? (size_t)gp * Cin + k : 0];
        r[i] = ok ? v : __float2bfloat16_rn(0.f);  // loaded at a clamped address and masked
      }
    }
  }
  __device__ __forceinline__ void put(int s) {
    if constexpr (!VEC) {
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(xa + s * xa_stage);
#pragma unroll
      for (int i = 0; i < 18; ++i) {
        const int row = threadIdx.x / kBK + i * (kC2fThreads / kBK);
        if (row < MA) dst[row * kARow + threadIdx.x % kBK] = r[i];
      }
    }
  }
};

// Stages 2 and 3: a 3x3 window of a shared pixel grid (`gw` wide, rows of
// `rs` values, the window reading channels c_off..) at the grid position of
// row p's window corner, `corner(p)`
struct WindowFeed {
  uint32_t src;  // shared address of the grid
  int rs, c_off, cp, gw, kp, dst_w;  // dst_w: width of the rows' own grid
  __device__ __forceinline__ void base(int p, uint32_t& b0, uint32_t& b1) const {
    b0 = src + ((p / dst_w) * gw + p % dst_w) * rs * 2;
    b1 = 0;
  }
  __device__ __forceinline__ uint32_t at(uint32_t b0, uint32_t, int k, uint32_t) const {
    k = k < kp ? k : 0;  // past the end: any finite value, its weight row is zero
    const int tap = k / cp, ci = k - tap * cp;
    return b0 + (((tap / 3) * gw + tap % 3) * rs + c_off + ci) * 2;
  }
  __device__ __forceinline__ void issue(int, int) {}
  __device__ __forceinline__ void fetch(int) {}
  __device__ __forceinline__ void put(int) {}
};

// Stage 4: [a | b] from y at the tile pixel's place in y's grid, then p
struct ConcatFeed {
  uint32_t y, p;
  int ys, ts, cp, T, gw1, kp;
  __device__ __forceinline__ void base(int q, uint32_t& b0, uint32_t& b1) const {
    b0 = y + ((q / T + 2) * gw1 + q % T + 2) * ys * 2;
    b1 = p + q * ts * 2;
  }
  __device__ __forceinline__ uint32_t at(uint32_t b0, uint32_t b1, int k, uint32_t) const {
    k = k < kp ? k : 0;
    return k < 2 * cp ? b0 + k * 2 : b1 + (k - 2 * cp) * 2;
  }
  __device__ __forceinline__ void issue(int, int) {}
  __device__ __forceinline__ void fetch(int) {}
  __device__ __forceinline__ void put(int) {}
};

__device__ __forceinline__ void put2(__nv_bfloat16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// put2 into this block's shared memory and, in a cluster of S blocks (S a
// power of 2), at the same offset in every other block's (`st_cluster`: the
// block goes on at once)
__device__ __forceinline__ void put2_cluster(__nv_bfloat16* dst, float v0, float v1, int S, int rank) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(dst) = v;
  const uint32_t bits = (uint32_t)__bfloat16_as_ushort(v.x) | (uint32_t)__bfloat16_as_ushort(v.y) << 16;
  for (int q = 1; q < S; ++q) st_cluster(cluster_addr(smem_addr(dst), (rank + q) & (S - 1)), bits);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kC2fThreads) c2f_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
    const __nv_bfloat16* __restrict__ wm1, const float* __restrict__ bm1, const __nv_bfloat16* __restrict__ wm2,
    const float* __restrict__ bm2, const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
    __nv_bfloat16* __restrict__ out, int H, int W, int Cin, int c, int F, int T, int tiles_x, int shortcut,
    int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const C2fLayout L = c2f_layout(c, T, BN, VEC);
  const int cp = L.cp, Fp = round8(F);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem + L.y);
  __nv_bfloat16* t1s = reinterpret_cast<__nv_bfloat16*>(smem + L.t1);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + L.p);
  int* tab = reinterpret_cast<int*>(smem + L.tab);
  const int tid = threadIdx.x;
  const int rank = (int)(blockIdx.x % S), tile = (int)(blockIdx.x / S), img = blockIdx.y;
  const int ty0 = (tile / tiles_x) * T, tx0 = (tile % tiles_x) * T;
  const int gw1 = T + 4, gw2 = T + 2;
  constexpr int WBN = c2f_wide(BN);  // columns a pass of stages 1 and 4
  auto inside = [&](int gy, int gx) { return gy >= 0 && gy < H && gx >= 0 && gx < W; };

  // a cluster barrier: the slices that every block wrote into the others' y,
  // t1 or p are all there (and, first, every block of the cluster runs)
  auto cluster_sync = [&]() {
    if (S > 1) cg::this_cluster().sync();
  };

  for (int r = tid; r < L.MA; r += kC2fThreads) {
    const int gy = ty0 - 2 + r / gw1, gx = tx0 - 2 + r % gw1;
    tab[r] = r < L.P1 && inside(gy, gx) ? (img * H + gy) * W + gx : -1;
  }
  __syncthreads();
  cluster_sync();  // no block writes into another's shared memory before that one runs

  // ---- stage 1: y = silu(x @ w1 + b1) on the tile grown by 2, zero outside the image
  {
    XFeed<VEC> feed{x, tab, smem + L.xa, L.MA, Cin, L.MA * kARow * 2};
    const WMat wm{w1, 2 * c, Cin, Cin, Cin, cp, c};
    auto epi = [&](int p, int n, float v0, float v1) {
      const int ci = n % cp, col = (n / cp) * c + ci;
      const bool in = tab[p] >= 0;
      v0 = in && ci < c ? silu_fast(v0 + b1[col]) : 0.f;
      v1 = in && ci + 1 < c ? silu_fast(v1 + b1[col + 1]) : 0.f;
      put2_cluster(ys + p * L.ys + n, v0, v1, S, rank);
    };
    product<WBN, kBK, VEC>(smem, L, L.P1, rank * 2 * cp / S, (rank + 1) * 2 * cp / S, wm, feed, epi);
    cluster_sync();  // y is whole, and every block's x ring (over t1 and p) is free
  }
  // ---- stage 2: t1 = silu(conv3x3(b) + bm1) on the tile grown by 1
  {
    WindowFeed feed{smem_addr(ys), L.ys, cp, cp, gw1, 9 * cp, gw2};
    const WMat wm{wm1, c, 9 * cp, cp, c, cp, c};
    auto epi = [&](int p, int n, float v0, float v1) {
      const bool in = inside(ty0 - 1 + p / gw2, tx0 - 1 + p % gw2);
      v0 = in && n < c ? silu_fast(v0 + bm1[n]) : 0.f;
      v1 = in && n + 1 < c ? silu_fast(v1 + bm1[n + 1]) : 0.f;
      put2_cluster(t1s + p * L.ts + n, v0, v1, S, rank);
    };
    product<BN, VEC ? kBKVec : kBK, VEC>(smem, L, L.P2, rank * cp / S, (rank + 1) * cp / S, wm, feed, epi);
    cluster_sync();
  }
  // ---- stage 3: p = b + silu(conv3x3(t1) + bm2) (or without b) on the tile
  {
    WindowFeed feed{smem_addr(t1s), L.ts, 0, cp, gw2, 9 * cp, T};
    const WMat wm{wm2, c, 9 * cp, cp, c, cp, c};
    auto epi = [&](int p, int n, float v0, float v1) {
      const __nv_bfloat16* b = ys + ((p / T + 2) * gw1 + p % T + 2) * L.ys + cp + n;
      v0 = n < c ? silu_fast(v0 + bm2[n]) + (shortcut ? __bfloat162float(b[0]) : 0.f) : 0.f;
      v1 = n + 1 < c ? silu_fast(v1 + bm2[n + 1]) + (shortcut ? __bfloat162float(b[1]) : 0.f) : 0.f;
      put2_cluster(ps + p * L.ts + n, v0, v1, S, rank);
    };
    product<BN, VEC ? kBKVec : kBK, VEC>(smem, L, L.P3, rank * cp / S, (rank + 1) * cp / S, wm, feed, epi);
    cluster_sync();  // no block writes into another's shared memory after this
  }
  // ---- stage 4: out = silu([a | b | p] @ w2 + b2), written where the tile is in the image
  {
    ConcatFeed feed{smem_addr(ys), smem_addr(ps), L.ys, L.ts, cp, T, gw1, 3 * cp};
    const WMat wm{w2, F, 3 * cp, cp, c, Fp, F};
    auto epi = [&](int p, int n, float v0, float v1) {
      const int gy = ty0 + p / T, gx = tx0 + p % T;
      if (gy >= H || gx >= W || n >= F) return;
      __nv_bfloat16* o = out + ((size_t)(img * H + gy) * W + gx) * F + n;
      v0 = silu_fast(v0 + b2[n]);
      if (n + 1 < F) {
        v1 = silu_fast(v1 + b2[n + 1]);
        if ((F & 1) == 0) {
          put2(o, v0, v1);
          return;
        }
        o[1] = __float2bfloat16_rn(v1);
      }
      o[0] = __float2bfloat16_rn(v0);
    };
    product<WBN, VEC ? kBKVec : kBK, VEC>(smem, L, L.P3, rank * Fp / S, (rank + 1) * Fp / S, wm, feed, epi);
  }
}

template <int BN, bool VEC>
cudaError_t launch_bf16(const void* x, const void* w1, const void* b1, const void* wm1, const void* bm1,
                        const void* wm2, const void* bm2, const void* w2, const void* b2, void* out, int B, int H,
                        int W, int Cin, int c, int F, int T, int S, int shortcut, cudaStream_t s) {
  auto kern = c2f_bf16_kernel<BN, VEC>;
  static const cudaError_t attr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return attr;
  const int bytes = c2f_layout(c, T, BN, VEC).total;
  const int tiles_x = (W + T - 1) / T, tiles_y = (H + T - 1) / T;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles_x * tiles_y * S), (unsigned)B);
  cfg.blockDim = dim3(kC2fThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = S;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = S > 1 ? 1 : 0;
  using bf = __nv_bfloat16;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const bf*>(x), static_cast<const bf*>(w1), static_cast<const float*>(b1),
      static_cast<const bf*>(wm1), static_cast<const float*>(bm1), static_cast<const bf*>(wm2),
      static_cast<const float*>(bm2), static_cast<const bf*>(w2), static_cast<const float*>(b2),
      static_cast<bf*>(out), H, W, Cin, c, F, T, tiles_x, shortcut, S);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BN>
cudaError_t launch_f32(const void* x, const void* w1, const void* b1, const void* wm1, const void* bm1,
                       const void* wm2, const void* bm2, const void* w2, const void* b2, void* out, int B, int H,
                       int W, int Cin, int c, int F, int T, int shortcut, cudaStream_t s) {
  const size_t bytes = f32_smem_bytes(BN, c, T);
  auto kern = c2f_f32_kernel<float, BN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + T - 1) / T, tiles_y = (H + T - 1) / T;
  const dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)B);
  kern<<<grid, kThreads, bytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(wm1), static_cast<const float*>(bm1), static_cast<const float*>(wm2),
      static_cast<const float*>(bm2), static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(out), H, W, Cin, c, F, T, T, tiles_x, shortcut);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block needs at a tile of T x T pixels, a
// cluster of S blocks and the gather vec (the wrapper computes the same to
// pick them).
extern "C" int slam_c2f_smem_bytes(int c, int T, int S, int bf16, int vec) {
  if (bf16) return c2f_layout(c, T, c2f_width(c, S), vec != 0).total;
  return (int)f32_smem_bytes(f32_width(c), c, T);
}

// x (B, H, W, Cin), w1 (Cin, 2c), wm1 and wm2 (3, 3, c, c), w2 (3c, F) of one
// type (bf16 != 0: bfloat16, else float32); b1 (2c), bm1 (c), bm2 (c), b2 (F)
// float32 -> out (B, H, W, F) of the activations' type.  T x T is the output
// tile of a block (T in 2, 4, 8), S the blocks of a cluster that share one
// tile (1, 2 or 4; bfloat16 only; every product's padded width divisible by
// 8 S), vec != 0 the 16-byte copies (bfloat16; Cin, c and F multiples of 8).
extern "C" int slam_c2f_fused(const void* x, const void* w1, const void* b1, const void* wm1,
                              const void* bm1, const void* wm2, const void* bm2, const void* w2,
                              const void* b2, void* out, int B, int H, int W, int Cin, int c, int F,
                              int T, int S, int shortcut, int bf16, int vec, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || c <= 0 || F <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (!(T == 2 || T == 4 || T == 8) || !(S == 1 || S == 2 || S == 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    if (S != 1 || vec) return (int)cudaErrorInvalidValue;
    const int bn = f32_width(c);
    if (bn == 16) return (int)launch_f32<16>(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, out, B, H, W, Cin, c, F, T, shortcut, s);
    if (bn == 32) return (int)launch_f32<32>(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, out, B, H, W, Cin, c, F, T, shortcut, s);
    return (int)launch_f32<64>(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, out, B, H, W, Cin, c, F, T, shortcut, s);
  }
  const int cp = round8(c), Fp = round8(F);
  if ((2 * cp) % (8 * S) || cp % (8 * S) || Fp % (8 * S)) return (int)cudaErrorInvalidValue;
  if (vec && (Cin % 8 || c % 8 || F % 8)) return (int)cudaErrorInvalidValue;
  if (vec && ((uintptr_t)x | (uintptr_t)w1 | (uintptr_t)wm1 | (uintptr_t)wm2 | (uintptr_t)w2) % 16)
    return (int)cudaErrorInvalidValue;
  const int bn = c2f_width(c, S);
#define SLAM_C2F(BN_, VEC_)                                                                                  \
  if (bn == BN_ && (vec != 0) == VEC_)                                                                       \
    return (int)launch_bf16<BN_, VEC_>(x, w1, b1, wm1, bm1, wm2, bm2, w2, b2, out, B, H, W, Cin, c, F, T, S, \
                                       shortcut, s);
  SLAM_C2F(16, true) SLAM_C2F(32, true) SLAM_C2F(64, true)
  SLAM_C2F(16, false) SLAM_C2F(32, false) SLAM_C2F(64, false)
#undef SLAM_C2F
  return (int)cudaErrorInvalidValue;
}
