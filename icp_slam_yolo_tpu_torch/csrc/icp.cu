// K1: the whole gated point-to-point ICP loop, for B independent
// registrations (the fleet's robot axis), in one launch.
//
// Replaces the TPU kernel `icp_fused_pallas` (icp_slam_yolo_tpu/ops/pallas/
// icp_fused.py, `_icp_kernel` via `_fused_batched`).  Semantics kept, per
// iteration: transform the source by (cos, sin, tx, ty); nearest valid target
// per live source row in difference form, first index on equal d^2; gate at
// d^2 < threshold^2; eight weighted moments in f32, in metres, uncentred;
// closed-form SE(2) Kabsch on (cos, sin); compose with renormalisation;
// optional Anderson(1); stop once |delta mean inlier distance| < tolerance.
// A last sweep at the final pose gives the inlier count and RMSE.  The
// kernel works in the frame of the valid targets' centroid (the moments are
// accumulated uncentred, so that matters in f32; the centroid is summed in
// float64) and maps the (cos, sin) result back to an angle in the map frame,
// so a call is this one launch.
//
// Bound on this card: operations.  Each executed iteration sweeps live source
// x live target pairs at ~7 FP32 operations (two subtracts, two multiplies,
// an add, a compare, a select); at the slice's shapes (~250 x ~20k live) that
// is ~35 MFLOP, ~0.5 us at 67 TFLOP/s.  So a registration is spread over many
// blocks (`icp_fused.icp_plan` picks how many from B and the shapes), and
// what an iteration costs besides its pairs is kept to one barrier among the
// registration's own blocks and one pass over 4 KB of keys:
//   - set-up, once a launch: the registration's first block sums the
//     centroid; each block stages the sources and the list of live rows, and
//     its share of the registration's valid targets, recentred and compacted
//     in index order (block (g, s) of `row_groups` x `slices` takes the s-th
//     of `slices` equal runs of valid targets and the g-th of `row_groups`
//     equal runs of live rows), into shared memory; nothing is staged again;
//   - sweep: in passes of up to 128 rows, lanes hold up to 4 rows each in
//     registers, and the lanes left over and the 8 warps split the block's
//     targets into contiguous runs (one shared-memory load feeds up to 4
//     pairs; groups of 4 targets, `nn_scan`); the minima are merged by
//     shuffles and in shared memory, and each row's (d^2, first index) goes
//     out as one 64-bit key (d^2 bits above the index: unsigned order is
//     (d^2, index) order) by atomicMin into the row's key word;
//   - one barrier among the registration's blocks, not across the grid, so
//     registrations do not run in lockstep and one that has finished exits.
//     Grid layout (a cooperative launch, every block resident): an arrival
//     count, red.release / ld.acquire at device scope.  Cluster layout (from
//     16 registrations on): a registration's blocks are one thread-block
//     cluster and the barrier is the cluster's; clusters wait their turn for
//     the card, so the number of registrations is not bounded by it;
//   - every block then reads the S keys, computes the gated moment terms of
//     every live row itself and sums them in one fixed order (thread t takes
//     rows t, t + 256, ...; then a fixed tree), and thread 0 of every block
//     runs the same closed-form solve: all blocks of a registration hold the
//     same pose bit for bit, with no second barrier.
// The keys rotate over three buffers: iteration i takes buffer i % 3 and,
// after its barrier, clears buffer (i + 2) % 3, which every block finished
// reading before that barrier and which nobody writes before the next one.
// Buffers 0 and 1 are cleared at set-up, before the launch's one grid-wide
// (or cluster-wide) barrier, which also publishes the centroids and the
// zeroed arrival counts.  The order of the moment sums and the
// nearest-neighbour choice do not depend on the blocks a registration was
// given, so its result is the same bit for bit whatever the layout and
// whether it is launched alone or among others.  The TPU kernel's Gram-form
// target rows, one-hot extraction and SMEM liveness flags are not carried
// over.
//
// Built with -fmad=false so each product rounds as the plain PyTorch
// version's separate operations do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nn_common.cuh"

namespace cg = cooperative_groups;
using namespace slam_nn;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 4;               // rows a lane holds in registers
constexpr int kRowsPass = 32 * kMaxR;  // rows a sweep pass takes at most
constexpr int kGroup = 4;              // targets a row takes the minimum over before comparing (nn_scan)
constexpr int kBarWords = 32;          // barrier words per registration (a 128-byte line; the count at 0)

struct IcpArgs {
  const float* src;             // (B, S, 2) sensor-frame source, mm
  const uint8_t* src_valid;     // (B, S)
  const float* tgt;             // (B, T, 2) target (map frame), mm
  const uint8_t* tgt_valid;     // (B, T)
  const float* init;            // (B, 3) initial pose [x, y, theta]
  unsigned long long* keys;     // (3, B, S) scratch: per-row (d^2, index) keys
  unsigned* bar;                // (B, kBarWords) scratch: barrier arrival counts (grid layout)
  float* centre;                // (B, 4) scratch: valid-target centroid x, y and count (as bits)
  float* pose;                  // (B, 3) out: [x, y, theta]
  float* rmse;                  // (B,) out: inlier RMSE, inf without an inlier
  int* n_in;                    // (B,) out: inliers at the final pose
  int* n_iters;                 // (B,) out: iterations run
  int B, row_groups, slices;    // blocks per registration: row_groups x slices
  int cluster;                  // 1: a registration's blocks are one thread-block cluster
  int cap;                      // targets a block's shared memory holds
  int S, T, iters, anderson;
  float thr2, tol;
};

// Sum eight per-thread values over the block in a fixed tree order; the
// result is valid in thread 0.
__device__ void block_sum8(float v[8], float (*red)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float x = v[k];
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[k][warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float x = lane < kWarps ? red[k][lane] : 0.f;
      for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
      v[k] = x;
    }
  }
  __syncthreads();
}

// Sum two doubles over the block in a fixed tree order; valid in thread 0.
__device__ void block_sum2(double& x, double& y, double (*red)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
    y += __shfl_down_sync(0xffffffffu, y, off);
  }
  if (lane == 0) {
    red[0][warp] = x;
    red[1][warp] = y;
  }
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? red[0][lane] : 0.0;
    y = lane < kWarps ? red[1][lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_down_sync(0xffffffffu, x, off);
      y += __shfl_down_sync(0xffffffffu, y, off);
    }
  }
  __syncthreads();
}

// Exclusive prefix sum of v over the block; *total gets the sum.
__device__ int block_scan(int v, int* total, int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_sum[w] : 0;
    all += warp_sum[w];
  }
  __syncthreads();  // warp_sum is rewritten by the next scan
  *total = all;
  return before + x - v;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The registration's barrier number `passed` + 1.  Grid layout: its blocks
// count their arrivals on one word (zeroed at set-up, never reset) and wait
// until all n have arrived `passed` + 1 times; the block barrier before the
// release orders the other threads' writes.  Every block of the grid is
// resident (a cooperative launch), so the wait ends.  Cluster layout: the
// hardware's cluster barrier, with release and acquire.
__device__ void registration_barrier(bool cluster, unsigned* count, unsigned n, unsigned passed) {
  if (cluster) {
    cluster_sync();
    return;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    red_release_add(count, 1u);
    const unsigned target = n * (passed + 1u);
    while (ld_acquire(count) < target) {
    }
  }
  __syncthreads();
}

// Thread 0's solver state (identical in every block).
struct Solver {
  float prev_err = kBig, n_iters = 0.f;
  float pf0 = 0.f, pf1 = 0.f, pf2 = 0.f, pf3 = 0.f;
  float pg0, pg1, pg2, pg3;
  bool have_prev = false;
};

// One closed-form update from the moments m; writes the new pose into
// p = [cos, sin, x, y] and returns the convergence test.
__device__ bool solve(const float m[8], float p[4], Solver& s, bool anderson, float tol) {
  const float cth = p[0], sth = p[1], ptx = p[2], pty = p[3];
  const float sw = m[0];
  const float safe = fmaxf(sw, 1e-9f);
  const float cax = m[1] / safe, cay = m[2] / safe;
  const float cbx = m[3] / safe, cby = m[4] / safe;
  const float sxx = m[5] - (m[1] * m[3] + m[2] * m[4]) / safe;
  const float sxy = m[6] - (m[1] * m[4] - m[2] * m[3]) / safe;
  const bool degenerate = sw < 1e-6f || sxx * sxx + sxy * sxy < 1e-30f;
  const float r = sqrtf(sxx * sxx + sxy * sxy);
  const float safe_r = fmaxf(r, 1e-30f);
  const float c2 = degenerate ? 1.f : sxx / safe_r;
  const float s2 = degenerate ? 0.f : sxy / safe_r;
  const float dtx = degenerate ? 0.f : (cbx - (c2 * cax - s2 * cay)) * 1e3f;
  const float dty = degenerate ? 0.f : (cby - (s2 * cax + c2 * cay)) * 1e3f;
  float nc = c2 * cth - s2 * sth;
  float ns = s2 * cth + c2 * sth;
  const float rn = 1.f / sqrtf(nc * nc + ns * ns);
  nc = nc * rn;
  ns = ns * rn;
  float ntx = c2 * ptx - s2 * pty + dtx;
  float nty = s2 * ptx + c2 * pty + dty;
  const float err = m[7] / fmaxf(sw, 1.f);
  const bool converged = fabsf(s.prev_err - err) < tol;
  if (anderson) {
    // Anderson(1) on the pose fixed point, rotation scaled by L = 1000
    const float L = 1000.f;
    const float f0 = ntx - ptx, f1 = nty - pty;
    const float f2 = L * (nc - cth), f3 = L * (ns - sth);
    const float d0 = f0 - s.pf0, d1 = f1 - s.pf1, d2 = f2 - s.pf2, d3 = f3 - s.pf3;
    const float den = d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
    const float num = f0 * d0 + f1 * d1 + f2 * d2 + f3 * d3;
    float gamma = den > 1e-12f ? num / fmaxf(den, 1e-12f) : 0.f;
    gamma = fminf(fmaxf(gamma, -9.f), 0.f);
    const float fn = f0 * f0 + f1 * f1 + f2 * f2 + f3 * f3;
    const float pfn = s.pf0 * s.pf0 + s.pf1 * s.pf1 + s.pf2 * s.pf2 + s.pf3 * s.pf3;
    if (!(s.have_prev && fn <= pfn)) gamma = 0.f;
    const float ax = ntx - gamma * (ntx - s.pg0);
    const float ay = nty - gamma * (nty - s.pg1);
    float ac = nc - gamma * (nc - s.pg2);
    float as = ns - gamma * (ns - s.pg3);
    const float arn = 1.f / sqrtf(fmaxf(ac * ac + as * as, 1e-12f));
    ac = ac * arn;
    as = as * arn;
    s.pf0 = f0; s.pf1 = f1; s.pf2 = f2; s.pf3 = f3;
    s.pg0 = ntx; s.pg1 = nty; s.pg2 = nc; s.pg3 = ns;
    s.have_prev = true;
    ntx = ax; nty = ay; nc = ac; ns = as;
  }
  s.prev_err = err;
  s.n_iters += 1.f;
  p[0] = nc;
  p[1] = ns;
  p[2] = ntx;
  p[3] = nty;
  return converged;
}

// One sweep pass: live rows base .. base + n - 1 (n <= LANES * R) against the
// block's m staged targets.  LANES lanes of a warp hold R rows each; the
// other 32 / LANES lanes of the warp and the 8 warps split the targets
// (part p of P takes the p-th of P contiguous runs).  The parts' minima are merged by
// shuffles, then the warps' in shared memory, in (d^2, index) order; each
// row's minimum leaves as one atomicMin.
template <int LANES, int R>
__device__ void sweep_pass(const float2* src_sh, const int* live, int base, int n, const float2* tgt_sh,
                           const int* tidx, int m, float cth, float sth, float ptx, float pty,
                           float (*red_d)[kRowsPass], int (*red_k)[kRowsPass], unsigned long long* keys) {
  constexpr int PW = 32 / LANES, P = PW * kWarps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l = lane % LANES, q = lane / LANES;
  float px[R], py[R], best[R];
  int arg[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = l + LANES * r;
    const float2 s = src_sh[live[base + (row < n ? row : 0)]];  // a row past n repeats the first
    px[r] = cth * s.x - sth * s.y + ptx;
    py[r] = sth * s.x + cth * s.y + pty;
    best[r] = kBig;
    arg[r] = kNoIndex;
  }
  const int p = warp * PW + q;
  nn_scan<R, kGroup>(tgt_sh, 0, m * p / P, m * (p + 1) / P, 1, px, py, best, arg);
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
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
    for (int r = 0; r < R; ++r) {
      red_d[warp][l + LANES * r] = best[r];
      red_k[warp][l + LANES * r] = arg[r];
    }
  }
  __syncthreads();
  if (tid < n) {
    float bd = kBig;
    int bk = kNoIndex;
    for (int w = 0; w < kWarps; ++w) {
      if (nn_before(red_d[w][tid], red_k[w][tid], bd, bk)) {
        bd = red_d[w][tid];
        bk = red_k[w][tid];
      }
    }
    if (bd < kBig) atomicMin(keys + live[base + tid], nn_key(bd, tidx[bk]));
  }
  __syncthreads();  // red is rewritten by the next pass
}

// The block's rows r0 .. r1 - 1 in passes that waste few lanes: 32 x R rows
// (R <= 4; all of them when that leaves fewer than 16 lanes idle) while 32
// or more are left, then the rest in one pass on 1-32 lanes a warp (a power
// of two), the lanes left over splitting the targets further.
__device__ void sweep(const float2* src_sh, const int* live, int r0, int r1, const float2* tgt_sh, const int* tidx,
                      int m, float cth, float sth, float ptx, float pty, float (*red_d)[kRowsPass],
                      int (*red_k)[kRowsPass], unsigned long long* keys) {
  for (int base = r0; base < r1;) {
    const int rem = r1 - base;
    int n;
    if (rem > 32 * kMaxR)
      n = 32 * kMaxR;
    else if (rem >= 32)  // the rows in one pass when that leaves fewer than 16 lanes idle
      n = 32 * ((rem + 15) / 32);
    else
      n = rem > 1 ? 1 << (32 - __clz(rem - 1)) : 1;  // the smallest power of two >= rem
#define SLAM_SWEEP_PASS(LANES_, R_) \
  sweep_pass<LANES_, R_>(src_sh, live, base, min(n, rem), tgt_sh, tidx, m, cth, sth, ptx, pty, red_d, red_k, keys)
    switch (n) {
      case 128: SLAM_SWEEP_PASS(32, 4); break;
      case 96: SLAM_SWEEP_PASS(32, 3); break;
      case 64: SLAM_SWEEP_PASS(32, 2); break;
      case 32: SLAM_SWEEP_PASS(32, 1); break;
      case 16: SLAM_SWEEP_PASS(16, 1); break;
      case 8: SLAM_SWEEP_PASS(8, 1); break;
      case 4: SLAM_SWEEP_PASS(4, 1); break;
      case 2: SLAM_SWEEP_PASS(2, 1); break;
      default: SLAM_SWEEP_PASS(1, 1); break;
    }
#undef SLAM_SWEEP_PASS
    base += min(n, rem);
  }
}

__global__ void __launch_bounds__(kThreads) icp_kernel(IcpArgs a) {
  extern __shared__ float2 dyn[];
  __shared__ float red_d[kWarps][kRowsPass];
  __shared__ int red_k[kWarps][kRowsPass];
  __shared__ float red[8][kWarps];
  __shared__ double red2[2][kWarps];
  __shared__ int warp_sum[kWarps];
  __shared__ float pose_sh[4];
  __shared__ int done_sh;

  const int S = a.S, T = a.T;
  float2* src_sh = dyn;             // (S) the sources
  float2* tgt_sh = dyn + S;         // (cap) this block's targets, compacted
  int* live = reinterpret_cast<int*>(dyn + S + a.cap);  // (S) live rows in order
  int* tidx = live + S;             // (cap) each staged target's index
  const int tid = threadIdx.x;
  // this block's registration, and its row group and target slice in it
  const bool cluster = a.cluster != 0;
  const int bpr = a.row_groups * a.slices;
  const int rb = blockIdx.x / bpr, lb = cluster ? cluster_rank() : blockIdx.x % bpr;
  const int group = lb / a.slices, slice = lb % a.slices;
  const float* src = a.src + static_cast<size_t>(rb) * S * 2;
  const uint8_t* src_valid = a.src_valid + static_cast<size_t>(rb) * S;
  const float2* tgt = reinterpret_cast<const float2*>(a.tgt) + static_cast<size_t>(rb) * T;
  const uint8_t* tgt_valid = a.tgt_valid + static_cast<size_t>(rb) * T;
  const size_t kstride = static_cast<size_t>(a.B) * S;  // from one key buffer to the next
  unsigned long long* keys = a.keys + static_cast<size_t>(rb) * S;
  unsigned* count = a.bar + static_cast<size_t>(rb) * kBarWords;
  float* centre = a.centre + rb * 4;

  // ---- set-up ----
  if (lb == 0) {
    // the registration's frame: its valid targets' centroid, summed in
    // float64 in one fixed order (thread t slots t, t + 256, ...; then a
    // tree), so it does not depend on the layout or the other registrations;
    // every slot is loaded (no branch around a load), invalid ones add 0
    double sx = 0.0, sy = 0.0;
    int mine = 0;
    for (int j = tid; j < T; j += kThreads) {
      const float2 t = tgt[j];
      const bool v = tgt_valid[j] != 0;
      sx += v ? static_cast<double>(t.x) : 0.0;
      sy += v ? static_cast<double>(t.y) : 0.0;
      mine += v;
    }
    int valid;
    block_scan(mine, &valid, warp_sum);
    block_sum2(sx, sy, red2);
    if (tid == 0) {
      const double n = valid > 0 ? static_cast<double>(valid) : 1.0;
      centre[0] = static_cast<float>(sx / n);
      centre[1] = static_cast<float>(sy / n);
      centre[2] = __int_as_float(valid);
      if (!cluster) *count = 0u;
    }
  }
  for (int i = lb * kThreads + tid; i < S; i += bpr * kThreads) {
    keys[i] = kNoKey;            // iteration 0's buffer
    keys[kstride + i] = kNoKey;  // iteration 1's
  }
  // sources, and the live rows in row order (thread t scans a run of rows)
  int n_live;
  {
    const int run = (S + kThreads - 1) / kThreads, i0 = min(S, tid * run), i1 = min(S, i0 + run);
    int mine = 0;
    for (int i = i0; i < i1; ++i) {
      src_sh[i] = make_float2(src[2 * i], src[2 * i + 1]);
      mine += src_valid[i] != 0;
    }
    int at = block_scan(mine, &n_live, warp_sum);
    for (int i = i0; i < i1; ++i)
      if (src_valid[i]) live[at++] = i;
  }
  const int r0 = static_cast<int>(static_cast<long long>(n_live) * group / a.row_groups);
  const int r1 = static_cast<int>(static_cast<long long>(n_live) * (group + 1) / a.row_groups);
  // the barrier counts, key buffers 0 and 1 and the centroids set everywhere
  if (cluster)
    cluster_sync();
  else
    cg::this_grid().sync();
  const float cx = __ldcg(centre), cy = __ldcg(centre + 1);  // written by another block
  const long long nv = __float_as_int(__ldcg(centre + 2));
  const int v0 = static_cast<int>(nv * slice / a.slices), v1 = static_cast<int>(nv * (slice + 1) / a.slices);
  const int m = v1 - v0;
  {
    // this block's targets: valid ranks [v0, v1) of the registration's valid
    // targets, in index order; their indices first (thread t scans a run of
    // slots), then the targets themselves, every load independent of the others
    const int run = (T + kThreads - 1) / kThreads, j0 = min(T, tid * run), j1 = min(T, j0 + run);
    int mine = 0;
    for (int j = j0; j < j1; ++j) mine += tgt_valid[j] != 0;
    int total;
    int rank = block_scan(mine, &total, warp_sum);
    for (int j = j0; j < j1 && rank < v1; ++j) {
      const bool v = tgt_valid[j] != 0;
      if (v && rank >= v0) tidx[rank - v0] = j;
      rank += v;
    }
    __syncthreads();
    for (int k = tid; k < m; k += kThreads) {
      const float2 t = tgt[tidx[k]];
      tgt_sh[k] = make_float2(t.x - cx, t.y - cy);  // recentred
    }
  }
  __syncthreads();

  // the initial pose in the recentred frame, the rotation as (cos, sin)
  float cth = cosf(a.init[rb * 3 + 2]), sth = sinf(a.init[rb * 3 + 2]);
  float ptx = a.init[rb * 3] - cx, pty = a.init[rb * 3 + 1] - cy;
  Solver solver;
  solver.pg0 = ptx; solver.pg1 = pty; solver.pg2 = cth; solver.pg3 = sth;
  bool done = false;  // converged: the next iteration is the final sweep

  for (int it = 0;; ++it) {
    const bool final_pass = done || it >= a.iters;
    unsigned long long* kcur = keys + (it % 3) * kstride;

    // ---- sweep: this block's rows x its targets, one atomicMin a row ----
    if (m > 0) sweep(src_sh, live, r0, r1, tgt_sh, tidx, m, cth, sth, ptx, pty, red_d, red_k, kcur);
    registration_barrier(cluster, count, static_cast<unsigned>(bpr), static_cast<unsigned>(it));

    // the buffer iteration it + 2 takes: read by all before this barrier
    unsigned long long* kclear = keys + ((it + 2) % 3) * kstride;
    for (int i = lb * kThreads + tid; i < S; i += bpr * kThreads) kclear[i] = kNoKey;

    // ---- moments: every block sums every live row's terms in the same order ----
    float mo[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i0 = tid; i0 < S; i0 += 2 * kThreads) {
      // two rows at a time (t, t + 256): their key loads, then their target
      // loads, in flight together; the sum takes the rows in order
      unsigned long long key[2];
      float2 t[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + h * kThreads;
        key[h] = i < S && src_valid[i] ? __ldcg(kcur + i) : kNoKey;  // written by other blocks
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) t[h] = key[h] != kNoKey ? tgt[nn_key_index(key[h])] : make_float2(cx, cy);
#pragma unroll
      for (int h = 0; h < 2; ++h) t[h] = make_float2(t[h].x - cx, t[h].y - cy);  // recentred as staged
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + h * kThreads;
        if (i >= S || !src_valid[i]) continue;
        float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;  // no valid target or gated out: weight 0
        if (key[h] != kNoKey) {
          const float2 s = src_sh[i];
          const float px = cth * s.x - sth * s.y + ptx;
          const float py = sth * s.x + cth * s.y + pty;
          const float d2 = nn_d2(px, py, t[h]);  // equals the key's d^2: same difference form
          if (d2 < a.thr2) {
            if (final_pass) {
              lo = make_float4(1.f, d2, 0.f, 0.f);
            } else {
              const float pxm = px * 1e-3f, pym = py * 1e-3f, mxm = t[h].x * 1e-3f, mym = t[h].y * 1e-3f;
              lo = make_float4(1.f, pxm, pym, mxm);
              hi = make_float4(mym, pxm * mxm + pym * mym, pxm * mym - pym * mxm, sqrtf(d2));
            }
          }
        }
        mo[0] += lo.x; mo[1] += lo.y; mo[2] += lo.z; mo[3] += lo.w;
        mo[4] += hi.x; mo[5] += hi.y; mo[6] += hi.z; mo[7] += hi.w;
      }
    }
    block_sum8(mo, red);
    if (tid == 0) {
      if (final_pass) {
        if (lb == 0) {  // back in the map frame, the angle from (cos, sin)
          const float n_in = mo[0];
          a.pose[rb * 3] = ptx + cx;
          a.pose[rb * 3 + 1] = pty + cy;
          a.pose[rb * 3 + 2] = atan2f(sth, cth);
          a.rmse[rb] = n_in > 0.f ? sqrtf(mo[1] / fmaxf(n_in, 1.f)) : __int_as_float(0x7f800000);
          a.n_in[rb] = static_cast<int>(n_in);
          a.n_iters[rb] = static_cast<int>(solver.n_iters);
        }
      } else {
        float p[4] = {cth, sth, ptx, pty};
        done_sh = solve(mo, p, solver, a.anderson != 0, a.tol);
        pose_sh[0] = p[0];
        pose_sh[1] = p[1];
        pose_sh[2] = p[2];
        pose_sh[3] = p[3];
      }
    }
    if (final_pass) break;  // uniform across the registration's blocks: they all exit here
    __syncthreads();
    cth = pose_sh[0];
    sth = pose_sh[1];
    ptx = pose_sh[2];
    pty = pose_sh[3];
    done = done_sh != 0;  // pose_sh is rewritten only after block_sum8's barriers
  }
}

// the largest dynamic shared memory a block may ask for (set once, with
// clusters of up to 16 blocks allowed)
int max_dynamic_smem() {
  static int bytes = -1;
  if (bytes < 0) {
    cudaFuncAttributes attr;
    int dev = 0, optin = 0;
    if (cudaFuncGetAttributes(&attr, icp_kernel) != cudaSuccess || cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
      return 0;
    const int most = optin - static_cast<int>(attr.sharedSizeBytes);
    if (cudaFuncSetAttribute(icp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most) != cudaSuccess ||
        cudaFuncSetAttribute(icp_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess)
      return 0;
    bytes = most;
  }
  return bytes;
}

int smem_bytes(int S, int cap) { return 12 * (S + cap); }  // mirrored by icp_fused.smem_bytes

cudaLaunchConfig_t cluster_config(int blocks, int per_cluster, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = per_cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Blocks of K1 a multiprocessor holds at once with `smem` bytes of dynamic
// shared memory (0 when a block cannot have that much).
extern "C" int slam_icp_blocks_per_sm(int smem, void* out) {
  const int most = max_dynamic_smem();
  int per_sm = 0;
  if (most > 0 && smem <= most) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, icp_kernel, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *static_cast<int*>(out) = per_sm;
  return 0;
}

// Clusters of `per_cluster` K1 blocks with `smem` bytes each that the card
// runs at once (0 when none fits).
extern "C" int slam_icp_clusters(int per_cluster, int smem, void* out) {
  const int most = max_dynamic_smem();
  int n = 0;
  if (most > 0 && smem <= most && per_cluster >= 1 && per_cluster <= 16) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(per_cluster, per_cluster, smem, nullptr, &attr);
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, icp_kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *static_cast<int*>(out) = n;
  return 0;
}

// B registrations in one launch, each over row_groups x slices blocks.  Grid
// layout (cluster 0): a cooperative launch, which returns
// cudaErrorCooperativeLaunchTooLarge when the blocks do not fit on the card
// at once (they must, for the barriers).  Cluster layout: a registration's
// blocks (up to 16) are one cluster; clusters wait their turn, so B is not
// bounded by the card.
extern "C" int slam_icp_fused(const void* src, const void* src_valid, int B, int S, const void* tgt,
                              const void* tgt_valid, int T, const void* init, int iters, float thr2,
                              float tolerance, int anderson, int row_groups, int slices, int cluster,
                              void* keys, void* bar, void* centre, void* pose, void* rmse, void* n_in,
                              void* n_iters, void* stream) {
  if (B <= 0) return 0;
  const int bpr = row_groups * slices;
  if (row_groups < 1 || slices < 1 || (cluster && bpr > 16)) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = T > 0 ? (T + slices - 1) / slices : 1;
  const int smem = smem_bytes(S, cap);
  const long long blocks = static_cast<long long>(B) * bpr;
  const auto st = static_cast<cudaStream_t>(stream);
  int fit = 0;
  const int err = cluster ? slam_icp_clusters(bpr, smem, &fit) : slam_icp_blocks_per_sm(smem, &fit);
  if (err != 0) return err;
  if (cluster && fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (!cluster) {
    int dev = 0, sms = 0, coop = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess && !coop) return static_cast<int>(cudaErrorNotSupported);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (blocks > static_cast<long long>(sms) * fit) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }

  IcpArgs a;
  a.src = static_cast<const float*>(src);
  a.src_valid = static_cast<const uint8_t*>(src_valid);
  a.tgt = static_cast<const float*>(tgt);
  a.tgt_valid = static_cast<const uint8_t*>(tgt_valid);
  a.init = static_cast<const float*>(init);
  a.keys = static_cast<unsigned long long*>(keys);
  a.bar = static_cast<unsigned*>(bar);
  a.centre = static_cast<float*>(centre);
  a.pose = static_cast<float*>(pose);
  a.rmse = static_cast<float*>(rmse);
  a.n_in = static_cast<int*>(n_in);
  a.n_iters = static_cast<int*>(n_iters);
  a.B = B;
  a.row_groups = row_groups;
  a.slices = slices;
  a.cluster = cluster;
  a.cap = cap;
  a.S = S;
  a.T = T;
  a.iters = iters;
  a.anderson = anderson;
  a.thr2 = thr2;
  a.tol = tolerance;

  cudaError_t e;
  if (cluster) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(static_cast<int>(blocks), bpr, smem, st, &attr);
    e = cudaLaunchKernelEx(&cfg, icp_kernel, a);
  } else {
    void* args[] = {&a};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(icp_kernel), static_cast<int>(blocks), kThreads, args,
                                    smem, st);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
