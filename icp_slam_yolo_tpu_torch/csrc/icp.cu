// K1: the whole gated point-to-point ICP loop, for B independent
// registrations (the fleet's robot axis), in one cooperative launch.
//
// Replaces the TPU kernel `icp_fused_pallas` (icp_slam_yolo_tpu/ops/pallas/
// icp_fused.py, `_icp_kernel` via `_fused_batched`).  Semantics kept, per
// iteration: transform the source by (cos, sin, tx, ty); nearest valid target
// per live source row in difference form, first index on equal d^2; gate at
// d^2 < threshold^2; eight weighted moments in f32, in metres, uncentred;
// closed-form SE(2) Kabsch on (cos, sin); compose with renormalisation;
// optional Anderson(1); stop once |delta mean inlier distance| < tolerance.
// A last sweep at the final pose gives the inlier count and RMSE.  The
// wrapper recentres the problem on the valid-target centroid first (the
// moments are accumulated uncentred, so that matters in f32) and maps the
// (cos, sin) result back to an angle.
//
// Bound on this card: operations.  Each executed iteration sweeps live source
// x live target pairs at ~7 FP32 operations (two subtracts, two multiplies,
// an add, a compare, a select); at the slice's shapes (~250 x ~20k live) that
// is ~35 MFLOP, ~0.5 us at 67 TFLOP/s.  A single block per registration
// would leave 131 SMs idle, so the resident blocks of the card are shared
// out evenly among the B registrations (all of them to one registration at
// B = 1, max(1, resident / B) each otherwise; the launcher refuses a B above
// the resident count instead of hanging at a barrier), and every phase of an
// iteration is spread over a registration's blocks, with two grid-wide
// barriers between them:
//   1. sweep: work items are (256 source rows) x (256-target slice), walked
//      grid-stride; each writes per-row (min d^2, argmin) partials;
//   2. fold: one warp per live source row folds its partials across slices
//      (lane-strided, then a shuffle argmin that keeps the lower index on
//      equal d^2, i.e. the first index overall), gates, and writes the row's
//      eight moment terms (zeros for a row that is gated out);
//   3. solve: every block sums its registration's per-row moments in one
//      fixed order (thread t takes rows t, t + 256, ...; then a fixed tree)
//      and runs the same closed-form solve, so all blocks of a registration
//      hold the same pose bit for bit without a third barrier.
// The barriers span the grid, so the registrations iterate in lockstep, but
// each ends on its own: once its convergence test holds it runs its final
// sweep (inlier count and RMSE at the final pose), writes its result and
// from then on only waits at the barriers, costing no sweep and keeping its
// pose.  A registration entering its final sweep raises a flag in device
// memory; between the two barriers every block reads all B flags, and the
// loop ends when all are up: no host read per iteration.  The order of the
// moment sums does not depend on the blocks a registration was given, so a
// registration's result is the same bit for bit whether it is launched alone
// or among others.  Target slices with no valid point and source
// blocks with no live row skip their sweep.  Sums run in fixed orders, so a
// run is deterministic.  Invalid target slots are staged at far-away
// coordinates instead of carrying a mask, so the inner loop has no branch.
// The TPU kernel's Gram-form target rows, one-hot
// extraction and SMEM liveness flags are not carried over.
//
// Built with -fmad=false so each product rounds as the plain PyTorch
// version's separate operations do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 1e30f;
constexpr float kFar = 1e18f;  // coordinates of an invalid target slot
constexpr int kThreads = 256;  // source rows per work item == threads per block
constexpr int kTile = 256;     // targets per work item
constexpr int kWarps = kThreads / 32;

struct IcpArgs {
  const float* src;          // (B, S, 2) sensor-frame source, mm
  const uint8_t* src_valid;  // (B, S)
  const float* tgt;          // (B, T, 2) recentred target, mm
  const uint8_t* tgt_valid;  // (B, T)
  const float* params;       // (B, 4) [x, y, cos, sin] initial pose, recentred
  float* part_d2;            // (B, n_slices, S) scratch
  int* part_idx;             // (B, n_slices, S) scratch
  float* row_m;              // (B, S, 8) scratch: per-row moment terms
  int* finishing;            // (B,) scratch: registration b is in or past its final sweep
  float* out;                // (B, 8) [x, y, cos, sin, rmse, n_in, n_iters, 0]
  int B, bpr;                // registrations; blocks per registration
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

__global__ void __launch_bounds__(kThreads) icp_kernel(IcpArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float2 tile[kTile];
  __shared__ float red[8][kWarps];
  __shared__ float pose_sh[4];
  __shared__ int done_sh;

  const int S = a.S, T = a.T;
  const int n_sb = (S + kThreads - 1) / kThreads;
  const int n_ts = (T + kTile - 1) / kTile;
  const int items = n_sb * n_ts;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this block's registration and its place among that registration's blocks
  const int rb = blockIdx.x / a.bpr, lb = blockIdx.x % a.bpr, bpr = a.bpr;
  const float* src = a.src + static_cast<size_t>(rb) * S * 2;
  const uint8_t* src_valid = a.src_valid + static_cast<size_t>(rb) * S;
  const float* tgt = a.tgt + static_cast<size_t>(rb) * T * 2;
  const uint8_t* tgt_valid = a.tgt_valid + static_cast<size_t>(rb) * T;
  float* part_d2 = a.part_d2 + static_cast<size_t>(rb) * n_ts * S;
  int* part_idx = a.part_idx + static_cast<size_t>(rb) * n_ts * S;
  float* row_m = a.row_m + static_cast<size_t>(rb) * S * 8;
  float* out = a.out + rb * 8;

  float cth = a.params[rb * 4 + 2], sth = a.params[rb * 4 + 3];
  float ptx = a.params[rb * 4], pty = a.params[rb * 4 + 1];
  Solver solver;
  solver.pg0 = ptx; solver.pg1 = pty; solver.pg2 = cth; solver.pg3 = sth;
  bool done = false;      // converged: the next iteration is the final sweep
  bool finished = false;  // result written: only the barriers are left

  for (int it = 0;; ++it) {
    const bool final_pass = done || it >= a.iters;
    if (lb == 0 && tid == 0 && !finished) a.finishing[rb] = final_pass ? 1 : 0;

    // ---- 1. sweep: NN partials over (source block, target slice) items ----
    for (int item = lb; item < items && !finished; item += bpr) {
      const int sb = item % n_sb, ts = item / n_sb;
      const int i = sb * kThreads + tid;
      const bool row_live = i < S && src_valid[i];
      if (!__syncthreads_or(row_live)) continue;  // uniform across the block
      const int j = ts * kTile + tid;
      const bool tv = j < T && tgt_valid[j];
      // an invalid slot sits at kFar: its d^2 (~2e36) never beats kBig
      tile[tid] = tv ? make_float2(tgt[2 * j], tgt[2 * j + 1]) : make_float2(kFar, kFar);
      const bool slice_live = __syncthreads_or(tv);
      if (row_live) {
        float best = kBig;
        int arg = 0;
        if (slice_live) {
          const float sx = src[2 * i], sy = src[2 * i + 1];
          const float px = cth * sx - sth * sy + ptx;
          const float py = sth * sx + cth * sy + pty;
#pragma unroll 8
          for (int k = 0; k < kTile; ++k) {
            const float2 t = tile[k];
            const float dx = px - t.x;
            const float dy = py - t.y;
            const float d2 = dx * dx + dy * dy;
            if (d2 < best) {
              best = d2;
              arg = k;
            }
          }
        }
        part_d2[ts * S + i] = best;
        part_idx[ts * S + i] = ts * kTile + arg;
      }
      __syncthreads();  // the next item overwrites the shared tile
    }
    grid.sync();

    // every registration in or past its final sweep: this iteration is the last
    // (a flag rises only before the first barrier of an iteration, and no
    // block reaches the next iteration before all have read here)
    bool mine_up = true;
    for (int r = tid; r < a.B; r += kThreads) mine_up = mine_up && __ldcg(a.finishing + r) != 0;
    const bool last_iteration = __syncthreads_and(mine_up);

    // ---- 2. fold: one warp per live source row ----
    const int n_warps = bpr * kWarps;
    for (int i = lb * kWarps + warp; i < S && !finished; i += n_warps) {
      if (!src_valid[i]) continue;  // uniform across the warp
      float best = kBig;
      int arg = 0x7fffffff;
      for (int ts = lane; ts < n_ts; ts += 32) {
        const float d = __ldcg(part_d2 + ts * S + i);  // written by other blocks
        if (d < best) {
          best = d;
          arg = __ldcg(part_idx + ts * S + i);
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_down_sync(0xffffffffu, best, off);
        const int oa = __shfl_down_sync(0xffffffffu, arg, off);
        if (ob < best || (ob == best && oa < arg)) {
          best = ob;
          arg = oa;
        }
      }
      if (lane != 0) continue;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;  // no valid target or gated out: weight 0
      if (best < kBig) {
        const float sx = src[2 * i], sy = src[2 * i + 1];
        const float px = cth * sx - sth * sy + ptx;
        const float py = sth * sx + cth * sy + pty;
        const float mx = tgt[2 * arg], my = tgt[2 * arg + 1];
        const float dx = px - mx, dy = py - my;
        const float d2 = dx * dx + dy * dy;  // equals `best`: same difference form
        if (d2 < a.thr2) {
          if (final_pass) {
            lo = make_float4(1.f, d2, 0.f, 0.f);
          } else {
            const float pxm = px * 1e-3f, pym = py * 1e-3f, mxm = mx * 1e-3f, mym = my * 1e-3f;
            lo = make_float4(1.f, pxm, pym, mxm);
            hi = make_float4(mym, pxm * mxm + pym * mym, pxm * mym - pym * mxm, sqrtf(d2));
          }
        }
      }
      float4* dst = reinterpret_cast<float4*>(row_m + 8 * i);
      dst[0] = lo;
      dst[1] = hi;
    }
    grid.sync();

    // ---- 3. solve: every block sums the registration's row moments in the same order ----
    if (!finished) {  // uniform across the block
      float m[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int i = tid; i < S; i += kThreads) {
        if (!src_valid[i]) continue;
        const float4 lo = __ldcg(reinterpret_cast<const float4*>(row_m + 8 * i));  // written by other blocks
        const float4 hi = __ldcg(reinterpret_cast<const float4*>(row_m + 8 * i) + 1);
        m[0] += lo.x; m[1] += lo.y; m[2] += lo.z; m[3] += lo.w;
        m[4] += hi.x; m[5] += hi.y; m[6] += hi.z; m[7] += hi.w;
      }
      block_sum8(m, red);
      if (tid == 0) {
        if (final_pass) {
          if (lb == 0) {
            const float n_in = m[0];
            out[0] = ptx;
            out[1] = pty;
            out[2] = cth;
            out[3] = sth;
            out[4] = n_in > 0.f ? sqrtf(m[1] / fmaxf(n_in, 1.f)) : kBig;
            out[5] = n_in;
            out[6] = solver.n_iters;
            out[7] = 0.f;
          }
        } else {
          float p[4] = {cth, sth, ptx, pty};
          done_sh = solve(m, p, solver, a.anderson != 0, a.tol);
          pose_sh[0] = p[0];
          pose_sh[1] = p[1];
          pose_sh[2] = p[2];
          pose_sh[3] = p[3];
        }
      }
    }
    if (last_iteration) break;  // uniform across the grid
    if (final_pass) {
      finished = true;
      continue;
    }
    __syncthreads();
    cth = pose_sh[0];
    sth = pose_sh[1];
    ptx = pose_sh[2];
    pty = pose_sh[3];
    done = done_sh != 0;  // pose_sh is rewritten only after two more grid barriers
  }
}

}  // namespace

// B registrations in one launch.  Returns cudaErrorCooperativeLaunchTooLarge
// when B exceeds the blocks the card can hold resident at once.
extern "C" int slam_icp_fused(const void* src, const void* src_valid, int B, int S,
                              const void* tgt, const void* tgt_valid, int T,
                              const void* params, int iters, float thr2,
                              float tolerance, int anderson, void* part_d2,
                              void* part_idx, void* row_m, void* finishing,
                              void* out, void* stream) {
  if (B <= 0) return 0;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) return static_cast<int>(cudaErrorNotSupported);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, icp_kernel, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);

  // every block must be co-resident for grid.sync: the resident blocks are
  // shared out among the registrations; enough warps for the fold
  const int resident = sms * per_sm;
  if (B > resident) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int items = ((S + kThreads - 1) / kThreads) * ((T + kTile - 1) / kTile);
  const int fold_blocks = (S + kWarps - 1) / kWarps;
  int bpr = items > fold_blocks ? items : fold_blocks;
  if (bpr > resident / B) bpr = resident / B;
  if (bpr < 1) bpr = 1;

  IcpArgs a;
  a.src = static_cast<const float*>(src);
  a.src_valid = static_cast<const uint8_t*>(src_valid);
  a.tgt = static_cast<const float*>(tgt);
  a.tgt_valid = static_cast<const uint8_t*>(tgt_valid);
  a.params = static_cast<const float*>(params);
  a.part_d2 = static_cast<float*>(part_d2);
  a.part_idx = static_cast<int*>(part_idx);
  a.row_m = static_cast<float*>(row_m);
  a.finishing = static_cast<int*>(finishing);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.bpr = bpr;
  a.S = S;
  a.T = T;
  a.iters = iters;
  a.anderson = anderson;
  a.thr2 = thr2;
  a.tol = tolerance;

  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(icp_kernel), B * bpr,
                                  kThreads, args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
