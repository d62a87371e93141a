// K2 and K4: one scan's occupancy update inside the window around the robot,
// for B robots in one launch.
//
// K2 (`slam_raster_update`) replaces the TPU kernel `raster_update_pallas`
// and K4 (`slam_raster_update_grid`) replaces `raster_update_grid_pallas`
// (both in icp_slam_yolo_tpu/ops/pallas/raster_fused.py).  Semantics kept, per
// robot: closed-form Bresenham from each ray's window-local endpoint cell
// back to the robot cell with the reference's tie-break (x-driven iff
// dx > dy); samples i in [0, min(L, K-1)]; each ray stops at its first body
// cell whose SCAN-START probability is >= block_threshold (the blocked cell
// itself is not freed and the endpoint is then dropped); per cell,
// p *= decay^n_free and then p = min(1, p + inc * n_end).  A cell outside
// the window counts nothing and never blocks.  Each robot has its own window
// origin and its own accept flag; a robot whose flag is false keeps its grid.
//
// Bound on this card: bytes, for the work the function needs: per robot the
// window (side_y x side_x f32, 384 x 384 at the step's shapes, 0.59 MB) read
// and written once, plus the rays; ~0.35 us per robot at 3.35 TB/s.  The
// rays add ~512 x 145 cell visits per robot, far below the FP32 roof.
//
// Design: pass 1 (shared by K2 and K4) runs one warp per ray (a thread per
// ray would chain ~145 dependent grid loads), blockIdx.y picking the robot,
// reads the frozen blocked grid straight from the unmodified input and
// atomicAdds int32 free/endpoint counts into a zeroed per-robot window
// scratch; integer counts are exact and commute, so the result does not
// depend on atomic order.  Pass 2 differs:
//   K2 returns a new grid (the single-robot SLAM state stays functional): one
//   thread per grid cell writes the whole output, a cell inside the window
//   gets the update and every other cell is copied.  That copy is the
//   wrapper's own overhead beyond the bound (the full 833 x 1000 grid, 6.7 MB
//   read and written); fusing it here spares a separate clone.
//   K4 updates the caller's grid in place, as the TPU kernel does through its
//   aliased output: one thread per window cell, and only cells that some ray
//   touched are written, so a fleet step moves B windows, not B grids.
// In both the accept flag is read on the device, so the step needs no select
// over the grid and the host never reads the origin or the flag.  The TPU
// kernels' one-hot MXU gathers and scatters, wedge boxes, roll placement and
// the (8, 128) alignment of the window origin are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRayThreads = 128;  // 4 rays (warps) per block
constexpr int kCellThreads = 256;

// meta: (B, 4) [y0, x0, rly, rlx] — window origin in the grid, robot cell in
// the window; occ (B, H, W); ey/ex/live (B, N); accept (B,) or null; counts
// (B, 2, side_y, side_x).
// One warp per ray: the lanes take 32 consecutive samples at a time, so the
// blocked-cell lookups of a chunk are loaded together, and a ballot finds
// the chunk's first blocked body cell.
__global__ void raster_count_kernel(
    const float* __restrict__ occ, int W, const int* __restrict__ meta,
    const int* __restrict__ ey, const int* __restrict__ ex,
    const uint8_t* __restrict__ live, const uint8_t* __restrict__ accept, int N,
    int side_y, int side_x, int K, float block_threshold,
    int H, int* __restrict__ counts) {
  const size_t rb = blockIdx.y;  // robot
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;  // uniform per warp
  const int lane = threadIdx.x & 31;
  if (r >= N || !live[rb * N + r] || (accept != nullptr && !accept[rb])) return;
  occ += rb * H * W;
  meta += rb * 4;
  ey += rb * N;
  ex += rb * N;
  int* free_n = counts + rb * 2 * side_y * side_x;
  int* end_n = free_n + side_y * side_x;
  const int y0 = meta[0], x0 = meta[1], rly = meta[2], rlx = meta[3];
  const int eyv = ey[r], exv = ex[r];
  const int dy = abs(eyv - rly), dx = abs(exv - rlx);
  const int sy = eyv >= rly ? 1 : -1, sx = exv >= rlx ? 1 : -1;
  const int ell = max(dx, dy);
  const bool x_driven = dx > dy;
  const int dmaj = x_driven ? dx : dy;
  const int dmin = x_driven ? dy : dx;
  const int b = 2 * max(dmaj, 1);
  const int last = min(ell, K - 1);
  for (int base = 0; base <= last; base += 32) {
    const int i = base + lane;
    // minor-axis steps: max(0, ceil((2 i dmin - dmaj) / (2 max(dmaj, 1))))
    const int a = 2 * i * dmin - dmaj;
    const int k = a > 0 ? (a + b - 1) / b : 0;
    const int lx = x_driven ? rlx + sx * i : rlx + sx * k;
    const int ly = x_driven ? rly + sy * k : rly + sy * i;
    const bool in_win = i <= last && ly >= 0 && ly < side_y && lx >= 0 && lx < side_x;
    const bool body = in_win && i < ell;
    const bool blocked =
        body && occ[static_cast<size_t>(y0 + ly) * W + (x0 + lx)] >= block_threshold;
    const unsigned bmask = __ballot_sync(0xffffffffu, blocked);
    const int first = bmask ? __ffs(bmask) - 1 : 32;
    if (body && lane < first) atomicAdd(&free_n[ly * side_x + lx], 1);
    if (bmask) return;  // the ray stops there; its endpoint is dropped
    if (in_win && i == ell) atomicAdd(&end_n[ly * side_x + lx], 1);
  }
}

__device__ __forceinline__ float updated(float p, int n_free, int n_end, float decay, float inc) {
  p = p * powf(decay, static_cast<float>(n_free));
  return fminf(1.0f, p + inc * static_cast<float>(n_end));
}

// K2's pass 2.  One thread per grid cell, blockIdx.y picking the robot: the
// window's cells take the update (where the scan was accepted), every other
// cell is copied.
__global__ void raster_apply_kernel(
    const float* __restrict__ occ, float* __restrict__ out, int H, int W,
    const int* __restrict__ meta, int side_y, int side_x,
    const int* __restrict__ counts, const uint8_t* __restrict__ accept,
    float decay, float inc) {
  const size_t b = blockIdx.y;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= H * W) return;
  const size_t g = b * H * W + cell;
  float p = occ[g];
  const int y = cell / W - meta[b * 4];
  const int x = cell % W - meta[b * 4 + 1];
  if ((accept == nullptr || accept[b]) && y >= 0 && y < side_y && x >= 0 && x < side_x) {
    const int* free_n = counts + b * 2 * side_y * side_x;
    const int c = y * side_x + x;
    p = updated(p, free_n[c], free_n[side_y * side_x + c], decay, inc);
  }
  out[g] = p;
}

// K4's pass 2.  One thread per window cell of every robot, in place; a cell
// no ray touched is not written.
__global__ void raster_apply_window_kernel(
    float* __restrict__ occ, int H, int W, const int* __restrict__ meta,
    int side_y, int side_x, const int* __restrict__ counts,
    const uint8_t* __restrict__ accept, float decay, float inc) {
  const size_t b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= side_y * side_x || (accept != nullptr && !accept[b])) return;
  const int* free_n = counts + b * 2 * side_y * side_x;
  const int nf = free_n[c], ne = free_n[side_y * side_x + c];
  if (nf == 0 && ne == 0) return;
  const int y = meta[b * 4] + c / side_x, x = meta[b * 4 + 1] + c % side_x;
  float* cell = occ + (b * H + y) * W + x;
  *cell = updated(*cell, nf, ne, decay, inc);
}

cudaError_t launch_count(const void* occ, int B, int H, int W, const void* meta,
                         const void* ey, const void* ex, const void* live,
                         const void* accept, int N, int side_y, int side_x, int K,
                         float block_threshold, void* counts, cudaStream_t s) {
  if (N <= 0) return cudaSuccess;
  const int rays_per_block = kRayThreads / 32;
  raster_count_kernel<<<dim3((N + rays_per_block - 1) / rays_per_block, B), kRayThreads, 0, s>>>(
      static_cast<const float*>(occ), W, static_cast<const int*>(meta),
      static_cast<const int*>(ey), static_cast<const int*>(ex),
      static_cast<const uint8_t*>(live), static_cast<const uint8_t*>(accept), N,
      side_y, side_x, K, block_threshold, H, static_cast<int*>(counts));
  return cudaGetLastError();
}

}  // namespace

// K2.  accept: (B,) device bools, or null for "always"; a robot's window is
// updated only where its flag is set.  Writes every cell of `out`.
extern "C" int slam_raster_update(const void* occ, void* out, int B, int H, int W,
                                  const void* meta, const void* ey,
                                  const void* ex, const void* live,
                                  const void* accept, int N,
                                  int side_y, int side_x, int K,
                                  float block_threshold, float decay, float inc,
                                  void* counts, void* stream) {
  if (B <= 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_count(occ, B, H, W, meta, ey, ex, live, accept, N, side_y,
                                     side_x, K, block_threshold, counts, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  raster_apply_kernel<<<dim3((H * W + kCellThreads - 1) / kCellThreads, B), kCellThreads, 0, s>>>(
      static_cast<const float*>(occ), static_cast<float*>(out), H, W,
      static_cast<const int*>(meta), side_y, side_x, static_cast<const int*>(counts),
      static_cast<const uint8_t*>(accept), decay, inc);
  return static_cast<int>(cudaGetLastError());
}

// K4.  As K2, but `occ` (B, H, W) is updated in place and only window cells
// are touched.
extern "C" int slam_raster_update_grid(void* occ, int B, int H, int W,
                                       const void* meta, const void* ey,
                                       const void* ex, const void* live,
                                       const void* accept, int N,
                                       int side_y, int side_x, int K,
                                       float block_threshold, float decay, float inc,
                                       void* counts, void* stream) {
  if (B <= 0 || N <= 0) return 0;  // no ray: no cell changes
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_count(occ, B, H, W, meta, ey, ex, live, accept, N, side_y,
                                     side_x, K, block_threshold, counts, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int win_cells = side_y * side_x;
  raster_apply_window_kernel<<<dim3((win_cells + kCellThreads - 1) / kCellThreads, B),
                               kCellThreads, 0, s>>>(
      static_cast<float*>(occ), H, W, static_cast<const int*>(meta), side_y, side_x,
      static_cast<const int*>(counts), static_cast<const uint8_t*>(accept), decay, inc);
  return static_cast<int>(cudaGetLastError());
}
