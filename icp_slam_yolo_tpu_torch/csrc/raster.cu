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
// rays add ~512 x 145 cell visits per robot, far below the FP32 roof.  K2
// returns a new grid, so it must also write every cell outside the window
// (the 833 x 1000 grid read and written: ~2.0 us in all).
//
// Design: one launch a call, no scratch in device memory, every count a
// shared-memory atomic of the block that holds it.  A thread-block cluster
// of C = 16 blocks owns one robot's window.  Rank r counts the samples of
// every ray whose driving coordinate is r modulo C: rows ly = r (mod C) of
// a y-driven ray (dy >= dx), columns lx = r (mod C) of an x-driven one.
// Along a ray the driving coordinate moves by one a sample, so these are
// the samples i = i0 + C m: each rank counts 1/C of every ray, whatever the
// rays' directions.  Its counts go to table Ty (its rows) or Tx (its
// columns), both counts of a cell packed in one uint32 (free in the low
// half, endpoint in the high half: a Bresenham line visits a cell once, so
// each count is at most N < 65536 and the tables' sums do not carry).  A
// block holds 1/C of a band's counts: a window whose tables fit no block's
// shared memory is taken in bands of rows (below), one band at the presets'
// window (384 x 384 at 1024 threads, see `smem_bytes`).  A rank counts at
// most kMaxPerRay samples of a ray an item; a ray of more than C kMaxPerRay
// samples gives an item every C kMaxPerRay samples more (`count`).
// Remote loads and atomics across the cluster were measured slow, and so
// were cluster barriers that order memory (a device-wide fence): data moves
// between the ranks by asynchronous stores and bulk copies (`st.async`,
// `cp.async.bulk`) that complete on the receiver's mbarrier.  In order:
//   - a warp walks each ray, 32 samples a chunk, the lookups of up to kWalk
//     chunks in flight together, a ballot finding the first blocked body
//     sample, and sends where the ray stops to every rank (st.async);
//   - meanwhile: zeroed tables, each ray's geometry; then, with every stop
//     in, the rank's rows of the scan-start window start to arrive (bulk
//     copies: the old values of the update);
//   - the rank's samples before each ray's stop (and the endpoint of a ray
//     nothing stopped) are counted: the rays sorted by kind and by their
//     number of samples here, so that the items (sample m of ray p) are all
//     real samples and a warp's lanes take the same m; the x-driven rays
//     first, so that Tx leaves for the row owners (bulk copies) while the
//     y-driven ones are counted; the decay^n table (powf(decay, n) for n <
//     kPowTable: a cell's update is a lookup) while Tx is on its way;
//   - each rank updates its rows ly = r (mod C): a cell's counts are its Ty
//     entry plus the received Tx entry.  For K4 (in place) a walker sends a
//     stop only after its lookups, so once a rank has every stop, every
//     scan-start read of its robot's window is done; the windows of
//     different robots lie in different grids.  A last cluster barrier
//     keeps every block running until the copies out of it have landed.
// Bands: where the tables of the whole window fit no block, the window's
// rows are taken in `bands` bands of C `rows` rows, in the same launch.  The
// walk runs once, in the first band, over every ray; each rank keeps the
// stops it received in `stops` (device memory, its own part) and reads them
// back in the later bands.  Each band counts only the samples whose row lies
// in it, sends its Tx, updates its rows and ends on a cluster barrier, so a
// band's copies never meet the next band's tables.  Every scan-start read of
// the window (the walk's) ends before the first band writes, as above; a
// band's staged rows are rows no earlier band wrote.  The kernel has two
// forms: the general one (`kWide`) and one for a single band whose items
// are single samples (K <= C kMaxPerRay), with the bands' loop and the
// items' later samples compiled out; the presets' windows take the second.
// A block has 1024 threads while a batch's clusters fit the card at once
// (the latency counts), 512 beyond (the throughput counts): then its shared
// memory is halved (the layout's `compact`), so that two blocks share a
// multiprocessor, one working while the other waits.
// Integer adds commute, so the bits depend on no order and on no layout.
// K2 writes every window cell (the update where the flag is set, else the
// old value); clusters past the B robots' copy every cell outside the
// windows, in 16-byte vectors where the row width allows, with no barrier.
// K4 writes only the window cells some ray touched, so a fleet step moves B
// windows, not B grids.  The accept flag and the window origin are read on
// the device.  The TPU kernels' one-hot MXU gathers and scatters, wedge
// boxes, roll placement and the (8, 128) alignment of the window origin are
// not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "nn_common.cuh"

namespace {

using slam_nn::cluster_addr;
using slam_nn::cluster_rank;
using slam_nn::smem_addr;

constexpr int kCluster = 16;  // blocks a robot's window: a smaller cluster takes more shared memory a block
constexpr int kLog2C = 4;
static_assert(kCluster == 1 << kLog2C, "kLog2C is log2(kCluster)");
constexpr int kRayGroup = 512;  // rays whose geometry and stops a block holds at a time (<= a block's threads)
constexpr int kPowTable = 512;  // decay^n for n below it (the robot's cell alone may reach N = 512)
constexpr int kWalk = 5;        // chunks of 32 samples whose lookups a walking warp issues together
constexpr int kMaxPerRay = 32;  // items of a ray a rank counts: sample m of an item, and m + kMaxPerRay j
constexpr int kCols = 3;        // window columns a lane updates at a time (3 x 32: a 384-wide row in 4)
constexpr int kCopyUnroll = 4;  // vectors a copying thread loads before it stores
constexpr int kMaxSmem = 232448;
constexpr int kNone = 0x7fffffff;  // "no blocked sample"

struct Args {
  const float* occ;  // (B, H, W)
  float* out;        // K2: (B, H, W), every cell written; K4: == occ
  const int* meta;   // (B, 4) [y0, x0, rly, rlx]: window origin in the grid, robot cell in the window
  const int* ey;     // (B, N) window-local endpoint cells
  const int* ex;
  const uint8_t* live;    // (B, N)
  const uint8_t* accept;  // (B,) or null for "always"
  int* stops;             // (B, kCluster, N): the stops each rank received, kept for the later bands; null for one band
  int B, H, W, N, side_y, side_x, K;
  float block_threshold, decay, inc;
  int bands;       // bands of kCluster x rows window rows
  int rows;        // window rows a rank owns in a band: ceil(ceil(side_y / kCluster) / bands)
  int cols;        // window columns a rank owns, rounded up to 4: the 16-byte rows of Tx
  int ty_pitch;    // words a row of Ty takes: side_x + 1 (rows 32 banks apart would share a bank)
  int rx_stride;   // words a rank's part of Rx takes: rows x cols, padded to 4 modulo 32 (the same)
  int pitch;       // floats a staged row takes: side_x + 6 rounded down to 4 (room for a 16-byte aligned copy)
  int per_ray;     // items of a ray a rank counts, at most: min(ceil(K / kCluster), kMaxPerRay)
  int bulk;        // staged rows come by bulk copies (16-byte aligned rows), else by 4-byte copies
  int copy_vec;    // K2's copy: cells a vector (4 or 1)
  int copy_chunk;  // K2's copy: vectors a copying block takes, a contiguous run
};

// Shared memory of a block, in this order: Ty (rows x ty_pitch, its rows),
// Tx (kCluster x rows x cols: its columns, by the rank that owns the row),
// Rx (the same from each rank, rx_stride apart: the column counts of its rows), the
// rank's rows of the scan-start window (rows x pitch), per ray of a group
// its stop, its geometry (two int4) and the same sorted by kind and by the
// rank's samples, the decay^n table, the rays by kind and samples (three
// arrays of 2 x (kMaxPerRay + 1)) and three mbarriers.  Compact: no staged
// rows, the geometry inside Rx's space (it is done with before Tx comes),
// the stops and the decay^n table in one space (one is done with before
// the other is made).
struct Layout {
  int ty, tx, rx, old, stop, geo, dir, sgeo, sdir, pow, hist, bars, total;
};
__host__ __device__ inline int rx_stride(int rows, int cols) { return rows * cols + ((4 - rows * cols) & 31); }
__host__ __device__ inline Layout layout(int rows, int cols, int side_x, int pitch, bool compact) {
  constexpr int C = kCluster;
  Layout l;
  l.ty = 0;
  l.tx = (rows * (side_x + 1) * 4 + 15) & ~15;
  l.rx = l.tx + C * rows * cols * 4;
  const int rx_bytes = C * rx_stride(rows, cols) * 4, geo_bytes = 4 * kRayGroup * 16;
  if (compact) {
    l.geo = l.rx;
    l.old = l.stop = l.pow = l.rx + (rx_bytes > geo_bytes ? rx_bytes : geo_bytes);
    l.hist = l.stop + (kPowTable > kRayGroup ? kPowTable : kRayGroup) * 4;
  } else {
    l.old = l.rx + rx_bytes;
    l.stop = l.old + rows * pitch * 4;
    l.geo = l.stop + kRayGroup * 4;
    l.pow = l.geo + geo_bytes;
    l.hist = l.pow + kPowTable * 4;
  }
  l.dir = l.geo + kRayGroup * 16;
  l.sgeo = l.dir + kRayGroup * 16;
  l.sdir = l.sgeo + kRayGroup * 16;
  l.bars = l.hist + ((3 * 2 * (kMaxPerRay + 1) * 4 + 15) & ~15);
  l.total = l.bars + 24;
  return l;
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
// this thread's arrival on the barrier's current phase, which then also
// waits for `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// A phase that never completes is a fault of this kernel: after 2^24 polls
// the launch fails rather than hold the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
}
// `bytes` (a multiple of 16) from device memory into this block's shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}
// `bytes` (a multiple of 16) from this block's shared memory at `src` into
// block `rank`'s at the offset of `dst`, completing on that block's barrier
// at the offset of `bar`
__device__ __forceinline__ void bulk_to_rank(uint32_t dst, uint32_t src, uint32_t bytes, uint32_t bar, int rank) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   cluster_addr(dst, rank)),
               "r"(src), "r"(bytes), "r"(cluster_addr(bar, rank))
               : "memory");
}
// a 4-byte store into block `rank`'s shared memory at the offset of `dst`,
// completing on that block's barrier at the offset of `bar`
__device__ __forceinline__ void st_to_rank(uint32_t dst, int v, uint32_t bar, int rank) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.s32 [%0], %1, [%2];\n" ::"r"(
                   cluster_addr(dst, rank)),
               "r"(v), "r"(cluster_addr(bar, rank))
               : "memory");
}
// a cluster barrier that orders no memory: every rank has reached it (the
// data moves on mbarriers)
__device__ __forceinline__ void cluster_meet() {
  slam_nn::cluster_arrive_relaxed();
  slam_nn::cluster_wait();
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
// shared-memory writes of this thread made visible to bulk copies
__device__ __forceinline__ void fence_to_bulk() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// A ray from the robot cell (rly, rlx) to its endpoint (the window-local
// cell (eyv, exv)); sample i lies at `cell(i)`, samples i in [0, last].
struct Ray {
  int dmaj, dmin, ell, last, sy, sx;
  bool x_driven;
  float rcp;  // 1 / (2 max(dmaj, 1)), rounded
  __device__ __forceinline__ Ray(int rly, int rlx, int eyv, int exv, int K, bool live) {
    const int dy = abs(eyv - rly), dx = abs(exv - rlx);
    sy = eyv >= rly ? 1 : -1;
    sx = exv >= rlx ? 1 : -1;
    ell = max(dx, dy);
    x_driven = dx > dy;
    dmaj = x_driven ? dx : dy;
    dmin = x_driven ? dy : dx;
    last = live ? min(ell, K - 1) : -1;
    rcp = __frcp_rn(static_cast<float>(2 * max(dmaj, 1)));
  }
  // as the group's geometry holds it: geo (dmaj, dmin, ell, last), dir
  // (0, sy < 0 | sx < 0 << 1 | x_driven << 2 | i0 << 8, rcp, 0)
  __device__ __forceinline__ Ray(int4 geo, int4 dir) {
    dmaj = geo.x;
    dmin = geo.y;
    ell = geo.z;
    last = geo.w;
    sy = dir.y & 1 ? -1 : 1;
    sx = dir.y & 2 ? -1 : 1;
    x_driven = dir.y & 4;
    rcp = __int_as_float(dir.z);
  }
  // minor-axis steps of sample i: max(0, ceil((2 i dmin - dmaj) / b)), b = 2 max(dmaj, 1):
  // a float estimate within one of the quotient, then corrected exactly
  __device__ __forceinline__ int steps(int i) const {
    const int t = 2 * i * dmin - dmaj;
    const int b = 2 * max(dmaj, 1);
    int e = __float2int_ru(__int2float_rn(t) * rcp);
    e += e * b < t ? 1 : 0;
    e -= (e - 1) * b >= t ? 1 : 0;
    return t > 0 ? e : 0;
  }
  __device__ __forceinline__ void cell(int i, int rly, int rlx, int& ly, int& lx) const {
    const int k = steps(i);
    lx = x_driven ? rlx + sx * i : rlx + sx * k;
    ly = x_driven ? rly + sy * k : rly + sy * i;
  }
};

__device__ __noinline__ float pow_n(float decay, uint32_t n) { return powf(decay, static_cast<float>(n)); }
__device__ __forceinline__ float updated(float p, uint32_t n, const float* pow_s, float decay, float inc) {
  const uint32_t nf = n & 0xffffu;
  p = p * (nf < kPowTable ? pow_s[nf] : pow_n(decay, nf));
  return fminf(1.0f, p + inc * static_cast<float>(n >> 16));
}

// K2's copying blocks: the cells of every robot's grid outside its window,
// block `blk` taking vectors [blk * copy_chunk, (blk + 1) * copy_chunk).
template <int V, int kThreads>
__device__ void copy_outside(const Args& a, int blk) {
  using T = typename std::conditional<V == 4, float4, float>::type;
  const uint32_t hw = static_cast<uint32_t>(a.H) * a.W;
  const uint32_t total = static_cast<uint32_t>(a.B) * hw / V;
  const uint32_t q0 = static_cast<uint32_t>(blk) * a.copy_chunk;
  const uint32_t q1 = min(q0 + a.copy_chunk, total);
  const T* src = reinterpret_cast<const T*>(a.occ);
  T* dst = reinterpret_cast<T*>(a.out);
  for (uint32_t base = q0 + threadIdx.x; base < q1; base += kCopyUnroll * kThreads) {
    T v[kCopyUnroll];
#pragma unroll
    for (int j = 0; j < kCopyUnroll; ++j) v[j] = src[min(base + j * kThreads, q1 - 1)];
#pragma unroll
    for (int j = 0; j < kCopyUnroll; ++j) {
      const uint32_t q = base + j * kThreads;
      if (q >= q1) break;
      const uint32_t cell = q * V;
      const uint32_t rb = cell / hw;
      const int y = static_cast<int>((cell - rb * hw) / a.W);
      const int x = static_cast<int>(cell - rb * hw - static_cast<uint32_t>(y) * a.W);
      const int wy = y - __ldg(a.meta + rb * 4), wx = x - __ldg(a.meta + rb * 4 + 1);
      const bool row_in = wy >= 0 && wy < a.side_y;
      if (!row_in || wx + V <= 0 || wx >= a.side_x) {
        dst[q] = v[j];  // the whole vector lies outside the window
      } else if (V == 4) {  // the vector meets the window's edge: the cells outside, one by one
        const float* f = reinterpret_cast<const float*>(&v[j]);
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (wx + e < 0 || wx + e >= a.side_x) a.out[cell + e] = f[e];
      }
    }
  }
}

// The counts of the rank's samples of one kind of ray in the band of rows
// [y0, y1) (y0 a multiple of C): the rays sorted by their number of items
// here, most first (`sgeo`, `sdir`), `off[m]` the first item m: items
// off[m] + p, p < (rays with more than m items), are item m of ray p, its
// samples m, m + kMaxPerRay, ... of the rank, up to its ray's last counted
// one.  The first is always a sample; without kWide it is the only one.
// A ray's items here, its samples from `d`'s first to `last`: at most S
// (without kWide, K <= C S and so is every ray's count).
template <bool kWide>
__device__ __forceinline__ int items_of(int last, int d, int S) {
  const int n = last >= d >> 8 ? ((last - (d >> 8)) >> kLog2C) + 1 : 0;
  return kWide ? min(n, S) : n;
}

template <int kThreads, bool kWide>
__device__ __forceinline__ void count(const Args& a, const int4* sgeo, const int4* sdir, const int* off, int rly,
                                      int rlx, int y0, int y1, uint32_t* ty, uint32_t* tx) {
  constexpr int C = kCluster, kLog2 = kLog2C;
  const int items = off[a.per_ray];
  int m = 0;
  for (int q = threadIdx.x; q < items; q += kThreads) {
    while (q >= off[m + 1]) ++m;
    const int p = q - off[m];
    const int4 d = sdir[p];
    const Ray ray(sgeo[p], d);
    int i = (d.y >> 8) + C * m;
    do {
      int ly, lx;
      ray.cell(i, rly, rlx, ly, lx);
      if (ly >= y0 && ly < y1 && lx >= 0 && lx < a.side_x) {
        // Ty (this rank's rows) for a y-driven ray, Tx (its columns) for an x-driven one
        ly -= y0;
        uint32_t* c = ray.x_driven ? tx + (((ly & (C - 1)) * a.rows + (ly >> kLog2)) * a.cols + (lx >> kLog2))
                                   : ty + (ly >> kLog2) * a.ty_pitch + lx;
        atomicAdd(c, i < ray.ell ? 1u : 1u << 16);  // i == ell: the endpoint of a ray nothing stopped
      }
      i += C * kMaxPerRay;
    } while (kWide && i <= ray.last);
  }
}

// kThreads 1024: one block a multiprocessor, the window's rows staged in
// shared memory, Tx sent while the y-driven rays are counted.  kThreads 512
// (COMPACT): half the shared memory, so two blocks share a multiprocessor;
// the rays' geometry lives in Rx until Tx arrives, the old values come from
// device memory.  kWide: the window in more than one band, or rays of
// more than C kMaxPerRay samples; without it, one band of one sample an
// item, the bands' loop and the items' later samples compiled out.
template <bool IN_PLACE, int kThreads, bool kWide>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads) raster_kernel(const Args a) {
  constexpr int C = kCluster, kLog2 = kLog2C;
  constexpr int kWarps = kThreads / 32;
  constexpr bool kCompact = kThreads < 1024;
  extern __shared__ __align__(128) unsigned char smem[];
  const int cl = blockIdx.x / C;
  if (!IN_PLACE && cl >= a.B) {  // K2's copying clusters
    const int blk = blockIdx.x - a.B * C;
    if (a.copy_vec == 4) copy_outside<4, kThreads>(a, blk);
    else copy_outside<1, kThreads>(a, blk);
    return;
  }
  const int rank = cluster_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t rb = cl;
  const int* ey = a.ey + rb * a.N;
  const int* ex = a.ex + rb * a.N;
  const uint8_t* live = a.live + rb * a.N;
  // the first group's rays, a thread a ray, loaded first: they are needed first
  const bool first_ray = threadIdx.x < min(a.N, kRayGroup);
  int ray_ey = first_ray ? ey[threadIdx.x] : 0, ray_ex = first_ray ? ex[threadIdx.x] : 0;
  bool ray_live = first_ray && live[threadIdx.x];
  const int y0 = __ldg(a.meta + rb * 4), x0 = __ldg(a.meta + rb * 4 + 1);
  const int rly = __ldg(a.meta + rb * 4 + 2), rlx = __ldg(a.meta + rb * 4 + 3);
  const int sx = a.side_x, rows = a.rows, cols = a.cols;
  const float* occ_win = a.occ + (rb * a.H + y0) * a.W + x0;
  float* out_win = a.out + (rb * a.H + y0) * a.W + x0;
  const int all_rows = (a.side_y - rank + C - 1) >> kLog2;  // this rank's rows: ly = rank + C t
  if (a.accept != nullptr && !a.accept[rb]) {  // uniform over the cluster: no barrier is reached
    if (!IN_PLACE)
      for (int t = warp; t < all_rows; t += kWarps) {
        const size_t g = static_cast<size_t>(rank + C * t) * a.W;
        for (int lx = lane; lx < sx; lx += 32) out_win[g + lx] = occ_win[g + lx];
      }
    return;
  }
  const Layout L = layout(rows, cols, sx, a.pitch, kCompact);
  uint32_t* ty = reinterpret_cast<uint32_t*>(smem + L.ty);
  uint32_t* tx = reinterpret_cast<uint32_t*>(smem + L.tx);
  const uint32_t* rx = reinterpret_cast<const uint32_t*>(smem + L.rx);
  float* old = reinterpret_cast<float*>(smem + L.old);
  int* stop = reinterpret_cast<int*>(smem + L.stop);
  int4* geo = reinterpret_cast<int4*>(smem + L.geo);
  int4* dir = reinterpret_cast<int4*>(smem + L.dir);
  float* pow_s = reinterpret_cast<float*>(smem + L.pow);
  int4* sgeo = reinterpret_cast<int4*>(smem + L.sgeo);
  int4* sdir = reinterpret_cast<int4*>(smem + L.sdir);
  // rays by kind (x-driven, y-driven) and items here; then with more than m items; then items before m
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  int* gt = hist + 2 * (kMaxPerRay + 1);
  int* off = gt + 2 * (kMaxPerRay + 1);
  int* kept = !kWide || a.stops == nullptr ? nullptr : a.stops + (rb * C + rank) * a.N;  // this rank's stops, bands > 1
  const uint32_t bar_old = smem_addr(smem + L.bars), bar_tx = bar_old + 8, bar_stop = bar_old + 16;

  // the barriers
  const int shift = a.bulk ? (x0 & 3) : 0;  // a staged row starts at the 16-byte boundary at or before x0
  const uint32_t row_bytes = ((shift + sx + 3) & ~3) * 4;  // a staged row by bulk copy
  if (threadIdx.x == 0) {
    mbar_init(bar_old);
    mbar_init(bar_tx);
    mbar_init(bar_stop);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar_tx, C * rows * cols * 4);  // C chunks of rows x cols counts
    if (!kCompact && a.bulk) mbar_expect(bar_old, row_bytes * min(rows, all_rows));
  }
  slam_nn::cluster_arrive_relaxed();  // waited for before the first store into another block
  const float thr = a.block_threshold;
  const int bands = kWide ? a.bands : 1;
  for (int band = 0; band < bands; ++band) {
    // this rank's rows of the band: ly = rank + C (t0 + t), t < my_rows; the band's rows [band_y0, band_y1)
    const int t0 = band * rows, my_rows = max(0, min(rows, all_rows - t0));
    const int band_y0 = C * t0, band_y1 = kWide ? min(band_y0 + C * rows, a.side_y) : a.side_y;
    const float* occ_band = occ_win + static_cast<size_t>(rank + C * t0) * a.W;
    float* out_band = out_win + static_cast<size_t>(rank + C * t0) * a.W;
    if (!kCompact && !a.bulk) {
      for (int t = warp; t < my_rows; t += kWarps)
        for (int lx = lane; lx < sx; lx += 32)
          cp_async4(smem_addr(old + t * a.pitch + lx), occ_band + static_cast<size_t>(C * t) * a.W + lx);
    }
    if (!kCompact && a.bulk && band > 0 && lane == 0)  // the barrier armed at the last band's end
      for (int t = warp; t < my_rows; t += kWarps)
        bulk_load(smem_addr(old + t * a.pitch), occ_band + static_cast<size_t>(C * t) * a.W - shift, row_bytes,
                  bar_old);
    for (int g0 = 0, group = 0; g0 < a.N; g0 += kRayGroup, ++group) {
      const int gn = min(kRayGroup, a.N - g0);
      const bool last_group = g0 + kRayGroup >= a.N;
      if (band == 0 && threadIdx.x == 0) mbar_expect(bar_stop, gn * 4);  // a stop a ray, from its walker
      if (threadIdx.x < 2 * (kMaxPerRay + 1)) hist[threadIdx.x] = 0;

      // a warp walks each ray to its first blocked body sample, and tells every rank
      if (band == 0 && g0 == 0) slam_nn::cluster_wait();  // every rank running, its barriers ready
      for (int j = rank * kWarps + warp; band == 0 && j < gn; j += C * kWarps) {
        const Ray ray(rly, rlx, ey[g0 + j], ex[g0 + j], a.K, live[g0 + j]);
        int s = kNone;
        for (int base = 0; base <= ray.last && s == kNone; base += 32 * kWalk) {
          const int chunks = min(kWalk, (ray.last - base) / 32 + 1);  // the chunks with samples
          float p[kWalk];
          bool body[kWalk];
#pragma unroll
          for (int u = 0; u < kWalk; ++u) {
            if (u < chunks) {
              const int i = base + 32 * u + lane;
              int ly, lx;
              ray.cell(i, rly, rlx, ly, lx);
              body[u] = i <= ray.last && i < ray.ell && ly >= 0 && ly < a.side_y && lx >= 0 && lx < sx;
              // every lane loads, at a clamped address, and the value is masked by `body`
              p[u] = __ldg(occ_win + min(max(ly, 0), a.side_y - 1) * a.W + min(max(lx, 0), sx - 1));
            }
          }
#pragma unroll
          for (int u = 0; u < kWalk; ++u) {
            if (u < chunks) {
              const unsigned blocked = __ballot_sync(0xffffffffu, body[u] && p[u] >= thr);
              if (blocked && s == kNone) s = base + 32 * u + __ffs(blocked) - 1;
            }
          }
        }
        if (lane < C) st_to_rank(smem_addr(stop + j), s, bar_stop, lane);
      }

      // while the stops come: zeroed tables; each ray's geometry (kThreads >= kRayGroup)
      if (g0 == 0) {
        uint4* z = reinterpret_cast<uint4*>(smem + L.ty);  // Ty and Tx are adjacent, 16-byte aligned
        const int n4 = (L.rx - L.ty) / 16;
        for (int c = threadIdx.x; c < n4; c += kThreads) z[c] = make_uint4(0, 0, 0, 0);
      }
      if (threadIdx.x < gn) {
        if (g0 > 0 || band > 0) {
          ray_ey = ey[g0 + threadIdx.x];
          ray_ex = ex[g0 + threadIdx.x];
          ray_live = live[g0 + threadIdx.x];
        }
        const Ray ray(rly, rlx, ray_ey, ray_ex, a.K, ray_live);
        // the rank's samples: those whose driving coordinate is rank modulo C
        const int i0 = (ray.x_driven ? (rank - rlx) * ray.sx : (rank - rly) * ray.sy) & (C - 1);
        geo[threadIdx.x] = make_int4(ray.dmaj, ray.dmin, ray.ell, ray.last);
        dir[threadIdx.x] = make_int4(0, (ray.sy < 0) | (ray.sx < 0) << 1 | ray.x_driven << 2 | i0 << 8,
                                     __float_as_int(ray.rcp), 0);
      }
      // every stop of the group here; every walker's lookups, done before it
      // sent its stop, read the scan-start window (K4 writes it in phase 4)
      if (band == 0) mbar_wait(bar_stop, group & 1);
      __syncthreads();
      if (!kCompact && a.bulk && band == 0 && g0 == 0 && lane == 0)  // the barrier ready: a warp a staged row
        for (int t = warp; t < my_rows; t += kWarps)
          bulk_load(smem_addr(old + t * a.pitch), occ_band + static_cast<size_t>(C * t) * a.W - shift, row_bytes,
                    bar_old);

      // the counts of each of the rank's samples before its ray's stop, the
      // x-driven rays' first, so that Tx leaves while the rest are counted.
      // Each ray's last counted sample, and its items here: n
      const int S = a.per_ray;
      for (int j = threadIdx.x; j < gn; j += kThreads) {
        int s;
        if (band == 0) {
          s = stop[j];
          if (kept != nullptr) kept[g0 + j] = s;  // read back by this thread in the later bands
        } else {
          s = kept[g0 + j];
        }
        const int last = s == kNone ? geo[j].w : min(geo[j].w, s - 1), d = dir[j].y;
        geo[j].w = last;
        atomicAdd(hist + (d & 4 ? 0 : kMaxPerRay + 1) + items_of<kWide>(last, d, S), 1);
      }
      __syncthreads();
      if (warp < 2) {  // warp 0 the x-driven rays, warp 1 the others; lane l stands for m = l (S <= 32)
        const int* h = hist + warp * (kMaxPerRay + 1);
        int more = lane < S ? h[lane + 1] : 0;  // rays with more than m items: a suffix sum
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_down_sync(0xffffffffu, more, d);
          more += lane + d < 32 ? v : 0;
        }
        int before = more;  // items before item m: a prefix sum of `more`
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, before, d);
          before += lane >= d ? v : 0;
        }
        gt[warp * (kMaxPerRay + 1) + lane] = lane < S ? more : 0;
        off[warp * (kMaxPerRay + 1) + lane] = before - more;
        if (lane == 31) off[warp * (kMaxPerRay + 1) + S] = before;
      }
      __syncthreads();
      const int nx = gt[0];  // the x-driven rays with a sample here come first
      for (int j = threadIdx.x; j < gn; j += kThreads) {  // the rays sorted by items here, most first
        const int last = geo[j].w, d = dir[j].y, kind = d & 4 ? 0 : 1;
        const int n = items_of<kWide>(last, d, S);
        if (n > 0) {
          const int pos = (kind ? nx : 0) + (n < S ? gt[kind * (kMaxPerRay + 1) + n] : 0) +
                          atomicSub(hist + kind * (kMaxPerRay + 1) + n, 1) - 1;
          sgeo[pos] = geo[j];
          sdir[pos] = dir[j];
        }
      }
      __syncthreads();
      count<kThreads, kWide>(a, sgeo, sdir, off, rly, rlx, band_y0, band_y1, ty, tx);
      if (!kCompact && last_group) {  // every rank its part of Tx: the column counts in its rows
        fence_to_bulk();
        __syncthreads();
        if (warp < C && lane == 0)  // a warp a receiving rank
          bulk_to_rank(smem_addr(rx + rank * a.rx_stride), smem_addr(tx + warp * rows * cols), rows * cols * 4,
                       bar_tx, warp);
      }
      count<kThreads, kWide>(a, sgeo + nx, sdir + nx, off + kMaxPerRay + 1, rly, rlx, band_y0, band_y1, ty, tx);
      if (!last_group) {
        __syncthreads();  // the group's geometry free for the next
        if (band == 0) cluster_meet();  // every rank done with the stops before the next group's arrive
      }
    }
    if (kCompact && a.N > 0) {  // every rank its part of Tx, once every rank is done with the geometry in Rx
      fence_to_bulk();
      __syncthreads();
      cluster_meet();
      if (warp < C && lane == 0)
        bulk_to_rank(smem_addr(rx + rank * a.rx_stride), smem_addr(tx + warp * rows * cols), rows * cols * 4, bar_tx,
                     warp);
    }
    if (a.N == 0) {  // no group: the rows staged and Tx (all zero) sent all the same
      if (band == 0) slam_nn::cluster_wait();  // every rank running, its barriers ready
      uint4* z = reinterpret_cast<uint4*>(smem + L.ty);
      for (int c = threadIdx.x; c < (L.rx - L.ty) / 16; c += kThreads) z[c] = make_uint4(0, 0, 0, 0);
      fence_to_bulk();
      __syncthreads();
      if (!kCompact && a.bulk && band == 0 && lane == 0)
        for (int t = warp; t < my_rows; t += kWarps)
          bulk_load(smem_addr(old + t * a.pitch), occ_band + static_cast<size_t>(C * t) * a.W - shift, row_bytes,
                    bar_old);
      if (warp < C && lane == 0)
        bulk_to_rank(smem_addr(rx + rank * a.rx_stride), smem_addr(tx + warp * rows * cols), rows * cols * 4, bar_tx,
                     warp);
    }
    // the decay^n table while Tx is on its way (kept for the later bands: nothing else writes its space then)
    if (band == 0)
      for (int n = threadIdx.x; n < kPowTable; n += kThreads) pow_s[n] = powf(a.decay, static_cast<float>(n));
    if (!kCompact && a.bulk) mbar_wait(bar_old, band & 1);
    if (!kCompact && !a.bulk) asm volatile("cp.async.wait_all;\n" ::: "memory");
    mbar_wait(bar_tx, band & 1);
    __syncthreads();  // every count, staged cell and table entry in place

    // the update of this rank's rows: Ty plus the Tx entries from the column's owner; a warp
    // takes 32 kCols columns of a row at a time.  Column lx = lane + 32 v: its Tx owner is
    // lane mod C, its entry there (lx >> log2 C) = (lane >> log2 C) + (32 v >> log2 C)
    const float decay = a.decay, inc = a.inc;
    const int seg = 32 * kCols, segs = (sx + seg - 1) / seg;
    const uint32_t* rx_lane = rx + (lane & (C - 1)) * a.rx_stride + (lane >> kLog2);
    // (row, segment) of unit w + kWarps k, stepped without a division
    const int dt = kWarps / segs, ds = kWarps - dt * segs;
    for (int t = warp / segs, sg = warp % segs; t < my_rows;) {
      const int lx0 = sg * seg;
      const uint32_t* tyr = ty + t * a.ty_pitch + lx0 + lane;
      const uint32_t* rxr = rx_lane + t * cols + (lx0 >> kLog2);
      float* outr = out_band + static_cast<size_t>(C * t) * a.W + lx0 + lane;
      // the old values: staged, or (compact) the grid's own, read before this block writes the row
      const float* oldr = kCompact ? (IN_PLACE ? outr : occ_band + static_cast<size_t>(C * t) * a.W + lx0 + lane)
                                   : old + t * a.pitch + shift + lx0 + lane;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        if (lx0 + lane + 32 * u < sx) {
          const uint32_t n = tyr[32 * u] + rxr[(32 * u) >> kLog2];
          if (!IN_PLACE || n != 0) outr[32 * u] = updated(oldr[32 * u], n, pow_s, decay, inc);
        }
      }
      t += dt;
      sg += ds;
      if (sg >= segs) {
        sg -= segs;
        ++t;
      }
    }
    if (band + 1 < bands && threadIdx.x == 0) {  // the next band's phases, armed before any copy can come
      mbar_expect(bar_tx, C * rows * cols * 4);
      if (!kCompact && a.bulk) mbar_expect(bar_old, row_bytes * max(0, min(rows, all_rows - t0 - rows)));
    }
    cluster_meet();  // every bulk copy out of this block has landed
  }
}

// Window rows a rank owns in each of `bands` bands.
int band_rows(int side_y, int bands) {
  const int rows = (side_y + kCluster - 1) / kCluster;
  return (rows + bands - 1) / bands;
}

// Shared memory a block of `threads` takes at these sizes, in `bands` bands.
int smem_bytes(int side_y, int side_x, int threads, int bands) {
  const int cols = ((side_x + kCluster - 1) / kCluster + 3) & ~3;
  return layout(band_rows(side_y, bands), cols, side_x, (side_x + 6) & ~3, threads < 1024).total;
}

// The launch configuration of `blocks` blocks (a multiple of kCluster) of
// the kernel's threads, its attributes set at its first use.
template <bool IN_PLACE, int kThreads, bool kWide>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* cluster, int blocks, int smem) {
  static const cudaError_t attr = [] {
    auto kern = raster_kernel<IN_PLACE, kThreads, kWide>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    return e != cudaSuccess ? e : cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kCluster;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return attr;
}

template <bool IN_PLACE, int kThreads, bool kWide>
cudaError_t launch_t(const Args& a, int copy_clusters, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster[1];
  const int smem = layout(a.rows, a.cols, a.side_x, a.pitch, kThreads < 1024).total;
  cudaError_t err = configure<IN_PLACE, kThreads, kWide>(cfg, cluster, (a.B + copy_clusters) * kCluster, smem);
  if (err != cudaSuccess) return err;
  cfg.stream = s;
  err = cudaLaunchKernelEx(&cfg, raster_kernel<IN_PLACE, kThreads, kWide>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Whether the kernel needs its general form: more than one band, or rays of
// more than kCluster kMaxPerRay samples.
bool wide(int bands, int K) { return bands > 1 || K > kCluster * kMaxPerRay; }

template <bool IN_PLACE>
cudaError_t launch(const Args& a, int threads, int copy_clusters, cudaStream_t s) {
  if (wide(a.bands, a.K))
    return threads == 512 ? launch_t<IN_PLACE, 512, true>(a, copy_clusters, s)
                          : launch_t<IN_PLACE, 1024, true>(a, copy_clusters, s);
  return threads == 512 ? launch_t<IN_PLACE, 512, false>(a, copy_clusters, s)
                        : launch_t<IN_PLACE, 1024, false>(a, copy_clusters, s);
}

// Fill the layout and check it; 0 or a CUDA error code.
int prepare(Args& a, int threads, int bands, int copy_clusters, int copy_vec) {
  if ((threads != 512 && threads != 1024) || a.N >= 65536 || a.K <= 0 || a.side_y <= 0 || a.side_x <= 0 ||
      a.side_y > a.H || a.side_x > a.W || bands <= 0 || smem_bytes(a.side_y, a.side_x, threads, bands) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  a.rows = band_rows(a.side_y, bands);
  a.bands = ((a.side_y + kCluster - 1) / kCluster + a.rows - 1) / a.rows;  // no band without rows
  if ((a.bands > 1) != (a.stops != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  a.cols = ((a.side_x + kCluster - 1) / kCluster + 3) & ~3;
  a.pitch = (a.side_x + 6) & ~3;
  a.ty_pitch = a.side_x + 1;
  a.rx_stride = rx_stride(a.rows, a.cols);
  a.per_ray = min((a.K + kCluster - 1) / kCluster, kMaxPerRay);
  a.bulk = a.W % 4 == 0 && reinterpret_cast<uintptr_t>(a.occ) % 16 == 0;
  a.copy_vec = copy_vec;
  a.copy_chunk = 0;
  if (copy_clusters > 0) {
    const long long cells = static_cast<long long>(a.B) * a.H * a.W;
    if ((copy_vec != 1 && copy_vec != 4) || a.W % copy_vec != 0 || cells >= (1ll << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = static_cast<long long>(copy_clusters) * kCluster;
    a.copy_chunk = static_cast<int>((cells / copy_vec + blocks - 1) / blocks);
  }
  return 0;
}

}  // namespace

// The clusters of 16 blocks of `threads` (512 or 1024) the card holds at
// once at this window in `bands` bands (cudaOccupancyMaxActiveClusters), or
// minus a CUDA error code.
extern "C" int slam_raster_max_clusters(int side_y, int side_x, int threads, int bands) {
  if ((threads != 512 && threads != 1024) || bands <= 0 || smem_bytes(side_y, side_x, threads, bands) > kMaxSmem)
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster[1];
  const int smem = smem_bytes(side_y, side_x, threads, bands);
  int n = 0;
  // both forms of the kernel have the same launch bounds: the one-band form stands for both
  cudaError_t err = threads == 512 ? configure<true, 512, false>(cfg, cluster, kCluster, smem)
                                   : configure<true, 1024, false>(cfg, cluster, kCluster, smem);
  if (err == cudaSuccess)
    err = threads == 512 ? cudaOccupancyMaxActiveClusters(&n, raster_kernel<true, 512, false>, &cfg)
                         : cudaOccupancyMaxActiveClusters(&n, raster_kernel<true, 1024, false>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Shared memory a block of `threads` (512 or 1024) takes in `bands` bands
// (`raster_fused.smem_bytes` computes the same).
extern "C" int slam_raster_smem_bytes(int side_y, int side_x, int threads, int bands) {
  return bands > 0 ? smem_bytes(side_y, side_x, threads, bands) : -static_cast<int>(cudaErrorInvalidValue);
}

// K2.  accept: (B,) device bools, or null for "always"; a robot's window is
// updated only where its flag is set.  Writes every cell of `out`: the
// robots' clusters their windows, `copy_clusters` more clusters the rest.
// Layout (`threads` 512 or 1024 a block; `bands`; `copy_clusters`;
// `copy_vec` 4 or 1): `raster_fused.raster_plan`.  stops: (B, 16, N) int32
// of device memory where the window takes more than one band, else null.
extern "C" int slam_raster_update(const void* occ, void* out, int B, int H, int W, const void* meta,
                                  const void* ey, const void* ex, const void* live, const void* accept, void* stops,
                                  int N, int side_y, int side_x, int K, float block_threshold, float decay, float inc,
                                  int threads, int bands, int copy_clusters, int copy_vec, void* stream) {
  if (B <= 0) return 0;
  if (copy_clusters <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a = {static_cast<const float*>(occ), static_cast<float*>(out), static_cast<const int*>(meta),
            static_cast<const int*>(ey), static_cast<const int*>(ex), static_cast<const uint8_t*>(live),
            static_cast<const uint8_t*>(accept), static_cast<int*>(stops), B, H, W, N, side_y, side_x, K,
            block_threshold, decay, inc};
  const int e = prepare(a, threads, bands, copy_clusters, copy_vec);
  if (e != 0) return e;
  return static_cast<int>(launch<false>(a, threads, copy_clusters, static_cast<cudaStream_t>(stream)));
}

// K4.  As K2, but `occ` (B, H, W) is updated in place and only window cells
// that some ray touched are written.
extern "C" int slam_raster_update_grid(void* occ, int B, int H, int W, const void* meta, const void* ey,
                                       const void* ex, const void* live, const void* accept, void* stops, int N,
                                       int side_y, int side_x, int K, float block_threshold, float decay, float inc,
                                       int threads, int bands, void* stream) {
  if (B <= 0 || N <= 0) return 0;  // no ray: no cell changes
  Args a = {static_cast<const float*>(occ), static_cast<float*>(occ), static_cast<const int*>(meta),
            static_cast<const int*>(ey), static_cast<const int*>(ex), static_cast<const uint8_t*>(live),
            static_cast<const uint8_t*>(accept), static_cast<int*>(stops), B, H, W, N, side_y, side_x, K,
            block_threshold, decay, inc};
  const int e = prepare(a, threads, bands, 0, 1);
  if (e != 0) return e;
  return static_cast<int>(launch<true>(a, threads, 0, static_cast<cudaStream_t>(stream)));
}
