// K1: the candidate pool of the grid top-K selection, every map of one
// selection call in two launches (coarse cells, then fine cells and pads).
//
// Replaces the XLA ops of orbslam3_tpu/ops/select.py::_candidate_pool
// (:36-101; its grid_maxima is a packed reduce_window per map), which the
// port ran as ~40 torch ops per map (ops/select.py, `candidate_pools_plain`).
// For map l (an int32 score map of h x w, row pitch `stride`) with coarse
// cell c (select.cell_size_for) and fine cell f = max(c // 2, 1), row l of
// the (L, P) outputs holds, in order:
//   - the gy * gx coarse cells of the map zero-padded to (gy c, gx c), in
//     raster order: the cell's maximum of packed = score * cc + (cc - 1 -
//     local) (cc = c * c, local the within-cell flat index), so the highest
//     score wins and, among equal scores, the smallest within-cell index;
//     resp = packed // cc and (ys, xs) the winner pixel;
//   - the fy * fx fine cells of that map with each coarse winner pixel set
//     to 0, zero-padded to (fy f, fx f), in raster order, the same packed
//     maximum at cell f.  A pixel is its coarse cell's winner iff its packed
//     value equals the cell's maximum (packed values are distinct within a
//     cell), and the first launch wrote each winner's (ys, xs): the second
//     compares a pixel with the winner of its own coarse cell, so fine cells
//     that straddle coarse cells (odd c) are right;
//   - pads to P: key -1, resp = ys = xs = 0 (the k zero entries of the pool
//     and the stack's fill to the longest pool alike).
// key = resp > 0 ? is_winner * 1e6 + (float)resp : -1 (f32, one rounded add).
//
// Bound on the H100: the maps are read twice (a stereo frame's 16 maps are
// 1.89 M int32 pixels, 7.6 MB, mostly L2-resident after detection) and 16
// x 1297 pool entries of 16 bytes written: its least time is those bytes'
// 2.4 us at HBM rate (it takes ~9x that, two launches included).  Design:
// one warp per cell, its lanes strided over the cell's pixels in raster
// order (one division by c per pixel, the loop unrolled so that several
// loads are in flight), a warp max (__reduce_max_sync) and one lane
// writing the entry; grid.y is the map, so up to kMaxMaps maps take two
// launches.  The fine pass reads the winner of a pixel's coarse cell only
// where the pixel's score is not 0 (the suppressed value is 0 anyway), so
// sparse NMS'd maps (5 % of pixels on a frame) read few.  Lanes on the
// cell's columns with no division (level 0's 40-wide coarse cell then
// takes 80 steps a lane, not 50) made a stereo frame's call 0.0349 ms
// against 0.0216-0.0219 (NVIDIA H100 80GB HBM3 at 700 W,
// tools/bench_match_kernels.py): the steps, not the divisions, set its time.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxMaps = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Map {
  const int32_t* score;
  int h, w, stride;  // rows, columns, row pitch in elements
  int cell, fine;
  int gx, n_coarse;  // coarse grid columns, coarse cells
  int fx, n_fine;    // fine grid columns, fine cells
};

struct Maps {
  Map map[kMaxMaps];
  float* key;
  int32_t* resp;
  int32_t* ys;
  int32_t* xs;
  int pool;  // P, the length of a row
};

// floor(a / b) for b > 0, as Python's // (a packed value may be negative
// only for a negative score)
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b < 0) ? q - 1 : q;
}

__device__ __forceinline__ int pixel(const Map& m, int y, int x) {
  return (y < m.h && x < m.w) ? m.score[static_cast<long long>(y) * m.stride + x] : 0;
}

// writes entry e of map l from the packed maximum of cell `ci` of a grid
// `cols` cells wide at cell size c
__device__ __forceinline__ void write_entry(const Maps& ms, int l, int e, int pmax, int c,
                                            int ci, int cols, bool winner) {
  const int cc = c * c;
  const int v = floor_div(pmax, cc);
  const int lwin = (cc - 1) - (pmax - v * cc);
  const int cy = ci / cols, cx = ci - cy * cols;
  const long long o = static_cast<long long>(l) * ms.pool + e;
  ms.resp[o] = v;
  ms.ys[o] = cy * c + lwin / c;
  ms.xs[o] = cx * c + lwin % c;
  ms.key[o] = v > 0 ? __fadd_rn(winner ? 1e6f : 0.0f, __int2float_rn(v)) : -1.0f;
}

__global__ void __launch_bounds__(kThreads)
    grid_pool_coarse_kernel(const __grid_constant__ Maps ms) {
  const int l = blockIdx.y;
  const Map& m = ms.map[l];
  const int e = blockIdx.x * kWarps + threadIdx.x / 32;
  if (e >= m.n_coarse) return;
  const int lane = threadIdx.x & 31;
  const int c = m.cell, cc = c * c;
  const int y0 = (e / m.gx) * c, x0 = (e % m.gx) * c;
  int best = INT_MIN;
#pragma unroll 8
  for (int i = lane; i < cc; i += 32) {
    const int r = i / c;
    best = max(best, pixel(m, y0 + r, x0 + i - r * c) * cc + (cc - 1 - i));
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if (lane == 0) write_entry(ms, l, e, best, c, e, m.gx, true);
}

__global__ void __launch_bounds__(kThreads)
    grid_pool_fine_kernel(const __grid_constant__ Maps ms) {
  const int l = blockIdx.y;
  const Map& m = ms.map[l];
  const int e = m.n_coarse + blockIdx.x * kWarps + threadIdx.x / 32;
  if (e >= ms.pool) return;
  const int lane = threadIdx.x & 31;
  const int f = e - m.n_coarse;
  if (f >= m.n_fine) {  // a pad
    if (lane == 0) {
      const long long o = static_cast<long long>(l) * ms.pool + e;
      ms.key[o] = -1.0f;
      ms.resp[o] = ms.ys[o] = ms.xs[o] = 0;
    }
    return;
  }
  const int c = m.fine, cc = c * c, cell = m.cell;
  const int y0 = (f / m.fx) * c, x0 = (f % m.fx) * c;
  const long long row = static_cast<long long>(l) * ms.pool;
  int best = INT_MIN;
#pragma unroll 4
  for (int i = lane; i < cc; i += 32) {
    const int r = i / c;
    const int y = y0 + r, x = x0 + i - r * c;
    int v = pixel(m, y, x);
    if (v != 0) {  // inside the map, so inside the coarse grid: suppress its winner
      const long long wo = row + (y / cell) * m.gx + x / cell;
      if (ms.ys[wo] == y && ms.xs[wo] == x) v = 0;
    }
    best = max(best, v * cc + (cc - 1 - i));
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if (lane == 0) write_entry(ms, l, e, best, c, f, m.fx, false);
}

}  // namespace

// maps: n_maps records of 6 int64 each, (score, h, w, stride, cell, fine):
// score an int32 map with rows `stride` elements apart, h, w >= 1, cell and
// fine >= 1.  key (f32), resp, ys, xs (int32): (n_maps, pool) each, pool at
// least the longest map's coarse + fine cells.  Requires 1 <= n_maps <= 32.
// Two launches on `stream`; returns cudaGetLastError() after them.
extern "C" int grid_pool(const long long* params, int n_maps, void* key, void* resp, void* ys,
                         void* xs, int pool, void* stream) {
  if (n_maps < 1 || n_maps > kMaxMaps || pool < 1) return static_cast<int>(cudaErrorInvalidValue);
  Maps ms{};
  ms.key = static_cast<float*>(key);
  ms.resp = static_cast<int32_t*>(resp);
  ms.ys = static_cast<int32_t*>(ys);
  ms.xs = static_cast<int32_t*>(xs);
  ms.pool = pool;
  int coarse_blocks = 1, fine_blocks = 1;
  for (int l = 0; l < n_maps; ++l) {
    const long long* p = params + 6 * l;
    Map& m = ms.map[l];
    m.score = reinterpret_cast<const int32_t*>(p[0]);
    m.h = static_cast<int>(p[1]);
    m.w = static_cast<int>(p[2]);
    m.stride = static_cast<int>(p[3]);
    m.cell = static_cast<int>(p[4]);
    m.fine = static_cast<int>(p[5]);
    if (m.h < 1 || m.w < 1 || m.cell < 1 || m.fine < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int gy = (m.h + m.cell - 1) / m.cell;
    m.gx = (m.w + m.cell - 1) / m.cell;
    m.n_coarse = gy * m.gx;
    const int fy = (gy * m.cell + m.fine - 1) / m.fine;
    m.fx = (m.gx * m.cell + m.fine - 1) / m.fine;
    m.n_fine = fy * m.fx;
    if (m.n_coarse + m.n_fine > pool) return static_cast<int>(cudaErrorInvalidValue);
    coarse_blocks = std::max(coarse_blocks, (m.n_coarse + kWarps - 1) / kWarps);
    fine_blocks = std::max(fine_blocks, (pool - m.n_coarse + kWarps - 1) / kWarps);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  grid_pool_coarse_kernel<<<dim3(coarse_blocks, n_maps), kThreads, 0, s>>>(ms);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grid_pool_fine_kernel<<<dim3(fine_blocks, n_maps), kThreads, 0, s>>>(ms);
  return static_cast<int>(cudaGetLastError());
}
