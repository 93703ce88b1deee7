// B3: fused FAST detection -- masked score, per-tile two-threshold retry and
// strict 3x3 NMS over one u8 detection composite.
//
// Replaces orbslam3_tpu/ops/fast.py::_detect_fused_pallas.  Input: a (h, w)
// u8 composite with h and w multiples of 32 and a (h, w) u8 interior mask
// (every 1 at least 3 px inside).  raw = mask ? score : 0 with the score of
// fast_score.cuh; hi = raw >= ini_th ? raw : 0, lo = raw >= min_th ? raw : 0;
// a 32x32 tile keeps hi if any of its hi is > 0, else lo; then a pixel is
// kept iff it is > 0 and > all 8 neighbours (zero outside the composite).
// Exact for every ini_th and min_th: raw lies in [-128, 254], so the
// selected map, negative scores kept by min_th <= 0 included, fits int16.
//
// The hard part is the NMS halo: a pixel on a tile border compares against
// neighbours that took THEIR tile's retry choice.  The TPU kernel carries
// that across its sequential grid with a one-strip lag; blocks on the card
// run in no order, so the kernel makes two launches on one stream:
//   1. one 256-thread block per 32x32 tile stages the 38x40 halo in shared
//      memory as u16, scores its 1024 pixels with the packed core (4
//      horizontally adjacent pixels per thread), reduces "any hi > 0" over
//      the block with __syncthreads_or (no atomics) and writes the tile's
//      selected map into a (h, w) int16 scratch, 4 pixels per 8-byte store;
//   2. one 256-thread block per 32x32 tile reads the selected map 4 pixels
//      per 8-byte load (three rows, the group and its two neighbours, from
//      L1), and writes the NMS'd map 4 int32 per 16-byte store.
// Bound on the H100: pass 1 is the B1 score (at least 118 two-input ops/px
// in 16-bit lanes, utils/device_time.FAST_SCORE_OPS_PER_PX) plus the
// thresholds, the tile's choice and the NMS; the bytes are 1 B image, 1 B
// mask and 4 B output per pixel.  The scratch round trip (2 B written, ~2 B
// read back) is what the TPU kernel avoided; at these sizes it stays in the
// 50 MB L2.

#include <cstdint>
#include <cuda_runtime.h>

#include "fast_score.cuh"

namespace {

constexpr int kTile = 32;                     // retry tile (TILE of ops/fast.py)
constexpr int kThreads = 256;
constexpr int kGroups = kTile / 4;            // 4-pixel groups in a tile row
constexpr int kHaloRows = kTile + 2 * kRingR;
constexpr int kHaloWords = (kTile + 2 * kHaloLeft) / 4;
// u16 per halo row: 48 rather than 40, so the two rows of a half-warp's
// 64-bit loads fall on disjoint banks
constexpr int kPitch = 48;
static_assert(kPitch >= 4 * kHaloWords, "halo row does not fit its pitch");

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
detect_select_kernel(const uint8_t* __restrict__ img, const uint8_t* __restrict__ mask,
                     int16_t* __restrict__ sel, int h, int w, int ini_th, int min_th) {
  __shared__ __align__(16) uint16_t tile[kHaloRows * kPitch];
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  stage_halo_u16<kHaloRows, kHaloWords, kThreads, VEC>(img, h, w, y0 - kRingR, x0 - kHaloLeft,
                                                       tile, kPitch);
  __syncthreads();

  const int lx = 4 * (threadIdx.x % kGroups);
  const int ly = threadIdx.x / kGroups;
  uint32_t s01, s23;
  biased_scores4(tile, kPitch, ly, lx, s01, s23);
  const size_t at = size_t(y0 + ly) * w + x0 + lx;
  uint32_t m;
  if (VEC) {
    m = *reinterpret_cast<const uint32_t*>(mask + at);
  } else {
    m = uint32_t(mask[at]) | uint32_t(mask[at + 1]) << 8 | uint32_t(mask[at + 2]) << 16 |
        uint32_t(mask[at + 3]) << 24;
  }
  const int raw[4] = {lane_score(s01, 0), lane_score(s01, 1), lane_score(s23, 0),
                      lane_score(s23, 1)};
  int hi[4], lo[4];
  int any_hi = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ((m >> (8 * i)) & 0xFFu) ? raw[i] : 0;
    hi[i] = r >= ini_th ? r : 0;
    lo[i] = r >= min_th ? r : 0;
    any_hi |= hi[i] > 0;
  }
  const bool use_hi = __syncthreads_or(any_hi) != 0;
  uint2 packed;
  packed.x = (uint32_t(use_hi ? hi[0] : lo[0]) & 0xFFFFu) | uint32_t(use_hi ? hi[1] : lo[1]) << 16;
  packed.y = (uint32_t(use_hi ? hi[2] : lo[2]) & 0xFFFFu) | uint32_t(use_hi ? hi[3] : lo[3]) << 16;
  *reinterpret_cast<uint2*>(sel + at) = packed;
}

// the 4 int16 of `sel` at (y, x), x % 4 == 0, as int; zeros outside the map
__device__ __forceinline__ void load4(const int16_t* __restrict__ sel, int h, int w, int y, int x,
                                     int v[4]) {
  uint2 p = make_uint2(0, 0);
  if (y >= 0 && y < h && x >= 0 && x < w) {
    p = __ldg(reinterpret_cast<const uint2*>(sel + size_t(y) * w + x));
  }
  v[0] = int(int16_t(p.x & 0xFFFFu));
  v[1] = int(p.x) >> 16;
  v[2] = int(int16_t(p.y & 0xFFFFu));
  v[3] = int(p.y) >> 16;
}

__global__ void __launch_bounds__(kThreads)
nms3_kernel(const int16_t* __restrict__ sel, int32_t* __restrict__ out, int h, int w) {
  const int x = blockIdx.x * kTile + 4 * (threadIdx.x % kGroups);
  const int y = blockIdx.y * kTile + threadIdx.x / kGroups;
  // rows y-1, y, y+1 at columns x-1 .. x+4: c[r][j] is column x - 1 + j
  int c[3][6];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    int left[4], mid[4], right[4];
    load4(sel, h, w, y - 1 + r, x - 4, left);
    load4(sel, h, w, y - 1 + r, x, mid);
    load4(sel, h, w, y - 1 + r, x + 4, right);
    c[r][0] = left[3];
#pragma unroll
    for (int i = 0; i < 4; ++i) c[r][1 + i] = mid[i];
    c[r][5] = right[0];
  }
  int ud[6];  // max of the rows above and below, per column
#pragma unroll
  for (int j = 0; j < 6; ++j) ud[j] = max(c[0][j], c[2][j]);
  int v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int centre = c[1][1 + i];
    const int nb = max(max(ud[i], ud[i + 1]), max(ud[i + 2], max(c[1][i], c[1][i + 2])));
    v[i] = (centre > 0 && centre > nb) ? centre : 0;
  }
  *reinterpret_cast<int4*>(out + size_t(y) * w + x) = make_int4(v[0], v[1], v[2], v[3]);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// img, mask: (h, w) u8 with h, w multiples of 32; sel: (h, w) int16
// scratch; out: (h, w) int32; sel and out 16-byte aligned.  Two launches on
// `stream`; returns the first non-zero cudaGetLastError() of either
// (cudaErrorInvalidValue, without launching, for sides that are not
// multiples of 32 or scratch and output that are not aligned).
extern "C" int detect_fused(const void* img, const void* mask, void* sel, void* out, int h,
                            int w, int ini_th, int min_th, void* stream) {
  if (h % kTile || w % kTile || !aligned(sel, 16) || !aligned(out, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(w / kTile, h / kTile);
  const auto* im = static_cast<const uint8_t*>(img);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* s = static_cast<int16_t*>(sel);
  if (aligned(img, 4) && aligned(mask, 4)) {
    detect_select_kernel<true><<<grid, kThreads, 0, st>>>(im, mk, s, h, w, ini_th, min_th);
  } else {
    detect_select_kernel<false><<<grid, kThreads, 0, st>>>(im, mk, s, h, w, ini_th, min_th);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms3_kernel<<<grid, kThreads, 0, st>>>(s, static_cast<int32_t*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
