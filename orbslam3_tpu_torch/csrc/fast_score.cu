// B1: threshold-free FAST-9/16 corner score over one u8 image.
//
// Replaces orbslam3_tpu/ops/fast.py::_raw_score_pallas.  For every pixel the
// score of fast_score.cuh (max over the 16 circular 9-arcs of the min ring
// difference, dark polarity folded in, minus 1).  The score is stored where
// the pixel is inside the 3-px frame (no mask) or where the u8 mask plane is
// 1; every other pixel stores 0.  Output (h, w) int32.
//
// Bound on the H100: per pixel the kernel reads 1 B of image (plus 1 B of
// mask) and writes 4 B, ~6 B/px -- about 4.3 us of HBM time for the 3264x736
// stereo detection composite.  The function needs at least 118 two-input
// integer ops per pixel, all in 16-bit lanes
// (utils/device_time.FAST_SCORE_OPS_PER_PX), plus the mask: about 4.3 us
// at 66.9 Tops/s.  The two bounds are about equal.  Design: a 16x128 tile
// per 256-thread block, its 22x136 halo staged once in shared memory as u16;
// each thread scores 4 horizontally adjacent pixels of 2 rows with the
// packed, subtraction-free core of fast_score.cuh, and stores each group
// of 4 int32 with one 16-byte store.  Widths that are not a multiple of 4
// (or unaligned pointers) take the same kernel with byte loads and scalar
// stores.  No TPU layout carries over.

#include <cstdint>
#include <cuda_runtime.h>

#include "fast_score.cuh"

namespace {

constexpr int kTileW = 128;
constexpr int kTileH = 16;  // 3 % faster than 32 rows on an H100 80GB HBM3 (PERF.md)
constexpr int kThreads = 256;
constexpr int kGroups = kTileW / 4;                  // 4-pixel groups in a tile row
constexpr int kRowStep = kThreads / kGroups;         // tile rows scored at once
constexpr int kHaloRows = kTileH + 2 * kRingR;
constexpr int kHaloWords = (kTileW + 2 * kHaloLeft) / 4;
constexpr int kPitch = 4 * kHaloWords;               // u16 per halo row

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
fast_score_kernel(const uint8_t* __restrict__ img, const uint8_t* __restrict__ mask,
                  int32_t* __restrict__ out, int h, int w) {
  __shared__ __align__(16) uint16_t tile[kHaloRows * kPitch];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  stage_halo_u16<kHaloRows, kHaloWords, kThreads, VEC>(img, h, w, y0 - kRingR, x0 - kHaloLeft,
                                                       tile, kPitch);
  __syncthreads();

  const int lx = 4 * (threadIdx.x % kGroups);
  const int x = x0 + lx;
  if (x >= w) return;
#pragma unroll
  for (int j = 0; j < kTileH / kRowStep; ++j) {
    const int ly = threadIdx.x / kGroups + j * kRowStep;
    const int y = y0 + ly;
    if (y >= h) break;
    uint32_t s01, s23;
    biased_scores4(tile, kPitch, ly, lx, s01, s23);
    int v[4] = {lane_score(s01, 0), lane_score(s01, 1), lane_score(s23, 0), lane_score(s23, 1)};
    const size_t at = size_t(y) * w + x;
    if (mask != nullptr) {
      uint32_t m;
      if (VEC) {
        m = *reinterpret_cast<const uint32_t*>(mask + at);
      } else {
        m = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (x + i < w) m |= uint32_t(mask[at + i]) << (8 * i);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = ((m >> (8 * i)) & 0xFFu) ? v[i] : 0;
    } else {
      const bool row_in = y >= kRingR && y < h - kRingR;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = (row_in && x + i >= kRingR && x + i < w - kRingR) ? v[i] : 0;
      }
    }
    if (VEC) {
      *reinterpret_cast<int4*>(out + at) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (x + i < w) out[at + i] = v[i];
      }
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// img, mask: (h, w) u8, mask may be null; out: (h, w) int32.  Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int fast_score(const void* img, const void* mask, void* out, int h, int w,
                          void* stream) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* im = static_cast<const uint8_t*>(img);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<int32_t*>(out);
  const bool vec = w % 4 == 0 && aligned(img, 4) && aligned(mask, 4) && aligned(out, 16);
  if (vec) {
    fast_score_kernel<true><<<grid, kThreads, 0, st>>>(im, mk, o, h, w);
  } else {
    fast_score_kernel<false><<<grid, kThreads, 0, st>>>(im, mk, o, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}
