// B3: fused FAST detection — masked score, per-tile two-threshold retry and
// strict 3x3 NMS over one u8 detection composite.
//
// Replaces orbslam3_tpu/ops/fast.py::_detect_fused_pallas.  Input: a (h, w)
// u8 composite with h and w multiples of 32 and a (h, w) u8 interior mask
// (every 1 at least 3 px inside).  raw = mask ? score : 0 with the score of
// fast_score.cuh; hi = raw >= ini_th ? raw : 0, lo = raw >= min_th ? raw : 0;
// a 32x32 tile keeps hi if any of its hi is > 0, else lo; then a pixel is
// kept iff it is > 0 and > all 8 neighbours (zero outside the composite).
//
// The hard part is the NMS halo: a pixel on a tile border compares against
// neighbours that took THEIR tile's retry choice.  The TPU kernel carries
// that across its sequential grid with a one-strip lag; blocks on the card
// run in no order, so the kernel makes two launches on one stream:
//   1. one block per 32x32 tile stages the (32+6)^2 u8 halo in shared
//      memory, scores its 1024 pixels, reduces "any hi > 0" over the block
//      with __syncthreads_or (no atomics) and writes the tile's selected map
//      into a (h, w) int32 scratch;
//   2. one block per 32x8 strip stages a (8+2)x(32+2) halo of the selected
//      map (zero outside) and writes the NMS'd map.
// Bound on the H100: pass 1 is the B1 score (at least 165 int ops/px, 16-bit
// lanes, integer issue); pass 2 reads and writes 4 B/px, ~10 MB for the 3264x736 stereo
// composite, a few microseconds of HBM time.  The scratch round trip is what
// the TPU kernel avoided; at these sizes it sits in the 50 MB L2.

#include <cstdint>
#include <cuda_runtime.h>

#include "fast_score.cuh"

namespace {

constexpr int kTile = 32;                 // retry tile (TILE of ops/fast.py)
constexpr int kRows = 8;                  // thread rows of a block
constexpr int kHalo = kTile + 2 * kRingR;

__global__ void detect_select_kernel(const uint8_t* __restrict__ img,
                                     const uint8_t* __restrict__ mask,
                                     int32_t* __restrict__ sel, int h, int w,
                                     int ini_th, int min_th) {
  __shared__ uint8_t tile[kHalo][kHalo];
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int i = tid; i < kHalo * kHalo; i += kTile * kRows) {
    const int ty = i / kHalo;
    const int tx = i - ty * kHalo;
    const int gy = y0 + ty - kRingR;
    const int gx = x0 + tx - kRingR;
    tile[ty][tx] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[gy * w + gx] : 0;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  int hi[kTile / kRows];
  int lo[kTile / kRows];
  int any_hi = 0;
#pragma unroll
  for (int j = 0; j < kTile / kRows; ++j) {
    const int r = threadIdx.y + j * kRows;
    const int raw = mask[(y0 + r) * w + x]
                        ? fast_score_at(&tile[0][0], kHalo, r + kRingR, threadIdx.x + kRingR)
                        : 0;
    hi[j] = raw >= ini_th ? raw : 0;
    lo[j] = raw >= min_th ? raw : 0;
    any_hi |= hi[j] > 0;
  }
  const bool use_hi = __syncthreads_or(any_hi) != 0;
#pragma unroll
  for (int j = 0; j < kTile / kRows; ++j) {
    const int y = y0 + threadIdx.y + j * kRows;
    sel[y * w + x] = use_hi ? hi[j] : lo[j];
  }
}

__global__ void nms3_kernel(const int32_t* __restrict__ sel, int32_t* __restrict__ out,
                            int h, int w) {
  __shared__ int32_t s[kRows + 2][kTile + 2];
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kRows;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int i = tid; i < (kRows + 2) * (kTile + 2); i += kTile * kRows) {
    const int ty = i / (kTile + 2);
    const int tx = i - ty * (kTile + 2);
    const int gy = y0 + ty - 1;
    const int gx = x0 + tx - 1;
    s[ty][tx] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? sel[gy * w + gx] : 0;
  }
  __syncthreads();

  const int cy = threadIdx.y + 1;
  const int cx = threadIdx.x + 1;
  const int v = s[cy][cx];
  bool keep = v > 0;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy != 0 || dx != 0) keep = keep && v > s[cy + dy][cx + dx];
    }
  }
  out[(y0 + threadIdx.y) * w + x0 + threadIdx.x] = keep ? v : 0;
}

}  // namespace

// img, mask: (h, w) u8 with h, w multiples of 32; sel: (h, w) int32
// scratch; out: (h, w) int32.  Two launches on `stream`; returns the first
// non-zero cudaGetLastError() of either.
extern "C" int detect_fused(const void* img, const void* mask, void* sel, void* out, int h,
                            int w, int ini_th, int min_th, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kTile, kRows);
  detect_select_kernel<<<dim3(w / kTile, h / kTile), block, 0, st>>>(
      static_cast<const uint8_t*>(img), static_cast<const uint8_t*>(mask),
      static_cast<int32_t*>(sel), h, w, ini_th, min_th);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms3_kernel<<<dim3(w / kTile, h / kRows), block, 0, st>>>(
      static_cast<const int32_t*>(sel), static_cast<int32_t*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
