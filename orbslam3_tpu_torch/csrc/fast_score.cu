// B1: threshold-free FAST-9/16 corner score over one u8 image.
//
// Replaces orbslam3_tpu/ops/fast.py::_raw_score_pallas.  For every pixel the
// score of fast_score.cuh (max over the 16 circular 9-arcs of the min ring
// difference, dark polarity folded in, minus 1).  The score is stored where
// the pixel is inside the 3-px frame (no mask) or where the u8 mask plane is
// 1 (mask multiplied in at the store); every other pixel stores 0.
//
// Bound on the H100: per output pixel the kernel reads 1 B of image (plus
// 1 B of mask) and writes 4 B, ~6 B/px — about 4 us of HBM time for the
// 3264x736 stereo detection composite.  The kernel's arithmetic is ~16
// subtractions plus 2 x 16 x 8 int32 min/max, ~300 ops/px; the function
// needs at least 165 (utils/device_time.FAST_SCORE_OPS_PER_PX, van Herk,
// 16-bit lanes), ~6 us at 66.9 Tops/s, so integer issue bounds it, not
// memory.  Design: each 32x8 block stages its
// (8+6)x(32+6) u8 halo in shared memory once (every pixel is read by 49
// neighbours' rings), the 16 differences live in registers, and the arc
// min/max chains are fully unrolled.  No TPU layout carries over.

#include <cstdint>
#include <cuda_runtime.h>

#include "fast_score.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int R = kRingR;

__global__ void fast_score_kernel(const uint8_t* __restrict__ img,
                                  const uint8_t* __restrict__ mask,
                                  int32_t* __restrict__ out, int h, int w) {
  __shared__ uint8_t tile[TY + 2 * R][TX + 2 * R];
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int i = tid; i < (TY + 2 * R) * (TX + 2 * R); i += TX * TY) {
    const int ty = i / (TX + 2 * R);
    const int tx = i - ty * (TX + 2 * R);
    const int gy = y0 + ty - R;
    const int gx = x0 + tx - R;
    tile[ty][tx] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[gy * w + gx] : 0;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;

  const int score = fast_score_at(&tile[0][0], TX + 2 * R, threadIdx.y + R, threadIdx.x + R);

  int keep;
  if (mask != nullptr) {
    keep = mask[y * w + x];
  } else {
    keep = (y >= R && y < h - R && x >= R && x < w - R) ? 1 : 0;
  }
  out[y * w + x] = score * keep;
}

}  // namespace

// img, mask: (h, w) u8, mask may be null; out: (h, w) int32.  Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int fast_score(const void* img, const void* mask, void* out, int h, int w,
                          void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<const uint8_t*>(mask),
      static_cast<int32_t*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
