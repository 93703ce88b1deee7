// FAST-9/16 score arithmetic shared by B1 (fast_score.cu) and B3
// (detect_fused.cu).
//
// For a pixel whose 16 Bresenham-ring neighbours lie inside a u8 tile: the
// ring differences d[k] = ring[k] - centre (int32), then
// score = max(max_o min(d[o..o+8]), max_o min(-d[o..o+8])) - 1 over the 16
// circular 9-arcs.  Min/max are exact in any order, so the result is
// bit-identical to the plain PyTorch twin `raw_score_map_plain`.

#pragma once

#include <cstdint>

namespace {

constexpr int kRingR = 3;

// FAST_RING of orbslam3_tpu/oracle/orb_cpu.py: (dx, dy), 12 o'clock, clockwise
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

// Threshold-free score of tile[cy][cx] (row pitch `pitch` bytes); the ring
// reaches kRingR pixels in every direction.  The 16 differences live in
// registers and the arc min/max chains are fully unrolled.
__device__ __forceinline__ int fast_score_at(const uint8_t* tile, int pitch, int cy, int cx) {
  const int c = tile[cy * pitch + cx];
  int d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = int(tile[(cy + kRingDy[k]) * pitch + cx + kRingDx[k]]) - c;

  int bright = -256;  // max over arcs of the arc minimum
  int ndark = 256;    // min over arcs of the arc maximum (dark = -ndark)
#pragma unroll
  for (int o = 0; o < 16; ++o) {
    int mn = d[o];
    int mx = d[o];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      mn = min(mn, d[(o + j) & 15]);
      mx = max(mx, d[(o + j) & 15]);
    }
    bright = max(bright, mn);
    ndark = min(ndark, mx);
  }
  return max(bright, -ndark) - 1;
}

}  // namespace
