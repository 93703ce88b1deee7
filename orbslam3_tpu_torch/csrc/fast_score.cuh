// FAST-9/16 score core shared by B1 (fast_score.cu) and B3 (detect_fused.cu).
//
// The score of a pixel with centre c and Bresenham ring values r[0..15] is
// max over the 16 circular 9-arcs of min(r - c) for the bright polarity and
// of min(c - r) for the dark one, minus 1.  The differences come out of the
// min/max: min over an arc of (r - c) = (min over the arc of r) - c, and
// likewise for max.  So with A = max over arcs of the arc's min of r and
// B = min over arcs of the arc's max of r,
//     score = max(A - c, c - B) - 1,
// and the 16 subtractions disappear: the arc reductions run on raw u8 ring
// values.  Both reductions are van Herk windows over two blocks of 8 ring
// values: per block 7 prefix and 6 suffix ops (the whole block is both the
// last prefix and the first suffix), 16 window ops and 15 ops over the
// windows, 57 per polarity; the fold is max(A + 255 - c, c + 255 - B) -
// 256, which keeps every lane in [0, 510].  Bit-identical to the plain
// twin `raw_score_map_plain` (tests/test_torch_score_core.py holds the
// algebra on the CPU).
//
// Lanes: two horizontally adjacent pixels share one 32-bit register as
// unsigned 16-bit lanes, and each thread scores four pixels (two such
// registers) at once, so the ring rows it loads serve both.  Min/max are
// Hopper's packed 16-bit instructions; the reduction over the 16 windows
// uses the three-input DPX forms (__vimax3_u16x2 / __vimin3_u16x2).
//
// Shared memory: the block stages its u8 halo widened to u16 (one u16 per
// pixel, high byte zero), with 4 columns of margin on the left so a
// thread's 4-pixel group starts on an 8-byte boundary.  A group reads, per
// ring row, three aligned 64-bit words (u16 columns x-4 .. x+7); a pair at
// an even offset is one word as it is, a pair at an odd offset is built
// from two words with one __byte_perm.

#pragma once

#include <cstdint>

namespace {

constexpr int kRingR = 3;
constexpr int kHaloLeft = 4;  // u16 columns of margin left of a tile in shared memory

// FAST_RING of oracle/orb_cpu.py, 12 o'clock, clockwise, as nibbles of
// dx + 3 and dy + 3 (k-th nibble from the least significant), so that the
// offsets are compile-time constants in the unrolled loops below
__host__ __device__ constexpr int ring_dx(int k) {
  return int((0x2100012345666543ull >> (4 * k)) & 0xF) - 3;
}
__host__ __device__ constexpr int ring_dy(int k) {
  return int((0x0123456665432100ull >> (4 * k)) & 0xF) - 3;
}

template <bool MIN>
__device__ __forceinline__ uint32_t lane_op(uint32_t a, uint32_t b) {
  return MIN ? __vminu2(a, b) : __vmaxu2(a, b);
}

// max over the 16 circular 9-windows of the window min (MIN), or min over
// them of the window max (!MIN), of 16 u16x2 ring values
template <bool MIN>
__device__ __forceinline__ uint32_t arc_reduce(const uint32_t p[16]) {
  uint32_t pf0[8], sf0[8], pf1[8], sf1[8];
  pf0[0] = p[0];
  pf1[0] = p[8];
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    pf0[k] = lane_op<MIN>(pf0[k - 1], p[k]);
    pf1[k] = lane_op<MIN>(pf1[k - 1], p[8 + k]);
  }
  sf0[7] = p[7];
  sf1[7] = p[15];
#pragma unroll
  for (int k = 6; k > 0; --k) {
    sf0[k] = lane_op<MIN>(sf0[k + 1], p[k]);
    sf1[k] = lane_op<MIN>(sf1[k + 1], p[8 + k]);
  }
  sf0[0] = pf0[7];
  sf1[0] = pf1[7];
  uint32_t win[16];
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    win[o] = lane_op<MIN>(sf0[o], pf1[o]);      // ring[o .. o+8]
    win[8 + o] = lane_op<MIN>(sf1[o], pf0[o]);  // ring[8+o .. 15] and ring[0 .. o]
  }
  // the other op over the 16 windows: a tree of three-input ops, depth 3
  uint32_t t[6];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    t[i] = MIN ? __vimax3_u16x2(win[3 * i], win[3 * i + 1], win[3 * i + 2])
               : __vimin3_u16x2(win[3 * i], win[3 * i + 1], win[3 * i + 2]);
  }
  t[5] = win[15];
  const uint32_t u0 = MIN ? __vimax3_u16x2(t[0], t[1], t[2]) : __vimin3_u16x2(t[0], t[1], t[2]);
  const uint32_t u1 = MIN ? __vimax3_u16x2(t[3], t[4], t[5]) : __vimin3_u16x2(t[3], t[4], t[5]);
  return lane_op<!MIN>(u0, u1);
}

// score + 256 of the two pixels of `centre` (u16x2) from their 16 ring pairs
__device__ __forceinline__ uint32_t biased_score_pair(const uint32_t p[16], uint32_t centre) {
  const uint32_t a = arc_reduce<true>(p);
  const uint32_t b = arc_reduce<false>(p);
  // A + 255 - c and c + 255 - B lie in [0, 510] in each lane, so one 32-bit
  // add of three terms never carries or borrows across the lanes
  return __vmaxu2(a + 0x00FF00FFu - centre, centre + 0x00FF00FFu - b);
}

// Scores of the four pixels at tile column lx (lx % 4 == 0) and tile row ly
// from the u16 halo `tile` (row pitch `pitch` u16, tile pixel (ly, lx) at
// halo row ly + kRingR, column lx + kHaloLeft): s01 holds pixels lx, lx+1,
// s23 pixels lx+2, lx+3, each lane score + 256.
__device__ __forceinline__ void biased_scores4(const uint16_t* tile, int pitch, int ly, int lx,
                                               uint32_t& s01, uint32_t& s23) {
  uint32_t wv[2 * kRingR + 1][6];  // per ring row, u16 columns lx .. lx+11 as words
#pragma unroll
  for (int r = 0; r < 2 * kRingR + 1; ++r) {
    const uint2* row = reinterpret_cast<const uint2*>(tile + (ly + r) * pitch + lx);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const uint2 v = row[q];
      wv[r][2 * q] = v.x;
      wv[r][2 * q + 1] = v.y;
    }
  }
  // the pair of u16 columns (lx + m, lx + m + 1) of ring row r
  auto pair = [&](int r, int m) -> uint32_t {
    return (m & 1) ? __byte_perm(wv[r][m >> 1], wv[r][(m >> 1) + 1], 0x5432) : wv[r][m >> 1];
  };
  uint32_t p0[16], p1[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    p0[k] = pair(ring_dy(k) + kRingR, kHaloLeft + ring_dx(k));
    p1[k] = pair(ring_dy(k) + kRingR, kHaloLeft + 2 + ring_dx(k));
  }
  s01 = biased_score_pair(p0, wv[kRingR][kHaloLeft / 2]);
  s23 = biased_score_pair(p1, wv[kRingR][kHaloLeft / 2 + 1]);
}

// The score of lane `hi` (0 or 1) of a biased pair, as int.
__device__ __forceinline__ int lane_score(uint32_t s, int hi) {
  return int(hi ? (s >> 16) : (s & 0xFFFFu)) - 256;
}

// Stage the (ROWS) x (4 * WORDS) u8 window of `img` whose top-left pixel is
// (gy0, gx0), gx0 % 4 == 0, into shared memory as u16 (row pitch `pitch`
// u16), zeros outside the image.  VEC: w % 4 == 0 and `img` 4-byte aligned,
// so each 4-pixel word of the window is wholly inside or outside the image
// and is read with one 32-bit load.
template <int ROWS, int WORDS, int THREADS, bool VEC>
__device__ __forceinline__ void stage_halo_u16(const uint8_t* __restrict__ img, int h, int w,
                                               int gy0, int gx0, uint16_t* tile, int pitch) {
#pragma unroll
  for (int i0 = 0; i0 < ROWS * WORDS; i0 += THREADS) {
    const int i = i0 + int(threadIdx.x);
    if (i < ROWS * WORDS) {
      const int r = i / WORDS;
      const int q = i - r * WORDS;
      const int gy = gy0 + r;
      const int gx = gx0 + 4 * q;
      uint32_t v = 0;
      if (gy >= 0 && gy < h) {
        const uint8_t* row = img + size_t(gy) * w;
        if (VEC) {
          if (gx >= 0 && gx < w) v = *reinterpret_cast<const uint32_t*>(row + gx);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            if (gx + b >= 0 && gx + b < w) v |= uint32_t(row[gx + b]) << (8 * b);
          }
        }
      }
      uint2 e;
      e.x = __byte_perm(v, 0, 0x4140);  // bytes 0, 1 -> u16 lanes
      e.y = __byte_perm(v, 0, 0x4342);  // bytes 2, 3 -> u16 lanes
      *reinterpret_cast<uint2*>(tile + r * pitch + 4 * q) = e;
    }
  }
}

}  // namespace
