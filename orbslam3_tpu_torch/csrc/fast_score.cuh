// FAST-9/16 score core shared by B1 (fast_score.cu), B3 (detect_fused.cu)
// and the A/B variants T1-T4 (fast_variants.cu).
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
//
// T1-T4 use the same fold, halo and ring loads, with their TPU harnesses'
// other reduction forms (arc_reduce_logstep, arc_reduce_pairs) and int32
// lanes as well.

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

// Lane types of the arc reductions: two u16 lanes per register (B1, B3 and
// the packed T variants), or one int32 lane per pixel (T1's int32 cases).
struct LaneU16x2 {
  using T = uint32_t;
  static __device__ __forceinline__ T mn(T a, T b) { return __vminu2(a, b); }
  static __device__ __forceinline__ T mx(T a, T b) { return __vmaxu2(a, b); }
  static __device__ __forceinline__ T mn3(T a, T b, T c) { return __vimin3_u16x2(a, b, c); }
  static __device__ __forceinline__ T mx3(T a, T b, T c) { return __vimax3_u16x2(a, b, c); }
};

struct LaneI32 {
  using T = int;
  static __device__ __forceinline__ T mn(T a, T b) { return min(a, b); }
  static __device__ __forceinline__ T mx(T a, T b) { return max(a, b); }
  static __device__ __forceinline__ T mn3(T a, T b, T c) { return __vimin3_s32(a, b, c); }
  static __device__ __forceinline__ T mx3(T a, T b, T c) { return __vimax3_s32(a, b, c); }
};

// the window op (MIN: min) and the op over the windows (MIN: max)
template <class L, bool MIN>
__device__ __forceinline__ typename L::T win_op(typename L::T a, typename L::T b) {
  return MIN ? L::mn(a, b) : L::mx(a, b);
}

// the op over the 16 windows: a tree of three-input ops, depth 3
template <class L, bool MIN>
__device__ __forceinline__ typename L::T over_windows(const typename L::T win[16]) {
  using T = typename L::T;
  auto op3 = [](T a, T b, T c) { return MIN ? L::mx3(a, b, c) : L::mn3(a, b, c); };
  T t[6];
#pragma unroll
  for (int i = 0; i < 5; ++i) t[i] = op3(win[3 * i], win[3 * i + 1], win[3 * i + 2]);
  t[5] = win[15];
  return win_op<L, !MIN>(op3(t[0], t[1], t[2]), op3(t[3], t[4], t[5]));
}

// max over the 16 circular 9-windows of the window min (MIN), or min over
// them of the window max (!MIN), of 16 u16x2 ring values
template <bool MIN>
__device__ __forceinline__ uint32_t arc_reduce(const uint32_t p[16]) {
  using L = LaneU16x2;
  uint32_t pf0[8], sf0[8], pf1[8], sf1[8];
  pf0[0] = p[0];
  pf1[0] = p[8];
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    pf0[k] = win_op<L, MIN>(pf0[k - 1], p[k]);
    pf1[k] = win_op<L, MIN>(pf1[k - 1], p[8 + k]);
  }
  sf0[7] = p[7];
  sf1[7] = p[15];
#pragma unroll
  for (int k = 6; k > 0; --k) {
    sf0[k] = win_op<L, MIN>(sf0[k + 1], p[k]);
    sf1[k] = win_op<L, MIN>(sf1[k + 1], p[8 + k]);
  }
  sf0[0] = pf0[7];
  sf1[0] = pf1[7];
  uint32_t win[16];
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    win[o] = win_op<L, MIN>(sf0[o], pf1[o]);      // ring[o .. o+8]
    win[8 + o] = win_op<L, MIN>(sf1[o], pf0[o]);  // ring[8+o .. 15] and ring[0 .. o]
  }
  return over_windows<L, MIN>(win);
}

// T1-T4 (fast_variants.cu) also reduce in the two other forms their TPU
// harnesses compare, in either lane type.  Min and max are exact, so every
// form gives arc_reduce's A (MIN) and B (!MIN).

// Log-step (tools/bench_fast_variants.py:81-89): circular windows of 2, 4
// and 8 by doubling, then the ninth value.
template <class L, bool MIN>
__device__ __forceinline__ typename L::T arc_reduce_logstep(const typename L::T p[16]) {
  using T = typename L::T;
  T m2[16], m4[16], m8[16], win[16];
#pragma unroll
  for (int o = 0; o < 16; ++o) m2[o] = win_op<L, MIN>(p[o], p[(o + 1) & 15]);
#pragma unroll
  for (int o = 0; o < 16; ++o) m4[o] = win_op<L, MIN>(m2[o], m2[(o + 2) & 15]);
#pragma unroll
  for (int o = 0; o < 16; ++o) m8[o] = win_op<L, MIN>(m4[o], m4[(o + 4) & 15]);
#pragma unroll
  for (int o = 0; o < 16; ++o) win[o] = win_op<L, MIN>(m8[o], p[(o + 8) & 15]);
  return over_windows<L, MIN>(win);
}

// Pairs (tools/bench_fast_variants4.py:35 _win9_pairs): the same doubling
// over the ring extended to 24 values, windows of 2, 4, 8, then the ninth.
template <class L, bool MIN>
__device__ __forceinline__ typename L::T arc_reduce_pairs(const typename L::T p[16]) {
  using T = typename L::T;
  T w2[23], w4[21], w8[17], win[16];
#pragma unroll
  for (int j = 0; j < 23; ++j) w2[j] = win_op<L, MIN>(p[j & 15], p[(j + 1) & 15]);
#pragma unroll
  for (int j = 0; j < 21; ++j) w4[j] = win_op<L, MIN>(w2[j], w2[j + 2]);
#pragma unroll
  for (int j = 0; j < 17; ++j) w8[j] = win_op<L, MIN>(w4[j], w4[j + 4]);
#pragma unroll
  for (int o = 0; o < 16; ++o) win[o] = win_op<L, MIN>(w8[o], p[(o + 8) & 15]);
  return over_windows<L, MIN>(win);
}

// score + 256 in each u16 lane from A, B and the centre c: max(A + 255 - c,
// c + 255 - B).  Both terms lie in [0, 510] in each lane, so one 32-bit add
// of three terms never carries or borrows across the lanes
__device__ __forceinline__ uint32_t fold_biased(uint32_t a, uint32_t b, uint32_t centre) {
  return __vmaxu2(a + 0x00FF00FFu - centre, centre + 0x00FF00FFu - b);
}

// score + 256 of the two pixels of `centre` (u16x2) from their 16 ring pairs
__device__ __forceinline__ uint32_t biased_score_pair(const uint32_t p[16], uint32_t centre) {
  return fold_biased(arc_reduce<true>(p), arc_reduce<false>(p), centre);
}

constexpr int kRingRows = 2 * kRingR + 1;
constexpr int kGroupWords = 6;  // u16 columns lx .. lx+11 of one ring row, as words

// The ring rows of the four pixels at tile column lx (lx % 4 == 0) and tile
// row ly of the u16 halo `tile` (row pitch `pitch` u16, tile pixel (ly, lx)
// at halo row ly + kRingR, column lx + kHaloLeft): three aligned 64-bit
// shared loads per row, u16 columns lx .. lx+11.  FRESH: volatile loads,
// which the compiler cannot merge with an earlier load of the same words.
template <bool FRESH = false>
__device__ __forceinline__ void load_ring_words(const uint16_t* tile, int pitch, int ly, int lx,
                                                uint32_t wv[kRingRows][kGroupWords]) {
#pragma unroll
  for (int r = 0; r < kRingRows; ++r) {
    const uint16_t* row = tile + (ly + r) * pitch + lx;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      uint2 v;
#ifdef __CUDA_ARCH__
      if (FRESH) {
        const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(row + 4 * q));
        asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(at));
      } else {
        v = reinterpret_cast<const uint2*>(row)[q];
      }
#else
      v = reinterpret_cast<const uint2*>(row)[q];
#endif
      wv[r][2 * q] = v.x;
      wv[r][2 * q + 1] = v.y;
    }
  }
}

// The 16 ring pairs of pixels (lx + 2 * half, lx + 2 * half + 1), half 0 or
// 1, from their ring words: the pair of u16 columns (lx + m, lx + m + 1) of
// a row is one word at even m and two words' halves at odd m.
__device__ __forceinline__ void ring_pairs(const uint32_t wv[kRingRows][kGroupWords], int half,
                                           uint32_t p[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int r = ring_dy(k) + kRingR;
    const int m = kHaloLeft + 2 * half + ring_dx(k);
    p[k] = (m & 1) ? __byte_perm(wv[r][m >> 1], wv[r][(m >> 1) + 1], 0x5432) : wv[r][m >> 1];
  }
}

// The centres of pixels (lx + 2 * half, lx + 2 * half + 1) as a u16 pair.
__device__ __forceinline__ uint32_t centre_pair(const uint32_t wv[kRingRows][kGroupWords],
                                                int half) {
  return wv[kRingR][kHaloLeft / 2 + half];
}

// Scores of the four pixels at tile column lx and tile row ly (see
// load_ring_words): s01 holds pixels lx, lx+1, s23 pixels lx+2, lx+3, each
// lane score + 256.
__device__ __forceinline__ void biased_scores4(const uint16_t* tile, int pitch, int ly, int lx,
                                               uint32_t& s01, uint32_t& s23) {
  uint32_t wv[kRingRows][kGroupWords];
  load_ring_words(tile, pitch, ly, lx, wv);
  uint32_t p0[16], p1[16];
  ring_pairs(wv, 0, p0);
  ring_pairs(wv, 1, p1);
  s01 = biased_score_pair(p0, centre_pair(wv, 0));
  s23 = biased_score_pair(p1, centre_pair(wv, 1));
}

// The score of lane `hi` (0 or 1) of a biased pair, as int.
__device__ __forceinline__ int lane_score(uint32_t s, int hi) {
  return int(hi ? (s >> 16) : (s & 0xFFFFu)) - 256;
}

// The 4-pixel word of `img` at (gy, gx), zeros outside the image.  VEC: w %
// 4 == 0, gx % 4 == 0 and `img` 4-byte aligned, so the word lies wholly
// inside or outside the image and is read with one 32-bit load.
template <bool VEC>
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ img, int h, int w,
                                              int gy, int gx) {
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
  return v;
}

// A word's four bytes into shared memory at `dst` (8-byte aligned) as u16.
__device__ __forceinline__ void store_word_u16(uint16_t* dst, uint32_t v) {
  uint2 e;
  e.x = __byte_perm(v, 0, 0x4140);  // bytes 0, 1 -> u16 lanes
  e.y = __byte_perm(v, 0, 0x4342);  // bytes 2, 3 -> u16 lanes
  *reinterpret_cast<uint2*>(dst) = e;
}

// Stage the (ROWS) x (4 * WORDS) u8 window of `img` whose top-left pixel is
// (gy0, gx0), gx0 % 4 == 0, into shared memory as u16 (row pitch `pitch`
// u16), zeros outside the image (VEC as load_word).
template <int ROWS, int WORDS, int THREADS, bool VEC>
__device__ __forceinline__ void stage_halo_u16(const uint8_t* __restrict__ img, int h, int w,
                                               int gy0, int gx0, uint16_t* tile, int pitch) {
#pragma unroll
  for (int i0 = 0; i0 < ROWS * WORDS; i0 += THREADS) {
    const int i = i0 + int(threadIdx.x);
    if (i < ROWS * WORDS) {
      const int r = i / WORDS;
      const int q = i - r * WORDS;
      store_word_u16(tile + r * pitch + 4 * q, load_word<VEC>(img, h, w, gy0 + r, gx0 + 4 * q));
    }
  }
}

}  // namespace
