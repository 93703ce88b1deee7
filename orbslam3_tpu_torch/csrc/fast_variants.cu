// T1-T4: the A/B variants of the threshold-free FAST-9/16 score.
//
// Replaces the four Pallas functions of the A/B harnesses under tools/:
//   fast_variant_t1  tools/bench_fast_variants.py   make_variant(cast_early, chain_dtype, in_dtype)
//   fast_variant_t2  tools/bench_fast_variants2.py  make_prod_like(strip, arc, chunk)
//   fast_variant_t3  tools/bench_fast_variants3.py  make_kernel(strip, chunk, mode)
//   fast_variant_t4  tools/bench_fast_variants4.py  make_kernel(strip, chunk, win)
// All four compute one function: for every pixel of the (h, w) u8 image,
// zero-padded outside it, max(max_o min(d[o..o+8]), max_o min(-d[o..o+8])) - 1
// over the 16 circular 9-arcs of the ring differences d[k] = ring[k] - centre.
// Output is (h, w) int32: the TPU functions' [:h, :w] (their 128-lane
// padding is a TPU layout and is not kept).  Unlike B1 (fast_score.cu) no
// 3-px frame is zeroed: border pixels score against the zero padding.
//
// The machinery is B1's packed core (fast_score.cuh): no ring difference is
// formed, since min over an arc of (ring - c) is the arc's min of ring,
// minus c, so with A the max over arcs of the arc's min of the raw ring
// values and B the min over arcs of the arc's max, score = max(A - c, c - B)
// - 1 whatever reduces the arcs.  What the TPU knobs mean here, as template
// parameters of one kernel:
//   reducer  the form of the arc reductions: log-step (T1, T2 "logstep":
//            windows of 2, 4, 8 by doubling, then the ninth value), van Herk
//            (T2 "vanherk", T3, T4 default: B1's arc_reduce, prefix and
//            suffix scans over two blocks of 8), or pairs (T4 "_win9_pairs":
//            the doubling over the ring extended to 24 values; after common
//            subexpressions it is log-step's dataflow);
//   passes   one, or two (T3 "twopass": the ring values are loaded from
//            shared memory again, with volatile loads, for B) -- the
//            register live set, T3's question; -Xptxas -v shows what the
//            compiler made of it;
//   width    two pixels per 32-bit register as u16 lanes (the TPU's bf16
//            chains; T2-T4 throughout, T1 where its chains or its cast-early
//            views are bf16), folded as max(A + 255 - c, c + 255 - B) - 256
//            in [0, 510] per lane; or one int32 lane per pixel (T1's other
//            cases: that is T1's knob).
// The tile, rows x cols, stands for strip x chunk: T3/T4's strip x chunk,
// T2's (rows, cols) sub-chunk, else strip x 128 (one lane group; the TPU
// functions without a chunk evaluate the whole width).  It is a launch
// parameter, so every strip and chunk the TPU functions take runs.  Each
// 256-thread block stages its halo as u16 in dynamic shared memory
// ((rows + 6) x (cols rounded up to 4, + 8) u16: 4 columns of margin each
// side keep a 4-pixel group 8-byte aligned), zeros outside the image, one
// 32-bit load per 4-pixel word where the width allows, eight words a thread
// in flight at once (a 48 x 384 tile stages ~21 words a thread, and one
// block has its SM to itself: a load latency per word would be exposed).
// Above 48 KB the
// kernel opts in to Hopper's 227 KB (T3's s64 c384 needs 54,880 B, s48
// c768 83,808 B).  Each thread scores 4 horizontally adjacent pixels at a
// time from three aligned 64-bit shared loads per ring row (packed: two u16
// pairs that share them), its groups dealt out over the tile with no
// division in the loop, and stores them with one 16-byte store where the
// width and the tile allow (w % 4 == 0, cols % 4 == 0); other widths,
// including tiles with cols % 4 == 2, store each pixel alone.  No
// instantiation spills at 4 pixels a thread (-Xptxas -v, sm_90a).
//
// Bound on the H100: 1 B read and 4 B written per pixel, ~7.8 MB for the
// 2112x736 harness image (~2.3 us at 3.35 TB/s).  The function needs at
// least 118 two-input integer ops per pixel (van Herk on the raw ring
// values with the differences folded out of the min/max,
// utils/device_time.FAST_SCORE_OPS_PER_PX), all of which fit 16-bit lanes:
// ~2.7 us at 66.9 Tops/s.  So the integer issue rate bounds every variant;
// log-step and pairs (~2 x 79 ops per pixel) and int32 lanes (half the lane
// rate) spend more than the function needs.

#include <cstdint>
#include <cuda_runtime.h>

#include "fast_score.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // the most dynamic shared memory an H100 block can opt in to
constexpr int kStageBatch = 8;    // halo words a thread loads before it stores them

enum Reducer { kLogStep = 0, kVanHerk = 1, kPairs = 2 };

// u16 per halo row of a tile `cols` wide, and the halo's bytes
__host__ __device__ constexpr int halo_pitch(int cols) { return 4 * ((cols + 3) / 4) + 2 * kHaloLeft; }
constexpr long long halo_bytes(int rows, int cols) {
  return 2LL * (rows + 2 * kRingR) * halo_pitch(cols);
}

// Deals the cells of a grid `ncols` wide out to the block's threads, cell
// r * ncols + q to thread (r * ncols + q) % kThreads: each thread divides
// once, then steps with adds.
struct GridWalk {
  int r, q;
  const int ncols, dr, dq;
  __device__ explicit GridWalk(int n)
      : r(int(threadIdx.x) / n), q(int(threadIdx.x) % n), ncols(n), dr(kThreads / n),
        dq(kThreads % n) {}
  __device__ void next() {
    r += dr;
    q += dq;
    if (q >= ncols) {
      q -= ncols;
      ++r;
    }
  }
};

template <class L, int REDUCER, bool MIN>
__device__ __forceinline__ typename L::T reduce_arcs(const typename L::T p[16]) {
  if constexpr (REDUCER == kVanHerk) {
    return arc_reduce<MIN>(p);  // u16 lanes only
  } else if constexpr (REDUCER == kPairs) {
    return arc_reduce_pairs<L, MIN>(p);
  } else {
    return arc_reduce_logstep<L, MIN>(p);
  }
}

// score - 1 of the four pixels at tile (ly, lx .. lx + 3), u16 lanes: two
// pairs from one set of ring-row loads
template <int REDUCER, int PASSES>
__device__ __forceinline__ void scores4_packed(const uint16_t* tile, int pitch, int ly, int lx,
                                               int v[4]) {
  uint32_t wv[kRingRows][kGroupWords];
  load_ring_words(tile, pitch, ly, lx, wv);
  uint32_t p[2][16], c[2], a[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ring_pairs(wv, i, p[i]);
    c[i] = centre_pair(wv, i);
    a[i] = reduce_arcs<LaneU16x2, REDUCER, true>(p[i]);
  }
  if (PASSES == 2) {
    load_ring_words<true>(tile, pitch, ly, lx, wv);
#pragma unroll
    for (int i = 0; i < 2; ++i) ring_pairs(wv, i, p[i]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t s = fold_biased(a[i], reduce_arcs<LaneU16x2, REDUCER, false>(p[i]), c[i]);
    v[2 * i] = lane_score(s, 0);
    v[2 * i + 1] = lane_score(s, 1);
  }
}

// the u16 column m of a group's ring row as an int
__device__ __forceinline__ int u16_at(const uint32_t row[kGroupWords], int m) {
  return int((m & 1) ? row[m >> 1] >> 16 : row[m >> 1] & 0xFFFFu);
}

// score - 1 of the four pixels at tile (ly, lx .. lx + 3), int32 lanes
template <int REDUCER, int PASSES>
__device__ __forceinline__ void scores4_i32(const uint16_t* tile, int pitch, int ly, int lx,
                                            int v[4]) {
  uint32_t wv[kRingRows][kGroupWords];
  load_ring_words(tile, pitch, ly, lx, wv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int p[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) p[k] = u16_at(wv[ring_dy(k) + kRingR], kHaloLeft + i + ring_dx(k));
    const int c = u16_at(wv[kRingR], kHaloLeft + i);
    const int a = reduce_arcs<LaneI32, REDUCER, true>(p);
    if (PASSES == 2) {
      uint32_t fresh[kRingRows][kGroupWords];
      load_ring_words<true>(tile, pitch, ly, lx, fresh);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        p[k] = u16_at(fresh[ring_dy(k) + kRingR], kHaloLeft + i + ring_dx(k));
      }
    }
    v[i] = max(a - c, c - reduce_arcs<LaneI32, REDUCER, false>(p)) - 1;
  }
}

// VEC: w % 4 == 0, cols % 4 == 0, img 4-byte and out 16-byte aligned
template <int REDUCER, int PASSES, bool PACKED>
__global__ void __launch_bounds__(kThreads)
fast_variant_kernel(const uint8_t* __restrict__ img, int32_t* __restrict__ out, int h, int w,
                    int rows, int cols, bool vec) {
  extern __shared__ __align__(16) uint16_t tile[];
  const int pitch = halo_pitch(cols);
  const int y0 = blockIdx.y * rows;
  const int x0 = blockIdx.x * cols;
  // the halo, kStageBatch words a thread at a time: their loads all go out
  // before the first store waits on one
  const int halo_rows = rows + 2 * kRingR;
  for (GridWalk g(pitch / 4); g.r < halo_rows;) {
    uint32_t v[kStageBatch];
    int at[kStageBatch];
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      at[b] = -1;
      if (g.r < halo_rows) {
        const int gy = y0 - kRingR + g.r;
        const int gx = x0 - kHaloLeft + 4 * g.q;
        v[b] = vec ? load_word<true>(img, h, w, gy, gx) : load_word<false>(img, h, w, gy, gx);
        at[b] = g.r * pitch + 4 * g.q;
      }
      g.next();
    }
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      if (at[b] >= 0) store_word_u16(tile + at[b], v[b]);
    }
  }
  __syncthreads();

  for (GridWalk g((cols + 3) / 4); g.r < rows; g.next()) {
    const int ly = g.r;
    const int lx = 4 * g.q;
    const int y = y0 + ly;
    const int x = x0 + lx;
    if (y >= h || x >= w) continue;
    int v[4];
    if constexpr (PACKED) {
      scores4_packed<REDUCER, PASSES>(tile, pitch, ly, lx, v);
    } else {
      scores4_i32<REDUCER, PASSES>(tile, pitch, ly, lx, v);
    }
    int32_t* o = out + size_t(y) * w + x;
    if (vec) {
      *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (lx + i < cols && x + i < w) o[i] = v[i];
      }
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int REDUCER, int PASSES, bool PACKED>
int launch(const void* img, void* out, int h, int w, int rows, int cols, void* stream) {
  // once per instantiation, at its first launch (so never inside a CUDA
  // graph capture that follows a first call)
  static const cudaError_t opted = cudaFuncSetAttribute(
      fast_variant_kernel<REDUCER, PASSES, PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const bool vec = w % 4 == 0 && cols % 4 == 0 && aligned(img, 4) && aligned(out, 16);
  const dim3 grid((w + cols - 1) / cols, (h + rows - 1) / rows);
  fast_variant_kernel<REDUCER, PASSES, PACKED>
      <<<grid, kThreads, static_cast<size_t>(halo_bytes(rows, cols)),
         static_cast<cudaStream_t>(stream)>>>(static_cast<const uint8_t*>(img),
                                              static_cast<int32_t*>(out), h, w, rows, cols, vec);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations the four TPU functions map to.
int dispatch(int reducer, int passes, bool packed, const void* img, void* out, int h, int w,
             int rows, int cols, void* stream) {
  if (h <= 0 || w <= 0 || rows <= 0 || cols <= 0 || cols % 2 != 0 ||
      halo_bytes(rows, cols) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reducer == kLogStep && passes == 1 && !packed)
    return launch<kLogStep, 1, false>(img, out, h, w, rows, cols, stream);
  if (reducer == kLogStep && passes == 1 && packed)
    return launch<kLogStep, 1, true>(img, out, h, w, rows, cols, stream);
  if (reducer == kVanHerk && passes == 1 && packed)
    return launch<kVanHerk, 1, true>(img, out, h, w, rows, cols, stream);
  if (reducer == kVanHerk && passes == 2 && packed)
    return launch<kVanHerk, 2, true>(img, out, h, w, rows, cols, stream);
  if (reducer == kPairs && passes == 1 && packed)
    return launch<kPairs, 1, true>(img, out, h, w, rows, cols, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

constexpr int kLanes = 128;  // the tile width of the TPU functions without a column chunk

}  // namespace

// img: (h, w) u8; out: (h, w) int32.  Each launches on `stream` and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a tile that
// does not fit, without launching).

// make_variant(cast_early, chain_dtype, in_dtype): in_kind 0 = u8 views
// (None), 1 = int32 views, 2 = bf16 views; chain16 = bf16 chains.  The
// lanes are 16-bit where the chains are bf16, or where the views are bf16
// and cast early; the views' type is otherwise a TPU load format and the
// tile stays u16.  Strip 32, no column chunk.
extern "C" int fast_variant_t1(const void* img, void* out, int h, int w, int cast_early,
                               int chain16, int in_kind, void* stream) {
  const bool packed = chain16 != 0 || (cast_early != 0 && in_kind == 2);
  return dispatch(kLogStep, 1, packed, img, out, h, w, 32, kLanes, stream);
}

// make_prod_like(strip, arc, chunk): arc 0 = logstep, 1 = vanherk; chunk
// (chunk_rows, chunk_cols), both 0 for None.  bf16 throughout.
extern "C" int fast_variant_t2(const void* img, void* out, int h, int w, int strip, int arc,
                               int chunk_rows, int chunk_cols, void* stream) {
  const int rows = chunk_rows > 0 ? chunk_rows : strip;
  const int cols = chunk_cols > 0 ? chunk_cols : kLanes;
  return dispatch(arc == 0 ? kLogStep : kVanHerk, 1, true, img, out, h, w, rows, cols, stream);
}

// make_kernel(strip, chunk, mode): van Herk; twopass 1 = "twopass", 0 =
// "onepass".  bf16 throughout.
extern "C" int fast_variant_t3(const void* img, void* out, int h, int w, int strip, int chunk,
                               int twopass, void* stream) {
  return dispatch(kVanHerk, twopass ? 2 : 1, true, img, out, h, w, strip, chunk, stream);
}

// make_kernel(strip, chunk, win): win 0 = _win9 (van Herk), 1 = _win9_pairs.
// bf16 throughout.
extern "C" int fast_variant_t4(const void* img, void* out, int h, int w, int strip, int chunk,
                               int win, void* stream) {
  return dispatch(win == 0 ? kVanHerk : kPairs, 1, true, img, out, h, w, strip, chunk, stream);
}
