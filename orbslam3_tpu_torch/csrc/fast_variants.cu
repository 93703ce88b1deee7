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
// What the TPU knobs mean here, as template parameters of one kernel:
//   reducer  log-step (T1, T2 "logstep": m2/m4/m8/m9 chains, 64 mins + 15
//            maxes per polarity, dark polarity from 16 negated planes), van
//            Herk (T2 "vanherk", T3, T4 default: prefix/suffix scans, 58 ops
//            per polarity, dark polarity as a max chain folded by one
//            negation), or pairs (T4 "_win9_pairs": 77 ops, depth 4);
//   passes   one (the 16 differences live across both polarities) or two
//            (T3 "twopass": the differences are loaded again from shared
//            memory for the dark polarity) -- the register live set, T3's
//            question; -Xptxas -v shows what the compiler made of it;
//   width    int32 chains, or signed 16-bit packed two pixels to a register
//            with __vsub2 / __vmins2 / __vmaxs2 / __vneg2: the card's
//            counterpart of the TPU's bf16 chains (differences lie in
//            [-255, 255], so 16 bits are exact).  T2-T4 are bf16 throughout,
//            hence packed; T1 packs where its chains or its inputs are bf16.
// The tile, rows x cols, stands for strip x chunk: T3/T4's strip x chunk,
// T2's (rows, cols) sub-chunk, else strip x 128 (one lane group; the TPU
// functions without a chunk evaluate the whole width).  It is a launch
// parameter (dynamic shared memory), so every strip and chunk the TPU
// functions take runs.  Each 256-thread block stages its (rows+6) x (cols+6)
// u8 halo, zeros outside the image, and its threads score the tile's pixels
// from it (a pixel pair per thread when packed).
//
// Bound on the H100: 1 B read and 4 B written per pixel, ~7.8 MB for the
// 2112x736 harness image (~2.3 us at 3.35 TB/s).  The function needs at
// least 118 two-input integer ops per pixel (van Herk on the raw ring
// values with the differences folded out of the min/max,
// utils/device_time.FAST_SCORE_OPS_PER_PX), all of which fit 16-bit lanes:
// ~2.7 us at 66.9 Tops/s (132 SMs x 64 INT32 lanes x 1.98 GHz, two ops per
// three-input VIMNMX3 / IADD3, two lanes per packed register).  So the
// integer issue rate bounds every variant; log-step (192 ops/px), pairs
// (203), the 16 ring differences every variant forms and int32 chains
// (half the lane rate) spend more than the function needs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 48 * 1024;

enum Reducer { kLogStep = 0, kVanHerk = 1, kPairs = 2 };

// FAST_RING of oracle/orb_cpu.py: (dx, dy), 12 o'clock, clockwise
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

// One int32 lane per pixel.
struct I32 {
  using T = int;
  static __device__ __forceinline__ T load(const uint8_t* p) { return int(p[0]); }
  static __device__ __forceinline__ T sub(T a, T b) { return a - b; }
  static __device__ __forceinline__ T mn(T a, T b) { return min(a, b); }
  static __device__ __forceinline__ T mx(T a, T b) { return max(a, b); }
  static __device__ __forceinline__ T neg(T a) { return -a; }
};

// Two signed 16-bit lanes per register: pixels x (low half) and x + 1.
struct S16x2 {
  using T = unsigned int;
  static __device__ __forceinline__ T load(const uint8_t* p) {
    return unsigned(p[0]) | (unsigned(p[1]) << 16);
  }
  static __device__ __forceinline__ T sub(T a, T b) { return __vsub2(a, b); }
  static __device__ __forceinline__ T mn(T a, T b) { return __vmins2(a, b); }
  static __device__ __forceinline__ T mx(T a, T b) { return __vmaxs2(a, b); }
  static __device__ __forceinline__ T neg(T a) { return __vneg2(a); }
};

template <class L>
__device__ __forceinline__ void ring_diffs(const uint8_t* c, int pitch, typename L::T d[16]) {
  const typename L::T centre = L::load(c);
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = L::sub(L::load(c + kDy[k] * pitch + kDx[k]), centre);
}

// tools/bench_fast_variants.py:81-89: max over o of the log-step min of p[o..o+8].
template <class L>
__device__ __forceinline__ typename L::T arc_logstep(const typename L::T p[16]) {
  using T = typename L::T;
  T m2[16], m4[16], m8[16];
#pragma unroll
  for (int o = 0; o < 16; ++o) m2[o] = L::mn(p[o], p[(o + 1) & 15]);
#pragma unroll
  for (int o = 0; o < 16; ++o) m4[o] = L::mn(m2[o], m2[(o + 2) & 15]);
#pragma unroll
  for (int o = 0; o < 16; ++o) m8[o] = L::mn(m4[o], m4[(o + 4) & 15]);
  T best = L::mn(m8[0], p[8]);
#pragma unroll
  for (int o = 1; o < 16; ++o) best = L::mx(best, L::mn(m8[o], p[(o + 8) & 15]));
  return best;
}

// orbslam3_tpu/ops/fast.py:62 _win9 (van Herk) when PAIRS is false,
// tools/bench_fast_variants4.py:35 _win9_pairs otherwise: win[o] = op over
// p[o..o+8] (circular), then `red` over the 16 windows.
template <class L, bool PAIRS, bool MIN>
__device__ __forceinline__ typename L::T win9_reduce(const typename L::T p[16]) {
  using T = typename L::T;
  auto op = [](T a, T b) { return MIN ? L::mn(a, b) : L::mx(a, b); };
  auto red = [](T a, T b) { return MIN ? L::mx(a, b) : L::mn(a, b); };
  T win[16];
  if (PAIRS) {
    T w2[23], w4[21], w8[17];
#pragma unroll
    for (int j = 0; j < 23; ++j) w2[j] = op(p[j & 15], p[(j + 1) & 15]);
#pragma unroll
    for (int j = 0; j < 21; ++j) w4[j] = op(w2[j], w2[j + 2]);
#pragma unroll
    for (int j = 0; j < 17; ++j) w8[j] = op(w4[j], w4[j + 4]);
#pragma unroll
    for (int o = 0; o < 16; ++o) win[o] = op(w8[o], p[(o + 8) & 15]);
  } else {
    T P[24], S[24];
#pragma unroll
    for (int j = 0; j < 24; ++j) P[j] = (j % 9 == 0) ? p[j & 15] : op(P[j - 1], p[j & 15]);
#pragma unroll
    for (int j = 23; j >= 0; --j)
      S[j] = (j % 9 == 8 || j == 23) ? p[j & 15] : op(S[j + 1], p[j & 15]);
#pragma unroll
    for (int o = 0; o < 16; ++o) win[o] = op(S[o], P[o + 8]);
  }
  T acc = win[0];
#pragma unroll
  for (int o = 1; o < 16; ++o) acc = red(acc, win[o]);
  return acc;
}

// score + 1 of the pixel (pair) whose centre is at c.
template <class L, int REDUCER, int PASSES>
__device__ __forceinline__ typename L::T score_plus1(const uint8_t* c, int pitch) {
  using T = typename L::T;
  T d[16];
  ring_diffs<L>(c, pitch, d);
  if (REDUCER == kLogStep) {
    T nd[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) nd[k] = L::neg(d[k]);
    return L::mx(arc_logstep<L>(d), arc_logstep<L>(nd));
  }
  constexpr bool kPairsWin = REDUCER == kPairs;
  const T bright = win9_reduce<L, kPairsWin, true>(d);
  if (PASSES == 2) ring_diffs<L>(c, pitch, d);
  const T ndark = win9_reduce<L, kPairsWin, false>(d);
  return L::mx(bright, L::neg(ndark));
}

template <int REDUCER, int PASSES, bool PACKED>
__global__ void __launch_bounds__(kThreads)
fast_variant_kernel(const uint8_t* __restrict__ img, int32_t* __restrict__ out, int h, int w,
                    int rows, int cols) {
  extern __shared__ uint8_t tile[];
  const int pitch = cols + 6;
  const int y0 = blockIdx.y * rows;
  const int x0 = blockIdx.x * cols;
  for (int i = threadIdx.x; i < (rows + 6) * pitch; i += kThreads) {
    const int ty = i / pitch;
    const int tx = i - ty * pitch;
    const int gy = y0 + ty - 3;
    const int gx = x0 + tx - 3;
    tile[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[gy * w + gx] : 0;
  }
  __syncthreads();

  if (PACKED) {
    const int pairs = cols / 2;
    for (int p = threadIdx.x; p < rows * pairs; p += kThreads) {
      const int y = p / pairs;
      const int x = 2 * (p - y * pairs);
      const int gy = y0 + y;
      const int gx = x0 + x;
      if (gy >= h || gx >= w) continue;
      const unsigned s = __vsub2(
          score_plus1<S16x2, REDUCER, PASSES>(tile + (y + 3) * pitch + x + 3, pitch), 0x00010001u);
      out[gy * w + gx] = int(int16_t(s & 0xFFFFu));
      if (gx + 1 < w) out[gy * w + gx + 1] = int(int16_t(s >> 16));
    }
  } else {
    for (int p = threadIdx.x; p < rows * cols; p += kThreads) {
      const int y = p / cols;
      const int x = p - y * cols;
      const int gy = y0 + y;
      const int gx = x0 + x;
      if (gy >= h || gx >= w) continue;
      out[gy * w + gx] = score_plus1<I32, REDUCER, PASSES>(tile + (y + 3) * pitch + x + 3, pitch) - 1;
    }
  }
}

template <int REDUCER, int PASSES, bool PACKED>
int launch(const void* img, void* out, int h, int w, int rows, int cols, void* stream) {
  const int smem = (rows + 6) * (cols + 6);
  const dim3 grid((w + cols - 1) / cols, (h + rows - 1) / rows);
  fast_variant_kernel<REDUCER, PASSES, PACKED>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(img), static_cast<int32_t*>(out), h, w, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations the four TPU functions map to.
int dispatch(int reducer, int passes, bool packed, const void* img, void* out, int h, int w,
             int rows, int cols, void* stream) {
  if (h <= 0 || w <= 0 || rows <= 0 || cols <= 0 || cols % 2 != 0 ||
      (rows + 6) * (cols + 6) > kMaxSmem) {
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
// differences are 16-bit where the chains are bf16, or where the views are
// bf16 and cast early; the views' type is otherwise a TPU load format and
// the tile stays u8.  Strip 32, no column chunk.
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
