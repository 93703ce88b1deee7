// K3: the stereo match's SAD subpixel refinement and its median-SAD filter,
// in two launches: one per-slot pass over many blocks, then one block.
//
// Replaces the XLA ops of orbslam3_tpu/frontend/stereo_frame.py::stereo_match
// (:141-202: the 11 slide SADs of the strips B2 gathered, the first-minimum
// slide, the parabola, the disparity, the median-SAD outlier filter and the
// depth), which the port ran as ~60 torch ops and a sort of K values
// (frontend/stereo_frame.py, `sad_refine_plain`).  Per slot k:
//   - sad_j = sum |L[r][c] - R[r][c + j]| over the 11x11 left window L and
//     the 11x21 right strip R, j = 0..10, in int32 (exact), then f32;
//   - best_j the first minimum (C-h5), sad its value, inc_ok 0 < best_j <
//     10; d1, d2, d3 the SADs at jm - 1, jm, jm + 1 (jm = best_j clamped to
//     [1, 9]); denom = 2 ((d1 + d3) - 2 d2), delta = (d1 - d3) / denom
//     where denom != 0, else 0, delta_ok |delta| <= 1;
//   - best_ur = s[oct] ((sur0 + (best_j - 5)) + delta), disparity = ul -
//     best_ur, disp_ok 0 <= disparity < max_d; a disparity <= 0 becomes
//     0.01 and best_ur ul - 0.01;
//   - ok = tentative & in_bounds & inc_ok & delta_ok & disp_ok.
// Then, over all slots: n_ok, the median = the (n_ok // 2)-th smallest sad
// among the ok slots (BIG = 1 << 15 when none is: the twin's sorted
// where(ok, sad, BIG) at min(n_ok // 2, K - 1)), th = f32(1.5 * 1.4) *
// median, and per slot ok &= n_ok > 0 & sad < th, u_right = ok ? best_ur :
// -1, depth = ok ? mbf / disparity : -1.  Every float operation is one
// rounded operation as torch's (__fadd_rn, __fmul_rn, __fdiv_rn: a true
// IEEE division, no contraction); max_d, mbf and th's factor arrive as the
// f32 values torch forms from the Python doubles.
//
// Bound on the H100: 1331 absolute differences a slot (1.3 M at K = 1000,
// ~0.02 us at the int32 rate) and 352 strip bytes read a slot: a launch's
// fixed cost bounds it.  Design: the per-slot pass stages its block's
// kSlots strips in shared memory with 4-byte loads (a block's strips are
// one contiguous range of each strip block), then one thread per (slot,
// slide) sums its slide's 121 __sad from shared memory (11 x 32 threads a
// block, so that enough warps hide the shared loads' latency), and one
// thread a slot takes the 11 sums; it writes (sad, ok, best_ur, disparity)
// per slot.  A first form, one thread a slot with all 11 slides in
// registers (16 blocks of 64 threads at K = 1000), made the whole call
// 0.0237 ms against this form's 0.0101 ms (a stereo frame's inputs, NVIDIA
// H100 80GB HBM3 at 700 W, tools/bench_match_kernels.py).  The median pass
// is one block: a 256-bin histogram of sad >> 7 over the ok slots finds
// the median's bin, a 128-bin histogram of sad & 127 inside that bin its
// value (sad < 121 * 255 < 2^15), so no sort is needed; then it writes the
// outputs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 32;  // slots of a per-slot block
constexpr int kMedianThreads = 1024;
constexpr int kSadW = 5, kSadL = 5;
constexpr int kWl = 2 * kSadW + 1;             // 11: left window side
constexpr int kWw = 2 * (kSadL + kSadW) + 1;   // 21: right strip width
constexpr int kSlides = 2 * kSadL + 1;         // 11
constexpr int kLeftBytes = kWl * kWl;          // 121
constexpr int kRightBytes = kWl * kWw;         // 231
constexpr int kBig = 1 << 15;
constexpr int kSlotThreads = kSlots * kSlides;  // a thread per (slot, slide)

// pairs rows (csrc/stereo_hamming.cu's output) that the refinement reads
constexpr int kRowTentative = 2, kRowSur0 = 5, kRowInBounds = 6;

struct SlotArgs {
  const uint8_t* p_l;     // (K, 11, 11)
  const uint8_t* p_r;     // (K, 11, 21)
  const int32_t* pairs;   // (11, K)
  const float* xy_l;      // (K, 2)
  const int32_t* oct_l;   // (K,)
  const float* scale;     // (L,)
  float max_d;
  int k;
  int32_t* scratch;       // (4, K): sad, ok, best_ur bits, disparity bits
};

// copies n bytes from global src (4-byte aligned) to shared dst
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src, int n) {
  const int words = n / 4;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    reinterpret_cast<uint32_t*>(dst)[i] = reinterpret_cast<const uint32_t*>(src)[i];
  }
  for (int i = 4 * words + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kSlotThreads)
    sad_slots_kernel(const __grid_constant__ SlotArgs a) {
  __shared__ __align__(16) uint8_t left[kSlots * kLeftBytes];
  __shared__ __align__(16) uint8_t right[kSlots * kRightBytes];
  __shared__ unsigned sads[kSlots][kSlides];
  const int k0 = blockIdx.x * kSlots;
  const int n = min(kSlots, a.k - k0);
  stage(left, a.p_l + static_cast<long long>(k0) * kLeftBytes, n * kLeftBytes);
  stage(right, a.p_r + static_cast<long long>(k0) * kRightBytes, n * kRightBytes);
  __syncthreads();
  // SAD of slide j of slot s: the 11 threads of a slot read its left bytes
  // together (one broadcast) and 11 neighbouring right bytes
  {
    const int s = threadIdx.x / kSlides, j = threadIdx.x - s * kSlides;
    if (s < n) {
      const uint8_t* lw = left + s * kLeftBytes;
      const uint8_t* rw = right + s * kRightBytes + j;
      unsigned acc = 0;
#pragma unroll
      for (int r = 0; r < kWl; ++r) {
#pragma unroll
        for (int c = 0; c < kWl; ++c) acc = __sad(lw[r * kWl + c], rw[r * kWw + c], acc);
      }
      sads[s][j] = acc;
    }
  }
  __syncthreads();
  const int s = threadIdx.x;
  if (s >= n) return;
  const int k = k0 + s;
  unsigned acc[kSlides];
#pragma unroll
  for (int j = 0; j < kSlides; ++j) acc[j] = sads[s][j];
  int best_j = 0;
#pragma unroll
  for (int j = 1; j < kSlides; ++j) {
    if (acc[j] < acc[best_j]) best_j = j;  // the first minimum
  }
  // the three SADs around the clamped best slide, picked from registers
  const int jm = min(max(best_j, 1), kSlides - 2);
  unsigned s1 = 0, s2 = 0, s3 = 0, sad = 0;
#pragma unroll
  for (int j = 0; j < kSlides; ++j) {
    if (j == jm - 1) s1 = acc[j];
    if (j == jm) s2 = acc[j];
    if (j == jm + 1) s3 = acc[j];
    if (j == best_j) sad = acc[j];
  }
  const float d1 = __uint2float_rn(s1), d2 = __uint2float_rn(s2), d3 = __uint2float_rn(s3);
  const float denom = __fmul_rn(2.0f, __fsub_rn(__fadd_rn(d1, d3), __fmul_rn(2.0f, d2)));
  const float delta = denom != 0.0f ? __fdiv_rn(__fsub_rn(d1, d3), denom) : 0.0f;
  const bool inc_ok = best_j > 0 && best_j < kSlides - 1;
  const bool delta_ok = delta >= -1.0f && delta <= 1.0f;
  const int sur0 = a.pairs[kRowSur0 * a.k + k];
  const float ul = a.xy_l[2 * k];
  float best_ur = __fmul_rn(
      a.scale[a.oct_l[k]],
      __fadd_rn(__fadd_rn(__int2float_rn(sur0), __int2float_rn(best_j - kSadL)), delta));
  float disparity = __fsub_rn(ul, best_ur);
  const bool disp_ok = disparity >= 0.0f && disparity < a.max_d;
  if (disparity <= 0.0f) {
    disparity = 0.01f;
    best_ur = __fsub_rn(ul, 0.01f);
  }
  const bool ok = a.pairs[kRowTentative * a.k + k] != 0 && a.pairs[kRowInBounds * a.k + k] != 0 &&
                  inc_ok && delta_ok && disp_ok;
  a.scratch[k] = static_cast<int>(sad);
  a.scratch[a.k + k] = ok;
  a.scratch[2 * a.k + k] = __float_as_int(best_ur);
  a.scratch[3 * a.k + k] = __float_as_int(disparity);
}

// In warp 0: the bin (of n_bins, n_bins / 32 a lane) that holds the rank-th
// smallest count, and the rank within it; bins and rank in shared memory.
// Returns the total in every lane.
__device__ __forceinline__ int find_bin(const int* hist, int n_bins, int rank_in, int* bin_out,
                                        int* rank_out, bool use_half_total) {
  const int lane = threadIdx.x & 31;
  const int per = n_bins / 32;
  int sum = 0;
  for (int b = 0; b < per; ++b) sum += hist[lane * per + b];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  const int rank = use_half_total ? total / 2 : rank_in;
  int run = incl - sum;
  if (total > 0 && run <= rank && rank < incl) {
    for (int b = 0; b < per; ++b) {
      const int c = hist[lane * per + b];
      if (rank < run + c) {
        *bin_out = lane * per + b;
        *rank_out = rank - run;
        break;
      }
      run += c;
    }
  }
  return total;
}

__global__ void __launch_bounds__(kMedianThreads)
    sad_median_kernel(const int32_t* scratch, int k, float mbf, float th_factor, float* u_right,
                      float* depth) {
  __shared__ int hi[256], lo[128];
  __shared__ int hi_bin, hi_rank, lo_bin, lo_rank, n_ok;
  const int t = threadIdx.x;
  if (t < 256) hi[t] = 0;
  if (t < 128) lo[t] = 0;
  if (t == 0) hi_bin = lo_bin = -1;
  __syncthreads();
  const int32_t* sad = scratch;
  const int32_t* ok = scratch + k;
  for (int i = t; i < k; i += kMedianThreads) {
    if (ok[i]) atomicAdd(&hi[sad[i] >> 7], 1);
  }
  __syncthreads();
  if (t < 32) {
    const int total = find_bin(hi, 256, 0, &hi_bin, &hi_rank, true);
    if (t == 0) n_ok = total;
  }
  __syncthreads();
  for (int i = t; i < k; i += kMedianThreads) {
    if (ok[i] && (sad[i] >> 7) == hi_bin) atomicAdd(&lo[sad[i] & 127], 1);
  }
  __syncthreads();
  if (t < 32 && n_ok > 0) find_bin(lo, 128, hi_rank, &lo_bin, &lo_rank, false);
  __syncthreads();
  const int median = n_ok > 0 ? (hi_bin << 7) | lo_bin : kBig;
  const float th = __fmul_rn(th_factor, __int2float_rn(median));
  for (int i = t; i < k; i += kMedianThreads) {
    const bool keep = ok[i] && n_ok > 0 && __int2float_rn(sad[i]) < th;
    u_right[i] = keep ? __int_as_float(scratch[2 * k + i]) : -1.0f;
    depth[i] = keep ? __fdiv_rn(mbf, __int_as_float(scratch[3 * k + i])) : -1.0f;
  }
}

}  // namespace

// p_l (K, 11, 11) and p_r (K, 11, 21) u8 strips, 4-byte aligned; pairs
// (11, K) int32 (csrc/stereo_hamming.cu); xy_l (K, 2) f32; oct_l (K,)
// int32 in [0, L); scale (L,) f32; scratch (4, K) int32; u_right, depth
// (K,) f32.  Two launches on `stream` (per-slot, then the one-block median);
// returns cudaGetLastError() after them.
extern "C" int sad_refine(const void* p_l, const void* p_r, const void* pairs, const void* xy_l,
                          const void* oct_l, const void* scale, int k, float max_d, float mbf,
                          float th_factor, void* scratch, void* u_right, void* depth,
                          void* stream) {
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(p_l) | reinterpret_cast<uintptr_t>(p_r)) & 3) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (k == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  SlotArgs a{static_cast<const uint8_t*>(p_l), static_cast<const uint8_t*>(p_r),
             static_cast<const int32_t*>(pairs), static_cast<const float*>(xy_l),
             static_cast<const int32_t*>(oct_l), static_cast<const float*>(scale), max_d, k,
             static_cast<int32_t*>(scratch)};
  sad_slots_kernel<<<(k + kSlots - 1) / kSlots, kSlotThreads, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sad_median_kernel<<<1, kMedianThreads, 0, s>>>(static_cast<const int32_t*>(scratch), k, mbf,
                                                 th_factor, static_cast<float*>(u_right),
                                                 static_cast<float*>(depth));
  return static_cast<int>(cudaGetLastError());
}
