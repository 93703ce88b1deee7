// B4: per-keypoint weighted window sums (the IC moments) out of one u8 image.
//
// Replaces orbslam3_tpu/ops/window_gather.py::_window_moments_pallas.
// out[k, m] = sum_{r < nr, c < nc} img[row0'[k] + r, col0'[k] + c] * wts[m, r, c]
// for m in {0, 1} ((m10, m01) with the circular IC weight planes), with the
// starts clamped to row0' in [0, h - nr] and col0' in [0, w - nc] as B2
// clamps them.  The sum is int32 and exact; it is stored as f32, exact too
// for the IC use (|m| <= 961 * 255 * 15 < 2^24).  atan2 stays in PyTorch, so
// the angles equal those of the unfused composition.
//
// Bound on the H100: per keypoint the kernel reads nr*nc bytes (961 B for
// 31x31) mostly from L2 (the merged composite is ~1.3-2.6 MB) and writes
// 8 B; ~2 int multiply-adds per pixel, ~200 warp instructions per keypoint,
// ~0.2 us of issue for K = 1000 over 132 SMs.  A launch is bound by load
// latency and the launch's fixed cost, not bandwidth or issue.  Design:
//   - One warp per keypoint; lane r owns window row r (and r + 32, ... for
//     taller windows).
//   - 31x31, the path's shape, is specialised at compile time: each lane
//     issues all ceil(31 / 4) + 1 = 9 aligned 32-bit word loads of its row at
//     once, before the block stages the weight planes in shared memory and
//     waits at its barrier, so the staging overlaps the pixel fetch and a
//     keypoint costs one load latency after its start is read.  Words are
//     aligned by absolute address (any base pointer); a row whose words
//     cross [img, img + h*w) reads them bytewise, so no byte outside the
//     image is read.  __funnelshift_r realigns the words to the window's
//     columns and the unrolled row loop extracts the bytes.
//   - Any other shape the wrapper takes (2 * nr * nc * 4 <= 48 KB) runs the
//     run-time instantiation: the same lane-per-row walk over byte loads.
//   - The weights are staged as (w10, w01) pairs, one 8-byte shared load per
//     pixel; lanes on different rows hit different banks.
//   - Products stay int32 IMADs (exact); the lanes' sums meet in a shuffle
//     reduction, and lane 0 writes (m10, m01) as one 8-byte store.  The
//     (K, nr, nc) windows of the unfused path never reach device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ uint32_t load_word_checked(const uint8_t* img, int npix, int woff) {
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int i = woff + b;
    if (i >= 0 && i < npix) v |= static_cast<uint32_t>(img[i]) << (8 * b);
  }
  return v;
}

// NR = NC = 0: the window's size at run time
template <int NR, int NC>
__global__ void __launch_bounds__(kWarps * 32)
    window_moments_kernel(const uint8_t* __restrict__ img, int h, int w,
                          const int32_t* __restrict__ row0, const int32_t* __restrict__ col0,
                          int k, int nr_rt, int nc_rt, const int32_t* __restrict__ wts,
                          float* __restrict__ out) {
  extern __shared__ int2 wsh[];  // (nr * nc) (w10, w01) pairs
  constexpr bool kFixed = NR > 0;
  const int nr = kFixed ? NR : nr_rt;
  const int nc = kFixed ? NC : nc_rt;
  const int n = nr * nc;
  const int npix = h * w;
  const int lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool valid = kp < k;
  int s10 = 0;
  int s01 = 0;

  if constexpr (kFixed) {
    constexpr int kRows = (NR + 31) / 32;   // rows per lane
    constexpr int kWords = (NC + 2) / 4 + 1;  // covering words of a row, at most
    constexpr int kAligned = (NC + 3) / 4;    // the row's words once realigned
    uint32_t wd[kRows][kWords];
    unsigned sh[kRows];
    // the pixel loads go out first
    if (valid) {
      const int r0 = min(max(row0[kp], 0), h - NR);
      const int c0 = min(max(col0[kp], 0), w - NC);
      const int ib = static_cast<int>(reinterpret_cast<uintptr_t>(img) & 3);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = lane + 32 * i;
        const int off = (r0 + min(r, NR - 1)) * w + c0;
        const int u = (ib + off) & 3;
        const int woff = off - u;
        sh[i] = 8u * u;
        if (woff >= 0 && woff <= npix - 4 * kWords) {
          const uint32_t* src = reinterpret_cast<const uint32_t*>(img + woff);
#pragma unroll
          for (int j = 0; j < kWords; ++j) wd[i][j] = __ldg(src + j);
        } else {
#pragma unroll
          for (int j = 0; j < kWords; ++j) wd[i][j] = load_word_checked(img, npix, woff + 4 * j);
        }
      }
    }
    constexpr int kStage = (NR * NC + kWarps * 32 - 1) / (kWarps * 32);
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = threadIdx.x + kWarps * 32 * j;
      if (i < NR * NC) wsh[i] = make_int2(wts[i], wts[NR * NC + i]);
    }
    __syncthreads();
    if (!valid) return;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = lane + 32 * i;
      if (r < NR) {
        uint32_t al[kAligned];
#pragma unroll
        for (int j = 0; j < kAligned; ++j) al[j] = __funnelshift_r(wd[i][j], wd[i][j + 1], sh[i]);
        const int2* wr = wsh + r * NC;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int p = (al[c >> 2] >> (8 * (c & 3))) & 0xff;
          const int2 wt = wr[c];
          s10 += p * wt.x;
          s01 += p * wt.y;
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kWarps * 32) wsh[i] = make_int2(wts[i], wts[n + i]);
    __syncthreads();
    if (!valid) return;
    const int r0 = min(max(row0[kp], 0), h - nr);
    const int c0 = min(max(col0[kp], 0), w - nc);
    for (int r = lane; r < nr; r += 32) {
      const uint8_t* row = img + (r0 + r) * w + c0;
      const int2* wr = wsh + r * nc;
      for (int c = 0; c < nc; ++c) {
        const int p = row[c];
        const int2 wt = wr[c];
        s10 += p * wt.x;
        s01 += p * wt.y;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s10 += __shfl_down_sync(0xffffffffu, s10, off);
    s01 += __shfl_down_sync(0xffffffffu, s01, off);
  }
  if (lane == 0) {
    reinterpret_cast<float2*>(out)[kp] = make_float2(static_cast<float>(s10), static_cast<float>(s01));
  }
}

}  // namespace

// img: (h, w) u8 with h * w < 2^31; row0, col0: (k,) int32; wts: (2, nr,
// nc) int32; out: (k, 2) f32.  Requires nr <= h, nc <= w and
// 8 * nr * nc <= 48 KiB of shared memory.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int window_moments(const void* img, int h, int w, const void* row0,
                              const void* col0, int k, int nr, int nc, const void* wts,
                              void* out, void* stream) {
  if (k == 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(nr) * nc * sizeof(int32_t);
  const dim3 grid((k + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* im = static_cast<const uint8_t*>(img);
  const auto* r0 = static_cast<const int32_t*>(row0);
  const auto* c0 = static_cast<const int32_t*>(col0);
  const auto* wt = static_cast<const int32_t*>(wts);
  auto* o = static_cast<float*>(out);
  if (nr == 31 && nc == 31) {
    window_moments_kernel<31, 31><<<grid, kWarps * 32, smem, s>>>(im, h, w, r0, c0, k, nr, nc, wt, o);
  } else {
    window_moments_kernel<0, 0><<<grid, kWarps * 32, smem, s>>>(im, h, w, r0, c0, k, nr, nc, wt, o);
  }
  return static_cast<int>(cudaGetLastError());
}
