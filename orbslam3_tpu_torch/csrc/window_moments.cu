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
// 8 B; ~2 int multiply-adds per pixel.  A launch is bound by latency and
// blocks in flight, not bandwidth or issue.  Design: the weight planes are
// staged once per block in shared memory; each warp of a block owns one
// keypoint, lanes walk a window row (neighbouring lanes on neighbouring
// bytes), and a warp-shuffle reduction sums the lanes.  The (K, nr, nc)
// windows of the unfused path never reach device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__global__ void window_moments_kernel(const uint8_t* __restrict__ img, int h, int w,
                                      const int32_t* __restrict__ row0,
                                      const int32_t* __restrict__ col0, int k, int nr,
                                      int nc, const int32_t* __restrict__ wts,
                                      float* __restrict__ out) {
  extern __shared__ int32_t wsh[];  // (2, nr, nc)
  const int n = nr * nc;
  for (int i = threadIdx.x; i < 2 * n; i += kWarps * 32) wsh[i] = wts[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (kp >= k) return;
  const int r0 = min(max(row0[kp], 0), h - nr);
  const int c0 = min(max(col0[kp], 0), w - nc);
  int s10 = 0;
  int s01 = 0;
  for (int r = 0; r < nr; ++r) {
    const uint8_t* row = img + (r0 + r) * w + c0;
    for (int c = lane; c < nc; c += 32) {
      const int p = row[c];
      s10 += p * wsh[r * nc + c];
      s01 += p * wsh[n + r * nc + c];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s10 += __shfl_down_sync(0xffffffffu, s10, off);
    s01 += __shfl_down_sync(0xffffffffu, s01, off);
  }
  if (lane == 0) {
    out[2 * kp] = static_cast<float>(s10);
    out[2 * kp + 1] = static_cast<float>(s01);
  }
}

}  // namespace

// img: (h, w) u8; row0, col0: (k,) int32; wts: (2, nr, nc) int32; out:
// (k, 2) f32.  Requires nr <= h, nc <= w and 8 * nr * nc <= 48 KiB of
// shared memory.  Launches on `stream`; returns cudaGetLastError().
extern "C" int window_moments(const void* img, int h, int w, const void* row0,
                              const void* col0, int k, int nr, int nc, const void* wts,
                              void* out, void* stream) {
  if (k == 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(nr) * nc * sizeof(int32_t);
  window_moments_kernel<<<(k + kWarps - 1) / kWarps, kWarps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), h, w, static_cast<const int32_t*>(row0),
      static_cast<const int32_t*>(col0), k, nr, nc, static_cast<const int32_t*>(wts),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
