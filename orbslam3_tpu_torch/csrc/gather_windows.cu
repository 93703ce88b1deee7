// B2: batched window gather out of one u8 image.
//
// Replaces orbslam3_tpu/ops/window_gather.py::_gather_windows_pallas.
// out[k, r, c] = img[row0'[k] + r, col0'[k] + c] for r < nr, c < nc, with
// the starts clamped in the kernel to row0' in [0, h - nr] and
// col0' in [0, w - nc], so every window lies inside the image.  Values stay
// u8 (the TPU kernel stored them as bf16; the values are equal).
//
// Bound on the H100: per window the kernel reads and writes nr*nc bytes
// (961 B for the 31x31 orientation windows, 1369 B for the 37x37 BRIEF
// windows, 121 B / 231 B for the SAD strips), a few MB per frame in all —
// microseconds of HBM time, so a launch is bound by latency and the number
// of blocks in flight, not bandwidth.  Design: one block of 128 threads per
// keypoint walks the window in row-major order, so neighbouring threads
// read neighbouring columns of one image row and write neighbouring output
// bytes; the image stays in device memory (and mostly in L2, since the
// merged composite is ~2.6 MB).  No TPU alignment granules or rotates
// carry over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void gather_windows_kernel(const uint8_t* __restrict__ img, int h, int w,
                                      const int32_t* __restrict__ row0,
                                      const int32_t* __restrict__ col0, int nr, int nc,
                                      uint8_t* __restrict__ out) {
  const int k = blockIdx.x;
  const int r0 = min(max(row0[k], 0), h - nr);
  const int c0 = min(max(col0[k], 0), w - nc);
  const int n = nr * nc;
  uint8_t* dst = out + static_cast<long long>(k) * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / nc;
    const int c = i - r * nc;
    dst[i] = img[(r0 + r) * w + (c0 + c)];
  }
}

}  // namespace

// img: (h, w) u8; row0, col0: (k,) int32; out: (k, nr, nc) u8.  Requires
// nr <= h and nc <= w.  Launches on `stream` and returns cudaGetLastError()
// of the launch.
extern "C" int gather_windows(const void* img, int h, int w, const void* row0,
                              const void* col0, int k, int nr, int nc, void* out,
                              void* stream) {
  if (k == 0) return 0;
  gather_windows_kernel<<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), h, w, static_cast<const int32_t*>(row0),
      static_cast<const int32_t*>(col0), nr, nc, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
