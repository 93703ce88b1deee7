// B5: per-keypoint point sampling out of one u8 image (the rBRIEF samples).
//
// Replaces orbslam3_tpu/ops/window_gather.py::_sample_windows_pallas.
// out[k, j] = img[row0'[k] + ridx[k, j], col0'[k] + cidx[k, j]] with the
// window starts clamped to row0' in [0, h - nr] and col0' in [0, w - nc]
// as B2 clamps them, and ridx / cidx in [0, nr) / [0, nc) (the caller's
// contract; the kernel clamps them so a bad index cannot leave the window).
// Values stay u8 (the TPU kernel stored f32; the values are equal).
//
// Bound on the H100: per keypoint the kernel reads nr*nc bytes of image
// (1369 B for the 37x37 BRIEF window, mostly from L2) and 2 x 4 x S bytes
// of indices (4 KB for S = 512), and writes S bytes: the index read
// dominates, ~20 MB for K = 5000, a few microseconds of HBM time.  Design:
// one block per keypoint stages its window in shared memory (row-major, so
// neighbouring threads read neighbouring bytes), then each thread picks
// samples out of shared memory; index reads and sample writes are
// coalesced.  The TPU kernel's one-hot row matmul and masked lane reduce
// have no counterpart: a shared-memory load is the pick.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void sample_windows_kernel(const uint8_t* __restrict__ img, int h, int w,
                                      const int32_t* __restrict__ row0,
                                      const int32_t* __restrict__ col0,
                                      const int32_t* __restrict__ ridx,
                                      const int32_t* __restrict__ cidx, int s, int nr,
                                      int nc, uint8_t* __restrict__ out) {
  extern __shared__ uint8_t win[];  // (nr, nc)
  const int k = blockIdx.x;
  const int r0 = min(max(row0[k], 0), h - nr);
  const int c0 = min(max(col0[k], 0), w - nc);
  for (int i = threadIdx.x; i < nr * nc; i += kThreads) {
    const int r = i / nc;
    const int c = i - r * nc;
    win[i] = img[(r0 + r) * w + (c0 + c)];
  }
  __syncthreads();

  const long long base = static_cast<long long>(k) * s;
  for (int j = threadIdx.x; j < s; j += kThreads) {
    const int r = min(max(ridx[base + j], 0), nr - 1);
    const int c = min(max(cidx[base + j], 0), nc - 1);
    out[base + j] = win[r * nc + c];
  }
}

}  // namespace

// img: (h, w) u8; row0, col0: (k,) int32; ridx, cidx: (k, s) int32; out:
// (k, s) u8.  Requires nr <= h, nc <= w and nr * nc <= 48 KiB.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int sample_windows(const void* img, int h, int w, const void* row0,
                              const void* col0, const void* ridx, const void* cidx, int k,
                              int s, int nr, int nc, void* out, void* stream) {
  if (k == 0 || s == 0) return 0;
  sample_windows_kernel<<<k, kThreads, static_cast<size_t>(nr) * nc,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), h, w, static_cast<const int32_t*>(row0),
      static_cast<const int32_t*>(col0), static_cast<const int32_t*>(ridx),
      static_cast<const int32_t*>(cidx), s, nr, nc, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
