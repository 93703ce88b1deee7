// B2: batched window gather out of u8 images, up to kMaxJobs jobs in one launch.
//
// Replaces orbslam3_tpu/ops/window_gather.py::_gather_windows_pallas.
// For each job j: out_j[k, r, c] = img_j[row0_j'[k] + r, col0_j'[k] + c] for
// r < nr_j, c < nc_j, with the starts clamped in the kernel to row0' in
// [0, h - nr] and col0' in [0, w - nc], so every window lies inside its
// image.  The jobs share K and nothing else: each has its own image, starts,
// window shape and output.  Values stay u8 (the TPU kernel stored them as
// bf16; the values are equal).
//
// Bound on the H100: per window the kernel reads and writes nr*nc bytes
// (961 B for the 31x31 orientation windows, 1369 B for the 37x37 BRIEF
// windows, 121 B / 231 B for the SAD strips): ~9 MB for a stereo frame, ~3
// us of HBM time, and the image (a 1.3-2.6 MB composite) and the windows
// mostly stay in L2.  A launch is bound by its fixed cost, load latency and
// instruction issue, not by bandwidth.  Design:
//   - One launch serves every job (grid.y = job), so a frame's two pairs of
//     independent gathers (orientation + BRIEF, left + right SAD strips) take
//     two launches, not four.
//   - Each thread writes one or two consecutive 32-bit words of its job's
//     flat (K, nr, nc) output with one store (two for windows of at least
//     kTwoWordsFrom columns), neighbouring threads on neighbouring
//     addresses.  Two divisions, as multiply-shifts by constants computed on
//     the host, place the thread's first byte (window, row, column); its
//     second word steps along the row.
//   - A word inside one window row is two aligned 32-bit loads of the image
//     and one __funnelshift_r; a word that crosses a row's end is two such
//     pairs, one per row.  A thread that reaches the next window loads that
//     window's start together with its own, so every pixel load waits for one
//     latency and all of a thread's loads are in flight at once.  Words are
//     aligned by absolute address, so any image base pointer works; where a
//     word pair crosses [img, img + h*w) it is read bytewise, so no byte
//     outside the image is read.  Windows under 4 columns go bytewise.
//   - No shared memory and no barrier: a block is 256 independent threads
//     at ~32 registers, so an SM holds 2048 threads to hide the two
//     dependent latencies (window start, then pixels).  A form that staged
//     16 windows per block in shared memory (4-byte cp.async of the covering
//     words, a realigning pass, 16-byte stores of the block's segment) was
//     slower on the H100 than the one-block-per-window kernel this one
//     replaced: each thread looped over ~26 window rows per phase between
//     five barriers, at one block (8 warps) per SM.
//   - TMA does not serve here: a tensor map needs the global row pitch to be
//     a multiple of 16 bytes, and the composites are 3454 and 1762 bytes
//     wide.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxJobs = 2;
// output bytes of one job, at most: a job's threads stop at its own block
// count, so their offsets stay below 2^31 whatever the other job's grid
constexpr long long kMaxTotal = (1LL << 31) - (1 << 16);
// windows this wide take two output words per thread (fewer divisions and
// window starts per byte), narrower ones one (more threads for small jobs;
// on the H100 the 11x21 SAD strips gathered ~10 % faster so)
constexpr int kTwoWordsFrom = 24;

// x / d for 0 <= x < 2^31 as (x * m) >> s (Granlund and Montgomery, 1994)
struct Divisor {
  unsigned long long m;
  int s;
};

Divisor make_divisor(unsigned d) {
  int l = 0;
  while ((1ULL << l) < d) ++l;  // ceil(log2 d)
  return {(1ULL << (31 + l)) / d + 1, 31 + l};
}

__device__ __forceinline__ int divide(int x, Divisor d) {
  return static_cast<int>((static_cast<unsigned long long>(x) * d.m) >> d.s);
}

struct Job {
  const uint8_t* img;
  const int32_t* row0;
  const int32_t* col0;
  uint8_t* out;
  Divisor by_n, by_nc;  // nr * nc, nc
  int total;  // k * nr * nc output bytes
  int npix;   // h * w
  int h, w, nr, nc;
  int words;   // 32-bit output words per thread: 1 or 2
  int blocks;  // blocks of this job; grid.x is the larger job's count
};

struct Jobs {
  Job job[kMaxJobs];
  int k;
};

// offset in the image of window kk's clamped start
__device__ __forceinline__ int window_offset(const Job& jb, int kk) {
  const int r0 = min(max(jb.row0[kk], 0), jb.h - jb.nr);
  const int c0 = min(max(jb.col0[kk], 0), jb.w - jb.nc);
  return r0 * jb.w + c0;
}

__device__ __forceinline__ uint32_t load_word_checked(const uint8_t* img, int npix, int woff) {
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int i = woff + b;
    if (i >= 0 && i < npix) v |= static_cast<uint32_t>(img[i]) << (8 * b);
  }
  return v;
}

// the 4 image bytes at [off, off + 4); bytes outside the image read as 0
__device__ __forceinline__ uint32_t load4(const Job& jb, int ib, int off) {
  const int u = (ib + off) & 3;
  const int woff = off - u;
  uint32_t lo, hi;
  if (woff >= 0 && woff <= jb.npix - 8) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(jb.img + woff);
    lo = __ldg(p);
    hi = __ldg(p + 1);
  } else {
    lo = load_word_checked(jb.img, jb.npix, woff);
    hi = load_word_checked(jb.img, jb.npix, woff + 4);
  }
  return __funnelshift_r(lo, hi, 8u * u);
}

// Windows of at least 4 columns (and 4 * KW bytes): a thread's words touch
// at most two windows, and a word at most two rows.
template <int KW>
__device__ __forceinline__ void gather_words_wide(const Jobs& jobs, const Job& jb, int f0,
                                                  uint32_t (&v)[KW]) {
  const int nc = jb.nc, w = jb.w;
  const int ib = static_cast<int>(reinterpret_cast<uintptr_t>(jb.img) & 3);
  const int kk = divide(f0, jb.by_n);
  const int rem = f0 - kk * jb.nr * nc;
  int r = divide(rem, jb.by_nc);
  int c = rem - r * nc;
  // both windows' starts at once, the next only where the thread reaches it
  int base = window_offset(jb, kk);
  const bool crosses = rem + 4 * KW > jb.nr * nc && kk + 1 < jobs.k;
  const int next = crosses ? window_offset(jb, kk + 1) : base;
#pragma unroll
  for (int j = 0; j < KW; ++j) {
    const uint32_t a = load4(jb, ib, base + r * w + c);
    if (c + 4 < nc) {  // the word lies in one window row, and so does the next word's start
      v[j] = a;
      c += 4;
    } else {  // the word ends the row or crosses into the next (of this window or the next)
      const int na = nc - c;  // 1-4 bytes from this row
      if (++r == jb.nr) {
        r = 0;
        base = next;
      }
      c = 4 - na;
      if (na == 4) {
        v[j] = a;
      } else {
        const uint32_t b = load4(jb, ib, base + r * w);
        v[j] = (a & ((1u << (8 * na)) - 1u)) | (b << (8 * na));
      }
    }
  }
}

// Windows under 4 columns, one word per thread: bytewise steps along rows
// and windows.
__device__ __forceinline__ uint32_t gather_word_narrow(const Jobs& jobs, const Job& jb, int f0) {
  const int nr = jb.nr, nc = jb.nc, w = jb.w;
  int kk = divide(f0, jb.by_n);
  const int rem = f0 - kk * nr * nc;
  int r = divide(rem, jb.by_nc);
  int c = rem - r * nc;
  int base = window_offset(jb, kk);
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (kk < jobs.k) {
      v |= static_cast<uint32_t>(jb.img[base + r * w + c]) << (8 * b);
      if (++c == nc) {
        c = 0;
        if (++r == nr) {
          r = 0;
          if (++kk < jobs.k) base = window_offset(jb, kk);
        }
      }
    }
  }
  return v;
}

template <int KW>
__device__ __forceinline__ void gather(const Jobs& jobs, const Job& jb) {
  const int f0 = (blockIdx.x * kThreads + threadIdx.x) * 4 * KW;
  if (f0 >= jb.total) return;
  uint32_t v[KW];
  if (KW > 1 || jb.nc >= 4) {  // two words only from kTwoWordsFrom columns
    gather_words_wide<KW>(jobs, jb, f0, v);
  } else {
    v[0] = gather_word_narrow(jobs, jb, f0);
  }
  uint8_t* dst = jb.out + f0;
  if (f0 + 4 * KW <= jb.total) {
    if constexpr (KW == 2) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = v[0];
    }
  } else {
    for (int i = 0; i < jb.total - f0; ++i) dst[i] = static_cast<uint8_t>(v[i >> 2] >> (8 * (i & 3)));
  }
}

__global__ void __launch_bounds__(kThreads)
    gather_windows_kernel(const __grid_constant__ Jobs jobs) {
  const Job& jb = jobs.job[blockIdx.y];
  if (static_cast<int>(blockIdx.x) >= jb.blocks) return;
  if (jb.words == 2) {
    gather<2>(jobs, jb);
  } else {
    gather<1>(jobs, jb);
  }
}

}  // namespace

// jobs: n_jobs records of 8 int64 each, (img, h, w, row0, col0, nr, nc, out):
// img (h, w) u8 with h * w < 2^31; row0, col0 (k,) int32; out (k, nr, nc)
// u8, 16-byte aligned, k * nr * nc <= 2^31 - 2^16.  Requires 1 <= n_jobs <=
// 2, nr <= h and nc <= w.  One launch on `stream` for every job; returns
// cudaGetLastError() of the launch.
extern "C" int gather_windows(const long long* params, int n_jobs, int k, void* stream) {
  if (n_jobs < 1 || n_jobs > kMaxJobs) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0) return 0;
  Jobs jobs{};
  jobs.k = k;
  int grid_x = 0;
  for (int j = 0; j < n_jobs; ++j) {
    const long long* p = params + 8 * j;
    Job& jb = jobs.job[j];
    jb.img = reinterpret_cast<const uint8_t*>(p[0]);
    jb.h = static_cast<int>(p[1]);
    jb.w = static_cast<int>(p[2]);
    jb.npix = jb.h * jb.w;
    jb.row0 = reinterpret_cast<const int32_t*>(p[3]);
    jb.col0 = reinterpret_cast<const int32_t*>(p[4]);
    jb.nr = static_cast<int>(p[5]);
    jb.nc = static_cast<int>(p[6]);
    jb.out = reinterpret_cast<uint8_t*>(p[7]);
    if (p[7] & 15) return static_cast<int>(cudaErrorMisalignedAddress);
    const long long total = static_cast<long long>(k) * jb.nr * jb.nc;
    if (total > kMaxTotal) return static_cast<int>(cudaErrorInvalidValue);
    jb.total = static_cast<int>(total);
    jb.by_n = make_divisor(static_cast<unsigned>(jb.nr * jb.nc));
    jb.by_nc = make_divisor(static_cast<unsigned>(jb.nc));
    jb.words = jb.nc >= kTwoWordsFrom ? 2 : 1;
    const int per_block = kThreads * 4 * jb.words;
    jb.blocks = (jb.total + per_block - 1) / per_block;
    grid_x = grid_x > jb.blocks ? grid_x : jb.blocks;
  }
  gather_windows_kernel<<<dim3(grid_x, n_jobs), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(jobs);
  return static_cast<int>(cudaGetLastError());
}
