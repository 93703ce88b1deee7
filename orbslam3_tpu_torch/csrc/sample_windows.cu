// B5: per-keypoint point sampling out of one u8 image, in two modes.
//
// Index mode replaces orbslam3_tpu/ops/window_gather.py::_sample_windows_pallas.
// out[k, j] = img[row0'[k] + ridx[k, j], col0'[k] + cidx[k, j]] with the
// window starts clamped to row0' in [0, h - nr] and col0' in [0, w - nc]
// as B2 clamps them, and ridx / cidx in [0, nr) / [0, nc) (the caller's
// contract; the kernel clamps them so a bad index cannot leave the window).
// Values stay u8 (the TPU kernel stored f32; the values are equal).
//
// rBRIEF mode folds in what the TPU function around that kernel computes
// (orbslam3_tpu/ops/brief.py::brief_descriptors): the window start from the
// keypoint's position, the rotation of the 512 pattern points by its angle,
// the picks, the 256 compares (even sample < odd sample) and the LSB-first
// pack, to (K, 32) u8 descriptors.  Its arithmetic is the plain twin's
// (ops/brief.py), operation for operation:
//   - angle * factor is one f32 multiply, then the precise cosf / sinf (not
//     __cosf; or the caller's pinned (cos, sin));
//   - row offset rint(px * sin + py * cos), column offset
//     rint(px * cos - py * sin), each product and the sum rounded on its own
//     (__fmul_rn / __fadd_rn / __fsub_rn: nvcc would contract a * b + c into
//     an FMA, whose single rounding moves an offset that lies within an ulp
//     of a rounding boundary by one pixel);
//   - rint is __float2int_rn, half to even as torch.round and jnp.rint (never
//     roundf, which rounds half away from zero);
//   - the window start is rint(xy) + BRIEF_PAD - PATCH_HALF, clamped as B2
//     clamps it; an offset is clamped into the window, which only a pinned
//     (cos, sin) that is not a rotation can reach.
//
// Bound on the H100: index mode reads 8 B of indices per sample (4 KB per
// keypoint at S = 512), the distinct image bytes its picks touch (~0.36 MB
// at K = 1000 on the mono composite), and writes S bytes: ~1.5 us of HBM
// time at K = 1000, almost all index reads.  rBRIEF mode reads 12 B per
// keypoint (xy, angle), the 4 KB pattern and the picked image bytes and
// writes 32 B: ~0.1 us at K = 1000; its ~4.4 k operations per keypoint take
// less still.  Both are bound by a launch's fixed cost and the latency of
// their dependent loads, not by bytes or issue.
//
// Design, both modes: one warp per keypoint, 8 keypoints per 256-thread
// block, no shared memory and no barrier (a B2 that staged its windows lost
// to plain loads at full occupancy).  Picks go through the read-only path;
// a 37x37 window is 1369 B and stays in L1.
//   - Index mode: lane j takes samples 16j .. 16j + 15 (more samples than
//     512: the next 512, and so on): its indices as four 16-byte loads per
//     plane, 16 picks, one 16-byte store.  Sample counts that are not a
//     multiple of 16, or planes that are not 16-byte aligned, take the
//     scalar form: lane j picks samples j, j + 32, ...
//   - rBRIEF mode: lane j owns descriptor byte j, i.e. pairs 8j .. 8j + 7,
//     i.e. pattern points 16j .. 16j + 15.  It loads its 16 points once
//     (eight 16-byte loads), rotates them, issues its 16 picks before the
//     first compare, packs its 8 bits and stores its byte, so the warp
//     stores the keypoint's 32-byte descriptor.  No index reaches memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16;  // samples one lane picks at once (index mode)

// the BRIEF window of ops/brief.py
constexpr int kBriefPad = 19;
constexpr int kPatchHalf = 18;
constexpr int kBriefWindow = 2 * kPatchHalf + 1;
constexpr int kPatternPoints = 512;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ int lane_of(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// VEC: s % 16 == 0 and ridx, cidx, out 16-byte aligned
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
sample_windows_kernel(const uint8_t* __restrict__ img, int h, int w,
                      const int32_t* __restrict__ row0, const int32_t* __restrict__ col0,
                      const int32_t* __restrict__ ridx, const int32_t* __restrict__ cidx,
                      int k, int s, int nr, int nc, uint8_t* __restrict__ out) {
  const int kp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (kp >= k) return;
  const int lane = threadIdx.x & 31;
  const uint8_t* win = img + size_t(clampi(__ldg(row0 + kp), 0, h - nr)) * w +
                       clampi(__ldg(col0 + kp), 0, w - nc);
  const size_t base = size_t(kp) * s;
  if (VEC) {
    for (int j0 = kChunk * lane; j0 < s; j0 += kChunk * 32) {
      const int4* rp = reinterpret_cast<const int4*>(ridx + base + j0);
      const int4* cp = reinterpret_cast<const int4*>(cidx + base + j0);
      int4 r[kChunk / 4], c[kChunk / 4];
#pragma unroll
      for (int q = 0; q < kChunk / 4; ++q) {
        r[q] = __ldg(rp + q);
        c[q] = __ldg(cp + q);
      }
      uint32_t v[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int rr = clampi(lane_of(r[i / 4], i % 4), 0, nr - 1);
        const int cc = clampi(lane_of(c[i / 4], i % 4), 0, nc - 1);
        v[i] = __ldg(win + rr * w + cc);
      }
      uint4 o;
      o.x = v[0] | (v[1] << 8) | (v[2] << 16) | (v[3] << 24);
      o.y = v[4] | (v[5] << 8) | (v[6] << 16) | (v[7] << 24);
      o.z = v[8] | (v[9] << 8) | (v[10] << 16) | (v[11] << 24);
      o.w = v[12] | (v[13] << 8) | (v[14] << 16) | (v[15] << 24);
      *reinterpret_cast<uint4*>(out + base + j0) = o;
    }
  } else {
    for (int j = lane; j < s; j += 32) {
      const int rr = clampi(__ldg(ridx + base + j), 0, nr - 1);
      const int cc = clampi(__ldg(cidx + base + j), 0, nc - 1);
      out[base + j] = __ldg(win + rr * w + cc);
    }
  }
}

// TRIG: (cos, sin) given per keypoint, else from the angle in degrees
template <bool TRIG>
__global__ void __launch_bounds__(kThreads)
brief_kernel(const uint8_t* __restrict__ img, int h, int w, const float* __restrict__ xy,
             const float* __restrict__ angles, const float* __restrict__ cosv,
             const float* __restrict__ sinv, const float4* __restrict__ pattern, int k,
             float factor, uint8_t* __restrict__ out) {
  const int kp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (kp >= k) return;
  const int lane = threadIdx.x & 31;
  float a, b;  // cos, sin
  if (TRIG) {
    a = __ldg(cosv + kp);
    b = __ldg(sinv + kp);
  } else {
    const float ang = __fmul_rn(__ldg(angles + kp), factor);
    a = cosf(ang);
    b = sinf(ang);
  }
  const int r0 = clampi(__float2int_rn(__ldg(xy + 2 * kp + 1)) + kBriefPad - kPatchHalf, 0,
                        h - kBriefWindow);
  const int c0 = clampi(__float2int_rn(__ldg(xy + 2 * kp)) + kBriefPad - kPatchHalf, 0,
                        w - kBriefWindow);
  const uint8_t* win = img + size_t(r0) * w + c0;
  // this lane's 16 points: px at pattern[0][16 lane ..], py at pattern[1][16 lane ..]
  float4 px[4], py[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    px[q] = __ldg(pattern + 4 * lane + q);
    py[q] = __ldg(pattern + kPatternPoints / 4 + 4 * lane + q);
  }
  uint32_t v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float x = lane_of(px[i / 4], i % 4);
    const float y = lane_of(py[i / 4], i % 4);
    const int dr = __float2int_rn(__fadd_rn(__fmul_rn(x, b), __fmul_rn(y, a)));
    const int dc = __float2int_rn(__fsub_rn(__fmul_rn(x, a), __fmul_rn(y, b)));
    const int rr = clampi(dr + kPatchHalf, 0, kBriefWindow - 1);
    const int cc = clampi(dc + kPatchHalf, 0, kBriefWindow - 1);
    v[i] = __ldg(win + rr * w + cc);
  }
  uint32_t byte = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) byte |= uint32_t(v[2 * i] < v[2 * i + 1]) << i;
  out[size_t(kp) * 32 + lane] = static_cast<uint8_t>(byte);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Index mode.  img: (h, w) u8 with h * w < 2^31; row0, col0: (k,) int32;
// ridx, cidx: (k, s) int32; out: (k, s) u8.  Requires nr <= h and nc <= w.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int sample_windows(const void* img, int h, int w, const void* row0,
                              const void* col0, const void* ridx, const void* cidx, int k,
                              int s, int nr, int nc, void* out, void* stream) {
  if (k == 0 || s == 0) return 0;
  const dim3 grid((k + kWarps - 1) / kWarps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* im = static_cast<const uint8_t*>(img);
  const auto* r0 = static_cast<const int32_t*>(row0);
  const auto* c0 = static_cast<const int32_t*>(col0);
  const auto* ri = static_cast<const int32_t*>(ridx);
  const auto* ci = static_cast<const int32_t*>(cidx);
  auto* o = static_cast<uint8_t*>(out);
  if (s % kChunk == 0 && aligned16(ridx) && aligned16(cidx) && aligned16(out)) {
    sample_windows_kernel<true><<<grid, kThreads, 0, st>>>(im, h, w, r0, c0, ri, ci, k, s, nr, nc, o);
  } else {
    sample_windows_kernel<false><<<grid, kThreads, 0, st>>>(im, h, w, r0, c0, ri, ci, k, s, nr, nc, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// rBRIEF mode.  img: (h, w) u8 sampling composite, h, w >= 37, h * w <
// 2^31; xy: (k, 2) f32 level coordinates (un-bordered); angles: (k,) f32
// degrees, read when cosv is null; cosv, sinv: (k,) f32 pinned trig, or
// both null; pattern: (2, 512) f32, 16-byte aligned; factor: pi / 180 as
// f32; out: (k, 32) u8.  Launches on `stream`; returns cudaGetLastError().
extern "C" int brief_descriptors(const void* img, int h, int w, const void* xy,
                                 const void* angles, const void* cosv, const void* sinv,
                                 const void* pattern, int k, float factor, void* out,
                                 void* stream) {
  if (k == 0) return 0;
  if (!aligned16(pattern)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((k + kWarps - 1) / kWarps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* im = static_cast<const uint8_t*>(img);
  const auto* p = static_cast<const float*>(xy);
  const auto* an = static_cast<const float*>(angles);
  const auto* cv = static_cast<const float*>(cosv);
  const auto* sv = static_cast<const float*>(sinv);
  const auto* pat = static_cast<const float4*>(pattern);
  auto* o = static_cast<uint8_t*>(out);
  if (cosv != nullptr) {
    brief_kernel<true><<<grid, kThreads, 0, st>>>(im, h, w, p, an, cv, sv, pat, k, factor, o);
  } else {
    brief_kernel<false><<<grid, kThreads, 0, st>>>(im, h, w, p, an, cv, sv, pat, k, factor, o);
  }
  return static_cast<int>(cudaGetLastError());
}
