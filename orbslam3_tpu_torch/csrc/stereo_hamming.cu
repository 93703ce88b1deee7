// K2: the stereo left-right Hamming match, and the starts of the SAD strips.
//
// Replaces the XLA ops of orbslam3_tpu/frontend/stereo_frame.py::stereo_match
// (:86-131: the K x K pair masks, hamming_matrix, the argmin, the SAD
// refinement's rounded coordinates, bounds and clipped strip starts), which
// the port ran as torch ops over a (K, K, 16) int32 popcount tensor
// (frontend/stereo_frame.py, `stereo_pairs_plain`).  For left slot i, right
// slot j passes when
//   trunc(vl_i) >= floor(vr_j - 2 s[oct_j]) and <= ceil(vr_j + 2 s[oct_j]),
//   oct_i - 1 <= oct_j <= oct_i + 1, ul_i - max_d <= ur_j <= ul_i,
//   and both slots are valid;
// its distance is the popcount of the XOR of the two 256-bit descriptors,
// and BIG = 1 << 15 where the pair fails.  best_r is the first minimum
// (C-h5), tentative = best_dist < 75 ((TH_HIGH + TH_LOW) / 2).  Then, as the
// twin: sul, svl, sur0 = rint(u * inv_s[oct_i]) (half to even, C-h4; sur0
// from the right slot best_r), in_bounds, and the strip starts clipped into
// the level's block plus the block's origin in the composite.  Every float
// product, sum and difference is one rounded operation, as torch's
// (__fmul_rn / __fadd_rn / __fsub_rn: nvcc would contract a * b - c into an
// FMA); max_d arrives as the f32 value torch forms from the Python double.
//
// Output: an (11, K_l) int32 block, rows best_r, best_dist, tentative, sul,
// svl, sur0, in_bounds, row_l, col_l, row_r, col_r (each row contiguous, so
// the strip gather (B2) takes its starts with no op between).
//
// Bound on the H100: K_l x K_r pair tests (1M at K = 1000), each a handful
// of compares; the popcount (8 XOR + 8 POPC + adds over 32 bytes) only where
// the pair passes (well under 1 % on a frame).  Ops-bound at the __popc rate
// were every pair to pass; in fact bound by the pair tests' instruction rate.
// Design: one warp per left slot, its lanes strided over the right slots;
// the right slots are staged per block in shared memory in tiles of kTile
// (descriptors as two uint4, and per slot the row band's floor / ceil, ur
// and the octave, an invalid slot's octave set so that no octave test
// passes), so any K_r works.  A lane keeps the least (dist << 16 | j) of its
// slots, and a warp min (__reduce_min_sync) gives the first minimum.  A left
// slot that is invalid skips the scan: its row is all BIG (best_r 0).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;  // right slots staged at a time
constexpr int kBig = 1 << 15;
constexpr int kThOrb = 75;
constexpr int kSadW = 5, kSadL = 5;
constexpr int kNoOctave = -(1 << 20);  // an invalid right slot's octave

struct Side {
  const float* xy;       // (K, 2)
  const int32_t* oct;    // (K,)
  const uint8_t* valid;  // (K,) bool
  const uint4* desc;     // (K, 32) u8 as two uint4 a slot
  const int32_t* row_off;  // (L,) the level blocks' origins in the composite
  const int32_t* col_off;
  int k;
};

struct Args {
  Side l, r;
  const float* scale;      // (L,)
  const float* inv_scale;  // (L,)
  const int32_t* level_hw;  // (L, 2)
  float max_d;
  int32_t* out;  // (11, K_l)
};

struct RightSlot {
  float lo, hi, ur;
  int oct;
};

__device__ __forceinline__ int rint_i(float x) { return static_cast<int>(rintf(x)); }

__device__ __forceinline__ int clip(int x, int hi) { return min(max(x, 0), hi); }

__global__ void __launch_bounds__(kThreads) stereo_hamming_kernel(const __grid_constant__ Args a) {
  __shared__ RightSlot slot[kTile];
  __shared__ uint4 desc[kTile][2];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  const bool active = i < a.l.k;
  const int il = active ? i : 0;
  const float ul = a.l.xy[2 * il], vl = a.l.xy[2 * il + 1];
  const int oct_l = a.l.oct[il];
  const bool scan = active && a.l.valid[il];
  const float row = static_cast<float>(static_cast<int>(vl));  // trunc(vL)
  const float u_lo = __fsub_rn(ul, a.max_d);
  uint4 dl0 = make_uint4(0, 0, 0, 0), dl1 = dl0;
  if (scan) {
    dl0 = a.l.desc[2 * il];
    dl1 = a.l.desc[2 * il + 1];
  }
  unsigned best = 0xffffffffu;  // (dist << 16) | j, least first
  for (int t0 = 0; t0 < a.r.k; t0 += kTile) {
    const int n = min(kTile, a.r.k - t0);
    __syncthreads();  // the previous tile is read
    for (int s = threadIdx.x; s < n; s += kThreads) {
      const int j = t0 + s;
      const float vr = a.r.xy[2 * j + 1];
      const int o = a.r.oct[j];
      const float r_r = __fmul_rn(2.0f, a.scale[o]);
      slot[s] = RightSlot{floorf(__fsub_rn(vr, r_r)), ceilf(__fadd_rn(vr, r_r)), a.r.xy[2 * j],
                          a.r.valid[j] ? o : kNoOctave};
      desc[s][0] = a.r.desc[2 * j];
      desc[s][1] = a.r.desc[2 * j + 1];
    }
    __syncthreads();
    if (!scan) continue;
    for (int s = lane; s < n; s += 32) {
      const RightSlot rs = slot[s];
      if (row >= rs.lo && row <= rs.hi && rs.oct >= oct_l - 1 && rs.oct <= oct_l + 1 &&
          rs.ur >= u_lo && rs.ur <= ul) {
        const uint4 d0 = desc[s][0], d1 = desc[s][1];
        const unsigned d = __popc(d0.x ^ dl0.x) + __popc(d0.y ^ dl0.y) + __popc(d0.z ^ dl0.z) +
                           __popc(d0.w ^ dl0.w) + __popc(d1.x ^ dl1.x) + __popc(d1.y ^ dl1.y) +
                           __popc(d1.z ^ dl1.z) + __popc(d1.w ^ dl1.w);
        best = min(best, (d << 16) | static_cast<unsigned>(t0 + s));
      }
    }
  }
  if (!active) return;
  best = __reduce_min_sync(0xffffffffu, best);
  if (lane != 0) return;
  // no pair passed: the row is all BIG and its first index wins
  const int best_r = best == 0xffffffffu ? 0 : static_cast<int>(best & 0xffffu);
  const int best_dist = best == 0xffffffffu ? kBig : static_cast<int>(best >> 16);
  const float inv = a.inv_scale[oct_l];
  const int sul = rint_i(__fmul_rn(ul, inv));
  const int svl = rint_i(__fmul_rn(vl, inv));
  const int sur0 = rint_i(__fmul_rn(a.r.xy[2 * best_r], inv));
  const int lh = a.level_hw[2 * oct_l], lw = a.level_hw[2 * oct_l + 1];
  const bool in_bounds = svl - kSadW >= 0 && svl + kSadW + 1 <= lh && sul - kSadW >= 0 &&
                         sul + kSadW + 1 <= lw && sur0 - kSadL - kSadW >= 0 &&
                         sur0 + kSadL + kSadW + 1 <= lw;
  constexpr int wl = 2 * kSadW + 1, ww = 2 * (kSadL + kSadW) + 1;
  const int cl_svl = clip(svl - kSadW, lh - wl);
  const int kl = a.l.k;
  int32_t* o = a.out + i;
  o[0 * kl] = best_r;
  o[1 * kl] = best_dist;
  o[2 * kl] = best_dist < kThOrb;
  o[3 * kl] = sul;
  o[4 * kl] = svl;
  o[5 * kl] = sur0;
  o[6 * kl] = in_bounds;
  o[7 * kl] = a.l.row_off[oct_l] + cl_svl;
  o[8 * kl] = a.l.col_off[oct_l] + clip(sul - kSadW, lw - wl);
  o[9 * kl] = a.r.row_off[oct_l] + cl_svl;
  o[10 * kl] = a.r.col_off[oct_l] + clip(sur0 - kSadL - kSadW, lw - ww);
}

}  // namespace

// xy (K, 2) f32, oct (K,) int32 in [0, L), valid (K,) bool, desc (K, 32) u8
// 16-byte aligned, for the left (k_l slots) and the right camera (k_r slots,
// at most 65535); scale, inv_scale (L,) f32; level_hw (L, 2) int32; the
// level blocks' origins row_off / col_off (L,) int32 of each camera; out
// (11, k_l) int32.  One launch on `stream`; returns cudaGetLastError().
extern "C" int stereo_hamming(const void* xy_l, const void* oct_l, const void* valid_l,
                              const void* desc_l, const void* row_off_l, const void* col_off_l,
                              int k_l, const void* xy_r, const void* oct_r, const void* valid_r,
                              const void* desc_r, const void* row_off_r, const void* col_off_r,
                              int k_r, const void* scale, const void* inv_scale,
                              const void* level_hw, float max_d, void* out, void* stream) {
  if (k_l < 0 || k_r < 0 || k_r > 0xffff) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(desc_l) | reinterpret_cast<uintptr_t>(desc_r)) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (k_l == 0) return 0;
  Args a{};
  a.l = Side{static_cast<const float*>(xy_l), static_cast<const int32_t*>(oct_l),
             static_cast<const uint8_t*>(valid_l), static_cast<const uint4*>(desc_l),
             static_cast<const int32_t*>(row_off_l), static_cast<const int32_t*>(col_off_l), k_l};
  a.r = Side{static_cast<const float*>(xy_r), static_cast<const int32_t*>(oct_r),
             static_cast<const uint8_t*>(valid_r), static_cast<const uint4*>(desc_r),
             static_cast<const int32_t*>(row_off_r), static_cast<const int32_t*>(col_off_r), k_r};
  a.scale = static_cast<const float*>(scale);
  a.inv_scale = static_cast<const float*>(inv_scale);
  a.level_hw = static_cast<const int32_t*>(level_hw);
  a.max_d = max_d;
  a.out = static_cast<int32_t*>(out);
  stereo_hamming_kernel<<<(k_l + kWarps - 1) / kWarps, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
