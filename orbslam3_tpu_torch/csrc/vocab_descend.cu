// V1: the bag-of-words vocabulary tree's descent for a batch of descriptors.
//
// Replaces no TPU kernel: the JAX package's `BinaryVocabulary.transform`
// (orbslam3_tpu/vocab/vocabulary.py:120) walks the tree in numpy on the
// host, level by level.  On every tracked frame that walk was the largest
// host stage of the port's frame assembly, so the walk moved onto the card
// and the host keeps only the building of the two vectors
// (vocab/device_vocabulary.py, whose `vocab_descend_plain` is the twin).
//
// For each descriptor the walk starts at the root (node 0) and takes up to
// max_steps steps.  A step looks at the current node's k child slots, skips
// a slot that holds -1 (such a slot can sit in the middle of a trained
// row), and moves to the child whose descriptor is nearest in Hamming
// distance, the lowest slot taking a tie (the first minimum of numpy's
// argmin, C-h5).  A node with no child ends the walk.  A walk that is
// still going at step feat_level keeps its node there as its feature node.
// Output: a (2, N) int32 block, row 0 the node where each walk ends, row 1
// the node it passed at feat_level, -1 where it ended above that level (or
// feat_level lies outside [0, max_steps)).  The host turns row 1 into
// `transform`'s feature nodes, whose batch-wide rule needs to know which
// walks reached the level.
//
// Bound on the H100: tiny work (1200 descriptors x <= 7 levels x 10 slots x
// 32 bytes, ~2.3 MB of L2 reads) in a chain of dependent loads: a level
// reads a child id, then that child's descriptor, then reduces over the
// slots before the next level can start.  So latency of the L2 (the tree
// is a few MB at most and stays there), not bytes or ops, bounds it.
// Design: a group of 16 lanes a descriptor, a lane a child slot (a lane
// takes slots lane, lane + 16, ... when k > 16), so a level's loads issue
// in one round per group; the descriptor sits in registers as two uint4;
// each lane computes 8 __popc of the XOR (K2's core) and keeps the least
// (dist << 16 | slot) of its slots with its child; a group min by
// __shfl_xor_sync gives the first minimum in one integer, and the winning
// slot's lane hands its child over with one __shfl_sync.  Every lane runs
// all max_steps levels (a finished walk loads nothing), so the shuffles
// always see the whole warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 16;  // lanes a descriptor
constexpr int kThreads = 256;
constexpr int kPerBlock = kThreads / kGroup;
constexpr unsigned kNone = 0xffffffffu;  // no child in the slots

__global__ void __launch_bounds__(kThreads)
    vocab_descend_kernel(const uint4* __restrict__ desc, int n, const int32_t* __restrict__ children,
                         const uint4* __restrict__ node_desc, int k, int feat_level, int max_steps,
                         int32_t* __restrict__ out) {
  const int lane = threadIdx.x % kGroup;
  const int i = blockIdx.x * kPerBlock + threadIdx.x / kGroup;
  const bool active = i < n;
  uint4 d0 = make_uint4(0, 0, 0, 0), d1 = d0;
  if (active) {
    d0 = __ldg(desc + 2 * i);
    d1 = __ldg(desc + 2 * i + 1);
  }
  int cur = 0, feat = -1;
  bool done = !active;
  for (int step = 0; step < max_steps; ++step) {
    if (step == feat_level && !done) feat = cur;
    unsigned best = kNone;
    int best_child = 0;
    if (!done) {
      const int32_t* row = children + static_cast<size_t>(cur) * k;
      for (int s = lane; s < k; s += kGroup) {
        const int c = __ldg(row + s);
        if (c < 0) continue;
        const uint4 a = __ldg(node_desc + 2 * static_cast<size_t>(c));
        const uint4 b = __ldg(node_desc + 2 * static_cast<size_t>(c) + 1);
        const unsigned dist = __popc(a.x ^ d0.x) + __popc(a.y ^ d0.y) + __popc(a.z ^ d0.z) +
                              __popc(a.w ^ d0.w) + __popc(b.x ^ d1.x) + __popc(b.y ^ d1.y) +
                              __popc(b.z ^ d1.z) + __popc(b.w ^ d1.w);
        const unsigned key = (dist << 16) | static_cast<unsigned>(s);
        if (key < best) {
          best = key;
          best_child = c;
        }
      }
    }
    unsigned m = best;
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    // the lane that holds the winning slot holds its child too: a slot's
    // key is unique, so the group's least is that lane's own least
    const int next = __shfl_sync(0xffffffffu, best_child, static_cast<int>(m & 0xffffu) % kGroup,
                                 kGroup);
    if (m == kNone) {
      done = true;
    } else {
      cur = next;
    }
  }
  if (active && lane == 0) {
    out[i] = cur;
    out[n + i] = feat;
  }
}

}  // namespace

// desc (n, 32) u8 and node_desc (n_nodes, 32) u8, each 16-byte aligned;
// children (n_nodes, k) int32, -1 for an empty slot, 1 <= k <= 65535; out
// (2, n) int32.  One launch on `stream`; returns cudaGetLastError().
extern "C" int vocab_descend(const void* desc, int n, const void* children, const void* node_desc,
                             int k, int feat_level, int max_steps, void* out, void* stream) {
  if (n < 0 || k < 1 || k > 0xffff) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(desc) | reinterpret_cast<uintptr_t>(node_desc)) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n == 0) return 0;
  vocab_descend_kernel<<<(n + kPerBlock - 1) / kPerBlock, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(desc), n, static_cast<const int32_t*>(children),
      static_cast<const uint4*>(node_desc), k, feat_level, max_steps, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
