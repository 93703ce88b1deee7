"""The bag-of-words transform with the vocabulary tree's walk on the card.

`BinaryVocabulary.transform` (``vocab/vocabulary.py``) walks the tree for a
frame's descriptors in numpy, level by level, then builds the frame's two
vectors.  `DeviceVocabulary` returns the same ``(bow_vec, feat_vec)``: it
holds the tree on its device, walks it there with V1
(``csrc/vocab_descend.cu``, `vocab_descend`: one launch a call), and builds
the vectors on the host from the two node rows that come back, with
`transform`'s own code (`_vectors`).  On the CPU `vocab_descend` runs its
plain twin, `vocab_descend_plain`, the walk in torch integer ops.

The walk per descriptor (both versions): from the root, move to the child
slot of least Hamming distance, skipping slots that hold -1, the lowest
slot taking a tie (C-h5); stop at a node with no children or after
``depth + 1`` steps.  Row 0 is the node each walk ends at, row 1 the node
it passed at ``feat_level``, or -1 where the walk ended above that level.
`transform` copies its feature nodes only if its level loop has not broken
off before ``feat_level``, which it does once no walk goes on: so when no
walk of the batch reaches the level every feature node stays the root,
and otherwise a walk that ended above the level has its end node there.
`_feature_nodes` applies that rule to row 1.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch._device import stream_handle

# a distance no slot reaches (256 at most): an empty slot's
_EMPTY = 1 << 20


def _popcount8(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of bytes held in int32."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def vocab_descend_plain(
    desc: torch.Tensor, children: torch.Tensor, node_desc: torch.Tensor, feat_level: int,
    max_steps: int,
) -> torch.Tensor:
    """Plain twin of V1: the (2, N) int32 node rows of the walk of the
    (N, 32) uint8 descriptors `desc` down the tree (`children` (M, k), -1
    for an empty slot; `node_desc` (M, 32) uint8)."""
    n, k = desc.shape[0], children.shape[1]
    dev = desc.device
    children = children.to(torch.int64)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    feat = torch.full((n,), -1, dtype=torch.int64, device=dev)
    going = torch.ones(n, dtype=torch.bool, device=dev)
    slots = torch.arange(k, device=dev)
    for step in range(max_steps):
        if step == feat_level:
            feat = torch.where(going, cur, feat)
        ch = children[cur]                                      # (N, k)
        xor = node_desc[ch.clamp(min=0)] ^ desc[:, None, :]     # (N, k, 32)
        dist = _popcount8(xor.to(torch.int32)).sum(dim=-1)
        dist = torch.where(ch >= 0, dist, _EMPTY)
        # least (distance, slot): the first minimum
        best = (dist * k + slots).argmin(dim=1)
        going = going & (ch >= 0).any(dim=1)
        cur = torch.where(going, ch.gather(1, best[:, None])[:, 0], cur)
    return torch.stack([cur, feat]).to(torch.int32)


def vocab_descend(
    desc: torch.Tensor, children: torch.Tensor, node_desc: torch.Tensor, feat_level: int,
    max_steps: int, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """The (2, N) int32 node rows of `vocab_descend_plain`, written into
    `out` (2, N) int32 when given.  CUDA tensors: one launch of V1
    (``csrc/vocab_descend.cu``); CPU tensors: the plain twin."""
    dev = desc.device
    if any(t.device != dev for t in (children, node_desc)):
        raise ValueError("descriptors and tree must lie on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    n = desc.shape[0]
    if desc.dtype != torch.uint8 or node_desc.dtype != torch.uint8 or desc.shape[1:] != (32,) \
            or node_desc.shape[1:] != (32,) or children.dim() != 2:
        raise TypeError("descriptors must be (N, 32) and (M, 32) uint8, children (M, k)")
    if out is None:
        out = torch.empty((2, n), dtype=torch.int32, device=dev)
    elif out.shape != (2, n) or out.dtype != torch.int32 or not out.is_contiguous() \
            or out.device != dev:
        raise ValueError("out must be a contiguous (2, N) int32 tensor on the descriptors' device")
    if dev.type == "cpu":
        out.copy_(vocab_descend_plain(desc, children, node_desc, feat_level, max_steps))
        return out
    if children.dtype != torch.int32 or not (desc.is_contiguous() and children.is_contiguous()
                                             and node_desc.is_contiguous()):
        raise TypeError("V1 takes contiguous tensors and int32 children")
    err = _build.kernels().vocab_descend(
        desc.data_ptr(), n, children.data_ptr(), node_desc.data_ptr(), children.shape[1],
        feat_level, max_steps, out.data_ptr(), stream_handle(out),
    )
    vocab_descend.launches += 1
    _build.check_launch("vocab_descend", err)
    return out


vocab_descend.launches = 0


def _feature_nodes(end: np.ndarray, feat: np.ndarray) -> np.ndarray:
    """`transform`'s feature node of each descriptor from the walk's rows:
    the root for all when no walk reached the feature level, else the node
    at that level, or the end node of a walk that ended above it."""
    reached = feat >= 0
    if not reached.any():
        return np.zeros(len(end), np.int64)
    return np.where(reached, feat, end).astype(np.int64)


def _vectors(voc, cur: np.ndarray, feat_node: np.ndarray):
    """(bow_vec, feat_vec) of the walk's end nodes `cur` and feature nodes
    `feat_node`: `BinaryVocabulary.transform`'s code after its walk."""
    n = len(cur)
    words = voc.word_id[cur]
    # bow: per-word summed idf weight, L1-normalized (vectorized)
    wv = words[words >= 0]
    bow: dict[int, float] = {}
    if len(wv):
        uw, cnt = np.unique(wv, return_counts=True)
        wts = voc.weights[uw] * cnt
        keep = voc.weights[uw] > 0
        s = wts[keep].sum()
        if s > 0:
            bow = dict(
                zip(uw[keep].tolist(), (wts[keep] / s).tolist())
            )
    # feat: node-at-feat-level -> ascending descriptor indices
    order = np.argsort(feat_node, kind="stable")
    fn = feat_node[order]
    bounds = np.nonzero(np.diff(fn))[0] + 1
    feat = {
        int(fn[s0]): order[s0:s1].tolist()
        for s0, s1 in zip(
            np.concatenate([[0], bounds]),
            np.concatenate([bounds, [n]]),
        )
    }
    return bow, feat


class DeviceVocabulary:
    """`vocabulary.transform` with the tree's walk on `device`: the tree is
    uploaded once, here; a call stages the descriptors in a reused host
    buffer (pinned on CUDA), uploads them, launches V1 on the current
    stream, copies the two node rows back and waits once."""

    def __init__(self, vocabulary, device: str | torch.device):
        if len(vocabulary.children) >= 2**31:
            raise ValueError("V1 indexes nodes with int32")
        self.vocabulary = vocabulary
        self.device = torch.device(device)
        self.max_steps = vocabulary.depth + 1
        self.children = torch.from_numpy(np.ascontiguousarray(vocabulary.children, np.int32)).to(
            self.device)
        self.node_desc = torch.from_numpy(
            np.ascontiguousarray(vocabulary.node_desc, np.uint8)).to(self.device)
        self._capacity = 0

    def _buffers(self, n: int):
        """(host descriptors, device descriptors, device rows, host rows),
        grown to hold `n` descriptors; the rows flat, 2 x capacity."""
        if n > self._capacity:
            self._capacity = max(n, 2 * self._capacity, 1024)
            pin = self.device.type == "cuda"
            c = self._capacity
            self._host_desc = torch.empty((c, 32), dtype=torch.uint8, pin_memory=pin)
            self._host_rows = torch.empty(2 * c, dtype=torch.int32, pin_memory=pin)
            self._dev_desc = torch.empty((c, 32), dtype=torch.uint8, device=self.device)
            self._dev_rows = torch.empty(2 * c, dtype=torch.int32, device=self.device)
        return self._host_desc, self._dev_desc, self._dev_rows, self._host_rows

    def transform(self, descriptors: np.ndarray):
        """(N, 32) uint8 -> (bow_vec, feat_vec), equal to
        `self.vocabulary.transform(descriptors)`."""
        n = len(descriptors)
        if n == 0:
            return {}, {}
        host_desc, dev_desc, dev_rows, host_rows = self._buffers(n)
        host_desc[:n].numpy()[...] = descriptors
        dev_desc[:n].copy_(host_desc[:n], non_blocking=True)
        rows = dev_rows[: 2 * n].view(2, n)
        vocab_descend(dev_desc[:n], self.children, self.node_desc, self.vocabulary.feat_level,
                      self.max_steps, out=rows)
        host_rows[: 2 * n].copy_(dev_rows[: 2 * n], non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        walk = host_rows[: 2 * n].numpy().reshape(2, n)
        cur = walk[0].astype(np.int64)
        return _vectors(self.vocabulary, cur, _feature_nodes(cur, walk[1]))
