"""Check and time the vocabulary-tree walk V1 on the card.

    python -m orbslam3_tpu_torch.tools.bench_vocab_kernel [--reps N]

Builds the kernels of the tree it is run from and holds V1
(``vocab/device_vocabulary.vocab_descend``, ``csrc/vocab_descend.cu``) bit
for bit against its plain twin on the same card tensors, on the trees of
`TREES` (a k=10, depth-6 tree trained on clustered descriptors, whose rows
hold -1 slots between children; `BinaryVocabulary.synthesize` at depth 4
and 6; a tree whose sibling descriptors repeat, so distances tie; a tree
whose first root children end at depth 1, above the feature level) and
the batches of `BATCHES` (0, 1, 1200 and 6000 descriptors near the tree's
words, and batches that end above the feature level).  Then it tracks a
few synthetic stereo frames through a CUDA `System` with the trained tree
and holds each frame's `bow_vec` / `feat_vec` to
`BinaryVocabulary.transform`, and times V1 at a frame's 1200 descriptors
(device time of a CUDA graph of 20 calls, ``utils/device_time.device_ms``)
beside its twin, its bound and the host's numpy transform.  The last line
is a JSON object.  Needs a CUDA card; the CPU tests import the trees and
batches from here.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np
import torch

from orbslam3_tpu_torch.vocab.vocabulary import BinaryVocabulary

FRAME_DESCRIPTORS = 1200  # a EuRoC stereo frame's features
SYSTEM_FRAMES = 8
SHALLOW_SLOTS = 5


def clustered_descriptors(n: int, seed: int = 5, centers: int = 60,
                          flip: float = 0.08) -> np.ndarray:
    """(n, 32) uint8 descriptors around `centers` random ones, each bit
    flipped with probability `flip`."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 256, (centers, 32), dtype=np.uint8)
    bits = np.unpackbits(c[rng.integers(0, centers, n)], axis=1)
    return np.packbits(bits ^ (rng.random(bits.shape) < flip), axis=1)


def _tied() -> BinaryVocabulary:
    """A synthesized k=10, depth-3 tree whose slots 7, 9 and 4 of every row
    hold the descriptors of slots 2, 0 and 3: the lower slot must win."""
    voc = BinaryVocabulary.synthesize(k=10, depth=3, seed=1)
    rows = voc.children[(voc.children >= 0).any(axis=1)]
    for hi, lo in ((7, 2), (9, 0), (4, 3)):
        voc.node_desc[rows[:, hi]] = voc.node_desc[rows[:, lo]]
    return voc


def _shallow() -> BinaryVocabulary:
    """A synthesized k=10, depth-4 tree whose root children in the first
    SHALLOW_SLOTS slots have no children: words at depth 1, above the
    feature level 2."""
    voc = BinaryVocabulary.synthesize(k=10, depth=4, seed=2)
    cut = voc.children[0, :SHALLOW_SLOTS]
    voc.children[cut] = -1
    voc.word_id[cut] = voc.n_words + np.arange(len(cut))
    voc.weights = np.concatenate([voc.weights, np.linspace(0.3, 0.9, len(cut))])
    voc.n_words += len(cut)
    return voc


# name -> how the tree is made (feature level 2 in each)
TREES = {
    "trained": lambda: BinaryVocabulary.train(clustered_descriptors(9600), k=10, depth=6, seed=0),
    "synthesized depth 4": lambda: BinaryVocabulary.synthesize(k=10, depth=4),
    "synthesized depth 6": lambda: BinaryVocabulary.synthesize(k=10, depth=6),
    "tied": _tied,
    "shallow": _shallow,
}


@functools.cache
def tree(name: str) -> BinaryVocabulary:
    """The tree `TREES` names, made once a process."""
    return TREES[name]()


def near_words(voc: BinaryVocabulary, n: int, seed: int = 0, flip: float = 0.05,
               nodes: np.ndarray | None = None, uniform: bool = True) -> np.ndarray:
    """(n, 32) uint8: the descriptors of random words (or of `nodes`), each
    bit flipped with probability `flip`; every tenth one uniform where
    `uniform`."""
    rng = np.random.default_rng(seed)
    if nodes is None:
        nodes = np.nonzero(voc.word_id >= 0)[0]
    bits = np.unpackbits(voc.node_desc[rng.choice(nodes, n)], axis=1)
    out = np.packbits(bits ^ (rng.random(bits.shape) < flip), axis=1)
    if uniform:
        out[::10] = rng.integers(0, 256, (len(out[::10]), 32), dtype=np.uint8)
    return out


def same_vectors(got: tuple, want: tuple) -> bool:
    """Whether two (bow_vec, feat_vec) pairs hold the same keys in the same
    order and the same values, the floats bit for bit."""
    return all(
        [(k, np.float64(v).tobytes() if isinstance(v, float) else v) for k, v in g.items()]
        == [(k, np.float64(v).tobytes() if isinstance(v, float) else v) for k, v in w.items()]
        for g, w in zip(got, want))


# name -> the tree the batch walks
BATCHES = {
    "N=0": "trained", "N=1": "trained", "N=1200": "trained", "N=6000": "trained",
    "every walk above the feature level": "shallow",
    "some walks above the feature level": "shallow",
}


def batch(name: str) -> np.ndarray:
    """The (N, 32) uint8 descriptors of the batch `BATCHES` names."""
    voc = tree(BATCHES[name])
    if name.startswith("N="):
        n = int(name[2:])
        return near_words(voc, n, seed=n)
    above = near_words(voc, 300, seed=3, flip=0.02, nodes=voc.children[0, :SHALLOW_SLOTS],
                       uniform=False)
    if name == "every walk above the feature level":
        return above
    return np.concatenate([above, near_words(voc, 50, seed=7)])


def walk_errs(dev) -> dict:
    """{case: rows of V1 that differ from its twin's} on `dev` (CUDA)."""
    from orbslam3_tpu_torch.vocab.device_vocabulary import (
        DeviceVocabulary, vocab_descend, vocab_descend_plain,
    )

    cases = {f"{name} N={n}": (name, near_words(tree(name), n, seed=n))
             for name in TREES for n in (FRAME_DESCRIPTORS, 6000)}
    cases.update({name: (BATCHES[name], batch(name)) for name in BATCHES})
    errs, held = {}, {}
    for case, (name, desc) in cases.items():
        if name not in held:
            held[name] = DeviceVocabulary(tree(name), dev)
        dv = held[name]
        d = torch.from_numpy(desc).to(dev)
        args = (d, dv.children, dv.node_desc, dv.vocabulary.feat_level, dv.max_steps)
        before = vocab_descend.launches
        got = vocab_descend(*args)
        if desc.shape[0] and vocab_descend.launches != before + 1:
            raise AssertionError(f"{case}: V1's counter did not add one")
        want = vocab_descend_plain(*args)
        errs[case] = int((got != want).any(dim=0).sum())
    return errs


def system_errs(dev, n_frames: int = SYSTEM_FRAMES) -> dict:
    """Tracks `n_frames` synthetic 480x752 stereo frames through a System on
    `dev` with the trained tree: the frames, those whose vectors differ
    from `BinaryVocabulary.transform`'s, the calls of that transform from
    the frame assembly, and V1's launches."""
    from orbslam3_tpu_torch import Pinhole, PyramidParams, stereo_sequence
    from orbslam3_tpu_torch.slam.system import System
    from orbslam3_tpu_torch.vocab.device_vocabulary import vocab_descend

    voc = tree("trained")
    cam = Pinhole([435.2, 435.2, 376.0, 240.0])
    sysm = System(cam, 435.2 * 0.11, PyramidParams(n_features=FRAME_DESCRIPTORS),
                  vocabulary=voc, device=dev)
    frames, in_frame = [], [False]
    host_calls = [0]
    transform, frame_of = voc.transform, sysm._frame

    def counted(desc):
        host_calls[0] += in_frame[0]
        return transform(desc)

    def assembled(*args, **kwargs):
        in_frame[0] = True
        try:
            frames.append(frame_of(*args, **kwargs))
        finally:
            in_frame[0] = False
        return frames[-1]

    voc.transform, sysm._frame = counted, assembled
    before = vocab_descend.launches
    try:
        for k, (left, right, _) in enumerate(
                stereo_sequence(n_frames, cam, 0.11, 480, 752, seed=1)):
            sysm.track_stereo(left, right, k / 20.0)
    finally:
        del voc.transform
        sysm.shutdown()
    differ = sum(not same_vectors((f.bow_vec, f.feat_vec), transform(f.desc)) for f in frames)
    return dict(frames=len(frames), differ=differ, host_transform_calls=host_calls[0],
                launches=vocab_descend.launches - before,
                descriptors=[len(f.desc) for f in frames])


def bound(dv, desc: np.ndarray) -> tuple:
    """(ms, "bytes" or "operations"): the least time of V1's walk of `desc`
    on the H100: the descriptors in and the two rows out, and once each the
    children row and the child descriptors of every node a walk reached;
    8 __popc of each child slot looked at, at the __popc rate."""
    from orbslam3_tpu_torch.utils.device_time import POPC_OPS_PER_S, bound_ms
    from orbslam3_tpu_torch.vocab.device_vocabulary import vocab_descend_plain

    voc = dv.vocabulary
    children = voc.children
    d = torch.from_numpy(desc)
    end = vocab_descend_plain(d, torch.from_numpy(children), torch.from_numpy(voc.node_desc),
                              voc.feat_level, dv.max_steps)[0].numpy()
    parent = np.full(len(children), -1, np.int64)
    rows, slots = np.nonzero(children >= 0)
    parent[children[rows, slots]] = rows
    reached, looked = set(end.tolist()), 0  # the slots the walks looked at
    for node in end.tolist():
        while (node := int(parent[node])) >= 0:
            reached.add(node)
            looked += int((children[node] >= 0).sum())
    reached = np.fromiter(reached, np.int64)
    n_bytes = desc.nbytes + 2 * 4 * len(desc) + reached.size * children.shape[1] * 4 \
        + 32 * int((children[reached] >= 0).sum())
    return bound_ms(n_bytes, 8 * looked, POPC_OPS_PER_S)


def time_kernel(dev, reps: int = 1) -> dict:
    """V1 at a frame's 1200 descriptors on the trained tree: device ms a
    call of the kernel and of its twin (medians over `reps` runs), the
    bound, and the host's numpy transform in ms (median of 20 calls)."""
    from orbslam3_tpu_torch.utils.device_time import device_ms
    from orbslam3_tpu_torch.vocab.device_vocabulary import (
        DeviceVocabulary, vocab_descend, vocab_descend_plain,
    )

    voc = tree("trained")
    dv = DeviceVocabulary(voc, dev)
    desc = near_words(voc, FRAME_DESCRIPTORS, seed=11)
    args = (torch.from_numpy(desc).to(dev), dv.children, dv.node_desc, voc.feat_level,
            dv.max_steps)

    def med(fn):
        return float(np.median([device_ms(fn) for _ in range(reps)]))

    def host_ms(fn):
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn(desc)
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    b, by = bound(dv, desc)
    return dict(ms=med(lambda: vocab_descend(*args)), plain_ms=med(lambda: vocab_descend_plain(*args)),
                bound_ms=b, bound_by=by, library_ms=None, host_transform_ms=host_ms(voc.transform),
                device_transform_ms=host_ms(dv.transform))


def main(argv=None) -> int:
    from orbslam3_tpu_torch.tools.card import open_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if open_device("bench_vocab_kernel", "cuda") is None:
        return 1
    dev = torch.device("cuda")
    errs = walk_errs(dev)
    print(f"walks: {errs}", flush=True)
    system = system_errs(dev)
    print(f"system: {system}", flush=True)
    times = time_kernel(dev, args.reps)
    print(f"vocab_descend: {times}", flush=True)
    ok = not any(errs.values()) and system["differ"] == 0 and system["host_transform_calls"] == 0 \
        and system["launches"] == system["frames"]
    print(json.dumps(dict(walks=errs, system=system, times=times, ok=ok)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
