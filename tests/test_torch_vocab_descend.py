"""The vocabulary tree's walk on the card (V1, ``csrc/vocab_descend.cu``).

CPU: V1's plain twin (`vocab/device_vocabulary.vocab_descend_plain`) and
`DeviceVocabulary` held to `BinaryVocabulary.transform` on the trees and
batches of `tools/bench_vocab_kernel.py`: the twin's end node of each walk
equals the one `transform` reaches, its feature nodes (after the
batch-wide rule) equal the ones `transform` files each descriptor under,
and the device vocabulary's `(bow_vec, feat_vec)` equal `transform`'s, the
same keys in the same order and the floats bit for bit.  A CPU `System`
still calls `BinaryVocabulary.transform` from its frame assembly.

The `cuda` tests hold V1 to its twin on the card, count its launches, and
track synthetic stereo frames through a CUDA `System` whose stored vectors
must equal `transform`'s.  On the chip (no JAX there):
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_vocab_descend.py -q``.
"""

import numpy as np
import pytest
import torch

from orbslam3_tpu_torch.tools import bench_vocab_kernel as bvk
from orbslam3_tpu_torch.vocab.device_vocabulary import (
    DeviceVocabulary,
    _feature_nodes,
    vocab_descend,
)
from orbslam3_tpu_torch.vocab.vocabulary import BinaryVocabulary


def _transform_walk(voc, desc):
    """(end node, feature node) of each descriptor as `voc.transform` walks:
    the end node from a copy of the tree whose every node is a word of
    weight 1, one descriptor a call; the feature nodes from the batch's
    feat_vec."""
    probe = BinaryVocabulary(voc.k, voc.depth, voc.feat_level)
    probe.children, probe.node_desc = voc.children, voc.node_desc
    probe.word_id = np.arange(len(voc.children))
    probe.weights = np.ones(len(voc.children))
    end = np.array([next(iter(probe.transform(d[None])[0])) for d in desc], np.int64)
    feat = np.full(len(desc), -1, np.int64)
    for node, idx in voc.transform(desc)[1].items():
        feat[idx] = node
    return end, feat


def _check(voc, desc):
    """The twin's rows and the device vocabulary's vectors against
    `voc.transform`; returns the twin's rows."""
    dv = DeviceVocabulary(voc, "cpu")
    before = vocab_descend.launches
    rows = vocab_descend(torch.from_numpy(desc), dv.children, dv.node_desc, voc.feat_level,
                         dv.max_steps).numpy()
    assert vocab_descend.launches == before  # the CPU takes the twin
    assert rows.shape == (2, len(desc)) and rows.dtype == np.int32
    end, feat = _transform_walk(voc, desc)
    assert np.array_equal(rows[0], end)
    assert np.array_equal(_feature_nodes(rows[0], rows[1]), feat)
    assert bvk.same_vectors(dv.transform(desc), voc.transform(desc))
    return rows


@pytest.mark.parametrize("name", ["trained", "synthesized depth 4", "tied", "shallow"])
def test_the_walk_and_the_vectors_equal_transform_on_each_tree(name):
    voc = bvk.tree(name)
    desc = bvk.near_words(voc, bvk.FRAME_DESCRIPTORS, seed=21)
    rows = _check(voc, desc)
    ch = voc.children
    if name == "trained":  # empty slots between children, as training leaves them
        valid = ch >= 0
        last = np.where(valid, np.arange(voc.k), -1).max(axis=1)
        assert (~valid & (np.arange(voc.k) < last[:, None])).any()
    if name == "tied":  # real ties at the root, and the lower slot took them
        d = np.bitwise_count(voc.node_desc[ch[0]][None] ^ desc[:, None]).sum(axis=-1)
        tied = (d[:, 2] == d[:, 7]) & (d[:, 2] == d.min(axis=1))
        assert tied.sum() > 10
        parent = {int(c): r for r, row in enumerate(ch) for c in row if c >= 0}
        first = []
        for node in rows[0][tied]:  # the root child on the way to each end node
            while parent[node] != 0:
                node = parent[node]
            first.append(node)
        assert (np.array(first) == ch[0, 2]).all()
    if name == "shallow":  # walks of both depths in one batch
        assert (rows[1] < 0).any() and (rows[1] >= 0).any()


@pytest.mark.parametrize("batch", list(bvk.BATCHES))
def test_the_walk_and_the_vectors_equal_transform_on_each_batch(batch):
    voc, desc = bvk.tree(bvk.BATCHES[batch]), bvk.batch(batch)
    rows = _check(voc, desc)
    if batch == "every walk above the feature level":
        # transform's level loop ends before the feature level: every
        # descriptor stays filed under the root
        assert (rows[1] < 0).all() and (rows[0] != 0).all()
        assert list(voc.transform(desc)[1]) == [0]
    if batch == "some walks above the feature level":
        assert (rows[1] < 0).any() and (rows[1] >= 0).any()


def test_the_wrapper_refuses_other_devices_and_shapes():
    voc = bvk.tree("synthesized depth 4")
    dv = DeviceVocabulary(voc, "cpu")
    desc = torch.from_numpy(bvk.near_words(voc, 8))
    with pytest.raises(ValueError):
        vocab_descend(desc.to("meta"), dv.children.to("meta"), dv.node_desc.to("meta"), 2, 5)
    with pytest.raises(ValueError):
        vocab_descend(desc, dv.children.to("meta"), dv.node_desc, 2, 5)
    with pytest.raises(TypeError):
        vocab_descend(desc[:, :16], dv.children, dv.node_desc, 2, 5)
    with pytest.raises(ValueError):
        vocab_descend(desc, dv.children, dv.node_desc, 2, 5,
                      out=torch.empty((2, 7), dtype=torch.int32))


def test_a_cpu_system_keeps_the_host_transform(monkeypatch):
    from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams
    from orbslam3_tpu_torch.slam.system import System
    from orbslam3_tpu_torch.tools import profile_host as ph

    pts, descs, rng = ph._world()
    voc = BinaryVocabulary.train(descs[:3000], k=4, depth=3, seed=0)
    sysm = System(ph.CAM, ph.MBF, PyramidParams(n_features=800), vocabulary=voc, device="cpu")
    assert sysm.device_vocabulary is None
    seen = []
    transform = voc.transform

    def spy(desc):
        seen.append(desc)
        return transform(desc)

    monkeypatch.setattr(voc, "transform", spy)
    before = vocab_descend.launches
    try:
        sysm.track_stereo_features(ph._feats_at(pts, descs, rng, ph._pose(0)), 0.0,
                                   (0, 0, ph.W, ph.H))
    finally:
        sysm.shutdown()
    frame = sysm.tracker.current
    assert len(seen) >= 1 and seen[0] is frame.desc
    assert bvk.same_vectors((frame.bow_vec, frame.feat_vec), transform(frame.desc))
    assert vocab_descend.launches == before


@pytest.mark.cuda
def test_v1_equals_its_twin_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    errs = bvk.walk_errs(torch.device("cuda"))  # raises unless each launch counts one
    assert {"trained N=1200", "trained N=6000", "synthesized depth 6 N=1200",
            "synthesized depth 6 N=6000"} <= set(errs)
    assert not any(errs.values()), errs


@pytest.mark.cuda
def test_a_cuda_system_stores_the_transform_vectors():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = bvk.system_errs(torch.device("cuda"))
    assert got["frames"] == bvk.SYSTEM_FRAMES and min(got["descriptors"]) > 0, got
    assert got["differ"] == 0 and got["host_transform_calls"] == 0, got
    assert got["launches"] == got["frames"], got
