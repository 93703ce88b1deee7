"""Atlas checkpoint/resume: save and load the whole multi-map state.

Role-parity with System::SaveAtlas/LoadAtlas (ORB_SLAM3/src/
System.cc:1348,1380): serialize the Atlas object graph (maps, keyframes,
map points, cameras, id counters) with an MD5 checksum of the vocabulary
stored alongside (CalculateCheckSum, System.cc:1438) so a reload with a
different vocabulary is rejected; PostLoad rebuilds the keyframe-database
inverted file and transient state.
"""

from __future__ import annotations

import hashlib
import pickle

import numpy as np


def vocabulary_checksum(voc) -> str:
    h = hashlib.md5()
    for arr in (voc.children, voc.node_desc, voc.word_id, voc.weights):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


class _PortUnpickler(pickle.Unpickler):
    """Loads the classes of an atlas saved by either package from this one:
    ``orbslam3_tpu.<mod>`` is read as ``orbslam3_tpu_torch.<mod>``, so a
    reference atlas never imports the reference package."""

    def find_class(self, module: str, name: str):
        if module == "orbslam3_tpu" or module.startswith("orbslam3_tpu."):
            module = "orbslam3_tpu_torch" + module[len("orbslam3_tpu"):]
        return super().find_class(module, name)


def save_atlas(path: str, atlas, vocabulary=None):
    from orbslam3_tpu_torch.slam.frame import Frame
    from orbslam3_tpu_torch.slam.keyframe import KeyFrame
    from orbslam3_tpu_torch.slam.map import Map
    from orbslam3_tpu_torch.slam.map_point import MapPoint

    payload = {
        "atlas": atlas,
        "voc_checksum": vocabulary_checksum(vocabulary) if vocabulary else None,
        "id_counters": {
            "frame": Frame._next_id,
            "keyframe": KeyFrame._next_id,
            "map_point": MapPoint._next_id,
            "map": Map._next_id,
        },
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_atlas(path: str, vocabulary=None, kf_database=None):
    from orbslam3_tpu_torch.slam.frame import Frame
    from orbslam3_tpu_torch.slam.keyframe import KeyFrame
    from orbslam3_tpu_torch.slam.map import Map
    from orbslam3_tpu_torch.slam.map_point import MapPoint

    with open(path, "rb") as f:
        payload = _PortUnpickler(f).load()
    if vocabulary is not None and payload["voc_checksum"] is not None:
        if vocabulary_checksum(vocabulary) != payload["voc_checksum"]:
            raise ValueError(
                "vocabulary checksum mismatch: atlas was saved with a "
                "different vocabulary (System::LoadAtlas guard)"
            )
    c = payload["id_counters"]
    Frame._next_id = max(Frame._next_id, c["frame"])
    KeyFrame._next_id = max(KeyFrame._next_id, c["keyframe"])
    MapPoint._next_id = max(MapPoint._next_id, c["map_point"])
    Map._next_id = max(Map._next_id, c["map"])
    atlas = payload["atlas"]
    # PostLoad: rebuild the inverted file
    if kf_database is not None:
        kf_database.clear()
        for m in atlas.get_all_maps():
            for kf in m.get_all_keyframes():
                if kf.bow_vec is not None:
                    kf_database.add(kf)
    return atlas
