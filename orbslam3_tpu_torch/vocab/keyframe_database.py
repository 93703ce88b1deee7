"""Keyframe database: inverted file over vocabulary words.

Role-parity with ORB_SLAM3/include/KeyFrameDatabase.h:47 /
src/KeyFrameDatabase.cc (857 LoC): word -> keyframe inverted index
(mvInvertedFile, KeyFrameDatabase.h:91), with the three query flavours —
DetectLoopCandidates (min-score gated), DetectNBestCandidates (loop+merge,
top-N by covisibility-group accumulated score), and
DetectRelocalizationCandidates (:71-79).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


class KeyFrameDatabase:
    def __init__(self, vocabulary):
        self.voc = vocabulary
        self.inverted: dict[int, list] = defaultdict(list)
        # parallel numpy posting buffers of KF ids (amortized-doubling
        # growable) + id registry: shared-word counting runs as one
        # np.concatenate + np.unique over zero-copy slices instead of a
        # Python dict walk (at the reference's 1M-word / >1k-KF scale the
        # walk was ~65 ms/query and per-word list->array conversion another
        # ~45 ms; reference measures 7.15 ms, ExecMean.txt:39)
        self._ids: dict[int, np.ndarray] = {}
        self._n: dict[int, int] = {}
        self._by_id: dict = {}

    def _append_id(self, w: int, kid: int):
        buf = self._ids.get(w)
        n = self._n.get(w, 0)
        if buf is None:
            buf = np.empty(4, np.int64)
            self._ids[w] = buf
        elif n == len(buf):
            buf = np.resize(buf, 2 * n)
            self._ids[w] = buf
        buf[n] = kid
        self._n[w] = n + 1

    def add(self, kf):
        if kf.bow_vec is None:
            kf.bow_vec, kf.feat_vec = self.voc.transform(kf.desc)
        for w in kf.bow_vec:
            self.inverted[w].append(kf)
            self._append_id(w, kf.id)
        self._by_id[kf.id] = kf

    def erase(self, kf):
        if kf.bow_vec is None:
            return
        for w in kf.bow_vec:
            lst = self.inverted.get(w)
            if lst and kf in lst:
                lst.remove(kf)
                buf, n = self._ids[w], self._n[w]
                keep = buf[:n][buf[:n] != kf.id]
                buf[: len(keep)] = keep
                self._n[w] = len(keep)
        self._by_id.pop(kf.id, None)

    def clear(self):
        self.inverted.clear()
        self._ids.clear()
        self._n.clear()
        self._by_id.clear()

    # ------------------------------------------------------------------
    def _shared_word_kfs(self, bow_vec: dict, exclude: set) -> dict:
        get_buf, get_n = self._ids.get, self._n.get
        arrs = []
        for w in bow_vec:
            buf = get_buf(w)
            if buf is not None:
                n = get_n(w, 0)
                if n:
                    arrs.append(buf[:n])
        if not arrs:
            return {}
        uid, cnt = np.unique(np.concatenate(arrs), return_counts=True)
        by = self._by_id
        counts: dict = {}
        for i, c in zip(uid.tolist(), cnt.tolist()):
            kf = by.get(i)
            if kf is None or kf.bad or kf in exclude:
                continue
            counts[kf] = c
        return counts

    def detect_loop_candidates(self, kf, min_score: float) -> list:
        """KFs outside kf's covisibility group with BoW score >= min_score,
        grouped by covisibility, accumulated-score gated (KeyFrameDatabase
        ::DetectLoopCandidates semantics)."""
        connected = set(kf.get_connected_keyframes())
        counts = self._shared_word_kfs(kf.bow_vec, connected | {kf})
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = int(0.8 * max_common)
        scored = []
        for cand, c in counts.items():
            if c > min_common:
                s = self.voc.score(kf.bow_vec, cand.bow_vec)
                cand.loop_score = s
                if s >= min_score:
                    scored.append((s, cand))
        if not scored:
            return []
        best_acc = min_score
        groups = []
        for s, cand in scored:
            acc = s
            best_in_group, best_s = cand, s
            for nb in cand.get_best_covisibility_keyframes(10):
                if nb in counts and counts[nb] > min_common:
                    sn = getattr(nb, "loop_score", 0.0)
                    acc += sn
                    if sn > best_s:
                        best_in_group, best_s = nb, sn
            groups.append((acc, best_in_group))
            best_acc = max(best_acc, acc)
        th = 0.75 * best_acc
        out, seen = [], set()
        for acc, cand in groups:
            if acc > th and cand not in seen:
                seen.add(cand)
                out.append(cand)
        return out

    def detect_n_best_candidates(self, kf, n: int = 3) -> list:
        """Top-n candidates by covisibility-group accumulated score,
        excluding kf's own covisibles (DetectNBestCandidates, used by
        place recognition for loop + merge, KeyFrameDatabase.h:76)."""
        connected = set(kf.get_connected_keyframes())
        counts = self._shared_word_kfs(kf.bow_vec, connected | {kf})
        if not counts:
            return []
        scored = []
        for cand, c in counts.items():
            s = self.voc.score(kf.bow_vec, cand.bow_vec)
            cand.pr_score = s
            scored.append((s, cand))
        groups = []
        for s, cand in scored:
            acc, best_in_group, best_s = s, cand, s
            for nb in cand.get_best_covisibility_keyframes(10):
                if nb in counts:
                    sn = getattr(nb, "pr_score", 0.0)
                    acc += sn
                    if sn > best_s:
                        best_in_group, best_s = nb, sn
            groups.append((acc, best_in_group))
        groups.sort(key=lambda t: -t[0])
        out, seen = [], set()
        for acc, cand in groups:
            if cand not in seen:
                seen.add(cand)
                out.append(cand)
            if len(out) >= n:
                break
        return out

    def detect_relocalization_candidates(self, frame) -> list:
        """Candidates for relocalizing a lost frame
        (DetectRelocalizationCandidates semantics)."""
        counts = self._shared_word_kfs(frame.bow_vec, set())
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = int(0.8 * max_common)
        scored = []
        for cand, c in counts.items():
            if c > min_common:
                s = self.voc.score(frame.bow_vec, cand.bow_vec)
                cand.reloc_score = s
                scored.append((s, cand))
        if not scored:
            return []
        groups = []
        best_acc = 0.0
        for s, cand in scored:
            acc, best_in_group, best_s = s, cand, s
            for nb in cand.get_best_covisibility_keyframes(10):
                if nb in counts and counts[nb] > min_common:
                    sn = getattr(nb, "reloc_score", 0.0)
                    acc += sn
                    if sn > best_s:
                        best_in_group, best_s = nb, sn
            groups.append((acc, best_in_group))
            best_acc = max(best_acc, acc)
        th = 0.75 * best_acc
        out, seen = [], set()
        for acc, cand in groups:
            if acc > th and cand not in seen:
                seen.add(cand)
                out.append(cand)
        return out
