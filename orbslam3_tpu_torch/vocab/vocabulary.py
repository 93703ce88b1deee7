"""Binary bag-of-words vocabulary (DBoW2 TemplatedVocabulary<FORB> analog).

Role-parity with ORB_SLAM3/Thirdparty/DBoW2 as used through
include/ORBVocabulary.h:29: hierarchical k-medians tree over 256-bit ORB
descriptors, tf-idf weighted BoW vectors, feature vectors at a fixed tree
level for bucketed matching, L1 scoring, and a loader for the ORBvoc.txt
text format (TemplatedVocabulary::loadFromTextFile, :1338).

Not a port: the tree lives in flat NumPy arrays (children table + packed
descriptors) and `transform` descends ALL descriptors in lock-step with
vectorized Hamming argmins — one (N, k) popcount per level instead of
DBoW2's per-descriptor recursive walk.  Training uses k-medians with
majority-vote bit medians.
"""

from __future__ import annotations

import numpy as np

def _hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 32) x (M, 32) -> (N, M) int32."""
    return np.bitwise_count(a[:, None, :] ^ b[None, :, :]).sum(
        axis=-1, dtype=np.int32
    )


def _bit_median(descs: np.ndarray) -> np.ndarray:
    """Majority-vote per-bit median of (N, 32) uint8 descriptors."""
    bits = np.unpackbits(descs, axis=1)  # (N, 256)
    maj = (bits.sum(axis=0) * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj)


class BinaryVocabulary:
    """k-ary tree of depth L; leaves are words with idf weights."""

    def __init__(self, k: int = 10, depth: int = 5, feat_level: int = 2):
        self.k = k
        self.depth = depth
        # feature-vector grouping level measured from the ROOT (DBoW2's
        # `levelsup` counts from the leaves; ORB-SLAM uses levelsup=4)
        self.feat_level = feat_level
        # flat arrays, node 0 = root
        self.children = np.zeros((1, k), np.int64) - 1
        self.node_desc = np.zeros((1, 32), np.uint8)
        self.node_level = np.zeros(1, np.int32)
        self.word_id = np.zeros(1, np.int64) - 1  # >= 0 at leaves
        self.weights = np.zeros(0, np.float64)    # per word (idf)
        self.n_words = 0

    # ------------------------------------------------------------------
    @staticmethod
    def train(
        descriptors: np.ndarray,
        k: int = 10,
        depth: int = 5,
        feat_level: int = 2,
        seed: int = 0,
        kmeans_iters: int = 8,
    ) -> "BinaryVocabulary":
        """Hierarchical k-medians over a (N, 32) uint8 training set."""
        rng = np.random.default_rng(seed)
        voc = BinaryVocabulary(k, depth, feat_level)
        children = [np.full(k, -1, np.int64)]
        node_desc = [np.zeros(32, np.uint8)]
        node_level = [0]
        word_of_node = [-1]
        leaf_counts = []

        def build(desc_idx: np.ndarray, node: int, level: int):
            descs = descriptors[desc_idx]
            if level == depth or len(desc_idx) <= k:
                word_of_node[node] = len(leaf_counts)
                leaf_counts.append(len(desc_idx))
                return
            # k-medians init: k distinct random seeds
            uniq = np.unique(descs, axis=0)
            kk = min(k, len(uniq))
            centers = uniq[rng.choice(len(uniq), kk, replace=False)]
            for _ in range(kmeans_iters):
                d = _hamming(descs, centers)
                assign = d.argmin(axis=1)
                new_centers = []
                for c in range(kk):
                    m = assign == c
                    new_centers.append(_bit_median(descs[m]) if m.any() else centers[c])
                new_centers = np.stack(new_centers)
                if (new_centers == centers).all():
                    break
                centers = new_centers
            d = _hamming(descs, centers)
            assign = d.argmin(axis=1)
            for c in range(kk):
                m = assign == c
                if not m.any():
                    continue
                child = len(children)
                children.append(np.full(k, -1, np.int64))
                node_desc.append(centers[c])
                node_level.append(level + 1)
                word_of_node.append(-1)
                children[node][c] = child
                build(desc_idx[m], child, level + 1)

        build(np.arange(len(descriptors)), 0, 0)
        voc.children = np.stack(children)
        voc.node_desc = np.stack(node_desc)
        voc.node_level = np.asarray(node_level, np.int32)
        voc.word_id = np.asarray(word_of_node, np.int64)
        voc.n_words = len(leaf_counts)
        # idf weights from the training corpus (treat all descs as one doc
        # set; DBoW2 uses per-image idf — with one synthetic corpus this is
        # the tf-idf-like weighting the scores need)
        counts = np.asarray(leaf_counts, np.float64)
        n = counts.sum()
        voc.weights = np.where(counts > 0, np.log(n / np.maximum(counts, 1)), 0.0)
        return voc

    # ------------------------------------------------------------------
    def transform(self, descriptors: np.ndarray):
        """(N, 32) -> (bow_vec: dict word->weight (L1-normalized),
                       feat_vec: dict node_at_feat_level -> list[int])."""
        n = len(descriptors)
        if n == 0:
            return {}, {}
        cur = np.zeros(n, np.int64)  # current node per descriptor
        feat_node = np.zeros(n, np.int64)
        for level in range(self.depth + 1):
            if level == self.feat_level:
                feat_node = cur.copy()
            ch = self.children[cur]                      # (N, k)
            has_child = (ch >= 0).any(axis=1)
            if not has_child.any():
                break
            idx = np.nonzero(has_child)[0]
            chi = ch[idx]                                # (M, k)
            cand = self.node_desc[np.maximum(chi, 0)]    # (M, k, 32)
            d = np.bitwise_count(cand ^ descriptors[idx][:, None, :]).sum(
                axis=-1, dtype=np.int32
            )
            d = np.where(chi >= 0, d, 1 << 20)
            cur[idx] = chi[np.arange(len(idx)), d.argmin(axis=1)]
        words = self.word_id[cur]
        # bow: per-word summed idf weight, L1-normalized (vectorized)
        wv = words[words >= 0]
        bow: dict[int, float] = {}
        if len(wv):
            uw, cnt = np.unique(wv, return_counts=True)
            wts = self.weights[uw] * cnt
            keep = self.weights[uw] > 0
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

    @staticmethod
    def score(bow1: dict, bow2: dict) -> float:
        """DBoW2 L1 score in [0, 1]: 1 - 0.5*sum|v1 - v2| over the union."""
        if not bow1 or not bow2:
            return 0.0
        s = 0.0
        for w, v in bow1.items():
            u = bow2.get(w)
            if u is not None:
                s += abs(v - u) - abs(v) - abs(u)
        return -0.5 * s

    # ------------------------------------------------------------------
    def save(self, path: str):
        np.savez_compressed(
            path,
            k=self.k,
            depth=self.depth,
            feat_level=self.feat_level,
            children=self.children,
            node_desc=self.node_desc,
            node_level=self.node_level,
            word_id=self.word_id,
            weights=self.weights,
        )

    @staticmethod
    def load(path: str) -> "BinaryVocabulary":
        z = np.load(path)
        voc = BinaryVocabulary(int(z["k"]), int(z["depth"]), int(z["feat_level"]))
        voc.children = z["children"]
        voc.node_desc = z["node_desc"]
        voc.node_level = z["node_level"]
        voc.word_id = z["word_id"]
        voc.weights = z["weights"]
        voc.n_words = int((voc.word_id >= 0).sum())
        return voc

    # --- ORBvoc.txt compatibility ----------------------------------------
    @staticmethod
    def load_orbvoc_text(path: str, feat_level: int = 2) -> "BinaryVocabulary":
        """Parse the DBoW2 text format the reference ships (header
        `k L scoring weighting`, then one node per line:
        `parent_id is_leaf d0..d31 weight`, nodes in BFS order;
        TemplatedVocabulary::loadFromTextFile, :1338).

        Fully vectorized: numpy's C tokenizer parses the (n, 35) numeric
        body, slots/levels/word-ids reconstruct with array ops — the
        reference's ~1M-node ORBvoc.txt (145 MB) loads in seconds instead
        of the minutes a per-line Python loop takes."""
        with open(path) as f:
            header = f.readline().split()
            k, depth = int(header[0]), int(header[1])
            data = np.loadtxt(f, dtype=np.float64, ndmin=2)
        if data.size == 0:
            return BinaryVocabulary(k, depth, feat_level)
        parents = data[:, 0].astype(np.int64)  # text ids: 0-based, root=0
        leafs = data[:, 1] != 0
        n = len(parents) + 1  # + root
        voc = BinaryVocabulary(k, depth, feat_level)
        voc.children = np.full((n, k), -1, np.int64)
        voc.node_desc = np.zeros((n, 32), np.uint8)
        voc.node_desc[1:] = data[:, 2:34].astype(np.uint8)
        voc.word_id = np.full(n, -1, np.int64)
        node_ids = np.arange(1, n)
        # child slots = appearance order within each parent (stable cumcount)
        order = np.argsort(parents, kind="stable")
        sp = parents[order]
        starts = np.r_[0, np.nonzero(np.diff(sp))[0] + 1]
        group_start = np.repeat(starts, np.diff(np.r_[starts, len(sp)]))
        slot = np.arange(len(sp)) - group_start
        ok = slot < k
        voc.children[sp[ok], slot[ok]] = node_ids[order][ok]
        # levels = hop count to the root (parents always precede children)
        par_full = np.r_[-1, parents]
        lvl = np.zeros(n, np.int64)
        cur = par_full.copy()
        for _ in range(depth + 3):
            alive = cur >= 0
            if not alive.any():
                break
            lvl[alive] += 1
            cur = np.where(alive, par_full[np.maximum(cur, 0)], -1)
        voc.node_level = lvl.astype(np.int32)
        # word ids in file order over the leaves (DBoW2 numbering)
        voc.word_id[node_ids[leafs]] = np.arange(int(leafs.sum()))
        voc.weights = data[leafs, 34]
        voc.n_words = int(leafs.sum())
        return voc

    def _bfs_order(self):
        """(nodes, parent_new_ids): level-order walk with slot-major child
        order, new ids implicit (line i = node i+1)."""
        new_id = np.full(len(self.word_id), -1, np.int64)
        new_id[0] = 0
        frontier = np.array([0], np.int64)
        out_nodes, out_parents = [], []
        count = 0
        while len(frontier):
            ch = self.children[frontier]  # (F, k)
            par = np.repeat(new_id[frontier], ch.shape[1])
            ch = ch.ravel()
            m = ch >= 0
            ch, par = ch[m], par[m]
            if len(ch) == 0:
                break
            new_id[ch] = count + 1 + np.arange(len(ch))
            count += len(ch)
            out_nodes.append(ch)
            out_parents.append(par)
            frontier = ch
        if not out_nodes:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(out_nodes), np.concatenate(out_parents)

    def save_orbvoc_text(self, path: str):
        """Write the DBoW2-compatible text format (BFS order; node ids are
        implicit: root = 0, line i defines node i+1; parent field is the
        parent's id).  Vectorized (np.savetxt) for ~1M-node vocabularies."""
        nodes, parent_ids = self._bfs_order()
        is_leaf = (self.word_id[nodes] >= 0).astype(np.int64)
        w = np.where(
            is_leaf > 0,
            self.weights[np.maximum(self.word_id[nodes], 0)]
            if len(self.weights)
            else 0.0,
            0.0,
        )
        ints = np.column_stack(
            [parent_ids, is_leaf, self.node_desc[nodes].astype(np.int64)]
        ).tolist()  # C-speed conversion to Python ints
        ws = w.tolist()
        with open(path, "w") as f:
            f.write(f"{self.k} {self.depth} 0 0\n")
            # join-based formatting: ~10x faster than np.savetxt's per-row
            # % formatting at the reference's ~1M-node scale
            chunk = 65536
            for s0 in range(0, len(ints), chunk):
                f.write(
                    "\n".join(
                        " ".join(map(str, row)) + f" {wv:.6f}"
                        for row, wv in zip(
                            ints[s0 : s0 + chunk], ws[s0 : s0 + chunk]
                        )
                    )
                    + "\n"
                )

    # ------------------------------------------------------------------
    @staticmethod
    def synthesize(
        k: int = 10, depth: int = 6, feat_level: int = 2, seed: int = 0
    ) -> "BinaryVocabulary":
        """Directly generate a full k^depth-word vocabulary structure
        (production scale: k=10, depth=6 -> 1M words, matching the
        reference's ORBvoc.txt shape) without training.  Node descriptors
        are hierarchical: each child = parent XOR a random mask whose
        per-bit flip probability halves per level, so descents are
        metrically coherent.  For scale/perf validation — a trained
        vocabulary is only needed for real place-recognition quality."""
        rng = np.random.default_rng(seed)
        sizes = [k**l for l in range(depth + 1)]
        offsets = np.cumsum([0] + sizes)  # node id ranges per level
        n = int(offsets[-1])
        voc = BinaryVocabulary(k, depth, feat_level)
        voc.children = np.full((n, k), -1, np.int64)
        voc.node_desc = np.zeros((n, 32), np.uint8)
        voc.node_level = np.zeros(n, np.int32)
        voc.word_id = np.full(n, -1, np.int64)
        for l in range(depth):
            lo, hi = offsets[l], offsets[l + 1]
            m = hi - lo
            voc.node_level[lo:hi] = l
            # children of level-l nodes are contiguous at level l+1
            voc.children[lo:hi] = offsets[l + 1] + np.arange(m * k).reshape(
                m, k
            )
            # per-bit flip probability 2^-(l+1): AND of (l+1) uniform bytes
            mask = rng.integers(0, 256, (m * k, 32), np.uint8, endpoint=False)
            for _ in range(l):
                mask &= rng.integers(0, 256, (m * k, 32), np.uint8)
            voc.node_desc[offsets[l + 1] : offsets[l + 2]] = (
                np.repeat(voc.node_desc[lo:hi], k, axis=0) ^ mask
            )
        lo, hi = offsets[depth], offsets[depth + 1]
        voc.node_level[lo:hi] = depth
        voc.word_id[lo:hi] = np.arange(hi - lo)
        voc.weights = rng.uniform(0.2, 1.0, hi - lo)
        voc.n_words = int(hi - lo)
        return voc
