"""Bag-of-binary-words place recognition on the host.

Port of ``okvis2_tpu/frontend/bow.py`` (the DBoW2 role: reference
external/DBoW2 TemplatedVocabulary/Database, queried by Frontend.cpp:
751-802), kept as host numpy as the JAX package keeps it:

- the vocabulary is a flat codebook of W binary centroids trained by
  k-majority (bitwise-median k-means); quantising N descriptors is one
  [N,B] x [B,W] sign product and an argmax. It runs on the host by design:
  a few milliseconds per keyframe, against a device round trip that would
  also re-upload the codebook;
- a frame's bag-of-words vector is a tf-idf-weighted histogram of its word
  ids; a query scores every stored keyframe with one [K,W] x [W] product
  (cosine similarity of the L2-normalised vectors).

The vocabulary comes from a file (npz, or a DBoW2 OpenCV-YAML export) or
is trained online from the session's own descriptors (``train``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from okvis2_torch.frontend.descriptor import DESCRIPTOR_BITS


class BinaryVocabulary:
    def __init__(self, centroid_signs: np.ndarray, idf: Optional[np.ndarray] = None):
        self.centroid_signs = np.asarray(centroid_signs, np.float32)  # [W,B]
        self.n_words = self.centroid_signs.shape[0]
        self.idf = (np.asarray(idf, np.float32) if idf is not None
                    else np.ones(self.n_words, np.float32))

    @classmethod
    def train(cls, signs: np.ndarray, n_words: int = 1024, iters: int = 8,
              seed: int = 0) -> "BinaryVocabulary":
        """k-majority clustering of ±1 descriptors [N,B]: each centroid is
        the bitwise sign of the mean of its members; idf from the final
        assignment."""
        rng = np.random.default_rng(seed)
        signs = np.asarray(signs, np.float32)
        N = len(signs)
        k = min(n_words, N)
        cent = signs[rng.choice(N, k, replace=False)].copy()
        for _ in range(iters):
            # assign: max dot product == min Hamming distance
            assign = np.argmax(signs @ cent.T, axis=1)
            for j in range(k):
                members = signs[assign == j]
                if len(members):
                    cent[j] = np.where(members.mean(axis=0) >= 0, 1.0, -1.0)
        counts = np.bincount(assign, minlength=k).astype(np.float32)
        idf = np.log(N / np.maximum(counts, 1.0))
        return cls(cent, idf)

    def quantize(self, signs, mask=None) -> np.ndarray:
        """Descriptor signs [N,B] -> word ids [N] (-1 where masked out)."""
        ids = np.argmax(np.asarray(signs, np.float32) @ self.centroid_signs.T, axis=-1)
        if mask is not None:
            ids = np.where(np.asarray(mask), ids, -1)
        return ids

    def bow_vector(self, signs, mask=None) -> np.ndarray:
        """tf-idf-weighted, L2-normalised bag-of-words vector [W]."""
        ids = self.quantize(signs, mask)
        v = np.zeros(self.n_words, np.float32)
        for w in ids[ids >= 0]:
            v[w] += 1.0
        v *= self.idf
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    def save(self, path: str):
        np.savez_compressed(path, centroid_signs=self.centroid_signs, idf=self.idf)

    @classmethod
    def load(cls, path: str) -> "BinaryVocabulary":
        if path.endswith((".yml", ".yml.gz", ".yaml", ".yaml.gz")):
            return cls.load_dbow2_yml(path)
        d = np.load(path)
        return cls(d["centroid_signs"], d["idf"])

    @classmethod
    def load_dbow2_yml(cls, path: str, n_bits: int = DESCRIPTOR_BITS) -> "BinaryVocabulary":
        """Load a DBoW2 OpenCV-YAML vocabulary (the reference's
        resources/small_voc.yml.gz format, Frontend.cpp:135-174): the
        tree's words (the leaves the ``words:`` section names) become the
        flat codebook and their stored weights the idf. Narrower
        descriptors are zero-padded (a 0 sign does not vote), wider ones
        truncated."""
        import gzip
        import re

        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            text = f.read()
        node_re = re.compile(
            r"nodeId:(\d+),\s*parentId:\d+,\s*weight:([0-9.eE+-]+),\s*"
            r'descriptor:"([^"]*)"', re.S)
        desc_of: Dict[int, np.ndarray] = {}
        weight_of: Dict[int, float] = {}
        for m in node_re.finditer(text):
            nid = int(m.group(1))
            weight_of[nid] = float(m.group(2))
            by = np.asarray([int(v) for v in m.group(3).split()], np.uint8)
            desc_of[nid] = np.unpackbits(by, bitorder="little")
        word_re = re.compile(r"wordId:(\d+),\s*nodeId:(\d+)")
        words = sorted((int(m.group(1)), int(m.group(2))) for m in word_re.finditer(text))
        if not words:
            raise ValueError(f"no words found in DBoW2 vocabulary {path}")
        W = len(words)
        cent = np.zeros((W, n_bits), np.float32)
        idf = np.zeros(W, np.float32)
        for wid, nid in words:
            bits = desc_of[nid]
            n = min(len(bits), n_bits)
            cent[wid, :n] = bits[:n] * 2.0 - 1.0  # {0,1} -> ±1
            idf[wid] = weight_of[nid]
        if np.all(idf == 0):
            idf[:] = 1.0
        return cls(cent, idf)


class PlaceRecognitionDatabase:
    """Keyframe bag-of-words database (DBoW2::TemplatedDatabase role)."""

    def __init__(self, vocabulary: BinaryVocabulary):
        self.voc = vocabulary
        self._vectors: List[np.ndarray] = []
        self._frame_ids: List[int] = []

    def __len__(self):
        return len(self._vectors)

    def add(self, frame_id: int, signs, mask=None):
        self._vectors.append(self.voc.bow_vector(signs, mask))
        self._frame_ids.append(frame_id)

    def query(self, signs, mask=None, exclude_recent: int = 0,
              min_score: float = 0.0) -> List[Tuple[int, float]]:
        """(frame_id, score) of every stored keyframe scoring at least
        ``min_score``, best first, leaving out the ``exclude_recent`` most
        recent entries (temporal neighbours match trivially)."""
        if not self._vectors:
            return []
        q = self.voc.bow_vector(signs, mask)
        scores = np.stack(self._vectors) @ q
        upto = len(scores) - exclude_recent
        out = [(self._frame_ids[i], float(scores[i])) for i in range(max(upto, 0))
               if scores[i] >= min_score]
        out.sort(key=lambda x: -x[1])
        return out
