"""Kruskal maximum spanning tree (host-side, tiny graphs).

Port of ``okvis2_tpu/graph/mst.py``, line for line: the edge sort keeps
its tie order (Python's stable sort on the negated weight), which decides
the marginalisation partner when covisibilities tie. Covers
okvis::MstGraph (reference: okvis_util/include/okvis/MstGraph.hpp:
48-190, used by ViGraphEstimator::buildMst, ViGraphEstimator.cpp:875-930)
for covisibility-based pose-graph edge selection. Graphs here are a few
dozen keyframes — pure Python/numpy host code, no device involvement.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


class _DisjointSet:
    def __init__(self, n: int):
        self.parent = list(range(n))
        self.rank = [0] * n

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        return True


def max_spanning_tree(
    n: int, edges: Sequence[Tuple[int, int, float]]
) -> List[Tuple[int, int, float]]:
    """Maximum spanning forest via Kruskal on negated weights.

    edges: (u, v, weight). Returns the selected edges (covisibility MST:
    weight = number of co-observed landmarks).
    """
    ds = _DisjointSet(n)
    out: List[Tuple[int, int, float]] = []
    for u, v, w in sorted(edges, key=lambda e: -e[2]):
        if ds.union(u, v):
            out.append((u, v, w))
            if len(out) == n - 1:
                break
    return out
