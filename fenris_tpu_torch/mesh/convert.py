"""Order elevation: tet4 → tet10/tet20, hex8 → hex20/hex27 (and tri3/quad4 → tri6/quad8/quad9).

Counterpart of ``fenris_tpu/mesh/convert.py`` (mesh_convert.rs): each node
of the target element has exact rational weights over the source's corner
vertices (the target's reference nodes in the source's linear basis).  A
new global node is keyed by its ``(global parent vertex, weight)`` pairs,
sorted by parent, so nodes shared by neighbouring cells dedup whatever the
cells' orientation.  Corner vertices keep their indices; new nodes follow
in order of first appearance in the cells, as in the JAX package.
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

import numpy as np

from ..reference_elements import ELEMENTS, element
from . import Mesh

__all__ = ["convert_mesh"]

_ALLOWED = {
    ("tri3", "tri6"),
    ("quad4", "quad8"),
    ("quad4", "quad9"),
    ("tet4", "tet10"),
    ("tet4", "tet20"),
    ("hex8", "hex20"),
    ("hex8", "hex27"),
}
_DENOMINATOR = 3**6 * 2**10  # every weight is k / 3^a 2^b with a <= 6, b <= 10


@lru_cache(maxsize=None)
def _node_parent_weights(src_name: str, tgt_name: str):
    """Per target node: (local corner indices, their rational weights, which sum to 1)."""
    src, tgt = ELEMENTS[src_name], ELEMENTS[tgt_name]
    phi, _ = src.tabulate(tgt.nodes)  # [n_t, n_src]
    out = []
    for t in range(tgt.num_nodes):
        locals_, weights = [], []
        for c in range(src.num_nodes):
            w = Fraction(float(phi[t, c])).limit_denominator(_DENOMINATOR)
            if w != 0:
                if abs(float(w) - phi[t, c]) >= 1e-12:
                    raise AssertionError(f"{tgt_name} node {t}: weight {phi[t, c]} is not a small rational")
                locals_.append(c)
                weights.append(w)
        if sum(weights) != 1:
            raise AssertionError(f"{tgt_name} node {t}: weights do not sum to 1")
        out.append((tuple(locals_), tuple(weights)))
    return tuple(out)


def convert_mesh(mesh: Mesh, target) -> Mesh:
    """``mesh`` elevated to the higher-order element ``target`` (a name or an element)."""
    tgt = element(target) if isinstance(target, str) else target
    src = mesh.element
    if (src.name, tgt.name) not in _ALLOWED:
        raise ValueError(f"unsupported conversion {src.name} -> {tgt.name}")
    pw = _node_parent_weights(src.name, tgt.name)
    E, n_t = mesh.num_cells, tgt.num_nodes
    max_p = max(len(ls) for ls, _ in pw)
    # key per (cell, target node): its (parent, weight) pairs sorted by parent, one int64 each
    # (parent * (_DENOMINATOR + 1) + weight numerator), padded with -1
    keys = np.full((E, n_t, max_p), -1, dtype=np.int64)
    coords = np.zeros((E, n_t, mesh.dim))
    for t, (ls, ws) in enumerate(pw):
        parents = mesh.cells[:, list(ls)].astype(np.int64)  # [E, p]
        worder = np.argsort(parents, axis=1, kind="stable")
        parents_sorted = np.take_along_axis(parents, worder, axis=1)
        wsorted = np.take_along_axis(np.array([float(w) for w in ws])[None, :].repeat(E, 0), worder, axis=1)
        keys[:, t, : len(ls)] = parents_sorted * (_DENOMINATOR + 1) + np.round(wsorted * _DENOMINATOR).astype(np.int64)
        coords[:, t, :] = np.einsum("ep,epd->ed", wsorted, mesh.points[parents_sorted, :])
    keys = keys.reshape(E * n_t, max_p)
    # group equal keys: a lexicographic sort and its runs (the order of the groups does not matter)
    order = np.lexsort(keys.T[::-1])
    sk = keys[order]
    starts = np.ones(len(sk), dtype=bool)
    starts[1:] = (sk[1:] != sk[:-1]).any(axis=1)
    group = np.cumsum(starts) - 1
    inverse = np.empty(len(sk), dtype=np.int64)
    inverse[order] = group
    uniq = sk[starts]
    # a corner vertex's key is one pair of weight 1: it keeps its index; new nodes follow in
    # order of first appearance
    is_vertex = uniq[:, 1] == -1 if max_p > 1 else np.ones(len(uniq), bool)
    final_index = np.empty(len(uniq), dtype=np.int64)
    final_index[is_vertex] = uniq[is_vertex, 0] // (_DENOMINATOR + 1)
    n_orig = mesh.num_vertices
    new_ids = np.flatnonzero(~is_vertex)
    first = np.empty(len(uniq), dtype=np.int64)
    first[group[::-1]] = order[::-1]  # the last write of each group is its smallest position
    final_index[new_ids[np.argsort(first[new_ids], kind="stable")]] = n_orig + np.arange(len(new_ids))
    points = np.zeros((n_orig + len(new_ids), mesh.dim))
    points[:n_orig] = mesh.points
    points[final_index[inverse]] = coords.reshape(E * n_t, mesh.dim)  # the same value per key
    return Mesh(points, final_index[inverse].reshape(E, n_t).astype(np.int32), tgt)
