"""Quadrature tables: per-element rules and per-quadrature-point data.

Counterpart of ``fenris_tpu/assembly/quadrature_table.py``
(quadrature_table.rs: ``UniformQuadratureTable`` :213,
``GeneralQuadratureTable`` :57, ``CompactQuadratureTable`` :312).  A
table's ``data`` is the parameter pytree handed to the element assemblers
of :mod:`.local`, with their leaf rules: scalars are constants, ``[E]``
leaves per element, ``[E, q]`` leaves per point.  Per-element rules are
*groups* of elements that share a rule; each group is assembled as one
batch and its results are written back into element order, as in the JAX
package.  :func:`compact_quadrature_table` forms the groups by
deduplicating bit-equal rules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..reference_elements import ReferenceElement
from . import local as L
from .local import Tabulation, tabulate

__all__ = ["UniformQuadratureTable", "GeneralQuadratureTable", "compact_quadrature_table"]


@dataclass(frozen=True)
class UniformQuadratureTable:
    """One rule (and optional data) for every element."""

    tab: Tabulation
    data: Any = None

    @staticmethod
    def from_rule(element: ReferenceElement, rule, data: Any = None) -> "UniformQuadratureTable":
        return UniformQuadratureTable(tab=tabulate(element, rule), data=data)

    def assemble_elliptic_matrices(self, X_geo, u_el, op):
        return L.assemble_element_elliptic_matrices(X_geo, u_el, op, self.data, self.tab)

    def assemble_elliptic_vectors(self, X_geo, u_el, op):
        return L.assemble_element_elliptic_vectors(X_geo, u_el, op, self.data, self.tab)

    def elliptic_energies(self, X_geo, u_el, op):
        return L.compute_element_elliptic_energy(X_geo, u_el, op, self.data, self.tab)

    def assemble_mass_matrices(self, X_geo, solution_dim: int):
        """Mass matrices with the table's data as the density (mass.rs:20)."""
        return L.assemble_element_mass_matrices(X_geo, 1.0 if self.data is None else self.data, solution_dim,
                                                self.tab)

    def assemble_source_vectors(self, X_geo, source: Callable, solution_dim: int):
        return L.assemble_element_source_vectors(X_geo, source, self.data, solution_dim, self.tab)


@dataclass(frozen=True)
class GeneralQuadratureTable:
    """Per-element rules as groups ``(element_indices [int64 numpy], tab, data)``.

    Every element is in exactly one group; a group's data leaves have the
    group's element count as their leading axis (or broadcast).
    """

    groups: Tuple[Tuple[np.ndarray, Tabulation, Any], ...]

    @staticmethod
    def from_rules(element: ReferenceElement, rules: Sequence, element_rule_ids,
                   data_per_rule: Optional[Sequence[Any]] = None) -> "GeneralQuadratureTable":
        """Group the elements by their rule id."""
        ids = np.asarray(element_rule_ids)
        groups = []
        for rid, rule in enumerate(rules):
            idx = np.flatnonzero(ids == rid)
            if len(idx):
                groups.append((idx, tabulate(element, rule), data_per_rule[rid] if data_per_rule is not None else None))
        return GeneralQuadratureTable(groups=tuple(groups))

    def num_elements(self) -> int:
        return sum(len(idx) for idx, _, _ in self.groups)

    def _grouped(self, X_geo, u_el, kernel):
        """``kernel(Xg, ug, tab, data)`` per group, written back into element order (``u_el`` may be None)."""
        out = None
        for idx, tab, data in self.groups:
            idx_t = torch.as_tensor(idx, dtype=torch.int64, device=X_geo.device)
            block = kernel(X_geo[idx_t], None if u_el is None else u_el[idx_t], tab, data)
            if out is None:
                out = block.new_zeros((self.num_elements(),) + tuple(block.shape[1:]))
            out[idx_t] = block
        return out

    def assemble_elliptic_matrices(self, X_geo, u_el, op):
        return self._grouped(X_geo, u_el, lambda X, u, tab, data: L.assemble_element_elliptic_matrices(X, u, op, data, tab))

    def assemble_elliptic_vectors(self, X_geo, u_el, op):
        return self._grouped(X_geo, u_el, lambda X, u, tab, data: L.assemble_element_elliptic_vectors(X, u, op, data, tab))

    def elliptic_energies(self, X_geo, u_el, op):
        return self._grouped(X_geo, u_el, lambda X, u, tab, data: L.compute_element_elliptic_energy(X, u, op, data, tab))

    def assemble_mass_matrices(self, X_geo, solution_dim: int):
        return self._grouped(X_geo, None, lambda X, u, tab, data: L.assemble_element_mass_matrices(
            X, 1.0 if data is None else data, solution_dim, tab))

    def assemble_source_vectors(self, X_geo, source: Callable, solution_dim: int):
        return self._grouped(X_geo, None, lambda X, u, tab, data: L.assemble_element_source_vectors(
            X, source, data, solution_dim, tab))


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))  # Python floats stay f64


def compact_quadrature_table(element: ReferenceElement, rules_per_element: Sequence,
                             data_per_element: Optional[Sequence[Any]] = None) -> GeneralQuadratureTable:
    """Deduplicate per-element rules into shared groups (``CompactQuadratureTable``, quadrature_table.rs:312).

    Bit-equal rules (weights and points) share one tabulation, in order of
    first appearance; per-element data pytrees are stacked per group into
    leaves with the group's element count as their leading axis.
    """
    keys: dict = {}
    ids = np.empty(len(rules_per_element), dtype=np.int64)
    rules: List[Any] = []
    for e, rule in enumerate(rules_per_element):
        key = (np.asarray(rule.weights, dtype=np.float64).tobytes(), np.asarray(rule.points, dtype=np.float64).tobytes())
        if key not in keys:
            keys[key] = len(rules)
            rules.append(rule)
        ids[e] = keys[key]
    groups = []
    for rid, rule in enumerate(rules):
        idx = np.flatnonzero(ids == rid)
        data = None
        if data_per_element is not None:
            data = pytree.tree_map(lambda *leaves: torch.stack([_as_tensor(x) for x in leaves]),
                                   *(data_per_element[int(e)] for e in idx))
        groups.append((idx, tabulate(element, rule), data))
    return GeneralQuadratureTable(groups=tuple(groups))
