"""Witherden–Vincent symmetric rules (the "polyquad" tables).

Counterpart of ``fenris_tpu/quadrature/polyquad.py``.  The tables of
Witherden & Vincent, "On the identification of symmetric quadrature rules
for finite element methods", Comput. Math. Appl. 69 (2015), in this
package's own copy of ``_polyquad_data.npz``.  :func:`rule` returns the
tabulated rule with the fewest points among those of at least the
requested strength (ties: the lowest strength).
"""

from __future__ import annotations

from functools import lru_cache
from importlib import resources

import numpy as np

__all__ = ["NoRuleAvailable", "available_strengths", "max_strength", "rule"]

_DOMAINS = ("tri", "quad", "tet", "hex", "pri", "pyr")


class NoRuleAvailable(Exception):
    """No tabulated rule of sufficient strength exists for the domain."""


@lru_cache(maxsize=1)
def _data():
    with resources.files(__package__).joinpath("_polyquad_data.npz").open("rb") as f:
        npz = np.load(f)
        return {k: npz[k].copy() for k in npz.files}


def _index(domain: str) -> np.ndarray:
    if domain not in _DOMAINS:
        raise ValueError(f"unknown polyquad domain {domain!r}")
    return _data()[f"{domain}/index"]  # [m, 2] (strength, points)


def available_strengths(domain: str):
    return [int(s) for s in _index(domain)[:, 0]]


def max_strength(domain: str) -> int:
    return int(_index(domain)[:, 0].max())


def rule(domain: str, strength: int):
    """The minimum-point tabulated rule of strength at least ``strength``."""
    from . import Rule

    idx = _index(domain)
    eligible = idx[idx[:, 0] >= strength]
    if len(eligible) == 0:
        raise NoRuleAvailable(f"no polyquad rule of strength >= {strength} for domain {domain!r} "
                              f"(max tabulated strength: {max_strength(domain)})")
    s, n = (int(v) for v in eligible[np.lexsort((eligible[:, 0], eligible[:, 1]))[0]])
    key = f"{domain}/{s}-{n}"
    d = _data()
    return Rule(d[key + "/weights"].copy(), d[key + "/points"].copy())
