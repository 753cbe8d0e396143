"""Element-level assembly helpers (hex8 tabulation only in this slice)."""

from .local import Tabulation, tabulate

__all__ = ["Tabulation", "tabulate"]
