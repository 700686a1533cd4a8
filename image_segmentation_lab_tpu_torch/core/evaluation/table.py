"""Minimal ASCII table for the per-class metric printout (counterpart of
``core/evaluation/table.py``)."""

from __future__ import annotations

from typing import Any, List, Sequence


class AsciiTable:
    def __init__(self):
        self._columns: List[tuple] = []

    def add_column(self, name: str, values: Sequence[Any]):
        self._columns.append((str(name), [str(v) for v in values]))

    def get_string(self) -> str:
        if not self._columns:
            return ""
        widths = [max(len(name), *(len(v) for v in vals)) if vals else
                  len(name) for name, vals in self._columns]
        nrows = max(len(vals) for _, vals in self._columns)

        def hline():
            return "+" + "+".join("-" * (w + 2) for w in widths) + "+"

        def row(cells):
            return "| " + " | ".join(c.ljust(w) for c, w in
                                     zip(cells, widths)) + " |"

        lines = [hline(), row([n for n, _ in self._columns]), hline()]
        for i in range(nrows):
            lines.append(row([vals[i] if i < len(vals) else ""
                              for _, vals in self._columns]))
        lines.append(hline())
        return "\n".join(lines)
