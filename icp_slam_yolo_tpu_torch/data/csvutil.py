"""Delimited-file helpers; a copy of the JAX package's ``data/csvutil.py``
(`lib_main/edit_csv_tab.py` / `edit_csv_phay.py` parity).

The reference carries two ~320-line near-duplicate modules of hand-rolled
tab- and comma-separated CSV create/append/edit/delete/query helpers (with
Vietnamese API names) used by the labeling pipeline (`kiem_tra.csv` review
log etc.).  One delimiter-parameterised implementation covers both.
"""

from __future__ import annotations

import csv
import os


class DelimitedTable:
    """Row-oriented CSV file with in-place edit operations."""

    def __init__(self, path: str, delimiter: str = ",", header: list[str] | None = None):
        self.path = path
        self.delimiter = delimiter
        if header is not None and not os.path.exists(path):
            self.write_rows([header])

    # --- io -----------------------------------------------------------------
    def read_rows(self) -> list[list[str]]:
        if not os.path.exists(self.path):
            return []
        with open(self.path, newline="") as f:
            return [row for row in csv.reader(f, delimiter=self.delimiter)]

    def write_rows(self, rows: list[list]) -> None:
        with open(self.path, "w", newline="") as f:
            csv.writer(f, delimiter=self.delimiter).writerows(rows)

    # --- operations (create/append/edit/delete/query of the reference) -------
    def append(self, row: list) -> None:
        with open(self.path, "a", newline="") as f:
            csv.writer(f, delimiter=self.delimiter).writerow(row)

    def edit_cell(self, row_idx: int, col_idx: int, value) -> None:
        rows = self.read_rows()
        rows[row_idx][col_idx] = value
        self.write_rows(rows)

    def delete_row(self, row_idx: int) -> None:
        rows = self.read_rows()
        del rows[row_idx]
        self.write_rows(rows)

    def find_rows(self, col_idx: int, value) -> list[int]:
        return [i for i, row in enumerate(self.read_rows()) if len(row) > col_idx and row[col_idx] == str(value)]

    def column(self, col_idx: int) -> list[str]:
        return [row[col_idx] for row in self.read_rows() if len(row) > col_idx]


def tab_table(path: str, header=None) -> DelimitedTable:
    """`edit_csv_tab.py` equivalent."""
    return DelimitedTable(path, "\t", header)


def comma_table(path: str, header=None) -> DelimitedTable:
    """`edit_csv_phay.py` equivalent."""
    return DelimitedTable(path, ",", header)
