"""Deterministic distributed dumps + the output combiner (a copy of the
JAX package's ``utils/logging.py``).

Parity with the reference's debugging pipeline: each rank writes its owned
rows to ``$PREFIX$RANK.out`` one global row at a time behind barriers, each
line tagged with a timestamp, sections delimited ``[Name]``
(``BelosMueLuSolver.cpp:29-84``); a Python script then validates that every
rank emitted identical section headers and k-way-merges lines by timestamp
(``mpi_output_combiner.py:1-78``).

Here the "ranks" are mesh parts of one program, so
determinism is structural rather than barrier-enforced: rows are written
tagged with their *global row index*, which makes the merge a stable sort —
no wall-clock timestamps needed (and the output is bit-stable across runs,
which the reference's microsecond tags were not).  The file format is kept
compatible: ``~tag~ content`` lines under ``[Section]`` headers.
"""

from __future__ import annotations

import glob
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops.csr import CSRMatrix

__all__ = [
    "print_csr_matrix",
    "print_vector",
    "combine_outputs",
]

_LINE = re.compile(r"^~(\d+)~ (.*)$")


def print_csr_matrix(
    A: CSRMatrix,
    name: str,
    prefix: str,
    parts: Optional[np.ndarray] = None,
    nparts: int = 1,
) -> List[str]:
    """Write per-part files ``{prefix}{p}.out`` with A's rows, reference
    format: section ``[name]``, one line per owned row, entries sorted by
    column like the verbose dump at ``ExodusIO.hpp:611-638``.

    Returns the list of files written.
    """
    if parts is None:
        parts = np.zeros(A.n_rows, dtype=np.int32)
    rows_of = [np.nonzero(parts == p)[0] for p in range(nparts)]
    files = []
    for p in range(nparts):
        path = f"{prefix}{p}.out"
        files.append(path)
        with open(path, "a") as f:
            f.write(f"[{name}]\n")
            for r in rows_of[p]:
                lo, hi = A.indptr[r], A.indptr[r + 1]
                ents = sorted(
                    zip(A.indices[lo:hi].tolist(), A.data[lo:hi].tolist())
                )
                body = ",".join(f"({c},{v:g})" for c, v in ents)
                f.write(f"~{r}~ {r} => [{body}]\n")
    return files


def print_vector(
    x: np.ndarray,
    name: str,
    prefix: str,
    parts: Optional[np.ndarray] = None,
    nparts: int = 1,
) -> List[str]:
    """Per-part vector dump (``printMultiVector``, ``BelosMueLuSolver.cpp:64-84``)."""
    if parts is None:
        parts = np.zeros(x.shape[0], dtype=np.int32)
    files = []
    for p in range(nparts):
        path = f"{prefix}{p}.out"
        files.append(path)
        with open(path, "a") as f:
            f.write(f"[{name}]\n")
            for r in np.nonzero(parts == p)[0]:
                f.write(f"~{r}~ {r} => {x[r]:.17g}\n")
    return files


def combine_outputs(prefix: str, output: str) -> None:
    """Merge ``{prefix}{p}.out`` files into one ordered stream.

    Mirrors ``mpi_output_combiner.py``: every file must contain the identical
    sequence of ``[Section]`` headers (validated, ``mpi_output_combiner.py:
    35-53``); within a section, lines are merged by their ``~tag~`` (here the
    global row index) and the tags stripped on output (``:75-77``).
    """
    paths = sorted(glob.glob(f"{prefix}*.out"))
    if not paths:
        raise FileNotFoundError(f"no files match {prefix}*.out")
    per_file: List[Dict[str, List[tuple]]] = []
    headers_ref: Optional[List[str]] = None
    for path in paths:
        sections: Dict[str, List[tuple]] = {}
        order: List[str] = []
        current = None
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if line.startswith("[") and line.endswith("]"):
                    current = line[1:-1]
                    order.append(current)
                    sections.setdefault(current, [])
                    continue
                m = _LINE.match(line)
                if m and current is not None:
                    sections[current].append((int(m.group(1)), m.group(2)))
        if headers_ref is None:
            headers_ref = order
        elif order != headers_ref:
            raise ValueError(
                f"{path}: section headers {order} differ from {headers_ref} "
                "(cross-file barrier violated)"
            )
        per_file.append(sections)
    with open(output, "w") as out:
        for name in headers_ref or []:
            out.write(f"[{name}]\n")
            merged = sorted(
                (t for s in per_file for t in s.get(name, [])), key=lambda t: t[0]
            )
            for _, content in merged:
                out.write(content + "\n")
