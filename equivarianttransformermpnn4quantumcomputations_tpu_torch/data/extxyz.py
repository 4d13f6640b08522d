"""Pure-Python extxyz reader: the port's own copy of the JAX package's
data/extxyz.py.

The reference reads OC20's extended-XYZ trajectory files through
``ase.io.read`` (reference models/data_loader_oc20v2.py:1-13).  The port
reads them with this module alone (no ase): the subset of the format the
OC20 files use — ``Lattice``, ``Properties`` columns
(``species``/``pos``/``forces``/``tags``/integer, logical and real extras),
``energy`` and ``pbc`` in the comment line — into an ``Atoms``-like object.
``read_extxyz(path, index)`` takes ase's index forms (int, -1, ":").
"""

from __future__ import annotations

import re

import numpy as np

from .periodic import ATOMIC_NUMBERS

__all__ = ["SimpleAtoms", "read_extxyz"]


class SimpleAtoms:
    """Duck-typed stand-in for ``ase.Atoms`` as used by ``_atoms_to_sample``."""

    def __init__(self, numbers, positions, cell, pbc, energy, forces, tags):
        self.numbers = np.asarray(numbers, np.int32)
        self.positions = np.asarray(positions, np.float64)
        self.cell = np.asarray(cell, np.float64)
        self.pbc = np.asarray(pbc, bool)
        self._energy = energy
        self._forces = forces
        self._tags = tags

    def __len__(self):
        return len(self.numbers)

    def get_potential_energy(self):
        if self._energy is None:
            raise RuntimeError("frame has no energy")
        return self._energy

    def get_forces(self):
        if self._forces is None:
            raise RuntimeError("frame has no forces")
        return np.asarray(self._forces, np.float64)

    def get_tags(self):
        if self._tags is None:
            return np.zeros(len(self.numbers), np.int64)
        return np.asarray(self._tags, np.int64)


# key="quoted value" | key=bare_value
_KV_RE = re.compile(r'(\S+?)=(?:"([^"]*)"|(\S+))')


def _parse_comment(line: str) -> dict:
    return {
        m.group(1): (m.group(2) if m.group(2) is not None else m.group(3))
        for m in _KV_RE.finditer(line)
    }


def _parse_properties(spec: str):
    """``species:S:1:pos:R:3:...`` -> [(name, kind, ncols), ...]."""
    parts = spec.split(":")
    out = []
    for i in range(0, len(parts) - 2, 3):
        out.append((parts[i], parts[i + 1], int(parts[i + 2])))
    return out


def _parse_frame(lines, start: int):
    """Parse one frame at ``lines[start:]``; returns (SimpleAtoms, next_start)."""
    natoms = int(lines[start].split()[0])
    info = _parse_comment(lines[start + 1])

    cell = np.zeros((3, 3))
    if "Lattice" in info:
        cell = np.fromstring(info["Lattice"], sep=" ").reshape(3, 3)
    pbc = np.array([True] * 3) if "Lattice" in info else np.array([False] * 3)
    if "pbc" in info:
        pbc = np.array([t in ("T", "True", "1") for t in info["pbc"].split()])

    energy = None
    for key in ("energy", "Energy", "free_energy"):
        if key in info:
            energy = float(info[key])
            break

    props = _parse_properties(info.get("Properties", "species:S:1:pos:R:3"))
    symbols, columns = [], {}
    col = 0
    col_slices = []
    for name, kind, ncols in props:
        col_slices.append((name, kind, col, col + ncols))
        col += ncols

    rows = [lines[start + 2 + i].split() for i in range(natoms)]
    for name, kind, c0, c1 in col_slices:
        vals = [r[c0:c1] for r in rows]
        if kind == "S":
            symbols = [v[0] for v in vals]
        elif kind == "I":
            columns[name] = np.asarray(vals, np.int64).reshape(natoms, c1 - c0)
        elif kind == "L":
            # logical columns hold T/F (or True/False/0/1) strings — e.g.
            # OC20 S2EF headers carry ``move_mask:L:1``
            columns[name] = np.asarray(
                [[t in ("T", "True", "1") for t in v] for v in vals], bool
            ).reshape(natoms, c1 - c0)
        else:  # R
            columns[name] = np.asarray(vals, np.float64).reshape(
                natoms, c1 - c0
            )

    numbers = np.asarray([ATOMIC_NUMBERS[s] for s in symbols], np.int32)
    positions = columns["pos"]
    forces = columns.get("forces", columns.get("force"))
    tags = columns.get("tags")
    if tags is not None:
        tags = tags[:, 0]
    atoms = SimpleAtoms(
        numbers, positions, cell, pbc, energy, forces, tags
    )
    return atoms, start + 2 + natoms


def read_extxyz(path: str, index=-1):
    """ase.io.read-compatible: int index -> one frame; ":" -> list of all.

    Blank lines between frames (some writers pad with them) are skipped, and
    for a non-negative int index parsing stops as soon as that frame is
    reached instead of scanning the whole file.
    """
    want = None if index == ":" else int(index)
    with open(path) as f:
        lines = f.read().splitlines()
    frames = []
    pos = 0
    while pos < len(lines):
        if not lines[pos].strip():
            pos += 1
            continue
        atoms, pos = _parse_frame(lines, pos)
        frames.append(atoms)
        if want is not None and want >= 0 and len(frames) > want:
            return frames[want]
    if want is None:
        return frames
    return frames[want]
