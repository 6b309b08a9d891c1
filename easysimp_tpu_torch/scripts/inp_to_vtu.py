"""Abaqus .inp -> VTU converter.

Python rebuild of the reference's standalone converter
(scripts/InpToVtu.jl:43-55 lists the supported element catalogue): volume
elements C3D8/C3D4/C3D20/C3D10/C3D6 (wedge), shells S3/STRI3/S4/S4R, and
trusses T3D2.  Abaqus node orderings for these types coincide with the VTK
orderings (corners, then edge midnodes in the same sequence), so connectivity
maps 1:1 after 1-based -> 0-based renumbering.  ELSETs (inline or *ELSET
blocks) are exported as an `elset_id` cell-data array plus a sidecar
name-mapping file.

Twin of scripts/inp_to_vtu.py on the port's VTU writer (post/vtu.py) and
terminal printing; it writes the same bytes.

Usage:  python -m easysimp_tpu_torch.scripts.inp_to_vtu input.inp [output.vtu]
"""

from __future__ import annotations

import sys

import numpy as np

from ..post.vtu import write_vtu
from ..utils.terminal import print_data, print_success, print_warning

__all__ = ["convert_inp_to_vtu", "parse_inp"]

# Abaqus element type -> (VTK cell code, nodes per element).  Full parity
# with the reference catalogue (scripts/InpToVtu.jl:43-55): volume
# Hex8/Tet4/Hex20/Tet10/Wedge6/Wedge15, shells Tri3/Quad4/Tri6/Quad8, and
# trusses Seg2/Seg3.  Abaqus node orderings for all of these coincide with
# the VTK orderings (corners first, then mid-edge nodes in the same
# sequence; for C3D15: bottom-edge, top-edge, then vertical mid-nodes —
# identical to VTK_QUADRATIC_WEDGE).
ELEMENT_TYPES = {
    "C3D8": (12, 8), "C3D8R": (12, 8), "C3D8I": (12, 8),
    "C3D4": (10, 4),
    "C3D20": (25, 20), "C3D20R": (25, 20),
    "C3D10": (24, 10),
    "C3D6": (13, 6),
    "C3D15": (26, 15),
    "S3": (5, 3), "STRI3": (5, 3), "CPS3": (5, 3),
    "S4": (9, 4), "S4R": (9, 4), "CPS4": (9, 4),
    "S6": (22, 6), "STRI65": (22, 6),
    "S8": (23, 8), "S8R": (23, 8),
    "T3D2": (3, 2),
    "T3D3": (21, 3),
}


def _iter_logical_lines(fh):
    """Yield stripped lines with Abaqus continuation (trailing comma) merged."""
    pending = ""
    for raw in fh:
        line = raw.strip()
        if not line or line.startswith("**"):
            continue
        if pending:
            line = pending + line
            pending = ""
        if line.endswith(",") and not line.startswith("*"):
            pending = line
            continue
        yield line
    if pending:
        yield pending.rstrip(",")


def _parse_keyword(line):
    parts = [p.strip() for p in line[1:].split(",")]
    keyword = parts[0].upper()
    opts = {}
    for p in parts[1:]:
        if "=" in p:
            k, v = p.split("=", 1)
            opts[k.strip().upper()] = v.strip()
        elif p:
            opts[p.upper()] = True
    return keyword, opts


def parse_inp(path):
    """Parse an Abaqus .inp: returns (points, blocks, elsets).

    blocks: list of dicts {vtk_type, conn (m, k) 0-based, elem_ids, elset}.
    elsets: dict name -> set of element ids (1-based, as in the file).
    """
    node_ids, node_xyz = [], []
    blocks = []
    elsets: dict[str, set] = {}
    section = None
    current = None

    with open(path) as fh:
        for line in _iter_logical_lines(fh):
            if line.startswith("*"):
                keyword, opts = _parse_keyword(line)
                if keyword == "NODE":
                    section = "node"
                elif keyword == "ELEMENT":
                    etype = opts.get("TYPE", "").upper()
                    if etype in ELEMENT_TYPES:
                        vtk, nn = ELEMENT_TYPES[etype]
                        current = {"vtk_type": vtk, "nn": nn, "abq": etype,
                                   "conn": [], "elem_ids": [],
                                   "elset": opts.get("ELSET", "")}
                        blocks.append(current)
                        section = "element"
                    else:
                        print_warning(f"Skipping unsupported element type "
                                      f"{etype!r}")
                        section = None
                elif keyword == "ELSET":
                    name = opts.get("ELSET", "")
                    elsets.setdefault(name, set())
                    section = ("elset", name, "GENERATE" in opts)
                else:
                    section = None
                continue

            if section == "node":
                parts = line.replace(",", " ").split()
                node_ids.append(int(parts[0]))
                xyz = [float(v) for v in parts[1:4]]
                while len(xyz) < 3:
                    xyz.append(0.0)
                node_xyz.append(xyz)
            elif section == "element":
                parts = [int(v) for v in line.replace(",", " ").split()]
                current["elem_ids"].append(parts[0])
                if len(parts[1:]) != current["nn"]:
                    raise ValueError(
                        f"element {parts[0]}: expected {current['nn']} nodes, "
                        f"got {len(parts) - 1}")
                current["conn"].append(parts[1:])
            elif isinstance(section, tuple) and section[0] == "elset":
                _, name, generate = section
                parts = [int(v) for v in line.replace(",", " ").split()]
                if generate:
                    start, stop = parts[0], parts[1]
                    step = parts[2] if len(parts) > 2 else 1
                    elsets[name].update(range(start, stop + 1, step))
                else:
                    elsets[name].update(parts)

    # inline ELSET= on *ELEMENT blocks
    for b in blocks:
        if b["elset"]:
            elsets.setdefault(b["elset"], set()).update(b["elem_ids"])

    id_map = {nid: k for k, nid in enumerate(node_ids)}
    points = np.asarray(node_xyz, dtype=np.float64)
    for b in blocks:
        b["conn"] = np.asarray(
            [[id_map[n] for n in row] for row in b["conn"]], dtype=np.int64)
        b["elem_ids"] = np.asarray(b["elem_ids"], dtype=np.int64)
    return points, blocks, elsets


def convert_inp_to_vtu(input_path, output_path=None):
    """Convert an .inp file to .vtu; returns the output path."""
    if output_path is None:
        base = input_path[:-4] if input_path.lower().endswith(".inp") \
            else input_path
        output_path = base + ".vtu"
    points, blocks, elsets = parse_inp(input_path)
    if not blocks:
        raise ValueError(f"no supported elements found in {input_path}")

    cells = [(b["vtk_type"], b["conn"]) for b in blocks]
    all_elem_ids = np.concatenate([b["elem_ids"] for b in blocks])
    n_cells = all_elem_ids.shape[0]

    # elset_id cell data: index of the first elset containing each element
    elset_id = np.zeros(n_cells, dtype=np.float64)
    names = sorted(elsets)
    for si, name in enumerate(names, start=1):
        members = elsets[name]
        mask = np.fromiter((e in members for e in all_elem_ids), dtype=bool,
                           count=n_cells)
        elset_id[mask & (elset_id == 0)] = si

    cell_data = {"element_id": all_elem_ids.astype(np.float64)}
    if names:
        cell_data["elset_id"] = elset_id

    out = write_vtu(output_path, points, cells, None, cell_data=cell_data)
    if names:
        with open(out + ".elsets.txt", "w") as fh:
            for si, name in enumerate(names, start=1):
                fh.write(f"{si}\t{name}\n")
    counts = ", ".join(f"{b['abq']}x{len(b['elem_ids'])}" for b in blocks)
    print_data(f"Converted: {points.shape[0]} nodes, {n_cells} elements "
               f"({counts})")
    print_success(f"Written: {out}")
    return out


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__)
        sys.exit(1)
    convert_inp_to_vtu(*sys.argv[1:3])
