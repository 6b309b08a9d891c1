"""Unstructured meshes: tet4/hex8 import from Gmsh .msh and VTK .vtu files.

The port's own copy of easysimp_tpu/mesh.py (host numpy only).  Replaces the
reference's FerriteGmsh/ReadVTK import pipeline
(src/MeshImport/MeshImport.jl:20-164) with pure-Python parsers; mesh IO is
host-side work.  Matching the reference semantics:

  * the grid is built from the DOMINANT volume cell type (MeshImport.jl:92-121)
  * cell-data arrays named CellEntityIds / element_ids / gmsh:physical /
    ElementId become cellsets (MeshImport.jl:124-153)
  * .msh physical groups become cellsets keyed by their physical names

Supported .msh: ASCII v2.2 and v4.1 (the reference's data/Wheel_3d_coarse.msh
is v4.1).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from functools import cached_property

import numpy as np

from .utils.terminal import print_success

__all__ = ["UnstructuredMesh", "import_mesh", "tet_mesh_from_grid"]

# Local face tables (0-based), matching the reference's get_face_nodes
# (FiniteElementAnalysis.jl:470-479).
TET_FACES = ((0, 1, 2), (0, 1, 3), (1, 2, 3), (0, 2, 3))
HEX_FACES = ((0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
             (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7))


@dataclass
class UnstructuredMesh:
    """Homogeneous mesh with optional cellsets.

    Volume meshes (tet4/hex8) support the full analysis pipeline; surface
    and line meshes (tri3/quad4/line2 — the extra VTK codes the reference's
    importer maps at MeshImport.jl:72-90) can be imported and re-exported
    for mesh-cleaning workflows, but are rejected by `setup`.
    """

    node_coords: np.ndarray                 # (n_nodes, 3) float64
    connectivity: np.ndarray                # (n_cells, k) int64, VTK order
    cell_type: str = ""                     # tet4|hex8|tri3|quad4|line2
    cellsets: dict = dc_field(default_factory=dict)

    def __post_init__(self):
        self.node_coords = np.ascontiguousarray(self.node_coords,
                                                dtype=np.float64)
        self.connectivity = np.ascontiguousarray(self.connectivity,
                                                 dtype=np.int64)
        nn = self.connectivity.shape[1]
        # nn==4 is ambiguous (tet4 vs quad4): an explicit cell_type wins;
        # the bare-constructor default stays tet4 (the volume type).
        default = {2: "line2", 3: "tri3", 4: "tet4", 8: "hex8"}.get(nn)
        valid = {2: {"line2"}, 3: {"tri3"}, 4: {"tet4", "quad4"},
                 8: {"hex8"}}.get(nn, set())
        if self.cell_type and self.cell_type not in valid:
            raise ValueError(
                f"cell_type {self.cell_type!r} inconsistent with {nn}-node "
                f"cells")
        if not self.cell_type:
            if default is None:
                raise ValueError(f"unsupported cells with {nn} nodes")
            self.cell_type = default
        if self.cell_type == "tet4":
            # Re-orient inverted tets (negative volume) by swapping nodes 1,2.
            J = (self.node_coords[self.connectivity[:, 1:]]
                 - self.node_coords[self.connectivity[:, :1]])
            neg = np.linalg.det(J) < 0
            if np.any(neg):
                c = self.connectivity
                c[neg, 1], c[neg, 2] = c[neg, 2].copy(), c[neg, 1].copy()

    @property
    def is_volume_mesh(self) -> bool:
        return self.cell_type in ("tet4", "hex8")

    # ----- counts ------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return self.node_coords.shape[0]

    @property
    def n_cells(self) -> int:
        return self.connectivity.shape[0]

    @property
    def n_dofs(self) -> int:
        return 3 * self.n_nodes

    # ----- geometry ----------------------------------------------------
    @cached_property
    def element_volumes(self) -> np.ndarray:
        # volumes come for free with the ke batch, but computing them alone
        # is cheap enough to keep this independent:
        coords = self.node_coords[self.connectivity]
        if self.cell_type == "tet4":
            J = coords[:, 1:4, :] - coords[:, 0:1, :]
            return np.linalg.det(J) / 6.0
        from .ops.elements import shape_integrals_batch_np

        return shape_integrals_batch_np(coords).sum(axis=1)

    @property
    def total_volume(self) -> float:
        return float(self.element_volumes.sum())

    @cached_property
    def cell_centers(self) -> np.ndarray:
        return self.node_coords[self.connectivity].mean(axis=1)

    @cached_property
    def characteristic_element_size(self) -> float:
        """Average size of the FIRST 10 cells, hex = geometric mean of three
        edges, tet = mean of six edges — exactly the reference's
        estimate_element_size (FilterCommon.jl:109-182), quirk included."""
        n = min(10, self.n_cells)
        coords = self.node_coords[self.connectivity[:n]]
        if self.cell_type == "tet4":
            edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
            sizes = np.mean(
                [np.linalg.norm(coords[:, j] - coords[:, i], axis=1)
                 for i, j in edges], axis=0)
        else:
            e1 = np.linalg.norm(coords[:, 1] - coords[:, 0], axis=1)
            e2 = np.linalg.norm(coords[:, 3] - coords[:, 0], axis=1)
            e3 = np.linalg.norm(coords[:, 4] - coords[:, 0], axis=1)
            sizes = (e1 * e2 * e3) ** (1.0 / 3.0)
        return float(np.mean(sizes))

    # ----- facets (for surface traction / BC export) --------------------
    @property
    def _face_table(self):
        return TET_FACES if self.cell_type == "tet4" else HEX_FACES

    def boundary_facets_for_nodes(self, nodes):
        """(cell_id, local_face_id) pairs whose face nodes are all in `nodes`
        (parity: get_boundary_facets, FiniteElementAnalysis.jl:450-468)."""
        node_arr = np.fromiter(set(int(n) for n in nodes), dtype=np.int64)
        in_set = np.isin(self.connectivity, node_arr)
        out = []
        for lf, fnodes in enumerate(self._face_table):
            ok = np.all(in_set[:, list(fnodes)], axis=1)
            out.extend((int(c), lf) for c in np.nonzero(ok)[0])
        return out

    def facet_node_lists(self, nodes):
        """Global node id tuples of the facets spanned by `nodes`."""
        conn = self.connectivity
        return [
            conn[cell, list(self._face_table[lf])]
            for cell, lf in self.boundary_facets_for_nodes(nodes)
        ]


# ---------------------------------------------------------------------------
# VTU import
# ---------------------------------------------------------------------------

_CELLSET_KEYS = ("CellEntityIds", "element_ids", "gmsh:physical", "ElementId")


# VTK code -> (nodes per cell, cell_type) — the same codes the reference
# importer accepts (MeshImport.jl:72-90: tet=10, hex=12, tri=5, quad=9,
# line=3).  The dominant (most numerous) cell type wins, with volume types
# breaking EXACT ties only — reference argmax(cell_counts) parity — so a
# thin volume mesh whose surface skin outnumbers its volume cells still
# imports as the skin, exactly as the reference would.
_VTU_CELL_TYPES = {10: (4, "tet4"), 12: (8, "hex8"), 5: (3, "tri3"),
                   9: (4, "quad4"), 3: (2, "line2")}


def _mesh_from_vtu(path) -> UnstructuredMesh:
    from .post.vtu import read_vtu

    data = read_vtu(path)
    counts = {t: int(np.sum(data.types == t)) for t in _VTU_CELL_TYPES}
    # sort key: count first, then volume types (tet=10/hex=12 sort above
    # the surface/line codes at equal count)
    dominant = max(counts, key=lambda t: (counts[t], t in (10, 12)))
    if counts[dominant] == 0:
        raise ValueError(
            f"no supported cells (tet/hex/tri/quad/line) found in {path}")
    nn, cell_type = _VTU_CELL_TYPES[dominant]

    keep = data.types == dominant
    starts = np.concatenate([[0], data.offsets[:-1]])
    conn = np.stack(
        [data.connectivity[s : s + nn]
         for s, k in zip(starts, keep) if k]
    )
    cellsets: dict = {}
    for key in _CELLSET_KEYS:
        if key in data.cell_data:
            vals = np.asarray(data.cell_data[key]).reshape(-1)[keep]
            for v in np.unique(vals):
                cellsets[f"{key}_{int(v)}"] = np.nonzero(vals == v)[0]
    mesh = UnstructuredMesh(node_coords=data.points, connectivity=conn,
                            cell_type=cell_type, cellsets=cellsets)
    print_success(
        f"Imported {path}: {mesh.n_cells} {mesh.cell_type} cells, "
        f"{mesh.n_nodes} nodes"
    )
    return mesh


# ---------------------------------------------------------------------------
# Gmsh .msh import (ASCII v2.2 and v4.1)
# ---------------------------------------------------------------------------

_GMSH_VOLUME_TYPES = {4: 4, 5: 8}  # element type code -> nodes per element


def _mesh_from_msh(path) -> UnstructuredMesh:
    with open(path) as fh:
        lines = fh.read().splitlines()

    sections: dict[str, list[str]] = {}
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("$") and not line.startswith("$End"):
            name = line[1:]
            j = i + 1
            while j < len(lines) and not lines[j].strip().startswith("$End"):
                j += 1
            sections[name] = lines[i + 1 : j]
            i = j + 1
        else:
            i += 1

    version = float(sections["MeshFormat"][0].split()[0])
    if version >= 4.0:
        nodes, node_ids = _parse_nodes_v4(sections["Nodes"])
        elements, elem_phys = _parse_elements_v4(sections)
    else:
        nodes, node_ids = _parse_nodes_v2(sections["Nodes"])
        elements, elem_phys = _parse_elements_v2(sections["Elements"])

    id_map = {nid: k for k, nid in enumerate(node_ids)}
    # dominant volume type
    by_nn = {}
    for nn, conn, phys in elements:
        by_nn.setdefault(nn, []).append((conn, phys))
    if not by_nn:
        raise ValueError(f"no tet4/hex8 elements in {path}")
    nn = max(by_nn, key=lambda k: len(by_nn[k]))
    conns, physs = [], []
    for conn, phys in by_nn[nn]:
        conns.append([id_map[n] for n in conn])
        physs.append(phys)
    conn_arr = np.asarray(conns, dtype=np.int64)
    phys_arr = np.asarray(physs, dtype=np.int64)

    # Physical-group names -> cellsets
    names = {}
    for line in sections.get("PhysicalNames", [])[1:]:
        parts = line.split(None, 2)
        if len(parts) == 3:
            names[int(parts[1])] = parts[2].strip().strip('"')
    cellsets = {}
    for tag in np.unique(phys_arr):
        if tag < 0:
            continue
        key = names.get(int(tag), f"physical_{int(tag)}")
        idx = np.nonzero(phys_arr == tag)[0]
        cellsets.setdefault(key, []).append(idx)
    cellsets = {k: np.concatenate(v) for k, v in cellsets.items()}

    mesh = UnstructuredMesh(node_coords=nodes, connectivity=conn_arr,
                            cellsets=cellsets)
    print_success(
        f"Imported {path}: {mesh.n_cells} {mesh.cell_type} cells, "
        f"{mesh.n_nodes} nodes"
        + (f", cellsets: {sorted(cellsets)}" if cellsets else "")
    )
    return mesh


def _parse_nodes_v4(body):
    head = body[0].split()
    num_blocks = int(head[0])
    ids, coords = [], []
    k = 1
    for _ in range(num_blocks):
        _, _, _, n = (int(v) for v in body[k].split())
        k += 1
        block_ids = [int(body[k + j]) for j in range(n)]
        k += n
        for j in range(n):
            xyz = body[k + j].split()
            coords.append([float(xyz[0]), float(xyz[1]), float(xyz[2])])
        k += n
        ids.extend(block_ids)
    return np.asarray(coords), ids


def _parse_elements_v4(sections):
    body = sections["Elements"]
    # entity (dim, tag) -> physical tag, from $Entities
    ent_phys = {}
    if "Entities" in sections:
        ent = sections["Entities"]
        counts = [int(v) for v in ent[0].split()]
        k = 1
        for dim, cnt in enumerate(counts):
            for _ in range(cnt):
                parts = ent[k].split()
                tag = int(parts[0])
                # points: tag x y z numPhys phys...; others: tag 6 bbox vals
                off = 4 if dim == 0 else 7
                nphys = int(parts[off])
                phys = int(parts[off + 1]) if nphys > 0 else -1
                ent_phys[(dim, tag)] = phys
                k += 1
    head = body[0].split()
    num_blocks = int(head[0])
    k = 1
    elements = []
    for _ in range(num_blocks):
        dim, etag, etype, n = (int(v) for v in body[k].split())
        k += 1
        if etype in _GMSH_VOLUME_TYPES and dim == 3:
            nn = _GMSH_VOLUME_TYPES[etype]
            phys = ent_phys.get((dim, etag), -1)
            for j in range(n):
                parts = [int(v) for v in body[k + j].split()]
                elements.append((nn, parts[1 : 1 + nn], phys))
        k += n
    return elements, None


def _parse_nodes_v2(body):
    n = int(body[0])
    ids, coords = [], []
    for line in body[1 : 1 + n]:
        parts = line.split()
        ids.append(int(parts[0]))
        coords.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(coords), ids


def _parse_elements_v2(body):
    n = int(body[0])
    elements = []
    for line in body[1 : 1 + n]:
        parts = [int(v) for v in line.split()]
        etype = parts[1]
        if etype in _GMSH_VOLUME_TYPES:
            ntags = parts[2]
            phys = parts[3] if ntags > 0 else -1
            nn = _GMSH_VOLUME_TYPES[etype]
            nodes = parts[3 + ntags : 3 + ntags + nn]
            elements.append((nn, nodes, phys))
    return elements, None


def import_mesh(path) -> UnstructuredMesh:
    """Import a mesh file (.msh or .vtu) — parity with `import_mesh`
    (MeshImport.jl:20-32)."""
    p = str(path)
    if p.endswith(".msh"):
        return _mesh_from_msh(p)
    if p.endswith(".vtu"):
        return _mesh_from_vtu(p)
    raise ValueError(f"unsupported mesh format: {p} (use .msh or .vtu)")


def tet_mesh_from_grid(grid) -> UnstructuredMesh:
    """Split each voxel of a VoxelGrid into 6 tets — a synthetic genuinely-
    unstructured mesh at controllable scale (benchmarks, scaling studies).
    The 6-tet decomposition shares the 0-6 diagonal, so the mesh is
    conforming; all tets have positive volume in VTK corner order."""
    conn = grid.hex_connectivity
    tets = [(0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
            (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6)]
    tet_conn = np.concatenate([conn[:, list(t)] for t in tets], axis=0)
    return UnstructuredMesh(node_coords=grid.node_coords,
                            connectivity=tet_conn)
