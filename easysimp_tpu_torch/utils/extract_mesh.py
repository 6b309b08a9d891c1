"""Extract a clean mesh-only VTU from a results VTU.

Parity with the reference's standalone `extract_mesh_from_vtu`
(src/Utils/ExtractMeshFromVTU.jl — not included by its package either, see
SURVEY.md §2 item 17): strips all cell/point/field data, keeping only points
and connectivity, so a results file can be re-used as a simulation mesh.
"""

from __future__ import annotations

from ..utils.terminal import print_success

__all__ = ["extract_mesh_from_vtu"]


def extract_mesh_from_vtu(input_path: str, output_path: str | None = None) -> str:
    """Read `input_path` and write a data-free copy of its mesh."""
    from ..post.vtu import read_vtu, write_vtu

    data = read_vtu(input_path)
    if output_path is None:
        base = input_path[:-4] if input_path.endswith(".vtu") else input_path
        output_path = base + "_mesh.vtu"
    counts = {int(t) for t in data.types}
    if len(counts) != 1:
        raise ValueError(
            f"mixed cell types {sorted(counts)} in {input_path}; extract "
            "supports homogeneous meshes"
        )
    (ctype,) = counts
    nn = {3: 2, 5: 3, 9: 4, 10: 4, 12: 8}[ctype]
    conn = data.connectivity.reshape(-1, nn)
    out = write_vtu(output_path, data.points, conn, ctype)
    print_success(f"Extracted mesh written: {out}")
    return out
