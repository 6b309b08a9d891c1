"""The port's own mesh module against the JAX package's: the .msh v2.2 and
v4.1 parsers, the VTU import, the dominant-cell-type choice, the tet
re-orientation, sizes, facets, and the state carried across (carry.py).
Integers equal, floats to 1e-15 (the code is the same numpy)."""

import os

import numpy as np
import pytest

import easysimp_tpu as et
from easysimp_tpu import mesh as mesh_r
from easysimp_tpu.post import vtu as vtu_r
import easysimp_tpu_torch as pt
from easysimp_tpu_torch import mesh as mesh_p
from easysimp_tpu_torch.carry import fields_from_numpy, mesh_from_reference
from easysimp_tpu_torch.post import vtu as vtu_p

REF_DATA = os.environ.get("EASYSIMP_REFERENCE_DATA", "")

# Three tets (one listed inverted) and a boundary triangle, with physical
# groups; node ids are not contiguous.
MSH_V22 = """$MeshFormat
2.2 0 8
$EndMeshFormat
$PhysicalNames
2
3 1 "steel"
3 2 "rubber"
$EndPhysicalNames
$Nodes
5
1 0 0 0
2 1 0 0
3 0 1 0
4 0 0 1
7 1 1 1
$EndNodes
$Elements
4
1 2 2 9 9 1 2 3
2 4 2 1 1 1 2 3 4
3 4 2 2 1 2 7 3 4
4 4 2 2 1 1 3 2 4
$EndElements
"""

MSH_V41 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$PhysicalNames
1
3 5 "body"
$EndPhysicalNames
$Entities
0 0 0 1
1 0 0 0 1 1 1 1 5 0
$EndEntities
$Nodes
1 6 1 6
3 1 0 6
1
2
3
4
5
6
0 0 0
1 0 0
0 1 0
0 0 1
1 1 1
0.5 0.5 2
$EndNodes
$Elements
1 3 1 3
3 1 4 3
1 1 2 3 4
2 2 5 3 4
3 3 4 5 6
$EndElements
"""


def _same_mesh(a, b):
    assert a.cell_type == b.cell_type
    np.testing.assert_array_equal(a.connectivity, b.connectivity)
    np.testing.assert_allclose(a.node_coords, b.node_coords, rtol=0,
                               atol=1e-15)
    assert sorted(a.cellsets) == sorted(b.cellsets)
    for k in a.cellsets:
        np.testing.assert_array_equal(a.cellsets[k], b.cellsets[k])
    np.testing.assert_allclose(a.element_volumes, b.element_volumes,
                               rtol=1e-15)
    np.testing.assert_allclose(a.cell_centers, b.cell_centers, rtol=1e-15)
    assert a.characteristic_element_size == b.characteristic_element_size
    assert a.total_volume == b.total_volume


def _tets(mod, nels):
    tet_mesh_from_grid = (mesh_p if mod is pt else mesh_r).tet_mesh_from_grid
    return tet_mesh_from_grid(mod.generate_grid(
        nels, (0.0, 0.0, 0.0), tuple(float(n) for n in nels)))


@pytest.mark.parametrize("text,n_cells,sets", [
    (MSH_V22, 3, ["rubber", "steel"]), (MSH_V41, 3, ["body"])],
    ids=["v2.2", "v4.1"])
def test_msh_import_equals_reference(tmp_path, text, n_cells, sets):
    path = tmp_path / "m.msh"
    path.write_text(text)
    got = pt.import_mesh(str(path))
    want = et.import_mesh(str(path))
    _same_mesh(got, want)
    assert got.cell_type == "tet4" and got.n_cells == n_cells
    assert sorted(got.cellsets) == sets
    assert np.all(got.element_volumes > 0)      # inverted tets re-oriented


def test_vtu_roundtrip_equals_reference(tmp_path):
    """A VTU written by the port's writer (tets with a cell-data tag) reads
    back through both importers to the same mesh and cellsets."""
    m = _tets(pt, (4, 2, 2))
    tags = np.arange(m.n_cells) % 3
    path = vtu_p.write_vtu(str(tmp_path / "m.vtu"), m.node_coords,
                           m.connectivity, 10,
                           cell_data={"gmsh:physical": tags.astype(float)})
    got, want = pt.import_mesh(path), et.import_mesh(path)
    _same_mesh(got, want)
    np.testing.assert_array_equal(got.connectivity, m.connectivity)
    assert sorted(got.cellsets) == [f"gmsh:physical_{i}" for i in range(3)]
    with pytest.raises(ValueError, match="unsupported mesh format"):
        pt.import_mesh("mesh.stl")


@pytest.mark.parametrize("vtk_code,nn,ctype", [
    (5, 3, "tri3"), (9, 4, "quad4"), (3, 2, "line2")])
def test_vtu_surface_and_line_cells(tmp_path, vtk_code, nn, ctype):
    """Surface/line VTUs import as their dominant type and are rejected by
    the SIMP loop (volume meshes only), as in the reference."""
    pts = np.array([[0.0, 0, 0], [1.0, 0, 0], [1.0, 1, 0], [0.0, 1, 0],
                    [2.0, 0, 0], [2.0, 1, 0]])
    conn = np.array([list(range(nn)), list(range(1, nn + 1))])
    path = vtu_r.write_vtu(str(tmp_path / "s.vtu"), pts, conn, vtk_code)
    mesh = pt.import_mesh(path)
    assert mesh.cell_type == ctype == et.import_mesh(path).cell_type
    assert not mesh.is_volume_mesh
    np.testing.assert_array_equal(mesh.connectivity, conn)
    with pytest.raises(ValueError, match="volume mesh"):
        pt.build_unstructured_step(mesh, [], [], pt.OptimizationParameters(),
                                   device="cpu")


def test_vtu_dominant_cell_type(tmp_path):
    """Volume cells win an exact tie with their boundary skin; a skin that
    outnumbers them wins, as the reference's argmax decides."""
    m = _tets(pt, (2, 1, 1))
    for n_tris, want in ((4, "tet4"), (6, "tri3")):
        tris = m.connectivity[:n_tris, :3]
        path = vtu_p.write_vtu(str(tmp_path / f"mix{n_tris}.vtu"),
                               m.node_coords,
                               [(5, tris), (10, m.connectivity[:4])], None)
        got = pt.import_mesh(path)
        assert got.cell_type == want == et.import_mesh(path).cell_type


def test_constructor_checks_and_reorientation():
    coords = np.array([[0.0, 0, 0], [1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    conn = np.array([[0, 2, 1, 3]])
    got = mesh_p.UnstructuredMesh(node_coords=coords, connectivity=conn)
    want = mesh_r.UnstructuredMesh(node_coords=coords, connectivity=conn)
    np.testing.assert_array_equal(got.connectivity, [[0, 1, 2, 3]])
    _same_mesh(got, want)
    quad = mesh_p.UnstructuredMesh(node_coords=coords, connectivity=conn,
                                   cell_type="quad4")
    assert not quad.is_volume_mesh
    np.testing.assert_array_equal(quad.connectivity, conn)  # left alone
    with pytest.raises(ValueError, match="inconsistent"):
        mesh_p.UnstructuredMesh(node_coords=coords, connectivity=conn,
                                cell_type="hex8")
    with pytest.raises(ValueError, match="unsupported cells"):
        mesh_p.UnstructuredMesh(node_coords=coords,
                                connectivity=np.zeros((1, 5), dtype=int))


def _distorted_hexes(seed=3):
    grid = pt.generate_grid((3, 2, 2))
    rng = np.random.default_rng(seed)
    coords = grid.node_coords + rng.uniform(-0.15, 0.15,
                                            grid.node_coords.shape)
    return coords, grid.hex_connectivity


@pytest.mark.parametrize("kind", ["tet4", "hex8"])
def test_geometry_and_facets_equal_reference(kind):
    """Volumes, centers, the first-10-cells size estimate, facets and the
    traction/point loads built on them."""
    if kind == "tet4":
        got, want = _tets(pt, (4, 2, 2)), _tets(et, (4, 2, 2))
    else:
        coords, conn = _distorted_hexes()
        got = mesh_p.UnstructuredMesh(node_coords=coords, connectivity=conn)
        want = mesh_r.UnstructuredMesh(node_coords=coords, connectivity=conn)
        assert got.cell_type == "hex8"
    _same_mesh(got, want)
    assert (got.n_nodes, got.n_cells, got.n_dofs) == \
        (want.n_nodes, want.n_cells, want.n_dofs)
    nodes = pt.select_nodes_by_plane(got, [0, 2, 0], [0, 1, 0], 0.2)
    np.testing.assert_array_equal(
        nodes, et.select_nodes_by_plane(want, [0, 2, 0], [0, 1, 0], 0.2))
    assert got.boundary_facets_for_nodes(nodes) == \
        want.boundary_facets_for_nodes(nodes)
    assert pt.get_boundary_facets(got, nodes) == \
        et.get_boundary_facets(want, nodes)
    assert len(pt.get_boundary_facets(got, nodes)) > 0
    for a, b in zip(got.facet_node_lists(nodes),
                    want.facet_node_lists(nodes)):
        np.testing.assert_array_equal(a, b)

    def traction(x, y, z):
        return [0.1 * x, -3.0, 0.5 * z]

    loads_p = [pt.SurfaceTractionLoad(nodes, traction),
               pt.PointLoad(nodes[:3], [1.0, 0.0, -2.0])]
    loads_r = [et.SurfaceTractionLoad(nodes, traction),
               et.PointLoad(nodes[:3], [1.0, 0.0, -2.0])]
    f_p = pt.build_load_field(got, loads_p)
    assert f_p.shape == (got.n_nodes, 3)
    np.testing.assert_allclose(f_p, et.build_load_field(want, loads_r),
                               rtol=1e-15, atol=1e-15)
    bc_p = pt.apply_sliding_boundary(got, nodes, [1])
    bc_r = et.apply_sliding_boundary(want, nodes, [1])
    mask = pt.build_free_mask(got, [bc_p])
    assert mask.shape == (got.n_dofs,)
    np.testing.assert_array_equal(mask, et.build_free_mask(want, [bc_r]))


def test_surface_traction_totals():
    """Constant traction over a full face integrates to p * Area on a tet
    mesh (apply_surface_traction!, FiniteElementAnalysis.jl:390-440)."""
    mesh = _tets(pt, (4, 2, 2))
    nodes = pt.select_nodes_by_plane(mesh, [0, 2, 0], [0, 1, 0], 1e-6)
    f = np.zeros((mesh.n_nodes, 3))
    pt.apply_surface_traction(f, mesh, nodes, lambda x, y, z: [0, -3.0, 0])
    np.testing.assert_allclose(f.sum(axis=0), [0, -3.0 * 8, 0], rtol=1e-12)


def test_state_carried_across():
    """carry.py: a reference mesh becomes the port's by attribute, and the
    flat fields of this path are taken beside the voxel ones."""
    want = _tets(et, (3, 2, 2))
    want.cellsets["left"] = np.array([0, 2, 5])
    got = mesh_from_reference(want)
    assert isinstance(got, mesh_p.UnstructuredMesh)
    _same_mesh(got, want)
    assert got.node_coords is not want.node_coords
    rng = np.random.default_rng(0)
    design, u = rng.uniform(size=got.n_cells), rng.normal(size=got.n_dofs)
    d_t, u_t = fields_from_numpy(design, u, dtype="float64", device="cpu")
    np.testing.assert_array_equal(d_t.numpy(), design)
    np.testing.assert_array_equal(u_t.numpy(), u)
    with pytest.raises(ValueError, match="flat u"):
        fields_from_numpy(design, rng.normal(size=(got.n_nodes, 3)),
                          dtype="float64", device="cpu")


@pytest.mark.parametrize("model,fname,ctype", [
    ("gripper", "stul14.vtu", "hex8"),
    ("wheel", "Wheel_3d_coarse.msh", "tet4")])
def test_imported_models_build(model, fname, ctype):
    """The gripper and wheel models' `build` on the reference's mesh files, which
    this repository does not hold: skipped unless EASYSIMP_REFERENCE_DATA
    names their directory."""
    path = os.path.join(REF_DATA, fname)
    if not (REF_DATA and os.path.exists(path)):
        pytest.skip("reference mesh files unavailable")
    import importlib

    mod = importlib.import_module(f"easysimp_tpu_torch.models.{model}")
    mesh, loads, bcs, params, accel = mod.build(path)
    assert mesh.cell_type == ctype
    assert all(len(bc.nodes) > 0 for bc in bcs)
    assert len(loads) >= 1 and accel is not None
