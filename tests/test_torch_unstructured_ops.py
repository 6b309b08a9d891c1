"""The modules of the port's unstructured path against the JAX package, on
the CPU in float64 with the same numpy inputs: batch element stiffnesses,
`UnstructuredOperator` (every method), `UnstructuredFilter` (both neighbour
routes), the native neighbour search and the host stress recovery.
Tolerances: rtol 1e-12 unless stated."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import easysimp_tpu as et
from easysimp_tpu import mesh as mesh_r
from easysimp_tpu.ops import elements as el_r
from easysimp_tpu.ops.filters import UnstructuredFilter as FilterR
from easysimp_tpu.ops.operator import UnstructuredOperator as OperatorR
from easysimp_tpu.stress import unstructured_stresses as stresses_r
import easysimp_tpu_torch as pt
from easysimp_tpu_torch import mesh as mesh_p
from easysimp_tpu_torch import native
from easysimp_tpu_torch import tracing
from easysimp_tpu_torch.ops import cuda_kernels as ck
from easysimp_tpu_torch.ops import elements as el_p
from easysimp_tpu_torch.ops import filters as filters_p
from easysimp_tpu_torch.ops.operator import (
    UnstructuredOperator as OperatorP,
    group_sum,
    padded_groups,
)
from reference_impl import ReferenceFilter

RTOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _mesh(kind, mod):
    """A (6,3,3) tet mesh or a few distorted hex8 cells, in package `mod`'s
    class."""
    cls = (mesh_p if mod is pt else mesh_r).UnstructuredMesh
    if kind == "tet4":
        grid = mod.generate_grid((6, 3, 3), (0.0, 0.0, 0.0), (6.0, 3.0, 3.0))
        tets = [(0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
                (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6)]
        conn = np.concatenate([grid.hex_connectivity[:, list(t)]
                               for t in tets], axis=0)
        return cls(node_coords=grid.node_coords, connectivity=conn)
    grid = mod.generate_grid((3, 2, 2))
    rng = np.random.default_rng(3)
    coords = grid.node_coords + rng.uniform(-0.15, 0.15,
                                            grid.node_coords.shape)
    return cls(node_coords=coords, connectivity=grid.hex_connectivity)


def test_tf32_is_off_after_import():
    """The counterpart of the reference's precision=HIGHEST pins: every
    einsum/bmm/linalg call of this path runs with TF32 off."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("kind", ["tet4", "hex8"])
def test_batch_stiffnesses_equal_reference(kind):
    mesh = _mesh(kind, pt)
    coords = mesh.node_coords[mesh.connectivity]
    ke_p, vol_p = el_p.element_stiffness_batch_np(coords, E=2.0, nu=0.31)
    ke_r, vol_r = el_r.element_stiffness_batch_np(coords, E=2.0, nu=0.31)
    _close(ke_p, ke_r)
    _close(vol_p, vol_r)
    _close(vol_p, mesh.element_volumes)
    kl_p, km_p = el_p.element_stiffness_lame_basis_batch_np(coords)
    kl_r, km_r = el_r.element_stiffness_lame_basis_batch_np(coords)
    _close(kl_p, kl_r)
    _close(km_p, km_r)
    # the Lamé identity ke = lam * ke_lam + mu * ke_mu
    lam, mu = el_p.lame_parameters(2.0, 0.31)
    _close(lam * kl_p + mu * km_p, ke_p, atol=1e-12)
    _close(el_p.shape_integrals_batch_np(coords),
           el_r.shape_integrals_batch_np(coords))
    _close(el_p.shape_integrals_batch_np(coords).sum(axis=1), vol_p)
    # the tensor versions against the JAX device versions
    batch_p = el_p.tet4_stiffness_batch if kind == "tet4" \
        else el_p.hex8_stiffness_batch
    batch_r = el_r.tet4_stiffness_batch if kind == "tet4" \
        else el_r.hex8_stiffness_batch
    ke_t, vol_t = batch_p(_t(coords), E=2.0, nu=0.31)
    ke_j, vol_j = batch_r(jnp.asarray(coords), E=2.0, nu=0.31)
    assert ke_t.dtype == torch.float64
    _close(ke_t, ke_j, atol=1e-13)
    _close(vol_t, vol_j)
    _close(ke_t, ke_p, atol=1e-13)
    with pytest.raises(ValueError, match="unsupported element"):
        el_p.element_stiffness_batch_np(np.zeros((2, 5, 3)))


def test_padded_groups_is_a_fixed_order_scatter_add():
    rng = np.random.default_rng(0)
    index = rng.integers(0, 7, size=40)
    index[index == 3] = 4                       # an empty group
    values = _t(rng.normal(size=(40, 2)))
    table = padded_groups(index, 7)
    assert table.shape[0] == 7 and table.dtype == np.int64
    for g in range(7):
        row = table[g][table[g] < 40]
        np.testing.assert_array_equal(row, np.nonzero(index == g)[0])
    want = torch.zeros((7, 2), dtype=torch.float64).index_add_(
        0, torch.as_tensor(index), values)
    _close(group_sum(values, torch.as_tensor(table)), want, atol=1e-15)


def _operators(kind, material=False):
    mesh_a, mesh_b = _mesh(kind, pt), _mesh(kind, et)
    coords = mesh_a.node_coords[mesh_a.connectivity]
    ke, _ = el_p.element_stiffness_batch_np(coords, E=1.0, nu=0.3)
    kw = dict(E0=3.0, Emin=1e-6, nu=0.3, p=3.0)
    op_p = OperatorP(ke, mesh_a.connectivity, mesh_a.n_nodes, **kw,
                     dtype=torch.float64, device="cpu")
    op_r = OperatorR(ke, mesh_b.connectivity, mesh_b.n_nodes, **kw,
                     dtype=jnp.float64)
    if material:
        basis = el_p.element_stiffness_lame_basis_batch_np(coords)
        op_p.set_lame_basis(*basis)
        op_r.set_lame_basis(*basis)
    rng = np.random.default_rng(11)
    u = rng.normal(size=mesh_a.n_dofs)
    rho = rng.uniform(0.05, 1.0, size=mesh_a.n_cells)
    fixed = pt.select_nodes_by_plane(mesh_a, [0, 0, 0], [1, 0, 0], 0.2)
    mask = pt.build_free_mask(mesh_a, [pt.apply_fixed_boundary(mesh_a, fixed)])
    return mesh_a, op_p, op_r, u, rho, mask


@pytest.mark.parametrize("kind", ["tet4", "hex8"])
def test_operator_equals_reference(kind):
    mesh, op_p, op_r, u, rho, mask = _operators(kind)
    scale_p = op_p.youngs_modulus(_t(rho))
    scale_r = op_r.youngs_modulus(jnp.asarray(rho))
    _close(scale_p, scale_r)
    np.testing.assert_array_equal(   # the gather of the dof numbers
        op_p.gather(torch.arange(mesh.n_dofs)).numpy(),
        np.asarray(op_r.dofmap))
    ue_p, q_p = op_p.apply_elements(_t(u))
    ue_r, q_r = op_r.apply_elements(jnp.asarray(u))
    _close(ue_p, ue_r)
    _close(q_p, q_r, atol=1e-13)
    Ku = op_p.apply_K(_t(u), scale_p)
    _close(Ku, op_r.apply_K(jnp.asarray(u), scale_r), atol=1e-12)
    assert torch.equal(Ku, op_p.apply_K(_t(u), scale_p))   # fixed order
    _close(op_p.apply(_t(u), scale_p, _t(mask)),
           op_r.apply(jnp.asarray(u), scale_r, jnp.asarray(mask)),
           atol=1e-12)
    _close(op_p.diagonal(scale_p, _t(mask)),
           op_r.diagonal(scale_r, jnp.asarray(mask)))
    Binv_p = op_p.block_diagonal_inverse(scale_p, _t(mask))
    Binv_r = op_r.block_diagonal_inverse(scale_r, jnp.asarray(mask))
    _close(Binv_p, Binv_r, rtol=1e-10, atol=1e-12)
    _close(op_p.apply_block_jacobi(Binv_p, _t(u)),
           op_r.apply_block_jacobi(Binv_r, jnp.asarray(u)), rtol=1e-10,
           atol=1e-12)
    _close(op_p.element_energies_unit(_t(u)),
           op_r.element_energies_unit(jnp.asarray(u)), atol=1e-12)
    _close(op_p.compliance_sensitivities(_t(u), _t(rho)),
           op_r.compliance_sensitivities(jnp.asarray(u), jnp.asarray(rho)),
           atol=1e-12)
    # K is symmetric: v.K u == u.K v
    v = _t(np.random.default_rng(2).normal(size=mesh.n_dofs))
    assert float(torch.dot(v, Ku)) == pytest.approx(
        float(torch.dot(_t(u), op_p.apply_K(v, scale_p))), rel=1e-12)


@pytest.mark.parametrize("kind", ["tet4", "hex8"])
def test_operator_lame_path_equals_reference(kind):
    mesh, op_p, op_r, u, rho, mask = _operators(kind, material=True)
    model_p = pt.create_simp_material_model(3.0, 0.3, 1e-6, 3.0)
    model_r = et.create_simp_material_model(3.0, 0.3, 1e-6, 3.0)
    lam_p, mu_p = model_p(_t(rho))
    lam_r, mu_r = model_r(jnp.asarray(rho))
    out = op_p.apply_K_lame(_t(u), lam_p, mu_p)
    _close(out, op_r.apply_K_lame(jnp.asarray(u), lam_r, mu_r), atol=1e-12)
    # the SIMP closure is the default law
    _close(out, op_p.apply_K(_t(u), op_p.youngs_modulus(_t(rho))),
           rtol=1e-10, atol=1e-12)
    _close(op_p.apply_lame(_t(u), lam_p, mu_p, _t(mask)),
           op_r.apply_lame(jnp.asarray(u), lam_r, mu_r, jnp.asarray(mask)),
           atol=1e-12)
    for got, want in zip(op_p.element_energies_lame(_t(u)),
                         op_r.element_energies_lame(jnp.asarray(u))):
        _close(got, want, atol=1e-12)


def _element_inputs(kind, dtype):
    """(u, conn, ke, scale, mask) of `_mesh(kind)` in `dtype` on the CPU."""
    mesh = _mesh(kind, pt)
    ke, _ = el_p.element_stiffness_batch_np(
        mesh.node_coords[mesh.connectivity], E=1.0, nu=0.3)
    rng = np.random.default_rng(5)
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    return (t(rng.normal(size=mesh.n_dofs)),
            torch.as_tensor(mesh.connectivity, dtype=torch.int64), t(ke),
            t(rng.uniform(0.05, 1.0, mesh.n_cells)),
            t(rng.uniform(size=mesh.n_dofs) > 0.2))


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["tet4", "hex8"])
def test_element_apply_on_cpu_is_gather_bmm_scale(kind, dtype, scaled):
    """On CPU tensors the kernel's wrapper is its plain version: the
    operator's former gather -> bmm -> scale, bitwise, in per-corner rows
    followed by one zero row; the mask multiplies u first; no launch is
    counted."""
    u, conn, ke, scale, mask = _element_inputs(kind, dtype)
    scale = scale if scaled else None
    E, d = ke.shape[:2]
    dofmap = torch.as_tensor(
        (3 * conn.numpy()[:, :, None] + np.arange(3)).reshape(E, d))
    q = torch.bmm(ke, u[dofmap].unsqueeze(-1)).squeeze(-1)
    if scaled:
        q = q * scale[:, None]
    before = tracing.counters()
    out = ck.element_apply(u, conn, ke, scale)
    assert out.shape == (E * d // 3 + 1, 3) and out.dtype == dtype
    assert torch.equal(out[:-1].reshape(E, d), q)
    assert torch.equal(out[-1], torch.zeros(3, dtype=dtype))
    assert torch.equal(ck.element_apply(u, conn, ke, scale, mask),
                       ck.element_apply(mask * u, conn, ke, scale))
    assert tracing.counters() == before
    assert ck.launches("element_apply", dtype) == before.get(
        f"launch.element_apply.{str(dtype)[6:]}", 0)


@pytest.mark.parametrize("case, error", [
    ("width", ValueError), ("u_shape", ValueError), ("conn_shape", ValueError),
    ("scale_shape", ValueError), ("ke_dtype", TypeError),
    ("conn_dtype", TypeError), ("storage", TypeError), ("device", ValueError),
    ("mixed_devices", ValueError)])
def test_element_apply_rejects_bad_arguments(case, error):
    """A wrong shape, dtype or device raises before any work."""
    u, conn, ke, scale, mask = _element_inputs("tet4", torch.float64)
    args = {"u": u, "conn": conn, "ke": ke, "scale": scale, "mask": mask}
    args.update({
        "width": {"ke": ke[:, :9, :9]},
        "u_shape": {"u": u.reshape(-1, 3)},
        "conn_shape": {"conn": conn[:, :3]},
        "scale_shape": {"scale": scale[1:]},
        "ke_dtype": {"ke": ke.float()},
        "conn_dtype": {"conn": conn.int()},
        "storage": {k: v.half() for k, v in args.items() if k != "conn"},
        "device": {k: v.to("meta") for k, v in args.items()},
        "mixed_devices": {"scale": scale.to("meta")},
    }[case])
    with pytest.raises(error):
        ck.element_apply(**args)


@pytest.mark.parametrize("name, source", [
    ("voxel_kernels", "voxel_kernels.cu"),
    ("element_apply", "element_apply.cu"),
    ("stencil_apply", "stencil_apply.cu")])
def test_each_kernel_library_builds_from_its_own_source(
        name, source, tmp_path, monkeypatch):
    """Each library compiles its own source alone, under a name keyed by
    that source only: no kernel enters or re-keys another's library (the
    voxel library's key is the hash of voxel_kernels.cu as before)."""
    import hashlib

    commands = []

    def run(cmd, **kw):
        commands.append(cmd)
        raise InterruptedError

    monkeypatch.setattr(ck, "_BUILD", tmp_path)
    monkeypatch.setattr(ck, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(ck.subprocess, "run", run)
    with pytest.raises(InterruptedError):
        ck._load(name)
    cu = [a for a in commands[0] if a.endswith((".cu", ".cuh"))]
    assert [a.rsplit("/", 1)[-1] for a in cu] == [source]
    sources, so = ck.library_path(name)
    src = ck._CSRC / source
    key = hashlib.sha256(src.name.encode() + src.read_bytes()).hexdigest()
    assert sources == [src] and so.name == f"{name}_{key[:16]}.so"
    assert all(ck.library_path(other)[1] != so
               for other in ck._LIBRARIES if other != name)


def test_native_search_equals_ckdtree():
    """The port's own build of the C++ grid hash against scipy (as
    tests/test_native.py holds the JAX package's)."""
    if not native.is_available():
        pytest.skip("g++ build unavailable")
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(0)
    centers = rng.uniform(0, 10, (2000, 3))
    radius = 0.8
    offsets, idx, w = native.neighbor_search(centers, radius)
    lists = cKDTree(centers).query_ball_point(centers, r=radius)
    assert offsets[-1] == sum(len(l) for l in lists)
    for i in [0, 17, 500, 1999]:
        mine = idx[offsets[i]:offsets[i + 1]]
        assert set(mine.tolist()) == set(lists[i]) and i in mine
        d = np.linalg.norm(centers[np.sort(mine)] - centers[i], axis=1)
        _close(w[offsets[i]:offsets[i + 1]][np.argsort(mine)],
               np.maximum(0.0, radius - d), rtol=0, atol=1e-12)
    assert "neighbor_search_" in native.get_lib()._name
    assert "_build" in native.get_lib()._name


@pytest.mark.parametrize("route", ["native", "scipy"])
@pytest.mark.parametrize("kind", ["tet4", "hex8"])
def test_filter_equals_reference(kind, route, capsys, monkeypatch):
    if route == "native" and not native.is_available():
        pytest.skip("g++ build unavailable")
    if route == "scipy":      # as on a machine without g++
        monkeypatch.setattr(native, "is_available", lambda: False)
    mesh = _mesh(kind, pt)
    radius = 1.5 * mesh.characteristic_element_size
    vols = mesh.element_volumes
    f_p = filters_p.UnstructuredFilter(
        mesh.cell_centers, vols, radius, dtype=torch.float64, device="cpu")
    assert f_p.neighbor_route == route
    assert ("native C++" if route == "native" else "cKDTree") \
        in capsys.readouterr().out
    f_r = FilterR(mesh.cell_centers, vols, radius, dtype=jnp.float64)
    ref = ReferenceFilter(mesh.cell_centers, vols, radius)
    rng = np.random.default_rng(4)
    rho = rng.uniform(1e-4, 1.0, size=mesh.n_cells)
    sens = -rng.uniform(0.0, 5.0, size=mesh.n_cells)
    assert f_p.neighbors.dtype == torch.int64
    _close(f_p.weight_sum, f_r.weight_sum)
    _close(f_p.wv_sum, f_r.wv_sum)
    _close(f_p.sensitivity_filter(_t(rho), _t(sens)),
           f_r.sensitivity_filter(jnp.asarray(rho), jnp.asarray(sens)))
    dens = f_p.density_filter(_t(rho))
    _close(dens, f_r.density_filter(jnp.asarray(rho)))
    _close(dens, ref.density_filter(rho))
    _close(f_p.chain_rule(_t(sens)), f_r.chain_rule(jnp.asarray(sens)))
    # create_filter_cache dispatches a mesh to this class
    monkeypatch.undo()
    cache = pt.create_filter_cache(mesh, 1.5, dtype=torch.float64,
                                   device="cpu")
    assert isinstance(cache, filters_p.UnstructuredFilter)
    assert isinstance(cache, pt.FilterCacheTypes)
    assert cache.filter_radius == pytest.approx(radius, rel=1e-15)
    _close(cache.density_filter(_t(rho)), dens)


@pytest.mark.parametrize("material", [False, True], ids=["simp", "closure"])
@pytest.mark.parametrize("kind", ["tet4", "hex8"])
def test_unstructured_stresses_equal_reference(kind, material):
    mesh_a, mesh_b = _mesh(kind, pt), _mesh(kind, et)
    rng = np.random.default_rng(8)
    u = rng.normal(size=mesh_a.n_dofs)
    rho = rng.uniform(0.05, 1.0, size=mesh_a.n_cells)
    args = (3.0, 1e-6, 0.3, 3.0)
    kw_p = kw_r = {}
    if material:
        # a law whose Poisson ratio varies with the density, on tensors and
        # on arrays
        def law(rho):
            return pt.lame_parameters(1e-6 + 3.0 * rho**3, 0.2 + 0.2 * rho)

        kw_p = kw_r = {"material_model": law}
    got = pt.unstructured_stresses(mesh_a, u, rho, *args, **kw_p)
    want = stresses_r(mesh_b, u, rho, *args, **kw_r)
    assert got.qp_stresses.shape == (mesh_a.n_cells,
                                     4 if kind == "tet4" else 8, 6)
    _close(got.qp_stresses, want.qp_stresses, atol=1e-13)
    _close(got.avg_stresses, want.avg_stresses, atol=1e-13)
    _close(got.von_mises, want.von_mises, atol=1e-13)
    assert got.max_vm_cell == want.max_vm_cell
    assert got.max_von_mises == pytest.approx(want.max_von_mises, rel=RTOL)
    assert len(got) == mesh_a.n_cells and got[3].shape[1] == 6
