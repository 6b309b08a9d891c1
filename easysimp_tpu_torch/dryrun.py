"""Single-device check and multi-device dry run of the port.

The twin of `__graft_entry__.py:17-166` of the JAX package:

entry(device)        -> (fn, example_args): one full SIMP iteration (density
                        filter -> multigrid-PCG solve -> sensitivities ->
                        filter -> OC bisection) on the 32x16x8 cantilever.
dryrun_multichip(n)  -> one SIMP step of the 16x8x8 float32 cantilever
                        (max_cg=50) over n-shard ("x","y","z") meshes: the
                        slab `best_mesh_shape(n, (16, 8, 8))` and, for n = 8,
                        the pencil (4, 2, 1) and the cube (2, 2, 2); then the
                        element-sharded step of a 96-tet mesh.

Where the reference puts n virtual devices in one process, the port puts n
shards on the given devices: by default the visible CUDA cards, repeated
round-robin up to n (so one card holds all n shards), or e.g. ["cpu"] * 8.
Each run prints the reference's line, with the shard-local block shapes in
place of its padded ones.  Reference figures (MULTICHIP_r05.json): energy
4.009019e+01 with CG 11 on all three splits, 8.712991e+01 for the tets.

    python -m easysimp_tpu_torch.dryrun [--devices cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def _build(nels, mesh=None, dtype="float32", max_cg=200, device="cuda"):
    import easysimp_tpu_torch as pt
    from easysimp_tpu_torch.opt.optimize import build_voxel_step

    nx, ny, nz = nels
    grid = pt.generate_grid(nels, (0.0, 0.0, 0.0),
                            tuple(float(n) for n in nels))
    fixed = pt.select_nodes_by_plane(grid, [0, 0, 0], [1, 0, 0], 1e-6)
    bc = pt.apply_fixed_boundary(grid, fixed)
    load = pt.PointLoad(
        pt.select_nodes_by_box(grid, [nx, 0, 0], [nx, 0, nz]),
        [0.0, -1.0, 0.0])
    params = pt.OptimizationParameters(
        E0=1.0, Emin=1e-9, nu=0.3, p=3.0, volume_fraction=0.4,
        filter_radius=1.5, dtype=dtype, cg_rtol=1e-6, cg_maxiter=max_cg)
    return build_voxel_step(grid, [load], [bc], params, device=device,
                            mesh=mesh)


def _one_step(vs):
    """Power estimation, preconditioner setup and one SIMP iteration from
    the initial design (the reference's power_init + step)."""
    pvecs = vs.power_init(vs.design0)
    state, _ = vs.setup(vs.design0, pvecs)
    return vs.step(vs.design0, vs.u0, state)


def entry(device="cuda"):
    """One full SIMP iteration on the flagship model + example args."""
    vs = _build((32, 16, 8), device=device)

    def fn(design, u):
        pvecs = vs.power_init(design)
        state, _ = vs.setup(design, pvecs)
        return vs.step(design, u, state)

    return fn, (vs.design0, vs.u0)


def dryrun_multichip(n_devices: int, devices=None) -> list:
    """One sharded SIMP step per mesh split (tiny shapes); returns
    (shape, energy, CG iterations) per voxel split and ("tets", energy,
    None) for the element-sharded step."""
    from easysimp_tpu_torch.parallel.sharding import (
        best_mesh_shape,
        make_mesh,
        round_robin_cards,
    )

    if devices is None:
        devices = round_robin_cards(n_devices)
    devices = [torch.device(d) for d in devices][:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    nels = (16, 8, 8)
    # 1-D slab, 2-D pencil and 3-D cube: every mesh rank runs its own
    # halo-exchange pattern
    shapes = [best_mesh_shape(n_devices, nels)]
    if n_devices == 8:
        shapes += [(4, 2, 1), (2, 2, 2)]
    results = []
    for shape in shapes:
        mesh = make_mesh(n_devices, shape=shape, devices=devices)
        vs = _build(nels, mesh=mesh, max_cg=50, device=devices[0].type)
        out = _one_step(vs)
        energy = float(out.energy)
        if not np.isfinite(energy):
            raise RuntimeError("non-finite energy in sharded step")
        if tuple(out.new_design.shape) != tuple(vs.design0.shape):
            raise RuntimeError("sharded step changed the design's shape")
        u = out.u
        print(f"dryrun_multichip OK: mesh={shape} devices={n_devices} "
              f"energy={energy:.6e} cg_iters={out.cg_iters} "
              f"u_global={tuple(u.shape)} "
              f"u_local={tuple(u.blocks[0].shape)}", flush=True)
        results.append((shape, energy, out.cg_iters))
    results.append(("tets", _dryrun_unstructured(n_devices, devices), None))
    return results


def _dryrun_unstructured(n_devices, devices):
    """Element-sharded unstructured step on a 96-tet mesh (ke batch, dof
    map and densities split over an ("e",) mesh)."""
    import easysimp_tpu_torch as pt
    from easysimp_tpu_torch.opt.optimize_unstructured import (
        build_unstructured_step,
    )
    from easysimp_tpu_torch.parallel.sharding import make_element_mesh

    # 6-tet decomposition of a small voxel block (96 tets, % 8 == 0), in the
    # reference's element order
    grid = pt.generate_grid((4, 2, 2), (0.0, 0.0, 0.0), (4.0, 2.0, 2.0))
    conn = grid.hex_connectivity
    tets = [(0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
            (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6)]
    mesh = pt.UnstructuredMesh(
        node_coords=grid.node_coords,
        connectivity=np.concatenate([conn[:, list(t)] for t in tets], axis=0))
    bc = pt.apply_fixed_boundary(
        mesh, pt.select_nodes_by_plane(mesh, [0, 0, 0], [1, 0, 0], 1e-6))
    load = pt.PointLoad(
        pt.select_nodes_by_box(mesh, [4, 0, 0], [4, 0, 2]), [0.0, -1.0, 0.0])
    params = pt.OptimizationParameters(
        E0=1.0, Emin=1e-9, volume_fraction=0.4, filter_radius=1.5,
        dtype="float32", cg_rtol=1e-6, cg_maxiter=200)
    emesh = make_element_mesh(mesh.n_cells, n_devices, devices=devices)
    us = build_unstructured_step(mesh, [load], [bc], params,
                                 device=devices[0].type, device_mesh=emesh)
    energy = float(us.step(us.design0, us.u0)[3])
    if not np.isfinite(energy):
        raise RuntimeError("non-finite unstructured energy")
    print(f"dryrun_multichip OK (unstructured): e-mesh devices="
          f"{emesh.size} elements={mesh.n_cells} energy={energy:.6e}",
          flush=True)
    return energy


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--devices", default=None,
                        help="'cpu' for eight CPU shards (default: the CUDA "
                             "cards, round-robin)")
    parser.add_argument("-n", type=int, default=8, help="shards (8)")
    args = parser.parse_args()
    devices = [args.devices] * args.n if args.devices else None
    device = args.devices or "cuda"
    fn, example = entry(device)
    print(f"entry OK: energy={float(fn(*example).energy):.6e}", flush=True)
    dryrun_multichip(args.n, devices)


if __name__ == "__main__":
    main()
