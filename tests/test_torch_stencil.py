"""The port's stencil module against the JAX package's, in float64 on the
CPU: the same numpy inputs through easysimp_tpu.ops.stencil and
easysimp_tpu_torch.ops.stencil.  Tensor functions agree to 1e-12 (relative
to the largest entry), host weights to 1e-15."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import easysimp_tpu as et
from easysimp_tpu.ops import stencil as js
from easysimp_tpu_torch.ops import stencil as ts


def _problem(nels, seed):
    spacing = (0.7, 1.1, 0.9)
    grid = et.generate_grid(nels, (0.0, 0.0, 0.0),
                            tuple(n * s for n, s in zip(nels, spacing)))
    op = et.VoxelOperator(grid, E0=70.0, Emin=1e-6, nu=0.3, p=3.0,
                          dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    scale = np.asarray(op.youngs_modulus(jnp.asarray(
        rng.uniform(0.05, 1.0, nels))))
    u = rng.standard_normal((*grid.nnodes_per_axis, 3))
    mask = np.ones((*grid.nnodes_per_axis, 3))
    mask[0] = 0.0                                # fix the x=0 plane
    mask[-1, 0, :, 1] = 0.0                      # plus a sliding edge
    return np.asarray(op.ke), scale, u, mask


def _close(got, want, rtol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("k", [0, 1, 2])
def test_host_weights_match_reference(k):
    """ke_corner_blocks (k=0), level1_weights (k=1) and
    compose_level_weights from level 1 to 2 (k=2): 1e-15."""
    ke, _, _, _ = _problem((2, 2, 2), seed=0)
    if k == 0:
        got, want = ts.ke_corner_blocks(ke), js.ke_corner_blocks(ke)
    else:
        got, want = ts.level1_weights(ke), js.level1_weights(ke)
        if k == 2:
            got = ts.compose_level_weights(got, 1)
            want = js.compose_level_weights(want, 1)
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


_T, _J = torch.tensor, jnp.asarray


def _cases():
    """name -> (port call, reference call), each on the numpy problem."""
    def assembled(mod, arr, ke, scale):
        return mod.assemble_node_stencil(arr(scale), ke)

    def folded(mod, arr, ke, scale, mask):
        return mod.fold_bc_into_stencil(assembled(mod, arr, ke, scale),
                                        arr(mask))

    return {
        "assemble_node_stencil": lambda mod, arr, ke, s, u, m:
            assembled(mod, arr, ke, s),
        "fold_bc_into_stencil": lambda mod, arr, ke, s, u, m:
            folded(mod, arr, ke, s, m),
        "apply_stencil": lambda mod, arr, ke, s, u, m:
            mod.apply_stencil(folded(mod, arr, ke, s, m), arr(u)),
        "stencil_diagonal": lambda mod, arr, ke, s, u, m:
            mod.stencil_diagonal(folded(mod, arr, ke, s, m)),
        "stencil_row_abs_sums": lambda mod, arr, ke, s, u, m:
            mod.stencil_row_abs_sums(folded(mod, arr, ke, s, m)),
        "coarsen_stencil_axis_0": lambda mod, arr, ke, s, u, m:
            mod.coarsen_stencil_axis(folded(mod, arr, ke, s, m), 0),
        "coarsen_stencil_axis_1": lambda mod, arr, ke, s, u, m:
            mod.coarsen_stencil_axis(folded(mod, arr, ke, s, m), 1),
        "coarsen_stencil_axis_2": lambda mod, arr, ke, s, u, m:
            mod.coarsen_stencil_axis(folded(mod, arr, ke, s, m), 2),
        "coarsen_stencil": lambda mod, arr, ke, s, u, m:
            mod.coarsen_stencil(folded(mod, arr, ke, s, m)),
        "level1_stencil_from_scale": lambda mod, arr, ke, s, u, m:
            mod.level1_stencil_from_scale(arr(s), js.level1_weights(ke)),
        "stencil_to_dense": lambda mod, arr, ke, s, u, m:
            mod.stencil_to_dense(folded(mod, arr, ke, s, m)),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_stencil_function_matches_reference(name):
    """Each stencil function on a 4x2x6 grid with a fixed plane and a
    sliding edge: 1e-12."""
    ke, scale, u, mask = _problem((4, 2, 6), seed=1)
    fn = _cases()[name]
    _close(fn(ts, _T, ke, scale, u, mask), fn(js, _J, ke, scale, u, mask))


@pytest.mark.parametrize("level,chunks", [(1, 1), (1, 3), (2, 1), (3, 1)])
def test_level_stencil_from_scale_matches_reference(level, chunks):
    """The direct im2col build at levels 1-3 on an 8x8x8 grid, whole and
    x-chunked, and its full-precision diagonal: 1e-12."""
    ke, scale, _, _ = _problem((8, 8, 8), seed=2)
    G = js.level1_weights(ke)
    for k in range(1, level):
        G = js.compose_level_weights(G, k)
    got = ts.level_stencil_from_scale(_T(scale), G, level, x_chunks=chunks)
    want = js.level_stencil_from_scale(_J(scale), G, level, x_chunks=chunks)
    _close(got, want)
    _close(ts.level_stencil_diag_from_scale(_T(scale), G, level),
           js.level_stencil_diag_from_scale(_J(scale), G, level))
    # the weight matrix made once into a tensor gives the same stencil
    Gm = _T(ts.level_weight_matrix(G))
    assert torch.equal(ts.level_stencil_from_scale(_T(scale), Gm, level,
                                                   x_chunks=chunks), got)


def test_narrow_storage_build_matches_reference():
    """out_dtype=bfloat16 with x-chunks: the matmul at float64, each slab
    cast as it is produced; equal to the reference's bfloat16 build to one
    bfloat16 rounding (2^-8 of the largest entry)."""
    ke, scale, _, _ = _problem((8, 4, 6), seed=3)
    G = js.level1_weights(ke)
    got = ts.level_stencil_from_scale(_T(scale), G, 1,
                                      out_dtype=torch.bfloat16, x_chunks=2)
    want = js.level_stencil_from_scale(_J(scale), G, 1,
                                       out_dtype=jnp.bfloat16, x_chunks=2)
    assert got.dtype == torch.bfloat16
    _close(got.double(), np.asarray(want, dtype=np.float64), rtol=2 ** -8)


def test_stencil_to_dense_index_once():
    """The dense index made once (`dense_index`) gives the matrix that
    stencil_to_dense builds on its own, and every destination is unique."""
    ke, scale, _, mask = _problem((4, 2, 2), seed=4)
    C = ts.fold_bc_into_stencil(ts.assemble_node_stencil(_T(scale), ke),
                                _T(mask))
    src, dst = ts.dense_index(C.shape[5:])
    assert np.unique(dst).size == dst.size
    K = ts.stencil_to_dense(C, (torch.as_tensor(src), torch.as_tensor(dst)))
    assert torch.equal(K, ts.stencil_to_dense(C))
    np.testing.assert_allclose(K.numpy(), K.numpy().T, rtol=0, atol=1e-12)
