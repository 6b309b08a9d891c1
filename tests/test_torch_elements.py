"""The port's hex8 element math against the JAX package (float64 numpy on
both sides; tolerance 1e-13)."""

import numpy as np
import pytest

from easysimp_tpu.ops import elements as ref
from easysimp_tpu_torch.ops import elements as port


@pytest.mark.parametrize("spacing,nu", [
    ((1.0, 1.0, 1.0), 0.3),
    ((0.5, 1.25, 2.0), 0.3),
    ((0.1, 0.1, 0.3), 0.45),
])
def test_hex8_stiffness(spacing, nu):
    np.testing.assert_allclose(port.hex8_stiffness(spacing, E=2.5, nu=nu),
                               ref.hex8_stiffness(spacing, E=2.5, nu=nu),
                               rtol=1e-13, atol=1e-13)
    B_p, w_p = port.hex8_b_matrices(spacing)
    B_r, w_r = ref.hex8_b_matrices(spacing)
    np.testing.assert_allclose(B_p, B_r, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(w_p, w_r, rtol=1e-13, atol=1e-13)


def test_material_law_and_corners():
    assert port.HEX_CORNERS == ref.HEX_CORNERS
    rho = np.linspace(0.0, 1.0, 11)
    np.testing.assert_allclose(port.simp_youngs_modulus(rho, 3.0, 1e-9, 3.0),
                               ref.simp_youngs_modulus(rho, 3.0, 1e-9, 3.0),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(port.lame_parameters(rho + 1.0, 0.3),
                               ref.lame_parameters(rho + 1.0, 0.3),
                               rtol=1e-13)
