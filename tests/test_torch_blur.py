"""Port variable-sigma blur vs the JAX package's: within 2e-5 (the JAX
package's own bar against the reference loop; the two differ only in how
exp rounds), at tap bounds 0, 3 and 9."""

import numpy as np
import pytest
import torch

from raytracingdiffusioncurves_tpu.ops import blur as jblur
from raytracingdiffusioncurves_torch.ops import blur as tblur


@pytest.mark.parametrize("radius", [0, 3, 9])
def test_blur_matches_jax(radius):
    rng = np.random.default_rng(radius)
    img = rng.uniform(0, 1, (17, 23, 4)).astype(np.float32)
    sigma = rng.uniform(0, radius / 3.0, (17, 23)).astype(np.float32)
    sigma[rng.uniform(size=sigma.shape) < 0.2] = 0.0
    want = np.asarray(jblur.variable_gaussian_blur(img, sigma, radius=radius))
    got = tblur.variable_gaussian_blur(torch.from_numpy(img), torch.from_numpy(sigma), radius)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_zero_sigma_is_exact_identity():
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.uniform(0, 1, (9, 11, 4)).astype(np.float32))
    out = tblur.variable_gaussian_blur(img, torch.zeros(9, 11), 6)
    assert torch.equal(out, img)
