"""The port's resize op (``sparkdl_tpu_torch.ops.infeed``) against the JAX
package's (``sparkdl_tpu.ops.infeed``) on the CPU: the same numpy-seeded
inputs through both, the JAX side through its XLA path and through the
Pallas kernel in interpret mode (as tests/test_ops.py runs it).

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version tested here."""

import numpy as np
import pytest
import torch

from sparkdl_tpu.ops import infeed as jax_infeed
from sparkdl_tpu_torch.ops import infeed

# fp32 on both sides; only the summation order differs. Bounds are 1e-5
# of the output's range: 1e-5 on the [-1, 1] scale, 255e-5 on 0..255.
TOL_UNIT = 1e-5
TOL_COUNTS = 255 * 1e-5

# (name, input shape, output hw, scale, offset, input dtype, tolerance):
# the chip smoke's shapes, the main path's 512→299 at batch 2 (the
# per-image math does not depend on the batch, and interpret mode is slow)
CASES = [
    ("main_geometry", (2, 512, 512, 3), (299, 299), 1.0, 0.0, np.uint8,
     TOL_COUNTS),
    ("small_unit", (3, 40, 56, 3), (24, 32), 1 / 127.5, -1.0, np.uint8,
     TOL_UNIT),
    ("upsample", (2, 150, 150, 1), (299, 299), 1.0, 0.0, np.uint8,
     TOL_COUNTS),
    ("fp32_input", (4, 64, 48, 3), (33, 71), 1.0, 0.0, np.float32,
     TOL_COUNTS),
]


def _input(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    if dtype == np.float32:
        x = x.astype(np.float32) * (255 / 256) + rng.random(shape,
                                                            np.float32)
    return x


@pytest.mark.parametrize("src,dst", [(40, 24), (56, 32), (512, 299),
                                     (150, 299), (17, 17), (64, 8)])
def test_weight_matrix_identical_to_jax(src, dst):
    np.testing.assert_array_equal(infeed.bilinear_weight_matrix(src, dst),
                                  jax_infeed.bilinear_weight_matrix(src, dst))


@pytest.mark.parametrize("src,dst", [(512, 299), (150, 299), (40, 24)])
def test_weight_bands_cover_every_nonzero(src, dst):
    w = infeed.bilinear_weight_matrix(src, dst)
    lo, hi = infeed.weight_bands(w)
    cols = np.arange(src)[None, :]
    outside = (cols < lo[:, None]) | (cols >= hi[:, None])
    assert not w[outside].any()
    assert (w[np.arange(dst), lo] != 0).all()
    assert (w[np.arange(dst), hi - 1] != 0).all()


@pytest.mark.parametrize("name,shape,out_hw,scale,offset,dtype,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_jax_xla_and_pallas(name, shape, out_hw, scale,
                                          offset, dtype, tol):
    x = _input(shape, dtype)
    before = infeed.launches
    got = infeed.fused_resize_normalize(torch.from_numpy(x), out_hw, scale,
                                        offset)
    assert infeed.launches == before  # CPU tensors take the plain version
    got = got.numpy()
    xla = np.asarray(jax_infeed.fused_resize_normalize(
        x, out_hw, scale=scale, offset=offset, use_pallas=False))
    pallas = np.asarray(jax_infeed.fused_resize_normalize(
        x, out_hw, scale=scale, offset=offset, use_pallas=True,
        interpret=True))
    assert got.shape == (shape[0], *out_hw, shape[3])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, xla, rtol=0, atol=tol)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=tol)


def test_wrapper_rejects_other_dtypes_and_ranks():
    with pytest.raises(TypeError):
        infeed.fused_resize_normalize(torch.zeros(1, 4, 4, 3,
                                                  dtype=torch.int32), (2, 2))
    with pytest.raises(ValueError):
        infeed.fused_resize_normalize(torch.zeros(4, 4, 3,
                                                  dtype=torch.uint8), (2, 2))
    with pytest.raises(ValueError):
        infeed.fused_resize_normalize(torch.zeros(1, 4, 4, 3,
                                                  dtype=torch.uint8), (0, 2))
