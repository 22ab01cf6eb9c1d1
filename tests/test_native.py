"""Native C++ host-path kernels vs numpy oracles (native/fastloader.cpp)."""

import numpy as np
import pytest

from fetal_mri_segmentation_tpu.utils import native
from fetal_mri_segmentation_tpu.ops import patches as P

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")


def _np_patch(data, shape, corner):
    """Pure-numpy oracle (duplicate of the fallback, native disabled)."""
    import os
    os.environ["FETAL_NO_NATIVE"] = "1"
    try:
        return P.get_patch_from_3d_data(data, shape, corner)
    finally:
        os.environ["FETAL_NO_NATIVE"] = "0"


@pytest.mark.parametrize("corner", [(0, 0, 0), (-2, 3, 8), (8, 8, 8),
                                    (-5, -5, -5), (10, 10, 10)])
def test_extract_patch_matches_numpy(corner, rng):
    data = rng.random((2, 12, 12, 12)).astype(np.float32)
    got = native.extract_patch(data, (6, 6, 6), corner)
    want = _np_patch(data, (6, 6, 6), corner)
    assert np.array_equal(got, want)


def test_extract_patches_batch(rng):
    data = rng.random((1, 10, 10, 10)).astype(np.float32)
    corners = np.array([[0, 0, 0], [-2, 4, 4], [6, 6, 6]], np.int64)
    got = native.extract_patches_batch(data, (5, 5, 5), corners)
    assert got.shape == (3, 1, 5, 5, 5)
    for i, c in enumerate(corners):
        assert np.array_equal(got[i], _np_patch(data, (5, 5, 5), c))


def test_overlap_add_matches_numpy(rng):
    shape = (1, 12, 12, 12)
    acc = np.zeros(shape, np.float32)
    wsum = np.zeros(shape[1:], np.float32)
    w = P.gaussian_importance_map((6, 6, 6))
    patches, corners = [], P.compute_patch_indices(shape[1:], (6, 6, 6), 2)
    for c in corners:
        p = rng.random((1, 6, 6, 6)).astype(np.float32)
        patches.append(p)
        assert native.overlap_add(acc, wsum, p, w, c)
    want = P.reconstruct_from_patches(patches, corners, shape, weight_map=w)
    covered = wsum > 0
    got = np.zeros(shape, np.float32)
    got[:, covered] = acc[:, covered] / wsum[covered]
    assert np.allclose(got, want, atol=1e-5)


def test_any_nonzero():
    z = np.zeros((4, 4, 4), np.float32)
    assert native.any_nonzero(z) is False
    z[1, 2, 3] = 0.5
    assert native.any_nonzero(z) is True


def test_hot_path_uses_native_transparently(rng):
    """get_patch_from_3d_data on contiguous f32 must equal the numpy path."""
    data = rng.random((1, 16, 16, 16)).astype(np.float32)
    got = P.get_patch_from_3d_data(data, (8, 8, 8), (-3, 2, 12))
    want = _np_patch(data, (8, 8, 8), (-3, 2, 12))
    assert np.array_equal(got, want)
