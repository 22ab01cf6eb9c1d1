"""Dataset build → HDF5 contract tests (SURVEY.md section 2 data rows)."""

import numpy as np
import pytest

from fetal_mri_segmentation_tpu.data import (
    open_data_file, write_data_to_file)
from fetal_mri_segmentation_tpu.data.normalize import (
    normalize_data, normalize_data_storage, normalize_data_storage_per_volume)
from tests.synthetic import write_synthetic_dataset


@pytest.fixture(scope="module")
def built_h5(tmp_path_factory):
    d = tmp_path_factory.mktemp("ds")
    files = write_synthetic_dataset(str(d / "nii"), n_cases=3, shape=(24, 24, 24))
    out = str(d / "data.h5")
    write_data_to_file(files, out, image_shape=(16, 16, 16),
                       subject_ids=[f"case_{i}" for i in range(3)],
                       normalize="per_volume", crop=True)
    return out


def test_hdf5_array_contract(built_h5):
    with open_data_file(built_h5) as f:
        assert f.root.data.shape == (3, 1, 16, 16, 16)
        assert f.root.data.dtype == np.float32
        assert f.root.truth.shape == (3, 1, 16, 16, 16)
        assert f.root.truth.dtype == np.uint8
        assert f.root.affine.shape == (3, 4, 4)
        ids = [s.decode() for s in f.root.subject_ids[:]]
        assert ids == ["case_0", "case_1", "case_2"]
        assert len(f) == 3


def test_normalization_per_volume(built_h5):
    with open_data_file(built_h5) as f:
        for i in range(3):
            v = np.asarray(f.root.data[i])
            assert abs(v.mean()) < 1e-4
            assert abs(v.std() - 1.0) < 1e-3


def test_truth_survives_resample(built_h5):
    with open_data_file(built_h5) as f:
        for i in range(3):
            t = np.asarray(f.root.truth[i])
            assert set(np.unique(t)).issubset({0, 1})
            assert t.sum() > 0  # ellipsoid still present


def test_build_deterministic(tmp_path):
    files = write_synthetic_dataset(str(tmp_path / "nii"), n_cases=2,
                                    shape=(20, 20, 20))
    a, b = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    for out in (a, b):
        write_data_to_file(files, out, image_shape=(12, 12, 12),
                           normalize=None, crop=False)
    with open_data_file(a) as fa, open_data_file(b) as fb:
        assert np.array_equal(fa.root.data[:], fb.root.data[:])
        assert np.array_equal(fa.root.truth[:], fb.root.truth[:])


def test_normalize_global_vs_per_volume():
    rng = np.random.default_rng(0)

    class FakeStorage:
        def __init__(self, arr):
            self.arr = arr
            self.shape = arr.shape

        def __getitem__(self, i):
            return self.arr[i]

        def __setitem__(self, i, v):
            self.arr[i] = v

    arr = rng.normal(5, 3, (4, 2, 6, 6, 6)).astype(np.float32)
    per = FakeStorage(arr.copy())
    normalize_data_storage_per_volume(per)
    for i in range(4):
        assert abs(per[i].mean()) < 1e-4

    glob = FakeStorage(arr.copy())
    normalize_data_storage(glob)
    # global: the DATASET is standardized, individual volumes generally not
    allv = glob.arr
    assert abs(allv.mean()) < 0.1


def test_normalize_data_zero_std_guard():
    d = np.ones((1, 4, 4, 4), np.float32)
    out = normalize_data(d, mean=np.array([1.0]), std=np.array([0.0]))
    assert np.isfinite(out).all()


def test_windowed_normalization(tmp_path):
    from fetal_mri_segmentation_tpu.data.normalize import (
        normalize_data_storage_windowed, window_intensities)
    rng = np.random.default_rng(0)
    v = rng.normal(0, 1, (1, 8, 8, 8)).astype(np.float32)
    v[0, 0, 0, 0] = 1000.0  # extreme outlier
    w = window_intensities(v, 1, 99)
    assert w.max() < 1000.0  # outlier clipped
    # windowed z-score leaves near-unit std without outlier domination

    class FakeStorage:
        def __init__(self, arr):
            self.arr = arr
            self.shape = arr.shape

        def __getitem__(self, i):
            return self.arr[i]

        def __setitem__(self, i, val):
            self.arr[i] = val

    st = FakeStorage(v[None].copy())
    normalize_data_storage_windowed(st)
    assert abs(float(st[0].std()) - 1.0) < 0.05


def test_data_file_from_arrays_serves_the_contract():
    """The in-memory DataFile exposes the same .root.* / len / close
    surface the generators read, with no HDF5 file and no h5py."""
    from fetal_mri_segmentation_tpu.data import DataFile

    data = np.random.default_rng(0).normal(size=(3, 1, 8, 8, 8))
    truth = (data > 0).astype(np.uint8)
    df = DataFile.from_arrays(data, truth, subject_ids=["a", "b", "c"])
    assert len(df) == 3
    assert df.root.data.dtype == np.float32
    np.testing.assert_array_equal(df.root.truth[1], truth[1])
    assert df.root.affine.shape == (3, 4, 4)
    assert list(df.root.subject_ids) == ["a", "b", "c"]
    with pytest.raises(AttributeError):
        df.root.missing
    df.close()


def test_open_data_file_without_h5py_says_so(monkeypatch, tmp_path):
    import sys

    from fetal_mri_segmentation_tpu.data import open_data_file

    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py -> error
    with pytest.raises(ImportError, match="need the h5py package"):
        open_data_file(str(tmp_path / "x.h5"))
