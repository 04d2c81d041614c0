"""The port's HDF5 reader and writer (music_generator_tpu_torch/utils/
hdf5.py) against h5py: files h5py writes read back equal through the
port's reader (names, attributes and arrays bit for bit), files the port
writes read back through h5py with the same tree, and what lies outside
the supported subset raises ValueError naming the feature."""

import numpy as np
import pytest

from music_generator_tpu_torch.utils import hdf5

h5py = pytest.importorskip("h5py")


def _tree_h5py(group, prefix=""):
    """{path: value} of every attribute ("path@name") and dataset."""
    out = {}
    for name in group.attrs:
        out[f"{prefix}@{name}"] = group.attrs[name]
    for name in group:
        obj = group[name]
        path = f"{prefix}/{name}"
        if isinstance(obj, h5py.Group):
            out.update(_tree_h5py(obj, path))
        else:
            out[path] = obj[()]
            for a in obj.attrs:
                out[f"{path}@{a}"] = obj.attrs[a]
    return out


def _tree_port(group, prefix=""):
    out = {}
    for name in group.attrs:
        out[f"{prefix}@{name}"] = group.attrs[name]
    for name in group:
        obj = group[name]
        path = f"{prefix}/{name}"
        if isinstance(obj, hdf5.Group):
            out.update(_tree_port(obj, path))
        else:
            out[path] = obj[()]
            for a in obj.attrs:
                out[f"{path}@{a}"] = obj.attrs[a]
    return out


def _assert_trees_equal(got, want):
    assert list(got) == list(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


def _fill(f, case, rng):
    """Write one case's content through an h5py-like API (h5py.File or
    hdf5.Writer)."""
    if case == "string_attrs":
        f.attrs["backend"] = np.bytes_(b"tensorflow")
        f.attrs["layer_names"] = np.array([b"input_1", b"time_distributed_4",
                                           b"style"])
        g = f.create_group("dense_1")
        g.attrs["weight_names"] = np.array([b"dense_1/kernel:0",
                                            b"dense_1/bias:0"])
        g.attrs["empty"] = np.array([], dtype="S1")
    elif case == "empty_float64_attr":
        f.create_group("dropout_1").attrs["weight_names"] = np.array([])
    elif case == "datasets":
        f.create_dataset("f32", data=rng.standard_normal((5, 7))
                         .astype(np.float32))
        f.create_dataset("f64", data=rng.standard_normal(11))
        f.create_dataset("scalar", data=np.float32(2.5))
        f.create_dataset("empty", data=np.zeros((0, 4), np.float32))
    elif case == "nested_groups":
        f.create_dataset("time_distributed_4/lstm_1/kernel:0",
                         data=rng.standard_normal((3, 8)).astype(np.float32))
        f.create_dataset("a/b/c/d/e:0", data=np.arange(3, dtype=np.float32))
        f["a"].attrs["x"] = np.array([1.5, 2.5])
    elif case == "integers":                   # read, not written
        f.create_dataset("i32", data=np.arange(-3, 4, dtype=np.int32))
        f.create_dataset("u8", data=np.arange(5, dtype=np.uint8))
        f.attrs["steps"] = np.array([1, 2], dtype=np.int64)
    elif case in ("group_of_9", "group_of_33", "group_of_200"):
        n = int(case.rsplit("_", 1)[1])
        g = f.create_group("many")
        for i in rng.permutation(n):
            g.create_dataset(f"w{i}", data=np.full(2, i, np.float32))
        for i in range(n):
            f.create_group(f"layer_{i}").attrs["weight_names"] = np.array(
                [], dtype="S1")


CASES = ["string_attrs", "empty_float64_attr", "datasets", "nested_groups",
         "group_of_9", "group_of_33", "group_of_200"]


@pytest.mark.parametrize("case", CASES + ["integers"])
def test_reader_agrees_with_h5py(tmp_path, case):
    path = str(tmp_path / "h5py.h5")
    with h5py.File(path, "w") as f:
        _fill(f, case, np.random.default_rng(0))
    with h5py.File(path, "r") as f:
        want = _tree_h5py(f)
    with hdf5.File(path) as f:
        got = _tree_port(f)
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_h5py_reads_the_writer(tmp_path, case):
    path = str(tmp_path / "port.h5")
    with hdf5.Writer(path) as f:
        _fill(f, case, np.random.default_rng(0))
    ref = str(tmp_path / "h5py.h5")
    with h5py.File(ref, "w") as f:
        _fill(f, case, np.random.default_rng(0))
    with h5py.File(path, "r") as f:
        got = _tree_h5py(f)
        assert f.id.get_create_plist().get_version()[0] == 0   # superblock
    with h5py.File(ref, "r") as f:
        want = _tree_h5py(f)
    _assert_trees_equal(got, want)
    with hdf5.File(path) as f:
        _assert_trees_equal(_tree_port(f), want)


def test_writer_refuses_more_than_256_entries(tmp_path):
    f = hdf5.Writer(str(tmp_path / "big.h5"))
    for i in range(257):
        f.create_dataset(f"d{i}", data=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="257 entries"):
        f.close()


@pytest.mark.parametrize("feature,match", [
    ("gzip", "filter pipeline"),
    ("chunked", "chunked layout"),
    ("latest", "superblock version"),
    ("big_endian", "big-endian"),
    ("vlen_string", "variable-length"),
])
def test_reader_refuses_what_it_does_not_read(tmp_path, feature, match):
    path = str(tmp_path / "x.h5")
    data = np.arange(64, dtype=np.float32)
    with h5py.File(path, "w", libver="latest" if feature == "latest"
                   else "earliest") as f:
        if feature == "gzip":
            f.create_dataset("x", data=data, compression="gzip")
        elif feature == "chunked":
            f.create_dataset("x", data=data, chunks=(8,))
        elif feature == "big_endian":
            f.create_dataset("x", data=data.astype(">f4"))
        elif feature == "vlen_string":
            f.attrs["x"] = "tensorflow"      # h5py writes str as vlen
            f.create_dataset("x", data=data)
        else:
            f.create_dataset("x", data=data)
    with pytest.raises(ValueError, match=match):
        with hdf5.File(path) as f:
            f["x"][()]
            f.attrs["x"]


def test_committed_model_files_read_as_h5py_reads_them():
    """The committed Keras-layout files: every group, dataset and
    fixed-length attribute as h5py reads it; their root `backend` and
    `keras_version` are variable-length strings (h5py 3 writes bytes that
    way), which the reader refuses by name and nothing needs."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "artifacts", "trained_model_r4", "model.h5")
    with h5py.File(path, "r") as f:
        want = _tree_h5py(f)
    vlen = {k for k, v in want.items() if isinstance(v, str)}
    assert vlen == {"@backend", "@keras_version"}
    with hdf5.File(path) as f:
        for key in vlen:
            with pytest.raises(ValueError, match="variable-length"):
                f.attrs[key[1:]]
        got = {}
        for name in f:
            got.update(_tree_port(f[name], f"/{name}"))
        got["@layer_names"] = f.attrs["layer_names"]
    want = {k: v for k, v in want.items() if k not in vlen}
    assert sorted(got) == sorted(want)
    _assert_trees_equal({k: got[k] for k in want}, want)
