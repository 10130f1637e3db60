"""`tepose_tpu_torch.data.h5` against h5py, the yardstick here (the GPU
host has no h5py): the reader on files h5py writes with the InstaVariety
builder's settings and the other features the port's files use, lazy row
slices that read only their chunks, the writer's file read back by h5py
and by the reader equal to what h5py's writer gives for the same appends,
and clear errors outside the subset. No JAX program is built here.
"""

import json
import os
import sys

import numpy as np
import pytest

from tepose_tpu_torch.data.h5 import H5FormatError, H5Writer, open_h5

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

h5py = pytest.importorskip("h5py")


def _append_h5py(f, dsets, key, rows):
    """The builder's h5py writer (`tools/preprocess/insta.py`): the first
    batch creates a resizable chunked dataset, later ones resize and
    write."""
    if key not in dsets:
        dsets[key] = f.create_dataset(key, data=rows,
                                      maxshape=(None,) + rows.shape[1:],
                                      chunks=True)
    else:
        d = dsets[key]
        d.resize(d.shape[0] + rows.shape[0], axis=0)
        d[-rows.shape[0]:] = rows


def _batches(seed=0, n_batches=6):
    """InstaVariety-like batches: one video of 1-40 frames each."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n_batches):
        n = int(rs.randint(1, 40))
        out.append({
            "vid_name": np.array([f"insta_0000_{i:04d}".encode()] * n),
            "frame_id": np.arange(n),
            "joints2D": rs.randn(n, 25, 3).astype(np.float32),
            "bbox": rs.rand(n, 4).astype(np.float32),
            "features": rs.randn(n, 2048).astype(np.float32)})
    return out


def _write_case(path, case):
    rs = np.random.RandomState(1)
    kw = {"userblock_size": 512} if case == "userblock" else {}
    with h5py.File(path, "w", **kw) as f:
        if case == "builder":
            dsets = {}
            for batch in _batches():
                for k, v in batch.items():
                    _append_h5py(f, dsets, k, v)
        elif case == "gzip":
            f.create_dataset("x", data=rs.randn(300, 7).astype(np.float32),
                             chunks=(8, 3), compression="gzip")
            f.create_dataset("i", data=rs.randint(-9, 9, (70, 2, 3)),
                             chunks=(16, 1, 3), compression="gzip")
        elif case == "shuffle_gzip":
            f.create_dataset("x", data=rs.randn(301, 5), chunks=(10, 5),
                             compression="gzip", shuffle=True)
        elif case == "contiguous":
            f.create_dataset("x", data=rs.randn(40, 3, 2).astype(np.float32))
            f.create_dataset("u", data=np.arange(300, dtype=np.uint16))
            f.create_dataset("scalar", data=2.5)
        elif case == "userblock":     # MATLAB v7.3: HDF5 after 512 bytes
            f.create_dataset("annot2", data=rs.randn(12, 1, 17, 2),
                             chunks=(4, 1, 17, 2), compression="gzip")
            f.create_dataset("valid_frame", data=np.ones((1, 12)))
        elif case == "strings":
            f.create_dataset("s", data=np.array([b"a", b"bcd", b"", b"ef"]))
            f.create_dataset("c", data=np.array([b"vid_%03d" % i
                                                 for i in range(50)]),
                             chunks=(7,), maxshape=(None,))
        elif case == "bigendian":
            f.create_dataset("f", data=rs.randn(20, 3).astype(">f4"))
            f.create_dataset("d", data=rs.randn(20).astype(">f8"),
                             chunks=(6,), compression="gzip")
            f.create_dataset("i", data=np.arange(-5, 15).astype(">i2"))
        elif case == "deep_btree":    # 2,500 chunks: an internal node
            f.create_dataset("x", data=rs.randn(5000, 2).astype(np.float32),
                             chunks=(2, 2), maxshape=(None, 2))
        elif case == "fill":          # chunks never written read the fill
            d = f.create_dataset("x", shape=(100, 3), dtype=np.float32,
                                 chunks=(10, 3), fillvalue=7.0)
            d[15:32] = 1.0


CASES = ("builder", "gzip", "shuffle_gzip", "contiguous", "userblock",
         "strings", "bigendian", "deep_btree", "fill")


def _same_as_h5py(path):
    with h5py.File(path, "r") as want, open_h5(path) as got:
        assert got.keys() == list(want.keys())
        for k in want:
            w, g = want[k], got[k]
            assert (g.shape, g.dtype) == (w.shape, w.dtype), k
            a = np.asarray(g)
            assert a.dtype == w.dtype and np.array_equal(a, w[()]), k
            if not w.shape:
                continue
            n = w.shape[0]
            for s in (slice(0, 1), slice(3, 7), slice(n - 2, n + 5),
                      slice(-3, None), slice(5, 5)):
                assert np.array_equal(g[s], w[s]), (k, s)
            assert np.array_equal(g[n // 2], w[n // 2]) and \
                np.array_equal(g[-1], w[-1]), k
            assert len(g) == len(w)


@pytest.mark.parametrize("case", CASES)
def test_reader_equals_h5py(tmp_path, case):
    path = str(tmp_path / f"{case}.h5")
    _write_case(path, case)
    _same_as_h5py(path)
    if case == "builder":
        with h5py.File(path, "r") as f:     # chunked and resizable
            assert f["features"].chunks is not None and \
                f["features"].maxshape == (None, 2048)
    if case == "userblock":
        with open(path, "rb") as f:
            assert f.read(520)[512:520] == b"\x89HDF\r\n\x1a\n"


@pytest.mark.parametrize("rows", [(0, 1), (100, 110), (4998, 5000),
                                  (777, 1901)])
def test_row_slices_read_only_their_chunks(tmp_path, rows):
    """(5000, 2) in (2, 2) chunks, indexed by a B-tree with an internal
    node: a slice reads the chunks covering its rows, and no other."""
    path = str(tmp_path / "deep.h5")
    _write_case(path, "deep_btree")
    with h5py.File(path, "r") as f:
        want = f["x"][rows[0]:rows[1]]
    with open_h5(path) as f:
        x = f["x"]
        assert x.chunks == (2, 2)
        got = x[rows[0]:rows[1]]
        first, last = rows[0] // 2, (rows[1] - 1) // 2
        assert x.chunks_read == last - first + 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batches", [1, 6])
def test_writer_equals_h5py_writer(tmp_path, batches):
    """The same appends through H5Writer and through the builder's h5py
    writer: h5py and the port's reader read H5Writer's file equal to the
    h5py file (values, shapes and dtypes); no temporary file is left."""
    mine, ref = str(tmp_path / "mine.h5"), str(tmp_path / "ref.h5")
    with H5Writer(mine) as w, h5py.File(ref, "w") as f:
        dsets = {}
        for batch in _batches(seed=2, n_batches=batches):
            for k, v in batch.items():
                w.append(k, v)
                _append_h5py(f, dsets, k, v)
        assert not os.path.exists(mine)       # renamed into place at close
    assert sorted(os.listdir(tmp_path)) == ["mine.h5", "ref.h5"]
    with h5py.File(ref, "r") as want, h5py.File(mine, "r") as got:
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k][()], want[k][()], err_msg=k)
    _same_as_h5py(mine)


def test_writer_casts_later_rows_and_drops_its_spills_on_error(tmp_path):
    path = str(tmp_path / "x.h5")
    with H5Writer(path) as w:
        w.append("a", np.array([[1.5, 2.0]], np.float32))
        w.append("a", np.array([[3, 4]], np.int64))     # cast, as h5py does
        w.append("b", np.array([1.0], ">f8"))
        with pytest.raises(ValueError, match="shape"):
            w.append("a", np.zeros((1, 3)))
    with open_h5(path) as f:
        np.testing.assert_array_equal(f["a"][()], [[1.5, 2.0], [3, 4]])
        assert f["a"].dtype == np.float32 and f["b"].dtype == ">f8"
    with pytest.raises(RuntimeError):
        with H5Writer(str(tmp_path / "y.h5")) as w:
            w.append("a", np.zeros((4, 2)))
            raise RuntimeError("the builder failed")
    assert sorted(os.listdir(tmp_path)) == ["x.h5"]


@pytest.mark.parametrize("case", ["superblock_v2", "fletcher32", "lzf",
                                  "not_hdf5", "group"])
def test_unsupported_files_raise_naming_the_file(tmp_path, case):
    path = str(tmp_path / f"{case}.h5")
    if case == "not_hdf5":
        with open(path, "wb") as f:
            f.write(b"\0" * 4096)
    else:
        kw = {"libver": "latest"} if case == "superblock_v2" else {}
        with h5py.File(path, "w", **kw) as f:
            x = np.arange(40.0)
            if case == "fletcher32":
                f.create_dataset("x", data=x, chunks=(8,), fletcher32=True)
            elif case == "lzf":
                f.create_dataset("x", data=x, chunks=(8,), compression="lzf")
            elif case == "group":
                f.create_group("g").create_dataset("x", data=x)
            else:
                f.create_dataset("x", data=x)
    feature = {"superblock_v2": "superblock version", "fletcher32":
               "fletcher32", "lzf": "lzf", "not_hdf5": "no HDF5 signature",
               "group": "a group"}[case]
    with pytest.raises(H5FormatError, match=feature) as err:
        with open_h5(path) as f:
            np.asarray(f[f.keys()[0]])
    assert path in str(err.value)


def test_insta_golden_spec_inputs_and_host_arrays(tmp_path, monkeypatch):
    """chip_smoke.py phase 15's committed golden
    (tools/make_torch_insta_golden.py): its spec, the SHA-256 of its inputs
    (the tfrecord shards fabricated here, the committed annot_data.mat, the
    MPI-INF-3DHP frames) and the JAX builder's host arrays, equal to what
    the port's builder writes on the CPU with h5py blocked and a stub
    feature extractor (no model runs here)."""
    import make_torch_insta_golden as ig
    from tepose_tpu_torch.preprocess import insta

    assert os.path.getsize(ig.GOLDEN_PATH) < 8 << 20
    golden = ig.load_golden()
    assert golden["spec"] == json.loads(json.dumps(ig.SPEC))
    folder = ig.fabricate_insta(str(tmp_path))
    assert ig.input_checksums(folder) == golden["input_sha256"]

    class StubExtractor:
        def __init__(self, backbone, mesh=None):
            pass

        def extract_from_frames(self, frames, bboxes, scale):
            assert scale == 1.2 and len(frames) == len(bboxes)
            assert all(f.shape == (ig.SPEC["height"], ig.SPEC["width"], 3)
                       for f in frames)
            return np.zeros((len(frames), 2048), np.float32)

    monkeypatch.setattr(insta, "FeatureExtractor", StubExtractor)
    path = str(tmp_path / "insta_train_db.h5")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        insta.read_data(folder, path, backbone=object(), device="cpu",
                        decode=ig.decode_png)
    with open_h5(path) as f:
        assert sorted(f.keys()) == sorted(
            k[3:] for k in golden if k.startswith("db/"))
        for k in ig.HOST_KEYS:
            got, want = f[k][()], golden[f"db/{k}"]
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
        n = len(f["vid_name"])
    lengths = [t for shard in ig.SPEC["videos"] for t in shard]
    assert 6 in lengths and n < sum(lengths)  # dropped frames and a video
    assert golden["db/features"].shape == (n, 2048)
    assert golden["pseudo_theta"].shape == (n, 85)
    for i in ig.SPEC["items"]:
        assert golden[f"item{i}/features"].shape == (
            2, ig.SPEC["item_vidlen"], 2048)
    assert golden["mpii3d/features"].shape == (ig.SPEC["mpii3d_frames"],
                                               2048)
