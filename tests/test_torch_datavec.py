"""The port's native IO library, normalizers, DataVec readers and
synthetic datasets against the JAX package's, on the CPU.

- Native IO (``native``, ``datasets/native_batcher.py``), with the
  library built from the port's own copy of the C++ source and with the
  NumPy fallbacks (``native_mode``): ``csv_read_floats`` (strict and
  not), ``idx_read``, ``gather_rows`` plain and fused with the
  standardization, ``one_hot`` and ``NativeBatchIterator`` equal the
  reference's arrays bit for bit, and the built library's equal the
  fallbacks' where the text holds exact binary fractions.
- Normalizers: the statistics, ``transform``/``revert`` and the saved
  files cross both ways, exactly (the same float64 and float32 numpy).
- DataVec: records and iterators over temporary CSV and sequence files
  (both alignments and their masks, string labels, the MultiDataSet
  reader) equal the reference's; ``ImageRecordReader`` only where PIL
  imports.
- The synthetic CIFAR-10, LFW and curves sets equal the reference's bit
  for bit; ``read_idx`` reads MNIST's format natively and from ``.gz``.
"""

import gzip
import os
import struct

import numpy as np
import pytest

from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.datasets import cifar as jcifar
from deeplearning4j_tpu.datasets import curves as jcurves
from deeplearning4j_tpu.datasets import lfw as jlfw
from deeplearning4j_tpu.datasets import native_batcher as jbatcher
from deeplearning4j_tpu.datasets import normalizers as jnorm
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.datavec import iterator as jdv_it
from deeplearning4j_tpu.datavec import records as jdv_rec
from deeplearning4j_tpu_torch import native as tnative
from deeplearning4j_tpu_torch.datasets import cifar as tcifar
from deeplearning4j_tpu_torch.datasets import curves as tcurves
from deeplearning4j_tpu_torch.datasets import lfw as tlfw
from deeplearning4j_tpu_torch.datasets import mnist as tmnist
from deeplearning4j_tpu_torch.datasets import native_batcher as tbatcher
from deeplearning4j_tpu_torch.datasets import normalizers as tnorm
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.datavec import iterator as tdv_it
from deeplearning4j_tpu_torch.datavec import records as tdv_rec


@pytest.fixture(params=["built", "numpy"])
def native_mode(request, monkeypatch):
    """Both packages with their built libraries, or both on the NumPy
    fallbacks."""
    if request.param == "numpy":
        for mod in (tnative, jnative):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
    else:
        assert tnative.get_lib() is not None, "the port's library did not build"
    return request.param


def _rng(seed=0):
    return np.random.default_rng(seed)


def _write_idx(path, arr, code):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, code, arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


# ------------------------------------------------------------ native IO

def test_library_builds_from_the_ports_copy():
    """From the port's own source, into a directory git ignores."""
    lib = tnative.get_lib()
    assert lib is not None and tnative.LIB.startswith(tnative.BUILD_DIR)
    assert os.path.dirname(tnative.SRC) == os.path.dirname(tnative.__file__)
    assert hasattr(lib, "dl4j_gather_normalize")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, ".gitignore")) as f:
        assert "deeplearning4j_tpu_torch/native/_build/" in f.read().split()


@pytest.mark.parametrize("strict", [False, True])
def test_csv_read_floats(tmp_path, native_mode, strict):
    data = _rng().standard_normal((300, 7)).astype(np.float32)
    path = str(tmp_path / "d.csv")
    with open(path, "w") as f:
        f.write("h1,h2\n\n")  # a header and a blank line
        np.savetxt(f, data, delimiter=",", fmt="%.7g")
    got = tnative.csv_read_floats(path, skip_rows=1, strict=strict)
    np.testing.assert_array_equal(got, jnative.csv_read_floats(
        path, skip_rows=1, strict=strict))
    np.testing.assert_allclose(got, data, rtol=1e-6)
    bad = str(tmp_path / "bad.csv")
    with open(bad, "w") as f:
        f.write('1.5,"2.5"\nx,4.0\n')
    if strict:
        with pytest.raises(ValueError, match="non-numeric"):
            tnative.csv_read_floats(bad, strict=True)
    else:
        np.testing.assert_array_equal(tnative.csv_read_floats(bad),
                                      [[1.5, 2.5], [0.0, 4.0]])


def test_csv_built_equals_fallback_on_exact_fractions(tmp_path, monkeypatch):
    q = _rng(2).integers(-4096, 4096, (500, 9)).astype(np.float32) / 512
    path = str(tmp_path / "q.csv")
    np.savetxt(path, q, delimiter=",", fmt="%.10g")
    built = tnative.csv_read_floats(path)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    np.testing.assert_array_equal(built, tnative.csv_read_floats(path))
    np.testing.assert_array_equal(built, q)


@pytest.mark.parametrize("code,dtype", [(0x08, np.uint8), (0x0D, ">f4"),
                                        (0x0C, ">i4")])
def test_idx_read(tmp_path, native_mode, code, dtype):
    arr = (_rng().standard_normal((6, 5, 4)) * 100).astype(dtype)
    path = str(tmp_path / "t.idx")
    _write_idx(path, arr, code)
    got = tnative.idx_read(path)
    want = jnative.idx_read(path)
    if native_mode == "numpy":
        assert got is None and want is None
    else:
        np.testing.assert_array_equal(got, want)
        assert got.dtype.byteorder in ("=", "|")
    np.testing.assert_array_equal(tmnist.read_idx(path), arr.astype(
        np.dtype(dtype).newbyteorder("=")))
    gz = str(tmp_path / "t.idx.gz")
    _write_idx(gz, arr, code)
    assert tnative.idx_read(gz) is None
    np.testing.assert_array_equal(tmnist.read_idx(gz), tmnist.read_idx(path))


def test_gather_rows_and_one_hot(native_mode):
    rng = _rng(3)
    src = rng.standard_normal((257, 3, 4)).astype(np.float32)
    idx = rng.integers(0, 257, 64)
    mean = rng.standard_normal(12).astype(np.float32)
    std = np.abs(rng.standard_normal(12)).astype(np.float32)
    std[3] = 0.0  # reads 1
    for args in ((), (mean, std)):
        got = tbatcher.gather_rows(src, idx, *args)
        np.testing.assert_array_equal(got, jbatcher.gather_rows(src, idx, *args))
        assert got.shape == (64, 3, 4)
    np.testing.assert_array_equal(tbatcher.gather_rows(src, idx),
                                  src[idx])
    ids = rng.integers(0, 9, 100)
    np.testing.assert_array_equal(tbatcher.one_hot(ids, 9), jbatcher.one_hot(ids, 9))
    np.testing.assert_array_equal(tbatcher.one_hot(ids[:, None], 9),
                                  np.eye(9, dtype=np.float32)[ids])
    with pytest.raises(IndexError):
        tbatcher.gather_rows(src, np.array([257]))
    with pytest.raises(IndexError):
        tbatcher.one_hot(np.array([9]), 9)
    with pytest.raises(ValueError, match="BOTH"):
        tbatcher.gather_rows(src, idx, mean)


def test_gather_built_equals_fallback(monkeypatch):
    rng = _rng(4)
    src = rng.standard_normal((300, 50)).astype(np.float32)
    idx = rng.integers(0, 300, 128)
    mean, std = src.mean(0), src.std(0)
    built = [tbatcher.gather_rows(src, idx), tbatcher.gather_rows(src, idx, mean, std),
             tbatcher.one_hot(idx % 7, 7)]
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    fallback = [tbatcher.gather_rows(src, idx), tbatcher.gather_rows(src, idx, mean, std),
                tbatcher.one_hot(idx % 7, 7)]
    for a, b in zip(built, fallback):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("labels", ["ids", "one_hot", "dense"])
def test_native_batch_iterator(native_mode, labels):
    rng = _rng(5)
    x = rng.standard_normal((83, 5)).astype(np.float32)
    y = rng.integers(0, 4, 83)
    if labels == "dense":
        y = rng.standard_normal((83, 2)).astype(np.float32)
    kw = dict(batch_size=16, seed=3, normalize=True,
              num_classes=4 if labels == "one_hot" else None)
    t = tbatcher.NativeBatchIterator(x, y, **kw)
    j = jbatcher.NativeBatchIterator(x, y, **kw)
    for _ in range(2):  # two epochs, each reshuffled
        got, want = list(t), list(j)
        assert [b.num_examples() for b in got] == [16] * 5 + [3]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.features, b.features)
            np.testing.assert_array_equal(a.labels, b.labels)
    with pytest.raises(ValueError, match="mismatch"):
        tbatcher.NativeBatchIterator(x[:4], y[:5], 2)


# ------------------------------------------------------------ normalizers

def _norm_data(rng, n=64):
    x = rng.normal(5.0, 3.0, (n, 4)).astype(np.float32)
    return x, np.zeros((n, 1), np.float32)


@pytest.mark.parametrize("kind", ["standardize", "minmax", "image"])
def test_normalizers_and_their_files_cross(tmp_path, kind):
    x, y = _norm_data(_rng(6))
    make = {"standardize": (tnorm.NormalizerStandardize, jnorm.NormalizerStandardize),
            "minmax": (lambda: tnorm.NormalizerMinMaxScaler(-1.0, 2.0),
                       lambda: jnorm.NormalizerMinMaxScaler(-1.0, 2.0)),
            "image": (tnorm.ImagePreProcessingScaler, jnorm.ImagePreProcessingScaler)}[kind]
    t = make[0]().fit(ListDataSetIterator(DataSet(x, y), 16))
    j = make[1]().fit(JList(JDataSet(x, y), 16))
    assert t._state() == j._state()
    ds, jds = DataSet(x, y), JDataSet(x, y)
    np.testing.assert_array_equal(t.transform(ds).features, j.transform(jds).features)
    np.testing.assert_array_equal(t.revert(t.transform(ds)).features,
                                  j.revert(j.transform(jds)).features)
    np.testing.assert_array_equal(t.pre_process(ds).features,
                                  j.transform(jds).features)
    # a file saved by either package loads in the other
    tp, jp = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    t.save(tp)
    j.save(jp)
    for cls_t, cls_j in ((type(t), type(j)),):
        np.testing.assert_array_equal(cls_t.load(jp).transform(ds).features,
                                      cls_j.load(tp).transform(jds).features)
    with open(tp) as a, open(jp) as b:
        assert a.read() == b.read()


def test_standardize_leaves_out_masked_timesteps():
    rng = _rng(7)
    x = rng.standard_normal((4, 5, 3)).astype(np.float32)
    m = (rng.random((4, 5)) > 0.3).astype(np.float32)
    t = tnorm.NormalizerStandardize().fit(DataSet(x, x, m, m))
    j = jnorm.NormalizerStandardize().fit(JDataSet(x, x, m, m))
    np.testing.assert_array_equal(t.mean, j.mean)
    np.testing.assert_array_equal(t.std, j.std)


# ---------------------------------------------------------------- DataVec

CSV = ["1,2,0", "3,4,1", "5,6,2", "7,8,0", "9,10,1"]


def _same(a, b):
    for key in ("features", "labels", "features_mask", "labels_mask"):
        ga, gb = getattr(a, key), getattr(b, key)
        if gb is None:
            assert ga is None, key
        else:
            np.testing.assert_array_equal(ga, gb, err_msg=key)


def _both_iters(t_it, j_it):
    got, want = list(t_it), list(j_it)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same(a, b)
    return got


def test_csv_record_reader_iterators(tmp_path):
    path = tmp_path / "r.csv"
    path.write_text("a,b,target\n" + "\n".join(CSV + ["", "11,12,2"]) + "\n")
    for kw in (dict(label_index=-1, num_classes=3),
               dict(label_index=-1, regression=True), dict(label_index=None)):
        got = _both_iters(
            tdv_it.RecordReaderDataSetIterator(
                tdv_rec.CSVRecordReader(str(path), skip_lines=1), 4, **kw),
            jdv_it.RecordReaderDataSetIterator(
                jdv_rec.CSVRecordReader(str(path), skip_lines=1), 4, **kw))
        assert [b.num_examples() for b in got] == [4, 2]
    t = tdv_rec.LineRecordReader(CSV)
    assert list(t) == list(jdv_rec.LineRecordReader(CSV)) and t.has_next() is False


def test_string_labels_take_the_sorted_order():
    a, b = ["1,dog", "2,cat", "3,dog"], ["4,cat", "5,dog"]
    for lines in (a, b):
        _both_iters(tdv_it.RecordReaderDataSetIterator(
                        tdv_rec.CSVRecordReader(lines), 8, num_classes=2),
                    jdv_it.RecordReaderDataSetIterator(
                        jdv_rec.CSVRecordReader(lines), 8, num_classes=2))
    with pytest.raises(ValueError, match="num_classes"):
        tdv_it.RecordReaderDataSetIterator(
            tdv_rec.CSVRecordReader(["1,a", "2,b", "3,c"]), 8, num_classes=2)


@pytest.mark.parametrize("align", ["start", "end"])
def test_sequence_iterator_pads_and_masks(tmp_path, native_mode, align):
    rng = _rng(8)
    feats, labs = [], []
    for i, t in enumerate((3, 5, 2)):
        f = tmp_path / f"f{i}.csv"
        np.savetxt(f, rng.integers(-9, 9, (t, 2)), delimiter=",", fmt="%d")
        g = tmp_path / f"l{i}.csv"
        np.savetxt(g, rng.integers(0, 3, (t, 1)), delimiter=",", fmt="%d")
        feats.append(str(f))
        labs.append(str(g))
    for labels in (labs, None):
        got = _both_iters(
            tdv_it.SequenceRecordReaderDataSetIterator(
                tdv_rec.CSVSequenceRecordReader(feats),
                None if labels is None else tdv_rec.CSVSequenceRecordReader(labels),
                2, num_classes=3, align=align),
            jdv_it.SequenceRecordReaderDataSetIterator(
                jdv_rec.CSVSequenceRecordReader(feats),
                None if labels is None else jdv_rec.CSVSequenceRecordReader(labels),
                2, num_classes=3, align=align))
        assert got[0].features.shape == (2, 5, 2)
        m = got[0].features_mask
        assert m[0].tolist() == ([1, 1, 1, 0, 0] if align == "start" else [0, 0, 1, 1, 1])
    with pytest.raises(ValueError, match="align"):
        tdv_it.SequenceRecordReaderDataSetIterator(None, None, 2, align="middle")


def test_multidataset_reader():
    def build(mod_it, mod_rec):
        return (mod_it.RecordReaderMultiDataSetIterator(batch_size=2)
                .add_reader("r", mod_rec.CSVRecordReader(CSV))
                .add_input("r", 0, 2).add_output_one_hot("r", 2, 3))
    got, want = list(build(tdv_it, tdv_rec)), list(build(jdv_it, jdv_rec))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.features[0], b.features[0])
        np.testing.assert_array_equal(a.labels[0], b.labels[0])


def test_image_record_reader(tmp_path):
    pil = pytest.importorskip("PIL.Image", reason="PIL is not installed")
    for label in ("cat", "dog"):
        d = tmp_path / label
        d.mkdir()
        for i in range(2):
            pil.new("RGB", (10, 8), color=(i * 50, 100, 150)).save(d / f"{i}.png")
    t = tdv_rec.ImageRecordReader(4, 5, 3, root_dir=str(tmp_path))
    j = jdv_rec.ImageRecordReader(4, 5, 3, root_dir=str(tmp_path))
    assert t.labels == j.labels == ["cat", "dog"]
    _both_iters(tdv_it.RecordReaderDataSetIterator(t, 4, num_classes=2),
                jdv_it.RecordReaderDataSetIterator(j, 4, num_classes=2))


# --------------------------------------------------------------- datasets

@pytest.mark.parametrize("train", [True, False])
def test_synthetic_cifar_is_the_references(monkeypatch, train):
    for mod in (tcifar, jcifar):
        monkeypatch.setattr(mod, "_find_dir", lambda: None)
    _same(tcifar.load_cifar10(train, 40, seed=9), jcifar.load_cifar10(train, 40, seed=9))
    assert sum(1 for _ in tcifar.CifarDataSetIterator(8, 16, train=train)) == 2


def test_synthetic_lfw_and_curves_are_the_references(monkeypatch):
    for mod in (tlfw, jlfw):
        monkeypatch.setattr(mod, "_find_dir", lambda: None)
    _same(tlfw.load_lfw(12, (16, 20), seed=4), jlfw.load_lfw(12, (16, 20), seed=4))
    for flat in (True, False):
        _same(tcurves.load_curves(30, seed=5, flat=flat),
              jcurves.load_curves(30, seed=5, flat=flat))


def test_cifar_reads_its_binary_format(tmp_path, monkeypatch):
    raw = _rng(9).integers(0, 256, (7, 3073)).astype(np.uint8)
    raw[:, 0] %= 10
    for i in range(1, 6):
        raw.tofile(tmp_path / f"data_batch_{i}.bin")
    for mod in (tcifar, jcifar):
        monkeypatch.setattr(mod, "_CIFAR_DIRS", [str(tmp_path)])
    _same(tcifar.load_cifar10(True), jcifar.load_cifar10(True))
