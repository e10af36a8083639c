"""The port's DataVec tier against the JAX package's.

Record readers, the record-to-DataSet iterators, Schema and
TransformProcess, AnalyzeLocal, Join, the normalizers and
LocalTransformExecutor are numpy and plain Python on the host in both
packages, so every comparison is exact: the same inputs (made from a
numpy seed) give equal records, equal arrays bit for bit, equal schemas
and equal statistics. A normalizer saved in a zip by either package's
ModelSerializer restores in the other, bit for bit.
"""

import numpy as np
import pytest

import deeplearning4j_tpu.datasets as jds
import deeplearning4j_tpu_torch.datasets as pds
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.utils.serializer import (
    ModelSerializer as JaxSerializer)
from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer

from torch_parity import net_pair

PKGS = {"jax": jds, "torch": pds}


def _arrays(ds):
    """A DataSet's or MultiDataSet's arrays as a flat list of numpy."""
    if hasattr(ds, "featuresMasks"):
        return [np.asarray(a) for a in ds.features + ds.labels]
    return [np.asarray(a) for a in (ds.getFeatures(), ds.getLabels())]


def _drain(it):
    out = []
    while it.hasNext():
        out.append(_arrays(it.next()))
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def _csv_rows(rng, n, cols, classes):
    x = rng.normal(size=(n, cols)).round(4)
    y = rng.integers(0, classes, n)
    return [",".join([*(f"{v:.4f}" for v in row), str(c)])
            for row, c in zip(x, y)]


# -- record readers ----------------------------------------------------------

@pytest.mark.parametrize("batch", [4, 7, 64])
def test_csv_file_classification_batches_equal(tmp_path, batch):
    rows = _csv_rows(np.random.default_rng(1), 50, 6, 3)
    path = tmp_path / "data.csv"
    path.write_text("\n".join(["a,b,c,d,e,f,label"] + rows) + "\n")
    out = {}
    for name, pkg in PKGS.items():
        reader = pkg.CSVRecordReader(skipNumLines=1).initialize(
            pkg.FileSplit(str(path)))
        out[name] = _drain(pkg.RecordReaderDataSetIterator(
            reader, batchSize=batch, labelIndex=6, numPossibleLabels=3))
    _same_batches(out["torch"], out["jax"])


def test_csv_label_count_inferred_and_regression_equal():
    rows = _csv_rows(np.random.default_rng(2), 20, 3, 5)
    for kwargs in (dict(labelIndex=3),
                   dict(labelIndex=2, regression=True, labelIndexTo=3),
                   dict(labelIndex=-1, regression=True)):
        out = {}
        for name, pkg in PKGS.items():
            reader = pkg.CSVRecordReader().initialize(
                pkg.ListStringSplit(rows))
            out[name] = _drain(pkg.RecordReaderDataSetIterator(
                reader, batchSize=8, **kwargs))
        _same_batches(out["torch"], out["jax"])


def test_csv_with_strings_reads_as_strings(tmp_path):
    path = tmp_path / "mixed.csv"
    path.write_text("1.5,setosa\n2.5,virginica\n")
    recs = {}
    for name, pkg in PKGS.items():
        reader = pkg.CSVRecordReader().initialize(pkg.FileSplit(str(path)))
        recs[name] = [reader.next() for _ in range(2)]
        assert not reader.hasNext()
    assert recs["torch"] == recs["jax"] == [["1.5", "setosa"],
                                            ["2.5", "virginica"]]


def test_file_split_and_line_reader_equal(tmp_path):
    for i in range(3):
        (tmp_path / f"f{i}.txt").write_text(f"line {i}a\nline {i}b\n")
    (tmp_path / "skip.bin").write_bytes(b"x")
    recs = {}
    for name, pkg in PKGS.items():
        split = pkg.FileSplit(str(tmp_path), extensions=[".txt"])
        reader = pkg.LineRecordReader()
        reader.initialize(split)
        recs[name] = []
        while reader.hasNext():
            recs[name].append(reader.next())
        reader.reset()
        assert reader.hasNext()
    assert recs["torch"] == recs["jax"] and len(recs["jax"]) == 6


def test_multi_dataset_iterator_equal():
    rng = np.random.default_rng(3)
    a = _csv_rows(rng, 10, 4, 3)
    b = [",".join(f"{v:.3f}" for v in row)
         for row in rng.normal(size=(10, 2))]
    out = {}
    for name, pkg in PKGS.items():
        ra = pkg.CSVRecordReader().initialize(pkg.ListStringSplit(a))
        rb = pkg.CSVRecordReader().initialize(pkg.ListStringSplit(b))
        it = (pkg.RecordReaderMultiDataSetIterator.Builder(4)
              .addReader("a", ra).addReader("b", rb)
              .addInput("a", 0, 3).addInput("b")
              .addOutputOneHot("a", 4, 3).addOutput("b", 1, 1).build())
        out[name] = _drain(it)
    _same_batches(out["torch"], out["jax"])


# -- schema and transform process ------------------------------------------

def _schema(pkg):
    return (pkg.Schema.Builder()
            .addColumnsDouble("sl", "sw")
            .addColumnInteger("n", 0, 9)
            .addColumnCategorical("species", "setosa", "versicolor",
                                  "virginica")
            .addColumnString("tag")
            .addColumnDouble("pw")
            .build())


def _process(pkg):
    cond = pkg.DoubleColumnCondition("sl", pkg.ConditionOp.LessThan, 4.0)
    return (pkg.TransformProcess.Builder(_schema(pkg))
            .filter(cond)
            .conditionalReplaceValueTransform(
                "pw", 0.0, pkg.DoubleColumnCondition(
                    "pw", pkg.ConditionOp.GreaterThan, 2.0))
            .doubleMathOp("sl", pkg.MathOp.Multiply, 10.0)
            .doubleMathFunction("sw", pkg.MathFunction.SQRT)
            .normalize("pw", 0.0, 2.0)
            .stringMapTransform("tag", {"a": "alpha"})
            .appendStringColumnTransform("tag", "!")
            .integerToOneHot("n", 0, 9)
            .categoricalToOneHot("species")
            .renameColumn("sl", "sepal")
            .reorderColumns("tag", "sepal")
            .removeColumns("sw")
            .build())


def _records(n, seed):
    rng = np.random.default_rng(seed)
    species = ("setosa", "versicolor", "virginica")
    return [[float(rng.uniform(3, 8)), float(rng.uniform(1, 5)),
             int(rng.integers(0, 10)), species[int(rng.integers(0, 3))],
             "ab"[int(rng.integers(0, 2))], float(rng.uniform(0, 3))]
            for _ in range(n)]


def test_transform_process_records_and_final_schema_equal():
    recs = _records(200, 4)
    out = {name: _process(pkg) for name, pkg in PKGS.items()}
    got, want = (out[k].execute([list(r) for r in recs])
                 for k in ("torch", "jax"))
    assert got == want and 0 < len(got) < len(recs)
    js, ps = (out[k].getFinalSchema() for k in ("jax", "torch"))
    assert ps.getColumnNames() == js.getColumnNames()
    assert ps.getColumnTypes() == js.getColumnTypes()


@pytest.mark.parametrize("op", ["categoricalToInteger", "stringToCategorical",
                                "removeAllColumnsExceptFor",
                                "categorical_inset"])
def test_transform_steps_equal(op):
    recs = _records(40, 5)
    got = {}
    for name, pkg in PKGS.items():
        b = pkg.TransformProcess.Builder(_schema(pkg))
        if op == "categoricalToInteger":
            b = b.categoricalToInteger("species")
        elif op == "stringToCategorical":
            b = b.stringToCategorical("tag", ["a", "b"]) \
                .categoricalToOneHot("tag")
        elif op == "removeAllColumnsExceptFor":
            b = b.removeAllColumnsExceptFor("pw", "species")
        else:
            b = b.filter(pkg.CategoricalColumnCondition(
                "species", pkg.ConditionOp.InSet, {"setosa", "virginica"}))
        tp = b.build()
        got[name] = (tp.execute([list(r) for r in recs]),
                     tp.getFinalSchema().getColumnNames())
    assert got["torch"] == got["jax"]


def test_transform_process_record_reader_through_iterator():
    rows = [",".join(str(v) for v in r[:3]) + f",{r[3]}"
            for r in _records(30, 6)]
    out = {}
    for name, pkg in PKGS.items():
        schema = (pkg.Schema.Builder().addColumnsDouble("a", "b")
                  .addColumnInteger("n")
                  .addColumnCategorical("species", "setosa", "versicolor",
                                        "virginica").build())
        tp = (pkg.TransformProcess.Builder(schema)
              .categoricalToInteger("species").build())
        reader = pkg.TransformProcessRecordReader(
            pkg.CSVRecordReader(), tp)
        reader.initialize(pkg.ListStringSplit(rows))
        out[name] = _drain(pkg.RecordReaderDataSetIterator(
            reader, batchSize=8, labelIndex=3, numPossibleLabels=3))
    _same_batches(out["torch"], out["jax"])


def test_local_transform_executor_equal_to_serial():
    recs = _records(3000, 7)
    want = _process(jds).execute([list(r) for r in recs])
    got = pds.LocalTransformExecutor.execute(
        [list(r) for r in recs], _process(pds), numWorkers=2,
        chunkSize=512)
    assert got == want


# -- analysis and join -------------------------------------------------------

def test_analyze_local_equal():
    recs = _records(300, 8)
    recs[3][0] = ""     # a missing value
    out = {}
    for name, pkg in PKGS.items():
        an = pkg.AnalyzeLocal.analyze(_schema(pkg), pkg.CollectionRecordReader(
            [list(r) for r in recs]))
        col = an.getColumnAnalysis("sl")
        cat = an.getColumnAnalysis("species")
        out[name] = (col.getMin(), col.getMax(), col.getMean(),
                     col.getSampleStdev(), col.countTotal, col.countMissing,
                     cat.getUnique(), cat.getMapOfUniqueToCount(),
                     repr(an))
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("kind", ["INNER", "LEFT_OUTER", "RIGHT_OUTER",
                                  "FULL_OUTER"])
def test_join_equal(kind):
    rng = np.random.default_rng(9)
    left = [[int(k), float(v)] for k, v in zip(rng.integers(0, 8, 20),
                                               rng.normal(size=20))]
    right = [[int(k), f"s{k}"] for k in rng.integers(4, 12, 15)]
    out = {}
    for name, pkg in PKGS.items():
        ls = pkg.Schema.Builder().addColumnInteger("id") \
            .addColumnDouble("v").build()
        rs = pkg.Schema.Builder().addColumnInteger("key") \
            .addColumnString("s").build()
        join = pkg.Join(getattr(pkg.JoinType, kind), ls, rs, ["id"],
                        ["key"])
        recs = pkg.executeJoin(join, pkg.CollectionRecordReader(left),
                               pkg.CollectionRecordReader(right))
        out[name] = (sorted(map(repr, recs)),
                     join.getOutputSchema().getColumnNames())
    assert out["torch"] == out["jax"]


# -- normalizers -------------------------------------------------------------

NORMALIZERS = ["NormalizerStandardize", "NormalizerMinMaxScaler",
               "ImagePreProcessingScaler"]


def _features(seed, n=96):
    return np.random.default_rng(seed).normal(
        50.0, 20.0, size=(n, 3, 4, 4)).astype(np.float32)


@pytest.mark.parametrize("name", NORMALIZERS)
def test_normalizer_fit_transform_revert_bitwise(name):
    f = _features(10)
    out = {}
    for pkg_name, pkg in PKGS.items():
        it = pkg.ListDataSetIterator(
            pkg.DataSet(f, np.zeros((len(f), 2), np.float32)), 16)
        norm = getattr(pkg, name)().fit(it)
        t = norm.transform(f)
        out[pkg_name] = (t, norm.revert(t),
                         {k: np.asarray(v) for k, v in norm._state().items()})
    for a, b in zip(out["torch"][:2], out["jax"][:2]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert out["torch"][2].keys() == out["jax"][2].keys()
    for k in out["jax"][2]:
        np.testing.assert_array_equal(out["torch"][2][k], out["jax"][2][k])


def test_normalizer_as_preprocessor_bitwise():
    f = _features(11, 40)
    out = {}
    for name, pkg in PKGS.items():
        ds = pkg.DataSet(f, np.eye(2, dtype=np.float32)[np.arange(40) % 2])
        norm = pkg.NormalizerStandardize().fit(ds)
        it = pkg.ListDataSetIterator(ds, 16)
        it.setPreProcessor(norm)
        out[name] = _drain(it)
    _same_batches(out["torch"], out["jax"])


@pytest.mark.parametrize("name", NORMALIZERS)
def test_normalizer_save_load_across_packages(name, tmp_path):
    f = _features(12)
    norms = {k: getattr(pkg, name)().fit(pkg.DataSet(
        f, np.zeros((len(f), 1), np.float32))) for k, pkg in PKGS.items()}
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        path = str(tmp_path / f"{writer}.npz")
        norms[writer].save(path)
        back = PKGS[reader].Normalizer.load(path)
        assert type(back).__name__ == name
        assert back.transform(f).tobytes() == \
            norms[writer].transform(f).tobytes()


# -- normalizers in the model zip ---------------------------------------------

@pytest.fixture(scope="module")
def lenet_pair():
    port, jnet = net_pair(jax_zoo.LeNet().conf())
    return port, jnet


@pytest.mark.parametrize("name", NORMALIZERS)
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_normalizer_in_zip_restores_in_the_other_package(
        lenet_pair, tmp_path, name, writer):
    """``writeModel(normalizer=)`` of either package, then
    ``restoreNormalizerFromFile`` of both: the same class and state, the
    same transform bit for bit; the port restores the network too."""
    port, jnet = lenet_pair
    f = np.random.default_rng(13).uniform(0, 255, size=(32, 784)).astype(
        np.float32)
    norm = getattr(PKGS[writer], name)().fit(
        PKGS[writer].DataSet(f, np.zeros((32, 10), np.float32)))
    path = str(tmp_path / "model.zip")
    if writer == "jax":
        JaxSerializer.writeModel(jnet, path, normalizer=norm)
    else:
        ModelSerializer.writeModel(port, path, normalizer=norm)
    want = norm.transform(f)
    for restore in (JaxSerializer.restoreNormalizerFromFile,
                    ModelSerializer.restoreNormalizerFromFile):
        back = restore(path)
        assert type(back).__name__ == name
        assert back.transform(f).tobytes() == want.tobytes()
    net = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
    np.testing.assert_array_equal(net.params().toNumpy(),
                                  port.params().toNumpy())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_add_normalizer_to_model_across_packages(lenet_pair, tmp_path,
                                                 writer):
    port, jnet = lenet_pair
    path = str(tmp_path / "model.zip")
    ModelSerializer.writeModel(port, path)
    assert ModelSerializer.restoreNormalizerFromFile(path) is None
    assert JaxSerializer.restoreNormalizerFromFile(path) is None
    f = _features(14).reshape(96, -1)
    norm = PKGS[writer].NormalizerMinMaxScaler(-1.0, 1.0).fit(
        PKGS[writer].DataSet(f, np.zeros((96, 1), np.float32)))
    adder = JaxSerializer if writer == "jax" else ModelSerializer
    adder.addNormalizerToModel(path, norm)
    adder.addNormalizerToModel(path, norm)   # replaces, never duplicates
    for restore in (JaxSerializer.restoreNormalizerFromFile,
                    ModelSerializer.restoreNormalizerFromFile):
        back = restore(path)
        assert (back.minRange, back.maxRange) == (-1.0, 1.0)
        assert back.transform(f).tobytes() == norm.transform(f).tobytes()
    net = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
    assert net.numParams() == port.numParams()
