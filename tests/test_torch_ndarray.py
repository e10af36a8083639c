"""The port's ``INDArray``, ``Nd4j`` and ``Transforms`` against the JAX
package's, on the CPU.

Each case of ``tests/test_ndarray.py`` is a function of the package it
runs on; the port's results are held to the JAX package's: arrays within
1e-6 relative (both float32; the sums may differ in order), shapes,
booleans and counts exactly. Random constructors agree by shape, dtype and
distribution, never by seed (threefry keys against a torch.Generator).
The last tests call the JAX package's ``MultiLayerNetwork`` API names on a
reference net and on a port net with the same weights
(``utils/convert.py``), at the network tests' float32 tolerance.
"""

import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import ndarray as jax_nd
from deeplearning4j_tpu_torch import ndarray as port_nd
from deeplearning4j_tpu_torch.ndarray import INDArray, Nd4j, Transforms

TOL = dict(rtol=1e-6, atol=1e-6)
NET_TOL = dict(rtol=1e-5, atol=1e-6)   # float32, sums in another order

JAX = types.SimpleNamespace(Nd4j=jax_nd.Nd4j, INDArray=jax_nd.INDArray,
                            Transforms=jax_nd.Transforms, name="jax")
PORT = types.SimpleNamespace(Nd4j=Nd4j, INDArray=INDArray,
                             Transforms=Transforms, name="port")


@pytest.fixture(autouse=True)
def _port_on_the_cpu():
    """The port's arrays go to the CPU in these tests (its default is
    "cuda")."""
    Nd4j.setDefaultDevice("cpu")
    yield
    Nd4j.setDefaultDevice(None)


# -- the cases of tests/test_ndarray.py, as functions of a package ---------
# Each returns the values its test asserts on, in order.

def case_create_and_shape(m, tmp):
    a = m.Nd4j.create([[1.0, 2.0], [3.0, 4.0]])
    return [a.shape(), a.rank(), a.length(), a.rows(), a.columns(),
            a.isMatrix(), a.isVector(), a]


def case_zeros_ones_eye_arange(m, tmp):
    return [m.Nd4j.zeros(2, 3), m.Nd4j.ones(4), m.Nd4j.eye(3),
            m.Nd4j.arange(5), m.Nd4j.linspace(0, 1, 5)]


def case_arithmetic_functional(m, tmp):
    a = m.Nd4j.create([[1.0, 2.0], [3.0, 4.0]])
    b = m.Nd4j.create([[10.0, 20.0], [30.0, 40.0]])
    return [a.add(b), a.sub(1.0), a.mul(2.0), a.rsub(5.0), a.rdiv(12.0),
            a + b, -a, a]


def case_inplace_ops(m, tmp):
    a = m.Nd4j.create([1.0, 2.0, 3.0])
    r = a.addi(1.0)
    first = a.toNumpy()
    a.muli(2.0).subi(1.0)
    return [r is a, first, a]


def case_view_writeback(m, tmp):
    a = m.Nd4j.create([[1.0, 2.0], [3.0, 4.0]])
    a.getRow(0).addi(10.0)
    first = a.toNumpy()
    a.getColumn(1).muli(0.0)
    return [first, a]


def case_assign_dup(m, tmp):
    a = m.Nd4j.create([1.0, 2.0])
    b = a.dup()
    b.addi(5.0)
    first = a.toNumpy()
    a.assign(m.Nd4j.create([9.0, 9.0]))
    return [first, b, a]


def case_mmul(m, tmp):
    a = m.Nd4j.create([[1.0, 2.0], [3.0, 4.0]])
    b = m.Nd4j.create([[5.0, 6.0], [7.0, 8.0]])
    return [a.mmul(b), m.Nd4j.gemm(a, b, transposeA=True), a @ b]


def case_reductions(m, tmp):
    a = m.Nd4j.create([[1.0, 2.0], [3.0, 4.0]])
    return [a.sum().getDouble(), a.mean().getDouble(), a.sum(0), a.sum(1),
            a.max(0), a.argMax(1).toNumpy().tolist(), a.norm2().getDouble(),
            a.std().getDouble()]


def case_reshape_transpose_permute(m, tmp):
    a = m.Nd4j.arange(6).reshape(2, 3)
    b = m.Nd4j.arange(24).reshape(2, 3, 4)
    return [a.shape(), a.transpose().shape(), b.permute(2, 0, 1).shape(),
            a.transpose(), b.permute(2, 0, 1)]


def case_row_column_broadcast(m, tmp):
    a = m.Nd4j.zeros(2, 3)
    return [a.addRowVector(m.Nd4j.create([1.0, 2.0, 3.0])),
            a.addColumnVector(m.Nd4j.create([1.0, 2.0]))]


def case_concat_stack(m, tmp):
    a, b = m.Nd4j.ones(2, 2), m.Nd4j.zeros(2, 2)
    return [m.Nd4j.concat(0, a, b).shape(), m.Nd4j.concat(1, a, b).shape(),
            m.Nd4j.stack(0, a, b).shape(), m.Nd4j.concat(1, a, b)]


def case_transforms(m, tmp):
    x = m.Nd4j.create([-1.0, 0.0, 1.0])
    t = m.Transforms
    return [t.relu(x), t.sigmoid(m.Nd4j.zeros(3)),
            t.softmax(m.Nd4j.create([[1.0, 1.0, 1.0]])),
            t.exp(m.Nd4j.zeros(2)), t.gelu(x), t.tanh(x), t.elu(x),
            t.hardSigmoid(x), t.leakyRelu(x), t.clip(x, -0.5, 0.5)]


def case_cosine_and_distance(m, tmp):
    a = m.Nd4j.create([1.0, 0.0])
    b = m.Nd4j.create([0.0, 1.0])
    return [m.Transforms.cosineSim(a, b),
            m.Transforms.euclideanDistance(a, b)]


def case_indexing_put(m, tmp):
    a = m.Nd4j.zeros(3, 3)
    a.putScalar((1, 1), 5.0)
    got = a.getDouble(1, 1)
    a.putRow(0, m.Nd4j.create([1.0, 2.0, 3.0]))
    return [got, a, a[0:2, 0:2].shape()]


def case_comparisons_where(m, tmp):
    a = m.Nd4j.create([1.0, 5.0, 3.0])
    return [a.gt(2.0).toNumpy().astype(np.float32),
            m.Nd4j.where(a.gt(2.0), m.Nd4j.zeros(3), a)]


def case_rand_reproducible(m, tmp):
    # by seed within a package; across packages by range and shape only
    m.Nd4j.setSeed(42)
    a = m.Nd4j.rand(3, 3)
    m.Nd4j.setSeed(42)
    b = m.Nd4j.rand(3, 3)
    return [bool(np.array_equal(a.toNumpy(), b.toNumpy())),
            a.toNumpy().min() >= 0 and a.toNumpy().max() < 1, a.shape(),
            str(a.toNumpy().dtype)]


def case_npy_roundtrip(m, tmp):
    a = m.Nd4j.create(np.arange(20, dtype=np.float32).reshape(4, 5) / 7)
    p = str(tmp / f"{m.name}.npy")
    m.Nd4j.writeNpy(a, p)
    return [m.Nd4j.readNpy(p), a]


def case_castTo(m, tmp):
    b = m.Nd4j.create([1.5, 2.5]).castTo(np.int32)
    return [str(b.toNumpy().dtype), b]


def case_equals(m, tmp):
    a = m.Nd4j.create([1.0, 2.0])
    return [a.equals(m.Nd4j.create([1.0, 2.0])),
            a.equals(m.Nd4j.create([1.0, 2.1])),
            a.equals(m.Nd4j.create([1.0, 2.0, 3.0]))]


def case_view_reads_through_parent(m, tmp):
    a = m.Nd4j.create([[1.0, 2.0], [3.0, 4.0]])
    row = a.getRow(0)
    a.addi(1.0)   # parent mutates after view creation
    first = row.toNumpy()
    row.addi(1.0)
    return [first, a]


def case_putScalar_linear_index_roundtrip(m, tmp):
    a = m.Nd4j.create([[0.0, 0.0], [0.0, 0.0]])
    a.putScalar(3, 5.0)
    return [a.getDouble(3), a]


def case_argmax_multi_dims(m, tmp):
    r = m.Nd4j.arange(24).reshape(2, 3, 4).argMax(1, 2)
    return [r.shape(), r.toNumpy().tolist()]


def case_create_dispatch_variants(m, tmp):
    return [m.Nd4j.create(m.Nd4j.ones(4), [2, 2]).shape(),
            m.Nd4j.create((1.0, 2.0, 3.0, 4.0), [2, 2]).shape(),
            m.Nd4j.create((2, 3)).shape(), m.Nd4j.create(2, 3).shape()]


def case_rowvector_accepts_list(m, tmp):
    a = m.Nd4j.zeros(2, 3)
    r = a.addRowVector([1.0, 2.0, 3.0])
    a.putColumn(0, [9.0, 9.0])
    return [r, a]


def case_eq_operator_elementwise(m, tmp):
    a = m.Nd4j.create([1.0, 2.0, 3.0])
    b = m.Nd4j.create([1.0, 0.0, 3.0])
    return [(a == b).toNumpy().astype(np.float32),
            (a != b).toNumpy().astype(np.float32)]


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


def _value(v):
    if isinstance(v, (jax_nd.INDArray, INDArray)):
        return v.toNumpy()
    return v


def _same(got, want, where):
    got, want = _value(got), _value(want)
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.shape == want.shape, where
        if want.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=where)
        else:
            np.testing.assert_allclose(got.astype(np.float64),
                                       want.astype(np.float64), **TOL,
                                       err_msg=where)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, **TOL, err_msg=where)
    else:
        assert got == want, where


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_the_jax_ndarray(name, tmp_path):
    want = CASES[name](JAX, tmp_path)
    got = CASES[name](PORT, tmp_path)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"{name}[{i}]")


def test_there_is_a_case_for_each_reference_test():
    import tests.test_ndarray as ref

    names = {n[len("test_"):] for n in dir(ref) if n.startswith("test_")}
    assert names == set(CASES)


# -- the port's own semantics ------------------------------------------------

def test_in_place_ops_write_into_the_tensor_and_results_own_theirs():
    t = torch.tensor([1.0, 2.0, 3.0])
    a = INDArray(t)
    a.addi(1.0)
    assert torch.equal(t, torch.tensor([2.0, 3.0, 4.0]))
    for made in (a.reshape(3, 1), a.transpose(), a.ravel(), a.dup(),
                 a.castTo(torch.float32), a.broadcast(2, 3), a.getScalar(0)):
        made.muli(0.0)
    assert torch.equal(t, torch.tensor([2.0, 3.0, 4.0]))
    src = np.ones(3, np.float32)
    Nd4j.create(src).addi(1.0)
    assert src.tolist() == [1.0, 1.0, 1.0]
    got = a.toNumpy()
    a.addi(1.0)
    assert got.tolist() == [2.0, 3.0, 4.0]


def test_views_are_torch_views_and_fancy_views_write_back():
    a = Nd4j.create(np.arange(12, dtype=np.float32).reshape(3, 4))
    row = a.getRow(1)
    assert row.torch().untyped_storage().data_ptr() == \
        a.torch().untyped_storage().data_ptr()
    picked = a.get([0, 2])           # a list index: torch copies
    picked.getColumn(3).assign(-1.0)  # a view of that view writes back
    np.testing.assert_array_equal(a.toNumpy()[:, 3], [-1.0, 7.0, -1.0])
    a.slice_(1, dim=1).muli(10.0)
    np.testing.assert_array_equal(a.toNumpy()[:, 1], [10.0, 50.0, 90.0])
    a[2, 0] = 100.0
    assert a.getDouble(2, 0) == 100.0


def test_replace_where_and_in_place_casts_keep_the_dtype():
    a = Nd4j.create([1, 2, 3], dtype=torch.int32)
    a.addi(0.7)
    assert a.dtype == torch.int32 and a.toNumpy().tolist() == [1, 2, 3]
    b = Nd4j.create([1.0, -2.0, 3.0])
    b.replaceWhere(0.0, b.lt(0.0))
    assert b.toNumpy().tolist() == [1.0, 0.0, 3.0]
    j = jax_nd.Nd4j.create([1.0, -2.0, 3.0])
    j.replaceWhere(0.0, j.lt(0.0))
    np.testing.assert_array_equal(b.toNumpy(), j.toNumpy())


@pytest.mark.parametrize("draw", ["rand", "randn", "randomBernoulli"])
def test_random_constructors_agree_by_shape_dtype_and_distribution(draw):
    shape = (200, 100)
    args = (0.3, *shape) if draw == "randomBernoulli" else shape
    jax_nd.Nd4j.setSeed(7)
    Nd4j.setSeed(7)
    want = getattr(jax_nd.Nd4j, draw)(*args).toNumpy()
    got = getattr(Nd4j, draw)(*args).toNumpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    # 20,000 draws: means within 0.03, standard deviations within 0.03
    assert abs(got.mean() - want.mean()) < 0.03
    assert abs(got.std() - want.std()) < 0.03
    Nd4j.setSeed(7)
    again = getattr(Nd4j, draw)(*args).toNumpy()
    np.testing.assert_array_equal(got, again)
    seeded = Nd4j.rand(4, seed=3).toNumpy()
    np.testing.assert_array_equal(seeded, Nd4j.rand(4, seed=3).toNumpy())


def test_npy_files_cross_between_the_packages(tmp_path):
    x = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    Nd4j.writeNpy(Nd4j.create(x), str(tmp_path / "port.npy"))
    jax_nd.Nd4j.writeNpy(jax_nd.Nd4j.create(x), str(tmp_path / "jax.npy"))
    np.testing.assert_array_equal(
        jax_nd.Nd4j.readNpy(str(tmp_path / "port.npy")).toNumpy(), x)
    np.testing.assert_array_equal(
        Nd4j.readNpy(str(tmp_path / "jax.npy")).toNumpy(), x)


def test_arrays_go_to_cuda_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Nd4j.setDefaultDevice(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Nd4j.create([1.0])
    assert Nd4j.zeros(2, device="cpu").device.type == "cpu"
    Nd4j.setDefaultDevice("cpu")
    assert Nd4j.create([1.0]).device.type == "cpu"


@pytest.mark.parametrize("name", ["sum", "mean", "max", "min", "prod", "std",
                                  "var", "norm1", "norm2", "normmax",
                                  "argMax", "argMin"])
@pytest.mark.parametrize("dims", [(), (0,), (1, 2), (-1,)])
def test_reductions_match_the_jax_ndarray(name, dims):
    x = np.random.default_rng(1).normal(size=(3, 4, 5)).astype(np.float32)
    want = getattr(jax_nd.Nd4j.create(x), name)(*dims).toNumpy()
    got = getattr(Nd4j.create(x), name)(*dims).toNumpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", [
    "sigmoid", "tanh", "relu", "relu6", "elu", "selu", "gelu", "softPlus",
    "softsign", "swish", "mish", "hardSigmoid", "hardTanh", "exp", "log1p",
    "abs", "sign", "floor", "ceil", "round", "sin", "cos", "atan", "sinh",
    "square", "cube", "neg", "step", "erf", "softmax", "logSoftmax",
    "unitVec"])
def test_transforms_match_the_jax_ndarray(name):
    x = np.random.default_rng(2).normal(size=(4, 6)).astype(np.float32) * 2
    want = getattr(jax_nd.Transforms, name)(jax_nd.Nd4j.create(x))
    got = getattr(Transforms, name)(Nd4j.create(x))
    np.testing.assert_allclose(got.toNumpy(), want.toNumpy(), rtol=1e-5,
                               atol=1e-6)


def test_distance_matrices_match_the_jax_ndarray():
    rng = np.random.default_rng(3)
    a, b = (rng.normal(size=(5, 8)).astype(np.float32) for _ in range(2))
    for name in ("allEuclideanDistances", "allCosineSimilarities"):
        np.testing.assert_allclose(
            getattr(Transforms, name)(a, b).toNumpy(),
            getattr(jax_nd.Transforms, name)(a, b).toNumpy(), rtol=1e-5,
            atol=1e-5)
    np.testing.assert_allclose(Transforms.manhattanDistance(a, b),
                               jax_nd.Transforms.manhattanDistance(a, b),
                               rtol=1e-5)


def test_the_ndarray_has_the_jax_ndarrays_public_methods():
    def public(cls):
        return {n for n in dir(cls) if not n.startswith("_")}

    assert public(jax_nd.INDArray) - {"jax"} <= public(INDArray)
    assert public(jax_nd.Nd4j) <= public(Nd4j)
    assert public(jax_nd.Transforms) <= public(Transforms)
    assert "torch" in public(INDArray)
    assert port_nd.__all__ == jax_nd.__all__


# -- MultiLayerNetwork by the JAX package's API names -------------------------

def _char_rnn_pair():
    from deeplearning4j_tpu.nn.multilayer import (
        MultiLayerNetwork as JaxNet)
    from deeplearning4j_tpu.models.zoo import (
        TextGenerationLSTM as JaxCharRnn)
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils.convert import params_from_numpy

    jnet = JaxCharRnn(vocabSize=7, hidden=12, seqLength=6).init()
    assert isinstance(jnet, JaxNet)
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    arrays = [{k: np.asarray(v) for k, v in p.items()} for p in jnet._params]
    net = MultiLayerNetwork(conf, device="cpu").init(
        params_from_numpy(conf, arrays, "cpu"))
    return jnet, net


def test_network_api_names_return_ndarrays_as_the_reference_does():
    jnet, net = _char_rnn_pair()
    x = np.eye(7, dtype=np.float32)[np.random.default_rng(4).integers(
        0, 7, size=(3, 6))].transpose(0, 2, 1)
    out = net.output(x)
    assert isinstance(out, INDArray) and out.shape() == (3, 7, 6)
    np.testing.assert_allclose(out.toNumpy(), jnet.output(x).toNumpy(),
                               **NET_TOL)
    # an INDArray of either kind is an input too
    np.testing.assert_allclose(net.output(Nd4j.create(x)).toNumpy(),
                               out.toNumpy(), rtol=0, atol=0)
    for k in range(3):
        step = net.rnnTimeStep(x[:, :, k])
        assert isinstance(step, INDArray)
        np.testing.assert_allclose(
            step.toNumpy(), jnet.rnnTimeStep(x[:, :, k]).toNumpy(),
            **NET_TOL)
    for i in (0, 1):
        got, want = net.rnnGetPreviousState(i), jnet.rnnGetPreviousState(i)
        assert sorted(got) == sorted(want)
        for k in want:
            assert isinstance(got[k], INDArray)
            np.testing.assert_allclose(got[k].toNumpy(), want[k].toNumpy(),
                                       **NET_TOL)
    flat = net.params()
    assert isinstance(flat, INDArray)
    np.testing.assert_array_equal(flat.toNumpy(), jnet.params().toNumpy())
    w = net.getParam(0, "W")
    assert isinstance(w, INDArray)
    np.testing.assert_array_equal(w.toNumpy(), jnet.getParam(0, "W")
                                  .toNumpy())
    table = net.paramTable()
    assert sorted(table) == sorted(jnet.paramTable())
    np.testing.assert_array_equal(table["1_b"].toNumpy(),
                                  jnet.paramTable()["1_b"].toNumpy())


def test_network_ndarrays_are_copies_and_go_back_in():
    jnet, net = _char_rnn_pair()
    x = np.eye(7, dtype=np.float32)[np.random.default_rng(5).integers(
        0, 7, size=(2, 6))].transpose(0, 2, 1)
    before = net.output(x).toNumpy()
    net.getParam(0, "W").muli(0.0)
    net.paramTable()["2_b"].addi(1.0)
    net.params().muli(0.0)
    np.testing.assert_array_equal(net.output(x).toNumpy(), before)
    out = net.output(x)
    out.addi(1.0)   # an inference tensor, written in inference mode
    np.testing.assert_allclose(out.toNumpy(), before + 1.0, rtol=1e-6)
    # INDArrays go back in where the reference takes them
    flat = net.params()
    net.setParams(flat.mul(2.0))
    np.testing.assert_allclose(net.params().toNumpy(), 2 * flat.toNumpy(),
                               rtol=0, atol=0)
    net.setParams(flat)
    net.setParam(2, "b", net.getParam(2, "b").add(0.0))
    net.rnnTimeStep(x[:, :, :3])
    saved = {i: net.rnnGetPreviousState(i) for i in (0, 1)}
    after = net.rnnTimeStep(x[:, :, 3:]).toNumpy()
    net.rnnClearPreviousState()
    for i, st in saved.items():
        net.rnnSetPreviousState(i, st)
    np.testing.assert_array_equal(net.rnnTimeStep(x[:, :, 3:]).toNumpy(),
                                  after)
    labels = np.eye(7, dtype=np.float32)[np.random.default_rng(6).integers(
        0, 7, size=(2, 6))].transpose(0, 2, 1)
    net.fit(Nd4j.create(x), Nd4j.create(labels))
    assert np.isfinite(net.score())
