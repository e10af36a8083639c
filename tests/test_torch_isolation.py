"""The port stands apart from JAX and runs on the GPU unless told not to.

- No module of deeplearning4j_tpu_torch/, not chip_smoke.py and not the
  op cases it reads (tests/samediff_op_cases.py) imports
  ``jax`` or ``deeplearning4j_tpu`` (checked on the source's AST, so a
  lazy import inside a function counts too).
- With CUDA absent, every entry point given no device raises instead of
  running on the CPU, training and pretraining included (networks,
  graphs, the zoo with its detectors, restored zips, ResNet-50 in
  bfloat16, an int8 QuantizedServable); a CUDA tensor never reaches the
  plain version.
- ``chip_smoke.py`` binds each top-level name once, so no phase's
  helper replaces another's.
- The bfloat16 paths of the serving boundary, the zip and the numpy
  conversion run in a fresh interpreter that imports neither ``jax`` nor
  ``ml_dtypes`` (the GPU machine has neither; JAX registers bfloat16
  with numpy here, which would hide a ``np.dtype("bfloat16")``).
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch
from deeplearning4j_tpu_torch.models.zoo import (
    YOLO2, ResNet50, TextGenerationLSTM, TinyYOLO, UNet)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.modelimport import TFGraphMapper, protobuf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import InferenceSession
from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "deeplearning4j_tpu"}
# chip_smoke.py's op phase reads its cases from tests/samediff_op_cases.py
SOURCES = sorted(Path(deeplearning4j_tpu_torch.__file__).parent.rglob(
    "*.py")) + [ROOT / "chip_smoke.py",
                ROOT / "tests" / "samediff_op_cases.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_imports_neither_jax_nor_the_jax_package(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_scan_sees_the_package_and_a_forbidden_import(tmp_path):
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for want in ("deeplearning4j_tpu_torch/kernels/lstm.py",
                 "deeplearning4j_tpu_torch/serving/session.py",
                 "deeplearning4j_tpu_torch/nn/losses.py",
                 "deeplearning4j_tpu_torch/optimize/schedules.py",
                 "deeplearning4j_tpu_torch/optimize/updaters.py",
                 "deeplearning4j_tpu_torch/datasets/dataset.py",
                 "deeplearning4j_tpu_torch/datasets/iterator.py",
                 "deeplearning4j_tpu_torch/autodiff/samediff.py",
                 "deeplearning4j_tpu_torch/autodiff/ops.py",
                 "deeplearning4j_tpu_torch/autodiff/__init__.py",
                 "deeplearning4j_tpu_torch/serving/servable.py",
                 "deeplearning4j_tpu_torch/serving/registry.py",
                 "deeplearning4j_tpu_torch/utils/serializer.py",
                 "deeplearning4j_tpu_torch/kernels/probe_matmul.py",
                 "deeplearning4j_tpu_torch/kernels/bottleneck.py",
                 "deeplearning4j_tpu_torch/tools/__init__.py",
                 "deeplearning4j_tpu_torch/tools/common.py",
                 "deeplearning4j_tpu_torch/tools/probe_matmul.py",
                 "deeplearning4j_tpu_torch/tools/probe_fused_block.py",
                 "deeplearning4j_tpu_torch/tools/probe_fused_parts.py",
                 "deeplearning4j_tpu_torch/evaluation/__init__.py",
                 "deeplearning4j_tpu_torch/evaluation/classification.py",
                 "deeplearning4j_tpu_torch/evaluation/regression.py",
                 "deeplearning4j_tpu_torch/evaluation/calibration.py",
                 "deeplearning4j_tpu_torch/tree_util.py",
                 "deeplearning4j_tpu_torch/modelimport/__init__.py",
                 "deeplearning4j_tpu_torch/modelimport/tensorflow.py",
                 "deeplearning4j_tpu_torch/modelimport/protobuf.py",
                 "deeplearning4j_tpu_torch/nn/graph.py",
                 "deeplearning4j_tpu_torch/nn/conf/graph_conf.py",
                 "deeplearning4j_tpu_torch/nn/conf/layers_extra.py",
                 "deeplearning4j_tpu_torch/nn/conf/attention.py",
                 "deeplearning4j_tpu_torch/nn/conf/capsnet.py",
                 "deeplearning4j_tpu_torch/nn/conf/variational.py",
                 "deeplearning4j_tpu_torch/nn/conf/objdetect.py",
                 "deeplearning4j_tpu_torch/nn/objdetect.py",
                 "deeplearning4j_tpu_torch/models/zoo.py",
                 "deeplearning4j_tpu_torch/runtime.py",
                 "deeplearning4j_tpu_torch/backend.py",
                 "deeplearning4j_tpu_torch/precision/__init__.py",
                 "deeplearning4j_tpu_torch/precision/policy.py",
                 "deeplearning4j_tpu_torch/precision/scaler.py",
                 "deeplearning4j_tpu_torch/precision/monitor.py",
                 "deeplearning4j_tpu_torch/precision/quantize.py",
                 "deeplearning4j_tpu_torch/telemetry/__init__.py",
                 "deeplearning4j_tpu_torch/telemetry/registry.py",
                 "deeplearning4j_tpu_torch/telemetry/prometheus.py",
                 "deeplearning4j_tpu_torch/telemetry/flight.py",
                 "deeplearning4j_tpu_torch/telemetry/memledger.py",
                 "deeplearning4j_tpu_torch/serving/decode.py",
                 "deeplearning4j_tpu_torch/serving/prefill.py",
                 "deeplearning4j_tpu_torch/serving/prefix_cache.py",
                 "deeplearning4j_tpu_torch/serving/speculative.py",
                 "deeplearning4j_tpu_torch/serving/admission.py",
                 "deeplearning4j_tpu_torch/serving/replica.py",
                 "deeplearning4j_tpu_torch/serving/http.py",
                 "deeplearning4j_tpu_torch/serving/batcher.py",
                 "deeplearning4j_tpu_torch/telemetry/tracing.py",
                 "deeplearning4j_tpu_torch/native/__init__.py",
                 "deeplearning4j_tpu_torch/datasets/prefetch.py",
                 "deeplearning4j_tpu_torch/datasets/parallel_etl.py",
                 "deeplearning4j_tpu_torch/datasets/image.py",
                 "deeplearning4j_tpu_torch/datasets/records.py",
                 "deeplearning4j_tpu_torch/datasets/transform.py",
                 "deeplearning4j_tpu_torch/datasets/normalizers.py",
                 "deeplearning4j_tpu_torch/datasets/analysis.py",
                 "deeplearning4j_tpu_torch/datasets/join.py",
                 "deeplearning4j_tpu_torch/nlp/__init__.py",
                 "deeplearning4j_tpu_torch/nlp/tokenization.py",
                 "deeplearning4j_tpu_torch/nlp/word2vec.py",
                 "deeplearning4j_tpu_torch/nlp/paragraph_vectors.py",
                 "deeplearning4j_tpu_torch/nlp/glove.py",
                 "deeplearning4j_tpu_torch/nlp/serializer.py",
                 "deeplearning4j_tpu_torch/graph/__init__.py",
                 "deeplearning4j_tpu_torch/graph/deepwalk.py",
                 "deeplearning4j_tpu_torch/clustering/__init__.py",
                 "deeplearning4j_tpu_torch/clustering/vptree.py",
                 "deeplearning4j_tpu_torch/clustering/kmeans.py",
                 "deeplearning4j_tpu_torch/clustering/tsne.py",
                 "deeplearning4j_tpu_torch/clustering/server.py",
                 "deeplearning4j_tpu_torch/parallel/multihost.py",
                 "deeplearning4j_tpu_torch/parallel/transport.py",
                 "deeplearning4j_tpu_torch/parallel/sharding.py",
                 "deeplearning4j_tpu_torch/parallel/ring_attention.py",
                 "deeplearning4j_tpu_torch/parallel/trainer.py",
                 "tests/samediff_op_cases.py",
                 "chip_smoke.py"):
        assert want in names
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    from deeplearning4j_tpu.nn import x\n")
    assert _imported_roots(bad) & FORBIDDEN == {"deeplearning4j_tpu"}


def test_chip_smoke_defines_each_top_level_name_once():
    """A phase's helper must not rebind an earlier phase's (a later
    ``def`` of the same name would run in the earlier phase's place)."""
    seen, twice = set(), []
    for node in ast.parse((ROOT / "chip_smoke.py").read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            bound = [node.name]
        elif isinstance(node, ast.Assign):
            bound = [n.id for t in node.targets for n in ast.walk(t)
                     if isinstance(n, ast.Name)]
        else:
            continue
        twice += [name for name in bound if name in seen]
        seen.update(bound)
    assert twice == []


def test_native_loader_names_no_path_of_the_jax_package():
    """The port's native library comes from its own ``etl.cpp`` and is
    built into its own ``_build/``: neither the loader's paths nor its
    source text name the JAX package's ``native/`` (whose ``_etl_*.so``
    it must never load)."""
    from deeplearning4j_tpu_torch import native

    pkg = Path(deeplearning4j_tpu_torch.__file__).resolve().parent
    ref = ROOT / "deeplearning4j_tpu"
    for path in (native.SRC, native.BUILD_DIR, native.library_path()):
        assert path.resolve().is_relative_to(pkg)
        assert not path.resolve().is_relative_to(ref)
    tree = ast.parse((pkg / "native" / "__init__.py").read_text())
    doc = ast.get_docstring(tree, clean=False)
    strings = [n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)
               and n.value != doc]
    assert not [t for t in strings if "_etl_" in t or "deeplearning4j_tpu/"
                in t.replace("deeplearning4j_tpu_torch/", "")]
    if native.available():
        assert Path(native.load()._name).resolve().is_relative_to(
            pkg / "_build")


def test_prefetcher_stages_on_the_card_unless_cpu_is_named(no_cuda):
    from deeplearning4j_tpu_torch.datasets import (
        DataSet, DevicePrefetcher, ListDataSetIterator)

    base = ListDataSetIterator(DataSet(np.zeros((4, 2), np.float32),
                                       np.zeros((4, 1), np.float32)), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DevicePrefetcher(base)
    cpu = DevicePrefetcher(base, device="cpu")
    assert cpu.next().getFeatures().device.type == "cpu"
    cpu.close()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    conf = TextGenerationLSTM(vocabSize=5, hidden=8, seqLength=4).conf()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiLayerNetwork(conf)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TextGenerationLSTM(vocabSize=5, hidden=8, seqLength=4).init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceSession()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TFGraphMapper.importGraph(protobuf.GraphDef([]).encode())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiLayerNetwork(conf, device="cuda")
    # the CPU only when named
    net = MultiLayerNetwork(conf, device="cpu").init()
    assert net.device.type == "cpu"
    assert net.output(np.zeros((1, 5, 4), np.float32)).device.type == "cpu"


def test_decode_entry_points_raise_without_cuda_unless_cpu_is_named(
        no_cuda):
    from deeplearning4j_tpu_torch.serving import (
        DecodeEngine, RnnDecodeModel, TransformerDecodeModel)

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerDecodeModel.init(vocab=8, hidden=8, n_layers=1,
                                    n_heads=2, max_len=16)
    cpu = TransformerDecodeModel.init(vocab=8, hidden=8, n_layers=1,
                                      n_heads=2, max_len=16, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerDecodeModel(cpu.params, n_heads=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TextGenerationLSTM(vocabSize=5, hidden=8, seqLength=4).init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceSession().register_decoder("d", cpu)
    # the CPU only when named: the engine runs where its model lives
    engine = DecodeEngine(cpu, name="iso")
    assert engine._state["k"].device.type == "cpu"
    assert len(engine.decode([1, 2], 3, timeout=60)) == 3
    engine.close()
    net = TextGenerationLSTM(vocabSize=5, hidden=8, seqLength=4).init("cpu")
    with InferenceSession(device="cpu") as session:
        eng = session.register_decoder("r", RnnDecodeModel(net, 2))
        assert eng._state[0]["h"].device.type == "cpu"
        assert len(session.decode("r", [1, 2], 3, timeout=60)) == 3


def test_replicas_raise_without_cuda_unless_cpu_is_named(no_cuda):
    """A replica set, its servables and its device helper run on "cuda"
    unless the CPU is named; with the CPU named, replicas own no stream."""
    from deeplearning4j_tpu_torch.serving import FnServable
    from deeplearning4j_tpu_torch.serving.replica import replica_devices

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        replica_devices(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FnServable(lambda x: x, (3,))
    sv = FnServable(lambda x: x * 2, (3,), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sv.for_device("cuda")
    net = TextGenerationLSTM(vocabSize=5, hidden=8, seqLength=4).init("cpu")
    with InferenceSession(device="cpu") as session:
        session.register("r", net, example_shape=(5, 4), ladder=(1,),
                         warmup=True, replicas=2)
        reps = session._batchers[("r", 1)].executor.replicas
        assert [r.servable.stream for r in reps] == [None, None]
        y = session.predict("r", np.zeros((5, 4), np.float32))
        assert y.shape == (5, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceSession().register("r", net, replicas=2)


def test_restore_without_device_raises_without_cuda(no_cuda, tmp_path):
    path = tmp_path / "missing.zip"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelSerializer.restoreMultiLayerNetwork(str(path))


class _OneBlockResNet(ResNet50):
    STAGES = (("s2", 1, (4, 4, 8), 1),)


def test_graph_entry_points_raise_without_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResNet50().init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResNet50(dataType="bfloat16").init()
    bf16 = _OneBlockResNet(numClasses=3, inputShape=(3, 16, 16),
                           dataType="bfloat16").init(device="cpu")
    assert bf16.device.type == "cpu"
    assert bf16._params["conv1"]["W"].dtype == torch.bfloat16
    model = _OneBlockResNet(numClasses=3, inputShape=(3, 16, 16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ComputationGraph(model.conf())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init()
    graph = model.init(device="cpu")
    assert graph.device.type == "cpu"
    path = str(tmp_path / "graph.zip")
    ModelSerializer.writeModel(graph, path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelSerializer.restoreComputationGraph(path)
    assert ModelSerializer.restoreComputationGraph(
        path, device="cpu").device.type == "cpu"


def test_training_raises_without_cuda_unless_cpu_is_named(no_cuda, tmp_path):
    conf = TextGenerationLSTM(vocabSize=5, hidden=8, seqLength=4).conf()
    rng = np.random.default_rng(0)
    f = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (2, 4))]
    f = f.transpose(0, 2, 1).copy()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiLayerNetwork(conf).init().fit(f, f)
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.fit(f, f)
    assert net.getIterationCount() == 1
    assert all(v.device.type == "cpu" for p in net._params
               for v in p.values())
    path = str(tmp_path / "net.zip")
    ModelSerializer.writeModel(net, path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelSerializer.restoreMultiLayerNetwork(path)
    restored = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
    assert restored.getIterationCount() == 1


def test_detection_and_zoo_entry_points_raise_without_cuda(no_cuda,
                                                            tmp_path):
    """TinyYOLO (a network) and YOLO2 and UNet (graphs) given no device,
    and a restored zip of each kind, raise; the CPU runs when named."""
    for model in (TinyYOLO(numClasses=2, inputShape=(3, 64, 64)),
                  YOLO2(numClasses=2, inputShape=(3, 64, 64)),
                  UNet(inputShape=(3, 16, 16), base=2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model.init()
    net = TinyYOLO(numClasses=2, inputShape=(3, 64, 64)).init(device="cpu")
    out = net.output(np.zeros((1, 3, 64, 64), np.float32))
    assert out.shape() == (1, 5, 7, 2, 2) and out.device.type == "cpu"
    path = str(tmp_path / "tiny.zip")
    ModelSerializer.writeModel(net, path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelSerializer.restoreMultiLayerNetwork(path)
    graph = UNet(inputShape=(3, 16, 16), base=2).init(device="cpu")
    path = str(tmp_path / "unet.zip")
    ModelSerializer.writeModel(graph, path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelSerializer.restoreComputationGraph(path)


def test_quantized_servable_raises_without_cuda_unless_cpu_is_named(
        no_cuda):
    from deeplearning4j_tpu_torch.models.zoo import LeNet
    from deeplearning4j_tpu_torch.precision import (
        QuantizedServable, quantize)

    net = LeNet().init(device="cpu")
    x = np.zeros((2, 784), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quantize(net, [x], example_shape=(784,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QuantizedServable(net, (784,))
    qsv = quantize(net, [x], example_shape=(784,), device="cpu")
    assert qsv.device.type == "cpu"
    assert qsv._qparams[4]["W"][0].dtype == torch.int8
    assert qsv.infer(x).shape == (2, 10)


_NO_ML_DTYPES = """
import sys, tempfile, os
import numpy as np, torch
from deeplearning4j_tpu_torch.nn import (
    DenseLayer, MultiLayerNetwork, NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu_torch.serving import as_servable
from deeplearning4j_tpu_torch.tree_util import tree_leaves
from deeplearning4j_tpu_torch.utils import ModelSerializer
from deeplearning4j_tpu_torch.utils.convert import (
    opt_states_to_numpy, params_from_numpy)

for policy, data_type in ((None, "bfloat16"), ("bf16", "float32"),
                          ("bf16_mixed", "float32")):
    b = NeuralNetConfiguration.Builder().seed(1).dataType(data_type)
    if policy:
        b = b.precision(policy)
    conf = (b.list().layer(DenseLayer.Builder().nIn(4).nOut(8)
                           .activation("relu").build())
            .layer(OutputLayer.Builder().nOut(3).activation("softmax")
                   .lossFunction("mcxent").build()).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = np.random.default_rng(0).normal(size=(6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2]]
    net.fit([(x, y)], 2)
    sv = as_servable(net, example_shape=(4,))
    out = sv.infer(x)
    assert sv.dtype == np.float32 and out.dtype == np.float32, policy
    assert np.array_equal(out, net.output(x).toNumpy()), policy
    host = opt_states_to_numpy(net._params)
    again = params_from_numpy(conf, host, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(again), tree_leaves(net._params))), policy
    path = os.path.join(tempfile.mkdtemp(), "m.zip")
    ModelSerializer.writeModel(net, path)
    back = ModelSerializer.restoreMultiLayerNetwork(path, device="cpu")
    trees = [[m._params, m._states, m._opt_states] for m in (back, net)]
    for a, b in zip(*map(tree_leaves, trees)):
        assert a.dtype == b.dtype and torch.equal(a, b), policy
    assert {k: float(v) for k, v in back._prec_state.items()} == {
        k: float(v) for k, v in net._prec_state.items()}, policy
assert "jax" not in sys.modules and "ml_dtypes" not in sys.modules
print("ok")
"""


def test_bf16_paths_run_without_jax_or_ml_dtypes():
    """as_servable on a bfloat16 network, numpy conversion both ways and a
    zip round trip, bit-equal, in an interpreter without jax or
    ml_dtypes (as_servable asked numpy for a "bfloat16" dtype before
    the precision slice, which raises there)."""
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


def test_pretrain_stays_on_the_named_device(no_cuda):
    """pretrainLayer runs on the CPU only when it is named."""
    from deeplearning4j_tpu_torch import nn

    conf = (nn.NeuralNetConfiguration.Builder().list()
            .layer(nn.AutoEncoder.Builder(nIn=4, nOut=3).build())
            .layer(nn.OutputLayer.Builder().nOut(2).build())
            .build())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiLayerNetwork(conf)
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.pretrainLayer(0, (np.ones((2, 4), np.float32), None))
    assert net.getIterationCount() == 1
    assert all(v.device.type == "cpu" for p in net._params
               for v in p.values())
