"""The port's packages export what the JAX package's export.

- For every package ``__init__`` of the JAX package, each name it imports
  from a module that the port also has, and that the port's module
  defines, imports from the port's matching package as the same object
  (``from deeplearning4j_tpu_torch.nn import MultiLayerNetwork`` works as
  ``from deeplearning4j_tpu.nn import ...`` does). The reference's
  ``__init__`` files are read as source (their ``from ... import``
  statements), so names that the port has not ported yet are skipped
  rather than guessed.
- Importing the port's top-level package loads no CUDA kernel and needs
  no GPU.
- ``ModelRegistry.names()`` and ``ExistingDataSetIterator`` against the
  JAX package's.
"""

import ast
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import deeplearning4j_tpu_torch
from deeplearning4j_tpu.datasets import (
    ExistingDataSetIterator as JaxExisting)
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.serving.registry import (
    ModelRegistry as JaxRegistry)
from deeplearning4j_tpu_torch.datasets import (
    DataSet, ExistingDataSetIterator, ListDataSetIterator)
from deeplearning4j_tpu_torch.serving import FnServable, ModelRegistry

ROOT = Path(__file__).resolve().parent.parent
REF = "deeplearning4j_tpu"
PORT = "deeplearning4j_tpu_torch"
PACKAGES = sorted(
    p.parent.relative_to(ROOT / REF).as_posix().replace("/", ".")
    for p in (ROOT / REF).rglob("__init__.py")
    if "__pycache__" not in p.parts)


def _reference_exports(package):
    """[(source module, name in it, exported name)] of the reference
    package's ``__init__``, from its absolute ``from X import a as b``
    statements."""
    rel = "" if package == "." else package.replace(".", "/")
    path = ROOT / REF / rel / "__init__.py"
    out = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 0 and (
                node.module == REF or node.module.startswith(REF + ".")):
            for a in node.names:
                out.append((node.module, a.name, a.asname or a.name))
    return out


def _port_module(name):
    port = PORT + name[len(REF):]
    try:
        if importlib.util.find_spec(port) is None:
            return None
    except ModuleNotFoundError:
        return None
    return importlib.import_module(port)


def _ported(module, name):
    """The port's counterpart of ``module.name`` (an attribute, or a
    submodule imported by name), or None."""
    mod = _port_module(module)
    if mod is None:
        return None
    if hasattr(mod, name):
        return getattr(mod, name)
    return _port_module(f"{module}.{name}")


def test_the_scan_sees_the_reference_packages():
    assert {".", "nn", "nn.conf", "datasets", "optimize", "utils", "models",
            "evaluation", "serving", "ndarray"} <= set(PACKAGES)
    assert ("deeplearning4j_tpu.nn.multilayer", "MultiLayerNetwork",
            "MultiLayerNetwork") in _reference_exports("nn")


@pytest.mark.parametrize("package", PACKAGES)
def test_package_exports_every_ported_name(package):
    port_pkg = importlib.import_module(
        PORT if package == "." else f"{PORT}.{package}") \
        if _port_module(REF if package == "." else f"{REF}.{package}") \
        else None
    missing = []
    for module, name, exported in _reference_exports(package):
        obj = _ported(module, name)
        if obj is None:
            continue
        if port_pkg is None or getattr(port_pkg, exported, None) is not obj:
            missing.append(f"{exported} (from {module})")
    assert not missing, f"{PORT}.{package} lacks {missing}"


@pytest.mark.parametrize("package,names", [
    (".", ["Nd4j", "INDArray"]),
    ("nn", ["MultiLayerNetwork", "NeuralNetConfiguration", "LSTM",
            "Bidirectional", "LastTimeStep", "SimpleRnn", "InputType",
            "GradientNormalization", "layers", "Yolo2OutputLayer",
            "YoloUtils", "DetectedObject", "AttentionVertex",
            "SelfAttentionLayer", "CapsuleLayer", "PrimaryCapsules",
            "FrozenLayer", "MaskZeroLayer", "OCNNOutputLayer",
            "CenterLossOutputLayer", "Convolution3D", "AutoEncoder",
            "VariationalAutoencoder"]),
    ("nn.conf", ["variational", "objdetect", "layers_extra", "attention",
                 "capsnet"]),
    ("nn.conf", ["InputType", "MultiLayerConfiguration",
                 "NeuralNetConfiguration"]),
    ("datasets", ["DataSet", "DataSetIterator", "ListDataSetIterator",
                  "ExistingDataSetIterator", "SplitTestAndTrain"]),
    ("optimize", ["Adam", "Sgd", "updater_from_config", "CycleSchedule"]),
    ("utils", ["ModelSerializer"]),
    ("models", ["TinyYOLO", "YOLO2", "UNet", "SqueezeNet", "Xception",
                "NASNet", "FaceNetNN4Small2", "InceptionResNetV1"]),
    ("models", ["TextGenerationLSTM", "ZooModel", "BertConfig",
                "BertTrainer", "mlm_loss", "synthetic_mlm_batch",
                "bert_forward", "bert_init_params"]),
    ("evaluation", ["Evaluation", "RegressionEvaluation", "ROC"]),
])
def test_named_exports(package, names):
    pkg = importlib.import_module(PORT if package == "." else
                                  f"{PORT}.{package}")
    assert [n for n in names if not hasattr(pkg, n)] == []


def test_top_level_import_loads_no_kernel_and_needs_no_gpu():
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "import deeplearning4j_tpu_torch as d\n"
            "from deeplearning4j_tpu_torch.nn import MultiLayerNetwork\n"
            "from deeplearning4j_tpu_torch.kernels import build\n"
            "assert not build._loaded, build._loaded\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', "
            "'deeplearning4j_tpu.')) for m in sys.modules)\n"
            "print(d.Nd4j.__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "Nd4j"


def test_registry_names_match_jax():
    got, want = ModelRegistry(), JaxRegistry()
    assert got.names() == want.names() == []
    for name, version in (("b", 1), ("a", 1), ("b", 2)):
        want.register(name, lambda x: x, version=version,
                      example_shape=(2,), warmup=False)
        got.register(name, FnServable(lambda x: x, (2,), device="cpu"),
                     version=version)
    assert got.names() == want.names() == ["a", "b"]
    got.unregister("a")
    want.unregister("a")
    assert got.names() == want.names() == ["b"]
    assert isinstance(got.get("b").servable, FnServable)


def test_existing_dataset_iterator_matches_jax():
    rng = np.random.default_rng(0)
    data = [(rng.normal(size=(n, 3)).astype(np.float32),
             rng.normal(size=(n, 2)).astype(np.float32)) for n in (4, 4, 2)]
    got = ExistingDataSetIterator([DataSet(f, l) for f, l in data])
    want = JaxExisting([JaxDataSet(f, l) for f, l in data])
    assert isinstance(got, ListDataSetIterator)
    assert got.totalExamples() == want.totalExamples() == 10
    for _ in range(2):   # iterating resets
        batches = list(got)
        ref = list(want)
        assert len(batches) == len(ref) == 3
        for a, b in zip(batches, ref):
            np.testing.assert_array_equal(a.features, np.asarray(b.features))
            np.testing.assert_array_equal(a.labels, np.asarray(b.labels))
    # from (features, labels) pairs and via hasNext/next, as the
    # reference's
    it = ExistingDataSetIterator(data)
    it.reset()
    n = 0
    while it.hasNext():
        n += it.next().numExamples()
    assert n == 10
