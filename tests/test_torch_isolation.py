"""The port stands apart from JAX and runs on the GPU unless told not to.

- No module of deeplearning4j_tpu_torch/, and not chip_smoke.py, imports
  ``jax`` or ``deeplearning4j_tpu`` (checked on the source's AST, so a
  lazy import inside a function counts too).
- With CUDA absent, every entry point given no device raises instead of
  running on the CPU, training included; a CUDA tensor never reaches the
  plain version.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch
from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import InferenceSession
from deeplearning4j_tpu_torch.utils.serializer import ModelSerializer

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "deeplearning4j_tpu"}
SOURCES = sorted(Path(deeplearning4j_tpu_torch.__file__).parent.rglob(
    "*.py")) + [ROOT / "chip_smoke.py"]


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
                 "chip_smoke.py"):
        assert want in names
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    from deeplearning4j_tpu.nn import x\n")
    assert _imported_roots(bad) & FORBIDDEN == {"deeplearning4j_tpu"}


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
        MultiLayerNetwork(conf, device="cuda")
    # the CPU only when named
    net = MultiLayerNetwork(conf, device="cpu").init()
    assert net.device.type == "cpu"
    assert net.output(np.zeros((1, 5, 4), np.float32)).device.type == "cpu"


def test_restore_without_device_raises_without_cuda(no_cuda, tmp_path):
    path = tmp_path / "missing.zip"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelSerializer.restoreMultiLayerNetwork(str(path))


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
