"""Run the cuda-marked tests of the given test files on a CUDA machine.

    python scripts/cuda_tests.py [pytest options] tests/test_torch_<name>.py ...

The test modules' imports of JAX and of the JAX package, which the
cuda-marked tests do not use, are replaced by empty modules, so that the
port's tests run on the card without the reference; tests/conftest.py
(which configures JAX) is not loaded. Exits with pytest's code."""
import os
import sys
import types

import pytest

sys.path.insert(0, os.getcwd())

for name in ("jax", "jax.numpy", "deeplearning4j_tpu",
             "deeplearning4j_tpu.nn", "deeplearning4j_tpu.nn.conf",
             "deeplearning4j_tpu.nn.conf.layers"):
    mod = types.ModuleType(name)
    mod.__path__ = []
    sys.modules[name] = mod
    parent, _, child = name.rpartition(".")
    if parent:
        setattr(sys.modules[parent], child, mod)
sys.exit(pytest.main(["-p", "no:cacheprovider", "--noconftest", "-m", "cuda",
                      "-q", *sys.argv[1:]]))
