"""Run the cuda-marked tests of the given test files on a CUDA machine.

    python scripts/cuda_tests.py [pytest options] tests/test_torch_<name>.py ...

The test modules' imports of JAX and of the JAX package, which the
cuda-marked tests do not use, are replaced by stub modules (every name
in them a placeholder that any attribute, call or decoration returns), so
that the port's tests run on the card without the reference;
tests/conftest.py (which configures JAX) is not loaded. Exits with
pytest's code."""
import importlib.abc
import importlib.machinery
import os
import sys
import types

import pytest

sys.path.insert(0, os.getcwd())

STUBBED = ("jax", "jaxlib", "deeplearning4j_tpu")


class _Stub:
    """Whatever a stubbed module is asked for at import time: any
    attribute, any call (a decorator too), always this object."""

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self

    def __call__(self, *args, **kwargs):
        return self


class _StubModule(types.ModuleType):
    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return _Stub()


class _StubFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Every module under the STUBBED roots (not deeplearning4j_tpu_torch)
    is an empty module whose names are ``_Stub``s."""

    def find_spec(self, name, path=None, target=None):
        if any(name == r or name.startswith(r + ".") for r in STUBBED):
            return importlib.machinery.ModuleSpec(name, self,
                                                  is_package=True)
        return None

    def create_module(self, spec):
        mod = _StubModule(spec.name)
        mod.__path__ = []
        return mod

    def exec_module(self, module):
        pass


sys.meta_path.insert(0, _StubFinder())
sys.exit(pytest.main(["-p", "no:cacheprovider", "--noconftest", "-m", "cuda",
                      "-q", *sys.argv[1:]]))
