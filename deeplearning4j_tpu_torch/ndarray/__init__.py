"""The ND4J tensor layer over PyTorch: ``INDArray``, ``Nd4j`` and
``Transforms``.

Counterpart of ``deeplearning4j_tpu/ndarray/``, with the same public names
and methods. An :class:`INDArray` is a handle over a ``torch.Tensor`` on
an explicit device. Where the two packages deliberately differ (in-place
ops write into the tensor, ``torch()`` for ``jax()``, an explicit
``torch.Generator`` for the random stream, torch dtypes, bf16 read back as
float32) the modules' docstrings and ``ROADMAP.md`` say so.
"""

from deeplearning4j_tpu_torch.ndarray.ndarray import INDArray
from deeplearning4j_tpu_torch.ndarray.factory import Nd4j
from deeplearning4j_tpu_torch.ndarray.transforms import Transforms

__all__ = ["INDArray", "Nd4j", "Transforms"]
