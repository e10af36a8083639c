"""deeplearning4j_tpu_torch: the PyTorch/CUDA port of deeplearning4j_tpu.

Module paths and public names mirror the JAX package, and each package
re-exports the ported names that its counterpart re-exports
(``from deeplearning4j_tpu_torch.nn import MultiLayerNetwork, LSTM``). The
port imports torch and numpy, never jax nor the JAX package. Entry points
run on the GPU unless the caller passes device="cpu". Importing the
package builds and loads no CUDA kernel and needs no GPU: kernels build at
their first launch.
"""

from deeplearning4j_tpu_torch import backend  # noqa: F401  (TF32 off)

__version__ = "0.1.0"

from deeplearning4j_tpu_torch.ndarray import Nd4j, INDArray  # noqa: E402,F401
from deeplearning4j_tpu_torch.backend import Nd4jBackend  # noqa: E402,F401
from deeplearning4j_tpu_torch.runtime import RuntimeConfig  # noqa: E402,F401
