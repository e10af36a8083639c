"""deeplearning4j_tpu_torch: the PyTorch/CUDA port of deeplearning4j_tpu.

Module paths and public names mirror the JAX package. The port imports
torch and numpy, never jax nor the JAX package. Entry points run on the
GPU unless the caller passes device="cpu".
"""

from deeplearning4j_tpu_torch import backend  # noqa: F401  (TF32 off)

__version__ = "0.1.0"
