"""Hand-written CUDA kernels of the port, each beside its plain version.
Importing a kernel module builds nothing: each kernel builds at its first
launch."""

from deeplearning4j_tpu_torch.kernels.lstm import lstm_seq  # noqa: F401
