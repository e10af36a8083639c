"""Model restore and weight conversion."""

from deeplearning4j_tpu_torch.utils.serializer import (  # noqa: F401
    ModelSerializer)
