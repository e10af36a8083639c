"""Inference serving: bucket ladder, registry, dynamic batcher and the
InferenceSession facade (counterpart of ``deeplearning4j_tpu.serving``)."""

from deeplearning4j_tpu_torch.serving.batcher import (
    DynamicBatcher, QueueFullError, ServingShutdown, ServingTimeout,
    execute_plan, run_batch)
from deeplearning4j_tpu_torch.serving.buckets import (
    BucketLadder, DEFAULT_BATCH_BUCKETS, pad_batch, pad_rows, pad_time,
    unpad)
from deeplearning4j_tpu_torch.serving.registry import (
    ModelNotFound, ModelRegistry)
from deeplearning4j_tpu_torch.serving.servable import (
    FnServable, GraphServable, NetworkServable, SameDiffServable, Servable,
    as_servable)
from deeplearning4j_tpu_torch.serving.session import InferenceSession

__all__ = [
    "BucketLadder", "DEFAULT_BATCH_BUCKETS", "DynamicBatcher", "FnServable",
    "GraphServable", "InferenceSession", "ModelNotFound", "ModelRegistry",
    "NetworkServable",
    "QueueFullError", "SameDiffServable", "Servable", "ServingShutdown",
    "ServingTimeout", "as_servable", "execute_plan", "pad_batch",
    "pad_rows", "pad_time", "run_batch", "unpad",
]
