"""Inference serving: bucket ladder, registry, dynamic batcher, replica
sets on CUDA streams, admission control, the continuous-batching decode
engine, the InferenceSession facade and the HTTP handlers (``http``)
(counterpart of ``deeplearning4j_tpu.serving``; its mesh-sharded
servables come with the parallel tier)."""

from deeplearning4j_tpu_torch.serving.admission import (
    AdmissionController, ShedError)
from deeplearning4j_tpu_torch.serving.batcher import (
    DynamicBatcher, QueueFullError, ServingShutdown, ServingTimeout,
    execute_plan, run_batch)
from deeplearning4j_tpu_torch.serving.buckets import (
    BucketLadder, DEFAULT_BATCH_BUCKETS, pad_batch, pad_rows, pad_time,
    unpad)
from deeplearning4j_tpu_torch.serving.decode import (
    DecodeEngine, PagedKVCache, RnnDecodeModel, TransformerDecodeModel)
from deeplearning4j_tpu_torch.serving.prefill import ChunkedPrefill
from deeplearning4j_tpu_torch.serving.prefix_cache import PrefixCache
from deeplearning4j_tpu_torch.serving.registry import (
    ModelNotFound, ModelRegistry)
from deeplearning4j_tpu_torch.serving.replica import (
    Replica, ReplicaDeath, ReplicaSet)
from deeplearning4j_tpu_torch.serving.servable import (
    FnServable, GraphServable, NetworkServable, SameDiffServable, Servable,
    as_servable)
from deeplearning4j_tpu_torch.serving.session import InferenceSession
from deeplearning4j_tpu_torch.serving.speculative import (
    SpeculativeConfig, SpeculativeDecoder)

__all__ = [
    "AdmissionController", "BucketLadder", "ChunkedPrefill",
    "DEFAULT_BATCH_BUCKETS", "DecodeEngine", "DynamicBatcher",
    "FnServable", "GraphServable", "InferenceSession", "ModelNotFound",
    "ModelRegistry", "NetworkServable", "PagedKVCache", "PrefixCache",
    "QueueFullError", "Replica", "ReplicaDeath", "ReplicaSet",
    "RnnDecodeModel", "SameDiffServable", "Servable",
    "ServingShutdown", "ServingTimeout", "ShedError", "SpeculativeConfig",
    "SpeculativeDecoder", "TransformerDecodeModel", "as_servable",
    "execute_plan", "pad_batch", "pad_rows", "pad_time", "run_batch",
    "unpad",
]
