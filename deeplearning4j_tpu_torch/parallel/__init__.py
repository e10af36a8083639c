"""The parallel tier: one process driving a mesh, or ranks of a process
group.

Counterpart of ``deeplearning4j_tpu/parallel/``. Ported: ``mesh.py``,
``moe.py``, ``pipeline.py``, ``pipeline_trainer.py``, ``multihost.py``,
``sharding.py``, ``ring_attention.py`` and ``trainer.py``, with the port's
own ``transport.py``. ``elastic.py`` comes with ROADMAP queue 1 item 13
(it stands on ``resilience/``), ``mesh.replica_devices`` and the sharded
serving tier with item 12b.

In the reference, ``data``, ``model`` and ``expert`` are GSPMD layouts (the
loss is the global batch's whatever the mesh), ``seq`` is ring attention
and ``pipe`` a GPipe schedule whose output equals applying the stages in
sequence. The port gives each axis a counterpart with the same numbers.

**One process, a mesh over a device list** (which may repeat one card,
``[torch.device("cuda")] * 4``; the CPU tests name ``["cpu"] * n``):

- **Devices.** A ``Mesh`` is a named-axis layout over a list of devices.
  ``MeshConfig.build()`` without devices takes ``torch.cuda.device_count()``
  devices and raises when CUDA is absent (no fallback to the CPU).
- **data, model and expert** place nothing and change no number: batches,
  params, the experts and every replicated value sit on the mesh's first
  device, and a spec tree (``sharding.py``, ``param_specs``) is kept in
  name only. ``ShardedTrainer`` pads the batch to the data size with
  padding rows masked out, and its step is the network's own.
- **seq** runs the ring (``ring_attention``): the sequence is cut into n
  blocks, each block's K/V sit on their mesh device and rotate with
  ``.to()``, and the n query blocks are batched.
- **pipe** runs the S stages in one process: each stage's params sit on
  its mesh device, activations move between stage devices with ``.to()``,
  the M microbatches run in the reference's schedule order with the
  microbatch index handed to each stage as ``pipeline_apply`` hands it,
  and bubble ticks do no work.

**Several ranks** (``MultiHost.initialize``: a ``torch.distributed``
group, gloo on the CPU, NCCL on cards, every collective with a timeout;
``transport.py`` moves the tensors):

- each rank owns its positions of the mesh (``Mesh.ranks``, rank-major);
- **data**: each rank holds its shard of the global batch; the gradients
  are weighed by the rank's share of the global mask and all-reduced, so
  the loss stays the global batch's mean with padding rows weighed out;
- **seq**: each rank holds one block of the sequence, and the K/V blocks
  rotate by point-to-point sends to rank + 1 and receives from rank - 1
  (the reference's ``lax.ppermute``), in the backward too;
- **model, pipe and expert** across ranks raise ``NotImplementedError``
  (ROADMAP queue 1 item 12b), and so does a BERT trainer over ranks.
"""

from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, EXPERT_AXIS, Mesh, MeshConfig, MODEL_AXIS, PIPE_AXIS,
    SEQ_AXIS, replicated, shard_batch, spec_for)
from deeplearning4j_tpu_torch.parallel.trainer import (  # noqa: F401
    ParallelInference, ParallelWrapper, ParameterAveragingTrainingMaster,
    ShardedTrainer, SharedTrainingMaster, SparkDl4jMultiLayer)
from deeplearning4j_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention)
from deeplearning4j_tpu_torch.parallel.sharding import (  # noqa: F401
    alternating_dense_specs, replicated_specs)
from deeplearning4j_tpu_torch.parallel.multihost import (  # noqa: F401
    MultiHost, VoidConfiguration)
from deeplearning4j_tpu_torch.parallel.moe import (  # noqa: F401
    MoELayerTrainer, moe_apply, moe_init, moe_param_specs)
from deeplearning4j_tpu_torch.parallel.pipeline import (  # noqa: F401
    PipelineMlp, pipeline_apply, pipeline_dryrun)
from deeplearning4j_tpu_torch.parallel.pipeline_trainer import (  # noqa: F401
    PipelineParallelTrainer)
