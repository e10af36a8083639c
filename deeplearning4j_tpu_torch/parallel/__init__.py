"""The parallel tier, as far as one process drives it.

Counterpart of ``deeplearning4j_tpu/parallel/``. Ported: ``mesh.py``,
``moe.py``, ``pipeline.py`` and ``pipeline_trainer.py``; the rest
(``trainer.py``, ``ring_attention.py``, ``sharding.py``, ``multihost.py``,
``elastic.py``, ``mesh.replica_devices``) comes with ROADMAP queue 1 item
12, with multi-rank transport.

In the reference, ``data`` and ``expert`` are GSPMD layouts (the loss is the
global batch's whatever the mesh), and ``pipe`` is a GPipe schedule whose
output equals applying the stages in sequence. So in one process each axis
has a counterpart with the same numbers:

- **Devices.** A ``Mesh`` is a named-axis layout over a list of devices.
  ``MeshConfig.build()`` without devices takes ``torch.cuda.device_count()``
  devices and raises when CUDA is absent (no fallback to the CPU). A
  caller may name a list that repeats the one card
  (``[torch.device("cuda")] * 4``); the CPU tests name ``["cpu"] * n``.
- **data and expert** place nothing and change no number: batches, the
  experts and every replicated value sit on the mesh's first device.
- **pipe** runs the S stages in one process: each stage's params sit on
  its mesh device, activations move between stage devices with ``.to()``,
  the M microbatches run in the reference's schedule order with the
  microbatch index handed to each stage as ``pipeline_apply`` hands it,
  and bubble ticks do no work.
- **Multi-rank transport** (send/recv over ``torch.distributed``: gloo on
  the CPU, NCCL on cards), which takes the place of the reference's
  ``ppermute`` and ``shard_map``, comes with item 12.
"""

from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, EXPERT_AXIS, Mesh, MeshConfig, MODEL_AXIS, PIPE_AXIS,
    SEQ_AXIS, replicated, shard_batch, spec_for)
from deeplearning4j_tpu_torch.parallel.moe import (  # noqa: F401
    MoELayerTrainer, moe_apply, moe_init, moe_param_specs)
from deeplearning4j_tpu_torch.parallel.pipeline import (  # noqa: F401
    PipelineMlp, pipeline_apply, pipeline_dryrun)
from deeplearning4j_tpu_torch.parallel.pipeline_trainer import (  # noqa: F401
    PipelineParallelTrainer)
