"""The repo's kernel probes, ported: runnable entry points that time the
bf16 tensor-core kernels of ``kernels/probe_matmul.py`` and
``kernels/bottleneck.py`` against cuBLAS and cuDNN.

    python -m deeplearning4j_tpu_torch.tools.probe_matmul
    python -m deeplearning4j_tpu_torch.tools.probe_fused_block --stage s2
    python -m deeplearning4j_tpu_torch.tools.probe_fused_parts

Counterparts of ``tools/probe_matmul.py``, ``tools/probe_fused_block.py``
and ``tools/probe_fused_parts.py`` (the JAX package's, which stay as they
are): the same shapes, stages and arguments. Importing them runs nothing;
``main(argv=None)`` runs a probe on ``cuda`` unless ``--device cpu`` is
given (the plain versions, host-clock times, no device metric). Each prints
one JSON line per measurement and returns the records.
"""
