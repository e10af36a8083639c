"""Precision: policy-based mixed-precision training and int8
post-training quantization for serving.

Counterpart of ``deeplearning4j_tpu.precision``. Training::

    conf = (NeuralNetConfiguration.Builder()
            .precision("bf16_mixed")        # float32 masters, bf16 compute,
            .list() ... .build())           # dynamic loss scaling
    net = MultiLayerNetwork(conf).init()    # on the GPU
    net.fit(data, epochs)                   # the scaler runs in the step

Serving::

    from deeplearning4j_tpu_torch.precision import quantize
    qsv = quantize(net, calibration_batches, example_shape=(784,))
    session.register("model_int8", qsv, warmup=True)
"""

from deeplearning4j_tpu_torch.precision.monitor import (
    PrecisionInstruments, PrecisionMonitor, monitor_for)
from deeplearning4j_tpu_torch.precision.policy import (
    NAMED_POLICIES, Policy, cast_floating, named_policy, resolve_policy)
from deeplearning4j_tpu_torch.precision.quantize import (
    QuantizedServable, dequantize_array, quantize, quantize_array,
    quantize_params)
from deeplearning4j_tpu_torch.precision.scaler import (
    DynamicLossScaler, FixedLossScaler)

__all__ = [
    "DynamicLossScaler", "FixedLossScaler", "NAMED_POLICIES", "Policy",
    "PrecisionInstruments", "PrecisionMonitor", "QuantizedServable",
    "cast_floating", "dequantize_array", "monitor_for", "named_policy",
    "quantize", "quantize_array", "quantize_params", "resolve_policy",
]
