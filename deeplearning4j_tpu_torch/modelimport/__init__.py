"""Model import (reference L6: deeplearning4j-modelimport + nd4j-api
org.nd4j.imports): TF GraphDef import into SameDiff. The Keras importer
of the JAX package needs h5py and is not ported (ROADMAP.md)."""

from deeplearning4j_tpu_torch.modelimport.tensorflow import (  # noqa: F401
    TFGraphMapper, TFImportError)
