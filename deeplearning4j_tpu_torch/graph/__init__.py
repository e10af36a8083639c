from deeplearning4j_tpu_torch.graph.deepwalk import (  # noqa: F401
    DeepWalk, Graph, RandomWalkIterator)
