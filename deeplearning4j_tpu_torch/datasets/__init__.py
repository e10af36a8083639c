"""Host data containers and iterators."""

from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet, SplitTestAndTrain)
from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: F401
    DataSetIterator, ExistingDataSetIterator, ListDataSetIterator)
