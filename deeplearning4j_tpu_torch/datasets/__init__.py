"""Host data containers and iterators."""

from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet, MultiDataSet, SplitTestAndTrain)
from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: F401
    DataSetIterator, ExistingDataSetIterator, ListDataSetIterator)
from deeplearning4j_tpu_torch.datasets.mnist import (  # noqa: F401
    MnistDataSetIterator, synthesize_mnist)
