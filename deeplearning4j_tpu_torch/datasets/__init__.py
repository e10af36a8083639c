"""The data tier: containers, iterators, record readers, DataVec
transforms, normalizers, the image pipeline, the parallel ETL pool and the
device prefetcher.

Counterpart of ``deeplearning4j_tpu.datasets``, with the same re-exports.
Everything but ``prefetch`` is numpy on the host, copied from the JAX
package; ``prefetch`` stages batches on the card on a CUDA side stream.
"""

from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet, MultiDataSet, SplitTestAndTrain)
from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: F401
    AsyncDataSetIterator, DataSetIterator, ExistingDataSetIterator,
    ListDataSetIterator)
from deeplearning4j_tpu_torch.datasets.mnist import (  # noqa: F401
    MnistDataSetIterator, synthesize_mnist)
from deeplearning4j_tpu_torch.datasets.records import (  # noqa: F401
    CollectionRecordReader, CSVRecordReader, FileSplit, InputSplit,
    LineRecordReader, ListStringSplit, RecordReader,
    RecordReaderDataSetIterator, RecordReaderMultiDataSetIterator)
from deeplearning4j_tpu_torch.datasets.join import (  # noqa: F401
    Join, JoinType, executeJoin)
from deeplearning4j_tpu_torch.datasets.analysis import (  # noqa: F401
    AnalyzeLocal, CategoricalColumnAnalysis, DataAnalysis,
    NumericalColumnAnalysis)
from deeplearning4j_tpu_torch.datasets.normalizers import (  # noqa: F401
    ImagePreProcessingScaler, Normalizer, NormalizerMinMaxScaler,
    NormalizerStandardize)
from deeplearning4j_tpu_torch.datasets.transform import (  # noqa: F401
    CategoricalColumnCondition, ColumnType, ConditionOp,
    DoubleColumnCondition, MathFunction, MathOp, Schema,
    StringColumnCondition, TransformProcess, TransformProcessRecordReader)
from deeplearning4j_tpu_torch.datasets.image import (  # noqa: F401
    CropImageTransform, FlipImageTransform, ImageRecordReader,
    ImageTransform, NativeImageLoader, ParentPathLabelGenerator,
    PathLabelGenerator, PipelineImageTransform, ResizeImageTransform,
    ScaleImageTransform)
from deeplearning4j_tpu_torch.datasets.parallel_etl import (  # noqa: F401
    EtlWorkerPool, LocalTransformExecutor, ParallelImageDataSetIterator,
    shared_pool)
from deeplearning4j_tpu_torch.datasets.prefetch import (  # noqa: F401
    DeviceBatch, DevicePrefetcher, default_depth, set_default_depth)
