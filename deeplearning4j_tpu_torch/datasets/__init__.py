"""DataSets, their iterators and loaders (``datavec`` for record
readers)."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet  # noqa: F401
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    DataSetIterator,
    ListDataSetIterator,
    AsyncDataSetIterator,
    MultipleEpochsIterator,
)
