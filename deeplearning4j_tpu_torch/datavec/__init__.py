"""DataVec: record readers and their DataSet iterators."""

from deeplearning4j_tpu_torch.datavec.iterator import (  # noqa: F401
    RecordReaderDataSetIterator,
    RecordReaderMultiDataSetIterator,
    SequenceRecordReaderDataSetIterator,
)
from deeplearning4j_tpu_torch.datavec.records import (  # noqa: F401
    CSVRecordReader,
    CSVSequenceRecordReader,
    ImageRecordReader,
    LineRecordReader,
    RecordReader,
)
