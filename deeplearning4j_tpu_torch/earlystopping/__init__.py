from deeplearning4j_tpu_torch.earlystopping.earlystopping import (  # noqa: F401
    DataSetLossCalculator,
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
    EarlyStoppingTrainer,
    InMemoryModelSaver,
    LocalFileModelSaver,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)
