from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    CollectScoresIterationListener,
    IterationListener,
    PerformanceListener,
    ScoreIterationListener,
)
from deeplearning4j_tpu_torch.optimize.training_stats import TrainingStats  # noqa: F401
