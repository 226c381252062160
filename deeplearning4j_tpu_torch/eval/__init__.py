from deeplearning4j_tpu_torch.eval.evaluation import ConfusionMatrix, Evaluation  # noqa: F401
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation  # noqa: F401
from deeplearning4j_tpu_torch.eval.roc import ROC  # noqa: F401
