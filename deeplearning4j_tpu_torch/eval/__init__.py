from deeplearning4j_tpu_torch.eval.evaluation import ConfusionMatrix, Evaluation  # noqa: F401
