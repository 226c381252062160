from deeplearning4j_tpu_torch.nn.updater.updaters import (  # noqa: F401
    GradientNormalization,
    LearningRatePolicy,
    Updater,
    UpdaterConfig,
    apply_updater,
    effective_learning_rate,
    init_updater_state,
    normalize_gradient,
)
