"""Serving on the card: the continuous decode scheduler
(``serving/continuous.py``) and its cross-request prefix cache
(``serving/prefixcache.py``); the engine in front of them is
``parallel/inference.py``. The model registry, sessions and the rest of
the reference's serving tier (router, fleet, policy, wire) wait for
ROADMAP A10b and A11."""

from deeplearning4j_tpu_torch.serving.continuous import (  # noqa: F401
    ContinuousDecodeScheduler,
    DecodeBurstError,
    KVPoolExhausted,
)
from deeplearning4j_tpu_torch.serving.prefixcache import PrefixCache  # noqa: F401
