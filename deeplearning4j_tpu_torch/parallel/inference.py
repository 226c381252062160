"""The serving engine's typed errors.

Counterpart of the two exception types of
``deeplearning4j_tpu/parallel/inference.py`` that the continuous decode
scheduler raises; the engine (``ParallelInference``) waits for ROADMAP
A10.
"""


class InferenceBackpressure(RuntimeError):
    """``submit`` found the admission queue full."""


class EngineShutdown(RuntimeError):
    """A submit was rejected because the engine (or its decode
    scheduler) is shut down."""
