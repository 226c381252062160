"""Parallel and serving-engine support: the serving engine
(``parallel/inference.py`` ``ParallelInference``) and its typed errors.
The mesh, the wrapper and the sharded paths wait for ROADMAP A9."""

from deeplearning4j_tpu_torch.parallel.inference import (  # noqa: F401
    EngineShutdown,
    InferenceBackpressure,
    ParallelInference,
    SliceDegraded,
)
