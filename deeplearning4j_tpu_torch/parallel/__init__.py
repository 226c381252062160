"""Parallel and serving-engine support. For now only the serving
engine's typed errors (``parallel/inference.py``); the engine itself and
the mesh wait for ROADMAP A10 and A9."""
