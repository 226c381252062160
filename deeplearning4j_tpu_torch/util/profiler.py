"""Device profiler hooks.

Counterpart of ``deeplearning4j_tpu/util/profiler.py``, which wraps
``jax.profiler``: here thin wrappers over ``torch.profiler`` that write
a trace of the real device timeline (kernels, copies, the host's
launches) that TensorBoard's profiler plugin or Perfetto loads. The
host's phases live in ``monitor/`` spans already; ``annotate`` names a
host region inside a captured trace.

The reference's shield against its profiler importing TensorFlow is
specific to ``jax.profiler`` and is not ported. ``start_server`` (the
reference's on-demand profiling server, for TensorBoard's "capture
profile" button) has no ``torch.profiler`` counterpart and raises
:class:`ProfilerServerUnavailable`.
"""

from __future__ import annotations

import contextlib
import logging
import os

_log = logging.getLogger("deeplearning4j_tpu_torch")


class ProfilerServerUnavailable(NotImplementedError):
    """``torch.profiler`` has no on-demand profiling server."""


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False,
          python_tracer: bool = False):
    """Capture a device trace of the enclosed block into ``log_dir``::

        with profiler.trace("/tmp/torch-trace"):
            net.fit_scan(ds, 512, epochs=1)
        # then: tensorboard --logdir /tmp/torch-trace
        # (or load the *.pt.trace.json into https://ui.perfetto.dev)

    Records CUDA activity where a card is present, and the CPU's
    operators always; ``python_tracer=True`` adds the Python call stacks
    (``with_stack``). ``create_perfetto_link`` is the reference's
    argument and only logs that the trace file is to be opened by hand.
    A profiler that cannot start logs a warning and the block runs
    untraced, as in the reference."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = None
    try:
        prof = profile(activities=activities, with_stack=python_tracer,
                       on_trace_ready=tensorboard_trace_handler(str(log_dir)))
        prof.__enter__()
    except Exception as e:
        _log.warning("profiler trace unavailable: %s", e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
            except Exception as e:
                _log.warning("profiler trace export failed: %s", e)
        if create_perfetto_link:
            _log.info("profiler trace in %s: open it in https://ui.perfetto.dev",
                      log_dir)


def start_server(port: int = 9999):
    """The reference starts ``jax.profiler``'s on-demand server here;
    ``torch.profiler`` has none, so this raises."""
    raise ProfilerServerUnavailable(
        "start_server: torch.profiler has no on-demand profiling server; "
        "capture with profiler.trace(log_dir) around the region instead")


def annotate(name: str):
    """Name a host region in a captured trace (``record_function``)."""
    from torch.profiler import record_function

    return record_function(name)
