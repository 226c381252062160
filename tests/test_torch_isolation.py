"""The port stands alone: it imports neither jax nor the JAX package,
and it never moves to the CPU unless asked."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import deeplearning4j_tpu_torch
from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
from deeplearning4j_tpu_torch.util import model_serializer

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.dirname(deeplearning4j_tpu_torch.__file__)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [_PKG], prefix="deeplearning4j_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert "deeplearning4j_tpu_torch.nn.generate" in mods
    # only what the port's imports add counts: a site hook of the
    # interpreter may have loaded modules before the first line runs
    code = ("import importlib, sys\n"
            "before = set(sys.modules)\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "new = set(sys.modules) - before\n"
            "bad = sorted(m for m in new if m == 'jax' "
            "or m.startswith('jax.') or m == 'deeplearning4j_tpu' "
            "or m.startswith('deeplearning4j_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_training_slice_modules_are_scanned():
    """The training slice's modules (updaters, losses, DataSet, the
    flash backward's wrapper and kernel source) are among the modules
    and files the two scans above cover."""
    mods = _modules()
    for name in ("nn.updater", "nn.updater.updaters", "ops.losses",
                 "datasets.dataset", "datasets.iterators",
                 "ops.flash_attention", "util.rng", "kernels"):
        assert f"deeplearning4j_tpu_torch.{name}" in mods, name
    kernel_dir = os.path.join(_PKG, "kernels")
    assert {"flash_fwd.cu", "flash_bwd.cu"} <= set(os.listdir(kernel_dir))
    for src in ("flash_fwd.cu", "flash_bwd.cu"):
        with open(os.path.join(kernel_dir, src)) as f:
            text = f.read()
        assert "torch/extension.h" not in text and "jax" not in text.lower()


def test_char_rnn_slice_modules_are_scanned():
    """The char-RNN slice's modules (the recurrent layers, the LSTM
    kernels' wrapper, the activations) and the LSTM kernel sources are
    among what the scans cover; the sources include no PyTorch header."""
    mods = _modules()
    for name in ("nn.layers.recurrent", "ops.lstm_kernel", "ops.activations",
                 "nn.generate", "util.dtypes"):
        assert f"deeplearning4j_tpu_torch.{name}" in mods, name
    kernel_dir = os.path.join(_PKG, "kernels")
    srcs = ("lstm_fwd.cu", "lstm_bwd.cu", "lstm_common.cuh")
    assert set(srcs) <= set(os.listdir(kernel_dir))
    for src in srcs:
        with open(os.path.join(kernel_dir, src)) as f:
            text = f.read()
        assert "torch/extension.h" not in text and "jax" not in text.lower()
        assert "cudnn" not in text.lower() and "cublas" not in text.lower()


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax_or_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(_PKG)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(_ROOT, "chip_smoke.py"))
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "deeplearning4j_tpu"), \
                f"{path} imports {name}"


def test_default_device_is_cuda_and_never_silently_cpu(tmp_path):
    size = dict(vocab_size=16, d_model=16, n_layers=1, num_heads=2,
                max_len=16, compute_dtype="float32")
    if torch.cuda.is_available():
        assert gpt(**size).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt(**size)
    path = str(tmp_path / "m.zip")
    model_serializer.write_model(gpt(device="cpu", **size).init(), path)
    with pytest.raises(RuntimeError, match="no CUDA|has none"):
        model_serializer.restore_multi_layer_network(path)
    assert model_serializer.restore_multi_layer_network(
        path, device="cpu").device.type == "cpu"
