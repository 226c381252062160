"""Model zip: config JSON + parameters, the reference's format.

Counterpart of ``deeplearning4j_tpu/util/model_serializer.py``, read and
written with ``zipfile`` and numpy only:

- ``configuration.json``: ``{"model_type", "conf"}`` (``config_payload``:
  a MultiLayerNetwork's conf with its input preprocessors and input
  type, or a ComputationGraph's);
- ``coefficients.npz``: one array per ``layerN/name`` key;
- ``modelState.npz``: non-trainable state, one array per
  ``layerN/name`` key (BN's moving ``mean`` and ``var``; an LSTM's
  carries live outside the saved state);
- ``updaterState.npz``: the step counter ``step`` (int32) and the
  updater state, one array per ``updater/layerN/param/name`` key
  (``m``/``v`` for Adam), so training resumes where it stopped;
- ``manifest.json``: a CRC32 per member, checked on restore.

A zip written by either package restores in the other, updater state
included, for both containers (``restore_multi_layer_network``,
``restore_computation_graph``, or ``restore_model`` for either); the
``*_from_numpy`` loaders carry a reference net's trees into either
container. Quantized weights (``nn/quantize.py``: an int8 or fp8 weight
beside its float32 ``*_qscale``) load through ``params_from_numpy`` and
mark the net quantized. In a zip, int8 weights go both ways; an fp8
weight is written as the reference writes it, one raw byte per value
(numpy has no fp8 dtype: ``np.savez`` records ``|V1``), and a zip that
holds one does not restore, as in the reference. A save runs in a
``checkpoint`` span; a restore that finds the zip torn or its CRCs
wrong ticks ``dl4j_fault_checkpoint_integrity_failures_total`` and
``dl4j_fault_events_total{domain="checkpoint"}`` before it raises
:class:`CheckpointCorruptError`.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
import zlib
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.monitor import (
    FAULT_CKPT_INTEGRITY_COUNTER,
    get_registry,
    record_fault,
    span,
)
from deeplearning4j_tpu_torch.nn.conf.configuration import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.quantize import QSCALE, mode_of
from deeplearning4j_tpu_torch.util.device import DeviceLike

Model = Union[MultiLayerNetwork, ComputationGraph]

_MANIFEST = "manifest.json"
_REQUIRED = ("configuration.json", "coefficients.npz", "modelState.npz")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed its integrity check."""


def _crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def fsync_dir(path: str) -> None:
    """fsync a directory, so that a rename into it survives a power
    loss (a no-op where the filesystem gives no directory handle)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        elif isinstance(v, torch.Tensor) and v.dtype == torch.float8_e4m3fn:
            # the bytes, as np.savez writes the reference's fp8 arrays
            out[key] = v.detach().cpu().view(torch.uint8).numpy().view("V1")
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _npz_bytes(tree: Dict[str, Any]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **_flatten(tree))
    return buf.getvalue()


def _quantized_tensor(a: np.ndarray, where: str,
                      device: torch.device) -> torch.Tensor:
    """A quantized weight's array as a tensor of its storage dtype: int8,
    or fp8-e4m3 from an ``ml_dtypes`` array (its bytes, reinterpreted)."""
    if a.dtype == np.int8:
        return torch.tensor(a, device=device)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint8)).view(
            torch.float8_e4m3fn).to(device)
    raise TypeError(f"{where}: dtype {a.dtype} is not a quantized weight's "
                    "(int8 or float8_e4m3fn)")


def params_from_numpy(net: Model,
                      tree: Dict[str, Dict[str, np.ndarray]]) -> Model:
    """Load a ``{layer: {name: ndarray}}`` tree (the reference's
    ``net.params`` converted to numpy) into ``net``: every parameter of
    every layer must be present with the shape the net expects, and no
    other key may be, except a quantized weight's ``<name>_qscale``
    (float32, one per output column). Values land on the net's device in
    the dtype of the parameter they replace; a quantized weight keeps its
    int8 or fp8 dtype, and the net is marked quantized."""
    if net.params is None:
        net.init()
    extra = set(tree) - set(net.params)
    if extra:
        raise ValueError(f"unknown layers {sorted(extra)}")
    new: Dict[str, Dict[str, torch.Tensor]] = {}
    modes = set()
    for layer, cur in net.params.items():
        given = tree.get(layer, {})
        quant = {n[:-len(QSCALE)] for n in given if n.endswith(QSCALE)}
        if set(given) != set(cur) | {n + QSCALE for n in quant} \
                or not quant <= set(cur):
            raise ValueError(f"{layer}: parameters {sorted(given)}, "
                             f"expected {sorted(cur)}")
        new[layer] = {}
        for name, t in cur.items():
            a = np.asarray(given[name])
            if a.shape != tuple(t.shape):
                raise ValueError(f"{layer}/{name}: shape {a.shape}, "
                                 f"expected {tuple(t.shape)}")
            if name not in quant:
                new[layer][name] = torch.tensor(a, dtype=t.dtype,
                                                device=net.device)
                continue
            q = _quantized_tensor(a, f"{layer}/{name}", net.device)
            sc = np.asarray(given[name + QSCALE])
            if sc.shape != (a.shape[-1],):
                raise ValueError(f"{layer}/{name}{QSCALE}: shape {sc.shape}, "
                                 f"expected {(a.shape[-1],)}")
            new[layer][name] = q
            new[layer][name + QSCALE] = torch.tensor(
                sc, dtype=torch.float32, device=net.device)
            modes.add(mode_of(q.dtype))
    if len(modes) > 1:
        raise ValueError(f"weights quantized in several modes: {sorted(modes)}")
    net.params = new
    net.quantized = modes.pop() if modes else None
    return net


def _overlay(template: Dict[str, Any], stored: Dict[str, Any],
             device: torch.device, where: str) -> Dict[str, Any]:
    """``stored`` arrays over ``template``'s tree of tensors, in the
    template's dtypes on ``device``: a stored key the template lacks, or a shape that
    differs, raises; a key ``stored`` lacks keeps the template's tensor
    (the reference's ``_merge``)."""
    extra = set(stored) - set(template)
    if extra:
        raise ValueError(f"{where}: unknown keys {sorted(extra)}")
    out: Dict[str, Any] = {}
    for k, t in template.items():
        if k not in stored:
            out[k] = t
        elif isinstance(t, dict):
            out[k] = _overlay(t, stored[k], device, f"{where}/{k}")
        else:
            a = np.asarray(stored[k])
            if a.shape != tuple(t.shape):
                raise ValueError(f"{where}/{k}: shape {a.shape}, expected "
                                 f"{tuple(t.shape)}")
            out[k] = torch.tensor(a, dtype=t.dtype, device=device)
    return out


def opt_state_from_numpy(net: Model,
                         tree: Dict[str, Any]) -> Model:
    """Load ``{"step": int, "updater": {layer: {param: {name: ndarray}}}}``
    (the reference's ``net.opt_state`` converted to numpy, or an
    ``updaterState.npz``) into ``net``. States the tree lacks stay at
    their initial zeros; unknown keys or shapes raise."""
    if net.params is None:
        net.init()
    updater = _overlay(net.opt_state["updater"], tree.get("updater", {}),
                       net.device, "updater")
    net.opt_state = {"step": int(np.asarray(tree["step"])), "updater": updater}
    return net


def states_from_numpy(net: Model,
                      tree: Dict[str, Any]) -> Model:
    """Load ``{layer: {name: ndarray}}`` (the reference's ``net.states``
    converted to numpy, or a ``modelState.npz``: BN's moving ``mean``
    and ``var``) into ``net``. States the tree lacks keep their initial
    values; unknown keys or shapes raise."""
    if net.params is None:
        net.init()
    net.states = _overlay(net.states, tree, net.device, "state")
    return net


def config_payload(model: Model) -> dict:
    """The ``{"model_type", "conf"}`` payload of ``configuration.json``."""
    if isinstance(model, MultiLayerNetwork):
        model_type = "MultiLayerNetwork"
    elif isinstance(model, ComputationGraph):
        model_type = "ComputationGraph"
    else:
        raise TypeError(type(model))
    return {"model_type": model_type, "conf": json.loads(model.conf.to_json())}


def model_from_payload(payload: dict, device: DeviceLike = None) -> Model:
    """An uninitialized model (on ``device``, cuda by default) from a
    ``config_payload`` dict."""
    conf_json = json.dumps(payload["conf"])
    if payload["model_type"] == "MultiLayerNetwork":
        return MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json),
                                 device=device)
    return ComputationGraph(ComputationGraphConfiguration.from_json(conf_json),
                            device=device)


def write_model(model: Model, path: str, save_updater: bool = True) -> None:
    """Write ``model`` as a zip the reference's restore functions load:
    temp file, fsync, rename, fsync of the directory; the write in a
    ``checkpoint`` span (op ``zip_save``)."""
    payload = config_payload(model)
    members: Dict[str, bytes] = {
        "configuration.json": json.dumps(payload, indent=2).encode(),
        "coefficients.npz": _npz_bytes(model.params),
        "modelState.npz": _npz_bytes(model.states),
    }
    if save_updater and model.opt_state is not None:
        members["updaterState.npz"] = _npz_bytes(
            {"step": np.asarray(model.opt_state["step"], np.int32),
             "updater": model.opt_state["updater"]})
    manifest = {"format": 1,
                "crc32": {n: _crc32(b) for n, b in members.items()}}
    path = os.path.abspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with span("checkpoint", op="zip_save", path=path):
        try:
            with open(tmp, "wb") as f:
                with zipfile.ZipFile(f, "w", zipfile.ZIP_DEFLATED) as z:
                    for name, data in members.items():
                        z.writestr(name, data)
                    z.writestr(_MANIFEST, json.dumps(manifest))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    fsync_dir(os.path.dirname(path))


def _verify(z: zipfile.ZipFile, path: str) -> None:
    problems = []
    bad = z.testzip()
    if bad is not None:
        problems.append(f"zip CRC mismatch in member {bad!r}")
    names = set(z.namelist())
    problems += [f"missing member {r!r}" for r in _REQUIRED if r not in names]
    if _MANIFEST in names:
        for name, crc in json.loads(z.read(_MANIFEST)).get("crc32", {}).items():
            if name not in names:
                problems.append(f"manifest lists missing member {name!r}")
            elif _crc32(z.read(name)) != int(crc):
                problems.append(f"manifest CRC mismatch for {name!r}")
    if problems:
        raise CheckpointCorruptError(f"{path}: " + "; ".join(problems))


def _npz_tree(data: bytes) -> Dict[str, Any]:
    """An npz member's tree. A raw-byte array (``|V1``: an fp8 weight as
    ``np.savez`` writes it) raises, as the reference's restore does: its
    dtype is not in the file."""
    with np.load(io.BytesIO(data)) as npz:
        flat = {k: npz[k] for k in npz.files}
    for k, a in flat.items():
        if a.dtype.kind == "V":
            raise TypeError(f"{k}: dtype {a.dtype.str} is not a numeric "
                            "array type (an fp8 weight's bytes; the zip "
                            "does not record its dtype)")
    return _unflatten(flat)


def restore_multi_layer_network(path: str, device: DeviceLike = None,
                                load_updater: bool = True
                                ) -> MultiLayerNetwork:
    """Rebuild a MultiLayerNetwork from a zip written by either package
    (on ``device``, cuda by default), with its updater state when the
    zip has one."""
    return _restore(path, "MultiLayerNetwork", device, load_updater)


def restore_computation_graph(path: str, device: DeviceLike = None,
                              load_updater: bool = True) -> ComputationGraph:
    """Rebuild a ComputationGraph, as ``restore_multi_layer_network``."""
    return _restore(path, "ComputationGraph", device, load_updater)


def restore_model(path: str, device: DeviceLike = None,
                  load_updater: bool = True) -> Model:
    """Rebuild whichever container the zip holds."""
    return _restore(path, None, device, load_updater)


def _restore(path: str, expect: Optional[str], device: DeviceLike,
             load_updater: bool) -> Model:
    try:
        with zipfile.ZipFile(path) as z:
            _verify(z, path)
            payload = json.loads(z.read("configuration.json"))
            params = _npz_tree(z.read("coefficients.npz"))
            states = _npz_tree(z.read("modelState.npz"))
            upd = None
            if load_updater and "updaterState.npz" in z.namelist():
                upd = _npz_tree(z.read("updaterState.npz"))
    except (zipfile.BadZipFile, zlib.error, CheckpointCorruptError) as e:
        get_registry().counter(
            FAULT_CKPT_INTEGRITY_COUNTER,
            "Checkpoint restores that failed the integrity check").inc()
        record_fault("checkpoint")
        if isinstance(e, CheckpointCorruptError):
            raise
        raise CheckpointCorruptError(f"{path}: unreadable checkpoint ({e})")
    if expect and payload["model_type"] != expect:
        raise ValueError(f"checkpoint is a {payload['model_type']}, "
                         f"expected {expect}")
    net = params_from_numpy(model_from_payload(payload, device).init(), params)
    states_from_numpy(net, states)
    return net if upd is None else opt_state_from_numpy(net, upd)
