"""Model zip: config JSON + parameters, the reference's format.

Counterpart of ``deeplearning4j_tpu/util/model_serializer.py``, read and
written with ``zipfile`` and numpy only:

- ``configuration.json``: ``{"model_type", "conf"}``;
- ``coefficients.npz``: one array per ``layerN/name`` key;
- ``modelState.npz``: non-trainable state (empty for the GPT and
  char-RNN stacks: an LSTM's carries live outside the saved state);
- ``updaterState.npz``: the step counter ``step`` (int32) and the
  updater state, one array per ``updater/layerN/param/name`` key
  (``m``/``v`` for Adam), so training resumes where it stopped;
- ``manifest.json``: a CRC32 per member, checked on restore.

A zip written by either package restores in the other, updater state
included. Quantized weights (``*_qscale`` keys) are not ported yet.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
import zlib
from typing import Any, Dict

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.configuration import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.device import DeviceLike

_MANIFEST = "manifest.json"
_REQUIRED = ("configuration.json", "coefficients.npz", "modelState.npz")
_QSCALE = "_qscale"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed its integrity check."""


def _crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
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


def params_from_numpy(net: MultiLayerNetwork,
                      tree: Dict[str, Dict[str, np.ndarray]]) -> MultiLayerNetwork:
    """Load a ``{layer: {name: ndarray}}`` tree (the reference's
    ``net.params`` converted to numpy) into ``net``: every parameter of
    every layer must be present with the shape the net expects, and no
    other key may be. Values land as float32 on the net's device."""
    if net.params is None:
        net.init()
    extra = set(tree) - set(net.params)
    if extra:
        raise ValueError(f"unknown layers {sorted(extra)}")
    new: Dict[str, Dict[str, torch.Tensor]] = {}
    for layer, cur in net.params.items():
        given = tree.get(layer, {})
        names = set(given)
        if any(n.endswith(_QSCALE) for n in names):
            raise NotImplementedError(
                f"{layer}: quantized weights are not ported yet")
        if names != set(cur):
            raise ValueError(f"{layer}: parameters {sorted(names)}, "
                             f"expected {sorted(cur)}")
        new[layer] = {}
        for name, t in cur.items():
            a = np.asarray(given[name])
            if a.shape != tuple(t.shape):
                raise ValueError(f"{layer}/{name}: shape {a.shape}, "
                                 f"expected {tuple(t.shape)}")
            new[layer][name] = torch.as_tensor(
                a.astype(np.float32), device=net.device).contiguous()
    net.params = new
    return net


def _overlay(template: Dict[str, Any], stored: Dict[str, Any],
             device: torch.device, where: str) -> Dict[str, Any]:
    """``stored`` arrays over ``template``'s tree of tensors, as float32
    on ``device``: a stored key the template lacks, or a shape that
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
            out[k] = torch.as_tensor(a.astype(np.float32), device=device).contiguous()
    return out


def opt_state_from_numpy(net: MultiLayerNetwork,
                         tree: Dict[str, Any]) -> MultiLayerNetwork:
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


def write_model(model: MultiLayerNetwork, path: str,
                save_updater: bool = True) -> None:
    """Write ``model`` as a zip the reference's
    ``restore_multi_layer_network`` loads: temp file, fsync, rename."""
    payload = {"model_type": "MultiLayerNetwork",
               "conf": json.loads(model.conf.to_json())}
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
    with np.load(io.BytesIO(data)) as npz:
        return _unflatten({k: npz[k] for k in npz.files})


def restore_multi_layer_network(path: str, device: DeviceLike = None,
                                load_updater: bool = True
                                ) -> MultiLayerNetwork:
    """Rebuild a net from a zip written by either package (on ``device``,
    cuda by default), with its updater state when the zip has one."""
    try:
        with zipfile.ZipFile(path) as z:
            _verify(z, path)
            payload = json.loads(z.read("configuration.json"))
            params = _npz_tree(z.read("coefficients.npz"))
            states = _npz_tree(z.read("modelState.npz"))
            upd = None
            if load_updater and "updaterState.npz" in z.namelist():
                upd = _npz_tree(z.read("updaterState.npz"))
    except (zipfile.BadZipFile, zlib.error) as e:
        raise CheckpointCorruptError(f"{path}: unreadable checkpoint ({e})")
    if payload["model_type"] != "MultiLayerNetwork":
        raise ValueError(f"checkpoint is a {payload['model_type']}, "
                         "expected MultiLayerNetwork")
    conf = MultiLayerConfiguration.from_json(json.dumps(payload["conf"]))
    net = params_from_numpy(MultiLayerNetwork(conf, device=device).init(), params)
    net.states = _overlay(net.states, states, net.device, "state")
    return net if upd is None else opt_state_from_numpy(net, upd)
