"""Post-training weight quantization for serving, and its accuracy gate.

Counterpart of ``deeplearning4j_tpu/nn/quantize.py``:

- :func:`quantize` returns a NEW net (same configuration, same layer
  names) whose Dense / Embedding / TransformerBlock projection matrices
  are int8 (or fp8-e4m3) with float32 per-output-channel scales under
  ``<name>_qscale`` keys. Biases, LayerNorm affines, positions and the
  3-D MoE experts stay float32. Quantized nets serve only: ``fit``
  refuses them.
- :func:`qmatmul` / :func:`qtake` are the dequant inside the op:
  ``(x @ q.to(x.dtype)) * scale`` and ``q[ids].to(dt) * scale``. The
  scale is a post-multiply in the output dtype, never folded into the
  weight (``x @ (q * s)`` rounds differently). int8 and e4m3 values are
  exact in bf16, so the product is the reference's. An unquantized
  weight takes the plain product or gather, unchanged.
- :func:`accuracy_gate` scores a quantized net against the float one on
  a seeded workload: teacher-forced greedy match rate, logit MSE and the
  relative next-token cross-entropy change, with thresholds;
  :func:`make_quality_gate` wraps it as a deploy-time gate.
- :func:`kv_quantize` / :func:`kv_dequantize` are the quantized paged KV
  pool's scatter and gather (``nn/kvpool.py``): one float32 scale per
  (position, head) over head_dim, so a re-prefill stores the same bytes
  as the incremental decode writes it replays.

Metrics, the reference's: ``dl4j_quant_models{dtype}`` counts the nets
:func:`quantize` made in this process, ``dl4j_quant_scale_absmax{layer,
param}`` is each quantized matrix's largest scale (set from the card's
value without waiting on it: the registry reads it when read),
``dl4j_quant_accuracy_gate_outcome_total{outcome}`` counts the gate's
verdicts.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.monitor import (
    QUANT_GATE_OUTCOME_COUNTER,
    QUANT_MODELS_GAUGE,
    QUANT_SCALE_ABSMAX_GAUGE,
    get_registry,
)

#: params-dict suffix marking a weight as quantized: ``params["W"]`` is
#: the int8/fp8 tensor and ``params["W" + QSCALE]`` its float32
#: per-output-channel scale vector
QSCALE = "_qscale"

#: storage mode -> (storage dtype, quantization max): int8 is symmetric
#: round-to-nearest-even at +-127, fp8 the e4m3 grid (max normal 448)
_MODES: Dict[str, Tuple[torch.dtype, float]] = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}


def quant_modes() -> Tuple[str, ...]:
    return tuple(sorted(_MODES))


def mode_of(dtype: torch.dtype) -> str:
    """The quantization mode whose storage dtype is ``dtype``."""
    for mode, (storage, _) in _MODES.items():
        if storage == dtype:
            return mode
    raise ValueError(f"not a quantized storage dtype: {dtype}")


def is_quantized(params: Dict[str, Any], name: str) -> bool:
    return (name + QSCALE) in params


def qmatmul(x: torch.Tensor, params: Dict[str, Any], name: str) -> torch.Tensor:
    """``x @ params[name]``, the weight taken to x's dtype; a quantized
    weight's per-output-channel scale multiplies the product after."""
    y = x @ params[name].to(x.dtype)
    sc = params.get(name + QSCALE)
    if sc is None:
        return y
    return y * sc.to(y.dtype)


def qtake(params: Dict[str, Any], name: str, idx: torch.Tensor,
          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Embedding gather; a quantized table's rows are taken in storage
    precision, then scaled per output channel in ``out_dtype`` (the
    scale's dtype by default)."""
    z = params[name][idx]
    sc = params.get(name + QSCALE)
    if sc is None:
        return z
    dt = out_dtype if out_dtype is not None else sc.dtype
    return z.to(dt) * sc.to(dt)


def quantize_array(w, mode: str = "int8") -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel quantization of one ``[in, out]`` matrix (or
    ``[vocab, d]`` embedding): scale[j] = amax(|w[:, j]|) / qmax.
    Returns (q, scale f32)."""
    if mode not in _MODES:
        raise ValueError(f"unknown quantization dtype {mode!r}; pick "
                         f"from {quant_modes()}")
    storage, qmax = _MODES[mode]
    wf = torch.as_tensor(w).float()
    if wf.ndim != 2:
        raise ValueError(f"per-channel quantization needs a 2-D matrix, "
                         f"got shape {tuple(wf.shape)}")
    amax = wf.abs().amax(dim=0)
    # a tensor divisor: the card divides by a Python scalar as a product
    # with its reciprocal, which can round the scale differently
    sc = torch.clamp(amax / torch.full_like(amax, qmax), min=1e-12)
    if storage == torch.int8:
        q = torch.clamp(torch.round(wf / sc), -qmax, qmax).to(torch.int8)
    else:
        q = (wf / sc).to(storage)
    return q, sc


def dequantize_array(q: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`quantize_array` (a test oracle)."""
    return q.float() * sc.float()


# ----------------------------------------------------- KV-pool primitive


def kv_qparams(mode: str) -> Tuple[torch.dtype, float]:
    """(storage dtype, qmax) of a quantized KV pool mode."""
    if mode not in _MODES:
        raise ValueError(f"unknown KV quantization mode {mode!r}; pick "
                         f"from {quant_modes()}")
    return _MODES[mode]


def kv_qmax(storage_dtype: torch.dtype) -> float:
    """Quantization max of a KV storage dtype (the pool tensors' dtype
    is the mode)."""
    for storage, qmax in _MODES.values():
        if storage == storage_dtype:
            return qmax
    raise ValueError(f"not a quantized KV storage dtype: {storage_dtype}")


def kv_quantize(x: torch.Tensor, storage_dtype: torch.dtype,
                qmax: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` [..., h, hd] -> (q [..., h, hd] in ``storage_dtype``, scale
    [..., h] f32): scale = max(amax over hd * (1 / qmax), 1e-12), int8
    rounds half to even and clips at +-qmax, fp8 saturates at +-qmax.
    The floor keeps zero positions exactly zero after the dequant. The
    reference runs this only inside compiled programs, where XLA turns
    its division by the constant qmax into a product with the float32
    reciprocal; the scale here is that product, so the stored scales
    are the reference's bit for bit."""
    if qmax is None:
        qmax = kv_qmax(storage_dtype)
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    sc = torch.clamp(amax * torch.tensor(1.0 / qmax, dtype=torch.float32),
                     min=1e-12)
    scaled = torch.clamp(xf / sc[..., None], -qmax, qmax)
    if storage_dtype == torch.int8:
        q = torch.round(scaled).to(torch.int8)
    else:
        q = scaled.to(storage_dtype)
    return q, sc


def kv_dequantize(q: torch.Tensor, sc: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Gathered ``q`` [..., h, hd] and ``sc`` [..., h] back to the compute
    dtype: both operands cast to ``dtype`` before the product."""
    return q.to(dtype) * sc[..., None].to(dtype)


# ------------------------------------------------------- the net pass

#: which parameters quantize, per impl family: the 3-D MoE experts and
#: the LSTM recurrences stay float
_DENSE_NAMES = ("W",)
_TRANSFORMER_NAMES = ("Wqkv", "Wo", "W1", "W2")
_EMBED_NAMES = ("W",)


def _quant_targets(impl) -> Tuple[str, ...]:
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (
        BaseDenseImpl,
        EmbeddingImpl,
    )
    from deeplearning4j_tpu_torch.nn.layers.transformer import (
        SequenceEmbeddingImpl,
        TransformerBlockImpl,
    )
    if isinstance(impl, TransformerBlockImpl):
        return _TRANSFORMER_NAMES
    if isinstance(impl, (SequenceEmbeddingImpl, EmbeddingImpl)):
        return _EMBED_NAMES
    if isinstance(impl, BaseDenseImpl):
        return _DENSE_NAMES
    return ()


def _iter_impls(net) -> List[Any]:
    impls = net.impls
    if isinstance(impls, dict):
        return list(impls.values())
    return list(impls)


#: nets quantize() made in this process, per storage mode
_quantized_nets: Dict[str, int] = {}


def quantized_param_bytes(params: Dict[str, Dict[str, torch.Tensor]]) -> int:
    """The byte footprint of a params tree."""
    return sum(t.numel() * t.element_size()
               for p in params.values() for t in p.values())


def quantize(net, dtype: str = "int8"):
    """Post-training quantization: a NEW net of the same configuration,
    layer names and device whose Dense / Embedding / TransformerBlock
    projection weights are stored in ``dtype`` (``"int8"`` or ``"fp8"``)
    with float32 per-output-channel scales; every other parameter stays
    as it is. The result serves through every path of a float net but
    is inference-only (``net.quantized`` is set and ``fit`` refuses
    it)."""
    if dtype not in _MODES:
        raise ValueError(f"unknown quantization dtype {dtype!r}; pick "
                         f"from {quant_modes()}")
    if net.params is None:
        raise ValueError("quantize() needs an initialized net (params)")
    if getattr(net, "quantized", None) is not None:
        raise ValueError(
            f"net is already quantized ({net.quantized}); re-quantizing "
            "quantized weights compounds the error: quantize the fp32 "
            "original")
    clone = type(net)(net.conf, device=net.device)
    clone.init(dtype=net._dtype)
    reg = get_registry()
    by_name = {impl.name: impl for impl in _iter_impls(clone)}
    new_params: Dict[str, Dict[str, Any]] = {}
    for lname, p in net.params.items():
        impl = by_name.get(lname)
        targets = _quant_targets(impl) if impl is not None else ()
        q: Dict[str, Any] = {}
        for pname, v in p.items():
            if pname in targets and v.ndim == 2:
                q[pname], q[pname + QSCALE] = quantize_array(v, dtype)
                reg.gauge(
                    QUANT_SCALE_ABSMAX_GAUGE,
                    "Largest per-output-channel dequant scale per "
                    "quantized weight matrix",
                    layer=lname, param=pname).set(q[pname + QSCALE].max())
            else:
                q[pname] = v
        new_params[lname] = q
    clone.params = new_params
    clone.states = {k: dict(v) if isinstance(v, dict) else v
                    for k, v in net.states.items()}
    clone.quantized = dtype
    _quantized_nets[dtype] = _quantized_nets.get(dtype, 0) + 1
    reg.gauge(QUANT_MODELS_GAUGE,
              "Quantized nets produced by quantize() in this process",
              dtype=dtype).set(float(_quantized_nets[dtype]))
    return clone


# -------------------------------------------------- accuracy-delta gate


@torch.no_grad()
def _sequence_logits(net, ids: np.ndarray) -> np.ndarray:
    """Teacher-forced next-token logits [b, t, V] (f32) from one causal
    forward: both nets see the same context at every position, so one
    token flip never compounds into a diverged rollout."""
    from deeplearning4j_tpu_torch.nn.generate import (
        TransformerGenerator,
        build_generator,
    )
    from deeplearning4j_tpu_torch.util.dtypes import cast_floats

    gen = build_generator(net)
    if not isinstance(gen, TransformerGenerator):
        raise ValueError("accuracy_gate scores transformer stacks; got "
                         f"{type(gen).__name__}")
    cd = net._cd
    cast = (lambda p: cast_floats(p, cd)) if cd is not None else (lambda p: p)
    params = net.params
    x = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=net.device)
    x, _ = gen.emb.forward(cast(params[gen.emb.name]), x, {}, False)
    for blk in gen.blocks:
        x, _ = blk.forward(cast(params[blk.name]), x,
                           blk.init_state(net.device), False)
    if hasattr(gen.head, "preout"):
        x = gen.head.preout(cast(params[gen.head.name]), x)
    return x.float().cpu().numpy()


def _xent(logits: np.ndarray, targets: np.ndarray) -> float:
    """Mean next-token cross-entropy of [b, t, V] logits against the
    [b, t] targets shifted by one (positions 0..t-2 predict 1..t-1)."""
    lg = logits[:, :-1].astype(np.float64)
    tg = targets[:, 1:]
    m = lg.max(axis=-1, keepdims=True)
    lse = m[..., 0] + np.log(np.exp(lg - m).sum(axis=-1))
    picked = np.take_along_axis(lg, tg[..., None], axis=-1)[..., 0]
    return float(np.mean(lse - picked))


def gate_workload(vocab: int, rows: int = 8, length: int = 24,
                  seed: int = 0) -> np.ndarray:
    """The fixed seeded token workload the gate scores on."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, (rows, length)).astype(np.int32)


def accuracy_gate(ref_net, cand_net, ids: Optional[np.ndarray] = None, *,
                  rows: int = 8, length: int = 24, seed: int = 0,
                  min_greedy_match: float = 0.995,
                  max_eval_delta: float = 0.005,
                  max_logit_mse: Optional[float] = None) -> Dict[str, Any]:
    """Score ``cand_net`` against ``ref_net`` on a fixed seeded workload
    (or explicit ``ids`` [b, t]) and apply the thresholds. Returns
    ``{"passed", "greedy_match_rate", "logit_mse", "eval_metric",
    "eval_metric_ref", "eval_metric_delta", "positions", "thresholds"}``:
    the share of teacher-forced positions where both nets' argmax
    agrees, the mean squared logit difference, and the relative change
    of the next-token cross-entropy."""
    if ids is None:
        vocab = int(_iter_impls(ref_net)[0].conf.n_in)
        ids = gate_workload(vocab, rows=rows, length=length, seed=seed)
    ids = np.asarray(ids, np.int32)
    lr = _sequence_logits(ref_net, ids)
    lq = _sequence_logits(cand_net, ids)
    match = float(np.mean(np.argmax(lr, -1) == np.argmax(lq, -1)))
    mse = float(np.mean((lr - lq) ** 2))
    xr = _xent(lr, ids)
    xq = _xent(lq, ids)
    delta = abs(xq - xr) / max(abs(xr), 1e-9)
    passed = match >= min_greedy_match and delta <= max_eval_delta
    if max_logit_mse is not None:
        passed = passed and mse <= max_logit_mse
    get_registry().counter(
        QUANT_GATE_OUTCOME_COUNTER,
        "Quantization accuracy-gate verdicts by outcome",
        outcome="pass" if passed else "fail").inc()
    return {
        "passed": bool(passed),
        "greedy_match_rate": round(match, 6),
        "logit_mse": mse,
        "eval_metric": round(xq, 6),
        "eval_metric_ref": round(xr, 6),
        "eval_metric_delta": round(delta, 6),
        "positions": int(lr.shape[0] * lr.shape[1]),
        "thresholds": {"min_greedy_match": min_greedy_match,
                       "max_eval_delta": max_eval_delta,
                       "max_logit_mse": max_logit_mse},
    }


def make_quality_gate(ids: Optional[np.ndarray] = None, *,
                      rows: int = 8, length: int = 24, seed: int = 0,
                      min_greedy_match: float = 0.995,
                      max_eval_delta: float = 0.005,
                      max_logit_mse: Optional[float] = None):
    """A deploy-time gate ``(stable_net_or_None, candidate_net) ->``
    :func:`accuracy_gate`'s verdict; with no stable net to compare
    against, the candidate passes."""
    def gate(stable_net, cand_net) -> Dict[str, Any]:
        if stable_net is None:
            return {"passed": True, "greedy_match_rate": 1.0,
                    "logit_mse": 0.0, "eval_metric_delta": 0.0,
                    "skipped": "no stable version to compare against"}
        return accuracy_gate(
            stable_net, cand_net, ids, rows=rows, length=length,
            seed=seed, min_greedy_match=min_greedy_match,
            max_eval_delta=max_eval_delta, max_logit_mse=max_logit_mse)
    return gate
