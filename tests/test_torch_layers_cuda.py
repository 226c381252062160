"""The layer library's new modules on the card against the CPU (marked
``cuda``: they skip where ``torch.cuda.is_available()`` is false).

f32 throughout, TF32 off: ``moe_ffn``'s output and gradients (routing
equal, then values within 1e-5 relative to the largest magnitude),
``quantize_array`` bit for bit, a quantized ``gpt``'s logits within
1e-5, and one AutoEncoder and one RBM pretraining step with the same
uniforms within 1e-5. The full-width paths run in ``chip_smoke.py``
phase 10.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.nn.layers.feedforward as tff
from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
from deeplearning4j_tpu_torch.nn import quantize as tq
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.base import build_layer
from deeplearning4j_tpu_torch.ops import moe
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _close(got, want, tol=TOL):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) / scale <= tol


def _arrays(seed, n=256, d=32, f=64, e=4):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s) * sc, dtype=torch.float32)
            for s, sc in (((n, d), 1.0), ((d, e), 1.0), ((e, d, f), 0.2),
                          ((e, f), 0.1), ((e, f, d), 0.2), ((e, d), 0.1))]


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_moe_ffn_on_card_matches_cpu(cuda_device, cf):
    cpu = [a.requires_grad_() for a in _arrays(int(cf * 4))]
    card = [a.detach().to(cuda_device).requires_grad_() for a in cpu]
    r = torch.randn(cpu[0].shape, generator=torch.Generator().manual_seed(1))
    slots = []
    for ts in (cpu, card):
        logits = ts[0].detach().float() @ ts[1].detach().float()
        slots.append(moe.top1_route(logits, max(1, int(cf * 256 / 4)))[0].cpu())
        y, aux = moe.moe_ffn(*ts, capacity_factor=cf)
        ((y * r.to(y.device)).sum() + aux).backward()
        ts.append(y)
    assert torch.equal(slots[0], slots[1])
    _close(card[-1], cpu[-1])
    for a, b in zip(card[:6], cpu[:6]):
        _close(a.grad, b.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_on_card_matches_cpu(cuda_device, mode):
    w = torch.randn(64, 48, generator=torch.Generator().manual_seed(2))
    q_cpu, s_cpu = tq.quantize_array(w, mode)
    q_card, s_card = tq.quantize_array(w.to(cuda_device), mode)
    assert torch.equal(q_card.cpu().view(torch.uint8), q_cpu.view(torch.uint8))
    assert torch.equal(s_card.cpu(), s_cpu)
    size = dict(vocab_size=64, d_model=32, n_layers=2, num_heads=4, max_len=64,
                compute_dtype="float32", seed=3)
    cpu = gpt(device="cpu", **size).init()
    card = gpt(device=cuda_device, **size).init()
    params_from_numpy(card, {l: {n: t.numpy() for n, t in p.items()}
                             for l, p in cpu.params.items()})
    nets = [tq.quantize(net, mode) for net in (cpu, card)]
    ids = np.random.default_rng(4).integers(1, 64, (2, 16))
    _close(torch.as_tensor(tq._sequence_logits(nets[1], ids)),
           torch.as_tensor(tq._sequence_logits(nets[0], ids)))


@pytest.mark.cuda
@pytest.mark.parametrize("conf", [
    L.AutoEncoder(n_in=24, n_out=12, corruption_level=0.3, sparsity=0.05),
    L.RBM(n_in=24, n_out=12, k=2, loss_function="xent")])
def test_pretrain_step_on_card_matches_cpu(cuda_device, conf, monkeypatch):
    gc = NeuralNetConfiguration(seed=5, activation="sigmoid", weight_init="xavier")
    impl = build_layer(gc, conf, "l")
    p_cpu = impl.init_params(torch.Generator().manual_seed(6), "cpu")
    x = torch.rand(32, 24, generator=torch.Generator().manual_seed(7))
    u = torch.rand(32, 24, generator=torch.Generator().manual_seed(8))
    monkeypatch.setattr(tff, "uniform_draw",
                        lambda key, shape, device: u[:, :shape[1]].to(device))
    out = []
    for dev in ("cpu", cuda_device):
        p = {k: v.to(dev) for k, v in p_cpu.items()}
        if hasattr(impl, "cd_gradients"):
            g, loss = impl.cd_gradients(p, x.to(dev), 9)
        else:
            leaves = {k: v.requires_grad_() for k, v in p.items()}
            loss = impl.pretrain_loss(leaves, x.to(dev), 9)
            g = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        out.append((g, loss))
    (g_cpu, l_cpu), (g_card, l_card) = out
    _close(l_card, l_cpu)
    for k in g_cpu:
        _close(g_card[k], g_cpu[k])
