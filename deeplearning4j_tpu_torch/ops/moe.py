"""Mixture-of-experts FFN with top-1 (Switch-style) routing.

Counterpart of ``deeplearning4j_tpu/ops/moe.py``: the router, the
capacity, the ``valid`` mask and the load-balancing aux loss are the
reference's. The reference writes dispatch and combine as dense one-hot
``[n, E, C]`` einsums; here the same function is computed by index:
each expert's kept tokens are gathered into ``[E, C, d]``, the two
expert products run as batched matmuls, and each token reads its slot
back, times its gate. Every ``[e, c]`` slot holds one token or none, so
each sum of the reference's einsums has a single nonzero term and the
index form gives the same values. Overflowed and masked tokens get zero
output.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def top1_route(gate_logits: torch.Tensor, capacity: int,
               valid: Optional[torch.Tensor] = None,
               expert: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """gate_logits [n, E] -> (slot [n] int64, gate [n] f32, aux_loss):
    ``slot`` is ``expert * capacity + queue position`` for a kept token
    and ``E * capacity`` for an overflowed or masked one (the zero row of
    the gathers); ``gate`` is the chosen expert's router probability.

    Each token's expert is the router's argmax (the first maximum), or
    ``expert`` [n] where given; a token's queue position is the cumsum
    over tokens in order. ``valid`` [n] (optional): masked tokens are
    routed nowhere, take no slot and are left out of the aux loss, the
    Switch load-balancing loss E * sum_e f_e * p_e (fraction routed
    times mean router probability)."""
    n, e = gate_logits.shape
    probs = torch.softmax(gate_logits.float(), dim=-1)
    if expert is None:
        expert = probs.argmax(dim=-1)                        # [n]
    onehot = F.one_hot(expert, e).float()                    # [n, E]
    if valid is not None:
        v = valid.float()
        onehot = onehot * v[:, None]
        n_valid = torch.clamp(v.sum(), min=1.0)
        weighted = probs * v[:, None]
    else:
        n_valid = float(n)
        weighted = probs
    # position of each token within its expert's queue (-1: not routed);
    # the cumsum runs along the inner dimension of [E, n], a fast scan
    # on the card where one along the outer dimension of [n, E] is not
    queue = onehot.t().contiguous()
    pos = (torch.cumsum(queue, dim=1) * queue - 1.0).gather(
        0, expert[None, :])[0]
    keep = (pos >= 0) & (pos < capacity)
    slot = torch.where(keep, expert * capacity + pos.long(),
                       torch.full_like(expert, e * capacity))
    gate = torch.sum(probs * onehot, dim=-1)                 # [n]
    frac_routed = onehot.sum(dim=0) / n_valid
    mean_prob = weighted.sum(dim=0) / n_valid
    aux_loss = e * torch.sum(frac_routed * mean_prob)
    return slot, gate, aux_loss


def moe_ffn(x: torch.Tensor, Wg, W1, b1, W2, b2,
            capacity_factor: float = 1.25,
            valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [n, d] -> ([n, d], aux_loss). Expert weights: W1 [E, d, f],
    b1 [E, f], W2 [E, f, d], b2 [E, d]; router Wg [d, E]. The router
    runs in f32, the experts in x's dtype, and the gate is cast to x's
    dtype before it scales the expert output, as the reference's
    ``combine.astype(x.dtype)``."""
    n, d = x.shape
    e = W1.shape[0]
    capacity = max(1, int(capacity_factor * n / e))
    slot, gate, aux = top1_route(x.float() @ Wg.float(), capacity, valid)
    # the token in each [e, c] slot (n: none, the zero row appended)
    token = torch.full((e * capacity + 1,), n, dtype=torch.long,
                       device=x.device)
    token[slot] = torch.arange(n, device=x.device)
    # index_select, whose gradient is an index_add: every row it gathers
    # but the zero row is gathered once
    xe = F.pad(x, (0, 0, 0, 1)).index_select(0, token[:-1]).view(e, capacity, d)
    dt = x.dtype
    h = F.gelu(torch.bmm(xe, W1.to(dt)) + b1.to(dt)[:, None, :],
               approximate="tanh")
    ye = torch.bmm(h, W2.to(dt)) + b2.to(dt)[:, None, :]    # [E, C, d]
    y = F.pad(ye.reshape(e * capacity, d), (0, 0, 0, 1)).index_select(0, slot)
    return y * gate.to(dt)[:, None], aux
