"""Hand-written Adam with per-leaf learning rates, masks and slot surgery.

Counterpart of ``deblurgs_tpu/train/optim.py``: ``torch.optim.Adam``
semantics (bias correction by a per-leaf step count, in float32;
``eps=1e-15`` as the reference), plus what densification needs under
static capacity: per-row update masks, scalar leaf gates (a gated-off leaf
skips its moments and step count too, as torch skips a parameter whose
grad is None), and :func:`zero_moment_rows`. ``torch.optim.Adam`` keeps
one step count per parameter and has no row masks, so the update is
written out here. Parameters and states are NamedTuples of tensors (one
leaf per field), updated functionally.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    mu: NamedTuple    # first moments, like params
    nu: NamedTuple    # second moments, like params
    step: NamedTuple  # per-leaf int32 step counts (0-d tensors)


def init(params: NamedTuple) -> AdamState:
    zeros = type(params)(*(torch.zeros_like(p) for p in params))
    return AdamState(
        mu=zeros, nu=type(params)(*(torch.zeros_like(p) for p in params)),
        step=type(params)(*(torch.zeros((), dtype=torch.int32, device=p.device)
                            for p in params)))


def _as_bool(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.bool, device=device)


def update(params: NamedTuple, grads: NamedTuple, state: AdamState, lr: NamedTuple, *,
           b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15,
           update_mask: NamedTuple | None = None,
           leaf_gate: NamedTuple | None = None) -> tuple[NamedTuple, AdamState]:
    """One Adam step (torch.optim.Adam semantics); returns (params, state).

    ``lr``: one scalar per leaf. ``update_mask``: per leaf None (update
    all), a scalar bool (the whole leaf; off also skips its moments and
    step count), or a [P] bool row mask (other rows keep params and
    moments). ``leaf_gate``: per leaf a scalar bool ANDed into the leaf's
    gate on top of a row mask (``optim.py:34-60`` of the JAX package).
    """
    n = len(params)
    masks = update_mask if update_mask is not None else (None,) * n
    gates = leaf_gate if leaf_gate is not None else (None,) * n
    new_p, new_mu, new_nu, new_st = [], [], [], []
    for p, g, mu, nu, st, lr_i, m, gate in zip(params, grads, state.mu, state.nu,
                                               state.step, lr, masks, gates):
        row_mask = None
        leaf_on = _as_bool(True, p.device)
        if m is not None:
            m = _as_bool(m, p.device)
            if m.dim() == 0:
                leaf_on = m
            else:
                row_mask = m.reshape(m.shape + (1,) * (p.dim() - m.dim()))
        if gate is not None:
            leaf_on = leaf_on & _as_bool(gate, p.device)

        st2 = st + leaf_on.to(torch.int32)
        t = torch.clamp(st2, min=1).to(torch.float32)
        mu2 = b1 * mu + (1 - b1) * g
        nu2 = b2 * nu + (1 - b2) * (g * g)
        mu_hat = mu2 / (1 - b1**t)
        nu_hat = nu2 / (1 - b2**t)
        upd = torch.as_tensor(lr_i, dtype=p.dtype, device=p.device) * mu_hat / (
            torch.sqrt(nu_hat) + eps)
        if row_mask is not None:
            mu2 = torch.where(row_mask, mu2, mu)
            nu2 = torch.where(row_mask, nu2, nu)
            upd = torch.where(row_mask, upd, 0.0)
        mu2 = torch.where(leaf_on, mu2, mu)
        nu2 = torch.where(leaf_on, nu2, nu)
        upd = torch.where(leaf_on, upd, 0.0)
        new_p.append(p - upd)
        new_mu.append(mu2)
        new_nu.append(nu2)
        new_st.append(st2)
    kind = type(params)
    return kind(*new_p), AdamState(mu=kind(*new_mu), nu=kind(*new_nu), step=kind(*new_st))


def zero_moment_rows(state: AdamState, params_like_mask: NamedTuple) -> AdamState:
    """Zero mu/nu rows where the [P] bool mask of each leaf is True
    (densification slot surgery)."""

    def z(moments):
        out = []
        for moment, mask in zip(moments, params_like_mask):
            m = mask.reshape(mask.shape + (1,) * (moment.dim() - mask.dim()))
            out.append(torch.where(m, 0.0, moment))
        return type(moments)(*out)

    return state._replace(mu=z(state.mu), nu=z(state.nu))
