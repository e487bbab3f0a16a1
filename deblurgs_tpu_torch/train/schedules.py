"""Learning-rate / hyperparameter schedules, indexed by step.

Counterpart of ``deblurgs_tpu/train/schedules.py`` (reference
``get_expon_lr_func``, ``get_scheduler`` and the curve half-life LR). Each
returns a float32 0-d CPU tensor computed in float32 as the JAX package
does; ``step`` is an int or a tensor.
"""

from __future__ import annotations

import torch

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             max_steps: int = 1_000_000) -> torch.Tensor:
    """DeblurGS log-lerp schedule (reference ``general_utils.py:31-71``)."""
    step = _f32(step) - lr_delay_steps
    ms = float(max_steps - lr_delay_steps)
    if lr_init <= 0.0:
        return torch.zeros((), dtype=_F32)
    if lr_init <= lr_final:
        return _f32(lr_init)
    lf = lr_final if lr_final > 0.0 else 1e-6
    t = torch.clamp(step / ms, 0.0, 1.0)
    log_lerp = torch.exp(torch.log(_f32(lr_init)) * (1 - t) + torch.log(_f32(lf)) * t)
    return torch.where(step < 0, _f32(lr_init), torch.where(step > ms, _f32(lf), log_lerp))


def warmup_exp_decay(step, lr_init: float, lr_final: float, step_warmup: int,
                     step_final: int) -> torch.Tensor:
    """Alignment-LR schedule (reference ``general_utils.py:73-101`` with
    warmup_ratio=0): 0 until warmup, then exponential decay to lr_final."""
    step = _f32(step)
    if lr_init <= 1e-8:
        return torch.zeros((), dtype=_F32)
    decay_rate = torch.log(_f32(lr_final / lr_init)) / max(step_final - step_warmup, 1)
    lr = lr_init * torch.exp(decay_rate * (step - step_warmup))
    return torch.where(step <= step_warmup, _f32(0.0),
                       torch.where(step <= step_final, lr, _f32(lr_final)))


def curve_half_life_lr(step, lr_init: float, start_iter: int, half_iter: int) -> torch.Tensor:
    """Curve control-point LR: halves every ``half_iter`` steps once the
    curve starts optimizing (reference ``gaussian_model.py:202-203``)."""
    n = torch.clamp(_f32(step) - start_iter + 1.0, min=0.0)
    return lr_init * torch.pow(_f32(0.5), n / half_iter)
