"""Training hyperparameters — counterpart of ``deblurgs_tpu/train/config.py``
(reference ``OptimizationParams``, ``arguments/__init__.py:90-123``): the
same fields and defaults."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    iterations: int = 150_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    noise_init: float = 0.0
    noise_final: float = 0.0
    lambda_t_smooth_init: float = 1e-3
    lambda_t_smooth_final: float = 1e-5
    lambda_depth_tv: float = 0.0
    lambda_hinge: float = 0.1

    densification_interval: int = 200
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 75_000
    densify_grad_threshold_init: float = 4e-4
    densify_grad_threshold_final: float = 2e-4
    densify_annealing_until: int = 25_000
    clip_grad: float = -1.0

    curve_controlpoints_lr: float = 1e-2
    curve_rotation_lr: float = 1e-3
    curve_alignment_lr: float = 0.0
    curve_alignment_start: int = 30_000
    curve_lr_half_iter: int = 15_000
    curve_start_iter: int = 1000
    curve_end_iter: int = 100_000
    random_sample_until: int = 100_000
    drop_alignment: float = 1.0
