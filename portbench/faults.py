"""Faults a training cell can have, planted in the program underneath the
loop, for the checks that ``correct`` must catch them (the tests, and
``portbench/limits_sweep.py`` at the cells' own size): a step that returns
its state unchanged, half of the batch left out with the mean taken over
the rest (the blur's mean over half of the sub-frames), an answer altered
where it is produced (the rendered image, 1% brighter), and a densify event
that adds and prunes nothing (its statistics restarted all the same)."""

from __future__ import annotations

import contextlib
import importlib

import torch


def _unchanged(real):
    def step(state, *args, **kwargs):
        new, metrics = real(state, *args, **kwargs)
        return state._replace(step=new.step), metrics
    return step


def _half_batch(real):
    def render(*args, **kwargs):
        images, *rest = real(*args, **kwargs)
        h = images.shape[0] // 2
        return (torch.cat([images[:h], images[:h], images[2 * h:]]), *rest)
    return render


def _altered(real):
    def compose(*args, **kwargs):
        image, *rest = real(*args, **kwargs)
        return (image * 1.01, *rest)
    return compose


def _no_densify(real):
    def event(params, aux, adam, *args, **kwargs):
        _, new_aux, _, report = real(params, aux, adam, *args, **kwargs)
        zero = torch.zeros_like(report.n_cloned)
        return (params, new_aux._replace(active=aux.active), adam,
                type(report)(zero, zero, zero, zero))
    return event


FAULTS = {
    "state_unchanged": ("deblurgs_tpu_torch.train.step", "train_step", _unchanged),
    "half_the_batch": ("deblurgs_tpu_torch.train.step", "_render_views", _half_batch),
    "answer_altered": ("deblurgs_tpu_torch.ops.tile_blend", "compose", _altered),
    "densify_skipped": ("deblurgs_tpu_torch.models.densify", "densify_and_prune", _no_densify),
}


@contextlib.contextmanager
def planted(name: str):
    module, attr, wrap = FAULTS[name]
    mod = importlib.import_module(module)
    real = getattr(mod, attr)
    setattr(mod, attr, wrap(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)
