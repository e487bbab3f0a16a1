"""Densification: clone / split / prune under static capacity.

Counterpart of ``deblurgs_tpu/models/densify.py`` (reference
``scene/gaussian_model.py:404-458``): grad-norm driven clone (small
Gaussians) and split (large ones, two samples from the Gaussian itself,
scale/1.6), low-opacity prune, with Adam-moment surgery.

Static capacity: "append a row" scatters into the lowest free slot
(``active == False``) and zeros that slot's Adam moments; "prune a row"
clears ``active``; a split reuses the original's slot for child 1 and a
free slot for child 2. Insertions past capacity are dropped and counted.
The split samples are standard normals passed in by the caller, so a test
can feed both packages the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deblurgs_tpu_torch.core import transforms as tf
from deblurgs_tpu_torch.models import gaussians as gm
from deblurgs_tpu_torch.train import optim


class DensifyReport(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped: torch.Tensor  # insertions lost to capacity exhaustion


def update_stats(aux: gm.GaussianAux, vsp_grad: torch.Tensor, radii: torch.Tensor,
                 denom_count: float) -> gm.GaussianAux:
    """Accumulate densification stats for one rendered sub-frame (reference
    ``add_densification_stats``, ``gaussian_model.py:456-458``, and the
    ``max_radii2D`` update, ``train.py:190-193``); ``vsp_grad`` [P, 2] NDC
    viewspace gradient, ``radii`` [P], ``denom_count = 1/f``."""
    vis = radii > 0
    norm = torch.linalg.norm(vsp_grad[:, :2], dim=-1)
    return aux._replace(
        xyz_grad_accum=aux.xyz_grad_accum + torch.where(vis, norm, 0.0),
        denom=aux.denom + torch.where(vis, denom_count, 0.0),
        max_radii2d=torch.where(vis, torch.maximum(aux.max_radii2d, radii.to(torch.float32)),
                                aux.max_radii2d),
    )


def _free_slot_table(active: torch.Tensor):
    """Indices of free slots in ascending order (a stable argsort of the
    mask as an integer: free slots first), and the free count."""
    order = torch.argsort(active.to(torch.int8), stable=True)
    return order, torch.sum(~active)


def _scatter_rows(leaf: torch.Tensor, dest: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``leaf.at[dest].set(val, mode="drop")``: rows with dest == P (no
    slot) land in a spare row that is cut off."""
    ext = torch.cat([leaf, leaf[:1]])
    ext[dest] = val
    return ext[:-1]


def densify_and_prune(params: gm.GaussianParams, aux: gm.GaussianAux,
                      adam: optim.AdamState, split_normals, *, cfg: gm.GaussianConfig,
                      grad_threshold, scene_extent: float, percent_dense: float = 0.01):
    """One densification event (reference ``densify_and_prune``,
    ``gaussian_model.py:444-454``). ``split_normals``: two [P, 3] standard
    normal draws, the split children's offsets in units of the scale.
    Returns (params, aux, adam, report); the stats accumulators restart."""
    capacity = params.xyz.shape[0]
    active = aux.active
    grads = torch.where(aux.denom > 0, aux.xyz_grad_accum / aux.denom, 0.0)

    scaling = gm.get_scaling(params, cfg)
    max_scale = torch.max(scaling, dim=-1).values
    hot = active & (grads >= grad_threshold)
    clone_mask = hot & (max_scale <= percent_dense * scene_extent)
    split_mask = hot & (max_scale > percent_dense * scene_extent)

    # free slots: clones first, then split child 2 (the reference's append
    # order), so clones have priority when capacity runs out
    needs = clone_mask | split_mask
    free_slots, n_free = _free_slot_table(active)
    rank_clone = torch.cumsum(clone_mask.to(torch.int64), 0) - 1
    rank_split = torch.sum(clone_mask) + torch.cumsum(split_mask.to(torch.int64), 0) - 1
    rank = torch.where(clone_mask, rank_clone, rank_split)
    ok = needs & (rank < n_free)
    dest = torch.where(ok, free_slots[torch.clamp(rank, 0, capacity - 1)], capacity)
    dropped = torch.sum(needs & ~ok)

    # split sampling (reference densify_and_split :404-427)
    n1, n2 = split_normals
    R = tf.quat_to_rotmat(params.rotation)
    xyz_child1 = torch.einsum("pij,pj->pi", R, n1 * scaling) + params.xyz
    xyz_child2 = torch.einsum("pij,pj->pi", R, n2 * scaling) + params.xyz
    split_scaling = gm.inverse_scaling(scaling / (0.8 * 2), cfg)
    if cfg.use_isotropic:   # raw isotropic scaling lives in channel 0
        split_scaling = torch.cat([split_scaling[:, :1], params.scaling[:, 1:]], dim=1)

    def new_slot_value(leaf, split_leaf):
        m = split_mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
        return torch.where(m, split_leaf, leaf)

    new_vals = params._replace(xyz=new_slot_value(params.xyz, xyz_child2),
                               scaling=new_slot_value(params.scaling, split_scaling))
    params = gm.GaussianParams(*(_scatter_rows(leaf, dest, val)
                                 for leaf, val in zip(params, new_vals)))
    active = _scatter_rows(active, dest, torch.ones_like(active))

    # split child 1 replaces the original in its slot
    did_split = split_mask & ok
    params = params._replace(
        xyz=torch.where(did_split[:, None], xyz_child1, params.xyz),
        scaling=torch.where(did_split[:, None], split_scaling, params.scaling))

    # Adam surgery: zero the moments of recycled slots and split originals
    touched = _scatter_rows(torch.zeros_like(active), dest, torch.ones_like(active)) | did_split
    adam = optim.zero_moment_rows(adam, gm.GaussianParams(*([touched] * 6)))

    # opacity prune (reference: min_op = lb + (1-lb)*0.005)
    min_op = cfg.alpha_lower_bound + (1 - cfg.alpha_lower_bound) * 0.005
    prune = active & (gm.get_opacity(params, cfg)[:, 0] < min_op)
    active = active & ~prune

    zeros = torch.zeros(capacity, dtype=torch.float32, device=active.device)
    aux = gm.GaussianAux(active=active, max_radii2d=zeros, xyz_grad_accum=zeros.clone(),
                         denom=zeros.clone())
    report = DensifyReport(n_cloned=torch.sum(clone_mask & ok), n_split=torch.sum(did_split),
                           n_pruned=torch.sum(prune), n_dropped=dropped)
    return params, aux, adam, report


def reset_opacity(params: gm.GaussianParams, adam: optim.AdamState,
                  cfg: gm.GaussianConfig):
    """Opacity reset + zeroing of its moments (reference ``reset_opacity``
    + ``replace_tensor_to_optimizer``, ``gaussian_model.py:247-253,301-314``)."""
    params = gm.reset_opacity(params, cfg)
    capacity = params.opacity.shape[0]
    on = torch.ones(capacity, dtype=torch.bool, device=params.opacity.device)
    off = torch.zeros_like(on)
    adam = optim.zero_moment_rows(adam, gm.GaussianParams(off, off, off, off, off, on))
    return params, adam
