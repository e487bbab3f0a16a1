"""The port's multi-process path against the JAX package's
(``tests/test_multihost.py``, ``parallel/multihost.py``, ``data/scene.py``'s
``load_indices``, ``train/loop.py`` with a process group and a mesh).

Two ranks run as spawned processes with gloo on the CPU
(``multihost.launch``): each keeps only its block of the training images,
a step's image comes from its owner by broadcast, and the steps shard their
sub-frames over both ranks. They agree with each other at rtol 1e-6 and
with one process at 5e-4, as JAX's two processes do; ``Trainer.train(mesh=)``
on two ranks agrees with JAX's ``Trainer.train(mesh=make_mesh(2))``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblurgs_tpu.data.scene import Scene as JScene
from deblurgs_tpu.models import gaussians as jgm
from deblurgs_tpu.models import motion as jmm
from deblurgs_tpu.parallel import make_mesh as jmake_mesh
from deblurgs_tpu.train import checkpoint as jckpt
from deblurgs_tpu.train import step as jstep
from deblurgs_tpu.train.config import OptimizationConfig as JOptimizationConfig
from deblurgs_tpu_torch.data.scene import Scene as TScene
from deblurgs_tpu_torch.parallel import multihost
from tests import torch_parallel_workers as workers
from tests.test_data import write_colmap_binary, write_images
from tests.test_torch_loop import _configs, _generic, _jax_draw_chain, _trainers
from tests.test_torch_parallel import _case, _jax_draws
from tests.test_train import build_synthetic

torch.set_num_threads(1)

W, H, N_CAMS = 64, 48, 4


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("multihost") / "scene")
    write_colmap_binary(os.path.join(root, "sparse", "0"), n_cams=N_CAMS, n_pts=40)
    write_images(os.path.join(root, "images"), [f"{i:03d}.png" for i in range(N_CAMS)],
                 w=W, h=H)
    return root


@pytest.fixture(scope="module")
def two_steps():
    """``tests/test_multihost.py``'s setup (4 cameras, 4 sub-frames, two
    steps on cameras 0 and 1): JAX's one-process run, the port's two ranks
    and the port's one process."""
    data = build_synthetic(jax.random.PRNGKey(0), n_cams=4)
    params, aux = jgm.create_from_pcd(data["pts"], data["cols"], data["gcfg"], capacity=64)
    mcfg = jmm.MotionConfig(curve_order=3, n_subframes=4)
    motion = jmm.init_motion(data["rots"], data["centers"], mcfg, jax.random.PRNGKey(1),
                             init_noise=0.01)
    st = jstep.TrainStatics(gcfg=data["gcfg"], mcfg=mcfg,
                            ocfg=JOptimizationConfig(curve_start_iter=1, densify_from_iter=10**9,
                                                     opacity_reset_interval=10**9),
                            rcfg=data["rcfg"], cs=data["cs"], sh_degree=1, n_sub=4,
                            tone_mapping="identity")
    state = _generic(jstep.init_state(params, motion, aux, jax.random.PRNGKey(2)))
    fn = jstep.make_train_step(st)
    jstate, jlosses = state, []
    for it in range(2):
        jstate, m = fn(jstate, data["gts"][it], jnp.int32(it), data["proj"])
        jlosses.append(float(m.loss))
    case = _case(data, mcfg, st, state, 2, 2)
    case["gts"] = np.array(data["gts"])
    ranks = workers.launch(workers.two_process_steps, 2, case)
    one, cur = [], workers.ckpt.state_from_arrays(case["state"], device="cpu")
    one_st = workers.statics(case["cfg"])
    for it, d in enumerate(case["draws"]):
        cur, m = workers.step_lib.train_step(cur, torch.tensor(case["gts"][it]), it,
                                             torch.tensor(case["proj"]), one_st,
                                             draws=workers.draws_of(d))
        one.append(float(m.loss))
    return dict(jax=jlosses, ranks=ranks, one=one, gts=case["gts"])


def test_two_processes_agree(two_steps):
    """Two ranks agree with each other at rtol 1e-6 and with one process
    (the port's and JAX's) at 5e-4, as ``tests/test_multihost.py``'s."""
    r0, r1 = two_steps["ranks"]
    np.testing.assert_allclose(r0["losses"], r1["losses"], rtol=1e-6)
    np.testing.assert_allclose(r0["losses"], two_steps["one"], rtol=5e-4)
    np.testing.assert_allclose(r0["losses"], two_steps["jax"], rtol=5e-4)


def test_camera_split_and_select(two_steps):
    """Contiguous blocks of the four cameras; each rank holds only its rows
    and receives the others' by broadcast, bit for bit."""
    r0, r1 = two_steps["ranks"]
    assert (r0["split"], r1["split"]) == ([0, 1], [2, 3])
    assert r0["local_rows"] == r1["local_rows"] == 2
    for r in (r0, r1):
        for it, got in enumerate(r["gts"]):
            np.testing.assert_array_equal(got, two_steps["gts"][it])
        assert r["traffic"]["broadcast"]["calls"] == 2
        assert r["traffic"]["all_reduce_sum"]["calls"] > 0


def test_split_without_a_group_is_everything():
    assert multihost.host_local_camera_split(5) == [0, 1, 2, 3, 4]
    images = np.random.default_rng(0).uniform(0, 1, (3, 4, 5, 3)).astype(np.float32)
    stack = multihost.assemble_global_images(images, device="cpu")
    assert isinstance(stack, torch.Tensor)
    np.testing.assert_array_equal(multihost.select_camera(stack, 2).numpy(), images[2])
    multihost.initialize(None, 1, 0)   # one process: nothing to join
    assert multihost.rank_world() == (0, 1)


@pytest.mark.parametrize("indices", [None, [1, 2], []], ids=["all", "two", "none"])
def test_scene_load_indices_matches_jax(source, indices):
    """``Scene(load_indices=)`` decodes the listed training images and
    leaves the other rows zero, as JAX's."""
    t = TScene(source, None, resolution=1, load_indices=indices)
    j = JScene(source, None, resolution=1, load_indices=indices)
    np.testing.assert_array_equal(t.train_images, np.asarray(j.train_images))
    assert t.train_images.dtype == np.asarray(j.train_images).dtype
    for i in range(N_CAMS):
        assert t.train_images[i].any() == (indices is None or i in indices)


def test_scene_rows_per_rank(source):
    """Two ranks, four cameras split by rank: each decodes its block only,
    and every rank selects every camera's full image."""
    full = TScene(source, None, resolution=1).train_images
    ranks = workers.launch(workers.scene_ranks, 2, source)
    assert [r["mine"] for r in ranks] == [[0, 1], [2, 3]]
    assert [r["zero_rows"] for r in ranks] == [[2, 3], [0, 1]]
    for r in ranks:
        np.testing.assert_array_equal(r["selected"], full)


TRAIN_FLAGS = ["--num_subframes", "4", "--curve_order", "2", "--tile", "16",
               "--max_pairs", str(1 << 12), "--iterations", "4", "--curve_start_iter", "1",
               "--densify_from_iter", "2", "--densification_interval", "3",
               "--densify_until_iter", "10", "--opacity_reset_interval", "1000",
               "--densify_grad_threshold_init", "2e-5", "--densify_grad_threshold_final",
               "1e-5", "--densify_annealing_until", "100", "--noise_init", "0.02",
               "--noise_final", "0.002", "--backend", "xla"]


def test_trainer_mesh_matches_jax(source):
    """``Trainer.train(mesh=)`` on two ranks, each with its own training
    images, against JAX's ``Trainer.train(mesh=make_mesh(2))``: four
    iterations of four sub-frames (two a rank), a densify event at 3,
    JAX's draws injected. The ranks end bit for bit alike; the metrics
    agree (loss 1e-4) and every leaf at 2e-4 scaled
    (``tests/test_torch_loop.py``'s tolerance)."""
    seen = []
    jt, _ = _trainers(source, TRAIN_FLAGS, batched_render=False,
                      jax_kw=dict(on_metrics=lambda it, m: seen.append(
                          (it, float(m.loss), int(m.num_pairs)))))
    jstate, first = jt.init_state(key=jax.random.PRNGKey(5), capacity=128)
    jstate = _generic(jstate)
    keys = _jax_draw_chain(jstate.rng, 4)
    draws = [_jax_draws(k, 128, (H, W, 3)) for k in keys]
    flat = jckpt._flatten(jstate)
    jstate = jt.train(jstate, first, mesh=jmake_mesh(2))
    _, configs = _configs(TRAIN_FLAGS)
    ranks = workers.launch(workers.trainer_ranks, 2, source, configs, flat, draws,
                           dict(batched_render=False, sync_every=2))
    for r in ranks:
        assert r["gts_type"] == "RankImages"
        assert [(it, n) for it, _, n in r["seen"]] == [(it, n) for it, _, n in seen]
        np.testing.assert_allclose([x for _, x, _ in r["seen"]], [x for _, x, _ in seen],
                                   atol=1e-6, rtol=1e-4)
    for k, v in ranks[0]["state"].items():
        np.testing.assert_array_equal(ranks[1]["state"][k], v, err_msg=k)
    for key, want in jckpt._flatten(jstate).items():
        if key == "rng":
            continue
        got = ranks[0]["state"][key]
        if want.dtype == bool or want.dtype.kind == "i":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            scale = max(float(np.abs(want).max()), 1e-12)
            np.testing.assert_allclose(got / scale, want / scale, atol=2e-4, err_msg=key)
    assert int(ranks[0]["state"]["step"]) == 5


def test_dryrun_multichip_on_two_ranks(capsys, monkeypatch):
    """The port's counterpart of ``__graft_entry__.py::dryrun_multichip``
    on two CPU ranks: the five sharded exercises, finite and alike on
    every rank."""
    from deblurgs_tpu_torch.scripts import dryrun_multichip

    monkeypatch.setenv("OMP_NUM_THREADS", "1")    # the ranks inherit it
    assert dryrun_multichip.main(["--ranks", "2", "--device", "cpu"]) == 0
    assert "dryrun_multichip(2): ok" in capsys.readouterr().out
