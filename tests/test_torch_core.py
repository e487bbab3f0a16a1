"""Core math of the PyTorch port against the JAX package (atol 1e-6).

Same cases as ``tests/test_core_math.py``: transforms and activations, SH
degrees 0-4, cameras, the Lie maps including their small-angle Taylor
branches, Bézier curves and tone mapping. Also checks that the port never
imports JAX or the JAX package.
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblurgs_tpu.core import bezier as jbez
from deblurgs_tpu.core import camera as jcam
from deblurgs_tpu.core import lie as jlie
from deblurgs_tpu.core import sh as jsh
from deblurgs_tpu.core import transforms as jtf
from deblurgs_tpu.models import tonemap as jtm
from deblurgs_tpu_torch.core import bezier as tbez
from deblurgs_tpu_torch.core import camera as tcam
from deblurgs_tpu_torch.core import lie as tlie
from deblurgs_tpu_torch.core import sh as tsh
from deblurgs_tpu_torch.core import transforms as ttf
from deblurgs_tpu_torch.models import tonemap as ttm
from tests.torch_bridge import np_of

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def both(fj, ft, *arrays, atol=ATOL, rtol=0.0):
    """Run the JAX and torch functions on the same arrays and compare."""
    a = fj(*(jnp.asarray(x) for x in arrays))
    b = ft(*(torch.from_numpy(x.copy()) for x in arrays))
    np.testing.assert_allclose(np_of(b), np_of(a), atol=atol, rtol=rtol)
    return np_of(b)


class TestTransforms:
    @pytest.mark.parametrize("normalize", [True, False])
    def test_quat_to_rotmat(self, normalize):
        q = rand(6, 10, 4)
        if not normalize:
            q /= np.linalg.norm(q, axis=-1, keepdims=True)
        both(lambda x: jtf.quat_to_rotmat(x, normalize),
             lambda x: ttf.quat_to_rotmat(x, normalize), q)

    def test_build_covariance(self):
        # scene-sized scales (covariances below 1): at atol 1e-6 this is a
        # few ulps, the spread of the two frameworks' quaternion norms
        s = 0.3 * np.exp(rand(7, 50, 3) * 0.3)
        q = rand(8, 50, 4)
        both(lambda a, b: jtf.build_covariance(a, b, 1.3),
             lambda a, b: ttf.build_covariance(a, b, 1.3), s, q)
        both(jtf.build_scaling_rotation, ttf.build_scaling_rotation, s, q)

    def test_normalize_and_activations(self):
        x = rand(9, 100)
        both(jtf.normalize, ttf.normalize, rand(10, 20, 3))
        both(jtf.clamp_opacity, ttf.clamp_opacity, x)
        both(jtf.inverse_clamp_opacity, ttf.inverse_clamp_opacity, x)
        both(lambda v: jtf.lower_bound_exp(v, 0.01),
             lambda v: ttf.lower_bound_exp(v, 0.01), x)
        both(lambda v: jtf.lower_bound_log(v, 0.01),
             lambda v: ttf.lower_bound_log(v, 0.01), np.abs(x))
        both(lambda v: jtf.bound_sigmoid(v, 0.001, 0.5),
             lambda v: ttf.bound_sigmoid(v, 0.001, 0.5), x)
        both(lambda v: jtf.inverse_bound_sigmoid(v, 0.001, 0.5),
             lambda v: ttf.inverse_bound_sigmoid(v, 0.001, 0.5),
             np.abs(x) * 0.5)
        u = np.random.default_rng(1).uniform(0.05, 0.95, 50).astype(np.float32)
        both(jtf.inverse_sigmoid, ttf.inverse_sigmoid, u)


class TestSH:
    @pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
    def test_eval_sh(self, deg):
        shc = rand(10 + deg, 16, 3, (deg + 1) ** 2)
        d = rand(20 + deg, 16, 3)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        both(lambda a, b: jsh.eval_sh(deg, a, b), lambda a, b: tsh.eval_sh(deg, a, b),
             shc, d)

    @pytest.mark.parametrize("use_sigmoid", [False, True])
    def test_sh_to_color(self, use_sigmoid):
        shc = rand(12, 64, 9, 3)
        means = rand(13, 64, 3) + np.array([0.0, 0.0, 5.0], np.float32)
        campos = np.array([0.3, -0.2, 0.1], np.float32)
        both(lambda a, b, c: jsh.sh_to_color(a, b, c, 2, use_sigmoid),
             lambda a, b, c: tsh.sh_to_color(a, b, c, 2, use_sigmoid),
             shc, means, campos)


class TestCamera:
    def test_projection_matrix(self):
        a = jcam.get_projection_matrix(0.01, 100.0, 1.2, 0.9)
        b = tcam.get_projection_matrix(0.01, 100.0, 1.2, 0.9, device="cpu")
        np.testing.assert_array_equal(np_of(b), np_of(a))

    def test_view_and_campos(self):
        rot = np_of(jlie.so3_exp_map(jnp.asarray(rand(15, 4, 3))))
        center = rand(16, 4, 3)
        view = both(jcam.c2w_to_view, tcam.c2w_to_view, rot, center)
        proj = np_of(jcam.get_projection_matrix(0.01, 100.0, 1.1, 0.8))
        for field in range(3):
            both(lambda v, p: jcam.make_camera_arrays(v, p)[field],
                 lambda v, p: tcam.make_camera_arrays(v, p)[field], view, proj)

    def test_static_fields(self):
        kw = dict(width=40, height=32, tanfovx=0.6, tanfovy=0.5, clamp_tanfovx=0.9)
        a, b = jcam.CameraStatic(**kw), tcam.CameraStatic(**kw)
        for name in ("focal_x", "focal_y", "lim_tanfovx", "lim_tanfovy"):
            assert getattr(a, name) == getattr(b, name)


class TestLie:
    def test_so3_exp_and_log(self):
        v = rand(2, 32, 3)
        v = v / np.linalg.norm(v, axis=-1, keepdims=True) * 1.5
        R = both(jlie.so3_exp_map, tlie.so3_exp_map, v)
        both(jlie.so3_log_map, tlie.so3_log_map, R)
        both(jlie.hat, tlie.hat, v)

    def test_se3_exp_and_log(self):
        x = rand(4, 20, 6)
        x[:, 3:] = x[:, 3:] / np.linalg.norm(x[:, 3:], axis=-1, keepdims=True) * 1.5
        M = both(jlie.se3_exp_map, tlie.se3_exp_map, x)
        both(jlie.se3_log_map, tlie.se3_log_map, M)

    def test_small_angle_branches(self):
        """Near zero angle: the eps clamp of the exp maps, the Taylor
        fallback of so3_log and the linear acos extrapolation."""
        v = np.array([[1e-6, -2e-6, 1e-6], [0.0, 0.0, 0.0], [3e-3, 0.0, -1e-3]],
                     np.float32)
        R = both(jlie.so3_exp_map, tlie.so3_exp_map, v)
        both(jlie.so3_log_map, tlie.so3_log_map, R)
        x = np.concatenate([rand(5, 3, 3, scale=0.1), v], axis=-1)
        both(jlie.se3_exp_map, tlie.se3_exp_map, x)
        c = np.array([0.99995, 1.0, 1.00002, -0.99995, -1.00001, 0.3], np.float32)
        both(jlie.acos_linear_extrapolation, tlie.acos_linear_extrapolation, c)


class TestBezier:
    def test_basis_and_eval(self):
        t = np.linspace(0.0, 1.0, 21).astype(np.float32)
        both(lambda a: jbez.bernstein_basis(a, 9), lambda a: tbez.bernstein_basis(a, 9), t)
        ctrl = rand(14, 3, 10, 6)
        both(jbez.bezier_eval, tbez.bezier_eval, ctrl, t)

    def test_init_control_points(self):
        pts = rand(3, 4, 6)
        g = torch.Generator().manual_seed(0)
        out = tbez.init_control_points(torch.from_numpy(pts), 9, 0.0, g)
        np.testing.assert_array_equal(np_of(out), np.repeat(pts[:, None], 10, axis=1))
        g = torch.Generator().manual_seed(0)
        noisy = np_of(tbez.init_control_points(torch.from_numpy(pts), 9, 1e-3, g))
        assert 0 < np.abs(noisy - pts[:, None]).max() < 1e-2


class TestTonemap:
    @pytest.mark.parametrize("kind", ["gamma", "reverse_gamma", "identity"])
    def test_tone_map(self, kind):
        x = np.random.default_rng(3).uniform(-0.1, 1.1, 64).astype(np.float32)
        both(lambda v: jtm.tone_map(v, kind, bound=0.01),
             lambda v: ttm.tone_map(v, kind, bound=0.01), x)

    def test_inverse_kind(self):
        for kind in ("gamma", "reverse_gamma", "identity", "reverse_identity"):
            assert ttm.inverse_kind(kind) == jtm.inverse_kind(kind)


class TestNoJax:
    _PATTERN = re.compile(r"^\s*(import jax|from jax)\b|deblurgs_tpu\.(?!_)|"
                          r"(import|from) deblurgs_tpu\b(?!_)", re.M)

    def test_sources_do_not_import_jax(self):
        paths = [os.path.join(REPO, "chip_smoke.py")]
        for root, _, files in os.walk(os.path.join(REPO, "deblurgs_tpu_torch")):
            paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
        offenders = []
        for p in paths:
            with open(p) as f:
                src = f.read()
            offenders += [f"{p}: {m.group(0)}" for m in self._PATTERN.finditer(src)]
        assert not offenders, offenders

    def test_imports_with_jax_blocked(self):
        code = ("import sys; sys.modules['jax'] = None; "
                "sys.modules['deblurgs_tpu'] = None; "
                "import deblurgs_tpu_torch; "
                "from deblurgs_tpu_torch import render_batch; "
                "from deblurgs_tpu_torch.models import blur; "
                "from deblurgs_tpu_torch import weights; "
                "import deblurgs_tpu_torch.cli.evaluate, deblurgs_tpu_torch.eval.session; "
                "import deblurgs_tpu_torch.eval.metrics, deblurgs_tpu_torch.data.scene; "
                "import deblurgs_tpu_torch.ops.cuda_blend_lockstep; print('ok')")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
