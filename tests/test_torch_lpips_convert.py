"""The port's LPIPS weight converter against ``scripts/convert_lpips_weights.py``:
random weights, a converted torchvision-layout state dict and lin heads
(made in the test), both written through each converter's command line,
and the port's ``LPIPS.from_file`` on the port's output."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from deblurgs_tpu_torch.eval import metrics as tmetrics
from deblurgs_tpu_torch.scripts import convert_lpips_weights as tconv
from scripts import convert_lpips_weights as jconv

torch.set_num_threads(1)


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def _load(path) -> dict:
    with np.load(path) as d:
        return dict(d)


def _backbone_and_lin(net_type: str, root):
    """A features state dict in torchvision's layout (conv weights at their
    ``features.<idx>`` positions) and a richzhang lin-head file."""
    arch = tmetrics.LPIPS_ARCHS[net_type]
    gen = torch.Generator().manual_seed(1)
    sd, cin = {}, 3
    for idx, spec in enumerate(arch["layers"]):
        if spec[0] == "max":
            continue
        _, k, _s, _p, cout = spec
        sd[f"features.{2 * idx}.weight"] = torch.randn((cout, cin, k, k), generator=gen)
        sd[f"features.{2 * idx}.bias"] = torch.randn((cout,), generator=gen)
        cin = cout
    lin = {f"lin{j}.model.1.weight": torch.rand((1, c, 1, 1), generator=gen)
           for j, c in enumerate(arch["channels"])}
    backbone, lin_path = root / f"{net_type}_features.pth", root / f"{net_type}_lin.pth"
    torch.save(sd, backbone)
    torch.save(lin, lin_path)
    return str(backbone), str(lin_path)


@pytest.mark.parametrize("net_type", ["vgg", "alex"])
def test_random_weights_match(net_type, tmp_path):
    assert tmetrics.LPIPS_ARCHS[net_type] == jconv.LPIPS_ARCHS[net_type]
    _assert_same(tconv.random_weights(net_type, 0), jconv.random_weights(net_type, 0))
    out = tmp_path / f"{net_type}.npz"
    tconv.main(["--net-type", net_type, "--out", str(out), "--random", "--seed", "0"])
    _assert_same(_load(out), jconv.random_weights(net_type, 0))


@pytest.mark.parametrize("net_type", ["vgg", "alex"])
def test_convert_torch_match(net_type, tmp_path):
    backbone, lin = _backbone_and_lin(net_type, tmp_path)
    got = tconv.convert_torch(net_type, backbone, lin)
    _assert_same(got, jconv.convert_torch(net_type, backbone, lin))
    # both command lines write the same file
    t_out, j_out = tmp_path / "port.npz", tmp_path / "jax.npz"
    tconv.main(["--net-type", net_type, "--out", str(t_out), "--backbone-pth", backbone,
                "--lin-pth", lin])
    subprocess.run([sys.executable, "scripts/convert_lpips_weights.py", "--net-type", net_type,
                    "--out", str(j_out), "--backbone-pth", backbone, "--lin-pth", lin],
                   check=True, capture_output=True, cwd=jconv.__file__.rsplit("/scripts/", 1)[0])
    _assert_same(_load(t_out), _load(j_out))
    lp = tmetrics.LPIPS.from_file(str(t_out), device="cpu")
    assert lp.net_type == net_type
    a = torch.rand((32, 32, 3), generator=torch.Generator().manual_seed(2))
    assert np.isfinite(float(lp(a, torch.flip(a, (0,))))) and float(lp(a, a)) == 0.0


def test_port_converter_imports_no_jax():
    code = ("import sys; import deblurgs_tpu_torch.scripts.convert_lpips_weights; "
            "sys.exit(any(m == 'jax' or m.startswith(('jax.', 'deblurgs_tpu.')) "
            "or m == 'deblurgs_tpu' for m in sys.modules))")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=jconv.__file__.rsplit("/scripts/", 1)[0])
