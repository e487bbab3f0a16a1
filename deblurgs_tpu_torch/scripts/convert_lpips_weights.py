"""Convert LPIPS weights (torchvision backbone + richzhang linear heads) to
the local ``.npz`` layout read by ``LPIPS.from_file`` of both packages.

Counterpart of ``scripts/convert_lpips_weights.py`` that needs no JAX: the
architectures come from ``deblurgs_tpu_torch/eval/metrics.py``. The same
flags, the same keys and the same arrays::

    python -m deblurgs_tpu_torch.scripts.convert_lpips_weights --net-type vgg \
        --out lpips_vgg.npz --backbone-pth vgg16_features.pth --lin-pth vgg.pth
    python -m deblurgs_tpu_torch.scripts.convert_lpips_weights --net-type alex \
        --out lpips_alex.npz --random --seed 0

The reference fetches both at runtime (``lpipsPyTorch/modules/utils.py:11-21``
downloads the lin heads from github; ``modules/networks.py:89-96`` pulls the
torchvision IMAGENET1K_V1 vgg16 / alexnet checkpoints); this converter runs
once wherever the checkpoints exist and the ``.npz`` ships with the model.

Weight provenance for real evaluations:
  - backbone: torchvision ``vgg16(weights=IMAGENET1K_V1).features`` or
    ``alexnet(weights=IMAGENET1K_V1).features`` state_dict (``--backbone-pth``
    accepts the raw ``.pth`` if already downloaded);
  - lin heads: ``https://raw.githubusercontent.com/richzhang/
    PerceptualSimilarity/master/lpips/weights/v0.1/{vgg,alex}.pth``
    (``--lin-pth`` accepts the local file).

Layout written: ``conv{i}/w`` [kh,kw,cin,cout] (HWIO — transposed from
torch OIHW), ``conv{i}/b`` [cout], ``lin{j}/w`` [1,1,c,1], ``meta_arch``.

``--random`` emits architecture-consistent pseudo-random weights (fixed
seed): an offline smoke path and the tests' weights. Random-weight LPIPS is
NOT a perceptual metric; real runs must use converted pretrained weights.
"""

import argparse

import numpy as np

from deblurgs_tpu_torch.eval.metrics import LPIPS_ARCHS


def random_weights(net_type: str, seed: int = 0) -> dict:
    """Architecture-consistent random weights (He-scaled convs, non-negative
    lin heads as in richzhang's release)."""
    arch = LPIPS_ARCHS[net_type]
    rng = np.random.default_rng(seed)
    out = {}
    cin = 3
    conv_i = 0
    for spec in arch["layers"]:
        if spec[0] == "max":
            continue
        _, k, _s, _p, cout = spec
        fan_in = k * k * cin
        out[f"conv{conv_i}/w"] = (
            rng.standard_normal((k, k, cin, cout)) / np.sqrt(fan_in)
        ).astype(np.float32)
        out[f"conv{conv_i}/b"] = (
            0.1 * rng.standard_normal(cout).astype(np.float32))
        cin = cout
        conv_i += 1
    for j, c in enumerate(arch["channels"]):
        out[f"lin{j}/w"] = np.abs(
            rng.standard_normal((1, 1, c, 1))).astype(np.float32)
    out["meta_arch"] = np.asarray(net_type)
    return out


def convert_torch(net_type: str, backbone_pth: str | None,
                  lin_pth: str | None) -> dict:
    import torch

    if backbone_pth:
        sd = torch.load(backbone_pth, map_location="cpu")
        if not any(k.startswith("features") or "." in k for k in sd):
            raise ValueError("unrecognized backbone state dict")
    else:
        try:
            import torchvision.models as models
        except ImportError as e:
            raise SystemExit(
                "torchvision unavailable — pass --backbone-pth with a "
                "downloaded checkpoint instead") from e
        net = (models.vgg16(weights=models.VGG16_Weights.IMAGENET1K_V1)
               if net_type == "vgg" else
               models.alexnet(weights=models.AlexNet_Weights.IMAGENET1K_V1))
        sd = net.state_dict()
    # features.<idx>.weight [cout,cin,kh,kw] → conv{i}/w HWIO, in conv order
    conv_keys = sorted(
        (int(k.split(".")[1]), k[: -len(".weight")])
        for k in sd if k.startswith("features.") and k.endswith(".weight")
    )
    out = {}
    for conv_i, (_, base) in enumerate(conv_keys):
        w = sd[f"{base}.weight"].numpy()
        out[f"conv{conv_i}/w"] = np.transpose(w, (2, 3, 1, 0)).astype(np.float32)
        out[f"conv{conv_i}/b"] = sd[f"{base}.bias"].numpy().astype(np.float32)

    if lin_pth:
        lin_sd = torch.load(lin_pth, map_location="cpu")
        # richzhang keys: lin{j}.model.1.weight [1,c,1,1]
        for j in range(len(LPIPS_ARCHS[net_type]["channels"])):
            key = next(k for k in lin_sd if k.startswith(f"lin{j}.")
                       and k.endswith("weight"))
            w = lin_sd[key].numpy()                       # [1, c, 1, 1]
            out[f"lin{j}/w"] = np.transpose(w, (2, 3, 1, 0)).astype(np.float32)
    else:
        raise SystemExit(
            "--lin-pth required (download "
            "richzhang/PerceptualSimilarity lpips/weights/v0.1/"
            f"{net_type}.pth where egress exists)")
    out["meta_arch"] = np.asarray(net_type)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--net-type", choices=("vgg", "alex"), default="vgg")
    ap.add_argument("--out", required=True)
    ap.add_argument("--backbone-pth", help="local torchvision features .pth")
    ap.add_argument("--lin-pth", help="local richzhang v0.1 lin-head .pth")
    ap.add_argument("--random", action="store_true",
                    help="emit fixed-seed random weights (testing only)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.random:
        weights = random_weights(args.net_type, args.seed)
    else:
        weights = convert_torch(args.net_type, args.backbone_pth,
                                args.lin_pth)
    np.savez(args.out, **weights)
    n_conv = sum(1 for k in weights if k.endswith("/w") and "conv" in k)
    print(f"wrote {args.out}: {n_conv} convs, "
          f"{len(LPIPS_ARCHS[args.net_type]['channels'])} lin heads, "
          f"arch={args.net_type}")


if __name__ == "__main__":
    main()
