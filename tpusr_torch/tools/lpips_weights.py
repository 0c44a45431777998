"""Offline LPIPS-alex weights provisioning (port of
``tpusr/tools/lpips_weights.py``).

The reference EDA's central metric is LPIPS(alex). Its weights are two
official torch checkpoints, obtained on a connected machine:

- torchvision AlexNet-OWT: ``alexnet-owt-7be5be79.pth``
  (https://download.pytorch.org/models/alexnet-owt-7be5be79.pth);
- the LPIPS v0.1 linear heads: ``alex.pth``
  (https://github.com/richzhang/PerceptualSimilarity, ``lpips/weights/v0.1``).

Convert them once to a validated ``.npz``:

    python -m tpusr_torch.tools.lpips_weights \\
        --alexnet alexnet-owt-7be5be79.pth --linear alex.pth \\
        --out weights/lpips_alex.npz

and point the EDA at it with ``TPUSR_LPIPS_WEIGHTS=weights/lpips_alex.npz``
or ``python -m tpusr_torch.cli eda --lpips-weights ...``; without it the
LPIPS column stays empty and the scenario pick uses PSNR. The layout is
``conv{1..5}/kernel`` (HWIO) and ``/bias``, and ``lin{1..5}/weight`` ((C,)
per channel), the JAX package's, read by ``tpusr_torch.metrics.lpips``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from tpusr_torch.metrics.lpips import ALEX_CONVS

# torchvision alexnet .features conv indices
_FEATURE_IDX = (0, 3, 6, 8, 10)


def expected_shapes() -> dict[str, tuple]:
    shapes = {}
    in_ch = 3
    for i, (k, _s, _p, out_ch) in enumerate(ALEX_CONVS, start=1):
        shapes[f"conv{i}/kernel"] = (k, k, in_ch, out_ch)
        shapes[f"conv{i}/bias"] = (out_ch,)
        shapes[f"lin{i}/weight"] = (out_ch,)
        in_ch = out_ch
    return shapes


def _torch_state_dict(path: str) -> dict:
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return {k: np.asarray(v) for k, v in sd.items()}


def convert(alexnet_pth: str, linear_pth: str, out_npz: str) -> dict:
    """torch checkpoints -> validated ``.npz`` bundle. Returns the arrays."""
    alex = _torch_state_dict(alexnet_pth)
    lin = _torch_state_dict(linear_pth)

    flat = {"__arch__": np.asarray("lpips_alex")}
    for i, idx in enumerate(_FEATURE_IDX, start=1):
        k = alex[f"features.{idx}.weight"]          # OIHW
        b = alex[f"features.{idx}.bias"]
        flat[f"conv{i}/kernel"] = np.transpose(k, (2, 3, 1, 0)).astype(np.float32)
        flat[f"conv{i}/bias"] = np.asarray(b, np.float32)
        # lpips package naming: lin{i-1}.model.1.weight, shape (1, C, 1, 1)
        for key in (f"lin{i - 1}.model.1.weight", f"lin{i - 1}.weight",
                    f"lins.{i - 1}.model.1.weight"):
            if key in lin:
                flat[f"lin{i}/weight"] = (np.asarray(lin[key], np.float32)
                                          .reshape(-1))
                break
        else:
            raise ValueError(f"linear weights for tap {i} not found in "
                             f"{linear_pth} (keys: {sorted(lin)[:6]}...)")
    validate(flat)
    if out_npz:
        os.makedirs(os.path.dirname(os.path.abspath(out_npz)) or ".",
                    exist_ok=True)
        np.savez(out_npz, **flat)
        print(f"validated lpips_alex -> {out_npz}")
    return flat


def validate(flat: dict) -> None:
    want = expected_shapes()
    for key, shape in want.items():
        if key not in flat:
            raise ValueError(f"lpips bundle missing {key}")
        got = tuple(np.asarray(flat[key]).shape)
        if got != shape:
            raise ValueError(f"{key}: shape {got}, want {shape}")


def default_weights_path() -> str | None:
    """The provisioned bundle, if present: $TPUSR_LPIPS_WEIGHTS, else
    weights/lpips_alex.npz beside the repo root."""
    env = os.environ.get("TPUSR_LPIPS_WEIGHTS")
    if env and os.path.exists(env):
        return env
    here = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "weights",
        "lpips_alex.npz")
    return here if os.path.exists(here) else None


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert official AlexNet+LPIPS torch checkpoints to the "
                    "tpusr .npz bundle")
    p.add_argument("--alexnet", required=True,
                   help="torchvision alexnet-owt .pth")
    p.add_argument("--linear", required=True,
                   help="lpips v0.1 alex.pth linear heads")
    p.add_argument("--out", default="weights/lpips_alex.npz")
    args = p.parse_args(argv)
    convert(args.alexnet, args.linear, args.out)


if __name__ == "__main__":
    main()
