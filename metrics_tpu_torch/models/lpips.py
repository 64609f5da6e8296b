"""LPIPS perceptual-similarity network, in NCHW.

JAX counterpart: `metrics_tpu/models/lpips.py` (``AlexNetFeatures`` `:33`,
``VGG16Features`` `:54`, ``Fire`` `:70`, ``SqueezeNetFeatures`` `:82`,
``_BACKBONES`` `:110`, ``LPIPSNet`` `:117`, ``LPIPSExtractor`` `:154`).
Backbone feature maps at the tapped layers, normalised to unit length over
channels (the eps outside the square root), squared difference, learned 1x1
heads taken in absolute value, spatial mean, summed over the taps (Zhang et
al. 2018). Parameter names follow the JAX package's modules
(``net.conv1.weight``, ``net.fire2.squeeze.weight``, ``lin0.weight``).

Padding follows Flax: a convolution given no padding pads "SAME", the
TensorFlow way, so SqueezeNet's first convolution (3 x 3, stride 2) pads one
pixel at the end of an even side and one on each side of an odd one (written
out with ``F.pad``, not torchvision's ``padding=0``); pools are "VALID".
"""
from __future__ import annotations

from typing import Any, List, Optional, Union

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.models.inception import LazyParamsPickleExtractor, params_from_npz
from metrics_tpu_torch.models.manifest import Layout, meta_module, state_from_flax
from metrics_tpu_torch.utils.compute import high_precision

# input normalisation constants of the published LPIPS scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _same_pad(x: Tensor, kernel: int, stride: int) -> Tensor:
    """TensorFlow's "SAME" padding of the two spatial dims: the output is ceil(in / stride),
    and an odd total pads one more pixel at the end."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):  # F.pad takes the last dim first
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class AlexNetFeatures(nn.Module):
    """AlexNet trunk with the 5 LPIPS tap points."""

    tap_channels = (64, 192, 384, 256, 256)

    def __init__(self) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 11, stride=4, padding=2)
        self.conv2 = nn.Conv2d(64, 192, 5, padding=2)
        self.conv3 = nn.Conv2d(192, 384, 3, padding=1)
        self.conv4 = nn.Conv2d(384, 256, 3, padding=1)
        self.conv5 = nn.Conv2d(256, 256, 3, padding=1)

    def forward(self, x: Tensor) -> List[Tensor]:
        taps = []
        x = F.relu(self.conv1(x))
        taps.append(x)
        x = F.max_pool2d(x, 3, stride=2)
        x = F.relu(self.conv2(x))
        taps.append(x)
        x = F.max_pool2d(x, 3, stride=2)
        for conv in (self.conv3, self.conv4, self.conv5):
            x = F.relu(conv(x))
            taps.append(x)
        return taps


class VGG16Features(nn.Module):
    """VGG16 trunk tapped at relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3."""

    cfg = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
    tap_channels = tuple(width for width, _ in cfg)

    def __init__(self) -> None:
        super().__init__()
        cin = 3
        for block, (width, convs) in enumerate(self.cfg, start=1):
            for i in range(1, convs + 1):
                self.add_module(f"conv{block}_{i}", nn.Conv2d(cin, width, 3, padding=1))
                cin = width

    def forward(self, x: Tensor) -> List[Tensor]:
        taps = []
        for block, (_, convs) in enumerate(self.cfg, start=1):
            for i in range(1, convs + 1):
                x = F.relu(getattr(self, f"conv{block}_{i}")(x))
            taps.append(x)
            if block < len(self.cfg):
                x = F.max_pool2d(x, 2, stride=2)
        return taps


class Fire(nn.Module):
    def __init__(self, in_channels: int, squeeze: int, expand: int) -> None:
        super().__init__()
        self.squeeze = nn.Conv2d(in_channels, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=1)


class SqueezeNetFeatures(nn.Module):
    """SqueezeNet 1.1 trunk with the 7 LPIPS tap points."""

    tap_channels = (64, 128, 256, 384, 384, 512, 512)

    def __init__(self) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, stride=2)  # padded "SAME" in forward, as Flax's default
        self.fire2 = Fire(64, 16, 64)
        self.fire3 = Fire(128, 16, 64)
        self.fire4 = Fire(128, 32, 128)
        self.fire5 = Fire(256, 32, 128)
        self.fire6 = Fire(256, 48, 192)
        self.fire7 = Fire(384, 48, 192)
        self.fire8 = Fire(384, 64, 256)
        self.fire9 = Fire(512, 64, 256)

    def forward(self, x: Tensor) -> List[Tensor]:
        taps = []
        x = F.relu(self.conv1(_same_pad(x, 3, 2)))
        taps.append(x)
        x = F.max_pool2d(x, 3, stride=2)
        x = self.fire3(self.fire2(x))
        taps.append(x)
        x = F.max_pool2d(x, 3, stride=2)
        x = self.fire5(self.fire4(x))
        taps.append(x)
        x = F.max_pool2d(x, 3, stride=2)
        for fire in (self.fire6, self.fire7, self.fire8, self.fire9):
            x = fire(x)
            taps.append(x)
        return taps


_BACKBONES = {
    "alex": (AlexNetFeatures, 5),
    "vgg": (VGG16Features, 5),
    "squeeze": (SqueezeNetFeatures, 7),
}


def lpips_converter(net_type: str) -> str:
    return f"python tools/convert_lpips_weights.py {net_type} <lpips .pth> out.npz"


class LPIPSNet(nn.Module):
    """Full LPIPS: backbone taps -> unit-normalise -> squared difference -> 1x1 heads -> mean."""

    def __init__(self, net_type: str = "alex") -> None:
        super().__init__()
        if net_type not in _BACKBONES:
            raise ValueError(f"Argument `net_type` must be one of {tuple(_BACKBONES)}, but got {net_type}.")
        self.net_type = net_type
        backbone_cls, n_taps = _BACKBONES[net_type]
        self.net = backbone_cls()
        for i, channels in enumerate(backbone_cls.tap_channels[:n_taps]):
            self.add_module(f"lin{i}", nn.Conv2d(channels, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)

    def forward(self, img1: Tensor, img2: Tensor) -> Tensor:
        feats1 = self.net((img1 - self.shift) / self.scale)
        feats2 = self.net((img2 - self.shift) / self.scale)
        total = 0.0
        for i, (f1, f2) in enumerate(zip(feats1, feats2)):
            # eps OUTSIDE the sqrt, as the published lpips normalize_tensor
            f1 = f1 / (torch.sqrt(torch.sum(f1**2, dim=1, keepdim=True)) + 1e-10)
            f2 = f2 / (torch.sqrt(torch.sum(f2**2, dim=1, keepdim=True)) + 1e-10)
            diff = (f1 - f2) ** 2
            # the published heads are trained non-negative; enforced at apply
            weighted = getattr(self, f"lin{i}")(diff).abs()
            total = total + weighted.mean(dim=(2, 3))[:, 0]
        return total

    def flax_layout(self) -> Layout:
        """``{state_dict key: (Flax key, axis permutation to Flax's layout)}``: every conv kernel
        OIHW -> HWIO, biases as they are."""
        layout: Layout = {}
        for key, value in self.state_dict().items():
            *mods, param = key.split(".")
            path = "params/" + "/".join(mods)
            layout[key] = (f"{path}/kernel", (2, 3, 1, 0)) if param == "weight" else (f"{path}/bias", None)
        return layout


@high_precision
def _apply(model: nn.Module, img1: Tensor, img2: Tensor) -> Tensor:
    with torch.no_grad():
        return model(img1, img2)


class LPIPSExtractor(LazyParamsPickleExtractor):
    """Callable ``(img1, img2) -> (N,)`` LPIPS scores (NCHW inputs in [-1, 1])."""

    def __init__(self, net_type: str = "alex", params: Any = None, npz_path: Optional[str] = None, seed: int = 0,
                 device: Union[str, torch.device, None] = None) -> None:
        if net_type not in _BACKBONES:
            raise ValueError(f"Argument `net_type` must be one of {tuple(_BACKBONES)}, but got {net_type}.")
        self.net_type = net_type
        self.device = resolve_device(device)
        if params is not None and npz_path is not None:
            raise ValueError(
                "Pass EITHER `params` or `npz_path`, not both — silently preferring one would "
                "hide which weights actually score."
            )
        if npz_path is not None:
            params = params_from_npz(npz_path)
        self._seed = seed
        self._model = None
        if params is not None:
            self._load(state_from_flax(params, meta_module(LPIPSNet, net_type), lpips_converter(net_type)))

    def _build(self) -> nn.Module:
        model = meta_module(LPIPSNet, self.net_type).to_empty(device="cpu")
        model.shift.copy_(torch.tensor(_SHIFT).reshape(1, 3, 1, 1))
        model.scale.copy_(torch.tensor(_SCALE).reshape(1, 3, 1, 1))
        return model

    def __call__(self, img1: Tensor, img2: Tensor) -> Tensor:
        img1 = torch.as_tensor(img1).to(self.device)
        img2 = torch.as_tensor(img2).to(self.device)
        return _apply(self.model, img1, img2)


__all__ = [
    "AlexNetFeatures",
    "Fire",
    "LPIPSExtractor",
    "LPIPSNet",
    "SqueezeNetFeatures",
    "VGG16Features",
]
