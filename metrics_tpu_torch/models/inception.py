"""InceptionV3 feature extractor (torch-fidelity "inception-v3-compat"), in NCHW.

JAX counterpart: `metrics_tpu/models/inception.py` (``BasicConv2d`` `:48`,
``_avg_pool_3x3_same`` `:62`, ``InceptionA``-``E`` `:66-144`, ``InceptionV3``
`:146`, ``_resize_bilinear`` `:184`, ``LazyParamsPickleExtractor`` `:197`,
``InceptionV3Extractor`` `:232`, ``params_from_npz`` `:289`). The TF-Slim
compatible InceptionV3 with 1008-way logits whose tapped, spatially pooled
activations feed FID, KID and IS. Every convolution is bias-free and followed
by an inference BatchNorm (eps 1e-3) and a ReLU. Module and parameter names
are torch-fidelity's (``Mixed_5b.branch1x1.conv.weight``,
``Conv2d_1a_3x3.bn.running_mean``, ``fc.weight``), so the port's
``state_dict`` has the checkpoint's keys. Feature taps:

- ``"64"``, ``"192"``: spatial means after the first and the second max pool;
- ``"768"``: after Mixed_6e; ``"2048"``: the global average pool (FID's default);
- ``"logits_unbiased"`` / ``"logits"``: the 1008-way classifier, without and with its bias.

Weights: supplied Flax-layout weights (``params``, or the ``.npz`` of
``tools/convert_inception_weights.py`` through ``npz_path``) are checked
against the manifest and carried in; otherwise the network is initialised at
its first use from a seeded ``torch.Generator`` (He-normal convolutions,
identity BatchNorm), on the CPU and then moved, so the same seed gives the
same weights on every device. The forward runs under
:func:`~metrics_tpu_torch.utils.compute.high_precision`: cuDNN's TF32 is off.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.models.manifest import Layout, meta_module, state_from_flax
from metrics_tpu_torch.utils.compute import high_precision

VALID_FEATURES = ("64", "192", "768", "2048", "logits_unbiased", "logits")
INCEPTION_CONVERTER = "python tools/convert_inception_weights.py <torch-fidelity .pth> out.npz"

_KernelSize = Union[int, Tuple[int, int]]


class _FlaxLayout(nn.Module):
    """The map from the ``state_dict`` keys of a block of the network to the JAX package's Flax keys."""

    def flax_layout(self) -> Layout:
        """``{state_dict key: (Flax key, axis permutation to Flax's layout)}``, the mapping of
        ``tools/convert_inception_weights.py``: conv kernels OIHW -> HWIO, the fc kernel
        transposed, BatchNorm's weight and bias as ``scale`` and ``bias``, its running
        statistics under ``batch_stats``; ``num_batches_tracked`` has no Flax counterpart."""
        layout: Layout = {}
        for key in self.state_dict():
            if key == "fc.weight":
                layout[key] = ("params/fc/kernel", (1, 0))
            elif key == "fc.bias":
                layout[key] = ("params/fc_bias", None)
            else:
                *mods, layer, param = key.split(".")
                prefix = "/".join(["params", *mods])
                if layer == "conv":
                    layout[key] = (f"{prefix}/conv/kernel", (2, 3, 1, 0))
                elif param in ("weight", "bias"):
                    layout[key] = (f"{prefix}/bn/{'scale' if param == 'weight' else 'bias'}", None)
                elif param in ("running_mean", "running_var"):
                    layout[key] = (f"batch_stats{prefix[len('params'):]}/bn/{param[len('running_'):]}", None)
        return layout


class BasicConv2d(_FlaxLayout):
    """Conv (no bias) + BatchNorm(eps=1e-3, inference) + ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel: _KernelSize, stride: int = 1,
                 padding: _KernelSize = 0) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-3)

    def forward(self, x: Tensor) -> Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3_same(x: Tensor) -> Tensor:
    # count_include_pad=False: TF-compat normalisation by the window's true size
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(_FlaxLayout):
    def __init__(self, in_channels: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, 1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(_FlaxLayout):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = F.max_pool2d(x, 3, stride=2)
        return torch.cat([b3, bd, bp], dim=1)


class InceptionC(_FlaxLayout):
    def __init__(self, in_channels: int, channels_7x7: int) -> None:
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(_FlaxLayout):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        bp = F.max_pool2d(x, 3, stride=2)
        return torch.cat([b3, b7, bp], dim=1)


class InceptionE(_FlaxLayout):
    """Mixed_7b/7c; tf-compat uses an avg pool in 7b and a max pool in 7c."""

    def __init__(self, in_channels: int, pool_type: str = "avg") -> None:
        super().__init__()
        self.pool_type = pool_type
        self.branch1x1 = BasicConv2d(in_channels, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        if self.pool_type == "avg":
            bp = _avg_pool_3x3_same(x)
        else:  # padded with -inf, as Flax's max pool pads
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3(_FlaxLayout):
    """TF-compat InceptionV3 trunk returning all tapped features (NCHW input in [-1, 1])."""

    def __init__(self, num_classes: int = 1008) -> None:
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, pool_features=32)
        self.Mixed_5c = InceptionA(256, pool_features=64)
        self.Mixed_5d = InceptionA(288, pool_features=64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, channels_7x7=128)
        self.Mixed_6c = InceptionC(768, channels_7x7=160)
        self.Mixed_6d = InceptionC(768, channels_7x7=160)
        self.Mixed_6e = InceptionC(768, channels_7x7=192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool_type="avg")
        self.Mixed_7c = InceptionE(2048, pool_type="max")
        # one matmul serves both logits variants: the bias is added for "logits" only
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: Tensor) -> Dict[str, Tensor]:
        out: Dict[str, Tensor] = {}
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        out["64"] = x.mean(dim=(2, 3))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        out["192"] = x.mean(dim=(2, 3))
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = block(x)
        out["768"] = x.mean(dim=(2, 3))
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pooled = x.mean(dim=(2, 3))
        out["2048"] = pooled
        out["logits_unbiased"] = F.linear(pooled, self.fc.weight)
        out["logits"] = out["logits_unbiased"] + self.fc.bias
        return out


def _random_init_(model: nn.Module, seed: int) -> nn.Module:
    """Fill ``model`` (on the CPU) from a seeded generator: He-normal conv and linear weights,
    zero biases, identity BatchNorm. The values differ from Flax's initialisation."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                fan_in = module.weight[0].numel()
                module.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=gen)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
    return model


def _resize_bilinear(imgs: Tensor, size: int = 299) -> Tensor:
    """Half-pixel bilinear resize to ``size`` x ``size``, antialiased when it shrinks (as ``jax.image.resize``).

    Upsampling needs no antialiasing filter, and there PyTorch's plain
    bilinear kernel rounds closer to JAX's than its antialiased path does;
    shrinking takes the triangle filter scaled by the ratio, PyTorch's
    ``antialias=True``.
    """
    shrinks = imgs.shape[-2] > size or imgs.shape[-1] > size
    return F.interpolate(imgs, size=(size, size), mode="bilinear", align_corners=False, antialias=shrinks)


@high_precision
def _apply(model: nn.Module, imgs: Tensor) -> Dict[str, Tensor]:
    # metric-grade features: float32 convolutions, cuDNN's TF32 off for the call
    with torch.no_grad():
        return model(imgs)


class LazyParamsPickleExtractor:
    """Shared extractor plumbing: lazy seeded random initialisation, and the network's device.

    Subclasses set ``self._model`` (None until the first use when no weights
    were supplied), ``self._seed`` and ``self.device``, and implement
    ``_build``. The random network is initialised at its first use, not at
    construction (a metric built and never fed pays nothing), on the CPU from
    the seed, and then moved to ``self.device``. The network is a plain
    attribute of the metric, not a registered submodule: the metric's
    ``state_dict`` and sync hold its states only, as in the JAX package, and
    :meth:`to` moves the network with the metric.
    """

    _model: Optional[nn.Module]
    _seed: int
    device: torch.device

    def _build(self) -> nn.Module:
        raise NotImplementedError

    @property
    def model(self) -> nn.Module:
        if self._model is None:
            self._model = _random_init_(self._build(), self._seed).to(self.device).eval()
        return self._model

    @property
    def params(self) -> Dict[str, Tensor]:
        return self.model.state_dict()

    def _load(self, state: Dict[str, Tensor]) -> None:
        model = self._build()
        model.load_state_dict(state, strict=True)
        self._model = model.to(self.device).eval()

    def to(self, device: Union[str, torch.device]) -> "LazyParamsPickleExtractor":
        self.device = torch.device(device)
        if self._model is not None:
            self._model.to(self.device)
        return self


class InceptionV3Extractor(LazyParamsPickleExtractor):
    """Callable imgs -> (N, d) features, the ``NoTrainInceptionV3`` analogue.

    Takes NCHW uint8 (0-255) or float images, resizes them to 299 x 299,
    rescales to [-1, 1] (float inputs are divided by 255 too, as in JAX) and
    returns the tapped feature. ``device`` is where the network runs (None:
    the current CUDA device).
    """

    def __init__(self, feature: str = "2048", params: Any = None, npz_path: Optional[str] = None, seed: int = 0,
                 device: Union[str, torch.device, None] = None) -> None:
        if str(feature) not in VALID_FEATURES:
            raise ValueError(f"Expected `feature` to be one of {VALID_FEATURES}, got {feature}")
        self.feature = str(feature)
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
            self._load(state_from_flax(params, meta_module(InceptionV3), INCEPTION_CONVERTER))

    def _build(self) -> nn.Module:
        return meta_module(InceptionV3).to_empty(device="cpu")

    def __call__(self, imgs: Tensor) -> Tensor:
        imgs = torch.as_tensor(imgs).to(self.device, torch.float32)
        imgs = _resize_bilinear(imgs)
        imgs = imgs / 255.0 * 2.0 - 1.0
        return _apply(self.model, imgs)[self.feature]


def params_from_npz(path: str) -> Dict[str, Any]:
    """Load a converted-weights ``.npz`` (flat 'a/b/c' keys) into a nested dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    with np.load(path) as flat:
        for key in flat.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    return tree


__all__ = [
    "BasicConv2d",
    "InceptionA",
    "InceptionB",
    "InceptionC",
    "InceptionD",
    "InceptionE",
    "InceptionV3",
    "InceptionV3Extractor",
    "LazyParamsPickleExtractor",
    "VALID_FEATURES",
    "params_from_npz",
]
