"""InceptionV3: the ``inception`` reward's classifier and FID's pool3
features.

Port of ``consolver_tpu/models/inception.py``: ``BasicConv`` (a bias-free
conv, an inference BatchNorm at eps 1e-3 computed in f32, ReLU), VALID
3x3 / stride-2 max pools, count-include-pad 3x3 average pools, blocks
``InceptionA``-``E`` and a global mean.  ``num_classes=1000`` runs the final
``fc`` in f32 (the reward cosines the stock eval forward's logits,
reward_model.py:339-341); ``num_classes=0`` returns the 2048-d pooled
features (clean-fid's pool3).  Key names are torchvision's
``inception_v3`` (``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.
running_mean``, ``fc``), which ``convert_inception`` reads; the BatchNorm
statistics are buffers.  Public calls are NHWC; the stack runs NCHW.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from consolver_torch.device import resolve_device
from consolver_torch.models.layers import batch_norm_f32
from consolver_torch.models.vit import preprocess

INCEPTION_MEAN = (0.485, 0.456, 0.406)
INCEPTION_STD = (0.229, 0.224, 0.225)

# ``consolver_tpu/models/inception.py::convert_inception`` (:191-212)
RENAMES = (
    (r"\.bn\.weight$", ".bn_scale"),
    (r"\.bn\.bias$", ".bn_bias"),
    (r"\.bn\.running_mean$", ".bn_mean"),
    (r"\.bn\.running_var$", ".bn_var"),
)


class BasicConv(nn.Module):
    """Conv (no bias) + inference BatchNorm (eps 1e-3, f32) + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 stride: int = 1, padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(batch_norm_f32(self.bn, self.conv(x))).to(x.dtype)


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


def _avgpool3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_ch, 64, (1, 1))
        self.branch5x5_1 = BasicConv(in_ch, 48, (1, 1))
        self.branch5x5_2 = BasicConv(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = BasicConv(in_ch, pool_features, (1, 1))

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avgpool3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv(in_ch, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = BasicConv(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv(96, 96, (3, 3), stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_ch, 192, (1, 1))
        self.branch7x7_1 = BasicConv(in_ch, c7, (1, 1))
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(in_ch, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(in_ch, 192, (1, 1))

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for conv in (self.branch7x7dbl_1, self.branch7x7dbl_2, self.branch7x7dbl_3,
                     self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgpool3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(in_ch, 192, (1, 1))
        self.branch3x3_2 = BasicConv(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = BasicConv(in_ch, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for conv in (self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3,
                     self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _maxpool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_ch, 320, (1, 1))
        self.branch3x3_1 = BasicConv(in_ch, 384, (1, 1))
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(in_ch, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(in_ch, 192, (1, 1))

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avgpool3(x))], dim=1)


class InceptionV3(nn.Module):
    """images NHWC (Inception-normalised, 299x299) -> pooled f32 features
    ``[B, 2048]`` (``num_classes=0``) or f32 logits ``[B, num_classes]``."""

    jax_renames = RENAMES

    def __init__(self, num_classes: int = 0, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_classes = num_classes
        with torch.device(resolve_device(device)):
            self.Conv2d_1a_3x3 = BasicConv(3, 32, (3, 3), stride=2)
            self.Conv2d_2a_3x3 = BasicConv(32, 32, (3, 3))
            self.Conv2d_2b_3x3 = BasicConv(32, 64, (3, 3), padding=(1, 1))
            self.Conv2d_3b_1x1 = BasicConv(64, 80, (1, 1))
            self.Conv2d_4a_3x3 = BasicConv(80, 192, (3, 3))
            self.Mixed_5b = InceptionA(192, 32)
            self.Mixed_5c = InceptionA(256, 64)
            self.Mixed_5d = InceptionA(288, 64)
            self.Mixed_6a = InceptionB(288)
            self.Mixed_6b = InceptionC(768, 128)
            self.Mixed_6c = InceptionC(768, 160)
            self.Mixed_6d = InceptionC(768, 160)
            self.Mixed_6e = InceptionC(768, 192)
            self.Mixed_7a = InceptionD(768)
            self.Mixed_7b = InceptionE(1280)
            self.Mixed_7c = InceptionE(2048)
            if num_classes:
                self.fc = nn.Linear(2048, num_classes)
        if dtype is not None:
            self.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.Conv2d_1a_3x3.conv.weight.dtype).permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_maxpool(x)))
        x = _maxpool(x)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        x = x.mean(dim=(2, 3)).float()  # global average pool
        if self.num_classes:
            x = F.linear(x, self.fc.weight.float(), self.fc.bias.float())
        return x


def make_inception_encoder(model: InceptionV3):
    """``RewardModel.encode`` / FID's ``encode_fn``: ``[B, H, W, 3]`` in
    [0, 1] -> ``[B, 2048]`` features or ``[B, num_classes]`` logits, after
    the reward's processor (reward_model.py:102-107): bicubic shortest edge
    to 299, center crop 299, ImageNet normalisation."""

    def encode(images: torch.Tensor) -> torch.Tensor:
        return model(preprocess(images, 299, INCEPTION_MEAN, INCEPTION_STD, resize_to=299,
                                method="cubic"))

    encode.model = model
    return encode
