"""Vision models of the port (counterpart of ``paddle_tpu/vision/models.py``
``:9-170`` and ``:472-503``): LeNet, and ResNet with its basic and
bottleneck blocks, depths 18 to 152, and the ResNeXt and wide variants of
the same class (``groups``, ``width``).

The layers keep the reference's names, so its ``state_dict`` read as
numpy (the batch norms' ``_mean`` and ``_variance`` included) loads by
key (:func:`paddle_tpu_torch.models.load_reference_state_dict`). Every
model takes ``device`` (the card unless the caller asks for the CPU),
``dtype`` and ``generator``, from which every layer draws its initial
weights in construction order.
"""

from __future__ import annotations

import torch

from ..nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Layer, Linear, MaxPool2D, ReLU,
                  Sequential)

__all__ = ["LeNet", "BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "resnext50_32x4d", "resnext50_64x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2"]


class LeNet(Layer):
    """``paddle.vision.models.LeNet``: two convolutions with ReLU and 2x2
    max pools over a ``[N, 1, 28, 28]`` input, then three linear layers
    (no activation between them, as the reference has it)."""

    def __init__(self, num_classes=10, *, device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **kw), ReLU(), MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **kw), ReLU(), MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(Linear(400, 120, **kw), Linear(120, 84, **kw),
                                 Linear(84, num_classes, **kw))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


class BasicBlock(Layer):
    """Two 3x3 convolutions with batch norms and a residual; ``groups``,
    ``base_width`` and ``dilation`` are taken and ignored, as in the
    reference."""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1, base_width=64,
                 dilation=1, norm_layer=None, *, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        kw = dict(device=device, dtype=dtype)
        conv = dict(bias_attr=False, generator=generator, **kw)
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1, **conv)
        self.bn1 = norm_layer(planes, **kw)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, **conv)
        self.bn2 = norm_layer(planes, **kw)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(Layer):
    """1x1, 3x3 (grouped, dilated) and 1x1 convolutions with batch norms
    and a residual; the inner width is ``planes * base_width / 64 *
    groups``."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1, base_width=64,
                 dilation=1, norm_layer=None, *, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        kw = dict(device=device, dtype=dtype)
        conv = dict(bias_attr=False, generator=generator, **kw)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, **conv)
        self.bn1 = norm_layer(width, **kw)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=dilation, groups=groups,
                            dilation=dilation, **conv)
        self.bn2 = norm_layer(width, **kw)
        self.conv3 = Conv2D(width, planes * self.expansion, 1, **conv)
        self.bn3 = norm_layer(planes * self.expansion, **kw)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(Layer):
    """``paddle.vision.models.ResNet``: a 7x7 stride-2 stem with batch norm,
    ReLU and a 3x3 stride-2 max pool, four stages of ``block`` (depths 18,
    34, 50, 101 or 152), then (``with_pool``) a global average pool and
    (``num_classes > 0``) a linear classifier."""

    LAYERS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
              152: [3, 8, 36, 3]}

    def __init__(self, block, depth=50, width=64, num_classes=1000, with_pool=True, groups=1,
                 *, device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        layers = self.LAYERS[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.inplanes = 64
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3, bias_attr=False, **kw)
        self.bn1 = self._norm_layer(self.inplanes, device=device, dtype=dtype)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0], **kw)
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2, **kw)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2, **kw)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2, **kw)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, **kw)

    def _make_layer(self, block, planes, blocks, stride=1, **kw):
        norm_kw = dict(device=kw["device"], dtype=kw["dtype"])
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1, stride=stride,
                       bias_attr=False, **kw),
                self._norm_layer(planes * block.expansion, **norm_kw))
        layers = [block(self.inplanes, planes, stride, downsample, self.groups, self.base_width,
                        norm_layer=self._norm_layer, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, norm_layer=self._norm_layer, **kw))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def resnet18(pretrained=False, **kwargs):
    return ResNet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return ResNet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 152, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, groups=32, width=4, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, groups=64, width=4, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, groups=32, width=4, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, groups=64, width=4, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 152, groups=32, width=4, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 152, groups=64, width=4, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, width=64 * 2, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, width=64 * 2, **kwargs)
