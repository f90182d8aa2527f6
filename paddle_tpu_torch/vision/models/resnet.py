"""The ResNet family (``paddle_tpu/vision/models/resnet.py``):
`BasicBlock`, `BottleneckBlock`, `ResNet`, ``resnet18/34/50/101/152``,
the ``resnext*`` variants (``groups``, ``width``) and ``wide_resnet*``.

Built of the port's layers with their default initializers: the
convolutions XavierUniform with no bias, the batch norms' scales one
and shifts zero with float32 running statistics (`nn.BatchNorm2D`),
the classifier `nn.Linear` ``[512 * expansion, num_classes]``. Every
layer takes ``device`` (the card unless ``device="cpu"``) and ``dtype``;
a ``norm_layer`` given to a block is called as ``norm_layer(channels,
device=..., dtype=...)``. ``pretrained=True`` raises, as in the
reference: there are no weights to fetch.
"""
from __future__ import annotations

import torch

from ... import nn


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype, device=device)
        norm_layer = norm_layer or nn.BatchNorm2D
        if groups != 1 or base_width != 64:
            raise ValueError(
                "BasicBlock only supports groups=1 and base_width=64")
        kw = dict(device=device, dtype=dtype)
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, **kw)
        self.bn1 = norm_layer(planes, **kw)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               **kw)
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


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype, device=device)
        norm_layer = norm_layer or nn.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        kw = dict(device=device, dtype=dtype)
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(width, **kw)
        self.conv2 = nn.Conv2D(width, width, 3, stride=stride,
                               padding=dilation, groups=groups,
                               dilation=dilation, bias_attr=False, **kw)
        self.bn2 = norm_layer(width, **kw)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion, **kw)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """The stem (7x7/2 conv, batch norm, ReLU, 3x3/2 max pool), four
    stages of ``block`` (the first at stride 1, the others 2; a 1x1
    conv and batch norm project the shortcut where the shape changes),
    then with ``with_pool`` the global average pool and with
    ``num_classes > 0`` the flattened classifier."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = nn.BatchNorm2D
        self._kw = dict(device=device, dtype=dtype)
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, **self._kw)
        self.bn1 = self._norm_layer(self.inplanes, **self._kw)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                **self._kw)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        downsample = None
        previous_dilation = self.dilation
        if dilate:
            self.dilation *= stride
            stride = 1
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, **self._kw),
                norm_layer(planes * block.expansion, **self._kw),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, previous_dilation,
                        norm_layer, **self._kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, **self._kw))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(arch, block, depth, pretrained, **kwargs):
    if pretrained:
        raise RuntimeError(
            f"{arch}: pretrained weights are not available (nothing is "
            "downloaded); build with pretrained=False and load local "
            "weights")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet("resnet18", BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet("resnet34", BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet("resnet50", BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet("resnet101", BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet("resnet152", BottleneckBlock, 152, pretrained, **kwargs)


def _variant(arch, depth, groups, width):
    def build(pretrained=False, **kwargs):
        if groups is not None:
            kwargs["groups"] = groups
        kwargs["width"] = width
        return _resnet(arch, BottleneckBlock, depth, pretrained, **kwargs)

    build.__name__ = build.__qualname__ = arch
    return build


resnext50_32x4d = _variant("resnext50_32x4d", 50, 32, 4)
resnext50_64x4d = _variant("resnext50_64x4d", 50, 64, 4)
resnext101_32x4d = _variant("resnext101_32x4d", 101, 32, 4)
resnext101_64x4d = _variant("resnext101_64x4d", 101, 64, 4)
resnext152_32x4d = _variant("resnext152_32x4d", 152, 32, 4)
resnext152_64x4d = _variant("resnext152_64x4d", 152, 64, 4)
wide_resnet50_2 = _variant("wide_resnet50_2", 50, None, 64 * 2)
wide_resnet101_2 = _variant("wide_resnet101_2", 101, None, 64 * 2)
