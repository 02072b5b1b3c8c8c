"""paddle.vision for the port (counterpart of ``paddle_tpu/vision``): the
LeNet and ResNet models and the MNIST and Cifar datasets."""

from . import datasets, models
from .models import (BasicBlock, BottleneckBlock, LeNet, ResNet, resnet18, resnet34, resnet50,
                     resnet101, resnet152, resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d, wide_resnet50_2,
                     wide_resnet101_2)

__all__ = ["datasets", "models", *models.__all__]
