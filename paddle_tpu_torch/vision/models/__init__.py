"""Model zoo (mirrors ``paddle_tpu/vision/models``): LeNet and the ResNet
family. VGG and MobileNet are ROADMAP queue 1 item 9b-2."""
from .lenet import LeNet
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152)

__all__ = ["LeNet", "BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152"]
