"""LeNet (mirrors ``paddle_tpu/vision/models/lenet.py``): the reference's
layer tree and parameter names (``features.0.weight`` ... ``fc.2.bias``),
its Linear layers' ``XavierNormal`` weights. Built on the card unless
``device`` names another."""
from __future__ import annotations

import torch

from ... import nn
from ...nn import initializer as I
from ...nn.layer.layers import device_scope, layer_device


class LeNet(nn.Layer):
    def __init__(self, num_classes=10, device=None):
        super().__init__()
        self.num_classes = num_classes
        with device_scope(layer_device(device)):
            self.features = nn.Sequential(
                nn.Conv2D(1, 6, 3, stride=1, padding=1),
                nn.ReLU(),
                nn.MaxPool2D(2, 2),
                nn.Conv2D(6, 16, 5, stride=1, padding=0),
                nn.ReLU(),
                nn.MaxPool2D(2, 2))
            if num_classes > 0:
                self.fc = nn.Sequential(
                    nn.Linear(400, 120, weight_attr=I.XavierNormal()),
                    nn.Linear(120, 84, weight_attr=I.XavierNormal()),
                    nn.Linear(84, num_classes, weight_attr=I.XavierNormal()))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x
