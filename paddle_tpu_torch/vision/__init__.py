"""``paddle.vision`` of the port (mirrors ``paddle_tpu.vision``): the
LeNet and ResNet models and the MNIST datasets. VGG, MobileNet, the
CIFAR/Flowers/VOC datasets and ``nn.functional.vision`` are ROADMAP queue
1 item 9b-2; transforms, detection and the image backends item 9."""
from . import datasets, models
from .models import LeNet, ResNet, resnet18, resnet50

__all__ = ["datasets", "models", "LeNet", "ResNet", "resnet18", "resnet50"]
