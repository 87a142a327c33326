"""Feature backbones of the port."""

from .mobilenet_v2 import MobileNetV2Backbone
from .vgg16 import VGG16Backbone

__all__ = ["MobileNetV2Backbone", "VGG16Backbone"]
