"""Feature backbones of the port. VGG16 arrives with the training slice."""

from .mobilenet_v2 import MobileNetV2Backbone

__all__ = ["MobileNetV2Backbone"]
