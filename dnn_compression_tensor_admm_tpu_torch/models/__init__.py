from .registry import create_model, list_models, parse_compressed_name, register_model
from . import (densenet, mobilenetv2, mobilenetv2_cifar, resnet_cifar,  # noqa: F401  (register builders and plans)
               resnet_inet, vgg, vit)
from .decompose import compression_ratio, count_params, decompose_params

__all__ = ["compression_ratio", "count_params", "create_model",
           "decompose_params", "list_models", "parse_compressed_name",
           "register_model"]
