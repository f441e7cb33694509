from .common import canonical_param_name, pair
from .tk_conv import TKConv2d

__all__ = ["TKConv2d", "canonical_param_name", "pair"]
