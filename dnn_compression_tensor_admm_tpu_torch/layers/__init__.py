from .common import canonical_param_name, pair
from .tk_conv import TKConv2d
from .tt_conv import TTConv2d

__all__ = ["TKConv2d", "TTConv2d", "canonical_param_name", "pair"]
