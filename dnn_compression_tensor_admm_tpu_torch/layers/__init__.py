from .common import canonical_param_name, pair
from .svd_conv import SVDConv2d
from .svd_linear import SVDLinear
from .tk_conv import TKConv2d
from .tk_linear import TKLinear
from .tt_conv import TTConv2d
from .tt_linear import TTLinear

__all__ = ["SVDConv2d", "SVDLinear", "TKConv2d", "TKLinear", "TTConv2d", "TTLinear",
           "canonical_param_name", "pair"]
