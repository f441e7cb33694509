from .hp import RankPlan, SVDSpec, TKSpec, TTConvSpec, TTLinearSpec
from .resolver import get_rank_plan, register_plan, strip_format_prefix

__all__ = ["RankPlan", "SVDSpec", "TKSpec", "TTConvSpec", "TTLinearSpec",
           "get_rank_plan", "register_plan", "strip_format_prefix"]
