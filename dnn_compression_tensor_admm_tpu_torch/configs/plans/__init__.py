from .tables import (build_svd_plan, build_tk_plan, build_tt_conv_plan,
                     build_tt_linear_plan, reference_tables, table_entry)

__all__ = ["build_svd_plan", "build_tk_plan", "build_tt_conv_plan",
           "build_tt_linear_plan", "reference_tables", "table_entry"]
