"""Analysis tooling (counterpart of the JAX package's `analysis/`;
reference: numeric_example*.py, ablation/,
xcompression/compute_flops_params.py)."""

from .flops import (tt_conv_cost, tk_conv_cost, svd_conv_cost, tt_linear_cost,
                    ttm_linear_cost, dense_conv_cost, dense_linear_cost,
                    model_compression_report)
from .feature_rank import activation_spectra, compare_feature_ranks
from .tt_lstm import TTLSTMCell, tt_lstm_inference_demo
