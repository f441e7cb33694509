"""PyTorch/CUDA port of the tensor-decomposition ADMM compression system.

The JAX package `dnn_compression_tensor_admm_tpu` is the reference this
package is held against; nothing here imports it or JAX. Entry points
run on the card (device='cuda') unless the caller passes device='cpu'.
"""
