"""The JAX package's reference computations for the port's slice tests,
each compiled as one program with `jax.jit`: its Z/U step as its own
engine compiles it (`train/engine.py`'s `z_step`/`zu_step`, the Pallas
kernels in interpret mode under `DCTA_PALLAS_INTERPRET=1`), its decompose
and a model's forward. Used where it is the cheaper way (measured alone:
ResNet-50's slice 73.9 -> 58.3 s, MobileNetV2-CIFAR's 55.3 -> 29.1,
DeiT-tiny's 46.4 -> 40.0); the ResNet32 slices' Pallas-interpret steps
compile slower than they run op by op, and stay eager."""

import functools

import jax

from dnn_compression_tensor_admm_tpu.admm import engine as jeng
from dnn_compression_tensor_admm_tpu.models import decompose_params


def admm_update(params, state, program, **kw):
    """`admm.engine.admm_update(params, state, program, **kw)`, jitted."""
    return jax.jit(functools.partial(jeng.admm_update, program=program,
                                     **kw))(params, state)


def decompose(variables, plan):
    """`models.decompose_params(variables, plan)`, jitted."""
    return jax.jit(lambda v: decompose_params(v, plan))(variables)


def apply(model, variables, *args, **kw):
    """`model.apply(variables, *args, **kw)`, jitted (keywords static)."""
    return jax.jit(functools.partial(model.apply, **kw))(variables, *args)
