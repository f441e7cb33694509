from .engine import (METHODS, AdmmState, ProjectionProgram, adjust_rho,
                     admm_grad_add, admm_init, admm_penalty, admm_update,
                     admm_update_, build_program, tk_ranks)
from .regularizers import orthogonal_penalty

__all__ = ["METHODS", "AdmmState", "ProjectionProgram", "adjust_rho",
           "admm_grad_add", "admm_init", "admm_penalty", "admm_update",
           "admm_update_", "build_program", "orthogonal_penalty", "tk_ranks"]
