from .engine import (METHODS, AdmmState, ProjectionProgram, adjust_rho,
                     admm_init, admm_penalty, admm_update, build_program,
                     tk_ranks)

__all__ = ["METHODS", "AdmmState", "ProjectionProgram", "adjust_rho",
           "admm_init", "admm_penalty", "admm_update", "build_program",
           "tk_ranks"]
