"""Train state: everything a run needs to resume, in one checkpoint
(counterpart of the JAX package's `train/state.py` and its
`utils/checkpoint.py::save_train_state`/`load_train_state`).

As in the JAX package, the ADMM duals U and targets Z are part of the
state and survive a resume (the reference's checkpoint loses them). The
JAX package writes an orbax directory; the port writes one file in the
checkpoint directory, `torch.save` of a dict of CPU tensors and plain
Python values, read back with `weights_only=True`. The orbax directories
are not read here.

A save writes a temporary file in the directory and renames it over the
last checkpoint (`os.replace`), so a run killed mid-write leaves the last
good checkpoint, as orbax's atomic save does.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, Optional, Tuple

import torch

from ..admm import AdmmState

CHECKPOINT_NAME = "train_state.pt"
FORMAT = "dnn_compression_tensor_admm_tpu_torch.train_state/1"


@dataclasses.dataclass
class TrainState:
    """`epoch` is the index of the last finished epoch (a resume starts at
    epoch + 1) and `step` the optimizer steps taken; `model` the model's
    state dict (parameters and BatchNorm buffers), `optimizer` the
    optimizer's; `admm` the ADMM state or None; `ema` the EMA shadow of
    the parameters or None; `rng` the generators' states ('device': the
    batches', crops', flips' and drop path's; 'cpu': the model init's)."""
    step: int
    epoch: int
    model: Dict[str, torch.Tensor]
    optimizer: dict
    admm: Optional[AdmmState]
    ema: Optional[Dict[str, torch.Tensor]]
    rng: Dict[str, torch.Tensor]


def _cpu(tree):
    """A copy of `tree` with every tensor on the CPU (never a view of a
    live tensor)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _payload(state: TrainState, extra: Optional[dict]) -> dict:
    admm = None
    if state.admm is not None:
        admm = {"u": state.admm.u, "z": state.admm.z,
                "nonfinite": state.admm.nonfinite}
    return _cpu({"format": FORMAT, "step": state.step, "epoch": state.epoch,
                 "model": state.model, "optimizer": state.optimizer,
                 "admm": admm, "ema": state.ema, "rng": state.rng,
                 "extra": extra})


def save_train_state(ckpt_dir: str, state: TrainState,
                     extra: Optional[dict] = None) -> str:
    """Write `state` (and `extra`, a dict of plain values) as
    `ckpt_dir/train_state.pt`, atomically; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, CHECKPOINT_NAME)
    fd, tmp = tempfile.mkstemp(prefix=".train_state.", suffix=".tmp",
                               dir=ckpt_dir)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(_payload(state, extra), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return path


def _shapes(tensors: Optional[Dict[str, torch.Tensor]]):
    if tensors is None:
        return None
    return {k: tuple(v.shape) for k, v in tensors.items()}


def load_train_state(ckpt_dir: str, template: TrainState
                     ) -> Tuple[TrainState, Optional[dict]]:
    """Read `ckpt_dir/train_state.pt` -> (state with CPU tensors, extra).

    `template` is the run's freshly built state: the checkpoint must hold
    the same model tensors, ADMM layers and EMA names, with their shapes,
    or this raises (a run never starts fresh in place of a resume)."""
    path = os.path.join(ckpt_dir, CHECKPOINT_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint {path} to resume from")
    d = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(d, dict) or d.get("format") != FORMAT:
        raise ValueError(f"{path} is not a train state of this package")
    admm = None
    if d["admm"] is not None:
        admm = AdmmState(u=d["admm"]["u"], z=d["admm"]["z"],
                         nonfinite=d["admm"]["nonfinite"])
    state = TrainState(step=d["step"], epoch=d["epoch"], model=d["model"],
                       optimizer=d["optimizer"], admm=admm, ema=d["ema"],
                       rng=d["rng"])
    checks = {
        "model": (_shapes(state.model), _shapes(template.model)),
        "ADMM targets": (_shapes(admm and admm.z),
                         _shapes(template.admm and template.admm.z)),
        "EMA shadow": (_shapes(state.ema), _shapes(template.ema)),
    }
    for what, (got, want) in checks.items():
        if got != want:
            diff = (sorted(set(got.items()) ^ set(want.items()))[:6]
                    if got is not None and want is not None
                    else f"{'none' if got is None else 'some'} in the "
                         f"checkpoint, {'none' if want is None else 'some'} "
                         "in the run")
            raise ValueError(f"{path}: its {what} do not match the run's: "
                             f"{diff}")
    return state, d["extra"]
