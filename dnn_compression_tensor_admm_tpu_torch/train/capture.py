"""The X-step as the JAX package compiles it: replayed from a CUDA graph
on the card (`jax.jit` of `run_steps`, `make_streaming_step` and
`run_epochs` there).

`CapturedStep` is one optimizer step that reads its input from tensors of
fixed address: the device-resident set's rows at a counter on the device,
or the streamed batch copied into `StaticBatch`'s buffers. On a card its
first call (`prime`) runs it eagerly, the warm-up autocast, cuDNN and the
optimizer's state need, and captures it in a CUDA graph with the device
generator registered; every later call replays the graph. One run holds
one such step, which both routes replay, so they cannot drift apart (the
JAX package's `scan_epoch` is shared by its per-epoch and fused programs
for the same reason):

* the per-epoch route (`run_epoch`): the epoch's steps replayed between
  eager Z/U steps, evaluations, logs and checkpoints;
* fused epochs (`EpochChunks`, `--epochs-per-dispatch`): several ADMM
  epochs as one chunk, each epoch's start (the Z/U step written in place,
  the epoch's permutation or shuffled copy, the epoch's sums and row
  counter set to 0) captured too. Nothing is read to the host between
  the chunk's first replay and its one read of the [k] sums at its end.

The NLP steps (`nlp/steps.py`) are `CapturedStep`s too, each call made by
`call`.

Replays run under `torch.cuda.set_sync_debug_mode("error")`. A capture or
a replay that fails raises; a run never gives way to the eager route. On
the CPU, and on a mesh of several ranks (its collectives are not
captured), the same step runs eagerly (`eager_reason`).

`chunkable` and `chunk_size` are the JAX package's rule
(`train/engine.py:654-671` there); `exclusion` names what the port
leaves on the per-epoch route although that rule would chunk it: a mesh,
and a Z/U step that would read a flag back to the host (`gram`, `svd`,
and an SVD plan under any method but `kernel`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List, Optional, Sequence

import torch

from ..ops.cuda import subspace_kernel as sk
from ..ops.cuda import tucker_kernel as tk


def chunkable(cfg, streaming: bool) -> bool:
    """The JAX package's predicate: chunks only where the host observes
    nothing per epoch."""
    return (not streaming and cfg.epochs_per_dispatch > 1
            and not cfg.verbose_admm and not cfg.log_path
            and cfg.checkpoint_dir is None and cfg.profile_dir is None
            and not cfg.adjust_rho_late)


def chunk_size(cfg, epoch: int, epochs: int, has_val: bool) -> int:
    """Epochs in the chunk that starts at `epoch` (0-based) of a run that
    stops at `epochs`: up to `epochs_per_dispatch`, ending at the next
    evaluation and at the last epoch."""
    if has_val and cfg.eval_every <= epochs:
        nxt = (epoch // cfg.eval_every + 1) * cfg.eval_every
    else:
        nxt = epochs
    return max(1, min(cfg.epochs_per_dispatch, nxt - epoch, epochs - epoch))


def _mesh_reason(mesh) -> Optional[str]:
    if mesh is not None and mesh.size > 1:
        return (f"a mesh of {mesh.size} ranks: collectives are not "
                "captured in CUDA graphs")
    return None


def eager_reason(device: torch.device, mesh=None) -> Optional[str]:
    """Why the run's X-step runs eagerly, or None: it is captured."""
    if device.type != "cuda":
        return "no card: CUDA graphs need one"
    return _mesh_reason(mesh)


# the Z/U methods whose every call can be captured: `kernel`, and the
# orthogonal iterations (Cholesky QR by `cholesky_ex`, Newton-Schulz);
# `gram`'s eigh and `svd` check their error flags on the host
CAPTURABLE_METHODS = ("kernel", "subspace", "ns")


def exclusion(cfg, mesh=None, program=None) -> Optional[str]:
    """Why the port runs a chunkable run per epoch, or None. `program`
    (`admm.ProjectionProgram`): an SVD bucket takes the exact SVD under
    any method but `kernel` (`admm/engine.py::_project_one`)."""
    why = _mesh_reason(mesh)
    if why is None and cfg.admm:
        method = cfg.admm_method
        if method not in CAPTURABLE_METHODS:
            why = (f"the {method!r} Z/U step's torch.linalg calls read "
                   "their error flags back to the host")
        elif method != "kernel" and program is not None and any(
                g.kind in ("svd_conv", "svd_linear") for g in program.groups):
            why = (f"the {method!r} Z/U step projects the plan's SVD layers "
                   "by torch.linalg.svd, which reads its error flag back to "
                   "the host")
    return why


def register_generators(graph, generators: Sequence[torch.Generator]) -> None:
    """Each replay of `graph` draws from `generators` where the eager calls
    would have, and advances them."""
    for g in generators:
        graph.register_generator_state(g)


class _Graph:
    """`fn` captured once in a CUDA graph; each replay adds the kernel
    launches the capture took to the wrappers' `launches`."""

    def __init__(self, fn: Callable[[], None],
                 generators: Sequence[torch.Generator]):
        wrappers = (tk.tucker2_factors_batched,
                    sk.dominant_left_subspace_batched)
        before = [getattr(w, "captured", 0) for w in wrappers]
        self.graph = torch.cuda.CUDAGraph()
        register_generators(self.graph, generators)
        # relaxed: the kernel wrappers' libraries are loaded and their
        # attributes set by the eager call before the capture
        with torch.cuda.graph(self.graph, capture_error_mode="relaxed"):
            fn()
        self.launches = [(w, getattr(w, "captured", 0) - b)
                         for w, b in zip(wrappers, before)]

    def replay(self) -> None:
        self.graph.replay()
        for w, n in self.launches:
            w.launches += n


@contextlib.contextmanager
def _no_host_reads(on_card: bool):
    if not on_card:
        yield
        return
    saved = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(saved)


class CapturedStep:
    """`fn`, one optimizer step reading nothing to the host, replayed from
    a CUDA graph once `prime` has run it (see the module docstring);
    before that, and where `capture` is False, a call runs it eagerly.
    `capture_s` is the host time of the capture (it waits for the card
    first). `CapturedStep.captures` counts the steps captured in this
    process, as the kernel wrappers count their launches."""

    captures = 0

    def __init__(self, fn: Callable[[], None],
                 generators: Sequence[torch.Generator], capture: bool):
        self.fn, self.generators = fn, tuple(generators)
        self.capture = capture
        self.graph: Optional[_Graph] = None
        self.capture_s = 0.0

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def prime(self) -> None:
        """The step eagerly, then captured: every later call replays it."""
        self.fn()
        t0 = time.perf_counter()
        self.graph = _Graph(self.fn, self.generators)
        self.capture_s = time.perf_counter() - t0
        CapturedStep.captures += 1

    def __call__(self) -> None:
        if self.graph is None:
            self.fn()
        else:
            self.graph.replay()


def call(step: CapturedStep) -> None:
    """One call of `step` as `run_epoch` makes it: a step to be captured
    and not captured yet is primed, a captured one replayed under the sync
    debug mode 'error', one that is not captured runs eagerly."""
    if step.capture and not step.captured:
        step.prime()
        return
    with _no_host_reads(step.capture):
        step()


class StaticBatch:
    """The streamed step's input: each batch copied into buffers of its
    own, on the step's stream, which a captured step reads."""

    def __init__(self):
        self.x: Optional[torch.Tensor] = None
        self.y: Optional[torch.Tensor] = None

    def load(self, xb: torch.Tensor, yb: torch.Tensor) -> None:
        if self.x is None:
            self.x, self.y = torch.empty_like(xb), torch.empty_like(yb)
        self.x.copy_(xb)
        self.y.copy_(yb)


def run_epoch(step: CapturedStep, steps: int,
              fetch: Optional[Callable[[], None]] = None,
              traced=contextlib.nullcontext) -> int:
    """The per-epoch route's `steps` calls of `step`, each after `fetch()`
    (the streamed batch into its buffers); on a card the run's first call
    primes the step and the others replay it, under the sync debug mode
    'error' and inside the context `traced()` makes (a `--profile-dir`
    trace of the replays). Returns the number of calls inside it."""
    first = 0
    if step.capture and not step.captured:
        if fetch:
            fetch()
        step.prime()
        first = 1
    with traced(), _no_host_reads(step.capture):
        for _ in range(first, steps):
            if fetch:
                fetch()
            step()
    return steps - first


class EpochChunks:
    """The fused chunks of one run (see the module docstring). `sums` is
    the tensor (loss, accuracy, failed Mixup draws) that `step` adds to
    and `epoch_start` sets to 0; the graphs are kept for every later chunk
    of the run. `capture_s` is the host time of the first epoch's eager
    start (and step, where the step was not captured yet) and the
    captures (each waits for the card first)."""

    def __init__(self, epoch_start: Callable[[], None], step: CapturedStep,
                 sums: torch.Tensor, steps: int):
        self.epoch_start, self.step = epoch_start, step
        self.sums, self.steps = sums, steps
        self.start: Optional[_Graph] = None
        self.capture_s = 0.0

    def run(self, k: int) -> List[List[float]]:
        """k epochs -> their sums over the steps, read to the host once,
        at the end."""
        out = torch.empty((k, self.sums.numel()), dtype=torch.float32,
                          device=self.sums.device)
        warm = self.step.capture and self.start is None
        first = 0
        if warm:  # the first epoch's start (and first step), eagerly
            t0 = time.perf_counter()
            self.epoch_start()
            if not self.step.captured:
                # the step first: its graph reads Z and U where the eager
                # Z/U step left them, and the Z/U step's graph writes there
                self.step.prime()
                first = 1
            self.start = _Graph(self.epoch_start, self.step.generators)
            self.capture_s = time.perf_counter() - t0
        with _no_host_reads(self.step.capture):
            for j in range(k):
                if not (warm and j == 0):
                    if self.start is None:
                        self.epoch_start()
                    else:
                        self.start.replay()
                for _ in range(first if j == 0 else 0, self.steps):
                    self.step()
                out[j].copy_(self.sums)
        return out.tolist()
