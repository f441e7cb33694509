"""Device-resident dataset sampling and augmentation.

The uint8 dataset lives on the device whole; a step picks its rows (a
slice of the epoch permutation, a slice of a shuffled copy, or uniform
draws with replacement; with repeated augmentation each picked row fills
`repeats` slots), gathers them, and pad-crops, flips, RandAugments,
normalises and erases them there. Crop and flip are one gather (the JAX
package's one-hot matmuls are a TPU idiom). Output is NCHW float32.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Optional, Sequence, Tuple

import torch

from .augment import (EraseDraws, RandAugmentDraws, device_constant,
                      rand_augment, random_erasing)


def pl_cdiv(a: int, b: int) -> int:
    return -(-a // b)


def batch_at(x: torch.Tensor, step: int, batch_size: int) -> torch.Tensor:
    """Contiguous batch `step` of `x` (dim 0): start (step*B) % (n-B+1).

    With the default steps_per_epoch = n // B the tail rows are dropped;
    more steps wrap and re-read mid-dataset rows."""
    n = x.shape[0]
    start = (step * batch_size) % max(n - batch_size + 1, 1)
    return x[start:start + batch_size]


def batch_at_repeated(x: torch.Tensor, step: int, batch_size: int,
                      repeats: int = 3) -> torch.Tensor:
    """Repeated augmentation over `batch_at`: ceil(B / repeats)
    consecutive rows, each filling `repeats` consecutive slots (the
    reference's RASampler: differently augmented views of each image)."""
    base = pl_cdiv(batch_size, repeats)
    return batch_at(x, step, base).repeat_interleave(repeats, 0)[:batch_size]


def batch_at_views(x: torch.Tensor, step: int, batch_size: int,
                   repeats: int = 0) -> torch.Tensor:
    """`batch_at`, or `batch_at_repeated` where repeats > 1: step `step`'s
    rows of a 'perm' epoch's permutation or of a shuffled copy."""
    if repeats <= 1:
        return batch_at(x, step, batch_size)
    return batch_at_repeated(x, step, batch_size, repeats)


def batch_rows_at(step: torch.Tensor, n: int, batch_size: int,
                  repeats: int = 0) -> torch.Tensor:
    """The rows [B] of a set of n that `batch_at_views` takes at step
    `step`, a 0-d int64 tensor on the device: start (step * base) %
    (n - base + 1), base = B (ceil(B / repeats) where repeats > 1), each
    row filling `repeats` consecutive slots. Computed on the device, so a
    captured step takes the rows of its own step at each replay."""
    base = batch_size if repeats <= 1 else pl_cdiv(batch_size, repeats)
    if n < base:
        raise ValueError(f"a set of {n} rows has no batch of {base}")
    slot = torch.arange(batch_size, device=step.device)
    if repeats > 1:
        slot = slot // repeats
    return (step * base) % (n - base + 1) + slot


def sample_batch(n: int, generator: torch.Generator,
                 batch_size: int) -> torch.Tensor:
    """Uniform with-replacement row indices [B] into a set of n rows."""
    return torch.randint(0, n, (batch_size,), device=generator.device,
                         generator=generator)


def sample_batch_repeated(n: int, generator: torch.Generator,
                          batch_size: int, repeats: int = 3) -> torch.Tensor:
    """ceil(B / repeats) uniform rows, each filling `repeats` slots (a
    gather, which reads nothing to the host)."""
    base = sample_batch(n, generator, pl_cdiv(batch_size, repeats))
    return base[torch.arange(batch_size, device=base.device) // repeats]


def shuffle_epoch(images: torch.Tensor, labels: torch.Tensor,
                  generator: torch.Generator):
    """One shuffled copy of the set for an epoch of contiguous batches
    (`batch_at` on it gives the rows a slice of the permutation does)."""
    perm = torch.randperm(images.shape[0], device=generator.device,
                          generator=generator)
    return images[perm], labels[perm]


def random_crop_flip(batch_size: int, generator: torch.Generator,
                     pad: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop offsets [B, 2] in [0, 2*pad] and flip bits [B], drawn on the
    generator's device."""
    dev = generator.device
    offsets = torch.randint(0, 2 * pad + 1, (batch_size, 2), device=dev,
                            generator=generator)
    flips = torch.rand(batch_size, device=dev, generator=generator) < 0.5
    return offsets, flips


def normalize(x: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    """uint8 NHWC -> normalised float32 NCHW."""
    m = device_constant(tuple(mean), x.device) * 255.0
    s = device_constant(tuple(std), x.device) * 255.0
    return ((x.float() - m) / s).permute(0, 3, 1, 2).contiguous()


def augment_batch(x_u8: torch.Tensor, offsets: torch.Tensor,
                  flips: torch.Tensor, *, mean: Sequence[float],
                  std: Sequence[float], pad: int = 4,
                  randaug: Optional[RandAugmentDraws] = None,
                  erase: Optional[EraseDraws] = None) -> torch.Tensor:
    """Zero-pad `pad` pixels, crop back at `offsets` (rows, cols), flip
    the samples whose bit is set, normalise: torchvision's
    RandomCrop(32, 4) + RandomHorizontalFlip + ToTensor + Normalize. With
    `randaug`, RandAugment runs on the [0, 1] floats before normalising;
    with `erase`, RandomErasing after it (timm's order)."""
    b, h, w, _ = x_u8.shape
    xp = torch.nn.functional.pad(x_u8, (0, 0, pad, pad, pad, pad))
    ar_h = torch.arange(h, device=x_u8.device)
    ar_w = torch.arange(w, device=x_u8.device)
    rows = offsets[:, 0:1] + ar_h                       # [B, H]
    cols = torch.where(flips[:, None], offsets[:, 1:2] + (w - 1) - ar_w,
                       offsets[:, 1:2] + ar_w)          # [B, W]
    bidx = torch.arange(b, device=x_u8.device)[:, None, None]
    crop = xp[bidx, rows[:, :, None], cols[:, None, :]]
    if randaug is None:
        out = normalize(crop, mean, std)
    else:
        xf = rand_augment(crop.permute(0, 3, 1, 2).float() / 255.0, randaug)
        m = device_constant(tuple(mean), x_u8.device)
        s = device_constant(tuple(std), x_u8.device)
        out = ((xf - m[:, None, None]) / s[:, None, None]).contiguous()
    return out if erase is None else random_erasing(out, erase)


class DevicePrefetcher:
    """Batches of a `NativeLoader` on `device`, `IN_FLIGHT` of them ahead
    (the JAX package's `prefetch_to_device(size=2)`). A thread of its own
    fills a ring of IN_FLIGHT + 1 host buffers (pinned on a card) from the
    loader, whose C call releases the GIL, so the loader's host time
    overlaps the training step. On a card each batch is copied on a side
    stream with `non_blocking=True`, the step's stream waits for that copy
    alone, and a buffer is refilled only once its copy has finished; on the
    CPU each batch is a copy of its buffer. Yields (images uint8
    [B, H, W, C], labels int64 [B]); `host_s` / `batches` is the loader's
    time a batch on its thread, `wait_s` the time the step waited for it.
    A looping loader keeps the short last batch of each pass over the
    shards (zero rows at its end), although the engine asks it for
    drop_last; such a batch is read and skipped. `close()` stops the
    thread; close the loader after it."""

    IN_FLIGHT = 2

    def __init__(self, loader, device: torch.device):
        self.pinned = device.type == "cuda"
        if self.pinned and device.index is None:  # the thread sets it
            device = torch.device("cuda", torch.cuda.current_device())
        self.loader, self.device = loader, device
        self.copy_stream = torch.cuda.Stream(device) if self.pinned else None
        shape = (loader.batch_size, *loader.shape)
        self.free = queue.Queue()   # (buffers, their copy's event)
        self.ready = queue.Queue()  # filled buffers, or the thread's error
        for _ in range(self.IN_FLIGHT + 1):
            self.free.put(((
                torch.empty(shape, dtype=torch.uint8, pin_memory=self.pinned),
                torch.empty(loader.batch_size, dtype=torch.int32,
                            pin_memory=self.pinned)), None))
        self.host_s = self.wait_s = 0.0
        self.batches = 0
        self.stopped = False
        self.thread = threading.Thread(target=self._fill, daemon=True)
        self.thread.start()
        self.queue = collections.deque(
            self._copy() for _ in range(self.IN_FLIGHT))

    def _fill(self) -> None:
        if self.pinned:
            torch.cuda.set_device(self.device)
        try:
            while True:
                item = self.free.get()
                if item is None or self.stopped:
                    return
                (x, y), copied = item
                if copied is not None:
                    copied.synchronize()
                t0 = time.perf_counter()
                n = self.loader.next_into(x.numpy(), y.numpy())
                while 0 < n < self.loader.batch_size:
                    n = self.loader.next_into(x.numpy(), y.numpy())
                self.host_s += time.perf_counter() - t0
                self.batches += 1
                if n == 0:
                    raise RuntimeError("the shard loader ran out of batches")
                self.ready.put((x, y))
        except Exception as e:  # raised again on the step's thread
            self.ready.put(e)

    def _copy(self):
        t0 = time.perf_counter()
        item = self.ready.get()
        self.wait_s += time.perf_counter() - t0
        if isinstance(item, Exception):
            raise item
        x, y = item
        if not self.pinned:
            batch = x.clone(), y.long(), None
            self.free.put((item, None))
            return batch
        with torch.cuda.stream(self.copy_stream):
            xd = x.to(self.device, non_blocking=True)
            yd = y.to(self.device, non_blocking=True).long()
            copied = torch.cuda.Event()
            copied.record(self.copy_stream)
        self.free.put((item, copied))
        return xd, yd, copied

    def __iter__(self):
        return self

    def __next__(self):
        xd, yd, copied = self.queue.popleft()
        self.queue.append(self._copy())
        if copied is not None:
            step_stream = torch.cuda.current_stream(self.device)
            step_stream.wait_event(copied)
            # the allocator keeps the copy stream's memory until the step's
            # stream has used it (the step, or the copy into a captured
            # step's input buffers, which runs there too)
            xd.record_stream(step_stream)
            yd.record_stream(step_stream)
        return xd, yd

    def close(self) -> None:
        self.stopped = True
        self.free.put(None)
        self.thread.join()
