"""The card a measurement ran on, as its rows name it."""

from __future__ import annotations

import subprocess
from typing import Optional

import torch


def card_info(device: torch.device) -> Optional[str]:
    """The card's `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` line (one line per visible card), or None off
    the card. On the card a failing `nvidia-smi` raises."""
    if torch.device(device).type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdin=subprocess.DEVNULL, capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
