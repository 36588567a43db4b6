"""Device helpers: the GPU paths fail loudly without a card, never fall
back to the CPU."""

from __future__ import annotations

import subprocess

import torch


def require_cuda() -> torch.device:
    """Return the first CUDA device; raise if there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this path needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def gpu_sm_clock_mhz() -> int:
    """The first card's SM clock in MHz at this moment (nvidia-smi). Ask
    while the card is busy: an idle card clocks down."""
    return int(_nvidia_smi("clocks.sm").split()[0])


def gpu_name_power() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (first card). Every timing is reported beside this line: a card
    capped below its maximum power runs slower under load."""
    return _nvidia_smi("name,power.limit")
