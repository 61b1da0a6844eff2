"""The port's counterparts of the JAX package's run scripts (`scripts/`):
`scale_demo` (BASELINE.json configs 3 and 5) and `disloc_core` (config 4).
Each runs with `python -m meng_zhang_tpu_torch.scripts.<name>` on the card,
and exposes `main(argv, device=None)`, which the CPU reaches with
`device="cpu"`."""
from __future__ import annotations

import subprocess

import torch


def device_label(dev):
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (its name alone if
    nvidia-smi cannot be run), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={index}"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(dev)
    line = smi.stdout.strip()
    return line if smi.returncode == 0 and line else \
        torch.cuda.get_device_name(dev)


def peak_mem_gib(dev):
    """torch.cuda.max_memory_allocated in GiB since the last reset, or None
    off the card."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2**30
