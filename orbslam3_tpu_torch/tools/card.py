"""The device a measuring tool runs on, and the card's line it prints first.

Every tool of this package that measures the System runs on the card
unless given ``--device=cpu``.  `open_device` prints the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them, the tool's first line; without a card,
and without ``--device=cpu``, it prints why to stderr and the tool exits 1.
"""

from __future__ import annotations

import subprocess
import sys

import torch

NO_CARD = ("torch.cuda.is_available() is False: {tool} runs on the card unless given "
           "--device=cpu")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def open_device(tool: str, device: str) -> torch.device | None:
    """`device` after printing the tool's first line (the card's, or "cpu");
    None, with the reason on stderr, when it asks for CUDA and there is no
    card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(NO_CARD.format(tool=tool), file=sys.stderr, flush=True)
        return None
    print(card_line() if dev.type == "cuda" else "cpu (--device=cpu)", flush=True)
    return dev


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
