"""Backdoor triggers and target remapping.

The reference's pattern trigger writes 2.8 into the top-left 5x5 patch of
every channel *after* normalization (reference backdoor.py:47-50; the
transform is appended after Normalize, data_sets.py:26-30) and remaps targets
to class 0 (backdoor.py:81, :129).  'sample k' mode instead trains on the
single training image k with label (y+1) % 5 (backdoor.py:83, :131).
"""

from __future__ import annotations

import torch

PATTERN_VALUE = 2.8   # normalized units, reference backdoor.py:49
PATTERN_SIZE = 5


def add_pattern(x: torch.Tensor) -> torch.Tensor:
    """A copy of the (..., C, H, W) image batch ``x`` with the 5x5 corner
    trigger applied; ``x`` itself is left as it was."""
    out = x.clone()
    out[..., :PATTERN_SIZE, :PATTERN_SIZE] = PATTERN_VALUE
    return out


def backdoor_targets(y: torch.Tensor, backdoor) -> torch.Tensor:
    """Poisoned labels: class 0 for 'pattern', (y+1)%5 for sample mode
    (reference backdoor.py:80-83)."""
    if backdoor == "pattern":
        return torch.zeros_like(y)
    return (y + 1) % 5
