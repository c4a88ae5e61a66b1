"""The search-loop kernels' launch counters.

``launch_counts`` reads how many CUDA launches each kernel's wrapper made;
``reset_launch_counts`` sets them to zero.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import actor_moe, screen_score

KERNELS = {"actor_moe": actor_moe, "screen_score": screen_score}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
