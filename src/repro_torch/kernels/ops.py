"""The port's kernels' launch counters.

``launch_counts`` reads how many CUDA launches each kernel's wrapper made;
``reset_launch_counts`` sets them to zero.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import (actor_moe, flash_attention, policy_mlp,
                                 screen_score, ssm_scan, sumtree,
                                 sumtree_sample)

KERNELS = {"actor_moe": actor_moe, "screen_score": screen_score,
           "sumtree": sumtree, "sumtree_sample": sumtree_sample,
           "fused_mlp": policy_mlp, "flash_attention": flash_attention,
           "ssm_scan": ssm_scan}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
