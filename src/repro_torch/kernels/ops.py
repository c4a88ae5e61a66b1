"""The port's kernels' launch counters.

``launch_counts`` reads how many CUDA launches each kernel's wrapper made;
``reset_launch_counts`` sets them to zero.  The two backward kernels keep
their counts beside their forwards' (``backward_launches``).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import (actor_moe, flash_attention, policy_mlp,
                                 screen_score, ssm_scan, sumtree,
                                 sumtree_sample)

# kernel name -> (wrapper module, its counter)
KERNELS = {"actor_moe": (actor_moe, "launches"),
           "screen_score": (screen_score, "launches"),
           "sumtree": (sumtree, "launches"),
           "sumtree_sample": (sumtree_sample, "launches"),
           "fused_mlp": (policy_mlp, "launches"),
           "flash_attention": (flash_attention, "launches"),
           "flash_attention_backward": (flash_attention, "backward_launches"),
           "ssm_scan": (ssm_scan, "launches"),
           "ssm_scan_backward": (ssm_scan, "backward_launches")}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)
