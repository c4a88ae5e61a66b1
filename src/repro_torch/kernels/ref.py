"""The plain PyTorch versions of the port's kernels, under the reference's
``repro.kernels.ref`` names.  Each is defined beside its kernel's wrapper;
this module only gathers them."""
from repro_torch.kernels.actor_moe import actor_forward_plain
from repro_torch.kernels.screen_score import screen_scores_plain

actor_forward_reference = actor_forward_plain
screen_scores_reference = screen_scores_plain

__all__ = ["actor_forward_reference", "screen_scores_reference"]
