"""The plain PyTorch versions of the port's kernels, under the reference's
``repro.kernels.ref`` names.  Each is defined beside its kernel's wrapper;
this module only gathers them."""
from repro_torch.kernels.actor_moe import actor_forward_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.policy_mlp import fused_mlp_plain
from repro_torch.kernels.screen_score import screen_scores_plain
from repro_torch.kernels.ssm_scan import ssm_scan_plain
from repro_torch.kernels.sumtree import sumtree_set_many_plain
from repro_torch.kernels.sumtree_sample import sumtree_sample_plain

actor_forward_reference = actor_forward_plain
screen_scores_reference = screen_scores_plain
fused_mlp_reference = fused_mlp_plain
sumtree_set_many_reference = sumtree_set_many_plain
sumtree_sample_reference = sumtree_sample_plain
attention_reference = flash_attention_plain
ssm_scan_reference = ssm_scan_plain

__all__ = ["actor_forward_reference", "screen_scores_reference",
           "fused_mlp_reference", "sumtree_set_many_reference",
           "sumtree_sample_reference", "attention_reference",
           "ssm_scan_reference"]
