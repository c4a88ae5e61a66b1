"""PyTorch/CUDA port of the RL-driven ASIC design-space search.

The JAX package ``repro`` is the reference; this package mirrors its layout
module for module (``repro_torch.ppa.analytic`` ports ``repro.ppa.analytic``)
and imports neither JAX nor anything of ``repro``.
"""
