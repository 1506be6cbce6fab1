"""Hand-written Hopper kernels, each beside its plain PyTorch version (K2's
plain version and autograd function are in ops/rasterize/pallas_composite.py)."""
from .bitonic_topk import bitonic_topk, topk_reference
from .composite import composite_launch
from .dpt_tail import dpt_tail_reference, fused_dpt_tail
from .flash_attn import (
    attention_backward_reference,
    attention_reference,
    flash_attention,
    flash_attention_backward,
)

__all__ = ["attention_backward_reference", "attention_reference", "bitonic_topk",
           "composite_launch", "dpt_tail_reference", "flash_attention",
           "flash_attention_backward", "fused_dpt_tail", "topk_reference"]
