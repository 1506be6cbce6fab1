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

# each kernel's launch counter: (wrapper, attribute)
COUNTERS = {"flash_attn": (flash_attention, "launches"),
            "flash_attn_bwd": (flash_attention_backward, "launches"),
            "flash_attn_f32": (flash_attention, "f32_launches"),
            "flash_attn_f32_bwd": (flash_attention_backward, "f32_launches"),
            "dpt_tail": (fused_dpt_tail, "launches"),
            "composite": (composite_launch, "launches"),
            "bitonic_topk": (bitonic_topk, "launches")}


def launch_counts() -> dict:
    """{kernel: launches since its counter was last reset}."""
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


__all__ = ["COUNTERS", "attention_backward_reference", "attention_reference",
           "bitonic_topk", "composite_launch", "dpt_tail_reference", "flash_attention",
           "flash_attention_backward", "fused_dpt_tail", "launch_counts",
           "topk_reference"]
