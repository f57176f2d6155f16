"""Model zoo (the slices port the Transformer and the MoE model)."""

from .moe import MoeConfig, build_moe_mnist

__all__ = ["MoeConfig", "build_moe_mnist"]
