"""Model zoo (the slices port the Transformer, BERT proxy, MoE model, GPT
and the MLP)."""

from .gpt import GPTConfig, build_gpt
from .mlp import build_mlp
from .moe import MoeConfig, build_moe_mnist
from .transformer import TransformerConfig, build_bert_proxy, build_transformer

__all__ = ["GPTConfig", "MoeConfig", "TransformerConfig", "build_bert_proxy",
           "build_gpt", "build_mlp", "build_moe_mnist", "build_transformer"]
