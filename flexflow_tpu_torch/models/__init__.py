"""Model zoo: every model of ``flexflow_tpu/models``, with the same graphs,
layer names and configs."""

from .alexnet import build_alexnet
from .candle_uno import CandleUnoConfig, build_candle_uno
from .dlrm import DLRMConfig, build_dlrm
from .gpt import GPTConfig, build_gpt
from .inception import build_inception_v3
from .mlp import build_mlp
from .moe import MoeConfig, build_moe_mnist
from .nmt import NMTConfig, build_nmt
from .resnet import build_resnet50
from .resnext import build_resnext50
from .transformer import TransformerConfig, build_bert_proxy, build_transformer
from .xdl import XDLConfig, build_xdl

__all__ = ["CandleUnoConfig", "DLRMConfig", "GPTConfig", "MoeConfig", "NMTConfig",
           "TransformerConfig", "XDLConfig", "build_alexnet", "build_bert_proxy",
           "build_candle_uno", "build_dlrm", "build_gpt", "build_inception_v3",
           "build_mlp", "build_moe_mnist", "build_nmt", "build_resnet50",
           "build_resnext50", "build_transformer", "build_xdl", "zoo_smoke_builders"]


def zoo_smoke_builders():
    """name -> build(ff, batch_size) for every zoo model, at the JAX
    package's small test sizes (the same twelve keys and sizes)."""

    def mlp(ff, bs):
        build_mlp(ff, bs, in_dim=64, hidden_dims=(128, 128), num_classes=10)

    def alexnet(ff, bs):
        build_alexnet(ff, bs, image_size=64)

    def resnet50(ff, bs):
        build_resnet50(ff, bs, image_size=64)

    def resnext50(ff, bs):
        build_resnext50(ff, bs, image_size=64)

    def inception_v3(ff, bs):
        build_inception_v3(ff, bs, image_size=299)

    def transformer(ff, bs):
        build_transformer(ff, bs, TransformerConfig(
            hidden_size=32, num_heads=4, num_layers=2, sequence_length=16))

    def dlrm(ff, bs):
        build_dlrm(ff, bs, DLRMConfig(embedding_size=[1000] * 4))

    def moe(ff, bs):
        build_moe_mnist(ff, bs, MoeConfig(
            input_dim=16, num_exp=4, num_select=2, expert_hidden_size=32))

    def xdl(ff, bs):
        build_xdl(ff, bs, XDLConfig(embedding_size=[1000] * 4))

    def candle_uno(ff, bs):
        build_candle_uno(ff, bs, CandleUnoConfig(
            dense_layers=[64] * 2, dense_feature_layers=[64] * 2))

    def nmt(ff, bs):
        build_nmt(ff, bs, NMTConfig(
            src_vocab_size=200, tgt_vocab_size=200, embed_dim=32,
            hidden_size=32, num_layers=1, src_length=8, tgt_length=8))

    def gpt(ff, bs):
        build_gpt(ff, bs, 16, GPTConfig(
            vocab_size=128, max_positions=64, hidden_size=32,
            num_heads=4, num_layers=2))

    return {
        "mlp": mlp,
        "alexnet": alexnet,
        "resnet50": resnet50,
        "resnext50": resnext50,
        "inception_v3": inception_v3,
        "transformer": transformer,
        "dlrm": dlrm,
        "moe": moe,
        "xdl": xdl,
        "candle_uno": candle_uno,
        "nmt": nmt,
        "gpt": gpt,
    }
