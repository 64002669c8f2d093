from .blocks import (
    GLU,
    Conv2DBlock,
    FCBlock,
    GatedResBlock,
    ResBlock,
    ResFCBlock,
    binary_encode,
    one_hot,
    sequence_mask,
)
from .lstm import LayerNormLSTMCell, StackedLSTM
from .scatter import scatter_connection
from .transformer import Attention, AttentionPool, Transformer, TransformerLayer

__all__ = [
    "GLU",
    "Attention",
    "AttentionPool",
    "Conv2DBlock",
    "FCBlock",
    "GatedResBlock",
    "LayerNormLSTMCell",
    "ResBlock",
    "ResFCBlock",
    "StackedLSTM",
    "Transformer",
    "TransformerLayer",
    "binary_encode",
    "one_hot",
    "scatter_connection",
    "sequence_mask",
]
