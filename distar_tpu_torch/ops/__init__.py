from .blocks import (
    GLU,
    Conv2DBlock,
    FCBlock,
    GatedResBlock,
    ResBlock,
    ResFCBlock,
    ResFCBlock2,
    binary_encode,
    one_hot,
    sequence_mask,
)
from .lstm import LayerNormLSTMCell, StackedLSTM
from .rl import (
    generalized_lambda_returns,
    multistep_forward_view,
    td_lambda_loss,
    upgo_returns,
    vtrace_advantages,
)
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
    "ResFCBlock2",
    "StackedLSTM",
    "Transformer",
    "TransformerLayer",
    "binary_encode",
    "generalized_lambda_returns",
    "multistep_forward_view",
    "one_hot",
    "scatter_connection",
    "sequence_mask",
    "td_lambda_loss",
    "upgo_returns",
    "vtrace_advantages",
]
