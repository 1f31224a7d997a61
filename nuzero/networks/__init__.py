from nuzero.networks.blocks import (
    VALUE_HEADS,
    BasicBlock,
    CombinedValueHead,
    DenseValueHead,
    DepthValueHead,
    DepthwiseConv,
    HexConv,
    HexDepthwiseConv,
    RawSeparableValueHead,
    ReducePolicyHead,
    ReduceValueHead,
    ReverseValueHead,
    SeparableValueHead,
    StrangeValueHead,
    make_value_head,
)
from nuzero.networks.convnet import ConvNet
from nuzero.networks.manager import NetworkManager
from nuzero.networks.mlp import MLPNetwork
from nuzero.networks.recurrent import RecurrentNet
from nuzero.networks.resnet import ResNet

__all__ = [
    "BasicBlock",
    "CombinedValueHead",
    "ConvNet",
    "DenseValueHead",
    "DepthValueHead",
    "DepthwiseConv",
    "HexConv",
    "HexDepthwiseConv",
    "MLPNetwork",
    "NetworkManager",
    "RawSeparableValueHead",
    "RecurrentNet",
    "ReducePolicyHead",
    "ReduceValueHead",
    "ResNet",
    "ReverseValueHead",
    "SeparableValueHead",
    "StrangeValueHead",
    "VALUE_HEADS",
    "make_value_head",
]
