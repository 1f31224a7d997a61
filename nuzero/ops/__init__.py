from nuzero.ops.hexconv import (
    hex_conv,
    hex_conv_depthwise,
    hex_neighbor_offsets,
)

__all__ = ["hex_conv", "hex_conv_depthwise", "hex_neighbor_offsets"]
