"""The network as ``nn.Module``s, named as the reference's modules."""

from .cost_volume import CostVolumeFilter, extract_idepthmap
from .feature_network import FeatureNetwork
from .layers import ResnetBlock
from .mvsnet import (
    MultiViewStereoNet,
    MultiViewStereoNetConfig,
    incremental_right_features,
    min_idepth_warp,
    mvsnet_forward,
    resolve_dtypes,
    resolve_precision,
)
from .refiners import FeatureRefiner, IDepthmapRefiner

__all__ = [
    "CostVolumeFilter",
    "extract_idepthmap",
    "FeatureNetwork",
    "ResnetBlock",
    "MultiViewStereoNet",
    "MultiViewStereoNetConfig",
    "incremental_right_features",
    "min_idepth_warp",
    "mvsnet_forward",
    "resolve_dtypes",
    "resolve_precision",
    "FeatureRefiner",
    "IDepthmapRefiner",
]
