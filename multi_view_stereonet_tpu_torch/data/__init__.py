"""Data layer: split parsing, datasets (GTA-SfM, DeMoN), transforms, loading.

Host-side counterpart of the reference's ``datasets/`` package, and a copy
of ``multi_view_stereonet_tpu/data`` (numpy and PIL only), so that the port
stands without the JAX package. Samples are numpy dicts; the loader
assembles fixed-shape batches (static B and V per split config) and a
background thread keeps the device fed.
"""

from .splits import read_multi_view_split, read_scene_list
from .transforms import (
    Compose,
    ResizeWithIntrinsics,
    RandomColorJitter,
    RandomHorizontalFlipStereo,
    Normalize,
    RollRight180,
    TranslationNoise,
    RotationNoise,
    get_training_transforms,
    get_testing_transforms,
    training_u8_dequantize_mode,
)
from .gta_sfm import GTASfMMultiViewDataset, GTASfMStereoDataset, create_mvs_split
from .demon import DeMoNDataset, DeMoNStereoDataset
from .loader import BatchLoader

__all__ = [
    "read_multi_view_split", "read_scene_list",
    "Compose", "ResizeWithIntrinsics", "RandomColorJitter",
    "RandomHorizontalFlipStereo", "Normalize",
    "RollRight180", "TranslationNoise", "RotationNoise",
    "get_training_transforms", "get_testing_transforms",
    "training_u8_dequantize_mode",
    "GTASfMMultiViewDataset", "GTASfMStereoDataset", "create_mvs_split",
    "DeMoNDataset", "DeMoNStereoDataset",
    "BatchLoader",
]
