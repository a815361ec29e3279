"""The port's own data path against the JAX package's, and the port's import surface.

The port keeps a copy of the JAX package's numpy/PIL data layer
(``data/``, ``utils/depthmap_utils.py``, ``native/``) so that it stands
without the JAX package. Here the same synthetic trees go through both
copies and must give equal samples, bit for bit: arrays, poses,
intrinsics and file names, with the PIL decoder and with the native
(g++-built) one where the toolchain and libjpeg are present.
"""

import ast
import os

import numpy as np
import pytest

from multi_view_stereonet_tpu import data as jax_data
from multi_view_stereonet_tpu.data.loader import BatchLoader as JaxBatchLoader
from multi_view_stereonet_tpu.utils import depthmap_utils as jax_depthmap_utils
from multi_view_stereonet_tpu_torch import data, native
from multi_view_stereonet_tpu_torch.data.loader import BatchLoader
from multi_view_stereonet_tpu_torch.eval.streaming import make_dataset
from multi_view_stereonet_tpu_torch.utils import depthmap_utils

from tests.synthetic_data import make_demon_tree, make_gta_sfm_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, COLS = 48, 64
SIZE = {"size": [ROWS, COLS]}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trees"))
    return {"gta": make_gta_sfm_tree(os.path.join(root, "gta"), num_sequences=1, frames=3,
                                     rows=ROWS, cols=COLS, comparisons=2),
            "demon": make_demon_tree(os.path.join(root, "demon"), num_scenes=1, frames=3,
                                     rows=ROWS, cols=COLS)}


def need_native():
    if not native.available():
        pytest.skip("the native image loader does not build here (g++ or libjpeg "
                    "missing, or the Pillow parity probe failed)")


def assert_same(a, b, where="sample"):
    """Equal structure and values, bit for bit (arrays compared with their dtypes)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for key in a:
            assert_same(a[key], b[key], f"{where}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def datasets(kind, tree, module, backend, transform_of):
    data_dir, split = tree
    if kind == "gta":
        return module.GTASfMMultiViewDataset(data_dir, split, transform=transform_of(module),
                                             shuffle=False, decode_backend=backend)
    return module.DeMoNDataset(data_dir, split, num_right_images=2,
                               transform=transform_of(module), shuffle=False,
                               decode_backend=backend)


@pytest.mark.parametrize("backend", ["pil", "native"])
@pytest.mark.parametrize("kind", ["gta", "demon"])
def test_datasets_match_jax_package(trees, kind, backend):
    """Testing transforms, ground-truth depthmaps on: every sample equal."""
    if backend == "native":
        need_native()
    mine = datasets(kind, trees[kind], data, backend,
                    lambda m: m.get_testing_transforms(SIZE))
    ref = datasets(kind, trees[kind], jax_data, backend,
                   lambda m: m.get_testing_transforms(SIZE))
    assert len(mine) == len(ref) > 0
    for i in range(len(ref)):
        assert_same(mine[i], ref[i], f"{kind} sample {i}")
    assert mine[0]["left_image"].shape == (ROWS, COLS, 3)


# The augmentations the training slice will use, each with the same seeded draws.
@pytest.mark.parametrize("pipeline", ["train_augment", "roll180", "rot_noise",
                                      "trans_noise_flip"])
def test_augmentations_match_jax_package(trees, pipeline):
    def transform_of(m):
        rng = np.random.default_rng(7)
        if pipeline == "train_augment":
            return m.get_training_transforms({**SIZE, "augment": True}, rng=rng)
        if pipeline == "roll180":
            return m.get_testing_transforms(SIZE, roll_right_image180=True)
        if pipeline == "rot_noise":
            return m.get_testing_transforms(SIZE, add_rot_noise=True, rng=rng)
        return m.Compose([m.TranslationNoise(rng=rng),
                          m.RandomHorizontalFlipStereo(rng=np.random.default_rng(3)),
                          m.ResizeWithIntrinsics(ROWS, COLS), m.transforms.ToArray(),
                          m.Normalize()])
    mine = datasets("gta", trees["gta"], data, "pil", transform_of)
    ref = datasets("gta", trees["gta"], jax_data, "pil", transform_of)
    for i in range(len(ref)):
        assert_same(mine[i], ref[i], f"{pipeline} sample {i}")


def test_batch_loader_matches_jax_package(trees):
    mine = datasets("gta", trees["gta"], data, "pil", lambda m: m.get_testing_transforms(SIZE))
    ref = datasets("gta", trees["gta"], jax_data, "pil",
                   lambda m: m.get_testing_transforms(SIZE))
    got = list(BatchLoader(mine, 1, shuffle=True, seed=4, drop_last=False))
    want = list(JaxBatchLoader(ref, 1, shuffle=True, seed=4, drop_last=False))
    assert len(got) == len(want) == len(ref) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert_same(a, b, f"batch {i}")


def test_depthmap_utils_match_jax_package():
    rng = np.random.default_rng(0)
    K = np.array([[40.0, 0, 31.5], [0, 40.0, 23.5], [0, 0, 1]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.3, -0.02, 0.05]
    depth = rng.uniform(1.0, 8.0, (ROWS, COLS)).astype(np.float32)
    depth[::7, ::5] = 0.0
    for name, args in (("depthmap_to_disparity", (K, T, depth)),
                       ("depthmap_to_point_cloud", (K, depth)),
                       ("rectified_disparity_to_depth", (40.0, 0.3, depth)),
                       ("depth_to_rectified_disparity", (40.0, 0.3, depth)),
                       ("resize_sparse_depthmap", ((24, 32), K / 2, K, depth))):
        assert_same(getattr(depthmap_utils, name)(*args),
                    getattr(jax_depthmap_utils, name)(*args), name)


def test_native_loader_builds_into_the_build_directory():
    """The port's g++ build goes to the git-ignored _build/, never beside its source."""
    package = os.path.dirname(os.path.dirname(native.__file__))
    assert native._LIB == os.path.join(package, "_build", "_image_loader.so")
    need_native()
    assert os.path.exists(native._LIB)
    assert not os.path.exists(os.path.join(os.path.dirname(native.__file__),
                                           "_image_loader.so"))


def test_streaming_serves_the_ports_datasets(trees):
    for kind, cls in (("gta", data.GTASfMMultiViewDataset), ("demon", data.DeMoNDataset)):
        data_dir, split = trees[kind]
        assert type(make_dataset(data_dir, split, SIZE, decode_backend="pil")) is cls


def imported_modules(path):
    """Every module name an ``import`` or ``from`` statement in ``path`` names."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def python_files(target):
    path = os.path.join(REPO, target)
    if os.path.isfile(path):
        return [path]
    return [os.path.join(d, f) for d, _, files in os.walk(path) for f in files
            if f.endswith(".py")]


@pytest.mark.parametrize("target", ["chip_smoke.py", "scripts/profile_torch_serving.py",
                                    "scripts/compare_torch_trees.py",
                                    "scripts/compare_torch_view_feed.py",
                                    "scripts/refiner_variants.py",
                                    "scripts/run_convergence_torch.py",
                                    "scripts/accuracy_speed_torch.py",
                                    "scripts/gn_bf16_rounding_torch.py",
                                    "multi_view_stereonet_tpu_torch"])
def test_imports_nothing_of_jax_or_the_jax_package(target):
    """A static check: no import statement names jax or multi_view_stereonet_tpu."""
    files = python_files(target)
    assert files
    for path in files:
        for name in imported_modules(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "multi_view_stereonet_tpu"), (path, name)
