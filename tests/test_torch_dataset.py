"""The port's dataset, loader and prefetcher against ``papr_tpu.dataset`` on
procedural scenes in both formats: the same seeds give the same batches
(both are numpy up to the device copy), bit for bit."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch

from papr_tpu.config import Config as JConfig
from papr_tpu.dataset import get_dataset as jget_dataset
from papr_tpu.dataset import get_loader as jget_loader
from papr_tpu.dataset.synth import make_demo_scene as jmake
from papr_tpu.dataset.synth import make_demo_scene_t2 as jmake_t2
from papr_tpu_torch.config import Config
from papr_tpu_torch.dataset import Batch, get_dataset, get_loader
from papr_tpu_torch.dataset.dataset import device_prefetch
from papr_tpu_torch.dataset.synth import make_demo_scene, make_demo_scene_t2

FIELDS = ("img_idx", "patch_idx", "image", "rayd", "rayo", "c2w")


def _args(path, type_="synthetic", **over):
    base = {"mode": "train", "coord_scale": 2.0, "type": type_,
            "white_bg": True, "path": path, "factor": 1, "batch_size": 2,
            "shuffle": True, "extract_patch": True, "extract_online": True,
            "read_offline": True,
            "patches": {"height": 16, "width": 16, "max_patches": 2}}
    base.update(over)
    return base


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    return {"synthetic": make_demo_scene(str(root / "bl"), n_train=4,
                                         n_test=2, H=32, W=32),
            "t2": make_demo_scene_t2(str(root / "t2"), n_train=4, n_test=2,
                                     H=32, W=32),
            "root": root}


def test_synth_writes_the_jax_packages_files(scenes):
    """Both generators write the same images and poses as the JAX package's."""
    import filecmp
    import os
    root = scenes["root"]
    jb = jmake(str(root / "jbl"), n_train=4, n_test=2, H=32, W=32)
    jt = jmake_t2(str(root / "jt2"), n_train=4, n_test=2, H=32, W=32)
    for ours, theirs in ((scenes["synthetic"], jb), (scenes["t2"], jt)):
        names = sorted(os.path.relpath(os.path.join(d, f), ours)
                       for d, _, fs in os.walk(ours) for f in fs)
        assert len(names) >= 8
        match, mismatch, errors = filecmp.cmpfiles(ours, theirs, names,
                                                   shallow=False)
        assert not mismatch and not errors, (mismatch, errors)


@pytest.mark.parametrize("type_,over", [
    ("synthetic", {}),
    ("t2", {}),
    ("synthetic", {"read_offline": False}),
    ("synthetic", {"extract_online": False}),
    ("synthetic", {"white_bg": False, "shuffle": False}),
])
def test_batches_equal_the_jax_loaders(scenes, type_, over):
    a = _args(scenes[type_], type_, **over)
    ours = get_dataset(Config(a), mode="train", seed=3)
    theirs = jget_dataset(JConfig(a), mode="train", seed=3)
    assert len(ours) == len(theirs)
    lo, lt = get_loader(ours, Config(a)), jget_loader(theirs, JConfig(a))
    assert len(lo) == len(lt)
    for epoch in range(2):
        bo, bt = list(lo), list(lt)
        assert len(bo) == len(bt) == len(lo)
        for x, y in zip(bo, bt):
            assert isinstance(x, Batch)
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f), f)
    for i in range(ours.num_imgs):
        for u, v in zip(ours.get_full_img(i), theirs.get_full_img(i)):
            np.testing.assert_array_equal(u, v)
    test_o = get_loader(get_dataset(Config(a), mode="test"), Config(a), "test")
    test_t = jget_loader(jget_dataset(JConfig(a), mode="test"), JConfig(a),
                         "test")
    for x, y in zip(test_o, test_t):
        np.testing.assert_array_equal(x.image, y.image)
        np.testing.assert_array_equal(x.rayd, y.rayd)


def test_device_prefetch_keeps_order_and_values(scenes):
    a = Config(_args(scenes["synthetic"]))
    plain = list(get_loader(get_dataset(a, mode="train", seed=5), a))
    moved = list(device_prefetch(
        get_loader(get_dataset(a, mode="train", seed=5), a), depth=2,
        device="cpu"))
    assert len(moved) == len(plain) == 2
    for x, y in zip(moved, plain):
        np.testing.assert_array_equal(x.img_idx, y.img_idx)
        for f in ("image", "rayd", "rayo", "c2w"):
            t = getattr(x, f)
            assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), getattr(y, f))
    assert list(device_prefetch([], device="cpu")) == []


def test_device_prefetch_defaults_to_the_card(scenes):
    """No device named: the card, and an error where there is none."""
    a = Config(_args(scenes["synthetic"]))
    loader = get_loader(get_dataset(a, mode="train"), a)
    if torch.cuda.is_available():
        assert next(device_prefetch(loader)).image.is_cuda
    else:
        with pytest.raises(RuntimeError, match="PAPR_PLATFORM=cpu"):
            next(device_prefetch(loader))
