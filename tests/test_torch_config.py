"""The port's config loader against papr_tpu.config on every scene YAML."""

import glob
import os

import pytest

pytest.importorskip("jax")

from papr_tpu import config as jconfig
from papr_tpu.config import load_config as jax_load
from papr_tpu_torch import config as tconfig
from papr_tpu_torch.config import Config, load_config, merge_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = sorted(glob.glob(os.path.join(ROOT, "configs", "*", "*.yml")))


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    return tree


def test_all_scene_yamls_found():
    assert len(SCENES) == 14, SCENES


@pytest.mark.parametrize("scene", SCENES,
                         ids=[os.path.relpath(s, ROOT) for s in SCENES])
def test_scene_merge_equals_jax(scene):
    """Deep-merged default + scene config: exact equality of the trees."""
    assert _plain(load_config(scene)) == _plain(jax_load(scene))


def test_overrides_and_datasets_merge_equal_jax():
    over = {"tpu": {"topk_impl": "cull"}, "geoms": {"points": {"select_k": 7}},
            "test": {"datasets": [{"name": "testset", "factor": 2},
                                  {"name": "extra", "path": "x"}]}}
    got = load_config(overrides=over)
    assert _plain(got) == _plain(jax_load(overrides=over))
    assert got.get_path("tpu.topk_impl") == "cull"
    assert got.get_path("tpu.nope.deeper", 3) == 3
    assert got.geoms.points.select_k == 7
    names = [d["name"] for d in got.test.datasets]
    assert names == ["testset", "extra"]
    assert got.test.datasets[1]["mode"] == "test"     # cloned from entry 0


def test_merge_overwrites_non_dataset_lists():
    base = {"a": [1, 2], "b": {"c": 1}}
    merge_config(base, {"a": [3], "b": {"d": 2}})
    assert base == {"a": [3], "b": {"c": 1, "d": 2}}
    assert isinstance(Config(base).b, Config)


@pytest.mark.parametrize("scene", SCENES,
                         ids=[os.path.relpath(s, ROOT) for s in SCENES])
def test_eval_and_test_configs_equal_jax(scene):
    """make_eval_config and make_test_config (one per test dataset) give the
    JAX package's trees, and leave the training config untouched."""
    cfg, jcfg = load_config(scene), jax_load(scene)
    before = _plain(cfg)
    ev = tconfig.make_eval_config(cfg)
    assert _plain(ev) == _plain(jconfig.make_eval_config(jcfg))
    assert ev.dataset.mode == cfg.eval.dataset.mode
    assert len(cfg.test.datasets) >= 1
    for entry, jentry in zip(cfg.test.datasets, jcfg.test.datasets):
        got = tconfig.make_test_config(cfg, entry)
        assert _plain(got) == _plain(jconfig.make_test_config(jcfg, jentry))
        assert got.dataset.name == entry["name"]
    assert _plain(cfg) == before
