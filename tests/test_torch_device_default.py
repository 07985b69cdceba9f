"""The port's entry points run on the card unless the caller asks for the
CPU: with no device named and no card they raise, and never hand back CPU
tensors. (On a machine with a card the same calls return CUDA tensors.)"""

import numpy as np
import pytest
import torch

from papr_tpu_torch import convert
from papr_tpu_torch.config import load_config
from papr_tpu_torch.device import platform_device, resolve_device
from papr_tpu_torch.model import lpips
from papr_tpu_torch.model.papr import create_model
from papr_tpu_torch.train.losses import build_loss

OVER = {"max_num_pts": 40, "geoms": {"points": {"init_num": 30}}}

CALLS = {
    "create_model": lambda: create_model(load_config(overrides=OVER))[0]["points"],
    "build_loss": lambda: build_loss(load_config(overrides=OVER)).params["lpips"]["lins"][0],
    "random_lpips_params": lambda: lpips.random_lpips_params(0)["lins"][0],
    "load_lin_params": lambda: lpips.load_lin_params()[0],
    "to_torch": lambda: convert.to_torch({"a": np.zeros(2, np.float32)})["a"],
    "from_jax_lpips_params": lambda: convert.from_jax_lpips_params(
        {"convs": [{"w": np.zeros((3, 3, 3, 4), np.float32),
                    "b": np.zeros(4, np.float32)}],
         "lins": [np.zeros(4, np.float32)]})["lins"][0],
    "resolve_device": lambda: torch.zeros(1, device=resolve_device()),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_no_device_means_the_card(name):
    if torch.cuda.is_available():
        assert CALLS[name]().is_cuda
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            CALLS[name]()


def test_platform_variable(monkeypatch):
    monkeypatch.setenv("PAPR_PLATFORM", "cpu")
    assert platform_device() == torch.device("cpu")
    monkeypatch.setenv("PAPR_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="PAPR_PLATFORM"):
        platform_device()
    monkeypatch.delenv("PAPR_PLATFORM")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="PAPR_PLATFORM=cpu"):
            platform_device()
    assert resolve_device("cpu") == torch.device("cpu")
    params, state = create_model(load_config(overrides=OVER), device="cpu")
    assert not params["points"].is_cuda and not state["alive"].is_cuda
