"""The culled top-k's stage 3 wrapper (``ops/tile_cull.py cull_select``,
kernel ``csrc/cull_topk.cu``) keeps its contract with the library at the
serving shape (2500 tiles of 256 rays, M = 2048, chunk 512, early exit) and
at the training shape (100 tiles, one 2048 chunk, no exit): one launch of
``papr_cull_topk`` with its signature's argument count, the tensors'
pointers, T, TR, M, chunk, k, the exit flag and a (T, TR, k) int32 output,
counted once. Wrappers run on CPU tensors that read as CUDA tensors against
a stand-in library (nothing runs on a card)."""

import types

import pytest
import torch

from papr_tpu_torch.kernels import build
from papr_tpu_torch.ops import tile_cull as tc


class _OnCard(torch.Tensor):
    @property
    def is_cuda(self):
        return True


class _Lib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        sig = build.SIGNATURES[name]

        def launch(*args):
            assert len(args) == len(sig), (name, len(args), len(sig))
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def lib(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return lib


@pytest.mark.parametrize("T,chunk,early_exit,k", [
    (2500, 512, True, 20),        # an 800x800 serving frame
    (100, 2048, False, 20),       # a 160x160 training patch
    (100, 2048, False, 30),       # configs/nerfsyn/hotdog.yml's k
])
def test_cull_select_passes_its_contract(lib, T, chunk, early_exit, k):
    TR, M = 256, 2048
    card = lambda x: x.as_subclass(_OnCard)
    tiles = card(torch.empty(T, TR, 3))
    f = card(torch.empty(T, TR))
    recs = card(torch.empty(T, 8, M))
    n = tc.cull_select.launches
    out = tc.cull_select(tiles, f, recs, k, chunk, early_exit)
    assert tc.cull_select.launches == n + 1
    (name, a), = lib.calls
    assert name == "papr_cull_topk"
    assert a[:3] == (tiles.data_ptr(), f.data_ptr(), recs.data_ptr())
    assert a[3:9] == (T, TR, M, chunk, k, int(early_exit))
    assert a[9] == out.data_ptr()
    assert tuple(out.shape) == (T, TR, k) and out.dtype == torch.int32


def test_cull_select_refuses_what_the_kernel_does_not_take(lib):
    card = lambda x: x.as_subclass(_OnCard)
    tiles, f = card(torch.empty(4, 256, 3)), card(torch.empty(4, 256))
    with pytest.raises(NotImplementedError):
        tc.cull_select(tiles, f, card(torch.empty(4, 8, 2048)), 65, 512, True)
    with pytest.raises(NotImplementedError):
        tc.cull_select(tiles, f, card(torch.empty(4, 8, 1000)), 20, 512, True)
    assert not lib.calls
