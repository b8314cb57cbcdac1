"""The port's entry points put their tensors on the GPU unless the caller
names another device: without CUDA a call that names none raises, with
CUDA its tensors lie on the GPU. The file imports no JAX, so it runs on
the GPU machine too."""
import numpy as np
import pytest
import torch

from tpu_bvh_torch.models import batched
from tpu_bvh_torch.ops import aabb
from tpu_bvh_torch.types import Rays
from tpu_bvh_torch.utils import convert, scenes


def _preset(**kw):
    tr, cam = scenes.preset("sponza", **kw)
    return list(tr) + list(cam)


def _to_torch(**kw):
    state = {f: np.zeros((4, 3), np.float32) for f in ("origin", "direction")}
    state.update(tmin=np.zeros(4, np.float32), tmax=np.ones(4, np.float32))
    return list(convert.to_torch(Rays, state, **kw))


def _pad_meshes(**kw):
    return list(batched.pad_meshes([np.zeros((2, 3, 3), np.float32)], **kw))


def _empty_aabb(**kw):
    return list(aabb.empty_aabb((2,), **kw))


@pytest.mark.parametrize("entry", [_preset, _to_torch, _pad_meshes, _empty_aabb],
                         ids=["preset", "to_torch", "pad_meshes", "empty_aabb"])
def test_entry_point_defaults_to_the_gpu(entry):
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in entry())
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            entry()
    assert all(t.device.type == "cpu" for t in entry(device="cpu"))
