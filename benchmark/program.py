"""The system under test: the port's public entries that a cell's window drives.

This is the only module of the harness that imports the program, and it does so
when a cell is set up. A configuration names its builder (`entry`); a traffic
mix names its step class here (`steps`) and, for traced rays, the packing and
traversal entries. A step class is built as `Steps(config, traffic, scene,
inputs, device)`, has `inputs` (how many distinct inputs the window cycles) and
`work_per_step`, and its call `steps(i)` returns (its input's index, what the
program produced), which the mix's check compares.
"""
from __future__ import annotations

import importlib

import torch

from benchmark import entry

FLT_MAX = 3.402823466e38


class BuildSteps:
    """A full build of the next frame, cycling the scene's frames."""

    def __init__(self, config: dict, traffic: dict, scene, inputs, device):
        self.build = entry(config["entry"])
        self.frames = scene.frames
        self.inputs = len(self.frames)
        self.work_per_step = 1

    def __call__(self, i: int):
        f = i % self.inputs
        return f, self.build(self.frames[f])


class TraceSteps:
    """One traversal call over the next pose's rays, cycling the poses, against
    the tree the configuration's builder made of one frame in set-up."""

    def __init__(self, config: dict, traffic: dict, scene, inputs, device):
        types = importlib.import_module("tpu_bvh_torch.types")
        tris = scene.frames[traffic["frame"]]
        bvh = entry(config["entry"])(tris)
        self.packed = entry(traffic["pack"])(bvh, tris)
        self.n_internal, self.root = bvh.n_internal, bvh.root
        self.trace = entry(traffic["trace"])
        self.transform = types.identity_transform(device)
        n = inputs.n_rays
        tmin = torch.zeros(n, dtype=torch.float32, device=device)
        tmax = torch.full((n,), FLT_MAX, dtype=torch.float32, device=device)
        self.rays = [types.Rays(o, d, tmin, tmax) for o, d in zip(inputs.origin, inputs.direction)]
        self.inputs = len(self.rays)
        self.work_per_step = n

    def __call__(self, i: int):
        p = i % self.inputs
        hit, _visits = self.trace(self.packed, self.n_internal, self.root, self.rays[p],
                                  self.transform)
        return p, (hit.prim_idx, hit.t, hit.u, hit.v)
