"""The checks that decide `correct`: what a sample of the window's outputs reads
against the plain reference.

A mix names its check (`"check": {"entry": "benchmark.checks:trees", ...}`),
called as `check(sample, scene, inputs, config, traffic, seed)` after the
window with `sample` a list of (step, input index, output); it returns one
dict of readings an output (`benchmark/reference/compare.py` names them). The
configuration names its reference builder (`"reference"`), called as
`reference(tris, config)`.
"""
from __future__ import annotations

import torch

from benchmark import entry
from benchmark.reference import compare
from benchmark.reference import traverse as ref_traverse


def trees(sample, scene, inputs, config, traffic, seed) -> list:
    """Each sampled build against the reference's tree of the same frame."""
    reference = entry(config["reference"])
    refs, per = {}, []
    for _, f, out in sample:
        if f not in refs:
            refs[f] = reference(scene.frames[f], config)
        per.append(compare.trees(out, refs[f]))
    return per


def hits(sample, scene, inputs, config, traffic, seed) -> list:
    """Each sampled traversal call's hits of `check.rays` rays, drawn from the
    seed and the step, against the reference's closest hits through the
    reference's own tree of the mix's frame."""
    tris = scene.frames[traffic["frame"]]
    tree = entry(config["reference"])(tris, config)
    n = inputs.n_rays
    k = min(traffic["check"]["rays"], n)
    per = []
    for i, p, out in sample:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(seed) * 1000003 + i)
        sel = torch.randperm(n, generator=gen)[:k].to(tris.device)
        want = ref_traverse.closest_hits(tree, tris, inputs.origin[p][sel],
                                         inputs.direction[p][sel])
        per.append(compare.hits(tuple(x[sel] for x in out), want))
    return per
