"""A `torch.distributed` process group under the names of JAX's one-axis
mesh and its `lax` collectives, and `spawn`, which starts the ranks.

JAX runs one controller over a `Mesh` with `shard_map`; PyTorch runs one
process a rank, each running the same code. `Mesh` wraps the default
process group so that each line of `sharded.py` and `sharded_build.py`
reads against its JAX line:

* `axis_index()` is this rank's index (`lax.axis_index`);
* `all_gather(x)` stacks every rank's `x` on a new leading axis, as
  `lax.all_gather` returns it;
* `pmin(x)` / `pmax(x)` reduce elementwise over the ranks;
* `ppermute(x, pairs)` sends `x` from `src` to `dst` for each pair; a rank
  that no pair sends to receives zeros, as under `lax.ppermute`.

The caller names the backend: NCCL when each rank has its own card, gloo
for CPU tensors and for ranks that share one card (NCCL refuses two ranks
on one card). Gloo moves host memory, so under gloo a CUDA tensor is
copied to the host and back around each collective; the kernels still run
on the card.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class Mesh:
    """The initialised default process group as a one-axis mesh."""

    def __init__(self):
        if not dist.is_initialized():
            raise RuntimeError("no process group: start the ranks with comm.spawn, or call "
                               "torch.distributed.init_process_group first")
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()

    def axis_index(self) -> int:
        return self.rank

    def _wire(self, x):
        """`x` as the backend takes it: on the host under gloo; bools as
        bytes (neither backend reduces a bool)."""
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        if self.backend == "gloo" and x.is_cuda:
            x = x.cpu()
        return x.contiguous()

    def all_gather(self, x):
        """Every rank's `x`, stacked on a new leading axis [p, *x.shape]."""
        w = self._wire(x)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w)
        return torch.stack(parts).to(device=x.device, dtype=x.dtype)

    def _reduce(self, x, op):
        w = self._wire(x)
        w = w.clone() if w is x else w
        dist.all_reduce(w, op=op)
        return w.to(device=x.device, dtype=x.dtype)

    def pmin(self, x):
        """Elementwise min over the ranks. On floats the backends give no
        order for +0.0 against -0.0: reduce `aabb.min_key`s where the sign
        of a zero matters."""
        return self._reduce(x, dist.ReduceOp.MIN)

    def pmax(self, x):
        return self._reduce(x, dist.ReduceOp.MAX)

    def ppermute(self, x, pairs):
        """`x` sent along each (src, dst) pair; zeros where no pair arrives.
        Sources and destinations must each be distinct."""
        pairs = list(pairs)
        if len({s for s, _ in pairs}) != len(pairs) or len({d for _, d in pairs}) != len(pairs):
            raise ValueError(f"ppermute needs a permutation, got {pairs}")
        dst = [d for s, d in pairs if s == self.rank]
        src = [s for s, d in pairs if d == self.rank]
        if src == [self.rank]:  # its own pair: nothing else leaves or arrives
            return x.clone()
        w = self._wire(x)
        recv = torch.zeros_like(w)
        ops = ([dist.P2POp(dist.isend, w, d) for d in dst]
               + [dist.P2POp(dist.irecv, recv, s) for s in src])
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return recv.to(device=x.device, dtype=x.dtype)


def _rank_device(device: str, backend: str, rank: int) -> torch.device:
    """The device of `rank`: the CPU, its own card under NCCL, or the
    cards in turn under gloo (ranks may share one)."""
    if device == "cpu":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % torch.cuda.device_count())


def _check_launch(world: int, device: str, backend: str) -> None:
    if world < 1:
        raise ValueError(f"world size {world} < 1")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: use 'gloo' or 'nccl'")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: use 'cpu' or 'cuda'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is false")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("NCCL moves CUDA tensors: use backend=\"gloo\" for device='cpu'")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(f"NCCL needs one card a rank: {world} ranks, {cards} card(s); "
                             f"ranks that share a card run with backend=\"gloo\"")


def _rank_main(rank, world, init, backend, device, timeout, call, results):
    """One rank: join the group, run `fn(device, *args)` from the `call`
    file, report."""
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)  # written by this rank's parent
        dev = _rank_device(device, backend, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:  # ranks share the host's cores: spinning thread pools would stall each other
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            value = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:  # the rank's boundary: report it, the parent raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, device: str = "cuda", backend: str | None = None, args=(),
          timeout: float = 300.0):
    """Run `fn(device, *args)` on `world` ranks, one process each, inside
    an initialised process group (rendezvous through a file in a fresh
    temporary directory, so concurrent launches never share a port), and
    return the ranks' results in rank order. The ranks run on the card
    unless `device` is "cpu"; `backend` is NCCL on the card and gloo on the
    CPU unless named (ranks that share a card need "gloo"). `fn` must be
    importable by its module path and return picklable values (numpy
    arrays, not CUDA tensors). A rank that raises fails the launch with its
    traceback; when `timeout` seconds pass first (also the group's
    collective timeout), every rank is killed and TimeoutError raised."""
    backend = backend or ("gloo" if device == "cpu" else "nccl")
    _check_launch(world, device, backend)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="tpu_bvh_torch_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        # the function and its arguments go through a file, so that no start()
        # waits for a child to import modules before it drains the pipe
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, init, backend, device, timeout, call, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            got, failed, grace = {}, {}, None
            while len(got) + len(failed) < world:  # drain the queue before any join
                now = time.monotonic()
                if grace is not None and now > grace:
                    break  # the rest wait on the failed ranks: report what failed
                if now >= deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} still running after "
                                       f"{timeout} s; killed")
                try:
                    rank, ok, value = results.get(timeout=min(deadline - now, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and r not in failed and p.exitcode]
                    if dead:
                        raise RuntimeError(f"rank(s) {dead} of {fn.__name__} died "
                                           f"(exit codes {[procs[r].exitcode for r in dead]})")
                    continue
                if ok:
                    got[rank] = value
                else:  # the others may fail in turn for the lost peer: wait a moment for them
                    failed[rank] = value
                    grace = grace or time.monotonic() + 3.0
            if failed:
                raise RuntimeError(f"rank(s) {sorted(failed)} of {fn.__name__} failed:\n"
                                   + "\n".join(f"rank {r}: {failed[r]}" for r in sorted(failed)))
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
            return [got[r] for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(5.0)
            results.close()
