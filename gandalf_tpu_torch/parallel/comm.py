"""The shard group: the port's counterpart of ``shard_map`` over a 1-D
mesh and the ``lax`` collectives that ``gandalf_tpu/parallel/`` uses.

The JAX package runs its distributed controller as one program over
``jax.devices()`` (single-controller SPMD).  The port keeps that design:
one Python process holds a list of per-shard tensors, one per shard
device, and each collective is a tensor copy between those devices.
Several shards may share one device (the CPU in the tests, one card in
``chip_smoke.py``); on a host with several cards each shard gets its own.
A multi-process NCCL backend could not hold two shards on one card (NCCL
does not let two ranks of a communicator share a GPU), so a shard layout
could not be checked against its one-shard run on a one-card machine.

A transfer to the device a tensor is already on returns the tensor
itself, so the callers never update a received tensor in place.  No
collective goes through the host unless a tensor already lives there.
``moved`` counts the bytes that each kind of collective hands from one
shard to another (the halos' ppermutes apart from the others'), whether
or not the two shards share a device.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

Tensor = torch.Tensor


class ShardGroup:
    """S shards on a list of devices (shard s on devices[s])."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a shard group needs at least one device")
        self.devices = [torch.device(d) for d in devices]
        self.moved = {}

    def _count(self, kind: str, x: Tensor, times: int = 1) -> None:
        self.moved[kind] = (self.moved.get(kind, 0)
                            + times * x.numel() * x.element_size())

    @property
    def size(self) -> int:
        return len(self.devices)

    def to(self, x: Tensor, s: int) -> Tensor:
        """`x` on shard s's device (itself where it is there already)."""
        return x.to(self.devices[s])

    def ppermute(self, xs: List[Tensor], shift: int,
                 kind: str = "ppermute") -> List[Tensor]:
        """Shard s receives the block of shard (s - shift) mod S: the
        ring permutation [(i, (i + shift) % S)] of lax.ppermute; the
        bytes count under `kind`."""
        S = self.size
        for s in range(S):
            if (s - shift) % S != s:
                self._count(kind, xs[(s - shift) % S])
        return [self.to(xs[(s - shift) % S], s) for s in range(S)]

    def all_gather(self, xs: List[Tensor], tiled: bool = False
                   ) -> List[Tensor]:
        """Every shard's blocks, stacked along a new axis 0 (tiled:
        concatenated along axis 0), on every shard."""
        join = torch.cat if tiled else torch.stack
        for x in xs:
            self._count("all_gather", x, self.size - 1)
        return [join([self.to(x, s) for x in xs]) for s in range(self.size)]

    def _reduce(self, xs: List[Tensor], op) -> List[Tensor]:
        for x in xs:
            self._count("reduce", x, self.size - 1)
        out = []
        for s in range(self.size):
            acc = self.to(xs[0], s)
            for x in xs[1:]:
                acc = op(acc, self.to(x, s))
            out.append(acc)
        return out

    def psum(self, xs: List[Tensor]) -> List[Tensor]:
        """The sum over shards (in shard order), on every shard."""
        return self._reduce(xs, torch.add)

    def pmin(self, xs: List[Tensor]) -> List[Tensor]:
        return self._reduce(xs, torch.minimum)

    def pmax(self, xs: List[Tensor]) -> List[Tensor]:
        return self._reduce(xs, torch.maximum)

    def any(self, flags: List[Tensor]) -> Tensor:
        """The OR of per-shard bool scalars, on shard 0's device (the
        pmax of an overflow flag)."""
        return self.pmax([f.to(torch.uint8) for f in flags])[0].bool()

    def all_to_all(self, xs: List[Tensor]) -> List[Tensor]:
        """lax.all_to_all(split_axis=0, concat_axis=0) of (S, M, ...)
        blocks: shard j receives row j of every shard, stacked in shard
        order."""
        S = self.size
        for i in range(S):
            for j in range(S):
                if i != j:
                    self._count("all_to_all", xs[i][j])
        return [torch.stack([self.to(xs[i][j], j) for i in range(S)])
                for j in range(S)]


def default_shard_devices() -> List[str]:
    """One entry per visible CUDA device: the counterpart of
    jax.devices() (none without a card)."""
    if not torch.cuda.is_available():
        return []
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
