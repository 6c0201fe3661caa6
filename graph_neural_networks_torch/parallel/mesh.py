"""The ('data', 'graph') device mesh of the single-controller parallel path.

The counterpart of the JAX package's ``parallel/mesh.py``. A
:class:`Mesh` is an ndarray of ``torch.device``s with one name per axis,
and ``mesh.shape[axis]`` is that axis's size, as for
``jax.sharding.Mesh``. One process drives every device of the mesh: the
sharded functions of this package loop over the mesh's coordinates and
copy halo strips between the shards' devices explicitly.

A device may appear more than once. That is the only difference from
``jax.sharding.Mesh``, and the counterpart of JAX's virtual device count
(``--xla_force_host_platform_device_count``): four graph shards run on
one card with ``devices=[cuda:0] * 4``, eight on the CPU with
``[cpu] * 8``. Across cards a halo copy is a peer copy; on one card it is
a device-local copy.

The JAX module's ``data_sharding`` and ``replicated`` are GSPMD
annotations (a NamedSharding for XLA to place collectives by) and have no
counterpart here: a sharded function places each shard's operands
itself.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch


def normalize_device(device) -> torch.device:
    """`device` as a torch.device with its index filled in ("cuda" is the
    current card), so two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A named array of devices: ``devices`` (ndarray of torch.device),
    ``axis_names``, ``shape`` (axis name -> size, in axis order) and
    ``home``, the first device, where the sharded functions take their
    global inputs and leave their global outputs."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = np.vectorize(normalize_device, otypes=[object])(
            devices)
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def home(self) -> torch.device:
        return self.devices.flat[0]

    @property
    def size(self) -> int:
        return self.devices.size

    def grid(self, axis: str, data_axis: Optional[str] = None) -> list:
        """The devices of the (data, axis) plane as a list of rows:
        ``grid[d][p]`` is the device of data slice d and shard p along
        `axis`, at coordinate 0 on every other axis (one row when
        data_axis is None)."""
        index = [0] * self.devices.ndim
        names = list(self.axis_names)
        index[names.index(axis)] = slice(None)
        if data_axis is not None:
            index[names.index(data_axis)] = slice(None)
        plane = self.devices[tuple(index)]
        if data_axis is None:
            return [list(plane)]
        if names.index(data_axis) > names.index(axis):
            plane = plane.T
        return [list(row) for row in plane]

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, home={self.home})"


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data", "graph"),
              devices=None) -> Mesh:
    """A mesh over `devices` (every CUDA device when None; that raises on a
    machine without CUDA, as ``utils.device.resolve_device`` does).

    shape=None picks (n_devices, 1, ...); pass e.g. (2, 4) for 2-way data x
    4-way graph parallelism. Devices may repeat (see the module
    docstring): ``make_mesh((1, 4), devices=[torch.device("cuda:0")] * 4)``.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; pass devices= "
                "(e.g. [torch.device('cpu')] * 8) for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} needs "
                         f"{int(np.prod(shape))} devices, got {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def halo_strips(shards: list, halo: int) -> list:
    """The halo exchange of a ring of shards, (..., bs) blocks in shard
    order, each on its own device: for each shard, (the last `halo` nodes
    of its left neighbour, the first `halo` of its right one), copied to
    its device, zeros beyond the global ends (the boundary condition of
    JAX's non-circular ``ppermute``)."""
    out = []
    for p, t in enumerate(shards):
        zeros = t.new_zeros(t.shape[:-1] + (halo,))
        left = shards[p - 1][..., -halo:].to(t.device) if p else zeros
        right = (shards[p + 1][..., :halo].to(t.device)
                 if p + 1 < len(shards) else zeros)
        out.append((left, right))
    return out


def halo_ext(shards: list, halo: int) -> list:
    """Each shard's (..., bs) block extended to (..., bs + 2*halo) by its
    halo strips (:func:`halo_strips`)."""
    if halo == 0:
        return shards
    return [torch.cat([left, t, right], dim=-1)
            for t, (left, right) in zip(shards, halo_strips(shards, halo))]


def halo_fold(shards_ext: list, halo: int) -> list:
    """The transpose of :func:`halo_ext`: each shard's (..., bs + 2*halo)
    block folded back to (..., bs) on its device. The left `halo` columns
    of shard p are added to the last `halo` of shard p - 1, its right ones
    to the first `halo` of shard p + 1 (each strip copied to the owner's
    device); the strips past the global ends are dropped, as the zeros of
    JAX's non-circular ``ppermute`` are (the JAX package's ``halo_fold``,
    parallel/attention.py)."""
    if halo == 0:
        return shards_ext
    out = []
    for p, t in enumerate(shards_ext):
        mid = t[..., halo:-halo].clone()
        if p + 1 < len(shards_ext):   # the right neighbour's left strip
            mid[..., -halo:] += shards_ext[p + 1][..., :halo].to(t.device)
        if p:                         # the left neighbour's right strip
            mid[..., :halo] += shards_ext[p - 1][..., -halo:].to(t.device)
        out.append(mid)
    return out
