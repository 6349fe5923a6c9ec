"""The device mesh of the port, and the data-parallel embed.

Counterpart of `facerecognitionpipeline_tpu/parallel/mesh.py`. The JAX
package drives its mesh from one controller process; so does the port: a
`Mesh` is a grid of `torch.device`s that one process launches on, with
the axes ('data', 'model') of `make_mesh`. Work on a shard runs on that
shard's device (its current stream) and results are gathered onto the
mesh's first device. A mesh may name one device more than once (the CPU
tests use `[cpu] * n`, a one-card run `[cuda:0] * n`): the shards then run
one after the other on that device, through the same code.

`Sharded` is a tensor split along its first axis into one contiguous block
per device of a mesh axis (the row-sharded gallery).
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.utils.device import resolve_device


def canonical_device(device) -> torch.device:
    """`device` with its index: 'cuda' names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A grid of devices with named axes: `.devices` is a numpy object array
    of `torch.device` of shape `[len(axis)...]`, `.shape` maps each axis
    name to its size, as on a `jax.sharding.Mesh`."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.empty(np.shape(devices), dtype=object)
        for i, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[i] = canonical_device(resolve_device(d))
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"devices of shape {grid.shape} do not match axes {tuple(axis_names)}"
            )
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    @property
    def first(self) -> torch.device:
        """The device results are gathered onto."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along `axis`, every other axis at index 0: the device
        of each shard of an array split over `axis`."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no '{axis}' axis (axes: {self.shape})")
        index = [0] * len(self.axis_names)
        index[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(index)])

    def distinct_devices(self) -> list[torch.device]:
        """Each device of the mesh once, in mesh order."""
        out: list = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(data: Optional[int] = None, model: int = 1, devices=None) -> Mesh:
    """('data', 'model') mesh over `devices` (default: every CUDA device,
    each once). data=None takes every device the model axis leaves."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices= (e.g. [torch.device('cpu')] * n)"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if data is None:
        data = len(devices) // model
    use = data * model
    if use < 1 or use > len(devices):
        raise ValueError(
            f"mesh data={data} x model={model} needs {max(use, model)} "
            f"devices, have {len(devices)}"
        )
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(devices[:use]):
        grid[i // model, i % model] = d
    return Mesh(grid, ("data", "model"))


class Sharded:
    """A tensor split along axis 0 into `blocks`, one contiguous tensor per
    shard (each on its own device), all of the same shape."""

    def __init__(self, blocks: Sequence[torch.Tensor]):
        self.blocks = [b.contiguous() for b in blocks]
        if len({tuple(b.shape) for b in self.blocks}) != 1:
            raise ValueError("Sharded blocks must share one shape")

    @classmethod
    def split(cls, tensor: torch.Tensor, devices: Sequence[torch.device]) -> "Sharded":
        n = len(devices)
        if tensor.shape[0] % n:
            raise ValueError(f"{tensor.shape[0]} rows do not split over {n} shards")
        rows = tensor.shape[0] // n
        return cls([tensor[i * rows:(i + 1) * rows].to(d) for i, d in enumerate(devices)])

    @property
    def shape(self) -> tuple:
        b = self.blocks[0]
        return (b.shape[0] * len(self.blocks), *b.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on one device."""
        return torch.cat([b.to(device) for b in self.blocks])


def shard_rows(x, devices: Sequence[torch.device]):
    """`x` (a tensor, a `Sharded` or an (int8 codes, scales) pair of either)
    as blocks per device: Sharded, or a pair of Sharded."""
    if isinstance(x, tuple):
        return tuple(shard_rows(v, devices) for v in x)
    if isinstance(x, Sharded):
        if len(x.blocks) != len(devices):
            raise ValueError(f"{len(x.blocks)} shards for a mesh axis of {len(devices)}")
        return Sharded([b.to(d) for b, d in zip(x.blocks, devices)])
    return Sharded.split(x, devices)


def shard_blocks(x, i: int):
    """Shard `i` of `shard_rows`' result (a tensor, or a pair of tensors)."""
    if isinstance(x, tuple):
        return tuple(shard_blocks(v, i) for v in x)
    return x.blocks[i]


def replicate(obj, device):
    """`obj` (a detector, an embedder, a module or a tensor) with its
    weights on `device`. On the device it already uses, the object itself,
    not a copy; elsewhere a shallow copy whose tensors and modules are
    copied to `device` (its `device` attribute set to it)."""
    device = canonical_device(device)
    if isinstance(obj, torch.nn.Module):
        params = list(obj.parameters()) + list(obj.buffers())
        if not params or canonical_device(params[0].device) == device:
            return obj
        return copy.deepcopy(obj).to(device)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if canonical_device(obj.device) == device:
        return obj
    new = copy.copy(obj)
    for k, v in vars(obj).items():
        setattr(new, k, _moved(v, device))
    new.device = device
    return new


def _moved(v, device):
    if isinstance(v, (torch.nn.Module, torch.Tensor)):
        return replicate(v, device)
    if isinstance(v, list):
        return [_moved(x, device) for x in v]
    if isinstance(v, tuple):
        return tuple(_moved(x, device) for x in v)
    return v


def data_parallel_embed(embedder, mesh: Mesh):
    """Batch-split embedding forward: one weight replica per device of the
    'data' axis, faces split on it, features gathered back onto the mesh's
    first device. Returns fn(faces_rgb [B,H,W,3]) -> (features [B,512],
    norms [B,1]); B must be a multiple of the 'data' axis."""
    devices = mesh.axis_devices("data")
    replicas = [replicate(embedder, d) for d in devices]
    home = mesh.first

    def embed(faces_rgb):
        faces = torch.as_tensor(np.asarray(faces_rgb) if not isinstance(
            faces_rgb, torch.Tensor) else faces_rgb)
        n = len(devices)
        if faces.shape[0] % n:
            raise ValueError(
                f"batch of {faces.shape[0]} faces is not a multiple of the "
                f"mesh 'data' axis ({n})"
            )
        per = faces.shape[0] // n
        feats, norms = [], []
        for i, (rep, d) in enumerate(zip(replicas, devices)):
            f, nm = rep.embed_batch_device(faces[i * per:(i + 1) * per].to(d).float())
            feats.append(f.to(home))
            norms.append(nm.to(home))
        return torch.cat(feats), torch.cat(norms)

    return embed
