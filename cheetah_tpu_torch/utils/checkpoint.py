"""Checkpoints of lattices, beams and dicts of them (counterpart of
``cheetah_tpu/utils/checkpoint.py``).

:func:`save` and :func:`load` read and write the JAX package's ``.npz``
layout: a JSON list of pytree paths under ``__paths__`` and the arrays as
``leaf_0``, ``leaf_1``, ... So a file written by the JAX package for a
``Segment`` or a beam loads into the port's counterpart, its pytree paths
(``.elements[3].k1``) mapped to module paths (``elements.3.k1``), and the
other way round. :func:`state_dict` is keyed by module paths, as
``nn.Module.state_dict``.

:func:`save_sharded` and :func:`load_sharded` go through
``torch.distributed.checkpoint`` (the counterpart of orbax): every rank
writes and restores only the shards of the ``DTensor``\\ s it holds
(:func:`cheetah_tpu_torch.parallel.process_local_beam`), with no gather on
one rank; plain tensors count as replicated and are written once.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from cheetah_tpu_torch.utils import tree


def state_dict(obj: Any) -> dict[str, np.ndarray]:
    """Every array of ``obj`` as numpy, keyed by module path."""
    return {path: tensor.detach().cpu().numpy() for path, _, tensor in tree.flatten(obj)}


def load_state_dict(obj: Any, state: dict[str, Any]) -> Any:
    """A copy of ``obj`` with the arrays of ``state`` (keyed by module path)
    in place of its own, each on the device of the tensor it replaces and in
    its own dtype. Missing keys keep the current value; keys that ``obj``
    does not have are ignored."""
    return tree.rebuild(
        obj,
        {
            path: torch.as_tensor(np.asarray(state[path]), device=tensor.device)
            for path, _, tensor in tree.flatten(obj)
            if path in state
        },
    )


def save(obj: Any, path: str) -> None:
    """Save ``obj``'s arrays with their pytree paths to an ``.npz`` file."""
    flat = [(pytree, tensor.detach().cpu().numpy()) for _, pytree, tensor in tree.flatten(obj)]
    np.savez(
        path,
        __paths__=json.dumps([pytree for pytree, _ in flat]),
        **{f"leaf_{index}": value for index, (_, value) in enumerate(flat)},
    )


def load(obj: Any, path: str) -> Any:
    """Restore a file written by :func:`save` (or by the JAX package's) into
    a template object of the same structure."""
    with np.load(path, allow_pickle=False) as data:
        paths = json.loads(str(data["__paths__"]))
        by_pytree = {pytree: data[f"leaf_{index}"] for index, pytree in enumerate(paths)}
    return load_state_dict(
        obj,
        {module: by_pytree[pytree] for module, pytree, _ in tree.flatten(obj) if pytree in by_pytree},
    )


def save_sharded(obj: Any, path: str, overwrite: bool = False) -> None:
    """Save ``obj`` with ``torch.distributed.checkpoint``: every rank writes
    its own shards. Call it on every rank, each seeing the same ``path``,
    which becomes a checkpoint directory.

    :raises FileExistsError: if ``path`` exists and ``overwrite`` is False.
    """
    import torch.distributed.checkpoint as dcp

    directory = pathlib.Path(path).resolve()
    exists = directory.exists()
    if dist.is_initialized():
        # Every rank looks before any rank writes.
        dist.barrier()
    if exists and not overwrite:
        raise FileExistsError(f"Checkpoint {directory} exists; pass overwrite=True.")
    dcp.save(
        {module: tensor for module, _, tensor in tree.flatten(obj)},
        storage_writer=dcp.FileSystemWriter(str(directory)),
    )


def load_sharded(template: Any, path: str) -> Any:
    """Restore a :func:`save_sharded` checkpoint into a copy of
    ``template``: every ``DTensor`` takes the shards of its own placements,
    so each rank reads only its own; the structure and the static
    configuration (names, grid shapes) come from the template."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor

    def empty_like(tensor: torch.Tensor) -> torch.Tensor:
        if isinstance(tensor, DTensor):
            return DTensor.from_local(
                torch.empty_like(tensor.to_local()), tensor.device_mesh, tensor.placements,
                run_check=False, shape=tensor.shape, stride=tensor.stride(),
            )
        return torch.empty_like(tensor)

    state = {module: empty_like(tensor) for module, _, tensor in tree.flatten(template)}
    dcp.load(state, storage_reader=dcp.FileSystemReader(str(pathlib.Path(path).resolve())))
    return tree.rebuild(template, state)
