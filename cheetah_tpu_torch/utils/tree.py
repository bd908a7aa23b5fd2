"""The tensors of a lattice, a beam or a dict of them, by path.

The JAX package reads and writes these objects as pytrees; the port's
elements are ``nn.Module``s with buffers and its beams plain objects. This
module flattens either into ``(module_path, pytree_path, tensor)`` triples
and builds a copy with some of the tensors replaced, for the checkpoints
(:mod:`cheetah_tpu_torch.utils.checkpoint`) and the sharding helpers
(:mod:`cheetah_tpu_torch.parallel.sharding`).

A module path is ``nn.Module``'s (``elements.3.k1``); a pytree path is the
JAX package's ``jax.tree_util.keystr`` (``.elements[3].k1``), so that both
packages read the same checkpoint files. A dict key ``"k1s"`` is the module
path ``k1s`` and the pytree path ``['k1s']``.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator

import torch
from torch import nn

from cheetah_tpu_torch.particles import ParameterBeam, ParticleBeam, Species

#: The tensor fields of each beam type and of a species, in the JAX
#: package's pytree order.
FIELDS = {
    ParticleBeam: ("particles", "energy", "particle_charges", "survival_probabilities", "s"),
    ParameterBeam: ("mu", "cov", "energy", "total_charge", "s"),
    Species: ("num_elementary_charges", "mass_eV"),
}


def _pytree_component(name: str) -> str:
    return f"[{name}]" if name.isdigit() else f".{name}"


def _join(prefix: tuple[str, str], name: str, key: str | None = None) -> tuple[str, str]:
    module_prefix, pytree_prefix = prefix
    module_path = f"{module_prefix}.{name}" if module_prefix else name
    pytree = f"[{key}]" if key is not None else "".join(
        _pytree_component(part) for part in name.split(".")
    )
    return module_path, pytree_prefix + pytree


def flatten(obj: Any, prefix: tuple[str, str] = ("", "")) -> Iterator[tuple[str, str, torch.Tensor]]:
    """Every tensor of ``obj`` with its module path and its pytree path.

    ``obj`` is an ``nn.Module`` (its buffers), a beam or species (its tensor
    fields), a dict with string keys or a list of these, or a tensor.
    Anything else holds no tensor.
    """
    if isinstance(obj, torch.Tensor):
        yield prefix[0], prefix[1], obj
    elif isinstance(obj, nn.Module):
        for name, buffer in obj.named_buffers():
            yield (*_join(prefix, name), buffer)
    elif type(obj) in FIELDS:
        for field in FIELDS[type(obj)]:
            yield from flatten(getattr(obj, field), _join(prefix, field))
        if not isinstance(obj, Species):
            yield from flatten(obj.species, _join(prefix, "species"))
    elif isinstance(obj, dict):
        for key, value in obj.items():
            yield from flatten(value, _join(prefix, str(key), repr(str(key))))
    elif isinstance(obj, (list, tuple)):
        for index, value in enumerate(obj):
            yield from flatten(value, _join(prefix, str(index)))


def rebuild(obj: Any, leaves: dict[str, torch.Tensor], prefix: str = "") -> Any:
    """A copy of ``obj`` in which every tensor whose module path is a key of
    ``leaves`` is replaced by that value; the other tensors are those of
    ``obj`` (copied with the module, not with a beam). A module is copied
    with its ``clone`` (``copy.deepcopy`` where it has none) and takes each
    new tensor through ``setattr``, so an element reacts to it as to any
    assignment."""
    if isinstance(obj, torch.Tensor):
        return leaves.get(prefix, obj)
    if isinstance(obj, nn.Module):
        copied = obj.clone() if hasattr(obj, "clone") else copy.deepcopy(obj)
        for name, _ in list(copied.named_buffers()):
            path = f"{prefix}.{name}" if prefix else name
            if path in leaves:
                owner, _, attribute = name.rpartition(".")
                setattr(copied.get_submodule(owner), attribute, leaves[path])
        return copied
    if type(obj) in FIELDS:
        values = {
            field: rebuild(getattr(obj, field), leaves, _join((prefix, ""), field)[0])
            for field in FIELDS[type(obj)]
        }
        if isinstance(obj, Species):
            species = obj.to()
            for field, value in values.items():
                setattr(species, field, value)
            return species
        species = rebuild(obj.species, leaves, _join((prefix, ""), "species")[0])
        if isinstance(obj, ParticleBeam):
            return ParticleBeam(
                values["particles"], values["energy"],
                particle_charges=values["particle_charges"],
                survival_probabilities=values["survival_probabilities"],
                s=values["s"], species=species,
            )
        return ParameterBeam(
            values["mu"], values["cov"], values["energy"],
            total_charge=values["total_charge"], s=values["s"], species=species,
        )
    if isinstance(obj, dict):
        return {
            key: rebuild(value, leaves, _join((prefix, ""), str(key))[0])
            for key, value in obj.items()
        }
    if isinstance(obj, (list, tuple)):
        return type(obj)(
            rebuild(value, leaves, _join((prefix, ""), str(index))[0])
            for index, value in enumerate(obj)
        )
    return obj


def tree_equal(a: Any, b: Any) -> bool:
    """Structural and numerical equality of two objects that
    :func:`flatten` reads (the JAX package's pytree ``tree_equal``): the
    same types, the same tensor paths, equal shapes and equal values.
    Elements are compared by ``==`` too, which adds their configuration
    (the JAX package's static fields)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, nn.Module) and a != b:
        return False
    leaves_a, leaves_b = list(flatten(a)), list(flatten(b))
    if [path for path, _, _ in leaves_a] != [path for path, _, _ in leaves_b]:
        return False
    return all(
        x.shape == y.shape and not bool(torch.any(x.detach().cpu() != y.detach().cpu()))
        for (_, _, x), (_, _, y) in zip(leaves_a, leaves_b)
    )


def replace(obj: Any, **changes: Any) -> Any:
    """A copy of ``obj`` (an element, a segment, a beam or a species, each
    copied by its ``clone``) with the attributes in ``changes`` assigned,
    the counterpart of the JAX package's functional ``replace``."""
    copied = obj.clone()
    for name, value in changes.items():
        setattr(copied, name, value)
    return copied
