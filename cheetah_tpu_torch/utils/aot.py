"""Ahead-of-time export (the deployment path; counterpart of
``cheetah_tpu/utils/aot.py``).

The JAX package serialises a tracking computation with ``jax.export`` and
passes abstract arguments (shapes and dtypes, the particle axis symbolic)
so that one artifact serves any particle count. The port does the same
with ``torch.export``: a :class:`TrackReadout` module holds the lattice
(its parameters become the program's buffers) and takes the beam's tensors
as arguments (:func:`beam_arguments`); the abstract side is the
``dynamic_shapes`` argument of ``torch.export.export``, which
:func:`abstract_like` (every dimension static) and
:func:`symbolic_particle_beam` (the particle axis a ``torch.export.Dim``)
build::

    from cheetah_tpu_torch.utils import aot

    step = aot.TrackReadout(segment, "sigma_x", beam.species)
    exported = torch.export.export(
        step, aot.beam_arguments(beam), dynamic_shapes=aot.symbolic_particle_beam(beam)
    )
    torch.export.save(exported, "step.pt2")  # one artifact, any N at call time
    torch.export.load("step.pt2").module()(*aot.beam_arguments(other_beam))

The counterpart of JAX's ahead-of-time ``lower(...).compile()`` and its
cost analysis: ``exported.module()`` runs the traced program without
tracing the lattice again, and
:func:`cheetah_tpu_torch.utils.profiling.compiled_stats` counts one call's
FLOPs and bytes. The lattice is traced as it stands: settings that the
port decides on the host when they are assigned (a cavity's voltage, the
tracking methods, which elements are active) are fixed in the program, as
the JAX package's static fields are fixed in its artifact.

The counterpart of compiling the artifact with XLA is AOTInductor: it
compiles an exported program into a package (the kernels Inductor
generates, a C++ wrapper, the lattice as constants) that runs as compiled
code, not operator by operator as a loaded program does, and loads in any
process::

    package = torch._inductor.aoti_compile_and_package(
        exported, package_path="step_aoti.pt2", inductor_configs=aot.AOTI_CONFIGS
    )
    torch._inductor.aoti_load_package(package)(*aot.beam_arguments(other_beam))

A space-charge segment exports too, its particle axis symbolic: the
kick's cloud-in-cell deposit and gather (and, on a grid of the x-tiled
pair, their tile plans) are the operators ``cheetah_tpu_torch::cic_*``
(:mod:`cheetah_tpu_torch.ops.cic_kernels`), which the graph holds as
operators, as the JAX package's artifact holds its CIC primitives. Nothing
about them is decided at export: the dispatcher picks an implementation by
the device of the tensors each call gets, so the program runs the plain
versions on CPU tensors and the hand-written kernels on CUDA tensors (a
program exported with CPU tensors moves to the card with
``torch.export.passes.move_to_device_pass``). A process that loads such a
program (or an AOTInductor package of it, which calls the operators
through its proxy executor) must ``import cheetah_tpu_torch`` before
``torch.export.load`` (``aoti_load_package``), as that import registers
the operators::

    import cheetah_tpu_torch  # registers the cheetah_tpu_torch::cic_* operators

    program = torch.export.load("space_charge.pt2").module()
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from cheetah_tpu_torch.particles import ParticleBeam, Species

#: The Inductor settings that ``torch._inductor.aoti_compile_and_package``
#: needs for a lattice's exported program: keep its parameters as tensors.
#: A lattice holds its settings in 0-dimensional buffers, and Inductor
#: would inline each as a number, whose lowering fails at the first view of
#: it ("'Constant' object has no attribute 'data'" at an ``unsqueeze``,
#: ``StopIteration`` at a ``pow`` of an ``expand``).
AOTI_CONFIGS = {"always_keep_tensor_constants": True}

#: The largest particle count an exported program takes
#: (:func:`symbolic_particle_beam`): a particle index fits 32 bits.
MAX_PARTICLES = 2**31 - 1

#: The tensors of a particle beam in the order :class:`TrackReadout` takes
#: them (the JAX package's pytree order).
BEAM_FIELDS = ("particles", "energy", "particle_charges", "survival_probabilities", "s")


def beam_arguments(beam: ParticleBeam) -> tuple[torch.Tensor, ...]:
    """The beam's tensors in :data:`BEAM_FIELDS` order."""
    return tuple(getattr(beam, field) for field in BEAM_FIELDS)


class TrackReadout(nn.Module):
    """``segment.track(beam)`` followed by the beam attribute ``readout``
    (``"sigma_x"``, ``"particles"``, ...), as a module whose arguments are
    the beam's tensors, for ``torch.export``.

    :param species: The beam's species, fixed in the program.
    """

    def __init__(self, segment: nn.Module, readout: str, species: Species) -> None:
        super().__init__()
        self.segment = segment
        self.readout = readout
        self.species = species

    def forward(self, particles, energy, particle_charges, survival_probabilities, s):
        beam = ParticleBeam(
            particles, energy, particle_charges=particle_charges,
            survival_probabilities=survival_probabilities, s=s, species=self.species,
        )
        return getattr(self.segment.track(beam), self.readout)


def _tensors_of(tree: Any) -> Any:
    return beam_arguments(tree) if isinstance(tree, ParticleBeam) else tree


def abstract_like(tree: Any) -> Any:
    """The ``dynamic_shapes`` of a static export of ``tree`` (a tensor, a
    beam, or tuples, lists and dicts of them): ``None``, every dimension
    static, for each tensor, in the structure ``torch.export`` takes."""
    tree = _tensors_of(tree)
    if isinstance(tree, torch.Tensor):
        return None
    if isinstance(tree, dict):
        return {key: abstract_like(value) for key, value in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(abstract_like(value) for value in tree)
    raise TypeError(f"abstract_like takes tensors, beams and containers, not {type(tree)}.")


def symbolic_particle_beam(beam: ParticleBeam, dim: str = "n") -> tuple:
    """The ``dynamic_shapes`` of ``beam``'s tensors (:func:`beam_arguments`)
    with the particle axis symbolic, so that one exported program serves
    any particle count.

    Every axis whose size equals ``beam.num_particles`` becomes the
    ``torch.export.Dim`` named ``dim`` (particles, per-particle charges,
    survival probabilities), bounded by :data:`MAX_PARTICLES`. The bound is
    what makes an AOTInductor package right at every count: Inductor
    takes an unbounded size in such a package to fit 32-bit indexing when
    the example beam's tensors do, and checks nothing at run time, so a
    package of the env step exported from 10k particles indexed past its
    tensors at 100k (4096 x 100k x 7 elements is more than 2^31). Under a
    finite bound that lets a tensor outgrow 32-bit indices, it indexes in
    64 bits. A tensor in which MORE than one axis matches
    is ambiguous (``num_particles == 7`` colliding with the coordinate
    axis, or a batch dimension equal to the particle count) and raises:
    export from a beam whose particle count is unambiguous instead.

    :raises ValueError: on an ambiguous particle axis.
    """
    symbol = torch.export.Dim(dim, max=MAX_PARTICLES)
    num_particles = int(beam.num_particles)

    def symbolize(x: torch.Tensor):
        if sum(axis_size == num_particles for axis_size in x.shape) > 1:
            raise ValueError(
                f"ambiguous particle axis: leaf shape {tuple(x.shape)} has more "
                f"than one axis of size num_particles={num_particles} — "
                "export from a beam whose particle count differs from its "
                "other dimensions (coordinate axis 7, batch sizes)"
            )
        axes = {axis: symbol for axis, size in enumerate(x.shape) if size == num_particles}
        return axes or None

    return tuple(symbolize(x) for x in beam_arguments(beam))
