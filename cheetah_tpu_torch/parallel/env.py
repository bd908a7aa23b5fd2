"""Vectorised lattice-tuning environments (counterpart of
``cheetah_tpu/parallel/env.py``).

Reinforcement-learning magnet tuning runs thousands of lattice instances in
lockstep: a batch of settings is a ``(num_instances, num_tunables)`` tensor,
and one env step tracks the beam through the lattice with per-instance
settings and returns the per-instance observations and rewards. In the
port's explicit SPMD (:mod:`cheetah_tpu_torch.parallel.collectives`) a rank
passes its own rows of the settings (:func:`~cheetah_tpu_torch.parallel.shard_beam`'s
instance axis) and gets its own rows back; instances are independent, so a
step issues no collective.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Sequence

import torch
from torch import nn

from cheetah_tpu_torch.particles import Beam
from cheetah_tpu_torch.utils.profiling import span


class BatchedLatticeEnv(nn.Module):
    """A batch of lattice-tuning environments evaluated in lockstep.

    :param segment: Lattice to tune. Element topology is shared; the tuned
        parameters are set per instance.
    :param incoming: Beam entering the lattice (shared across instances).
    :param tunables: Sequence of ``(element_name, attribute)`` pairs, e.g.
        ``[("AREAMQZM1", "k1"), ("AREAMCHM1", "angle")]``; each attribute is
        a parameter (buffer) of an element of ``segment``.
    :param objective: Function ``(outgoing_beam, readings) -> (...,)`` reward
        per instance. Defaults to the negative transverse beam size.
    :param moments_only: When ``True``, track with
        :meth:`Segment.track_moments`; the objective then receives a
        :class:`ParameterBeam` and ``readings`` is empty. Use only when the
        reward is moment-based.

    The settings are applied for the duration of a step by assignment to the
    elements' parameters and restored afterwards: no copy of the lattice,
    and each element reacts to the assignment as to any other (a Cavity
    decides from a tuned voltage whether it fuses).

    Gradients over a sharded particle axis (a ``SpaceChargeKick`` with
    ``particle_axis`` in ``segment``) follow the kick's convention: each
    rank differentiates its own share of the reward, and the gradients of
    replicated settings are then all-reduced. Over the instance axis every
    rank's rows are its own, and :meth:`grad_step` needs no collective.
    """

    def __init__(
        self,
        segment: nn.Module,
        incoming: Beam,
        tunables: Sequence[tuple[str, str]],
        objective: Callable | None = None,
        moments_only: bool = False,
    ) -> None:
        super().__init__()
        self.segment = segment
        self.incoming = incoming
        self.tunables = tuple((str(element), str(attribute)) for element, attribute in tunables)
        self.objective = objective
        self.moments_only = bool(moments_only)
        for element_name, attribute in self.tunables:
            element = getattr(segment, element_name)
            if attribute not in element._buffers:
                raise ValueError(
                    f"{element_name}.{attribute} is not a parameter of "
                    f"{type(element).__name__}: {sorted(element._buffers)}."
                )

    @property
    def num_tunables(self) -> int:
        return len(self.tunables)

    @contextlib.contextmanager
    def _with_settings(self, settings: torch.Tensor) -> Iterator[nn.Module]:
        """The segment with per-instance tunable values applied, for the
        ``with`` block. ``settings`` has shape ``(..., num_tunables)``; its
        leading dims become the vectorisation dims of the lattice parameters.
        """
        if settings.shape[-1] != self.num_tunables:
            raise ValueError(
                f"settings have {settings.shape[-1]} columns for {self.num_tunables} tunables."
            )
        elements = [getattr(self.segment, name) for name, _ in self.tunables]
        saved = [getattr(element, attribute) for element, (_, attribute) in zip(elements, self.tunables)]
        try:
            for index, (element, (_, attribute)) in enumerate(zip(elements, self.tunables)):
                setattr(element, attribute, settings[..., index])
            yield self.segment
        finally:
            for element, (_, attribute), value in zip(elements, self.tunables, saved):
                setattr(element, attribute, value)

    def step(self, settings: torch.Tensor) -> tuple[Beam, dict[str, torch.Tensor], torch.Tensor]:
        """Evaluate one step: track with per-instance ``settings``.

        :return: ``(outgoing_beam, readings, reward)`` where reward has the
            settings' leading (instance) shape.
        """
        with span("ctt.env.step"):
            with self._with_settings(settings) as segment:
                if self.moments_only:
                    outgoing, readings = segment.track_moments(self.incoming), {}
                else:
                    outgoing, readings = segment.track_with_readings(self.incoming)
            with span("ctt.env.readout"):
                if self.objective is not None:
                    reward = self.objective(outgoing, readings)
                else:
                    reward = -torch.hypot(outgoing.sigma_x, outgoing.sigma_y)
            return outgoing, readings, reward

    def forward(self, settings: torch.Tensor) -> tuple[Beam, dict[str, torch.Tensor], torch.Tensor]:
        return self.step(settings)

    def reward(self, settings: torch.Tensor) -> torch.Tensor:
        """Reward only (convenient for ``torch.autograd`` and ``torch.func``)."""
        return self.step(settings)[2]

    def grad_step(
        self, settings: torch.Tensor, learning_rate: float | torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One gradient-ascent update of all instances in lockstep.

        The gradient is ``torch.func.grad`` of the summed reward, as the JAX
        package takes ``jax.grad``: ``torch.compile`` traces it into the
        step's program, where it would stop at ``torch.autograd.grad``.

        :return: ``(new_settings, reward)``, both detached.
        """

        def total_reward(settings):
            reward = self.reward(settings)
            return reward.sum(), reward

        with span("ctt.env.grad_step"):
            grads, reward = torch.func.grad(total_reward, has_aux=True)(settings.detach())
            return settings.detach() + learning_rate * grads, reward.detach()
