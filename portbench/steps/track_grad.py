"""Step kind ``track_grad``: ``sum(px^2)`` after ``segment.track(beam)`` and
its derivative with respect to one element's parameter (the mix's
``parameter``: element, attribute and range), over a pool of that
parameter's values and the mix's ``beams`` beams: step ``i`` takes value
``i`` and beam ``i`` of each, modulo their counts."""

from __future__ import annotations

import numpy as np
import torch

from portbench import harness, reference
from portbench.reference import ParticleState


class Steps:
    """Set-up draws the beams, the pool of values and the sample of
    particles compared on ``device`` from the seed."""

    #: The derivative's rounding error is one number a step and mostly the
    #: beam's: its root mean square over the compared steps, which span the
    #: beams, is compared, and its worst step against a looser limit.
    RMS_NUMBERS = ("grad_rel_err",)

    def __init__(self, ctt, cell, seed: int, device, dtype) -> None:
        config, traffic = cell.config, cell.traffic
        self.config = config
        beam = config["beam"]
        energy = float(torch.tensor(beam["energy"], dtype=dtype))
        count = int(traffic["beams"])
        # The mix's beams in one call: each the configuration's beam.
        particles, charges = harness.make_particles(
            {**beam, "num_particles": count * beam["num_particles"]}, seed, dtype, device)
        particles = particles.view(count, -1, 7)
        charges = charges[: particles.shape[1]] * count
        self.beams = [ctt.ParticleBeam(part, energy=beam["energy"], particle_charges=charges,
                                       dtype=dtype, device=device) for part in particles]
        self.reference_beam = lambda index, rdtype: ParticleState(
            particles[index % count].to(rdtype), energy, charges.to(rdtype))
        self.segment = harness.build_segment(ctt, config, dtype, device)
        parameter = traffic["parameter"]
        self.parameter = (parameter["element"], parameter["attribute"])
        self.element = getattr(self.segment, parameter["element"])
        low, high = parameter["range"]
        pool = low + (high - low) * torch.rand(int(traffic["pool"]),
                                               generator=harness.generator(seed, 2, device),
                                               dtype=dtype, device=device)
        # One leaf a value, made now, so that a step launches nothing to
        # make its input.
        self.values = [value.clone().requires_grad_() for value in pool]
        self.pool = pool.double().cpu().tolist()
        self.sample = torch.randint(particles.shape[1], (int(traffic["particles_compared"]),),
                                    generator=harness.generator(seed, 3, device), device=device)
        self.px_in = particles[:, :, 1][:, self.sample].double().cpu().numpy()

    def step(self, index: int):
        value = self.values[index % len(self.values)]
        setattr(self.element, self.parameter[1], value)
        px = self.segment.track(self.beams[index % len(self.beams)]).px
        objective = torch.sum(torch.square(px))
        (grad,) = torch.autograd.grad(objective, value)
        return (torch.cat([objective.detach()[None], grad[None], px.detach()[self.sample]])
                .cpu().numpy(),)

    def reference(self, index: int, dtype):
        value = self.pool[index % len(self.pool)]
        objective, grad, px = reference.track_grad(
            self.config["lattice"], self.reference_beam(index, dtype), self.parameter, value,
            self.sample)
        return (torch.cat([objective[None], grad[None], px]).cpu().numpy(),)

    def readings(self, index: int, result, expected) -> dict:
        """The derivative's relative error (``grad_rel_err``, the root mean
        square over the compared steps, and ``grad_rel_err_worst``, their
        worst), and the largest error of a compared particle's outgoing
        ``px`` over the largest change of ``px`` the reference gives them
        (the kicks). The objective itself is not compared: TF32 moves it no
        more than float32 rounding does (``PERF.md``)."""
        actual, wanted = result[0].astype(np.float64), expected[0]
        kick = np.max(np.abs(wanted[2:] - self.px_in[index % len(self.px_in)]))
        grad_rel_err = abs(actual[1] - wanted[1]) / abs(wanted[1])
        return {
            "grad_rel_err": grad_rel_err,
            "grad_rel_err_worst": grad_rel_err,
            "px_err_of_kick": float(np.max(np.abs(actual[2:] - wanted[2:])) / kick),
        }

    def release(self) -> None:
        del self.values, self.beams, self.segment, self.element
