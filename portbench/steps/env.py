"""Step kind ``env``: ``BatchedLatticeEnv.step(settings)`` or, where the mix
names a ``gradient``, ``grad_step(settings, learning_rate)``, over a pool of
settings: each tunable the configuration names uniform in the mix's range
for its attribute. With ``beam: "particle"`` the configuration's particle
beam, with ``beam: "parameter"`` the Gaussian beam of its moments."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import harness, reference
from portbench.reference import ParticleState


class Steps:
    """Set-up draws the beam and the pool of settings on ``device`` from the
    seed; :meth:`step` runs pool entry ``index`` and reads its result back."""

    def __init__(self, ctt, cell, seed: int, device, dtype) -> None:
        from cheetah_tpu_torch import parallel

        config, traffic = cell.config, cell.traffic
        self.config = config
        self.tunables = [tuple(pair) for pair in config["tunables"]]
        self.learning_rate = (traffic["gradient"]["learning_rate"]
                              if traffic.get("gradient") else None)
        self.moment_ratio_split = float(traffic.get("moment_ratio_split", math.inf))
        beam = config["beam"]
        energy = float(torch.tensor(beam["energy"], dtype=dtype))
        if traffic["beam"] == "particle":
            particles, charges = harness.make_particles(beam, seed, dtype, device)
            self.beam = ctt.ParticleBeam(particles, energy=beam["energy"],
                                         particle_charges=charges, dtype=dtype, device=device)
            self.reference_beam = lambda rdtype: ParticleState(
                particles.to(rdtype), energy, charges.to(rdtype))
        else:
            cov = harness.twiss_covariance(beam).to(device=device, dtype=dtype)
            mu = torch.zeros(7, dtype=dtype, device=device)
            mu[6] = 1.0
            self.beam = ctt.ParameterBeam(mu, cov, energy=beam["energy"],
                                          total_charge=beam["total_charge"], dtype=dtype,
                                          device=device)
            self.reference_beam = lambda rdtype: {
                "mu": mu.to(rdtype), "cov": cov.to(rdtype), "energy": energy}
        self.segment = harness.build_segment(ctt, config, dtype, device)
        self.env = parallel.BatchedLatticeEnv(self.segment, self.beam, self.tunables,
                                              moments_only=bool(traffic.get("moments_only")))
        pool, instances = int(traffic["pool"]), int(config["instances"])
        draw = harness.generator(seed, 2, device)
        columns = []
        for _, attribute in self.tunables:
            low, high = traffic["settings"][attribute]
            columns.append(low + (high - low) * torch.rand((pool, instances), generator=draw,
                                                           dtype=dtype, device=device))
        self.settings = torch.stack(columns, dim=-1)

    def step(self, index: int):
        settings = self.settings[index % len(self.settings)]
        if self.learning_rate is None:
            return (self.env.step(settings)[2].cpu().numpy(),)
        new, reward = self.env.grad_step(settings, self.learning_rate)
        return new.cpu().numpy(), reward.cpu().numpy()

    def reference(self, index: int, dtype):
        """The step's result by the plain reference, computed in ``dtype``,
        and after it ``<x^2> + <y^2>`` of each instance."""
        settings = self.settings[index % len(self.settings)].to(dtype)
        beam = self.reference_beam(dtype)
        if self.learning_rate is None:
            reward, raw = reference.env_reward(self.config["lattice"], beam, self.tunables,
                                               settings)
            return reward.cpu().numpy(), raw.cpu().numpy()
        reward, raw, grad = reference.env_reward_and_grad(self.config["lattice"], beam,
                                                          self.tunables, settings)
        return ((settings + self.learning_rate * grad).cpu().numpy(), reward.cpu().numpy(),
                raw.cpu().numpy())

    def readings(self, index: int, result, expected) -> dict:
        """The numbers of one step. The squared reward is ``sigma_x^2 +
        sigma_y^2``; its error is judged per instance, by the reference's
        ``ratio = (<x^2> + <y^2>) / (sigma_x^2 + sigma_y^2)``:

        ``reward_rel_err``: the worst instance's error of the squared reward
        over the reference's, among instances whose ratio is at most the
        mix's ``moment_ratio_split`` (every instance where the mix names
        none).

        Where the mix names a split, two numbers more:
        ``reward_err_of_moments``, the worst error of the squared reward
        over ``<x^2> + <y^2>`` among the instances past the split, and
        ``reward_rel_err_all``, ``reward_rel_err`` over every instance. The
        port reads a particle beam's variances from raw moments (``<x^2> -
        mu^2``), whose float32 rounding scales with ``<x^2>``, not with the
        variance; the correctors' centroids raise the ratio to some
        hundreds, so past the split the relative error is held only to the
        looser limit of ``reward_rel_err_all``.

        ``update_rel_err`` (gradient steps): the error of the settings'
        update in each tunable, over all instances (the norm of the
        difference over the norm of the reference's update), the worst
        tunable. The norm over the instances is used, not the worst
        instance: the worst instance's error swings from seed to seed, with
        the port's float32 rounding of a map's derivative where a ``k1``
        lies near 0. A tunable whose reference update is under a thousandth
        of the median tunable's (a corrector's angle, which shifts the
        centroid and leaves the reward unchanged) is left out.
        """
        fields = 1 if self.learning_rate is None else 2
        reward = result[fields - 1].astype(np.float64)
        reward_ref, raw = expected[fields - 1], expected[fields]
        error = np.abs(reward**2 - reward_ref**2)
        relative = error / reward_ref**2
        near = raw / reward_ref**2 <= self.moment_ratio_split
        numbers = {"reward_rel_err": float(np.max(relative[near], initial=0.0))}
        if math.isfinite(self.moment_ratio_split):
            numbers["reward_err_of_moments"] = float(np.max((error / raw)[~near], initial=0.0))
            numbers["reward_rel_err_all"] = float(np.max(relative))
        if self.learning_rate is not None:
            settings = self.settings[index % len(self.settings)].double().cpu().numpy()
            update = result[0].astype(np.float64) - settings
            update_ref = expected[0] - settings
            norms = np.linalg.norm(update_ref, axis=0)
            kept = norms >= 1e-3 * np.median(norms)
            numbers["update_rel_err"] = float(np.max(
                np.linalg.norm(update - update_ref, axis=0)[kept] / norms[kept]))
        return numbers

    def release(self) -> None:
        del self.env, self.beam, self.segment
