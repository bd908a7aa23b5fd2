"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped (the CPU, tiny cells), the rest of the
run as it is. One test a fault the cell can have: a gradient step that
returns its state unchanged, half of the batch left out with the mean
taken over the rest, and an answer altered where it is produced. (A cell
on one chip has no exchange between chips to leave out.)"""

import pytest
import torch

import cheetah_tpu_torch as ctt
from cheetah_tpu_torch.accelerator import space_charge_kick
from cheetah_tpu_torch.parallel import BatchedLatticeEnv
from portbench import harness
from portbench.tests.helpers import tiny_cell

SEED = 2**31 + 41


def _run(name):
    return harness.run_cell(tiny_cell(name), SEED, 0.2, False, "cpu")


def test_sound_runs_are_correct():
    for name in ("ares_ea.env_step", "ares_ea.env_grad_step", "sc_segment_128.grad"):
        assert _run(name).correct


def test_state_unchanged_fails(monkeypatch):
    def unchanged(self, settings, learning_rate):
        return settings.detach(), self.reward(settings).detach()

    monkeypatch.setattr(BatchedLatticeEnv, "grad_step", unchanged)
    run = _run("ares_ea.env_grad_step")
    assert not run.correct and run.checks["update_rel_err"]["value"] >= 1.0


@pytest.mark.parametrize("name", ["ares_ea.env_step", "ares_ea.env_grad_step",
                                  "ares_ea.moments_step"])
def test_half_the_instances_left_out_fails(monkeypatch, name):
    step = BatchedLatticeEnv.step

    def half(self, settings):
        kept = settings.shape[0] // 2
        outgoing, readings, reward = step(self, settings[:kept])
        return outgoing, readings, torch.cat([reward, reward.mean().expand(
            settings.shape[0] - kept)])

    monkeypatch.setattr(BatchedLatticeEnv, "step", half)
    assert not _run(name).correct


def test_half_the_particles_left_out_fails(monkeypatch):
    deposit = space_charge_kick.cloud_in_cell_charge_deposition

    def half(positions, bins, extent, charges):
        kept = charges.shape[-1] // 2
        weights = torch.cat([2 * charges[..., :kept], 0 * charges[..., kept:]], dim=-1)
        return deposit(positions=positions, bins=bins, extent=extent, charges=weights)

    monkeypatch.setattr(space_charge_kick, "cloud_in_cell_charge_deposition", half)
    assert not _run("sc_segment_128.grad").correct


def _instance(outgoing, which: str) -> int:
    """The instance whose ``<x^2> + <y^2>`` over ``sigma_x^2 + sigma_y^2``
    is least (``near``) or largest (``far``); 0 for a Gaussian beam, whose
    every instance is compared relative to its variance."""
    particles = getattr(outgoing, "particles", None)
    if particles is None:
        return 0
    x, y = particles[..., 0], particles[..., 2]
    ratio = (x.square().mean(-1) + y.square().mean(-1)) / (x.var(-1) + y.var(-1))
    return int(ratio.argmin() if which == "near" else ratio.argmax())


@pytest.mark.parametrize("name, which, factor", [
    ("ares_ea.env_step", "near", 1.01), ("ares_ea.env_step", "far", 1.01),
    ("ares_ea.moments_step", "near", 1.01)])
def test_one_reward_altered_fails(monkeypatch, name, which, factor):
    step = BatchedLatticeEnv.step

    def altered(self, settings):
        outgoing, readings, reward = step(self, settings)
        scale = reward.new_ones(len(reward))
        scale[_instance(outgoing, which)] = factor
        return outgoing, readings, reward * scale

    monkeypatch.setattr(BatchedLatticeEnv, "step", altered)
    assert not _run(name).correct


def test_kick_altered_fails(monkeypatch):
    kick = space_charge_kick.SpaceChargeKick._track

    def altered(self, incoming):
        outgoing = kick(self, incoming)
        particles = outgoing.particles + 1e-2 * (outgoing.particles - incoming.particles)
        return ctt.ParticleBeam(particles, outgoing.energy, outgoing.particle_charges,
                                outgoing.survival_probabilities, outgoing.s, outgoing.species)

    monkeypatch.setattr(space_charge_kick.SpaceChargeKick, "_track", altered)
    assert not _run("sc_segment_128.grad").correct
