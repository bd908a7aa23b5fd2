"""The reference's side of each step kind: a lattice given as data, tracked
element by element (consecutive linear maps multiplied first), with the
step's settings applied per instance.

Every function takes the lattice as the configuration states it (a list of
element dicts), the beam as tensors and the step's inputs, and computes in
the dtype of the tensors it is given.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.reference import optics, space_charge


@dataclass
class ParticleState:
    """A particle beam as the benchmark makes it: ``particles (N, 7)``, the
    reference energy in eV and the charge of each particle ``(N,)``."""

    particles: torch.Tensor
    energy: float
    charges: torch.Tensor


def _values(element: dict, overrides: dict, dtype, device) -> dict:
    values = {
        key: torch.as_tensor(value, dtype=dtype, device=device)
        for key, value in element.items()
        if key not in ("type", "name") and isinstance(value, (int, float))
    }
    values.update(overrides.get(element["name"], {}))
    return values


def _blocks(elements, overrides, energy, batch, dtype, device):
    """The lattice as a list of ``("map", R (batch, 7, 7))`` and
    ``("kick", element, values)``, consecutive maps multiplied."""
    blocks = []
    for element in elements:
        values = _values(element, overrides, dtype, device)
        if element["type"] == "SpaceChargeKick":
            blocks.append(("kick", element, values))
            continue
        R = optics.element_map(element, values, energy, batch, dtype, device)
        if blocks and blocks[-1][0] == "map":
            blocks[-1] = ("map", optics.product(R, blocks[-1][1]))
        else:
            blocks.append(("map", R))
    return blocks


def _settings_overrides(tunables, settings: torch.Tensor) -> dict:
    overrides: dict = {}
    for column, (name, attribute) in enumerate(tunables):
        overrides.setdefault(name, {})[attribute] = settings[:, column]
    return overrides


def _reward(elements, beam, tunables, settings: torch.Tensor):
    """``-hypot(sigma_x, sigma_y)`` of each instance after the lattice, for
    a particle beam (:class:`ParticleState`) or a Gaussian beam given by its
    moments (``{"mu": (7,), "cov": (7, 7), "energy": eV}``), and the sum of
    the second moments of ``x`` and ``y`` about 0, ``<x^2> + <y^2>``."""
    batch = settings.shape[0]
    overrides = _settings_overrides(tunables, settings)
    if isinstance(beam, ParticleState):
        blocks = _blocks(elements, overrides, beam.energy, batch, settings.dtype, settings.device)
        if len(blocks) != 1 or blocks[0][0] != "map":
            raise ValueError("The env reference tracks linear lattices only.")
        out = optics.transport(beam.particles, blocks[0][1])
        sigma_x, sigma_y = optics.sigma(out[..., 0]), optics.sigma(out[..., 2])
        raw = torch.mean(out[..., 0] ** 2 + out[..., 2] ** 2, dim=-1)
    else:
        blocks = _blocks(elements, overrides, beam["energy"], batch, settings.dtype,
                         settings.device)
        if len(blocks) != 1 or blocks[0][0] != "map":
            raise ValueError("The env reference tracks linear lattices only.")
        R = blocks[0][1]
        cov = optics.product(optics.product(R, beam["cov"]), R.transpose(-1, -2))
        mu = optics.product(R, beam["mu"][:, None])[..., 0]
        sigma_x, sigma_y = torch.sqrt(cov[:, 0, 0]), torch.sqrt(cov[:, 2, 2])
        raw = cov[:, 0, 0] + cov[:, 2, 2] + mu[:, 0] ** 2 + mu[:, 2] ** 2
    return -torch.hypot(sigma_x, sigma_y), raw


def env_reward(elements, beam, tunables, settings: torch.Tensor, block: int = 512):
    """The reward of each instance and ``<x^2> + <y^2>`` after the lattice,
    computed ``block`` instances at a time."""
    with torch.no_grad():
        parts = [_reward(elements, beam, tunables, part) for part in settings.split(block)]
    return torch.cat([reward for reward, _ in parts]), torch.cat([raw for _, raw in parts])


def env_reward_and_grad(elements, beam, tunables, settings: torch.Tensor, block: int = 512):
    """As :func:`env_reward`, and the reward's gradient with respect to each
    instance's settings."""
    rewards, raws, grads = [], [], []
    for part in settings.split(block):
        part = part.detach().requires_grad_()
        reward, raw = _reward(elements, beam, tunables, part)
        (grad,) = torch.autograd.grad(reward.sum(), part)
        rewards.append(reward.detach())
        raws.append(raw.detach())
        grads.append(grad)
    return torch.cat(rewards), torch.cat(raws), torch.cat(grads)


def track_grad(elements, beam: ParticleState, parameter: tuple[str, str], value: float,
               sample: torch.Tensor):
    """``sum(px^2)`` after the lattice with ``parameter = (element name,
    attribute)`` set to ``value``, its derivative with respect to that
    value, and the outgoing ``px`` of the particles at ``sample``."""
    dtype, device = beam.particles.dtype, beam.particles.device
    setting = torch.tensor(value, dtype=dtype, device=device, requires_grad=True)
    overrides = {parameter[0]: {parameter[1]: setting}}
    particles = beam.particles
    for block in _blocks(elements, overrides, beam.energy, 1, dtype, device):
        if block[0] == "map":
            particles = optics.transport(particles, block[1][0])
        else:
            _, element, values = block
            particles = space_charge.kick(particles, beam.energy, beam.charges,
                                          values["effect_length"], element["grid_shape"])
    px = particles[:, 1]
    objective = torch.sum(px * px)
    (grad,) = torch.autograd.grad(objective, setting)
    return objective.detach(), grad.detach(), px.detach()[sample]
