"""The ARES EA env step in the PyTorch port against cheetah_tpu: the JAX
lattice and beam cross over as numpy arrays through
``cheetah_tpu_torch.interop`` and both packages track them.

At float64 the particles and beam sizes agree to rtol 1e-10 (the composed
13-element map differs by a few ulps). At float32 both packages round at
different places; the stated tolerance follows from a 13-matrix product and
the raw-moment variance in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cheetah_tpu as ct
from cheetah_tpu.lattices import ares_ea_subcell as jax_ares_ea_subcell
import cheetah_tpu_torch as ctt
from cheetah_tpu_torch import interop
from cheetah_tpu_torch.lattices import ares_ea_subcell

CPU = "cpu"


def element_to_numpy(element) -> dict:
    """A JAX element as the dict of numpy arrays and static configuration
    that :func:`interop.segment_from_numpy` takes."""
    spec = {"type": type(element).__name__}
    for feature in element.defining_features:
        value = getattr(element, feature)
        if feature == "elements":
            spec["elements"] = [element_to_numpy(child) for child in value]
        elif isinstance(value, jax.Array):
            spec[feature] = np.asarray(value)
        else:
            spec[feature] = value
    return spec


def segment_to_torch(segment, device=CPU) -> ctt.Segment:
    return interop.segment_from_numpy(
        [element_to_numpy(element) for element in segment.elements],
        name=segment.name,
        device=device,
    )


def beam_to_torch(beam, device=CPU) -> ctt.ParticleBeam:
    return interop.particle_beam_from_numpy(
        np.asarray(beam.particles),
        np.asarray(beam.energy),
        np.asarray(beam.particle_charges),
        np.asarray(beam.survival_probabilities),
        species_name=beam.species.name,
        device=device,
    )


def _jax_env(dtype, num_instances=3, num_particles=500):
    segment = jax_ares_ea_subcell(dtype=dtype)
    segment.AREAMQZM1.k1 = jnp.linspace(-20, 20, num_instances, dtype=dtype)
    segment.AREAMQZM3.k1 = jnp.asarray([-8.0, 0.0, 5.0], dtype)
    beam = ct.ParticleBeam.from_twiss(
        num_particles=num_particles,
        beta_x=jnp.asarray(5.0, dtype),
        alpha_x=jnp.asarray(-1.0, dtype),
        emittance_x=jnp.asarray(2e-9, dtype),
        beta_y=jnp.asarray(3.0, dtype),
        alpha_y=jnp.asarray(0.5, dtype),
        emittance_y=jnp.asarray(2e-9, dtype),
        energy=jnp.asarray(1.54e8, dtype),
        total_charge=jnp.asarray(1e-10, dtype),
        key=jax.random.PRNGKey(7),
        dtype=dtype,
    )
    return segment, beam


@pytest.mark.parametrize(
    "jax_dtype, torch_dtype, rtol_particles, rtol_sigma",
    [
        (jnp.float64, torch.float64, 1e-10, 1e-10),
        # float32: the composed map carries ~13 roundings of eps = 6e-8 per
        # entry, relative to the particle scale; the raw-moment variance
        # loses eps * (1 + (mu/sigma)^2) more over 500 particles.
        (jnp.float32, torch.float32, 2e-5, 1e-4),
    ],
    ids=["float64", "float32"],
)
def test_ares_ea_env_step_matches(jax_dtype, torch_dtype, rtol_particles, rtol_sigma):
    jax_segment, jax_beam = _jax_env(jax_dtype)
    segment = segment_to_torch(jax_segment)
    beam = beam_to_torch(jax_beam)
    assert beam.particles.dtype == torch_dtype
    assert len(segment.elements) == 13 and segment.is_skippable

    expected = jax_segment.track(jax_beam)
    actual = segment.track(beam)

    assert actual.particles.shape == (3, 500, 7)
    # Each coordinate relative to its own scale (x ~ 1e-4 m, p ~ 1e-6).
    scale = np.abs(np.asarray(expected.particles)).max(axis=(0, 1))
    np.testing.assert_allclose(
        actual.particles.numpy() / scale,
        np.asarray(expected.particles) / scale,
        rtol=rtol_particles,
        atol=rtol_particles,
    )
    for name in ("sigma_x", "sigma_y", "mu_x", "mu_y"):
        # Means are measured against the beam size, which they may be far below.
        sigma = np.asarray(getattr(expected, name.replace("mu", "sigma")))
        np.testing.assert_allclose(
            getattr(actual, name).numpy() / sigma,
            np.asarray(getattr(expected, name)) / sigma,
            rtol=rtol_sigma,
            atol=rtol_sigma,
            err_msg=name,
        )
    assert actual.s.item() == pytest.approx(float(expected.s), rel=1e-6)


def test_port_lattice_equals_carried_lattice():
    """``ares_ea_subcell`` of the port builds the same lattice as the JAX one
    carried across."""
    jax_segment, _ = _jax_env(jnp.float64)
    carried = segment_to_torch(jax_segment)
    native = ares_ea_subcell(torch.float64, device=CPU)
    native.AREAMQZM1.k1 = carried.AREAMQZM1.k1
    native.AREAMQZM3.k1 = carried.AREAMQZM3.k1
    assert native.element_names == carried.element_names
    energy = torch.tensor(1.54e8, dtype=torch.float64)
    species = ctt.Species("electron", dtype=torch.float64, device=CPU)
    torch.testing.assert_close(
        native.first_order_transfer_map(energy, species),
        carried.first_order_transfer_map(energy, species),
        rtol=0,
        atol=0,
    )


def test_buffers_assignment_and_name_lookup():
    segment = ares_ea_subcell(torch.float64, device=CPU)
    quad = segment.AREAMQZM1
    assert isinstance(quad, ctt.Quadrupole)
    assert "k1" in dict(quad.named_buffers()) and not list(segment.parameters())
    segment.AREAMQZM1.k1 = torch.linspace(-20, 20, 4, dtype=torch.float64)
    assert segment.AREAMQZM1.k1.shape == (4,)
    segment.AREAMQZM2.k1 = 3  # a Python number keeps the buffer's dtype and device
    assert segment.AREAMQZM2.k1.dtype == torch.float64
    assert isinstance(segment.elements, torch.nn.ModuleList)
    with pytest.raises(AttributeError):
        segment.NOT_AN_ELEMENT
    assert segment.to(torch.float32).AREAMQZM1.k1.dtype == torch.float32


def test_plan_fuses_skippable_runs_only():
    kw = {"dtype": torch.float64, "device": CPU}
    segment = ctt.Segment(
        [
            ctt.Drift(0.1, **kw),
            ctt.Quadrupole(0.1, k1=2.0, **kw),
            ctt.SpaceChargeKick(0.2, grid_shape=(4, 4, 4), **kw),
            ctt.Drift(0.1, **kw),
            ctt.Marker(**kw),
        ]
    )
    plan = segment._plan()
    assert [type(todo).__name__ for todo in plan] == ["Segment", "SpaceChargeKick", "Segment"]
    assert [len(todo.elements) for todo in (plan[0], plan[2])] == [2, 2]
    assert not segment.is_skippable and plan[0].is_skippable


def test_unported_tracking_method_raises_not_warns():
    kw = {"dtype": torch.float64, "device": CPU}
    beam = ctt.ParticleBeam(torch.zeros(4, 7, dtype=torch.float64), 1e8)
    for method in ("second_order", "drift_kick_drift"):
        drift = ctt.Drift(0.5, tracking_method=method, **kw)
        with pytest.raises(NotImplementedError, match="nonlinear-element slice"):
            drift.track(beam)
        with pytest.raises(NotImplementedError):
            ctt.Segment([ctt.Drift(0.1, **kw), drift]).track(beam)


def test_segment_and_beam_on_different_devices_raise():
    """A 0-dim CPU tensor combines silently with tensors on another device in
    PyTorch; tracking must raise instead (the meta device stands in for the
    card here)."""
    segment = ares_ea_subcell(torch.float64, device=CPU)
    beam = ctt.ParticleBeam(
        torch.zeros(2, 10, 7, dtype=torch.float64, device="meta"), 1e8, device="meta"
    )
    with pytest.raises(ValueError, match="device"):
        segment.track(beam)
    with pytest.raises(ValueError, match="device"):
        ctt.ParticleBeam(torch.zeros(10, 7), torch.tensor(1e8, device="meta"))
