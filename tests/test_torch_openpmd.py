"""The port's openPMD beam I/O against cheetah_tpu's on the CPU.

The cases of ``tests/test_openpmd.py`` on the port (``pmd_beamphysics`` is
not installed, so the native h5py layer of
``cheetah_tpu_torch/converters/openpmd.py`` writes and reads), each beam
made with numpy and given to both packages; and files written by either
package read by the other. In float64 the particles come back within 1e-12
of the written ones, and the two packages read the same file to the same
particles within 1e-12. In float32 the SI round trip costs the
reference-energy subtraction: ``eps * E / p0c`` in delta, in both packages.
"""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cheetah_tpu as ct
import cheetah_tpu_torch as ctt
from cheetah_tpu import constants
from cheetah_tpu.converters.openpmd import read_particle_group_h5 as jax_read
from cheetah_tpu_torch import interop
from cheetah_tpu_torch.converters.openpmd import ParticleGroupData, read_particle_group_h5

CPU = "cpu"
F64 = torch.float64
ENERGY = 1e6


def beam_arrays(num_particles=10_000, seed=3, energy=ENERGY):
    """The beam of ``tests/test_openpmd.py`` (means 1e-4 in x and y, sizes
    2e-5, 1e-4 in delta), drawn with numpy."""
    rng = np.random.default_rng(seed)
    sigmas = np.array([2e-5, 2e-7, 2e-5, 2e-7, 1e-6, 1e-4])
    particles = rng.normal(size=(num_particles, 6)) * sigmas + np.array([1e-4, 0, 1e-4, 0, 0, 0])
    return {
        "particles": np.concatenate([particles, np.ones((num_particles, 1))], axis=-1),
        "energy": np.asarray(energy),
        "particle_charges": np.full(num_particles, 1e-9 / num_particles),
        "survival_probabilities": np.ones(num_particles),
    }


def port_beam(arrays, species="electron", dtype=F64):
    return interop.particle_beam_from_numpy(
        arrays["particles"].astype(np.float64), arrays["energy"], arrays["particle_charges"],
        arrays["survival_probabilities"], species_name=species, device=CPU,
    ).to(dtype=dtype)


def jax_beam(arrays, species="electron"):
    return ct.ParticleBeam(
        **{key: jnp.asarray(value) for key, value in arrays.items()},
        species=ct.Species(species),
    )


@pytest.fixture
def arrays():
    return beam_arrays()


def _numpy(tensor):
    return tensor.detach().cpu().numpy()


def test_particlegroup_round_trip_matches_jax(arrays):
    """Through the particle-group object in memory, as the JAX package's
    first case: the port's data dict equals the JAX package's, and both
    read it back to the same beam."""
    beam = port_beam(arrays)
    data = beam._to_openpmd_data()
    jax_data = jax_beam(arrays)._to_openpmd_data()
    for key in ("x", "y", "z", "px", "py", "pz", "t", "weight", "status"):
        np.testing.assert_allclose(data[key], jax_data[key], rtol=1e-12, atol=0, err_msg=key)
    loaded = ctt.ParticleBeam.from_openpmd_particlegroup(
        ParticleGroupData(data), energy=ENERGY, dtype=F64, device=CPU
    )
    jax_loaded = ct.ParticleBeam.from_openpmd_particlegroup(
        ParticleGroupData(data), energy=jnp.asarray(ENERGY), dtype=jnp.float64
    )
    np.testing.assert_allclose(_numpy(loaded.particles), np.asarray(jax_loaded.particles),
                               rtol=1e-12, atol=1e-20)
    np.testing.assert_allclose(_numpy(loaded.particles), arrays["particles"], rtol=1e-9,
                               atol=1e-14)
    assert loaded.species.name == "electron"


@pytest.mark.parametrize("writer, reader", [("port", "port"), ("port", "jax"),
                                            ("jax", "port"), ("jax", "jax")])
def test_files_read_by_either_package(arrays, tmp_path, writer, reader):
    """A file written by either package reads back in either to the
    written particles within 1e-12 (float64), the charges exactly."""
    path = tmp_path / f"{writer}.h5"
    (port_beam(arrays) if writer == "port" else jax_beam(arrays)).save_as_openpmd_h5(path)
    if reader == "port":
        loaded = ctt.ParticleBeam.from_openpmd_file(path, energy=ENERGY, dtype=F64, device=CPU)
        particles, charges = _numpy(loaded.particles), _numpy(loaded.particle_charges)
    else:
        loaded = ct.ParticleBeam.from_openpmd_file(path, energy=jnp.asarray(ENERGY),
                                                   dtype=jnp.float64)
        particles, charges = np.asarray(loaded.particles), np.asarray(loaded.particle_charges)
    scale = np.abs(arrays["particles"]).max(axis=0)
    assert np.all(np.abs(particles - arrays["particles"]).max(axis=0) <= 1e-12 * scale)
    np.testing.assert_array_equal(charges, arrays["particle_charges"])


def test_both_packages_write_the_same_records(arrays, tmp_path):
    port_path, jax_path = tmp_path / "port.h5", tmp_path / "jax.h5"
    port_beam(arrays).save_as_openpmd_h5(port_path)
    jax_beam(arrays).save_as_openpmd_h5(jax_path)
    ours, theirs = read_particle_group_h5(port_path), jax_read(jax_path)
    for attr in ("x", "y", "z", "px", "py", "pz", "t", "weight", "status"):
        np.testing.assert_allclose(getattr(ours, attr), getattr(theirs, attr), rtol=1e-12,
                                   atol=0, err_msg=attr)
    assert ours.species == theirs.species


def test_openpmd_h5_schema(arrays, tmp_path):
    beam = port_beam(arrays)
    path = tmp_path / "schema.h5"
    beam.save_as_openpmd_h5(path)
    with h5py.File(path, "r") as h5:
        assert h5.attrs["openPMD"] == b"2.0.0"
        assert b"BeamPhysics" in h5.attrs["openPMDextension"]
        assert h5.attrs["basePath"] == b"/"
        assert h5.attrs["particlesPath"] == b"."
        assert h5.attrs["speciesType"] == b"electron"
        assert h5.attrs["numParticles"] == beam.num_particles
        np.testing.assert_allclose(h5.attrs["totalCharge"], float(beam.total_charge), rtol=1e-12)
        for record in ("position/x", "position/y", "position/z"):
            assert h5[record].attrs["unitSI"] == 1.0
            assert h5[record].shape == (beam.num_particles,)
        ev_per_c = constants.elementary_charge / constants.speed_of_light
        for record in ("momentum/x", "momentum/y", "momentum/z"):
            np.testing.assert_allclose(h5[record].attrs["unitSI"], ev_per_c, rtol=1e-12)
        assert "time" in h5 and "weight" in h5 and "particleStatus" in h5


def _series_copy(flat, series, iterations):
    with h5py.File(flat, "r") as src, h5py.File(series, "w") as dst:
        dst.attrs["openPMD"] = np.bytes_("2.0.0")
        dst.attrs["basePath"] = np.bytes_("/data/%T/")
        dst.attrs["particlesPath"] = np.bytes_("particles/")
        for iteration, scale in iterations:
            group = dst.create_group(f"data/{iteration}/particles")
            for key in ("position", "momentum", "time", "weight", "particleStatus"):
                src.copy(key, group)
            group.attrs["speciesType"] = src.attrs["speciesType"]
            group["position/x"][...] = group["position/x"][...] * scale


def test_reader_handles_iteration_layouts_in_numeric_order(arrays, tmp_path):
    """``/data/%T/`` series read as the flat file, iteration 2 before 10,
    in both packages."""
    flat, series = tmp_path / "flat.h5", tmp_path / "series.h5"
    port_beam(arrays).save_as_openpmd_h5(flat)
    _series_copy(flat, series, (("10", 2.0), ("2", 1.0)))
    flat_group = read_particle_group_h5(flat)
    for group in (read_particle_group_h5(series), jax_read(series)):
        for attr in ("x", "y", "z", "px", "py", "pz", "t", "weight", "status"):
            np.testing.assert_array_equal(getattr(group, attr), getattr(flat_group, attr))
        assert group.species == flat_group.species


def test_momentum_identities(arrays):
    """p_total^2 = E^2 - m^2 and the per-particle energies, as in the JAX
    package's case."""
    beam = port_beam(arrays)
    group = ParticleGroupData(beam._to_openpmd_data())
    energies = _numpy(beam.energies)
    np.testing.assert_allclose(group.energy, energies, rtol=1e-12)
    mass = float(beam.species.mass_eV)
    np.testing.assert_allclose(group.p, np.sqrt(energies**2 - mass**2), rtol=1e-12)


def test_dead_particles_round_trip(tmp_path):
    arrays = beam_arrays(100, energy=1e8)
    survival = np.ones(100)
    survival[10:20] = 0.0
    survival[20:25] = 0.3  # below threshold -> dead
    arrays["survival_probabilities"] = survival
    path = tmp_path / "dead.h5"
    port_beam(arrays).save_as_openpmd_h5(path)
    loaded = ctt.ParticleBeam.from_openpmd_file(path, energy=1e8, dtype=F64, device=CPU)
    np.testing.assert_array_equal(_numpy(loaded.survival_probabilities),
                                  (survival > 0.5).astype(float))
    jax_loaded = ct.ParticleBeam.from_openpmd_file(path, energy=jnp.asarray(1e8),
                                                   dtype=jnp.float64)
    np.testing.assert_array_equal(_numpy(loaded.survival_probabilities),
                                  np.asarray(jax_loaded.survival_probabilities))


def test_vectorised_beam_raises():
    beam = port_beam(beam_arrays(10))
    vectorised = ctt.ParticleBeam(beam.particles.expand(2, 10, 7), beam.energy)
    with pytest.raises(ValueError, match="non-vectorised"):
        vectorised._to_openpmd_data()


def test_proton_species_round_trip(tmp_path):
    arrays = beam_arrays(50, energy=2e9)
    path = tmp_path / "proton.h5"
    port_beam(arrays, species="proton").save_as_openpmd_h5(path)
    loaded = ctt.ParticleBeam.from_openpmd_file(path, energy=2e9, dtype=F64, device=CPU)
    assert loaded.species.name == "proton"
    np.testing.assert_allclose(_numpy(loaded.particles), arrays["particles"], rtol=1e-9,
                               atol=1e-14)


def test_float32_round_trip_within_the_si_bound(tmp_path):
    """A float32 beam through the file: each coordinate within a few float32
    ulps of its largest value, delta within the SI bound eps * E / p0c
    (the reference-energy subtraction), in both packages alike."""
    arrays = beam_arrays(2_000, energy=1.54e8)
    beam = port_beam(arrays, dtype=torch.float32)
    path = tmp_path / "f32.h5"
    beam.save_as_openpmd_h5(path)
    loaded = ctt.ParticleBeam.from_openpmd_file(path, energy=1.54e8, dtype=torch.float32,
                                                device=CPU)
    jax_loaded = ct.ParticleBeam.from_openpmd_file(path, energy=jnp.asarray(1.54e8, jnp.float32),
                                                   dtype=jnp.float32)
    np.testing.assert_array_equal(_numpy(loaded.particles), np.asarray(jax_loaded.particles))
    eps = np.finfo(np.float32).eps
    written = _numpy(beam.particles).astype(np.float64)
    error = np.abs(_numpy(loaded.particles).astype(np.float64) - written).max(axis=0)
    scale = np.abs(written).max(axis=0)
    assert np.all(error[:5] <= 4 * eps * scale[:5]), error / scale
    p0c = float(beam.p0c)
    assert error[5] <= 2 * eps * 1.54e8 / p0c, error[5]


def test_from_openpmd_file_defaults_to_the_card(arrays, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    path = tmp_path / "beam.h5"
    port_beam(arrays).save_as_openpmd_h5(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ctt.ParticleBeam.from_openpmd_file(path, energy=ENERGY)
