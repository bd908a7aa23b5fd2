"""The remaining elements of the PyTorch port against cheetah_tpu on the CPU,
in float64: Solenoid, Undulator, CombinedCorrector, RBend, the transverse
deflecting cavity, CustomTransferMap (with ``from_merging_elements``) and
Superimposed (with the ``Superimposed`` branch of ``track_with_readings``).

For each: the first-order map, tracking in every supported method, a
``ParameterBeam`` where the element takes one, a batched parameter's
vector shape, and the gradient of a quadratic loss by one parameter
against ``jax.grad``. The same numpy inputs, made from a seed, go through
both packages. Both evaluate the same closed forms in the same order, so
maps and moments agree to rtol 1e-12 (atol 1e-15 on entries that are zero
in one package and rounding noise in the other). Tracked particles agree
to 1e-9 of each coordinate's largest value, the tolerance of the nonlinear
slice's tests: the drift-kick-drift maps chain a few dozen operations per
particle, and a batched dipole angle of -0.1 rad loses 1.4e-11 there.
Gradients agree to rtol 1e-10.
"""

import warnings

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

F64 = torch.float64
CPU = "cpu"
SEED = 7
NUM_PARTICLES = 300
ENERGY = 1.5e8
RTOL, ATOL = 1e-12, 1e-15
PARTICLE_RTOL = 1e-9
GRAD_RTOL = 1e-10

CUSTOM_TM = [
    [1.0, 0.5, 0.0, 0.01, 0.0, 0.0, 1e-4],
    [0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 2e-5],
    [0.0, 0.01, 1.0, 0.5, 0.0, 0.0, -1e-4],
    [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 1e-5],
    [0.0, 0.0, 0.0, 0.0, 1.0, 0.1, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
]

# name: (class name, constructor spec, tracking methods, takes a ParameterBeam,
#        batched parameter, gradient parameter)
CASES = {
    "solenoid": ("Solenoid", {"length": 0.4, "k": 2.5, "misalignment": [1e-4, -1e-4]},
                 ["linear"], True, "k", "k"),
    # Stage 3's solenoids sit at k = 0, where sin(kL)/k is a removable zero.
    "solenoid_off": ("Solenoid", {"length": 0.09, "k": 0.0}, ["linear"], True, "k", "k"),
    "undulator": ("Undulator", {"length": 2.0, "period": 0.05, "kx": 1.2, "ky": 0.8},
                  ["linear"], True, "kx", "ky"),
    "undulator_no_period": ("Undulator", {"length": 1.0, "period": 0.0, "kx": 1.0},
                            ["linear"], True, "ky", "kx"),
    "combined_corrector": ("CombinedCorrector", {"length": 0.1, "horizontal_angle": 2e-4,
                                                 "vertical_angle": -1e-4},
                           ["linear"], True, "horizontal_angle", "vertical_angle"),
    "rbend": ("RBend", {"length": 0.5, "angle": 0.2, "rbend_e1": 0.05, "rbend_e2": -0.02,
                        "gap": 0.02, "fringe_integral": 0.4},
              ["linear", "second_order", "drift_kick_drift"], True, "angle", "rbend_e1"),
    "tdc": ("TransverseDeflectingCavity", {"length": 0.6, "voltage": 1e6, "phase": 0.1,
                                           "frequency": 2.9e9, "misalignment": [1e-4, -1e-4],
                                           "tilt": 0.05},
            ["drift_kick_drift"], False, "voltage", "voltage"),
    "custom_transfer_map": ("CustomTransferMap", {"predefined_transfer_map": CUSTOM_TM,
                                                  "length": 0.5},
                            ["linear"], True, None, "predefined_transfer_map"),
}
BATCH = {"k": [-1.0, 0.0, 2.0], "kx": [0.0, 0.5, 1.5], "ky": [0.0, 0.5, 1.5],
         "horizontal_angle": [-1e-4, 0.0, 3e-4], "angle": [-0.1, 0.05, 0.2],
         "voltage": [0.0, 5e5, 2e6]}


def build(module, class_name: str, spec: dict):
    """The element of ``spec`` in cheetah_tpu (``module`` is ``ct``) or in
    the port, in float64."""
    if module is ct:
        kwargs = {k: jnp.asarray(v, jnp.float64) if isinstance(v, (float, list)) else v
                  for k, v in spec.items()}
        return getattr(ct, class_name)(**kwargs)
    kwargs = {k: torch.tensor(v, dtype=F64) if isinstance(v, (float, list)) else v
              for k, v in spec.items()}
    return getattr(ctt, class_name)(**kwargs, device=CPU)


def superimposed(module, observer: bool = False):
    """A quadrupole with a corrector (or an active BPM) at its centre."""
    if module is ct:
        a = lambda v: jnp.asarray(v, jnp.float64)  # noqa: E731
        centre = (ct.BPM(is_active=True, name="bpm") if observer
                  else ct.HorizontalCorrector(a(0.0), angle=a(2e-4), name="hcor"))
        return ct.Superimposed(ct.Quadrupole(a(0.3), k1=a(4.2), name="quad"), centre,
                               name="sup")
    kw = {"dtype": F64, "device": CPU}
    centre = (ctt.BPM(is_active=True, name="bpm", **kw) if observer
              else ctt.HorizontalCorrector(0.0, angle=2e-4, name="hcor", **kw))
    return ctt.Superimposed(ctt.Quadrupole(0.3, k1=4.2, name="quad", **kw), centre, name="sup")


def particles_in(num_particles=NUM_PARTICLES, seed=SEED) -> np.ndarray:
    rng = np.random.default_rng(seed)
    phase_space = rng.normal(0.0, [1.7e-4, 4e-6, 1.7e-4, 4e-6, 1e-5, 1e-3],
                             size=(num_particles, 6))
    return np.concatenate([phase_space, np.ones((num_particles, 1))], axis=1)


def beams(particles=None):
    particles = particles_in() if particles is None else particles
    jax_beam = ct.ParticleBeam(particles=jnp.asarray(particles), energy=jnp.asarray(ENERGY))
    beam = ctt.ParticleBeam(torch.tensor(particles), torch.tensor(ENERGY, dtype=F64))
    return jax_beam, beam


def parameter_beams():
    moments = dict(mu_x=1e-4, mu_px=-2e-5, sigma_x=1.7e-4, sigma_px=4e-6, sigma_y=1.7e-4,
                   sigma_py=4e-6, sigma_tau=1e-5, sigma_p=1e-3, cov_xpx=1e-10,
                   energy=ENERGY, total_charge=1e-9)
    jax_beam = ct.ParameterBeam.from_parameters(
        **{k: jnp.asarray(v, jnp.float64) for k, v in moments.items()}
    )
    beam = ctt.ParameterBeam.from_parameters(**moments, dtype=F64, device=CPU)
    return jax_beam, beam


# The loss of the gradient tests: a quadratic form of every coordinate, each
# weighted by its inverse scale.
WEIGHTS = 1.0 / np.array([1.7e-4, 4e-6, 1.7e-4, 4e-6, 1e-5, 1e-3])


def jax_loss(beam):
    return jnp.mean(jnp.square(beam.particles[..., :6] @ jnp.asarray(WEIGHTS)))


def torch_loss(beam):
    return torch.mean(torch.square(beam.particles[..., :6] @ torch.tensor(WEIGHTS)))


def assert_close(actual, expected, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(
        actual.detach().numpy(), np.asarray(expected), rtol=rtol, atol=atol, err_msg=err_msg
    )


def assert_beams_close(actual, expected, err_msg=""):
    # Each coordinate relative to its own scale.
    expected_particles = np.asarray(expected.particles)
    scale = np.abs(expected_particles).max(axis=tuple(range(expected_particles.ndim - 1)))
    np.testing.assert_allclose(
        actual.particles.detach().numpy() / scale, expected_particles / scale,
        rtol=0, atol=PARTICLE_RTOL, err_msg=err_msg,
    )
    assert_close(actual.energy, expected.energy, err_msg=err_msg)
    assert_close(actual.s, expected.s, err_msg=err_msg)


def set_method(element, method):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        element.tracking_method = method


# ---------------------------------------------------------------------------
# Each element against cheetah_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][2] != ["drift_kick_drift"]])
def test_first_order_map_matches_jax(case):
    class_name, spec, *_ = CASES[case]
    species_jax, species = ct.Species("electron"), ctt.Species("electron", dtype=F64, device=CPU)
    expected = build(ct, class_name, spec).first_order_transfer_map(
        jnp.asarray(ENERGY), species_jax
    )
    actual = build(ctt, class_name, spec).first_order_transfer_map(
        torch.tensor(ENERGY, dtype=F64), species
    )
    assert actual.shape == (7, 7)
    assert_close(actual, expected, err_msg=case)


@pytest.mark.parametrize(
    "case, method", [(c, m) for c in CASES for m in CASES[c][2]], ids=lambda v: str(v)
)
def test_particle_tracking_matches_jax(case, method):
    class_name, spec, *_ = CASES[case]
    jax_element, element = build(ct, class_name, spec), build(ctt, class_name, spec)
    set_method(element, method)
    jax_element.tracking_method = method
    jax_beam, beam = beams()
    assert_beams_close(element.track(beam), jax_element.track(jax_beam), err_msg=case)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][3]])
def test_parameter_beam_tracking_matches_jax(case):
    class_name, spec, *_ = CASES[case]
    jax_beam, beam = parameter_beams()
    expected = build(ct, class_name, spec).track(jax_beam)
    actual = build(ctt, class_name, spec).track(beam)
    assert_close(actual.mu, expected.mu, atol=1e-18, err_msg=case)
    assert_close(actual.cov, expected.cov, atol=1e-24, err_msg=case)
    assert_close(actual.energy, expected.energy)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][4] is not None])
def test_batched_parameter_gives_vector_shape(case):
    class_name, spec, methods, _, batched, _ = CASES[case]
    jax_element, element = build(ct, class_name, spec), build(ctt, class_name, spec)
    setattr(jax_element, batched, jnp.asarray(BATCH[batched]))
    setattr(element, batched, torch.tensor(BATCH[batched], dtype=F64))
    jax_beam, beam = beams()
    for method in methods:
        set_method(element, method)
        jax_element.tracking_method = method
        actual = element.track(beam)
        assert actual.particles.shape == (3, NUM_PARTICLES, 7)
        assert_beams_close(actual, jax_element.track(jax_beam), err_msg=f"{case} {method}")


@pytest.mark.parametrize(
    "case, method", [(c, m) for c in CASES for m in CASES[c][2]], ids=lambda v: str(v)
)
def test_gradient_matches_jax(case, method):
    class_name, spec, _, _, _, parameter = CASES[case]
    jax_beam, beam = beams()
    value = spec.get(parameter, 0.0)

    def jax_value(v):
        element = build(ct, class_name, spec)
        element.tracking_method = method
        setattr(element, parameter, v)
        return jax_loss(element.track(jax_beam))

    expected = jax.grad(jax_value)(jnp.asarray(value, jnp.float64))
    element = build(ctt, class_name, spec)
    set_method(element, method)
    v = torch.tensor(value, dtype=F64, requires_grad=True)
    setattr(element, parameter, v)
    (grad,) = torch.autograd.grad(torch_loss(element.track(beam)), v)
    assert bool(torch.isfinite(grad).all())
    scale = np.abs(np.asarray(expected)).max()
    np.testing.assert_allclose(grad.numpy() / scale, np.asarray(expected) / scale,
                               rtol=GRAD_RTOL, atol=GRAD_RTOL, err_msg=case)


def test_solenoid_map_at_zero_strength_is_a_drift_with_zero_gradient():
    """sin(kL)/k at k = 0: the map is the drift's, and its derivative by k
    is finite (the coupling terms' first order in k)."""
    solenoid = ctt.Solenoid(0.09, k=0.0, dtype=F64, device=CPU)
    drift = ctt.Drift(0.09, dtype=F64, device=CPU)
    energy, species = torch.tensor(ENERGY, dtype=F64), ctt.Species("electron", dtype=F64,
                                                                   device=CPU)
    solenoid_map = solenoid.first_order_transfer_map(energy, species)
    drift_map = drift.first_order_transfer_map(energy, species)
    np.testing.assert_allclose(solenoid_map.numpy(), drift_map.numpy(), rtol=1e-9, atol=0)

    def map_of(k):
        return ctt.Solenoid(0.09, k=k, dtype=F64, device=CPU).first_order_transfer_map(
            energy, species
        )

    jacobian = torch.autograd.functional.jacobian(map_of, torch.tensor(0.0, dtype=F64))
    expected = jax.jacfwd(
        lambda k: ct.Solenoid(jnp.asarray(0.09), k=k).first_order_transfer_map(
            jnp.asarray(ENERGY), ct.Species("electron")
        )
    )(jnp.asarray(0.0))
    assert bool(torch.isfinite(jacobian).all())
    np.testing.assert_allclose(jacobian.numpy(), np.asarray(expected), rtol=RTOL, atol=ATOL)


def test_solenoid_drift_kick_drift_warns_and_stays_linear():
    solenoid = ctt.Solenoid(0.3, k=1.0, dtype=F64, device=CPU)
    with pytest.warns(ctt.utils.warnings.PhysicsWarning, match="Invalid tracking method"):
        solenoid.tracking_method = "drift_kick_drift"
    assert solenoid.tracking_method == "linear"


# ---------------------------------------------------------------------------
# RBend's faces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["linear", "second_order", "drift_kick_drift"])
def test_rbend_face_setters_update_the_dipole_buffers(method):
    class_name, spec, *_ = CASES["rbend"]
    element, jax_element = build(ctt, class_name, spec), build(ct, class_name, spec)
    set_method(element, method)
    jax_element.tracking_method = method
    element.rbend_e1 = 0.07
    element.rbend_e2 = torch.tensor(-0.04, dtype=F64)
    jax_element.rbend_e1 = jnp.asarray(0.07)
    jax_element.rbend_e2 = jnp.asarray(-0.04)
    assert "dipole_e1" in element._buffers and "rbend_e1" not in element._buffers
    assert element.dipole_e1.item() == pytest.approx(0.07 + 0.1, rel=1e-15)
    assert element.rbend_e2.item() == pytest.approx(-0.04, rel=1e-12)

    fresh = build(ctt, class_name, {**spec, "rbend_e1": 0.07, "rbend_e2": -0.04})
    set_method(fresh, method)
    jax_beam, beam = beams()
    out = element.track(beam)
    assert_beams_close(out, jax_element.track(jax_beam), err_msg=method)
    np.testing.assert_allclose(out.particles.numpy(), fresh.track(beam).particles.numpy(),
                               rtol=1e-14, atol=1e-20)


# ---------------------------------------------------------------------------
# The transverse deflecting cavity's offsets
# ---------------------------------------------------------------------------


def test_tdc_zero_offsets_keep_their_batch_dimension():
    """The JAX zero-offset skip drops a batched offset's instance dimension;
    the port always applies the offset frames, so the outgoing shape is the
    broadcast of the parameters' shapes, and zero offsets change no bit."""
    _, spec, *_ = CASES["tdc"]
    spec = {**spec, "misalignment": [0.0, 0.0], "tilt": 0.0}
    element = build(ctt, "TransverseDeflectingCavity", spec)
    _, beam = beams()
    single = element.track(beam).particles
    element.misalignment = torch.zeros(4, 2, dtype=F64)
    batched = element.track(beam).particles
    assert batched.shape == (4, NUM_PARTICLES, 7)
    assert torch.equal(batched, single.expand(4, -1, -1))


def test_tdc_batched_offsets_match_jax():
    _, spec, *_ = CASES["tdc"]
    offsets = [[1e-4, -1e-4], [0.0, 2e-4], [-3e-4, 0.0]]
    element, jax_element = build(ctt, "TransverseDeflectingCavity", spec), build(
        ct, "TransverseDeflectingCavity", spec
    )
    element.misalignment = torch.tensor(offsets, dtype=F64)
    jax_element.misalignment = jnp.asarray(offsets)
    jax_beam, beam = beams()
    actual = element.track(beam)
    assert actual.particles.shape == (3, NUM_PARTICLES, 7)
    assert_beams_close(actual, jax_element.track(jax_beam))


def test_tdc_refuses_a_parameter_beam():
    _, beam = parameter_beams()
    with pytest.raises(TypeError, match="ParticleBeam"):
        build(ctt, "TransverseDeflectingCavity", CASES["tdc"][1]).track(beam)


# ---------------------------------------------------------------------------
# CustomTransferMap
# ---------------------------------------------------------------------------


def test_merging_the_ares_subcell_matches_jax_and_the_segment():
    jax_segment = jax_ares_ea_subcell(dtype=jnp.float64)
    segment = ares_ea_subcell(F64, device=CPU)
    jax_beam, beam = beams()
    expected = ct.CustomTransferMap.from_merging_elements(list(jax_segment.elements), jax_beam)
    merged = ctt.CustomTransferMap.from_merging_elements(list(segment.elements), beam)
    assert merged.name == expected.name
    assert_close(merged.predefined_transfer_map, expected.predefined_transfer_map)
    assert_close(merged.length, expected.length)
    out = merged.track(beam)
    np.testing.assert_allclose(out.particles.numpy(), segment.track(beam).particles.numpy(),
                               rtol=1e-12, atol=1e-18)
    assert_close(out.s, segment.track(beam).s)


def test_merging_keeps_the_order_and_the_vector_shape():
    kw = {"dtype": F64, "device": CPU}
    k1 = torch.tensor([1.0, -2.0, 3.0], dtype=F64)
    elements = [ctt.Drift(0.3, **kw), ctt.Quadrupole(0.2, k1=k1, **kw), ctt.Drift(0.5, **kw)]
    _, beam = beams()
    merged = ctt.CustomTransferMap.from_merging_elements(elements, beam)
    assert merged.predefined_transfer_map.shape == (3, 7, 7)
    energy, species = beam.energy, beam.species
    maps = [element.first_order_transfer_map(energy, species) for element in elements]
    assert torch.equal(merged.predefined_transfer_map, maps[2] @ (maps[1] @ maps[0]))


def test_empty_merge_is_the_identity_and_the_seventh_row_is_checked():
    _, beam = beams()
    merged = ctt.CustomTransferMap.from_merging_elements([], beam)
    assert torch.equal(merged.predefined_transfer_map, torch.eye(7, dtype=F64))
    assert merged.length.item() == 0.0 and merged.name == "combined_"
    bad = torch.eye(7, dtype=F64)
    bad[6, 0] = 1.0
    with pytest.raises(AssertionError, match="seventh row"):
        ctt.CustomTransferMap(bad)
    with pytest.raises(AssertionError, match="not skippable"):
        ctt.CustomTransferMap.from_merging_elements(
            [ctt.Drift(0.1, tracking_method="drift_kick_drift", device=CPU)], beam
        )


# ---------------------------------------------------------------------------
# Superimposed
# ---------------------------------------------------------------------------


def test_superimposed_tracks_and_maps_as_jax():
    jax_beam, beam = beams()
    element, jax_element = superimposed(ctt), superimposed(ct)
    assert element.is_skippable and float(element.length) == 0.3
    assert_beams_close(element.track(beam), jax_element.track(jax_beam))
    energy = torch.tensor(ENERGY, dtype=F64)
    assert_close(
        element.first_order_transfer_map(energy, ctt.Species("electron", dtype=F64, device=CPU)),
        jax_element.first_order_transfer_map(jnp.asarray(ENERGY), ct.Species("electron")),
    )
    jax_parameter, parameter = parameter_beams()
    actual, expected = element.track(parameter), jax_element.track(jax_parameter)
    assert_close(actual.mu, expected.mu, atol=1e-18)
    assert_close(actual.cov, expected.cov, atol=1e-24)


def test_superimposed_halves_are_new_modules_and_leave_the_base_unchanged():
    element = superimposed(ctt)
    base, length = element.base_element, element.base_element.length
    first, second = element._segment(), element._segment()
    assert first.elements[0] is not second.elements[0]
    assert first.elements[0] is not base and first.elements[1] is element.superimposed_element
    assert first.elements[0].name == "quad_half_front" and first.elements[2].name == "quad_half_back"
    assert first.elements[0].length.item() == pytest.approx(0.15, rel=1e-15)
    assert base.length is length and base.name == "quad"
    assert first.elements[0].k1 is base.k1


def test_superimposed_gradients_reach_the_base_and_the_centre():
    jax_beam, beam = beams()
    element = superimposed(ctt)
    k1 = torch.tensor(4.2, dtype=F64, requires_grad=True)
    angle = torch.tensor(2e-4, dtype=F64, requires_grad=True)
    element.base_element.k1 = k1
    element.superimposed_element.angle = angle
    grads = torch.autograd.grad(torch_loss(element.track(beam)), (k1, angle))

    def jax_value(k1, angle):
        jax_element = superimposed(ct)
        jax_element.base_element.k1 = k1
        jax_element.superimposed_element.angle = angle
        return jax_loss(jax_element.track(jax_beam))

    expected = jax.grad(jax_value, argnums=(0, 1))(jnp.asarray(4.2), jnp.asarray(2e-4))
    for grad, want in zip(grads, expected):
        np.testing.assert_allclose(grad.item(), float(want), rtol=GRAD_RTOL)


def test_superimposed_observer_is_read_through_track_with_readings():
    jax_beam, beam = beams()
    kw = {"dtype": F64, "device": CPU}
    a = lambda v: jnp.asarray(v, jnp.float64)  # noqa: E731
    segment = ctt.Segment([ctt.Drift(0.4, **kw), superimposed(ctt, observer=True),
                           ctt.Drift(0.2, **kw)])
    jax_segment = ct.Segment([ct.Drift(a(0.4)), superimposed(ct, observer=True),
                              ct.Drift(a(0.2))])
    assert not segment.elements[1].is_skippable
    out, readings = segment.track_with_readings(beam)
    jax_out, jax_readings = jax_segment.track_with_readings(jax_beam)
    assert set(readings) == set(jax_readings) == {"bpm"}
    assert_close(readings["bpm"], jax_readings["bpm"])
    assert_beams_close(out, jax_out)
    np.testing.assert_allclose(out.particles.numpy(), segment.track(beam).particles.numpy(),
                               rtol=1e-13, atol=1e-20)


# ---------------------------------------------------------------------------
# Carrying the new elements across from numpy
# ---------------------------------------------------------------------------


def element_to_numpy(element) -> dict:
    """A JAX element as the dict that :func:`interop.segment_from_numpy`
    takes, element-valued features included."""
    spec = {"type": type(element).__name__}
    for feature in element.defining_features:
        value = getattr(element, feature)
        if feature == "elements":
            spec["elements"] = [element_to_numpy(child) for child in value]
        elif isinstance(value, ct.Element):
            spec[feature] = element_to_numpy(value)
        elif isinstance(value, jax.Array):
            spec[feature] = np.asarray(value)
        else:
            spec[feature] = value
    return spec


def test_segment_from_numpy_carries_every_new_element():
    jax_elements = [build(ct, class_name, spec) for class_name, spec, *_ in CASES.values()]
    jax_elements.append(superimposed(ct))
    segment = interop.segment_from_numpy([element_to_numpy(e) for e in jax_elements],
                                         device=CPU)
    assert [type(e).__name__ for e in segment.elements] == [
        type(e).__name__ for e in jax_elements
    ]
    assert segment.sup.base_element.name == "quad"
    assert segment.sup.superimposed_element.angle.item() == 2e-4
    jax_beam, beam = beams()
    assert_beams_close(segment.track(beam), ct.Segment(jax_elements).track(jax_beam))
