"""``Segment.track_checkpointed`` of the PyTorch port against ``track`` and
against the JAX package's ``track_checkpointed`` on the CPU, in float64.

The same numpy inputs go through both packages. Values and gradients agree
within rtol 1e-10 on the env step (the k1 gradient), BASELINE config 3 (the
voltage and k2 gradients) and the space-charge segment on the untiled 8^3
grid and the tiled (160, 40, 16) grid (plain versions of the kernels). The
port's checkpointed run equals its own ``track`` bit for bit on the CPU,
where the deposits add in a fixed order. Then the tile plans under
checkpoint: ``track`` makes 4 plans in forward and none in backward; the
checkpointed run makes the same 4 in forward and 4 more when backward runs
the kicks' forwards again, because the plans are saved tensors that the
checkpoint drops. Last, ``lattices.cold_beam_line``: the cold uniform beam
of the JAX package's ImpactX benchmark (``tests/test_space_charge.py:53-104``)
in a line built with ``split`` and ``with_consecutive_elements_merged``, as
the JAX package builds it, doubles in size within 2e-2 through
``track_checkpointed`` at the JAX test's size (100k particles, 32^3, 3
kicks), and it tracks with no operator that waits for the device or copies
from the host, which would stall the card and stop a CUDA graph from
capturing the line.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cheetah_tpu as ct
import cheetah_tpu_torch as ctt
from cheetah_tpu.lattices import ares_ea_subcell as jax_ares_ea_subcell
from cheetah_tpu_torch.ops import cic_tiled
from test_torch_nonlinear import _chain
from test_torch_tracking import beam_to_torch, segment_to_torch

F64 = torch.float64
CPU = "cpu"
RTOL = 1e-10
TILED = (160, 40, 16)


def _jax_beam(num_particles, seed, **extra):
    a = lambda value: jnp.asarray(value, jnp.float64)  # noqa: E731
    return ct.ParticleBeam.from_twiss(
        num_particles=num_particles, beta_x=a(5.0), alpha_x=a(-1.0), emittance_x=a(2e-9),
        beta_y=a(3.0), alpha_y=a(0.5), emittance_y=a(2e-9), energy=a(1.54e8),
        total_charge=a(1e-10), key=jax.random.PRNGKey(seed), dtype=jnp.float64,
        **{k: a(v) for k, v in extra.items()},
    )


def _jax_sc_segment(grid):
    a = lambda value: jnp.asarray(value, jnp.float64)  # noqa: E731
    return ct.Segment(
        [
            ct.Drift(a(0.1)),
            ct.SpaceChargeKick(a(0.2), grid_shape=grid),
            ct.Drift(a(0.1)),
            ct.SpaceChargeKick(a(0.2), grid_shape=grid),
            ct.Drift(a(0.1)),
        ]
    )


def _set(segment, path, value):
    """Assign ``value`` to ``segment``'s parameter at ``path`` (element
    index or name, attribute)."""
    where, attribute = path
    element = segment.elements[where] if isinstance(where, int) else getattr(segment, where)
    setattr(element, attribute, value)


# name: (the JAX segment's maker, the beam's maker, parameter path, its value,
#        loss of the outgoing beam)
CASES = {
    "env_step_k1": (
        lambda: jax_ares_ea_subcell(dtype=jnp.float64),
        lambda: _jax_beam(500, 3),
        ("AREAMQZM1", "k1"), np.linspace(-20.0, 20.0, 3),
        lambda beam, lib: lib.sum(beam.sigma_x),
    ),
    "config3_voltage": (
        _chain, lambda: _jax_beam(500, 4, sigma_p=1e-3),
        ("cav", "voltage"), 2e7,
        lambda beam, lib: lib.sum(beam.sigma_x * beam.sigma_p),
    ),
    "config3_k2": (
        _chain, lambda: _jax_beam(500, 4, sigma_p=1e-3),
        ("sext", "k2"), 60.0,
        lambda beam, lib: lib.sum(beam.sigma_x),
    ),
    "space_charge_8": (
        lambda: _jax_sc_segment((8, 8, 8)), lambda: _jax_beam(2000, 5, sigma_tau=1e-5, sigma_p=1e-4),
        (0, "length"), 0.1,
        lambda beam, lib: lib.sum(lib.square(beam.px)),
    ),
    "space_charge_tiled": (
        lambda: _jax_sc_segment(TILED), lambda: _jax_beam(2000, 5, sigma_tau=1e-5, sigma_p=1e-4),
        (0, "length"), 0.1,
        lambda beam, lib: lib.sum(lib.square(beam.px)),
    ),
}


def _jax_value_and_grad(case, method):
    build_segment, build_beam, path, value, loss = CASES[case]

    def jax_loss(parameter, segment, beam):
        _set(segment, path, parameter)
        return loss(getattr(segment, method)(beam), jnp)

    return jax.value_and_grad(jax_loss)(jnp.asarray(value), build_segment(), build_beam())


def _port_value_and_grad(case, method):
    build_segment, build_beam, path, value, loss = CASES[case]
    segment = segment_to_torch(build_segment())
    beam = beam_to_torch(build_beam())
    parameter = torch.tensor(value, dtype=F64, requires_grad=True)
    _set(segment, path, parameter)
    result = loss(getattr(segment, method)(beam), torch)
    (grad,) = torch.autograd.grad(result, parameter)
    return result.detach(), grad


@pytest.mark.parametrize("case", list(CASES))
def test_track_checkpointed_matches_track_and_jax(case):
    expected_value, expected_grad = _jax_value_and_grad(case, "track_checkpointed")
    value, grad = _port_value_and_grad(case, "track_checkpointed")
    plain_value, plain_grad = _port_value_and_grad(case, "track")
    np.testing.assert_allclose(value.numpy(), np.asarray(expected_value), rtol=RTOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(expected_grad), rtol=RTOL, atol=0)
    assert np.any(np.asarray(expected_grad) != 0)
    # On the CPU the two ways run the same operations in the same order.
    assert torch.equal(value, plain_value) and torch.equal(grad, plain_grad)


@pytest.mark.parametrize("grid", [(8, 8, 8), TILED], ids=["untiled", "tiled"])
def test_plans_under_checkpoint(grid):
    """Forward makes one plan a deposit and one a gather on the tiled grid;
    ``track``'s backward makes none, the checkpointed backward makes them
    again with the forwards it reruns. The untiled grid makes none."""
    jax_segment, jax_beam = _jax_sc_segment(grid), _jax_beam(1000, 6, sigma_tau=1e-5)
    plans = {}
    for method in ("track", "track_checkpointed"):
        segment, beam = segment_to_torch(jax_segment), beam_to_torch(jax_beam)
        length = torch.tensor(0.1, dtype=F64, requires_grad=True)
        segment.elements[0].length = length
        before = cic_tiled.tile_plan.calls
        value = torch.sum(torch.square(getattr(segment, method)(beam).px))
        forward = cic_tiled.tile_plan.calls - before
        torch.autograd.grad(value, length)
        plans[method] = (forward, cic_tiled.tile_plan.calls - before - forward)
    tiled = grid == TILED
    assert plans == {"track": (4 * tiled, 0), "track_checkpointed": (4 * tiled, 4 * tiled)}


def test_track_checkpointed_of_a_skippable_or_empty_segment_is_track():
    beam = beam_to_torch(_jax_beam(200, 7))
    segment = segment_to_torch(jax_ares_ea_subcell(dtype=jnp.float64))
    assert torch.equal(
        segment.track_checkpointed(beam).particles, segment.track(beam).particles
    )
    assert ctt.Segment([]).track_checkpointed(beam) is beam


def test_track_checkpointed_refuses_a_beam_on_another_device():
    segment = ctt.Segment([ctt.Drift(1.0, dtype=F64, device="meta")])
    with pytest.raises(ValueError, match="device"):
        segment.track_checkpointed(beam_to_torch(_jax_beam(10, 8)))


def _jax_cold_beam_line(length: float, kicks: int):
    """The line of ``lattices.cold_beam_line`` built by the JAX package's
    structure operations from the same length."""
    a = lambda value: jnp.asarray(value, jnp.float64)  # noqa: E731
    pieces = ct.Drift(a(length), name="drift").split(a(length / (2 * kicks) * (1.0 + 1e-6)))
    elements = []
    for index, piece in enumerate(pieces):
        elements.append(piece)
        if index % 2 == 0:
            elements.append(ct.SpaceChargeKick(a(length / kicks), name=f"kick_{index // 2}"))
    return ct.Segment(elements, name="space_charge_line").with_consecutive_elements_merged()


@pytest.mark.parametrize("kicks", [3, 10])
def test_cold_beam_line_is_built_as_the_jax_package_builds_it(kicks):
    _, line = ctt.lattices.cold_beam_line(kicks, num_particles=100, dtype=F64, device=CPU,
                                          generator=torch.Generator().manual_seed(0))
    expected = _jax_cold_beam_line(float(line.length), kicks)
    assert line.explain_plan() == expected.explain_plan()
    assert len(line.explain_plan().splitlines()) == 2 * kicks + 1
    assert [type(e).__name__ for e in line.elements] == ["Drift", "SpaceChargeKick"] * kicks + [
        "Drift"
    ]
    np.testing.assert_allclose([float(e.length) for e in line.elements],
                               [float(e.length) for e in expected.elements], rtol=1e-15)


def test_cold_uniform_beam_doubles_through_a_line_built_by_split_and_merge():
    """3 kicks on 32^3 at 100k particles: the JAX test's layout and size."""
    beam, line = ctt.lattices.cold_beam_line(3, (32, 32, 32), num_particles=100_000, dtype=F64,
                                             device=CPU, generator=torch.Generator().manual_seed(0))
    out = line.track_checkpointed(beam)
    for dimension in ("sigma_x", "sigma_y", "sigma_tau"):
        ratio = (getattr(out, dimension) / getattr(beam, dimension)).item()
        assert ratio == pytest.approx(2.0, rel=2e-2), dimension


#: Operators that read device values on the host or build tensors from host
#: data: each stalls the card's stream and breaks CUDA-graph capture.
HOST_ROUND_TRIPS = ("aten::_local_scalar_dense", "aten::item", "aten::nonzero",
                    "aten::is_nonzero", "aten::lift_fresh")


@pytest.mark.parametrize("grid", [(8, 8, 8), TILED], ids=["untiled", "tiled"])
@pytest.mark.parametrize("method", ["track", "track_checkpointed"])
def test_line_value_and_grad_makes_no_host_round_trip(grid, method):
    """Seen by the profiler's operator records (a dispatch mode would make
    autograd take other formulas)."""
    beam, line = ctt.lattices.cold_beam_line(2, grid, num_particles=500, dtype=F64, device=CPU,
                                             generator=torch.Generator().manual_seed(1))
    length = line.elements[0].length.detach().clone().requires_grad_()

    def value_and_grad():
        line.elements[0].length = length
        value = torch.sum(torch.square(getattr(line, method)(beam).px))
        return torch.autograd.grad(value, length)

    value_and_grad()  # builds the cached constants
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as trace:
        value_and_grad()
    seen = {event.key for event in trace.key_averages() if event.key in HOST_ROUND_TRIPS}
    assert seen == set()
