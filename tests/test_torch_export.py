"""The port's deployment path (``torch.export``) against cheetah_tpu's
(``jax.export``), on the CPU in float32.

The cases of ``tests/test_export.py`` in torch's terms: a tracking step
(``segment.track(beam).sigma_x`` through Drift, Quadrupole and an active
Screen) exported, saved, loaded and called; with vectorised instances;
exported once with the particle axis symbolic and called at two particle
counts; the ahead-of-time program against eager tracking, with its cost
(FLOPs); and the ambiguous particle axis refused. The port's exported
``sigma_x`` equals the JAX package's exported result within rtol 1e-6 on
the same particles, drawn with numpy. The JAX package's pytree codec and
its export registry have no counterpart: the port's lattice is an
``nn.Module`` whose buffers the exported program carries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export

import cheetah_tpu as ct
import cheetah_tpu_torch as ctt
from cheetah_tpu.utils import aot as jax_aot
from cheetah_tpu_torch import interop
from cheetah_tpu_torch.utils import aot, profiling

CPU = "cpu"
F32 = torch.float32
RTOL = 1e-6


def build_segment(package, **kw):
    """The lattice of ``tests/test_export.py``."""
    screen_kw = {"device": CPU} if kw else {}
    return package.Segment(
        [
            package.Drift(1.0, **kw),
            package.Quadrupole(0.3, k1=8.0, name="q1",
                               metadata={"pv": "Q1:STRENGTH", "nested": {"hw": [1, 2]}}, **kw),
            package.Screen(resolution=(128, 128), is_active=True, name="scr", **screen_kw),
        ]
    )


def jax_segment():
    segment = build_segment(ct)
    segment.elements[0].length = jnp.asarray(1.0, jnp.float32)
    segment.q1.length = jnp.asarray(0.3, jnp.float32)
    segment.q1.k1 = jnp.asarray(8.0, jnp.float32)
    return segment


def port_segment():
    return build_segment(ctt, dtype=F32, device=CPU)


def beam_arrays(num_particles, seed=0):
    """A beam with beta 8 m and emittance 2e-9 in both planes at 150 MeV,
    drawn with numpy, in float32."""
    rng = np.random.default_rng(seed)
    sigmas = np.array([1.26e-4, 1.6e-5, 1.26e-4, 1.6e-5, 1e-6, 1e-6])
    particles = np.concatenate(
        [rng.normal(size=(num_particles, 6)) * sigmas, np.ones((num_particles, 1))], axis=-1
    )
    return {
        "particles": particles.astype(np.float32),
        "energy": np.asarray(1.5e8, np.float32),
        "particle_charges": np.full(num_particles, 1e-14, np.float32),
        "survival_probabilities": np.ones(num_particles, np.float32),
    }


def jax_beam(arrays):
    return ct.ParticleBeam(**{key: jnp.asarray(value) for key, value in arrays.items()})


def port_beam(arrays):
    return interop.particle_beam_from_numpy(
        arrays["particles"], arrays["energy"], arrays["particle_charges"],
        arrays["survival_probabilities"], device=CPU,
    )


def jax_step(segment, beam):
    return segment.track(beam).sigma_x


def export_port(segment, beam, dynamic_shapes, path):
    """Export the port's step, save it to ``path`` and load it back."""
    step = aot.TrackReadout(segment, "sigma_x", beam.species)
    exported = torch.export.export(step, aot.beam_arguments(beam), dynamic_shapes=dynamic_shapes)
    torch.export.save(exported, str(path))
    return torch.export.load(str(path))


def test_export_save_load_matches_jax(tmp_path):
    arrays = beam_arrays(1_000)
    beam = port_beam(arrays)
    loaded = export_port(port_segment(), beam, aot.abstract_like(beam), tmp_path / "step.pt2")
    got = loaded.module()(*aot.beam_arguments(beam))

    step = jax.jit(jax_step)
    segment, jbeam = jax_segment(), jax_beam(arrays)
    want = export.deserialize(export.export(step)(segment, jbeam).serialize()).call(segment, jbeam)
    assert got.dtype == F32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_export_vectorised_instances_matches_jax(tmp_path):
    arrays = beam_arrays(1_000, seed=1)
    segment = port_segment()
    segment.q1.k1 = torch.linspace(-20, 20, 8, dtype=F32)
    beam = port_beam(arrays)
    loaded = export_port(segment, beam, aot.abstract_like(beam), tmp_path / "vectorised.pt2")
    got = loaded.module()(*aot.beam_arguments(beam))
    assert tuple(got.shape) == (8,)

    jsegment, jbeam = jax_segment(), jax_beam(arrays)
    jsegment.q1.k1 = jnp.linspace(-20, 20, 8, dtype=jnp.float32)
    step = jax.jit(jax_step)
    want = export.deserialize(export.export(step)(jsegment, jbeam).serialize()).call(
        jsegment, jbeam)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_shape_polymorphic_export_matches_jax(tmp_path):
    """One program, the particle axis symbolic, called at two counts."""
    beam = port_beam(beam_arrays(1_000))
    loaded = export_port(port_segment(), beam, aot.symbolic_particle_beam(beam),
                         tmp_path / "symbolic.pt2")

    jsegment = jax_segment()
    step = jax.jit(jax_step)
    exported = export.export(step)(
        jax_aot.abstract_like(jsegment), jax_aot.symbolic_particle_beam(jax_beam(beam_arrays(1_000)))
    )
    rehydrated = export.deserialize(exported.serialize())
    for n in (500, 2_000):
        arrays = beam_arrays(n, seed=3)
        got = loaded.module()(*aot.beam_arguments(port_beam(arrays)))
        want = rehydrated.call(jsegment, jax_beam(arrays))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, err_msg=f"n={n}")
        eager = port_segment().track(port_beam(arrays)).sigma_x
        np.testing.assert_allclose(got.numpy(), eager.numpy(), rtol=1e-7, err_msg=f"n={n}")


def test_aot_program_runs_without_tracing_again_and_counts_its_cost():
    """The counterpart of ``test_aot_lower_compile``: the exported
    program's module runs as eager tracking does, and the step's cost
    analysis counts its matrix products."""
    arrays = beam_arrays(1_000, seed=2)
    segment, beam = port_segment(), port_beam(arrays)
    step = aot.TrackReadout(segment, "sigma_x", beam.species)
    program = torch.export.export(step, aot.beam_arguments(beam)).module()
    np.testing.assert_allclose(program(*aot.beam_arguments(beam)).numpy(),
                               segment.track(beam).sigma_x.numpy(), rtol=1e-7)
    stats = profiling.compiled_stats(step, *aot.beam_arguments(beam))
    assert stats["flops"] > 0 and stats["bytes_accessed"] > 0


def test_symbolic_beam_rejects_ambiguous_particle_count():
    """A particle count equal to the coordinate axis (7) must raise in both
    packages, not export a wrong program."""
    arrays = beam_arrays(7, seed=4)
    with pytest.raises(ValueError, match="ambiguous particle axis"):
        aot.symbolic_particle_beam(port_beam(arrays))
    with pytest.raises(ValueError, match="ambiguous particle axis"):
        jax_aot.symbolic_particle_beam(jax_beam(arrays))


def test_abstract_like_is_a_static_export():
    """Every dimension static: the program refuses another particle count."""
    beam = port_beam(beam_arrays(300))
    assert aot.abstract_like(beam) == (None,) * 5
    assert aot.abstract_like({"a": (beam.particles, [beam.energy])}) == {"a": (None, [None])}
    step = aot.TrackReadout(port_segment(), "sigma_x", beam.species)
    program = torch.export.export(step, aot.beam_arguments(beam),
                                  dynamic_shapes=aot.abstract_like(beam)).module()
    with pytest.raises(Exception, match="shape|size|Expected"):
        program(*aot.beam_arguments(port_beam(beam_arrays(400))))


def test_export_leaves_the_cached_constants_real():
    """The port caches constant tensors (the flat identity and index of
    ``matrix7``); one first built while ``torch.export`` traced would be a
    fake tensor, handed to every later call. Export from empty caches,
    then track eagerly and export again."""
    from torch._subclasses.fake_tensor import FakeTensor

    from cheetah_tpu_torch.ops import transfer_maps

    for cached in (transfer_maps._flat_identity, transfer_maps._flat_positions):
        cached.cache_clear()
    segment, beam = port_segment(), port_beam(beam_arrays(200, seed=5))
    step = aot.TrackReadout(segment, "sigma_x", beam.species)
    torch.export.export(step, aot.beam_arguments(beam))
    assert not isinstance(transfer_maps._flat_identity(F32, torch.device(CPU)), FakeTensor)
    eager = segment.track(beam).sigma_x
    program = torch.export.export(step, aot.beam_arguments(beam)).module()
    np.testing.assert_allclose(program(*aot.beam_arguments(beam)).numpy(), eager.numpy(),
                               rtol=1e-7)
