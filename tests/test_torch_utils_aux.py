"""The port's auxiliary modules on the CPU: ``utils.profiling`` (the host
timer of CPU tensors, and ``compiled_stats``, whose FLOPs for a linear
track equal the matrix products' analytic count), ``utils.vector`` against
the JAX package's, ``utils.tree``'s ``tree_equal`` and ``replace``, and
``Element.to_mesh`` / ``Segment.to_mesh`` against the JAX package's with a
fake ``trimesh`` and a fabricated asset cache (as
``tests/test_3d_visualization.py``), the download stubbed to fail as it
does offline, so that nothing is fetched.
"""

import sys
import types
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cheetah_tpu as ct
import cheetah_tpu_torch as ctt
from cheetah_tpu.utils.vector import squash_index_for_unavailable_dims as jax_squash
from cheetah_tpu_torch.utils import profiling, tree_equal, replace
from cheetah_tpu_torch.utils.vector import squash_index_for_unavailable_dims

CPU = "cpu"
F64 = torch.float64


def _beam(num_particles, seed=0):
    generator = torch.Generator().manual_seed(seed)
    return ctt.ParticleBeam.from_parameters(
        num_particles=num_particles, energy=1e8, generator=generator, dtype=F64, device=CPU
    )


# ----------------------------------------------------------------------
# Profiling
# ----------------------------------------------------------------------


@pytest.mark.parametrize("force_fetch", [True, False])
def test_benchmark_times_cpu_tensors_on_the_host(force_fetch):
    drift, beam = ctt.Drift(1.0, dtype=F64, device=CPU), _beam(100)
    stats = profiling.benchmark(lambda d, b: d.track(b).particles, drift, beam, iters=3,
                                force_fetch=force_fetch)
    assert set(stats) == {"mean_ms", "min_ms", "timings_ms"}
    assert len(stats["timings_ms"]) == 3
    assert 0 < stats["min_ms"] <= stats["mean_ms"]


def test_timeit_slope_is_seconds_per_step():
    """A step that sleeps 2 ms takes about 2 ms a step; the fixed cost of a
    measurement cancels in the slope."""
    import time

    def step(x):
        time.sleep(2e-3)
        return x + 1

    seconds = profiling.timeit_slope(step, torch.zeros(3), iters=5, repeats=2)
    assert 1.5e-3 < seconds < 10e-3


@pytest.mark.parametrize("num_particles", [100, 1000])
def test_compiled_stats_counts_a_linear_track(num_particles):
    """A lone element tracks as ``particles @ R^T``: 2 N 7 7 FLOPs. A
    segment of three elements composes their maps onto the identity first
    (three 7x7 products, 2 * 7^3 FLOPs each), the quadrupole's map turned
    by its tilt (two more), and applies the product once."""
    beam = _beam(num_particles)
    drift = ctt.Drift(1.0, dtype=F64, device=CPU)
    stats = profiling.compiled_stats(lambda d, b: d.track(b).particles, drift, beam)
    assert stats["flops"] == 2 * num_particles * 7 * 7
    # Reading the particles and writing the result, at the least.
    assert stats["bytes_accessed"] >= 2 * num_particles * 7 * 8

    kw = {"dtype": F64, "device": CPU}
    segment = ctt.Segment([ctt.Drift(1.0, **kw), ctt.Quadrupole(0.2, k1=3.0, **kw),
                           ctt.Drift(0.5, **kw)])
    stats = profiling.compiled_stats(lambda s, b: s.track(b).particles, segment, beam)
    assert stats["flops"] == 2 * num_particles * 7 * 7 + (3 + 2) * 2 * 7**3


def test_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        ctt.Drift(1.0, dtype=F64, device=CPU).track(_beam(10))
    assert list(tmp_path.glob("*.json"))


# ----------------------------------------------------------------------
# Vector indices, tree equality
# ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "index, shape",
    [((1, 2), (2, 1)), ((1, 2), (3,)), ((1, 2), (2, 3)), (None, (2,)), ((0, 1, 2), (1, 1, 4)),
     ((3,), ())],
)
def test_squash_index_matches_jax(index, shape):
    assert squash_index_for_unavailable_dims(index, shape) == jax_squash(index, shape)


def test_tree_equal_and_replace():
    kw = {"dtype": F64, "device": CPU}
    quadrupole = ctt.Quadrupole(0.2, k1=3.0, name="q", **kw)
    assert tree_equal(quadrupole, ctt.Quadrupole(0.2, k1=3.0, name="q", **kw))
    changed = replace(quadrupole, k1=torch.tensor(4.0, dtype=F64))
    assert float(changed.k1) == 4.0 and float(quadrupole.k1) == 3.0
    assert not tree_equal(quadrupole, changed)
    assert not tree_equal(quadrupole, ctt.Drift(0.2, **kw))
    beam = _beam(20)
    assert tree_equal(beam, beam.clone())
    assert not tree_equal(beam, replace(beam, energy=torch.tensor(2e8, dtype=F64)))


# ----------------------------------------------------------------------
# 3D meshes with a fake trimesh
# ----------------------------------------------------------------------


class FakeMesh:
    def __init__(self):
        self.extents = (1.0, 1.0, 2.0)  # 2 m long along the beam (z) axis
        self.scales = []
        self.transforms = []

    def apply_scale(self, scale):
        self.scales.append(float(scale))

    def apply_transform(self, transform):
        self.transforms.append(np.asarray(transform))


class FakeScene:
    def __init__(self):
        self.geometries = []

    def add_geometry(self, geometry):
        if geometry is not None:
            self.geometries.append(geometry)


@pytest.fixture
def fake_trimesh(monkeypatch, tmp_path):
    """A stub ``trimesh``, an asset cache with meshes for drift, quadrupole
    and horizontal_corrector (not bpm), and a download that fails."""
    transformations = types.ModuleType("trimesh.transformations")

    def translation_matrix(direction):
        matrix = np.eye(4)
        matrix[:3, 3] = direction
        return matrix

    transformations.translation_matrix = translation_matrix
    transformations.identity_matrix = lambda: np.eye(4)
    trimesh = types.ModuleType("trimesh")
    trimesh.transformations = transformations
    trimesh.Scene = FakeScene
    trimesh.load_mesh = lambda path: FakeMesh()
    monkeypatch.setitem(sys.modules, "trimesh", trimesh)
    monkeypatch.setitem(sys.modules, "trimesh.transformations", transformations)

    asset_dir = tmp_path / "assets" / "v1.2.0"
    asset_dir.mkdir(parents=True)
    for name in ("drift", "quadrupole", "horizontal_corrector"):
        (asset_dir / f"{name}.glb").write_bytes(b"fake-glb")
    monkeypatch.setenv("CHEETAH_TPU_ASSETS", str(tmp_path / "assets"))

    requested = []

    def offline(url, path):
        requested.append(url)
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlretrieve", offline)
    return requested


def test_element_to_mesh_matches_jax(fake_trimesh):
    ours, our_transform = ctt.Quadrupole(0.2, dtype=F64, device=CPU, name="q1").to_mesh(
        cuteness={"q1": 3.0}, show_download_progress=False)
    theirs, their_transform = ct.Quadrupole(jnp.asarray(0.2), name="q1").to_mesh(
        cuteness={"q1": 3.0}, show_download_progress=False)
    assert ours.scales == theirs.scales == [pytest.approx(0.1), pytest.approx(3.0)]
    np.testing.assert_array_equal(our_transform, their_transform)


def test_segment_to_mesh_matches_jax(fake_trimesh):
    lengths = (0.3, 0.2, 0.1, 0.1, 0.3)

    def build(package, **kw):
        return package.Segment([
            package.Drift(lengths[0], **kw), package.Quadrupole(lengths[1], **kw),
            package.Drift(lengths[2], **kw), package.HorizontalCorrector(lengths[3], **kw),
            package.Drift(lengths[4], **kw),
        ])

    scene, transform = build(ctt, dtype=F64, device=CPU).to_mesh(show_download_progress=False)
    jax_scene, jax_transform = build(ct).to_mesh(show_download_progress=False)
    np.testing.assert_allclose(transform, jax_transform, rtol=1e-15)
    np.testing.assert_allclose(transform[:3, 3], [0.0, 0.0, 1.0])
    placements = [mesh.transforms[0][2, 3] for mesh in scene.geometries]
    np.testing.assert_allclose(placements, [m.transforms[0][2, 3] for m in jax_scene.geometries])
    np.testing.assert_allclose(placements, [0.0, 0.3, 0.5, 0.6, 0.7])


def test_missing_asset_warns_offline(fake_trimesh):
    """No cached BPM mesh and no network: ``None`` and a warning, as in the
    JAX package; the download was attempted once and failed."""
    with pytest.warns(ctt.VisualizationWarning, match="bpm1 of type BPM"):
        mesh, transform = ctt.BPM(name="bpm1", device=CPU).to_mesh()
    assert mesh is None
    np.testing.assert_allclose(transform, np.eye(4))
    assert len(fake_trimesh) == 1 and fake_trimesh[0].endswith("/v1.2.0/b_p_m.glb")


def test_zero_length_warning(fake_trimesh):
    with pytest.warns(ctt.VisualizationWarning, match="length of zero"):
        mesh, transform = ctt.HorizontalCorrector(0.0, name="h1", dtype=F64,
                                                  device=CPU).to_mesh()
    assert isinstance(mesh, FakeMesh)
    np.testing.assert_allclose(transform[:3, 3], [0.0, 0.0, 0.0])


def test_to_mesh_without_trimesh_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "trimesh", None)
    with pytest.raises(ImportError, match="trimesh"):
        ctt.Drift(1.0, dtype=F64, device=CPU).to_mesh()
