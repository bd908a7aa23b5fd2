"""The map of a fused linear run in one operator call
(``cheetah_tpu_torch/ops/fused_maps.py``, ``csrc/fused_maps.cu``).

On the CPU: the operator's plain version equals the composite (the
elements' maps multiplied one by one) bit for bit on the ARES EA run; the
dispatch takes the operator only for runs of its six kinds where nothing
tracks a gradient, and counts every other run as
``fused_run_map_composite``; the fake rule's shapes; the strides at which
the card path reads each parameter; the card path's table, launches and
chaining, run against an emulation of the kernel that reads the packed
table and the parameters' memory as the kernel does; and a compiled env
step that holds the operator in its graph and does not trace again.

Tests marked ``card`` hold the kernel against the composite on a CUDA
device (the map within 1e-6 of its largest entry in float32, 1e-13 in
float64; each instance's map as close to float64 as the composite's) and
skip without one. On the card, with no JAX installed, run
``python -m pytest tests/test_torch_fused_maps.py -m card --noconftest``.
This file imports no JAX.
"""

import collections
import ctypes
import types

import numpy as np
import pytest
import torch
from functorch.compile import make_boxed_func
from torch._dynamo.backends.common import aot_autograd
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.autograd import forward_ad
from torch.utils._python_dispatch import TorchDispatchMode

import cheetah_tpu_torch as ctt
from cheetah_tpu_torch.accelerator.segment import run_transfer_map
from cheetah_tpu_torch.ops import fused_maps
from cheetah_tpu_torch.parallel import BatchedLatticeEnv
from cheetah_tpu_torch.utils import profiling

CPU = "cpu"
F32, F64 = torch.float32, torch.float64
OPERATOR = "cheetah_tpu_torch.fused_run_map.default"
COMPOSITE = "fused_run_map_composite"
TUNABLES = [("AREAMQZM1", "k1"), ("AREAMQZM2", "k1"), ("AREAMQZM3", "k1"),
            ("AREAMCVM1", "angle"), ("AREAMCHM1", "angle")]
QUADRUPOLES = ("AREAMQZM1", "AREAMQZM2", "AREAMQZM3")
#: The kernel against the composite: the largest difference over each map's
#: largest entry.
CARD_TOLERANCE = {F32: 1e-6, F64: 1e-13}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "tests/test_torch_fused_maps.py -m card --noconftest)")
    return "cuda"


class _Operators(TorchDispatchMode):
    """The operators that run, by name."""

    def __init__(self) -> None:
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _settings(instances, dtype, seed, device=CPU):
    """The env's settings: k1 in +-20 m^-2 with exactly 0 and values within
    1e-6 of 0 among them, angles in +-1e-3 rad."""
    generator = torch.Generator().manual_seed(seed)
    settings = torch.rand(instances, 5, generator=generator, dtype=F64) * 2 - 1
    settings[:, :3] *= 20
    settings[:, 3:] *= 1e-3
    settings[0, :3] = 0.0
    settings[1, :3] = torch.tensor([1e-6, -1e-6, 3e-7], dtype=F64)
    settings[2, :3] = torch.tensor([-4e-7, 0.0, 1e-9], dtype=F64)
    return settings.to(device, dtype)


def _ares(dtype, device=CPU, instances=64, seed=0, frames=False):
    """The ARES EA subcell with the settings' columns assigned as the env
    assigns them (``settings[..., i]``, strided views); with ``frames``, a
    random tilt and misalignment on each quadrupole, per instance."""
    segment = ctt.lattices.ares_ea_subcell(dtype, device=device)
    settings = _settings(instances, dtype, seed, device)
    for index, (name, attribute) in enumerate(TUNABLES):
        setattr(getattr(segment, name), attribute, settings[..., index])
    if frames:
        generator = torch.Generator().manual_seed(seed + 1)
        for name in QUADRUPOLES:
            quadrupole = getattr(segment, name)
            quadrupole.tilt = (torch.rand(instances, generator=generator, dtype=F64) - 0.5).to(
                device, dtype)
            quadrupole.misalignment = (
                (torch.rand(instances, 2, generator=generator, dtype=F64) - 0.5) * 2e-3
            ).to(device, dtype)
    return segment


def _energy_species(dtype, device=CPU, instances=None):
    energy = torch.tensor(1.54e8, dtype=dtype, device=device)
    if instances is not None:
        energy = torch.linspace(1.0e8, 2.0e8, instances, dtype=dtype, device=device)
    return energy, ctt.Species("electron", dtype=dtype, device=device)


def _composite(elements, energy, species):
    tm = torch.eye(7, dtype=energy.dtype, device=energy.device)
    for element in elements:
        tm = element.first_order_transfer_map(energy, species) @ tm
    return tm


def _counted(fn):
    """``fn()``, the operators it ran and the runs it sent to the composite."""
    before = profiling.counters().get(COMPOSITE, 0)
    with _Operators() as operators:
        out = fn()
    return out, operators.seen[OPERATOR], profiling.counters().get(COMPOSITE, 0) - before


# ---------------------------------------------------------------------------
# The plain version and the dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frames", [False, True], ids=["aligned", "tilted_misaligned"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_plain_version_equals_the_composite_bit_for_bit(dtype, frames):
    segment = _ares(dtype, frames=frames)
    energy, species = _energy_species(dtype)
    tm, operators, composite = _counted(lambda: segment.first_order_transfer_map(energy, species))
    assert (operators, composite) == (1, 0)
    expected = _composite(segment.elements, energy, species)
    assert tm.shape == (64, 7, 7)
    assert torch.equal(tm, expected)


def _dipole_run(dtype):
    segment = _ares(dtype)
    elements = list(segment.elements)
    elements.insert(5, ctt.Dipole(0.2, angle=0.01, dtype=dtype, device=CPU))
    return elements


def _solenoid_run(dtype):
    elements = list(_ares(dtype).elements)
    elements.insert(3, ctt.Solenoid(0.1, k=1.5, dtype=dtype, device=CPU))
    return elements


class _OwnDrift(ctt.Drift):
    """A subclass, whose map the kernel cannot know."""


def _subclass_run(dtype):
    elements = list(_ares(dtype).elements)
    elements[1] = _OwnDrift(0.17504, dtype=dtype, device=CPU)
    return elements


def _nested_run(dtype):
    elements = list(_ares(dtype).elements)
    return elements[:4] + [ctt.Segment(elements[4:8])] + elements[8:]


@pytest.mark.parametrize("build, nested_runs", [
    (_dipole_run, 0), (_solenoid_run, 0), (_subclass_run, 0), (_nested_run, 1),
], ids=["dipole", "solenoid", "drift_subclass", "nested_segment"])
def test_a_run_with_another_kind_takes_the_composite(build, nested_runs):
    """The run goes to the composite; a nested segment of the six kinds
    builds its own map with the operator."""
    elements = build(F64)
    energy, species = _energy_species(F64)
    tm, operators, composite = _counted(lambda: run_transfer_map(elements, energy, species))
    assert (operators, composite) == (nested_runs, 1)
    assert torch.equal(tm, _composite(elements, energy, species))


def _k1_function(segment, energy, species):
    def transfer_map(k1):
        segment.AREAMQZM2.k1 = k1
        return run_transfer_map(list(segment.elements), energy, species)

    return transfer_map


@pytest.mark.parametrize("tracking", ["requires_grad", "energy_requires_grad", "func_grad",
                                      "vmap", "forward_ad"])
def test_a_tracked_gradient_takes_the_composite(tracking):
    """A grad-tracked ``k1`` or energy, ``torch.func.grad`` and ``vmap``
    over ``k1``, and a forward-mode level: each run goes to the composite,
    which differentiates; the values equal the composite's."""
    segment = _ares(F64, instances=8)
    energy, species = _energy_species(F64)
    transfer_map = _k1_function(segment, energy, species)
    k1 = torch.linspace(-12.0, 9.0, 8, dtype=F64)
    expected = transfer_map(k1.clone())
    if tracking == "requires_grad":
        run = lambda: transfer_map(k1.clone().requires_grad_())  # noqa: E731
    elif tracking == "energy_requires_grad":
        energy.requires_grad_()
        run = lambda: transfer_map(k1.clone())  # noqa: E731
    elif tracking == "func_grad":
        run = lambda: torch.func.grad(lambda k: transfer_map(k)[..., 0, 0].sum())(k1)  # noqa: E731
    elif tracking == "vmap":
        # Sample i's map of instance i is the unbatched map's instance i.
        diagonal = torch.arange(8)
        run = lambda: torch.func.vmap(transfer_map)(k1[:, None])[diagonal, diagonal]  # noqa: E731
    else:

        def run():
            with forward_ad.dual_level():
                dual = forward_ad.make_dual(k1, torch.ones_like(k1))
                return forward_ad.unpack_dual(transfer_map(dual)).primal

    out, operators, composite = _counted(run)
    assert operators == 0 and composite >= 1
    if tracking == "func_grad":
        assert bool(torch.isfinite(out).all())
    else:
        np.testing.assert_allclose(out.detach().numpy(), expected.numpy(), rtol=1e-13, atol=1e-15)


def test_a_gradient_through_the_composite_is_the_one_before():
    """Where ``k1`` tracks a gradient the map differentiates as before."""
    segment = _ares(F64, instances=8)
    energy, species = _energy_species(F64)
    k1 = torch.linspace(-12.0, 9.0, 8, dtype=F64, requires_grad=True)
    segment.AREAMQZM2.k1 = k1
    tm = segment.first_order_transfer_map(energy, species)
    (grad,) = torch.autograd.grad(tm[..., 0, 1].sum(), k1)
    (expected,) = torch.autograd.grad(
        _composite(segment.elements, energy, species)[..., 0, 1].sum(), k1)
    assert torch.equal(grad, expected)


def test_a_bracket_folds_its_runs_with_the_operator():
    """A second-order element's bracket builds its up- and downstream maps
    as runs; its folded tensor equals the one built element by element."""
    dtype = F64
    segment = _ares(dtype, instances=4)
    segment.AREAMQZM2.tracking_method = "second_order"
    energy, species = _energy_species(dtype)
    (bracket,) = segment._plan()
    T, operators, composite = _counted(
        lambda: bracket.fused_second_order_transfer_map(energy, species))
    assert (operators, composite) == (2, 0)
    M = _composite(bracket.upstream, energy, species)
    R = _composite(bracket.downstream, energy, species)
    expected = bracket.element.second_order_transfer_map(energy, species)
    expected = torch.einsum("...ijk,...ja,...kb->...iab", expected, M, M)
    expected = torch.einsum("...il,...ljk->...ijk", R, expected)
    assert torch.equal(T, expected)


# ---------------------------------------------------------------------------
# Shapes and strides
# ---------------------------------------------------------------------------


def _broadcast_inputs(device, dtype=F32):
    """A quadrupole and a corrector whose parameters broadcast to (2, 2048)."""
    empty = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
    parameters = [empty(), empty(2, 1), empty(2), empty(), empty(), empty(2048)]
    return parameters, empty(), empty(), [fused_maps.QUADRUPOLE, fused_maps.VERTICAL_CORRECTOR]


def test_fake_rule_gives_the_broadcast_shape():
    parameters, energy, mass, opcodes = _broadcast_inputs("meta")
    out = fused_maps.FUSED_RUN_MAP(parameters, energy, mass, opcodes)
    assert out.shape == (2, 2048, 7, 7) and out.dtype == F32
    parameters, energy, mass, _ = _broadcast_inputs(CPU)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(tensor) for tensor in (*parameters, energy, mass)]
        out = fused_maps.FUSED_RUN_MAP(fake[:-2], fake[-2], fake[-1], opcodes)
    assert out.shape == (2, 2048, 7, 7)
    markers = fused_maps.FUSED_RUN_MAP(
        [], torch.zeros(5, device="meta"), torch.zeros(3, device="meta"), [fused_maps.MARKER])
    assert markers.shape == (5, 7, 7)


def test_plain_version_gives_the_fake_rules_shape():
    parameters, energy, mass, opcodes = _broadcast_inputs(CPU)
    mass = mass + ctt.Species("electron", dtype=F32, device=CPU).mass_eV
    energy = energy + 1e8
    parameters[0] = parameters[0] + 0.2
    out = fused_maps.FUSED_RUN_MAP(parameters, energy, mass, opcodes)
    assert out.shape == (2, 2048, 7, 7)
    with pytest.raises(ValueError, match="parameters for 2 opcodes taking 6"):
        fused_maps.FUSED_RUN_MAP(parameters[:-1], energy, mass, opcodes)


STRIDE_CASES = {
    "scalar": (lambda: torch.zeros(()), (4, 5)),
    "row": (lambda: torch.zeros(5), (4, 5)),
    "full": (lambda: torch.zeros(4, 5), (4, 5)),
    "settings_column": (lambda: torch.zeros(4, 5, 3)[..., 1], (4, 5)),
    "transposed": (lambda: torch.zeros(5, 4).T, (4, 5)),
    "column_broadcast": (lambda: torch.zeros(4, 1), (4, 5)),
    "leading_one": (lambda: torch.zeros(1, 5), (4, 5)),
    "unit_axes": (lambda: torch.zeros(3, 1, 6)[:, :, 2], (1, 3, 1)),
    "flipped": (lambda: torch.zeros(6).flip(0), (6,)),
    "inner_broadcast": (lambda: torch.zeros(3, 1, 4), (3, 2, 4)),
}


@pytest.mark.parametrize("case", list(STRIDE_CASES))
def test_instance_stride_reads_the_broadcast_tensor(case):
    """Where a single stride is returned, element ``n`` of the flattened
    broadcast lies ``n`` strides past the first; where none is, the
    broadcast's offsets are no arithmetic progression."""
    make, vector_shape = STRIDE_CASES[case]
    tensor = make()
    stride = fused_maps._instance_stride(tensor.shape, tensor.stride(), vector_shape)
    expanded = tensor.expand(vector_shape)
    offsets = [
        sum(index * step for index, step in zip(np.unravel_index(n, vector_shape),
                                                expanded.stride()))
        for n in range(int(np.prod(vector_shape)))
    ]
    progression = all(b - a == offsets[1] - offsets[0] for a, b in zip(offsets, offsets[1:])) \
        if len(offsets) > 1 else True
    if stride is None:
        assert not progression
    else:
        assert offsets == [stride * n for n in range(len(offsets))]


# ---------------------------------------------------------------------------
# The card path against an emulation of the kernel
# ---------------------------------------------------------------------------


def _emulated_launch(calls):
    """``LIBRARY.launch`` replaced by a reading of what the kernel reads: the
    packed table (5 + 11 * count int64 words), each parameter at its address
    and stride for every instance, the product to start from at ``init``;
    the maps are the plain builders', written to ``out``."""

    def launch(name, dtype, device, table, instances, init, out):
        assert name == "fused_run_map" and device.type == CPU
        header = list((ctypes.c_int64 * 5).from_address(table))
        count = header[4]
        assert 1 <= count <= fused_maps.MAX_ENTRIES
        words = list((ctypes.c_int64 * (11 * count)).from_address(table + 40))
        scalar = ctypes.c_float if dtype == F32 else ctypes.c_double
        size = ctypes.sizeof(scalar)

        def read(address, stride):
            return torch.tensor([scalar.from_address(address + size * stride * n).value
                                 for n in range(instances)], dtype=dtype)

        energy = read(*header[0:2])
        species = types.SimpleNamespace(mass_eV=read(*header[2:4]))
        if init:
            values = (scalar * (49 * instances)).from_address(init)
            tm = torch.tensor(list(values), dtype=dtype).reshape(instances, 7, 7)
        else:
            tm = torch.eye(7, dtype=dtype).expand(instances, 7, 7)
        for entry in range(count):
            opcode, *slots = words[11 * entry: 11 * entry + 11]
            arguments = []
            for pair in fused_maps.KINDS[opcode].pairs:
                if pair:
                    arguments.append(torch.stack([read(*slots[0:2]), read(*slots[2:4])], -1))
                    slots = slots[4:]
                else:
                    arguments.append(read(*slots[0:2]))
                    slots = slots[2:]
            assert not any(slots), "unused slots are zero"
            tm = fused_maps.KINDS[opcode].build(*arguments, energy, species) @ tm
        result = tm.contiguous()
        ctypes.memmove(out, result.data_ptr(), result.numel() * size)
        calls.append((count, bool(init)))

    return launch


def _long_run(dtype, instances, device=CPU, repeats=6):
    """``repeats`` copies of the ARES run's elements, 13 each, with the
    settings' columns on the quadrupoles and correctors."""
    elements = []
    for repeat in range(repeats):
        elements += list(_ares(dtype, device, instances, seed=repeat, frames=repeat % 2 == 1)
                         .elements)
    return elements


def _emulation_cases(dtype):
    instances = 6
    ares = list(_ares(dtype, instances=instances, frames=True).elements)
    transposed = _ares(dtype, instances=instances)
    for name in QUADRUPOLES:
        quadrupole = getattr(transposed, name)
        quadrupole.misalignment = torch.rand(2, instances, dtype=dtype).T * 1e-3
    broadcast = _ares(dtype, instances=instances)
    broadcast.AREAMQZM1.k1 = torch.tensor([[3.0], [-5.0]], dtype=dtype)
    broadcast.AREAMCHM1.angle = torch.linspace(-1e-3, 1e-3, 5, dtype=dtype)
    broadcast.AREAMQZM2.k1 = torch.tensor(-4.0, dtype=dtype)
    broadcast.AREAMQZM3.k1 = torch.tensor(7.0, dtype=dtype)
    broadcast.AREAMCVM1.angle = torch.tensor(2e-4, dtype=dtype)
    combined = [ctt.Drift(0.3, dtype=dtype, device=CPU),
                ctt.CombinedCorrector(0.1, torch.linspace(-1e-3, 1e-3, instances, dtype=dtype),
                                      torch.full((instances,), 5e-4, dtype=dtype),
                                      dtype=dtype, device=CPU),
                ctt.Marker(dtype=dtype, device=CPU)]
    return {
        "ares_frames": (ares, None, 1),
        "ares_energy_per_instance": (ares, instances, 1),
        "transposed_misalignment": (list(transposed.elements), None, 1),
        "broadcast_2x5": (list(broadcast.elements), None, 1),
        "combined_corrector": (combined, None, 1),
        "markers": ([ctt.Marker(dtype=dtype, device=CPU)] * 3, instances, 1),
        "long_run": (_long_run(dtype, instances), None, 3),
    }


@pytest.mark.parametrize("case", ["ares_frames", "ares_energy_per_instance",
                                  "transposed_misalignment", "broadcast_2x5",
                                  "combined_corrector", "markers", "long_run"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_card_path_packs_what_the_kernel_reads(monkeypatch, dtype, case):
    """The card path, run on CPU tensors with its launch emulated: one
    launch per ``MAX_ENTRIES`` elements, each counted, the later ones
    starting from the product the first wrote, and the maps the plain
    version's."""
    elements, energy_instances, launches = _emulation_cases(dtype)[case]
    energy, species = _energy_species(dtype, instances=energy_instances)
    opcodes = [element.fused_opcode for element in elements]
    parameters = [getattr(element, name) for element, opcode in zip(elements, opcodes)
                  for name in fused_maps.KINDS[opcode].attributes]
    calls = []
    monkeypatch.setattr(fused_maps.LIBRARY, "launch", _emulated_launch(calls))
    before = profiling.counters().get("fused_run_map", 0)
    actual = fused_maps._kernel(parameters, energy, species.mass_eV, opcodes)
    assert profiling.counters()["fused_run_map"] == before + launches
    assert [init for _, init in calls] == [False] + [True] * (launches - 1)
    assert sum(count for count, _ in calls) == len(elements)
    expected = fused_maps._plain(parameters, energy, species.mass_eV, opcodes)
    assert actual.shape == expected.shape
    torch.testing.assert_close(actual, expected, rtol=1e-12 if dtype == F64 else 1e-6,
                               atol=0)


# ---------------------------------------------------------------------------
# Compiled
# ---------------------------------------------------------------------------


def test_compiled_env_step_holds_the_operator_and_does_not_trace_again():
    """``BatchedLatticeEnv.step`` under ``torch.compile(fullgraph=True)``:
    the fused run is one ``fused_run_map`` in the graph, new settings do
    not trace again, and both calls equal the eager step."""
    generator = torch.Generator().manual_seed(5)
    beam = ctt.ParticleBeam.from_twiss(
        num_particles=200, beta_x=5.0, emittance_x=2e-9, beta_y=3.0, emittance_y=2e-9,
        energy=1.54e8, dtype=F64, device=CPU, generator=generator,
    )
    env = BatchedLatticeEnv(ctt.lattices.ares_ea_subcell(F64, device=CPU), beam, TUNABLES)
    graphs = []

    def record(graph_module, example_inputs):
        graphs.append(collections.Counter(
            str(node.target) for node in graph_module.graph.nodes if node.op == "call_function"
        ))
        return make_boxed_func(graph_module.forward)

    torch._dynamo.reset()
    try:
        compiled = torch.compile(env.step, fullgraph=True, dynamic=False,
                                 backend=aot_autograd(fw_compiler=record))
        for index, seed in enumerate((1, 2)):
            settings = _settings(6, F64, seed)
            with torch._dynamo.config.patch(error_on_recompile=index > 0):
                reward = compiled(settings)[2]
            torch.testing.assert_close(reward, env.step(settings)[2], rtol=1e-12, atol=0)
    finally:
        torch._dynamo.reset()
    assert len(graphs) == 1
    assert graphs[0][OPERATOR] == 1


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card_case(case, dtype, device):
    """Elements, energy and the launches the kernel makes for a card case,
    at 4096 instances."""
    instances = 4096
    energy_instances = None
    if case == "broadcast_2x2048":
        segment = _ares(dtype, device, instances=2048)
        segment.AREAMQZM1.k1 = torch.tensor([[12.0], [-7.5]], dtype=dtype, device=device)
        segment.AREAMQZM3.k1 = _settings(4096, dtype, 9, device)[:, 0].reshape(2, 2048)
        elements, launches = list(segment.elements), 1
    elif case == "long_run":
        elements, launches = _long_run(dtype, instances, device), 3
    else:
        segment = _ares(dtype, device, instances, frames=case != "aligned")
        elements, launches = list(segment.elements), 1
        energy_instances = instances if case == "energy_per_instance" else None
    energy, species = _energy_species(dtype, device, energy_instances)
    return elements, energy, species, launches


def _float64(elements, energy):
    """The run's elements and energy in float64: the composite's map of the
    same inputs without the rounding of float32."""
    copies = [element.clone() for element in elements]
    for copy in copies:
        copy.double()
    species = ctt.Species("electron", dtype=F64, device=energy.device)
    return _composite(copies, energy.double(), species)


def _per_map(actual, expected):
    """Each instance's largest difference over its map's largest entry."""
    difference = (actual.double() - expected.double()).abs().amax(dim=(-2, -1))
    return difference / expected.double().abs().amax(dim=(-2, -1))


@pytest.mark.card
@pytest.mark.parametrize("case", ["aligned", "tilted_misaligned", "energy_per_instance",
                                  "broadcast_2x2048", "long_run"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_card_kernel_matches_the_composite(card, dtype, case):
    """The kernel's maps against the composite's on the card: the largest
    difference within the tolerance of the largest entry; in float64 each
    instance's map within it; in float32 each instance's map no farther
    from the float64 map of the same inputs than the composite's farthest
    map (or the tolerance), since the composite's own rounding in float32
    reaches 1.6e-6 of an instance's map (tilted) and 3e-5 in the long run
    on the H100."""
    elements, energy, species, launches = _card_case(case, dtype, card)
    before = profiling.counters()
    actual = run_transfer_map(elements, energy, species)
    after = profiling.counters()
    assert after.get("fused_run_map", 0) - before.get("fused_run_map", 0) == launches
    assert after.get(COMPOSITE, 0) == before.get(COMPOSITE, 0)
    expected = _composite(elements, energy, species)
    assert actual.shape == expected.shape and actual.dtype == dtype
    assert bool(torch.isfinite(actual).all())
    whole = (actual - expected).abs().max() / expected.abs().max()
    assert whole.item() <= CARD_TOLERANCE[dtype], whole.item()
    if dtype == F64:
        assert _per_map(actual, expected).max().item() <= CARD_TOLERANCE[F64]
        return
    reference = _float64(elements, energy)
    kernel_error = _per_map(actual, reference).max().item()
    composite_error = _per_map(expected, reference).max().item()
    assert kernel_error <= max(CARD_TOLERANCE[F32], 1.5 * composite_error), (
        kernel_error, composite_error)
