"""The golden consistency corpus (``tests/resources/consistency/``) through
the PyTorch port on the CPU, in float64.

The corpus holds the outgoing beams of every case of ``tests/element_zoo.py``
as the torch reference computed them: each element case with the stored
3000-particle beam, the ``param_*`` cases with a ``ParameterBeam``, and the
composite cases (CustomTransferMap, Superimposed, nested segments, a
space-charge segment with a charged beam, an active cavity). The port builds
the same cases from the same specs and is held to the tolerances of
``tests/test_consistency.py``: particles and moments rtol 1e-8 (atol 1e-14 on
particles and means, 1e-18 on covariances), energy, survival probabilities,
total charge and ``s`` rtol 1e-12. The space-charge segment needs no
tolerance of its own.
"""

import pathlib
import warnings

import numpy as np
import pytest
import torch
from element_zoo import (
    COMPOSITE_CASES,
    ELEMENT_CASES,
    PARAMETER_ELEMENT_INDICES,
    _composite_builders,
)

import cheetah_tpu_torch as ctt

RESOURCES = pathlib.Path(__file__).parent / "resources" / "consistency"
F64 = torch.float64
CPU = "cpu"

PARITY_CASES = [
    (index, class_name, spec)
    for index, (class_name, spec, parity) in enumerate(ELEMENT_CASES)
    if spec is not None and parity
]
PARAMETER_CASES = [
    (index, ELEMENT_CASES[index][0], ELEMENT_CASES[index][1])
    for index in PARAMETER_ELEMENT_INDICES
]
PARAMETER_MOMENTS = dict(mu_x=1e-4, mu_px=-2e-5, sigma_x=1.7e-4, sigma_px=4e-6,
                         sigma_y=1.7e-4, sigma_py=4e-6, sigma_tau=1e-5, sigma_p=1e-3,
                         cov_xpx=1e-10, energy=1.5e8, total_charge=1e-9)


def build_element(class_name: str, spec: dict):
    """The port's element of a zoo spec: numbers and lists as float64
    tensors, ``num_steps``, ``binning`` and strings as they are."""
    kwargs = {
        key: (
            torch.tensor(value, dtype=F64)
            if isinstance(value, (float, list))
            or (isinstance(value, int) and not isinstance(value, bool)
                and key not in ("num_steps", "binning"))
            else value
        )
        for key, value in spec.items()
    }
    return getattr(ctt, class_name)(**kwargs, dtype=F64, device=CPU)


def build_composite(name: str):
    return _composite_builders(ctt, lambda v: torch.tensor(v, dtype=F64))[name]()


def incoming(charged: bool = False) -> ctt.ParticleBeam:
    particles = torch.tensor(np.load(RESOURCES / "incoming.npz")["particles"], dtype=F64)
    charges = None
    if charged:
        charges = torch.full((particles.shape[-2],), 1e-9 / particles.shape[-2], dtype=F64)
    return ctt.ParticleBeam(particles, torch.tensor(1.5e8, dtype=F64),
                            particle_charges=charges)


def parameter_incoming() -> ctt.ParameterBeam:
    return ctt.ParameterBeam.from_parameters(**PARAMETER_MOMENTS, dtype=F64, device=CPU)


def assert_particle_golden(outgoing, golden, name) -> None:
    np.testing.assert_allclose(outgoing.particles.numpy(), golden["particles"], rtol=1e-8,
                               atol=1e-14, err_msg=name)
    np.testing.assert_allclose(outgoing.energy.numpy(), golden["energy"], rtol=1e-12)
    np.testing.assert_allclose(outgoing.survival_probabilities.numpy(),
                               golden["survival_probabilities"], rtol=1e-12, atol=0)


def assert_parameter_golden(outgoing, golden, name) -> None:
    np.testing.assert_allclose(outgoing.mu.numpy(), golden["mu"], rtol=1e-8, atol=1e-14,
                               err_msg=name)
    np.testing.assert_allclose(outgoing.cov.numpy(), golden["cov"], rtol=1e-8, atol=1e-18,
                               err_msg=name)
    np.testing.assert_allclose(outgoing.energy.numpy(), golden["energy"], rtol=1e-12)
    np.testing.assert_allclose(outgoing.s.numpy(), golden["s"], rtol=1e-12, atol=1e-15)


def test_port_covers_the_whole_corpus():
    """Every golden file is a case here, and every element type of the zoo
    is a class of the port."""
    files = {path.name for path in RESOURCES.glob("*.npz")} - {"incoming.npz"}
    cases = (
        {f"{index:03d}_{class_name}.npz" for index, class_name, _ in PARITY_CASES}
        | {f"param_{index:03d}_{class_name}.npz" for index, class_name, _ in PARAMETER_CASES}
        | {f"composite_{name}_{kind}.npz" for name, kind in COMPOSITE_CASES}
    )
    assert files == cases
    # 66 files: the 65 cases and the incoming beam.
    assert len(files) == 65
    for class_name, _, _ in ELEMENT_CASES:
        assert hasattr(ctt, class_name), class_name


@pytest.mark.parametrize("index, class_name, spec", PARITY_CASES,
                         ids=[f"{c}-{i}" for i, c, _ in PARITY_CASES])
def test_golden_consistency(index, class_name, spec):
    outgoing = build_element(class_name, spec).track(incoming())
    golden = np.load(RESOURCES / f"{index:03d}_{class_name}.npz")
    assert_particle_golden(outgoing, golden, class_name)
    np.testing.assert_allclose(outgoing.s.numpy(), golden["s"], rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("index, class_name, spec", PARAMETER_CASES,
                         ids=[f"{c}-{i}" for i, c, _ in PARAMETER_CASES])
def test_golden_consistency_parameter_beam(index, class_name, spec):
    element = build_element(class_name, spec)
    with warnings.catch_warnings():
        # An aperture lets a ParameterBeam through with a warning.
        warnings.simplefilter("ignore")
        outgoing = element.track(parameter_incoming())
    golden = np.load(RESOURCES / f"param_{index:03d}_{class_name}.npz")
    assert_parameter_golden(outgoing, golden, class_name)
    np.testing.assert_allclose(outgoing.total_charge.numpy(), golden["total_charge"],
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("name, beam_kind", COMPOSITE_CASES,
                         ids=[f"{n}-{b}" for n, b in COMPOSITE_CASES])
def test_golden_consistency_composite(name, beam_kind):
    element = build_composite(name)
    golden = np.load(RESOURCES / f"composite_{name}_{beam_kind}.npz")
    if beam_kind == "parameter":
        assert_parameter_golden(element.track(parameter_incoming()), golden, name)
        return
    assert_particle_golden(element.track(incoming(charged=beam_kind == "charged")), golden,
                           name)
