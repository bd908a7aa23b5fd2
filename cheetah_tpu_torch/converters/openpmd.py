"""Native openPMD BeamPhysics particle-group HDF5 I/O (counterpart of
``cheetah_tpu/converters/openpmd.py``; the same files).

The reference delegates openPMD I/O entirely to the ``pmd_beamphysics``
package (ref ``particle_beam.py:904-1032``). Here the HDF5 layer is
implemented natively on ``h5py`` following the openPMD standard with the
BeamPhysics extension (github.com/openPMD/openPMD-standard + openPMD's
``EXT_BeamPhysics``), so beams round-trip through ``.h5`` files without any
optional dependency; when ``pmd_beamphysics`` *is* installed, its
``ParticleGroup`` objects are used instead (see
``ParticleBeam.from_openpmd_file`` / ``save_as_openpmd_h5``), and files
written by either implementation are readable by the other: the writer emits
the same flat layout (``basePath='/'``, ``particlesPath='.'``) and records
(``position/{x,y,z}`` in m, ``momentum/{x,y,z}`` in eV/c with SI ``unitSI``,
``time`` in s, ``weight`` in C, ``particleStatus``) that
``pmd_beamphysics.ParticleGroup.write`` produces, and the reader resolves
``basePath``/``particlesPath`` indirection including ``/data/%T/`` iteration
layouts.

All host-side I/O: plain numpy in, plain numpy out — beams convert at the
:class:`~cheetah_tpu_torch.particles.particle_beam.ParticleBeam` boundary,
which moves its tensors to the host (``.detach().cpu()``) to write and
builds them on the requested device when it reads.
"""

from __future__ import annotations

import numpy as np
import torch

from cheetah_tpu_torch import constants

#: SI value of 1 eV/c in kg m/s — the momentum ``unitSI`` of the BeamPhysics
#: extension's eV/c convention.
_EV_PER_C_SI = constants.elementary_charge / constants.speed_of_light

#: openPMD unitDimension exponents (L, M, T, I, theta, N, J).
_DIM_LENGTH = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
_DIM_MOMENTUM = (1.0, 1.0, -1.0, 0.0, 0.0, 0.0, 0.0)
_DIM_TIME = (0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0)
_DIM_CHARGE = (0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0)
_DIM_NONE = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


class ParticleGroupData:
    """Minimal stand-in for ``pmd_beamphysics.ParticleGroup``.

    Exposes exactly the attributes ``ParticleBeam.from_openpmd_particlegroup``
    consumes (``x, y, px, py, t, energy, weight, status, species`` — ref
    ``particle_beam.py:946-973``), with momenta in eV/c and ``energy`` the
    per-particle total energy ``sqrt(p^2 + m^2)`` in eV, matching
    ``ParticleGroup``'s derived property.
    """

    def __init__(self, data: dict):
        self.x = np.asarray(data["x"])
        self.y = np.asarray(data["y"])
        self.z = np.asarray(data["z"])
        self.px = np.asarray(data["px"])
        self.py = np.asarray(data["py"])
        self.pz = np.asarray(data["pz"])
        self.t = np.asarray(data["t"])
        self.weight = np.asarray(data["weight"])
        self.status = np.asarray(data["status"])
        self.species = str(data["species"])

    @property
    def mass_eV(self) -> float:
        from cheetah_tpu_torch.particles.species import Species

        return Species(self.species, dtype=torch.float64, device="cpu").mass_eV.item()

    @property
    def p(self) -> np.ndarray:
        """Total momentum in eV/c."""
        return np.sqrt(self.px**2 + self.py**2 + self.pz**2)

    @property
    def energy(self) -> np.ndarray:
        """Per-particle total energy in eV."""
        return np.sqrt(self.p**2 + self.mass_eV**2)

    @property
    def n_particle(self) -> int:
        return int(self.x.shape[0])


def _write_component(group, name: str, values, unit_si: float, unit_dim):
    dataset = group.create_dataset(name, data=np.asarray(values))
    dataset.attrs["unitSI"] = float(unit_si)
    dataset.attrs["unitDimension"] = np.asarray(unit_dim, dtype=np.float64)
    dataset.attrs["timeOffset"] = 0.0
    return dataset


def write_particle_group_h5(data: dict, path) -> None:
    """Write a particle-group data dict as an openPMD BeamPhysics HDF5 file.

    ``data`` uses the same keys the reference passes to
    ``openpmd.ParticleGroup(data=...)`` (ref ``particle_beam.py:1019-1030``):
    ``x, y, z`` (m), ``px, py, pz`` (eV/c), ``t`` (s), ``weight`` (C),
    ``status`` (int, 1 = alive), ``species``.
    """
    import h5py

    with h5py.File(path, "w") as h5:
        # openPMD root attributes; flat layout exactly as
        # pmd_beamphysics.interfaces (pmd_init with basePath='/',
        # particlesPath='.') writes single particle groups.
        h5.attrs["openPMD"] = np.bytes_("2.0.0")
        h5.attrs["openPMDextension"] = np.bytes_("BeamPhysics;SpeciesType")
        h5.attrs["basePath"] = np.bytes_("/")
        h5.attrs["particlesPath"] = np.bytes_(".")

        h5.attrs["speciesType"] = np.bytes_(str(data["species"]))
        h5.attrs["numParticles"] = int(np.asarray(data["x"]).shape[0])
        weight = np.asarray(data["weight"], dtype=np.float64)
        h5.attrs["totalCharge"] = float(weight.sum())
        h5.attrs["chargeUnitSI"] = 1.0

        for axis in "xyz":
            _write_component(
                h5, f"position/{axis}", data[axis], 1.0, _DIM_LENGTH
            )
        h5["position"].attrs["unitDimension"] = np.asarray(
            _DIM_LENGTH, dtype=np.float64
        )
        for axis in "xyz":
            _write_component(
                h5, f"momentum/{axis}", data[f"p{axis}"], _EV_PER_C_SI,
                _DIM_MOMENTUM,
            )
        h5["momentum"].attrs["unitDimension"] = np.asarray(
            _DIM_MOMENTUM, dtype=np.float64
        )
        _write_component(h5, "time", data["t"], 1.0, _DIM_TIME)
        _write_component(h5, "weight", data["weight"], 1.0, _DIM_CHARGE)
        _write_component(
            h5, "particleStatus",
            np.asarray(data["status"], dtype=np.int64), 1.0, _DIM_NONE,
        )


def _particle_group_nodes(h5):
    """Resolve the HDF5 group(s) holding particle records.

    Follows the openPMD ``basePath``/``particlesPath`` indirection. Flat
    layouts (``basePath='/'``) resolve to the root; series layouts
    (``basePath='/data/%T/'``) yield one node per iteration, of which the
    first is used.
    """

    def decode(value) -> str:
        return value.decode() if isinstance(value, bytes) else str(value)

    base_path = decode(h5.attrs.get("basePath", "/"))
    particles_path = decode(h5.attrs.get("particlesPath", "."))

    bases = []
    if "%T" in base_path:
        prefix = base_path.split("%T")[0].strip("/")
        container = h5[prefix] if prefix else h5

        def iteration_order(key: str):
            # Numeric iteration order ('2' before '10'), lexicographic
            # fallback for non-numeric names.
            try:
                return (0, int(key), key)
            except ValueError:
                return (1, 0, key)

        for key in sorted(container.keys(), key=iteration_order):
            bases.append(container[key])
    else:
        stripped = base_path.strip("/")
        bases.append(h5[stripped] if stripped else h5)

    nodes = []
    for base in bases:
        if particles_path in (".", "", "/"):
            nodes.append(base)
        else:
            nodes.append(base[particles_path.strip("/")])
    return nodes


def _read_component(node, name: str, si_to_native: float = 1.0) -> np.ndarray:
    dataset = node[name]
    unit_si = float(dataset.attrs.get("unitSI", 1.0))
    return np.asarray(dataset) * (unit_si * si_to_native)


def read_particle_group_h5(path) -> ParticleGroupData:
    """Read an openPMD BeamPhysics HDF5 file into :class:`ParticleGroupData`.

    Handles both the flat single-group layout this module writes and
    ``/data/%T/`` iteration layouts (first iteration); momenta are rescaled
    from their stored ``unitSI`` to eV/c.
    """
    import h5py

    with h5py.File(path, "r") as h5:
        node = _particle_group_nodes(h5)[0]
        # A particle group may itself hold named groups (ParticleGroup.write
        # with a name); descend if the records aren't at this level.
        if "position" not in node:
            candidates = [
                key for key in node.keys()
                if isinstance(node[key], h5py.Group) and "position" in node[key]
            ]
            if not candidates:
                raise ValueError(
                    f"No openPMD particle records found in '{path}'."
                )
            node = node[candidates[0]]

        def decode(value) -> str:
            return value.decode() if isinstance(value, bytes) else str(value)

        data = {
            "species": decode(node.attrs.get("speciesType", "electron")),
            "t": _read_component(node, "time"),
            "weight": _read_component(node, "weight"),
        }
        for axis in "xyz":
            data[axis] = _read_component(node, f"position/{axis}")
            data[f"p{axis}"] = _read_component(
                node, f"momentum/{axis}", si_to_native=1.0 / _EV_PER_C_SI
            )
        if "particleStatus" in node:
            data["status"] = np.asarray(node["particleStatus"])
        elif "status" in node:
            data["status"] = np.asarray(node["status"])
        else:
            data["status"] = np.ones_like(data["x"], dtype=np.int64)
    return ParticleGroupData(data)
