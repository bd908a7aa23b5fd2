"""Communication-volume auditing of sharded steps (counterpart of
``cheetah_tpu/parallel/comm_audit.py``).

Multi-node linear scaling rests on one invariant: per step, the bytes moved
by collectives that cross the slow DCN axis must be O(settings + readouts),
kilobytes, never O(particles). The JAX package reads the collectives out of
a compiled HLO module. Eager PyTorch compiles nothing, so the port runs the
step under :func:`cheetah_tpu_torch.parallel.collectives.recording`, which
writes one line per collective the rank issues, forward and backward, and
parses those lines::

    report = collective_report(lambda: env.grad_step(settings, 1e-3), mesh,
                               dcn_axes=("hosts",))
    assert report.dcn_bytes < 4096

A recorded line reads like an HLO collective,
``all-reduce f64[4,3,1] replica_groups={{0,1},{2,3}}``: kind, result type
and every participant group in global ranks. The byte figure is the summed
result size of the collectives whose groups span more than one index
along a DCN axis: a lower bound of wire traffic (a ring all-reduce moves
~2x), which is what an O(particles)-against-O(readouts) audit needs.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Callable

from torch.distributed.device_mesh import DeviceMesh

from cheetah_tpu_torch.parallel import collectives

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{((?:\{[0-9, ]*\},?\s*)*)\}")
_COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                     "collective-permute", "collective-broadcast")
_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2, "s32": 4,
    "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}


@dataclasses.dataclass
class CollectiveOp:
    """One recorded collective."""

    kind: str
    output_bytes: int
    groups: list[list[int]]
    crosses: dict[str, bool]
    line: str


@dataclasses.dataclass
class CollectiveReport:
    ops: list[CollectiveOp]
    dcn_axes: tuple[str, ...]

    @property
    def dcn_bytes(self) -> int:
        """Summed output bytes of collectives spanning any DCN axis."""
        return sum(
            op.output_bytes
            for op in self.ops
            if any(op.crosses.get(axis, False) for axis in self.dcn_axes)
        )

    @property
    def total_bytes(self) -> int:
        return sum(op.output_bytes for op in self.ops)

    def bytes_crossing(self, axis: str) -> int:
        return sum(op.output_bytes for op in self.ops if op.crosses.get(axis))


def _result_bytes(line: str) -> int:
    dtype, dims = _SHAPE_RE.search(line).groups()
    size = _DTYPE_BYTES[dtype]
    for dim in filter(None, dims.split(",")):
        size *= int(dim)
    return size


def _axis_coordinates(mesh: DeviceMesh) -> dict[int, dict[str, int]]:
    """Global rank -> {axis name: index along that axis}."""
    ranks = mesh.mesh
    return {
        int(ranks[index]): dict(zip(mesh.mesh_dim_names, index))
        for index in itertools.product(*(range(size) for size in ranks.shape))
    }


def parse_collectives(hlo_text: str, mesh: DeviceMesh) -> list[CollectiveOp]:
    """Every collective in recorded text (one per line) with its volume and
    the mesh axes its groups cross."""
    coords = _axis_coordinates(mesh)
    ops = []
    for line in hlo_text.splitlines():
        stripped = line.strip()
        kind = next((k for k in _COLLECTIVE_KINDS if stripped.startswith(k + " ")), None)
        if kind is None:
            continue
        match = _GROUPS_RE.search(stripped)
        groups = (
            [[int(rank) for rank in group.split(",") if rank.strip()]
             for group in re.findall(r"\{([0-9, ]*)\}", match.group(1))]
            if match
            else [sorted(coords)]
        )
        crosses = {
            axis: any(
                len({coords[rank][axis] for rank in group if rank in coords}) > 1
                for group in groups
            )
            for axis in mesh.mesh_dim_names
        }
        ops.append(CollectiveOp(kind=kind, output_bytes=_result_bytes(stripped), groups=groups,
                                crosses=crosses, line=stripped))
    return ops


def collective_report(
    compiled: Callable[[], object] | str, mesh: DeviceMesh, dcn_axes: tuple[str, ...] = ("hosts",)
) -> CollectiveReport:
    """Audit a step against ``mesh``.

    :param compiled: The step, a function of no arguments that this rank
        runs under a recording inside :func:`collectives.active_mesh` of
        ``mesh`` (forward, and backward where it calls it), or the text of a
        recording.
    :param mesh: The mesh the step runs on.
    :param dcn_axes: Axis names that ride the data-center network.
    """
    if callable(compiled):
        with collectives.active_mesh(mesh), collectives.recording() as lines:
            compiled()
        compiled = "\n".join(lines)
    return CollectiveReport(ops=parse_collectives(compiled, mesh), dcn_axes=tuple(dcn_axes))
