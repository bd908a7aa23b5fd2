"""The configurations as data build the lattices the port ships."""

import torch

import cheetah_tpu_torch as ctt
from portbench import harness
from portbench.tests.helpers import benchmark


def test_ares_ea_config_is_the_ares_ea_subcell():
    cell = harness.load_cell("ares_ea.env_step", benchmark())
    built = harness.build_segment(ctt, cell.config, torch.float64, "cpu")
    shipped = ctt.lattices.ares_ea_subcell(torch.float64, device="cpu")
    assert len(built.elements) == len(shipped.elements) == 13
    for ours, theirs in zip(built.elements, shipped.elements):
        assert type(ours) is type(theirs)
        assert ours == theirs, (ours, theirs)


def test_every_tunable_is_a_parameter_of_the_lattice():
    cell = harness.load_cell("ares_ea.env_step", benchmark())
    built = harness.build_segment(ctt, cell.config, torch.float64, "cpu")
    for name, attribute in cell.config["tunables"]:
        assert attribute in getattr(built, name)._buffers


def test_space_charge_config_is_the_baseline_segment():
    cell = harness.load_cell("sc_segment_128.grad", benchmark())
    built = harness.build_segment(ctt, cell.config, torch.float64, "cpu")
    assert [type(e).__name__ for e in built.elements] == [
        "Drift", "SpaceChargeKick", "Drift", "SpaceChargeKick", "Drift"]
    assert all(e.grid_shape == (128, 128, 128) for e in built.elements[1::2])
    assert cell.config["beam"]["num_particles"] == 1_000_000


def test_every_config_names_its_source_and_cuts():
    bench = benchmark()
    for config in bench["configs"]:
        data = harness._read_json(harness.BENCH_DIR / "configs" / f"{config['name']}.json")
        assert data["source"] == config["source"]
        assert data["reduced"] == config["reduced"]
        assert config["file"] == f"portbench/configs/{config['name']}.json"
