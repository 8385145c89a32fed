"""A cell of the benchmark cut to a size the CPU runs in a few seconds.

Only the scale shrinks (nodes, pods per wave, batch); the pod kinds, the
traffic and the check are the cell's own."""

from portbench import harness


def small_cell(name: str, nodes: int = 96, wave: int = 384, batch: int = 64):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell, config, params = harness.load_cell(name, bench)
    config["node_count"] = nodes
    config["wave_pods"] = wave
    config["scheduler"]["batch_size"] = batch
    return cell, config, params, bench


def run_small(name: str, seed: int = 20260101, seconds: float = 2.0, trace: bool = False,
              solver_overrides=None, **size):
    cell, config, params, bench = small_cell(name, **size)
    return harness.run_cell(cell, config, params, bench, seed, seconds, trace, device="cpu",
                            solver_overrides=solver_overrides)
