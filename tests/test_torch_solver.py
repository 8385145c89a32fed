"""The slice end to end: the port's ExactSolver.solve on the CPU against the
JAX package's (tie_break="first", balanced_fdtype="float64", the Pallas
switch off and on). The assignments and the node state written back into
the NodeBatch must be bit-identical. Random mode is held to the NumPy
oracle's tie set."""

import numpy as np
import pytest
from test_pallas_kernels import _interpod_cluster
from test_torch_tensorize import mixed_cluster, tensorize

import kubernetes_tpu.api.wrappers as ref_wrappers
import kubernetes_tpu_torch.api.wrappers as port_wrappers
from kubernetes_tpu.ops.oracle.profile import FullOracle, make_oracle_nodes
from kubernetes_tpu.solver.exact import ExactSolver as RefSolver
from kubernetes_tpu.solver.exact import ExactSolverConfig as RefConfig
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops import domain_counts as dc
from kubernetes_tpu_torch.solver.exact import ExactSolver

STATE = ("used", "nonzero_used", "pod_count")


def _ref_solve(inputs, pallas):
    cfg = RefConfig(tie_break="first", balanced_fdtype="float64", pallas=pallas)
    nb = inputs[0]
    solver = RefSolver(cfg)
    got = solver.solve(*inputs)
    return got, {k: getattr(nb, k) for k in STATE}, dict(solver.dispatch_counts)


def _port_solve(inputs, cfg=None):
    cfg = cfg or convert.solver_config(RefConfig(tie_break="first", balanced_fdtype="float64"))
    nb = inputs[0]
    solver = ExactSolver(cfg)
    before = dc.LAUNCHES
    got = solver.solve(*inputs, device="cpu")
    assert dc.LAUNCHES == before, "the CPU path launches no kernel"
    return got, {k: getattr(nb, k) for k in STATE}, dict(solver.dispatch_counts)


def _assert_identical(port, ref):
    """Assignments, written-back node state and the executable-dispatch
    counts (the scan, or the grouped path's chunk kinds) equal."""
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[0].dtype == np.int32
    for k in STATE:
        assert port[1][k].dtype == ref[1][k].dtype, k
        np.testing.assert_array_equal(port[1][k], ref[1][k], err_msg=k)
    assert port[2] == ref[2]


def _check_against_reference(ref_inputs_fn, port_inputs_fn=None):
    """Reference solves (Pallas off and on) and the port's solve, each on
    fresh inputs: both solvers write node state back in place."""
    ref_off = _ref_solve(ref_inputs_fn(), pallas=False)
    ref_on = _ref_solve(ref_inputs_fn(), pallas=True)
    _assert_identical(ref_on, ref_off)
    port = _port_solve(convert.solve_inputs(*ref_inputs_fn()))
    _assert_identical(port, ref_off)
    if port_inputs_fn is not None:
        _assert_identical(_port_solve(port_inputs_fn()), ref_off)
    return port[0]


def test_interpod_zone_cluster():
    """Zone-topology interpod terms share domains (ident=False), so the
    domain_counts aggregation runs in every step."""

    def ref_inputs():
        return tensorize("kubernetes_tpu", *_interpod_cluster())

    assert not ref_inputs()[5].ident
    got = _check_against_reference(ref_inputs)
    assert (got >= 0).sum() >= 12


def test_mixed_cluster_256x128():
    """256 pods on 128 nodes (already running spread/anti/port pods):
    spread hard and soft, hostname anti-affinity, preferred zone
    affinity, host ports; the same cluster tensorized by the port's own
    tensorizers too."""
    args = (128, 256, 7, 4)

    def ref_inputs():
        return tensorize("kubernetes_tpu", *mixed_cluster(ref_wrappers, *args))

    def port_inputs():
        return tensorize("kubernetes_tpu_torch", *mixed_cluster(port_wrappers, *args))

    first = ref_inputs()
    assert not first[5].ident and first[4].has_soft and first[3].num_ports > 0
    got = _check_against_reference(ref_inputs, port_inputs)
    assert (got >= 0).sum() > 200


@pytest.mark.parametrize(
    "strategy,weights",
    [("MostAllocated", (1, 1)), ("RequestedToCapacityRatio", (2, 1))],
)
def test_scoring_strategies_end_to_end(strategy, weights):
    """The other fit strategies and weights, through convert.solver_config."""
    ref_cfg = RefConfig(
        tie_break="first", balanced_fdtype="float64", scoring_strategy=strategy,
        cpu_weight=weights[0], mem_weight=weights[1],
        rtc_shape=((0, 10), (60, 4), (100, 0)),
    )

    def ref_inputs():
        return tensorize("kubernetes_tpu", *mixed_cluster(ref_wrappers, 40, 96, 3, 3))

    want = RefSolver(ref_cfg).solve(*ref_inputs())
    inputs = convert.solve_inputs(*ref_inputs())
    got = ExactSolver(convert.solver_config(ref_cfg)).solve(*inputs, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_random_tie_break_lands_in_oracle_tie_set():
    nodes, pods, _ = mixed_cluster(ref_wrappers, 48, 120, seed=5)
    inputs = convert.solve_inputs(*tensorize("kubernetes_tpu", nodes, pods, {}))
    cfg = convert.solver_config(RefConfig(tie_break="random", seed=3))
    assignments = ExactSolver(cfg).solve(*inputs, device="cpu")
    names = [inputs[0].names[a] if a >= 0 else None for a in assignments]
    oracle = FullOracle(make_oracle_nodes(nodes))
    errors = oracle.validate_assignments(pods, list(assignments), names=names)
    assert not errors, "\n".join(errors[:5])
    assert (assignments >= 0).sum() > 100


def test_trivial_tensors_resources_only():
    """No plugin tensors: the trivial ones reproduce the resources-only
    pipeline, as in the reference."""
    nodes, pods, _ = mixed_cluster(ref_wrappers, 20, 60, seed=9)
    ref = tensorize("kubernetes_tpu", nodes, pods, {})[:2]
    port = convert.solve_inputs(*tensorize("kubernetes_tpu", nodes, pods, {})[:2])
    want = RefSolver(RefConfig(tie_break="first", balanced_fdtype="float64")).solve(*ref)
    got = ExactSolver(
        convert.solver_config(RefConfig(tie_break="first", balanced_fdtype="float64"))
    ).solve(*port[:2], device="cpu")
    np.testing.assert_array_equal(got, want)
    for k in STATE:
        np.testing.assert_array_equal(getattr(port[0], k), getattr(ref[0], k))


def test_convert_copies_and_drops_pallas():
    ref = tensorize("kubernetes_tpu", *_interpod_cluster())
    port = convert.solve_inputs(*ref)
    assert not np.shares_memory(port[0].used, ref[0].used)
    assert not np.shares_memory(port[5].in_dom, ref[5].in_dom)
    cfg = convert.solver_config(RefConfig(pallas=True, seed=4, tie_break="first"))
    assert not hasattr(cfg, "pallas") and cfg.seed == 4 and cfg.tie_break == "first"


@pytest.mark.slow
def test_parity_large_shape():
    """The full 2,048 x 1,040 shape of tests/test_parity_large.py."""
    args = (1040, 2048, 7, 0)

    def ref_inputs():
        return tensorize("kubernetes_tpu", *mixed_cluster(ref_wrappers, *args))

    ref = _ref_solve(ref_inputs(), pallas=False)
    port = _port_solve(convert.solve_inputs(*ref_inputs()))
    _assert_identical(port, ref)
