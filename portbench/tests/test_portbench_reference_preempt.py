"""``reference_preempt`` on the CPU: the port's Scheduler, driven through
``Run.call`` and ``run_cell`` on 64 nodes with upstream PreemptionBasic's
shapes (4 CPU / 32Gi / 110-pod nodes; four priority-1 pods of 900m / 500Mi a
node, bound first; then priority-10 preemptors of 3,000m / 500Mi, which fit
nowhere until three of a node's four low pods go), reads 0 on every number;
faults planted in the program or in its record read above their limits; and a
configuration names its reference."""

import ast
import copy
import re
import subprocess
import sys
import time

import pytest

from portbench import gen, harness, reference, reference_preempt

NAMESPACE = "preempt"
_KEY = re.compile(rf"^{NAMESPACE}/(low|high)-(\d{{6,}})$")


def _kind(name: str, priority: int, cpu: str) -> dict:
    return {"name": name, "weight": 1, "pod": {
        "metadata": {"labels": {"app": name}},
        "spec": {"priority": priority, "containers": [{
            "name": "pause", "image": "registry.k8s.io/pause:3.10", "ports": [{"containerPort": 80}],
            "resources": {"limits": {"cpu": cpu, "memory": "500Mi"},
                          "requests": {"cpu": cpu, "memory": "500Mi"}}}]}}}


def preemption_config(nodes: int = 64, preemptors: int = 32, batch: int = 64, reference_name=None) -> dict:
    """PreemptionBasic's deployment at ``nodes`` nodes: four low pods a node,
    then ``preemptors`` high ones."""
    config = {
        "name": "preempt_small",
        "node_count": nodes,
        "wave_pods": 10 ** 9,
        "init_pods": 4 * nodes,
        "measure_pods": preemptors,
        "nodes": {"hostname_key": "kubernetes.io/hostname",
                  "allocatable": {"cpu": "4", "memory": "32Gi", "pods": "110"}},
        "pod_kinds": [_kind("low", 1, "900m"), _kind("high", 10, "3000m")],
        "scheduler": {"batch_size": batch, "tie_break": "random", "balanced_fdtype": "float64"},
    }
    if reference_name is not None:
        config["reference"] = reference_name
    return config


class InitThenMeasured(gen.Traffic):
    """The stream: ``init_pods`` low pods, then ``measure_pods`` high ones,
    all in one namespace, named by position."""

    def kind(self, j: int) -> int:
        return 0 if j < int(self.config["init_pods"]) else 1

    def pod(self, w: int, i: int) -> dict:
        j = w * self.wave_pods + i
        return self._make(self.kind(j), 0, j, NAMESPACE)

    def key(self, j: int) -> str:
        return f"{NAMESPACE}/{self.config['pod_kinds'][self.kind(j)]['name']}-{j:06d}"

    def position(self, key: str) -> int | None:
        m = _KEY.match(key)
        if m is None:
            return None
        j = int(m.group(2))
        return j if j < int(self.config["init_pods"]) + int(self.config["measure_pods"]) and \
            self.key(j) == key else None


class Process(harness.Run):
    """Set-up binds the low pods; the window creates the preemptors
    ``top_up`` at a time whenever fewer are queued, and ends when all are
    bound or the time is up."""

    def __init__(self, cell, config, params, seed, device, trace, solver_overrides=None):
        super().__init__(cell, config, params, seed, device, trace, solver_overrides)
        self.traffic = InitThenMeasured(config, seed)
        self.pods = gen.StreamPods(self.traffic)
        self.top_up = int(params["top_up"])
        self.total = int(config["init_pods"]) + int(config["measure_pods"])

    def warmup(self) -> None:
        self.create(int(self.config["init_pods"]))
        while self.sched.pending:
            self.call(int(self.params["batches_per_call"]), False)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter()
            done = self.pods.created == self.total and not self.sched.pending
            if (done or now - t0 >= seconds) and not self.closing(now):
                break
            if self.sched.pending < self.top_up and self.pods.created < self.total:
                self.create(min(self.top_up, self.total - self.pods.created))
            self.call(int(self.params["batches_per_call"]), self.t1 is None)
        return {"t0": t0, "t1": self.t1, "attempted": self.attempted_in_window,
                "failed": self.failed_in_window,
                "e2e": {"pods_per_s": self.bound_in_window / (self.t1 - t0)}}


PARAMS = {"batches_per_call": 1, "trace_batches": 1, "reference_score_checks": 4096}


def run(config: dict, seconds: float = 20.0, seed: int = 20260101, top_up: int = 64) -> dict:
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = {"name": "preempt_small.basic", "config": config["name"], "traffic": "preempt", "chips": 1}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "load_process", lambda name: Process)
        return harness.run_cell(cell, config, dict(PARAMS, process="preempt", top_up=top_up), bench, seed, seconds,
                                False, device="cpu")


@pytest.fixture(scope="module")
def sound():
    """One sound run, and what its check was handed."""
    handed = {}
    judge = reference_preempt.judge

    def keeping(node_dicts, pods, events, store, nodes, sample):
        handed.update(node_dicts=node_dicts, pods=pods, events=list(events), store=store, nodes=nodes,
                      sample=sample)
        return judge(node_dicts, pods, handed["events"], store, nodes, sample)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(reference_preempt, "judge", keeping)
        # eight preemptors at a time: later preemptions meet earlier preemptors
        # bound and nominated
        out = run(preemption_config(reference_name="reference_preempt"), top_up=8)
    return out, handed


def rejudge(handed, events, module=reference_preempt) -> dict:
    h = handed
    return module.judge(h["node_dicts"], h["pods"], events, h["store"], h["nodes"], h["sample"])


def test_a_sound_run_reads_zero_on_every_number(sound):
    out, handed = sound
    assert list(out["checks"]) == list(reference_preempt.LIMITS)
    assert all(c == {"value": 0, "limit": 0} for c in out["checks"].values()), out["checks"]
    assert out["correct"] is True and out["failed"] == 0
    events = handed["events"]
    preemptions = [ev for ev in events if ev[0] == "preempt"]
    assert len(preemptions) == 32 and all(len(ev[3]) == 3 for ev in preemptions)
    nominated = {ev[1]: ev[2] for ev in preemptions}
    bound = {ev[1]: ev[2] for ev in events if ev[0] == "bind" and ev[1] in nominated}
    assert bound == nominated
    # every preemptor attempted, counted once as nominated and once bound
    assert out["attempted"] == 64


def _first(events, kind, pred=lambda ev: True) -> int:
    return next(i for i, ev in enumerate(events) if ev[0] == kind and pred(ev))


def _preempts(events):
    return [i for i, ev in enumerate(events) if ev[0] == "preempt"]


def _plant_equal_priority_victim(events):
    # the last preemption also evicts a preemptor bound before it
    last = _preempts(events)[-1]
    earlier = next(ev[1] for ev in events[:last] if ev[0] == "bind" and "/high-" in ev[1])
    _, p, n, v = events[last]
    events[last] = ("preempt", p, n, v + (earlier,))


def _plant_dropped_victim(events):
    i = _preempts(events)[0]
    _, p, n, v = events[i]
    events[i] = ("preempt", p, n, v[:-1])


def _plant_fourth_victim(events):
    # the node's fourth low pod, the one the reprieve kept, evicted too
    i = _preempts(events)[0]
    _, p, n, v = events[i]
    low = sorted(k for k, node in ((ev[1], ev[2]) for ev in events[:i] if ev[0] == "bind")
                 if node == n and k not in v)
    events[i] = ("preempt", p, n, v + (low[0],))


def _plant_preemption_where_it_fit(events):
    # a second preemption for the first preemptor, on the second's node,
    # right after its first: its own nominated node fits it with no eviction
    first, second = _preempts(events)[:2]
    _, p, _, _ = events[first]
    _, _, n2, v2 = events[second]
    events.insert(first + 1, ("preempt", p, n2, v2))
    del events[second + 1]


def _plant_moved_binding(events):
    # the first preemptor bound on the next preemptor's node instead of its own
    first, second = _preempts(events)[:2]
    p, n2 = events[first][1], events[second][2]
    i = _first(events, "bind", lambda ev: ev[1] == p)
    events[i] = ("bind", p, n2)


@pytest.mark.parametrize("plant,number", [
    (_plant_equal_priority_victim, "preemption_faults"),
    (_plant_dropped_victim, "preemption_faults"),
    (_plant_fourth_victim, "preemption_faults"),
    (_plant_preemption_where_it_fit, "preemption_faults"),
    (_plant_moved_binding, "nomination_breaks"),
])
def test_faults_planted_in_the_record(sound, plant, number):
    _, handed = sound
    events = copy.deepcopy(handed["events"])
    plant(events)
    numbers = rejudge(handed, events)
    assert numbers[number] > reference_preempt.LIMITS[number], numbers


@pytest.mark.parametrize("plant,rule", [
    (_plant_equal_priority_victim, "victim_not_lower_on_the_node"),
    (_plant_dropped_victim, "no_fit_with_the_victims_gone"),
    (_plant_fourth_victim, "not_the_greedy_reprieve"),
    (_plant_preemption_where_it_fit, "fit_without_evictions"),
    (_plant_moved_binding, "bound_off_its_nominated_node"),
])
def test_each_planted_fault_breaks_its_rule(sound, plant, rule):
    _, handed = sound
    events = copy.deepcopy(handed["events"])
    plant(events)
    assert rule in rejudge(handed, events)["_broken_rules"]


def _nodes(n: int, cpu: str) -> list[dict]:
    return [{"metadata": {"name": f"n{i}", "labels": {"kubernetes.io/hostname": f"n{i}"}},
             "status": {"allocatable": {"cpu": cpu, "memory": "4Gi", "pods": "110"}}} for i in range(n)]


def _pod(name: str, priority: int, cpu: str = "800m", **spec) -> dict:
    return {"metadata": {"name": name, "namespace": "a"},
            "spec": {"priority": priority, **spec, "containers": [
                {"name": "c", "resources": {"requests": {"cpu": cpu, "memory": "1Gi"}}}]}}


def _two_nodes(victim_on_n1_priority: int, policy: str = ""):
    """n0 holds a priority-1 pod, n1 one of ``victim_on_n1_priority``; each
    leaves too little cpu for the preemptor, which the record preempts on n1."""
    extra = {"preemptionPolicy": policy} if policy else {}
    pods = {"a/low": _pod("low", 1), "a/mid": _pod("mid", victim_on_n1_priority),
            "a/vip": _pod("vip", 10, **extra)}
    events = [("bind", "a/low", "n0"), ("bind", "a/mid", "n1"), ("preempt", "a/vip", "n1", ("a/mid",))]
    out = reference_preempt.judge(_nodes(2, "1"), pods, events, {"a/low": "n0", "a/vip": ""}, None, set())
    return out["preemption_faults"], out["_broken_rules"]


def test_a_node_with_lower_victims_is_the_better_pick():
    assert _two_nodes(1) == (0, {})
    assert _two_nodes(5) == (1, {"a_better_node": 1})


def _mixed_priorities(on: str):
    """n0 holds victims of priority 5, 1 and 1, n1 of 5 and 3, and the
    preemptor needs a whole node: the record preempts on ``on``.
    pickOneNodeForPreemption ties on the highest priority, 5, and takes n1:
    each victim's priority raised by MaxInt32 + 1 before the sum puts two
    victims before three (a plain sum, 7 against 8, would take n0)."""
    pods = {"a/a5": _pod("a5", 5, "1000m"), "a/a1": _pod("a1", 1, "1000m"), "a/b1": _pod("b1", 1, "1000m"),
            "a/c5": _pod("c5", 5, "1500m"), "a/c3": _pod("c3", 3, "1500m"), "a/vip": _pod("vip", 10, "4000m")}
    placed = {"a/a5": "n0", "a/a1": "n0", "a/b1": "n0", "a/c5": "n1", "a/c3": "n1"}
    victims = {"n0": ("a/a5", "a/a1", "a/b1"), "n1": ("a/c5", "a/c3")}[on]
    events = [("bind", k, n) for k, n in placed.items()] + [("preempt", "a/vip", on, victims)]
    store = {k: n for k, n in placed.items() if k not in victims}
    out = reference_preempt.judge(_nodes(2, "4"), pods, events, dict(store, **{"a/vip": ""}), None, set())
    return out["preemption_faults"], out["_broken_rules"]


def test_fewer_victims_come_before_a_lower_plain_sum():
    assert _mixed_priorities("n1") == (0, {})
    assert _mixed_priorities("n0") == (1, {"a_better_node": 1})


def test_a_preemptor_that_may_not_preempt():
    assert _two_nodes(1, policy="Never") == (1, {"policy_never": 1})


@pytest.mark.parametrize("module", [reference, reference_preempt])
def test_an_eviction_left_out_of_the_record_is_a_mismatch(sound, module):
    _, handed = sound
    events = [ev for ev in handed["events"] if ev[0] != "preempt"]
    numbers = rejudge(handed, events, module)
    assert numbers["readback_mismatches"] > 0


def test_the_default_reference_replays_evictions_as_deletes(sound):
    _, handed = sound
    numbers = rejudge(handed, handed["events"], reference)
    assert all(numbers[k] == 0 for k in reference.LIMITS), numbers


def test_a_fourth_victim_planted_in_the_program(monkeypatch):
    from kubernetes_tpu_torch.solver.preemption import PreemptionEvaluator

    evaluate = PreemptionEvaluator.evaluate

    def greedy(self, pod, nodes, slot_names, placed_by_slot, *a, **k):
        result = evaluate(self, pod, nodes, slot_names, placed_by_slot, *a, **k)
        if result is not None:
            on_node = placed_by_slot[slot_names.index(result.node_name)]
            result.victims.extend(q for q in on_node if q not in result.victims
                                  and q.effective_priority < pod.effective_priority)
        return result

    monkeypatch.setattr(PreemptionEvaluator, "evaluate", greedy)
    out = run(preemption_config(preemptors=8, reference_name="reference_preempt"))
    assert out["correct"] is False
    assert out["checks"]["preemption_faults"]["value"] > 0
    assert out["checks"]["readback_mismatches"]["value"] == 0


def test_a_configuration_names_its_reference():
    assert harness.load_reference({}) is reference
    assert harness.load_reference({"reference": "reference_preempt"}) is reference_preempt
    assert list(harness.LIMITS) == ["infeasible_binds", "score_gap", "double_or_unknown_binds",
                                    "readback_mismatches"]
    assert list(reference_preempt.LIMITS) == list(harness.LIMITS) + ["preemption_faults", "nomination_breaks"]
    assert set(reference_preempt.LIMITS.values()) == {0}


@pytest.mark.parametrize("name,checks", [
    (None, list(reference.LIMITS)),
    ("reference_preempt", list(reference_preempt.LIMITS)),
])
def test_the_checks_follow_the_named_reference(name, checks):
    # no preemptor: the low pods alone, in the window
    config = preemption_config(nodes=16, preemptors=0, reference_name=name)
    out = run(config, seconds=1.0)
    assert list(out["checks"]) == checks and out["correct"] is True


def test_pod_disruption_budgets_are_refused():
    config = dict(preemption_config(), pod_disruption_budgets=[{"minAvailable": 1}])
    with pytest.raises(NotImplementedError):
        gen.Traffic(config, 1)
    with pytest.raises(NotImplementedError):
        run(config, seconds=1.0)


def test_the_reference_imports_nothing_of_the_program():
    tree = ast.parse((harness.BENCH_DIR / "reference_preempt.py").read_text())
    absolute, relative = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            absolute |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                relative |= {a.name for a in node.names}
            else:
                absolute.add(node.module.split(".")[0])
    assert absolute - set(sys.stdlib_module_names) == {"numpy"} and relative == {"reference"}


_STUB = """
from portbench import reference
{load}
LIMITS = dict(reference.LIMITS)


def judge(*args):
{judge}
    return reference.judge(*args)
"""


@pytest.fixture
def stub_reference(tmp_path, monkeypatch):
    """Writes a reference module ``stub_reference`` that imports a stand-in
    ``flax`` where the test says: at load, or in ``judge``."""
    import portbench

    (tmp_path / "refs").mkdir()
    (tmp_path / "fakes" / "flax").mkdir(parents=True)
    (tmp_path / "fakes" / "flax" / "__init__.py").write_text("")
    monkeypatch.setattr(portbench, "__path__", [*portbench.__path__, str(tmp_path / "refs")])
    monkeypatch.syspath_prepend(str(tmp_path / "fakes"))

    def write(load: str = "", judge: str = "    pass") -> dict:
        (tmp_path / "refs" / "stub_reference.py").write_text(_STUB.format(load=load, judge=judge))
        return preemption_config(nodes=16, preemptors=0, reference_name="stub_reference")

    yield write
    for name in ("flax", "portbench.stub_reference"):
        sys.modules.pop(name, None)
    if hasattr(portbench, "stub_reference"):
        delattr(portbench, "stub_reference")


@pytest.mark.parametrize("load,judge", [("import flax", "    pass"), ("", "    import flax")],
                         ids=["at_load", "in_judge"])
def test_a_reference_that_loads_jax_ends_the_run(stub_reference, load, judge):
    assert "flax" not in sys.modules
    with pytest.raises(SystemExit, match="flax"):
        run(stub_reference(load, judge), seconds=1.0)


def test_the_stub_reference_alone_runs(stub_reference):
    out = run(stub_reference(), seconds=1.0)
    assert out["correct"] is True and list(out["checks"]) == list(reference.LIMITS)


def test_a_misnamed_reference_fails_before_set_up(monkeypatch):
    built = []
    monkeypatch.setattr(Process, "__init__", lambda self, *a, **k: built.append(a))
    with pytest.raises(ModuleNotFoundError):
        run(preemption_config(nodes=16, preemptors=0, reference_name="no_such_reference"), seconds=1.0)
    assert built == []


def test_loading_it_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import harness\n"
            "harness.load_reference({'reference': 'reference_preempt'})\n"
            "from kubernetes_tpu_torch.scheduler import Scheduler\n"
            "print(harness.forbidden_modules(sys.modules))\n") % str(harness.ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=harness.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
