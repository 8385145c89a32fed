"""Scheduler-extender webhook server — the delivery boundary of SURVEY.md
§8.2: a kube-scheduler configured with this extender sends its
filter/prioritize/preempt/bind verbs here and the card answers.

Wire shapes are byte-compatible with
staging/src/k8s.io/kube-scheduler/extender/v1/types.go:
- POST /filter     ExtenderArgs{pod, nodes|nodenames} ->
                   ExtenderFilterResult{nodes|nodenames, failedNodes,
                   failedAndUnresolvableNodes, error}
- POST /prioritize ExtenderArgs -> HostPriorityList [{host, score 0..10}]
                   (MaxExtenderPriority; the caller multiplies by the
                   extender weight and rescales vs MaxNodeScore)
- POST /preempt    ExtenderPreemptionArgs{pod, nodeNameToVictims|
                   nodeNameToMetaVictims} -> ExtenderPreemptionResult
                   {nodeNameToMetaVictims: {node: {pods: [{uid}],
                   numPDBViolations}}}
- POST /bind       ExtenderBindingArgs{podName, podNamespace, podUID, node}
                   -> ExtenderBindingResult{error}
- GET  /metrics    prometheus exposition (reference names)
- GET  /healthz /livez /readyz

Filter and prioritize answer from the DEVICE by default: concurrent webhook
requests micro-batch into one batched filter+score evaluation on the card
(solver/evaluate.py) whose pipeline is the exact solver's, so the served
verdicts are bit-identical to an in-process solve over the same snapshot. ``backend="oracle"`` retains the scalar NumPy path for parity
tests. The server also exposes an ingest surface (the apiserver-shaped
CRUD the extender's watch connection would provide in a reference
deployment) so `cli.py serve` is an operable component:
- POST   /api/nodes           Node dict or {"items": [...]} (create/update)
- DELETE /api/nodes/{name}
- POST   /api/pods            Pod dict or {"items": [...]}
- DELETE /api/pods/{ns}/{name}
- GET    /api/state           {"nodes": N, "pods": P, "unscheduled": U}
- GET    /api/leases          {"items": [coordination.k8s.io Lease, ...]}
In ``--mode scheduler`` a full Scheduler drains the queue in the
background: ingested pods get bound by device solves without any external
kube-scheduler (the cmd/kube-scheduler#Run analog).

Handlers are pure dict->dict functions (golden-JSON testable, SURVEY §8.6)
wrapped by a thin aiohttp app (``aiohttp`` is imported inside ``make_app``
and ``run_server`` only, so this module imports without it). The server holds a ClusterState for the pod
side of NodeInfo (an extender keeps its own watch-fed view in the reference
deployment; ExtenderArgs only carries Node objects). nodeCacheCapable mode
accepts/returns bare node names resolved against that state.

Copied from ``kubernetes_tpu/server/extender.py``. ``ExtenderCore`` and
``run_server`` take ``device`` (None = the card, raising without CUDA;
``"cpu"`` runs on the CPU) for the evaluator, the preemption dry-run and
the embedded Scheduler, and for the bulk tensor gRPC path that
``grpc_port > 0`` serves beside the webhook (``server/bulk.py``).
``/debug/hub`` reports the embedded Scheduler's occupancy hub when it is a
fleet replica, 404 otherwise.
"""

from __future__ import annotations

import time
from typing import Mapping, Sequence

import numpy as np

from ..api.objects import Node, Pod
from ..ops.oracle import preemption as opr
from ..ops.oracle.profile import FullOracle, make_oracle_nodes
from ..state.cluster import ApiError, ClusterState
from .. import metrics

MAX_EXTENDER_PRIORITY = 10


class DecodeError(Exception):
    """Per-request decode failure inside a micro-batch: the HTTP layer maps
    it to a 500 for that one request without failing its batch-mates."""


class ExtenderCore:
    """Verb implementations as pure dict->dict handlers.

    backend="device" (default): filter/prioritize scores come from one
    batched evaluation on ``device`` per request group. backend="oracle":
    scalar NumPy reference path (the sanitizer, SURVEY §8.6).
    """

    def __init__(
        self,
        cluster: ClusterState,
        node_cache_capable: bool = False,
        backend: str = "device",
        solver_config=None,
        tracer=None,
        device=None,
    ):
        self.cluster = cluster
        self.node_cache_capable = node_cache_capable
        self.backend = backend
        # obs span layer (obs/): shared with the embedded
        # Scheduler in --mode scheduler so webhook evaluation spans and
        # solve spans land in one flight recorder; a disabled tracer
        # otherwise (one attribute check per request group)
        if tracer is None:
            from ..obs import Tracer

            tracer = Tracer(enabled=False)
        self.tracer = tracer
        if backend == "device":
            from ..solver.evaluate import BatchEvaluator

            self.evaluator = BatchEvaluator(solver_config, device=device)
        else:
            self.evaluator = None

    # -- helpers --

    def _pods_by_node(self) -> dict[str, list[Pod]]:
        out: dict[str, list[Pod]] = {}
        for p in self.cluster.list_pods():
            if p.node_name:
                out.setdefault(p.node_name, []).append(p)
        return out

    def _resolve_nodes(self, args: Mapping) -> tuple[list[Node], bool, list[str]]:
        """(nodes, by_name, unknown_names): honor nodes vs nodenames
        (nodeCacheCapable). Unknown names fail per-node, not per-request —
        the extender's watch-fed view may lag the scheduler's."""
        if args.get("nodenames") is not None:
            nodes, unknown = [], []
            for n in args["nodenames"]:
                try:
                    nodes.append(self.cluster.get_node(n))
                except ApiError:
                    unknown.append(n)
            return nodes, True, unknown
        items = (args.get("nodes") or {}).get("items") or []
        return [Node.from_dict(d) for d in items], False, []

    def _oracle(self, nodes: list[Node]) -> FullOracle:
        pods_by_node = self._pods_by_node()
        return FullOracle(make_oracle_nodes(nodes, pods_by_node))

    # per-webhook-batch device evaluation path: ktpu: hot
    def _score_rows(
        self, pods: Sequence[Pod], nodes: list[Node]
    ) -> np.ndarray:
        """[len(pods), len(nodes)] int32 full-pipeline totals, -1 =
        infeasible — one device call for the whole pod group."""
        if self.backend == "device":
            with self.cluster.lock:  # one consistent snapshot of the view
                pods_by_node = self._pods_by_node()
                services = self.cluster.list_services()
                pvs = self.cluster.list_pvs()
                pvcs = self.cluster.list_pvcs()
            return self.evaluator.evaluate(
                list(pods),
                nodes,
                pods_by_node,
                services=services,
                pvs=pvs,
                pvcs=pvcs,
            )
        oracle = self._oracle(nodes)
        rows = np.full((len(pods), len(nodes)), -1, dtype=np.int32)
        for pi, pod in enumerate(pods):
            feasible = oracle.feasible_set(pod)
            totals = oracle.score_totals(pod, feasible)
            for i in feasible:
                rows[pi, i] = totals[i]
        return rows

    # -- verbs --

    def filter(self, args: Mapping) -> dict:
        return self.run_many([("filter", args)])[0]

    def prioritize(self, args: Mapping) -> list[dict]:
        """HostPriorityList: full-pipeline totals rescaled into the 0..10
        extender score range (MaxExtenderPriority). Decode errors raise —
        the HTTP layer turns them into a 500 so the caller sees the failure
        instead of silently dropping this extender's scores."""
        out = self.run_many([("prioritize", args)])[0]
        if isinstance(out, DecodeError):
            raise KeyError(str(out))
        return out

    def run_many(self, requests: list[tuple[str, Mapping]]) -> list:
        """Evaluate a micro-batch of filter/prioritize requests. Requests
        sharing one node list (the common case: kube-scheduler fans a batch
        of pods over the same snapshot) share a single device evaluation —
        its pod axis. Responses keep request order. A request
        that fails to decode gets a per-request error (filter: the wire's
        {"error"} shape; prioritize: a DecodeError the HTTP layer turns
        into a 500 for that request alone) — it never poisons the batch."""
        # cross-process trace propagation: a request carrying the obs
        # layer's traceContext (the outbound client attaches it per
        # batch) pins this evaluation span to the CALLER's trace, so a
        # webhook round trip appears inside the scheduling batch's
        # trace instead of as an anonymous server-side event
        tctx = next(
            (
                args["traceContext"]
                for _verb, args in requests
                if isinstance(args, Mapping)
                and isinstance(args.get("traceContext"), Mapping)
            ),
            None,
        )
        attrs = {"requests": len(requests)}
        trace_id = None
        if tctx is not None:
            trace_id = tctx.get("trace")
            for k in ("parent", "replica", "incarnation"):
                if tctx.get(k) is not None:
                    attrs[k] = tctx[k]
        with self.tracer.span(
            "extender_batch", trace_id=trace_id, **attrs
        ):
            return self._run_many(requests)

    def _run_many(self, requests: list[tuple[str, Mapping]]) -> list:
        import hashlib
        import json

        results: list = [None] * len(requests)
        # group key -> [(req_idx, verb, pod)]; key captures everything the
        # evaluation depends on: mode, resolved names, per-request unknown
        # names, and (full-node mode) the node payload itself — two requests
        # naming the same nodes with different capacities must not share
        groups: dict[tuple, list] = {}
        meta: dict[tuple, tuple] = {}
        for ri, (verb, args) in enumerate(requests):
            try:
                pod = Pod.from_dict(args["pod"])
                nodes, by_name, unknown = self._resolve_nodes(args)
            except Exception as e:  # any decode failure stays per-request
                if verb == "filter":
                    results[ri] = {"error": str(e)}
                else:
                    results[ri] = DecodeError(str(e))
                continue
            if by_name:
                payload_key = ""
            else:
                payload_key = hashlib.blake2b(
                    json.dumps(
                        (args.get("nodes") or {}).get("items") or [],
                        sort_keys=True,
                    ).encode(),
                    digest_size=16,
                ).hexdigest()
            key = (
                by_name,
                tuple(n.name for n in nodes),
                tuple(unknown),
                payload_key,
            )
            if key not in groups:
                groups[key] = []
                meta[key] = (nodes, by_name, unknown)
            groups[key].append((ri, verb, pod))
        for key, members in groups.items():
            nodes, by_name, unknown = meta[key]
            rows = self._score_rows([pod for _, _, pod in members], nodes)
            for (ri, verb, pod), row in zip(members, rows):
                if verb == "filter":
                    results[ri] = self._filter_result(
                        row, nodes, by_name, unknown
                    )
                else:
                    results[ri] = self._prioritize_result(row, nodes)
        return results

    def _filter_result(
        self, row: np.ndarray, nodes: list[Node], by_name: bool,
        unknown: list[str],
    ) -> dict:
        passed: list[Node] = []
        failed: dict[str, str] = {}
        for i, node in enumerate(nodes):
            if row[i] >= 0:
                passed.append(node)
            else:
                failed[node.name] = "node did not satisfy filters"
        out: dict = {
            "failedNodes": failed,
            "failedAndUnresolvableNodes": {
                n: "node not found" for n in unknown
            },
        }
        if by_name:
            out["nodenames"] = [n.name for n in passed]
        else:
            out["nodes"] = {"items": [n.to_dict() for n in passed]}
        return out

    def _prioritize_result(
        self, row: np.ndarray, nodes: list[Node]
    ) -> list[dict]:
        mx = int(row.max()) if row.size else -1
        return [
            {
                "host": n.name,
                "score": (
                    MAX_EXTENDER_PRIORITY * int(row[i]) // mx
                    if mx > 0 and row[i] >= 0
                    else 0
                ),
            }
            for i, n in enumerate(nodes)
        ]

    def preempt(self, args: Mapping) -> dict:
        try:
            pod = Pod.from_dict(args["pod"])
        except KeyError as e:
            return {"error": str(e)}
        from ..ops.oracle import plugins as opl

        pods_by_node = self._pods_by_node()
        pdbs = self.cluster.list_pdbs()
        candidates = args.get("nodeNameToVictims") or args.get(
            "nodeNameToMetaVictims"
        ) or {}
        # static gate: preemption cannot resolve taints/affinity/
        # nodeName/unschedulable failures (the dry-run is fit-only) —
        # never offer such nodes
        live: list = []
        for node_name in candidates:
            try:
                node = self.cluster.get_node(node_name)
            except ApiError:
                continue
            if (
                opl.node_name_filter(pod, node)
                and opl.node_unschedulable_filter(pod, node)
                and opl.taint_toleration_filter(pod, node)
                and opl.node_affinity_filter(pod, node)
            ):
                live.append(node)

        if self.backend == "device" and live:
            victims_map = self._preempt_device(pod, live, pods_by_node, pdbs)
        else:
            victims_map = {}
            for node in live:
                nv = opr.select_victims_on_node(
                    pod,
                    node.allocatable,
                    node.allowed_pod_number,
                    pods_by_node.get(node.name, []),
                    pdbs,
                )
                if nv is None:
                    continue  # dropped from the result = not a candidate
                victims_map[node.name] = (list(nv.victims), nv.num_violating)

        out: dict[str, dict] = {}
        for node_name, (victims, n_viol) in victims_map.items():
            if self.node_cache_capable:
                out[node_name] = {
                    "pods": [{"uid": v.uid or v.key} for v in victims],
                    "numPDBViolations": n_viol,
                }
            else:
                out[node_name] = {
                    "pods": [v.to_dict() for v in victims],
                    "numPDBViolations": n_viol,
                }
        # extender.go#ProcessPreemption reads NodeNameToMetaVictims only for
        # nodeCacheCapable extenders, NodeNameToVictims (full pods) otherwise
        if self.node_cache_capable:
            return {"nodeNameToMetaVictims": out}
        return {"nodeNameToVictims": out}

    def _preempt_device(
        self, pod: Pod, nodes: list[Node], pods_by_node, pdbs
    ) -> dict:
        """Device-backed /preempt (VERDICT r3 #8): ONE batched dry-run
        over all statically-feasible candidates instead of a scalar
        per-node loop — the in-process PostFilter's pre-screen behind the
        wire. Fit-only semantics identical to select_victims_on_node,
        including zero-victim fits: a node where the pod fits without
        eviction STAYS in the result with an empty victim list, exactly
        like the scalar path's NodeVictims([], 0). The vocab is built
        over the pod AND the candidate nodes so an extended resource the
        nodes don't advertise stays visible (fit then fails on its zero
        allocatable instead of being silently dropped)."""
        from ..solver.preemption import PreemptionEvaluator
        from ..tensorize.schema import ResourceVocab, build_node_batch

        if not hasattr(self, "_preemptor"):
            self._preemptor = PreemptionEvaluator(device=self.evaluator.device)
        vocab = ResourceVocab.build([pod], nodes)
        batch = build_node_batch(nodes, vocab=vocab)
        placed_by_slot = {
            i: pods_by_node.get(nd.name, []) for i, nd in enumerate(nodes)
        }
        static_row = np.zeros(batch.padded, dtype=bool)
        static_row[: len(nodes)] = True  # static gate already applied
        return self._preemptor.victims_by_node(
            pod,
            batch,
            [nd.name for nd in nodes],
            placed_by_slot,
            static_row,
            pdbs,
            candidate_slots=list(range(len(nodes))),
        )

    def bind(self, args: Mapping) -> dict:
        try:
            self.cluster.bind(
                args.get("podNamespace") or "default",
                args["podName"],
                args["node"],
            )
            return {}
        except (KeyError, ApiError) as e:
            return {"error": str(e)}


class MicroBatcher:
    """Coalesce concurrent filter/prioritize requests into one device call.

    Requests arriving within ``window`` seconds ride one ExtenderCore
    .run_many() (executed off the event loop). The analog of the reference's
    in-proc 16-way parallel-for: here parallelism is the evaluation's pod
    axis."""

    def __init__(self, core: ExtenderCore, window: float = 0.002):
        self.core = core
        self.window = window
        self._pending: list = []
        self._task = None

    async def submit(self, verb: str, args: Mapping):
        import asyncio

        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._pending.append((verb, args, fut))
        if self._task is None or self._task.done():
            self._task = asyncio.create_task(self._drain())
        return await fut

    async def _drain(self):
        import asyncio

        # loop until no request arrived while the previous batch was in the
        # executor — submit() only spawns a new task when this one is done,
        # so returning with _pending non-empty would strand those futures
        # ktpu: ignore[RETRY001]: batch pump, not a retry loop — a failed batch FAILS its futures (nothing replayed) and the sleep is the fixed micro-batch window cadence, so jitter would be wrong
        while True:
            await asyncio.sleep(self.window)
            batch, self._pending = self._pending, []
            if not batch:
                return
            loop = asyncio.get_running_loop()
            t0 = time.perf_counter()
            try:
                results = await loop.run_in_executor(
                    None,
                    self.core.run_many,
                    [(verb, args) for verb, args, _ in batch],
                )
            except Exception as e:
                for _, _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            metrics.extender_batch_size.observe(len(batch))
            metrics.extender_request_seconds.observe(time.perf_counter() - t0)
            for (_, _, fut), res in zip(batch, results):
                if fut.done():
                    continue
                if isinstance(res, DecodeError):
                    fut.set_exception(res)
                else:
                    fut.set_result(res)


def _load_state_file(cluster: ClusterState, path: str) -> None:
    """Initial-state ingest: JSON/YAML with {"nodes": [...], "pods": [...],
    "services": [...], "pdbs": [...], "resourceSlices": [...],
    "deviceClasses": [...], "resourceClaims": [...]} of wire-shape dicts."""
    import json

    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        import yaml

        doc = yaml.safe_load(text)
    for nd in doc.get("nodes") or []:
        cluster.create_node(Node.from_dict(nd))
    for pd in doc.get("pods") or []:
        cluster.create_pod(Pod.from_dict(pd))
    if doc.get("services"):
        from ..api.objects import Service

        for sd in doc["services"]:
            cluster.create_service(Service.from_dict(sd))
    if doc.get("pdbs"):
        from ..api.objects import PodDisruptionBudget

        for dd in doc["pdbs"]:
            cluster.create_pdb(PodDisruptionBudget.from_dict(dd))
    if (
        doc.get("resourceSlices")
        or doc.get("deviceClasses")
        or doc.get("resourceClaims")
    ):
        from ..api.dra import DeviceClass, ResourceClaim, ResourceSlice

        for sd in doc.get("resourceSlices") or []:
            cluster.create_resource_slice(ResourceSlice.from_dict(sd))
        for cd in doc.get("deviceClasses") or []:
            cluster.create_device_class(DeviceClass.from_dict(cd))
        for cd in doc.get("resourceClaims") or []:
            cluster.create_resource_claim(ResourceClaim.from_dict(cd))


def make_app(
    core: ExtenderCore,
    scheduler=None,
    batch_window: float = 0.002,
    recorder=None,
    slo=None,
):
    """aiohttp application wiring the pure handlers to the wire.

    With ``scheduler`` (a Scheduler over the same ClusterState), a
    background task drains the queue: ingested pods are bound by device
    solves — serve --mode scheduler. ``recorder`` (an
    obs.FlightRecorder, defaulting to the scheduler's) backs the
    ``/debug/flightrecorder`` and ``/debug/spans`` endpoints; ``slo``
    (an obs.SloEngine, defaulting to the scheduler's) backs
    ``GET /debug/slo`` — the live are-we-meeting-SLOs answer. The
    scheduler's flight telemetry (obs.Telemetry, serve --telemetry)
    backs ``GET /debug/profile`` — per-stage profile + sentinel state,
    with ``?capture=1`` forcing a manual replay-bundle capture."""
    import asyncio

    from aiohttp import web

    batcher = MicroBatcher(core, window=batch_window)

    async def _json(request):
        return await request.json()

    async def filter_(request):
        return web.json_response(
            await batcher.submit("filter", await _json(request))
        )

    async def prioritize(request):
        try:
            return web.json_response(
                await batcher.submit("prioritize", await _json(request))
            )
        except Exception as e:
            return web.json_response({"error": str(e)}, status=500)

    async def preempt(request):
        return web.json_response(core.preempt(await _json(request)))

    async def bind(request):
        return web.json_response(core.bind(await _json(request)))

    async def metrics_(request):
        return web.Response(
            body=metrics.render(), content_type="text/plain"
        )

    async def healthz(request):
        return web.Response(text="ok")

    # -- flight recorder / span debug surface (obs/) --

    if recorder is None and scheduler is not None:
        recorder = getattr(scheduler, "flight", None)

    async def debug_flightrecorder(request):
        if recorder is None:
            return web.json_response(
                {"error": "observability disabled (serve --obs)"},
                status=404,
            )
        # one snapshot backs both the response and the optional disk
        # dump (?dump=1), so the two can never diverge; plain GETs (a
        # poller) don't touch the disk
        snap = recorder.snapshot()
        if request.query.get("dump"):
            snap["dumped_to"] = recorder.dump(
                trigger="manual", snapshot=snap
            )
        return web.json_response(snap)

    async def debug_spans(request):
        if recorder is None:
            return web.json_response(
                {"error": "observability disabled (serve --obs)"},
                status=404,
            )
        return web.json_response({"spans": recorder.spans()})

    # -- live SLO surface (obs/slo.py) --

    if slo is None and scheduler is not None:
        slo = getattr(scheduler, "slo", None)

    async def debug_slo(request):
        if slo is None:
            return web.json_response(
                {"error": "SLO engine disabled (serve --slo)"},
                status=404,
            )
        return web.json_response(slo.snapshot())

    # -- flight telemetry surface (obs/ profiler +
    # sentinel + capture) --

    async def debug_profile(request):
        telemetry = (
            getattr(scheduler, "telemetry", None)
            if scheduler is not None
            else None
        )
        if telemetry is None:
            return web.json_response(
                {"error": "flight telemetry disabled (serve --telemetry)"},
                status=404,
            )
        snap = telemetry.snapshot()
        if request.query.get("capture"):
            # operator-triggered forensic capture: bundle the most
            # recent complete batch exactly as an anomaly would
            telemetry.capture("manual", note="GET /debug/profile?capture=1")
            snap = telemetry.snapshot()
            snap["captured"] = True
        return web.json_response(snap)

    # -- occupancy-hub HA surface (the fleet) --

    async def debug_hub(request):
        status = None
        if scheduler is not None and scheduler.fleet is not None:
            from ..fleet.occupancy import ExchangeUnreachable

            try:
                status = scheduler.hub_status()
            except ExchangeUnreachable as e:
                # mid-blackout: every hub endpoint is down — exactly
                # what the operator polling this endpoint wants to know
                return web.json_response(
                    {"error": f"hub unreachable: {e}"}, status=503
                )
        if status is None:
            return web.json_response(
                {"error": "not a fleet replica (no occupancy hub)"},
                status=404,
            )
        return web.json_response(status)

    # -- ingest surface (the watch-fed view's write side) --

    def _items(doc):
        return doc["items"] if isinstance(doc, Mapping) and "items" in doc else [doc]

    async def post_nodes(request):
        doc = await _json(request)
        created = 0
        for nd in _items(doc):
            node = Node.from_dict(nd)
            try:
                core.cluster.create_node(node)
            except ApiError:
                core.cluster.update_node(node)
            created += 1
        return web.json_response({"applied": created})

    async def delete_node(request):
        try:
            core.cluster.delete_node(request.match_info["name"])
        except ApiError as e:
            return web.json_response({"error": e.reason}, status=404)
        return web.json_response({})

    async def post_pods(request):
        doc = await _json(request)
        created = 0
        for pd in _items(doc):
            pod = Pod.from_dict(pd)
            try:
                core.cluster.create_pod(pod)
            except ApiError:
                core.cluster.update_pod(pod)
            created += 1
        return web.json_response({"applied": created})

    async def delete_pod(request):
        try:
            core.cluster.delete_pod(
                request.match_info["ns"], request.match_info["name"]
            )
        except ApiError as e:
            return web.json_response({"error": e.reason}, status=404)
        return web.json_response({})

    async def get_state(request):
        pods = core.cluster.list_pods()
        return web.json_response(
            {
                "nodes": len(core.cluster.list_nodes()),
                "pods": len(pods),
                "unscheduled": sum(1 for p in pods if not p.node_name),
                "resourceVersion": core.cluster.resource_version,
            }
        )

    async def get_leases(request):
        # coordination.k8s.io wire shapes: who leads (leader election)
        return web.json_response(
            {"items": [le.to_dict() for le in core.cluster.list_leases()]}
        )

    app = web.Application()
    app.router.add_post("/filter", filter_)
    app.router.add_post("/prioritize", prioritize)
    app.router.add_post("/preempt", preempt)
    app.router.add_post("/bind", bind)
    app.router.add_get("/metrics", metrics_)
    for route in ("/healthz", "/livez", "/readyz"):
        app.router.add_get(route, healthz)
    app.router.add_get("/debug/flightrecorder", debug_flightrecorder)
    app.router.add_get("/debug/spans", debug_spans)
    app.router.add_get("/debug/slo", debug_slo)
    app.router.add_get("/debug/profile", debug_profile)
    app.router.add_get("/debug/hub", debug_hub)
    app.router.add_post("/api/nodes", post_nodes)
    app.router.add_delete("/api/nodes/{name}", delete_node)
    app.router.add_post("/api/pods", post_pods)
    app.router.add_delete("/api/pods/{ns}/{name}", delete_pod)
    app.router.add_get("/api/state", get_state)
    app.router.add_get("/api/leases", get_leases)

    if scheduler is not None:

        async def drain(app):
            loop = asyncio.get_running_loop()

            async def loop_task():
                import logging
                import random

                log = logging.getLogger("kubernetes_tpu_torch.serve")
                log.info("scheduler drain loop running")
                failures = 0
                while True:
                    progressed = False
                    if scheduler.pending:
                        try:
                            # bounded double-buffered burst: overlaps each
                            # batch's device read with the next batch's
                            # tensorize/dispatch (Scheduler.run_pipelined),
                            # then returns to the event loop so ingest
                            # keeps flowing
                            results = await loop.run_in_executor(
                                None,
                                lambda: scheduler.run_pipelined(
                                    max_batches=64
                                ),
                            )
                        except Exception:
                            # a failed burst must not kill the drain loop —
                            # log and retry (pods stay queued). Full-jitter
                            # backoff: a fixed sleep re-hammers a hub that
                            # is mid-failover in lockstep with every other
                            # replica's drain loop
                            failures += 1
                            log.exception("pipelined drain burst failed")
                            await asyncio.sleep(
                                random.uniform(
                                    0.0,
                                    min(1.0 * 2 ** (failures - 1), 30.0),
                                )
                            )
                            continue
                        failures = 0
                        progressed = any(
                            r.progressed for r in results
                        )
                    if not progressed:
                        # pending may count backoff/unschedulable pods the
                        # pop yields nothing for — don't busy-spin on them
                        await asyncio.sleep(0.02)

            task = asyncio.create_task(loop_task())
            yield
            task.cancel()

        app.cleanup_ctx.append(drain)
    return app


def run_server(
    cluster: ClusterState,
    host: str = "127.0.0.1",
    port: int = 10259,
    node_cache_capable: bool = False,
    mode: str = "extender",
    state_file: str | None = None,
    solver_config=None,
    grpc_port: int = 0,
    scheduler_config=None,
    device=None,
) -> None:
    """Blocking server entry (the cmd/kube-scheduler#Run analog serves
    healthz+metrics on 10259). mode="scheduler" also runs the batching
    scheduler loop over the ingested state; grpc_port > 0 additionally
    serves the bulk tensor gRPC path (SURVEY §6.8). ``device``: where
    evaluations, dry-runs, bulk solves and the embedded Scheduler's solves
    run (None = the card)."""
    import logging

    from aiohttp import web

    log = logging.getLogger("kubernetes_tpu_torch.serve")
    if state_file:
        _load_state_file(cluster, state_file)
    scheduler = None
    tracer = recorder = None
    obs_cfg = getattr(scheduler_config, "obs", None)
    if mode == "scheduler":
        from ..scheduler import Scheduler

        scheduler = Scheduler(cluster, scheduler_config, device=device)
        tracer, recorder = scheduler.obs, scheduler.flight
    elif obs_cfg is not None:
        # extender-only mode still gets webhook spans + debug endpoints
        from ..obs import build_obs

        tracer, _journal, recorder = build_obs(obs_cfg)
    core = ExtenderCore(
        cluster, node_cache_capable, solver_config=solver_config,
        tracer=tracer, device=device,
    )
    log.info(
        "serving on %s:%d", host, port,
        extra={
            "mode": mode,
            "grpc_port": grpc_port,
            "observability": bool(recorder),
        },
    )
    grpc_server = None
    if grpc_port:
        from .bulk import serve_bulk

        grpc_server = serve_bulk(
            cluster, port=grpc_port, solver_config=solver_config,
            tracer=tracer, device=device,
        )
    app = make_app(core, scheduler=scheduler, recorder=recorder)
    try:
        web.run_app(app, host=host, port=port)
    finally:
        if grpc_server is not None:
            grpc_server.stop(grace=1.0)
