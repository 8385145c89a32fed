"""Bulk tensor gRPC service (SURVEY §6.8): the wide-pipe companion to the
per-pod JSON webhook, for workloads where per-pod JSON would dominate —
the 50k-pod single-shot rebalance.

Service ``kubernetestpu.Bulk``, methods (all unary, payloads framed by
server/tensorcodec.py — columnar arrays + one JSON header):

- ``SyncNodes``: upsert a node set from columnar arrays
  (names in meta; cpu_milli/mem_bytes/max_pods arrays; optional labels in
  meta). The node-delta path: only changed nodes need re-sending.
- ``Solve``: schedule a columnar pod batch (cpu_milli/mem_bytes/priority
  arrays) against the current node state.
  meta.mode = "exact" (sequential-parity scan, grouped fast path when
  eligible) | "single_shot" (auction; the rebalance engine).
  meta.commit = true writes bindings into the cluster state (pods must
  carry names in meta); default is advisory — assignments return but no
  state changes, mirroring the webhook's advisory filter/prioritize.
  Response: assignments int32 [P] (index into meta.nodes of the reply,
  -1 = unschedulable).
- ``Evaluate``: score a columnar pod batch -> scores int32 [P, N]
  (-1 = infeasible), the bulk analog of /filter + /prioritize in one call.

Columnar pods deliberately carry only resources + priority: richer pods
(affinity, spread, ports) flow through the JSON ingest + webhook path where
the full object model applies. This mirrors the north-star workload shape
(BASELINE.json ladder #5: resource rebalance at 50k x 10k).

Uses grpc.method_handlers_generic_handler with identity serializers —
the wire is opaque bytes (tensorcodec framing); no protoc codegen is
needed. ``grpc`` is imported only inside the functions that open a server
or a channel (or abort a call), so this module imports without it.

Copied from ``kubernetes_tpu/server/bulk.py``. ``BulkCore``, ``serve_bulk``
and the solvers under them take ``device`` (None = the card, raising
without CUDA; ``"cpu"`` runs on the CPU): ``Solve`` runs the exact solver
or the single-shot auction there, ``Evaluate`` the batched evaluator (two
``domain_counts`` launches per evaluation). The fleet's two methods,
``ExchangeOccupancy`` and ``HubOp``, serve the occupancy hub
(``fleet/occupancy.py``) that ``BulkCore(exchange=)`` shares or the first
call creates; ``BulkClient.exchange_occupancy`` / ``hub_op`` call them.
"""

from __future__ import annotations

import threading

import numpy as np

from ..api.objects import (
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    Node,
    Pod,
)
from ..state.cluster import ApiError, ClusterState
from ..tensorize.schema import (
    CPU_IDX,
    MEM_IDX,
    PodBatch,
    ResourceVocab,
    bucket_pow2,
    build_node_batch,
)
from . import tensorcodec

SERVICE = "kubernetestpu.Bulk"


def columnar_pod_batch(
    cpu_milli: np.ndarray,
    mem_bytes: np.ndarray,
    priority: np.ndarray | None,
    vocab: ResourceVocab,
    keys: list[str] | None = None,
) -> PodBatch:
    """Build a PodBatch straight from columnar arrays — no per-pod Python
    objects on the bulk path (SURVEY §8.8: 1-vCPU host discipline).

    NonZeroRequested defaults (100 mCPU / 200 MB, noderesources/
    resource_allocation.go) apply where a request is zero, matching
    Pod.non_zero_request()."""
    p = int(cpu_milli.shape[0])
    pp = bucket_pow2(p)
    k = len(vocab)
    req = np.zeros((pp, k), dtype=np.int64)
    req[:p, CPU_IDX] = cpu_milli
    req[:p, MEM_IDX] = mem_bytes
    nonzero = np.zeros((pp, 2), dtype=np.int64)
    nonzero[:p, 0] = np.where(cpu_milli > 0, cpu_milli, 100)
    nonzero[:p, 1] = np.where(mem_bytes > 0, mem_bytes, 200 * 1024 * 1024)
    prio = np.zeros(pp, dtype=np.int32)
    if priority is not None:
        prio[:p] = priority
    valid = np.zeros(pp, dtype=bool)
    valid[:p] = True
    return PodBatch(
        vocab=vocab,
        keys=keys if keys is not None else [f"default/bulk-{i}" for i in range(p)],
        num_pods=p,
        padded=pp,
        req=req,
        req_mask=req > 0,
        feasible_static=np.ones(pp, dtype=bool),
        nonzero_req=nonzero,
        priority=prio,
        valid=valid,
    )


class BulkCore:
    """Method implementations as bytes -> bytes functions (testable without
    a socket, like ExtenderCore's dict -> dict handlers)."""

    def __init__(
        self, cluster: ClusterState, solver_config=None, exchange=None,
        tracer=None, device=None,
    ):
        from .. import device as device_mod
        from ..solver.evaluate import BatchEvaluator
        from ..solver.exact import ExactSolver
        from ..solver.single_shot import SingleShotSolver

        self.cluster = cluster
        self._lock = threading.Lock()
        self.device = device_mod.resolve(device)
        self.exact = ExactSolver(solver_config)
        self.evaluator = BatchEvaluator(solver_config, device=self.device)
        self.single_shot = SingleShotSolver(device=self.device)
        # fleet occupancy hub (fleet/occupancy.py): lazily created on
        # the first ExchangeOccupancy call unless an in-process fleet
        # shares its hub explicitly
        self.exchange = exchange
        # obs span layer: server-side half of the cross-process trace
        # propagation — a Solve request carrying meta.trace continues
        # the CALLER's trace (id + parent span + replica + incarnation
        # as span attributes) instead of starting an anonymous one.
        # Default: a disabled tracer (one attribute check per call).
        if tracer is None:
            from ..obs import Tracer

            tracer = Tracer(enabled=False)
        self.tracer = tracer

    # -- helpers --

    def _node_view(self):
        nodes = self.cluster.list_nodes()
        pods_by_node: dict[str, list[Pod]] = {}
        for p in self.cluster.list_pods():
            if p.node_name:
                pods_by_node.setdefault(p.node_name, []).append(p)
        return nodes, pods_by_node

    # -- methods --

    def sync_nodes(self, data: bytes) -> bytes:
        meta, arrays = tensorcodec.decode(data)
        names = meta.get("names") or []
        labels = meta.get("labels") or [{}] * len(names)
        cpu = arrays["cpu_milli"]
        mem = arrays["mem_bytes"]
        max_pods = arrays.get("max_pods")
        applied = 0
        with self._lock:
            for i, name in enumerate(names):
                node = Node(
                    name=name,
                    labels=dict(labels[i]) if i < len(labels) else {},
                    allocatable={
                        RESOURCE_CPU: int(cpu[i]),
                        RESOURCE_MEMORY: int(mem[i]),
                        RESOURCE_PODS: (
                            int(max_pods[i]) if max_pods is not None else 110
                        ),
                    },
                )
                try:
                    self.cluster.create_node(node)
                except ApiError:
                    self.cluster.update_node(node)
                applied += 1
        return tensorcodec.encode({"applied": applied})

    def solve(self, data: bytes) -> bytes:
        meta, arrays = tensorcodec.decode(data)
        mode = meta.get("mode") or "exact"
        commit = bool(meta.get("commit"))
        names = meta.get("names")
        # cross-process trace context (obs tentpole): the caller's
        # trace id / parent span / replica / incarnation ride the
        # request meta; the server-side span joins that trace so the
        # bulk solve appears in the SAME trace as the caller's batch
        tctx = meta.get("trace") or {}
        with self.tracer.span(
            "bulk_solve",
            trace_id=tctx.get("trace"),
            mode=mode,
            commit=commit,
            **{
                k: tctx[k]
                for k in ("parent", "replica", "incarnation")
                if tctx.get(k) is not None
            },
        ), self._lock:
            nodes, pods_by_node = self._node_view()
            if not nodes:
                return tensorcodec.encode({"error": "no nodes ingested"})
            batch = build_node_batch(nodes, pods_by_node)
            pbatch = columnar_pod_batch(
                arrays["cpu_milli"],
                arrays["mem_bytes"],
                arrays.get("priority"),
                batch.vocab,
                keys=names,
            )
            if mode == "single_shot":
                assignments = self.single_shot.solve(batch, pbatch)
            else:
                assignments = self.exact.solve(
                    batch, pbatch, device=self.device
                )
            committed = 0
            commit_errors: dict[str, str] = {}
            if commit and names:
                from ..api.objects import Container

                default_ns = meta.get("namespace") or "default"
                for i, (key, a) in enumerate(zip(names, assignments)):
                    if a < 0:
                        continue
                    # an "ns/name"-shaped key carries its own namespace;
                    # bare names fall back to the request's (a caller
                    # mixing namespaces must not land pods in the wrong
                    # one — ADVICE r3)
                    ns, _, pod_name = key.rpartition("/")
                    ns = ns or default_ns
                    # one create+bind per placed pod; advisory callers skip.
                    # Failures are reported per pod so the reply can never
                    # silently diverge from committed state; a bind failure
                    # rolls the created pod back (no unbound orphans).
                    created = False
                    try:
                        self.cluster.create_pod(
                            Pod(
                                name=pod_name,
                                namespace=ns,
                                containers=(
                                    Container(
                                        name="c",
                                        requests={
                                            RESOURCE_CPU: int(
                                                arrays["cpu_milli"][i]
                                            ),
                                            RESOURCE_MEMORY: int(
                                                arrays["mem_bytes"][i]
                                            ),
                                        },
                                    ),
                                ),
                            )
                        )
                        created = True
                        self.cluster.bind(ns, pod_name, batch.names[int(a)])
                        committed += 1
                    except ApiError as e:
                        commit_errors[key] = e.reason
                        if created:
                            try:
                                self.cluster.delete_pod(ns, pod_name)
                            except ApiError:
                                pass
        reply_meta: dict = {"nodes": batch.names, "mode": mode}
        if commit:
            reply_meta["committed"] = committed
            if commit_errors:
                reply_meta["commitErrors"] = commit_errors
        return tensorcodec.encode(
            reply_meta,
            {"assignments": np.asarray(assignments, dtype=np.int32)},
        )

    def exchange_occupancy(self, data: bytes) -> bytes:
        """Fleet cross-shard occupancy exchange (fleet/occupancy.py):
        the sender's node inventory + pod rows replace its previous
        view on the hub; the reply carries the merged rows of every
        OTHER replica, framed the same way. One unary call per
        reconcile refresh — compact by construction (label-bearing
        placements only)."""
        from ..fleet.occupancy import ingest_payload

        return ingest_payload(self._hub(), data)

    def _hub(self):
        from ..fleet.occupancy import OccupancyExchange

        with self._lock:
            if self.exchange is None:
                self.exchange = OccupancyExchange()
            return self.exchange

    def hub_op(self, data: bytes, ctx=None) -> bytes:
        """Occupancy-hub operation dispatch: the full OccupancyExchange
        surface (stage / fenced compare-and-stage / commit / withdraw /
        idempotent apply_ops flush / retire / handoff / degraded flags
        / views / replication catch-up / status) as one unary RPC, so N
        cross-process replicas share ONE hub with the in-process
        semantics intact. The op table itself lives in
        ``fleet.occupancy.dispatch_hub_op`` — shared verbatim with the
        in-process LocalHubClient, so the two transports cannot drift —
        and every reply carries the hub's ``epoch`` for the client-side
        monotone fencing check. Error mapping — the wire half of the
        typed-conflict contract:

        - ``ExchangeUnreachable`` (the sim's partition seam / a downed
          hub) -> UNAVAILABLE: a transport-class failure the client
          surfaces as ExchangeUnreachable again;
        - ``HubDeposed`` (this hub does not hold the primary lease —
          a deposed old primary or an unpromoted standby) ->
          PERMISSION_DENIED: RemoteOccupancyExchange rotates to the
          next endpoint, never retries here;
        - ``AdmitConflict`` (CAS lost its version race) -> ABORTED;
          ``AdmitConflict(fenced=True)`` (hub write fence) ->
          FAILED_PRECONDITION. Both are SEMANTIC rejections: BulkClient
          never retries them (retrying a lost race would re-land the
          write the CAS exists to reject)."""
        import grpc

        from ..fleet.occupancy import (
            AdmitConflict,
            ExchangeUnreachable,
            HubDeposed,
            dispatch_hub_op,
        )

        meta, _arrays = tensorcodec.decode(data)
        op = meta.get("op") or ""
        hub = self._hub()
        # hub spans carry the epoch: one span per HubOp with the hub's
        # identity attributes, so a trace crossing a failover shows
        # WHICH hub incarnation served each op (disabled tracer = one
        # attribute check)
        with self.tracer.span(
            "hub_op", op=op, hub_epoch=hub.hub_epoch,
        ):
            try:
                out = dispatch_hub_op(hub, op, meta)
            except HubDeposed as e:
                if ctx is not None:
                    ctx.abort(grpc.StatusCode.PERMISSION_DENIED, str(e))
                raise
            except ExchangeUnreachable as e:
                if ctx is not None:
                    ctx.abort(grpc.StatusCode.UNAVAILABLE, str(e))
                raise
            except AdmitConflict as e:
                if ctx is not None:
                    ctx.abort(
                        grpc.StatusCode.FAILED_PRECONDITION
                        if e.fenced
                        else grpc.StatusCode.ABORTED,
                        str(e),
                    )
                raise
            except ValueError as e:
                if ctx is not None:
                    ctx.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
                raise
        return tensorcodec.encode(out)

    def evaluate(self, data: bytes) -> bytes:
        meta, arrays = tensorcodec.decode(data)
        from ..tensorize.interpod import trivial_interpod_tensors
        from ..tensorize.plugins import (
            trivial_port_tensors,
            trivial_static_tensors,
        )
        from ..tensorize.spread import trivial_spread_tensors

        with self._lock:
            nodes, pods_by_node = self._node_view()
            if not nodes:
                return tensorcodec.encode({"error": "no nodes ingested"})
            batch = build_node_batch(nodes, pods_by_node)
            pbatch = columnar_pod_batch(
                arrays["cpu_milli"],
                arrays["mem_bytes"],
                arrays.get("priority"),
                batch.vocab,
            )
            static = trivial_static_tensors(
                pbatch, batch.padded, batch.schedulable
            )
            ports = trivial_port_tensors(pbatch, batch.padded)
            spread = trivial_spread_tensors(pbatch, batch.padded, static.c_pad)
            interpod = trivial_interpod_tensors(
                pbatch, batch.padded, static.c_pad
            )
            out = self.evaluator.evaluate_tensors(
                batch, pbatch, static, ports, spread, interpod
            )[:, : batch.num_nodes]
        return tensorcodec.encode(
            {"nodes": batch.names},
            {"scores": np.ascontiguousarray(out, dtype=np.int32)},
        )


def make_grpc_server(core: BulkCore, port: int = 0, host: str = "127.0.0.1"):
    """Returns (server, bound_port). Identity serializers: the tensorcodec
    framing IS the message format."""
    import grpc
    from concurrent import futures

    ident = lambda b: b  # noqa: E731

    def unary(fn):
        return grpc.unary_unary_rpc_method_handler(
            lambda req, ctx: fn(req),
            request_deserializer=ident,
            response_serializer=ident,
        )

    def unary_ctx(fn):
        # the handler needs the ServicerContext to abort with typed
        # status codes (the HubOp conflict mapping)
        return grpc.unary_unary_rpc_method_handler(
            lambda req, ctx: fn(req, ctx),
            request_deserializer=ident,
            response_serializer=ident,
        )

    handler = grpc.method_handlers_generic_handler(
        SERVICE,
        {
            "SyncNodes": unary(core.sync_nodes),
            "Solve": unary(core.solve),
            "Evaluate": unary(core.evaluate),
            "ExchangeOccupancy": unary(core.exchange_occupancy),
            "HubOp": unary_ctx(core.hub_op),
        },
    )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((handler,))
    bound = server.add_insecure_port(f"{host}:{port}")
    return server, bound


def serve_bulk(
    cluster: ClusterState,
    port: int,
    host: str = "127.0.0.1",
    solver_config=None,
    tracer=None,
    device=None,
):
    """Start the bulk gRPC server (non-blocking) with its solves on
    ``device`` (None = the card); returns the grpc server."""
    core = BulkCore(
        cluster, solver_config=solver_config, tracer=tracer, device=device
    )
    server, bound = make_grpc_server(core, port=port, host=host)
    server.start()
    return server


# transient gRPC status codes worth retrying: the server is alive but
# this call lost (connection churn, queue overflow, deadline) — the
# request is idempotent on the bulk surface (SyncNodes upserts, Solve
# without commit is advisory, ExchangeOccupancy replaces wholesale)
_RETRYABLE_CODES = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED")


class BulkClient:
    """Columnar in, columnar out — now with production-grade call
    hygiene: every RPC carries a deadline, and transient failures
    (UNAVAILABLE / DEADLINE_EXCEEDED / RESOURCE_EXHAUSTED, plus broken
    connections) retry with FULL-JITTER bounded exponential backoff
    (each wait drawn uniformly from [0, base * 2^attempt) — N clients
    whose server just failed over must not re-arrive in lockstep and
    thundering-herd the standby), counted by
    ``scheduler_bulk_retry_total``. A call that keeps failing raises
    the last error — the caller sees exactly one exception after the
    budget, not a raw flake on the first blip.

    ``Solve`` with ``commit=True`` is NOT blindly idempotent (a lost
    reply can leave bindings committed), so commit calls do not
    retry; the per-pod ``commitErrors`` map is the recovery surface.
    """

    def __init__(
        self,
        target: str,
        *,
        retries: int = 3,
        deadline_s: float = 30.0,
        backoff_base_s: float = 0.05,
        clock=None,
        backoff_rng=None,
    ):
        import grpc
        import random

        from ..utils.clock import Clock

        self._grpc = grpc
        self.retries = max(int(retries), 0)
        self.deadline_s = float(deadline_s)
        self.backoff_base_s = float(backoff_base_s)
        self._clock = clock or Clock()
        # jitter stream: seeded by the target string so seeded runs
        # (the sim's --selfcheck) stay deterministic; tests inject
        # their own to pin exact draws
        self._backoff_rng = (
            backoff_rng
            if backoff_rng is not None
            else random.Random(f"bulk-backoff/{target}")
        )
        ident = lambda b: b  # noqa: E731
        self._channel = grpc.insecure_channel(target)
        self._solve = self._channel.unary_unary(
            f"/{SERVICE}/Solve",
            request_serializer=ident,
            response_deserializer=ident,
        )
        self._sync = self._channel.unary_unary(
            f"/{SERVICE}/SyncNodes",
            request_serializer=ident,
            response_deserializer=ident,
        )
        self._eval = self._channel.unary_unary(
            f"/{SERVICE}/Evaluate",
            request_serializer=ident,
            response_deserializer=ident,
        )
        self._exchange = self._channel.unary_unary(
            f"/{SERVICE}/ExchangeOccupancy",
            request_serializer=ident,
            response_deserializer=ident,
        )
        self._hub_op = self._channel.unary_unary(
            f"/{SERVICE}/HubOp",
            request_serializer=ident,
            response_deserializer=ident,
        )

    def _retryable(self, err: Exception) -> bool:
        if isinstance(err, ConnectionError):
            return True
        if isinstance(err, self._grpc.RpcError):
            code = getattr(err, "code", lambda: None)()
            return code is not None and code.name in _RETRYABLE_CODES
        return False

    def _call(self, method: str, fn, payload: bytes, retry: bool = True):
        """One deadline-bounded RPC with full-jitter bounded-backoff
        retries on transient errors (AWS-style full jitter: the wait is
        uniform over [0, cap), where cap doubles per attempt — plain
        exponential backoff keeps simultaneous losers synchronized,
        which is exactly wrong during a fleet-wide hub failover)."""
        attempts = self.retries + 1 if retry else 1
        last = None
        for attempt in range(attempts):
            if attempt:
                from .. import metrics

                metrics.bulk_retry_total.labels(method).inc()
                self._clock.sleep(
                    self._backoff_rng.uniform(
                        0.0, self.backoff_base_s * (2 ** (attempt - 1))
                    )
                )
            try:
                return fn(payload, timeout=self.deadline_s)
            except Exception as e:
                if not self._retryable(e):
                    raise
                last = e
        raise last

    def sync_nodes(self, names, cpu_milli, mem_bytes, max_pods=None, labels=None):
        arrays = {
            "cpu_milli": np.asarray(cpu_milli, dtype=np.int64),
            "mem_bytes": np.asarray(mem_bytes, dtype=np.int64),
        }
        if max_pods is not None:
            arrays["max_pods"] = np.asarray(max_pods, dtype=np.int32)
        meta = {"names": list(names)}
        if labels is not None:
            meta["labels"] = list(labels)
        reply = self._call(
            "SyncNodes", self._sync, tensorcodec.encode(meta, arrays)
        )
        return tensorcodec.decode(reply)[0]

    def solve(self, cpu_milli, mem_bytes, priority=None, mode="exact",
              names=None, commit=False, namespace=None, trace=None):
        arrays = {
            "cpu_milli": np.asarray(cpu_milli, dtype=np.int64),
            "mem_bytes": np.asarray(mem_bytes, dtype=np.int64),
        }
        if priority is not None:
            arrays["priority"] = np.asarray(priority, dtype=np.int32)
        meta = {"mode": mode, "commit": commit}
        if trace is not None:
            # cross-process trace propagation: a dict like
            # {"trace": <id>, "parent": <span id>, "replica": ...,
            # "incarnation": ...} — the server-side bulk_solve span
            # joins the caller's trace instead of starting its own
            meta["trace"] = dict(trace)
        if names is not None:
            meta["names"] = list(names)
        if namespace is not None:
            # commit fallback namespace for bare (un-prefixed) names;
            # "ns/name"-shaped names carry their own
            meta["namespace"] = namespace
        reply = self._call(
            "Solve", self._solve, tensorcodec.encode(meta, arrays),
            # a committing solve mutates cluster state: a lost REPLY
            # would make the retry double-create — surface the error
            retry=not commit,
        )
        return tensorcodec.decode(reply)

    def evaluate(self, cpu_milli, mem_bytes, priority=None):
        arrays = {
            "cpu_milli": np.asarray(cpu_milli, dtype=np.int64),
            "mem_bytes": np.asarray(mem_bytes, dtype=np.int64),
        }
        if priority is not None:
            arrays["priority"] = np.asarray(priority, dtype=np.int32)
        reply = self._call(
            "Evaluate", self._eval, tensorcodec.encode({}, arrays)
        )
        return tensorcodec.decode(reply)

    def hub_op(self, op: str, **meta) -> dict:
        """One occupancy-hub operation (the HubOp method): meta in,
        reply meta out. Transient transport failures retry like every
        other bulk RPC; ABORTED / FAILED_PRECONDITION — the hub's typed
        CAS-conflict and fence rejections — are SEMANTIC and surface
        immediately (never retried: a blind retry of a lost admit race
        would re-land the write the compare-and-stage rejected,
        mirroring the committing-Solve never-retries rule)."""
        meta["op"] = op
        reply = self._call(
            "HubOp", self._hub_op, tensorcodec.encode(meta)
        )
        return tensorcodec.decode(reply)[0]

    def exchange_occupancy(self, replica, version, node_rows, pod_rows):
        """Fleet occupancy exchange round trip: publish this replica's
        rows, return (version, peer node rows, peer pod rows)."""
        from ..fleet.occupancy import decode_rows, encode_rows

        reply = self._call(
            "ExchangeOccupancy", self._exchange,
            encode_rows(replica, version, node_rows, pod_rows),
        )
        _replica, v, nodes, pods = decode_rows(reply)
        return v, nodes, pods

    def close(self):
        self._channel.close()
