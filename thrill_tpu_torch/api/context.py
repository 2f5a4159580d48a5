"""The runtime handle passed to user jobs (counterpart of the reference
package's ``api/context.py``). Sources take ``storage`` "device" (columnar tensors) or
"host" (per-worker Python lists); None infers it as the reference does.
A Context owns the JSON event log (``logger``), the HBM governor
(``hbm``, mem/hbm.py), the memory-pressure ladder (``pressure``,
mem/pressure.py), the decision ledger (``decisions``,
common/decisions.py), the planner (``planner``, api/planner.py; None
with ``THRILL_TPU_PLANNER=0``), and, when their directories are set,
the plan store (``plan_store``, service/plan_store.py) and the
checkpoint manager (``checkpoint``, api/checkpoint.py); ``close()``
saves the plan store and frees the spill store.

Observability: the tracer (``tracer``, common/trace.py; its ring is the
flight recorder that :meth:`Context.note_failure` dumps), the
performance doctor (``doctor``, common/doctor.py; None with
``THRILL_TPU_DOCTOR=0``; :meth:`Context.doctor_report`), the profile
thread (``Config.profile``, ``THRILL_TPU_PROFILE=1``, with a log) and
the metrics endpoint (``THRILL_TPU_METRICS_PORT``,
common/metrics.py).

A mesh of several processes (``RunDistributed``): each process runs the
same job on its own Context, whose mesh holds its local workers' rows
(parallel/mesh.py). ``ctx.net`` is the host control plane, a
FlowControlChannel over the authenticated TCP group made from
``THRILL_TPU_HOSTLIST``/``_RANK``/``_SECRET`` (net/tcp.py), or the MPI
world under ``THRILL_TPU_NET=mpi`` (net/mpi.py); the
host-storage multiplexer (data/multiplexer.py) and
:meth:`Context.collective_mean_stdev` ride it. ``host_rank`` is the
process's rank; ``overall_stats()`` gathers every process's counters
unless ``local_only``, with ``hosts`` the number of processes.

Failure domains (reference: ``api/context.py:1187-1395``): every
pipeline run inside ``with ctx.pipeline():`` carries a fresh generation
id; an error escaping the block aborts only that run. The heal disposes
the failed generation's nodes (their HBM ledger entries, spilled blocks
and memory grants), drops its deferred checks and a loop capture in
progress (a CUDA graph capture that a failure interrupted was already
ended by the loop, api/loop.py ``_graph_loop``), waits for the card's
queue, then runs the generation barrier over the host group;
the caller gets a :class:`PipelineError` and the Context serves the next
pipeline as a fresh one would. A sticky CUDA error (an illegal address,
a device-side assert) poisons the process's CUDA context: it is
classified unrecoverable and the original error is raised, so a
supervised relaunch takes over, as for a dead peer.

Elasticity: :meth:`Context.resize` changes W at a generation boundary
(every live result re-split to the W' layout a fresh W'-wide run makes,
the old W's plan state parked per W in the mesh), and
:meth:`Context.resize_processes` is the supervised move (seal a RESIZE
epoch, commit the marker, exit ``RESIZE_EXIT_CODE`` for
``run-scripts/supervise.sh``), of one controller or of every process of
a mesh.

Tenants: ``current_tenant`` is stamped on every node made while it is
set (``node._tenant``, beside ``_generation``) and on the tracer's
spans; the HBM governor keeps a ledger of each tenant's device bytes
and spills an over-budget tenant's own results (mem/hbm.py). The
scheduler sets it around each job; ``service/tenancy.py``'s
``activate`` is the direct form.

Serving (service/): :meth:`Context.submit` queues ``fn(ctx)`` from any
thread and returns a ``JobFuture``; the first submit builds the
scheduler (``service``), whose one dispatcher thread runs the jobs in
weighted-fair order across tenants, each in its own failure domain.
``THRILL_TPU_SERVE_PORT`` starts the front door (``front_door``) and
``THRILL_TPU_AUTOSCALE_S`` the autoscaler (``autoscaler``). On a
serving Context :meth:`Context.resize` runs fenced between two jobs,
:meth:`Context.resize_processes` drains the front door and the queue
first, ``overall_stats`` runs no collective once the Context has
served, and ``close`` stops the autoscaler, the front door, then the
scheduler."""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import threading
import time
import weakref
from typing import Any, Callable, List, Optional, Sequence

import torch

from ..common import faults
from ..common.config import Config
from ..common.logger import JsonLogger, default_log_path
from ..core.em_runs import adopted_total
from ..mem.hbm import HbmGovernor
from ..mem.manager import MemoryConfig
from ..mem.pressure import PressureMonitor
from ..parallel.mesh import DeviceLike, MeshExec, resolve_device


def _wire_totals(stats: dict) -> None:
    """``bytes_on_wire`` (device exchanges' and host frames' bytes
    between processes) and its full-width ``_raw`` into ``stats``."""
    stats["bytes_on_wire"] = (stats["bytes_wire_device"]
                              + stats["bytes_wire_host"])
    stats["bytes_on_wire_raw"] = (stats["bytes_wire_device_raw"]
                                  + stats["bytes_wire_host"])


class PipelineError(RuntimeError):
    """One pipeline run on a Context failed, and only that run: the
    Context healed and stays usable (reference: ``api/context.py:54``).
    Carries the root cause: ``origin`` rank, ``cause`` text,
    ``generation`` of the failed run and ``root``, the original
    exception. Not a ConnectionError: retry policies classify it
    permanent and ``RunSupervised`` does not relaunch for it."""

    def __init__(self, origin: int, cause: str, generation: int,
                 root: Optional[BaseException] = None) -> None:
        super().__init__(
            f"pipeline generation {generation} aborted "
            f"(origin rank {origin}): {cause}")
        self.origin = origin
        self.cause = cause
        self.generation = generation
        self.root = root


#: the exit code of a supervised worker once a resize move is committed
#: (EX_TEMPFAIL): the supervisor reads the RESIZE marker and relaunches
#: the job at the target W with resume (reference:
#: ``api/context.py:80``)
RESIZE_EXIT_CODE = 75


class ResizeRelaunch(SystemExit):
    """Raised by :meth:`Context.resize_processes` once the move is
    committed: the process exits with :data:`RESIZE_EXIT_CODE` so
    ``run-scripts/supervise.sh`` relaunches the job at ``target_w`` with
    ``THRILL_TPU_RESUME=1``. Raise it on the main thread only."""

    def __init__(self, target_w: int, epoch: Optional[int] = None,
                 generation: Optional[int] = None) -> None:
        super().__init__(RESIZE_EXIT_CODE)
        self.target_w = int(target_w)
        self.epoch = epoch
        self.generation = generation

    def __str__(self) -> str:
        return (f"resize move to W={self.target_w} committed: exiting "
                f"{RESIZE_EXIT_CODE} for supervised relaunch")


#: the texts of CUDA errors that poison the process's CUDA context: no
#: heal can clear them, only a new process
_STICKY_CUDA = ("illegal memory access", "device-side assert",
                "unspecified launch failure", "misaligned address",
                "illegal instruction", "an illegal address",
                "cudaErrorIllegalAddress", "cudaErrorAssert",
                "CUDA error: unknown error")


def device_plane_broken(exc: BaseException) -> bool:
    """Did ``exc`` (or an exception it chains) come from a failed
    collective of the device data plane across processes (gloo)? A gloo
    group whose collective failed or timed out halfway is not used
    again: no heal can tell which of its messages were delivered."""
    import torch.distributed as dist
    broken = getattr(dist, "DistBackendError", ())
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if (broken and isinstance(exc, broken)) or any(
                s in str(exc) for s in ("Gloo", "gloo", "Connection closed "
                                        "by peer", "Connection reset by "
                                        "peer")):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def sticky_cuda_error(exc: BaseException) -> bool:
    """Is ``exc`` (or an exception it chains) a CUDA error that leaves
    the CUDA context unusable for the rest of the process?"""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if not isinstance(exc, torch.OutOfMemoryError):
            text = str(exc)
            if any(s in text for s in _STICKY_CUDA):
                return True
        exc = exc.__cause__ or exc.__context__
    return False


class Context:
    """Owns the mesh of W virtual workers and the DIA graph's nodes."""

    def __init__(self, mesh_exec: Optional[MeshExec] = None,
                 num_workers: int = 1, device: DeviceLike = None,
                 config: Optional[Config] = None,
                 resume: bool = False) -> None:
        self.mesh_exec = mesh_exec or MeshExec(num_workers=num_workers,
                                               device=device)
        self.config = config or Config.from_env()
        self.host_rank = self.mesh_exec.process_index
        # the host control plane (one process: a group of one)
        from ..net import FlowControlChannel
        self.net = FlowControlChannel(self._construct_host_group())
        self.mesh_exec.host_net = self.net
        self._next_id = 0
        # the nodes made, for explain(): each weakly held (a dropped
        # node's results must not stay alive) beside its id and label
        self._nodes: List[tuple] = []
        self._ram_workers: Optional[int] = None
        self._mem_reserved = 0
        self.logger = JsonLogger(
            default_log_path(self.config.log_path, host_rank=self.host_rank),
            program="thrill_tpu_torch", workers=self.num_workers,
            host=self.host_rank)
        if self.logger.enabled:
            faults.REGISTRY.set_logger(self.logger.line)
        # the fault counters are the process's: this Context reports
        # what happened since it was made
        self._faults_base = faults.REGISTRY.stats()
        # the out-of-core I/O ledger (common/iostats.py) is the
        # process's too
        from ..common.iostats import IO as _iostats
        self._io_base = _iostats.snapshot()
        # the tracer and the doctor: one attribute read away from every
        # choke point (THRILL_TPU_TRACE=0: no spans; THRILL_TPU_DOCTOR=0:
        # no doctor)
        from ..common.doctor import Doctor, doctor_enabled
        from ..common.trace import Tracer
        self.tracer = Tracer(rank=self.host_rank, logger=self.logger)
        # the tenant that nodes made now belong to (the scheduler sets
        # it around each job; service/tenancy.py's activate() is the
        # direct form)
        self.current_tenant: Optional[str] = None
        self.tracer.tenant_fn = lambda: self.current_tenant
        self.tracer.gen_fn = lambda: getattr(self, "generation", None)
        self.doctor = (Doctor(rank=self.host_rank) if doctor_enabled()
                       else None)
        self.net.group.tracer = self.tracer
        self.net.group.doctor = self.doctor
        self.mesh_exec.tracer = self.tracer
        self.mesh_exec.doctor = self.doctor
        self.hbm = HbmGovernor(self, limit=self.config.hbm_limit)
        self.pressure = PressureMonitor(self.mesh_exec, governor=self.hbm)
        # the dispatch choke point reaches both in one attribute read
        self.mesh_exec.pressure = self.pressure
        self.mesh_exec.logger = self.logger
        mex = self.mesh_exec
        if self.config.exchange:
            mex.exchange_mode = self.config.exchange
        # the decision ledger: every plan choice of the choke points,
        # one attribute read away (THRILL_TPU_DECISIONS=0: none)
        from ..common.decisions import DecisionLedger
        self.decisions = DecisionLedger(logger=self.logger,
                                        tracer=self.tracer)
        mex.decisions = self.decisions
        # the planner, which re-plans a site when an audit shows its
        # learned state lied (THRILL_TPU_PLANNER=0: the per-site rules)
        from .planner import Planner, planner_enabled
        self.planner = None
        if planner_enabled():
            self.planner = Planner(mex)
            mex.planner = self.planner
            self.decisions.audit_hook = self.planner.on_audit
        # the plan store: learned plans seed the fresh mesh, so a warm
        # restart of a known pipeline builds no plan (off unless set)
        self.plan_store = None
        if self.config.plan_store and mex.num_processes > 1:
            self._plan_store_broadcast()
        elif self.config.plan_store:
            from ..service.plan_store import PlanStore
            self.plan_store = PlanStore(self.config.plan_store,
                                        logger=self.logger)
            seeded = self.plan_store.attach(mex)
            if self.logger.enabled:
                self.logger.line(event="plan_store_load",
                                 path=self.config.plan_store,
                                 entries=seeded)
            if self.decisions.enabled \
                    and self.plan_store._last_corrupt is not None:
                self.decisions.record(
                    "store_skip", "plan_store", "cold",
                    rejected=[("warm-start", None)],
                    reason="store corrupt: "
                           + self.plan_store._last_corrupt[:120],
                    path=self.config.plan_store)
        self._aborted = False
        self._closed = False
        # the service plane: the scheduler is made by the first
        # submit(), under the lock, so one dispatcher owns the mesh; the
        # front door and the autoscaler start from the environment below
        self.service = None
        self._service_lock = threading.Lock()
        self.front_door = None
        self.autoscaler = None
        # failure domains: every pipeline run carries the current
        # generation id, which the host group's poison frames and
        # barriers carry too; the counter never re-issues an id
        self.generation = 1
        self._gen_counter = 1
        self.net.group.generation = self.generation
        self.stats_pipeline_aborts = 0
        self.stats_heal_time_s = 0.0
        # elasticity: resizes of W on this Context and their seconds,
        # process-level moves committed, and the latch that makes the
        # close of a committed move local
        self.stats_resizes = 0
        self.stats_resize_time_s = 0.0
        self.stats_resizes_proc = 0
        self._resize_exiting = False
        # checkpoints and resume: None, and nothing made on disk, unless
        # a checkpoint directory is set
        self.checkpoint = None
        if self.config.ckpt_dir:
            from .checkpoint import CheckpointManager
            self.checkpoint = CheckpointManager(
                self, self.config.ckpt_dir,
                resume=resume or self.config.resume,
                auto=self.config.ckpt_auto)
        self._profiler = None
        if self.config.profile and self.logger.enabled:
            from ..common.profile import ProfileThread
            self._profiler = ProfileThread(
                self.logger, device=self.mesh_exec.device).start()
        # the live metrics endpoint (off unless THRILL_TPU_METRICS_PORT)
        from ..common.metrics import maybe_start
        self._metrics = maybe_start(self)
        # the front door (THRILL_TPU_SERVE_PORT) and the autoscaler
        # (THRILL_TPU_AUTOSCALE_S): off unless set; close() stops the
        # autoscaler first, so no decision fires into a draining service
        from ..service.front_door import maybe_start as fd_start
        fd_start(self)
        from ..service.autoscale import maybe_start as as_start
        self.autoscaler = as_start(self)

    def _plan_store_broadcast(self) -> None:
        """The plan store on a mesh of several processes (reference:
        ``api/context.py:300-360``): rank 0 alone reads the store and
        broadcasts the entries over the host group, so every process
        installs the same seeds (``symmetric=True``) and the optimistic
        exchange stays open; rank 0 keeps the store and is its only
        writer at close. Without a host group that spans the processes
        there is no channel for the entries: a notice and a cold start."""
        from ..service.plan_store import PlanStore, install_entries
        mex = self.mesh_exec
        path = self.config.plan_store
        if self.net.num_workers != mex.num_processes:
            print("thrill_tpu.service: THRILL_TPU_PLAN_STORE "
                  "ignored on a multi-process mesh without a "
                  "spanning host control plane (no channel to "
                  "broadcast rank 0's entries); recompiling cold",
                  file=sys.stderr)
            if self.decisions.enabled:
                self.decisions.record(
                    "store_skip", "plan_store", "cold",
                    rejected=[("warm-start", None)],
                    reason="multi-process mesh without a host "
                           "control plane: rank-0 entries cannot "
                           "be broadcast",
                    path=path)
            return
        entries = None
        if self.host_rank == 0:
            self.plan_store = PlanStore(path, logger=self.logger)
            entries = self.plan_store.load()
        entries = self.net.broadcast(entries, origin=0)
        seeded = install_entries(mex, entries or {}, symmetric=True)
        # every process now holds the same seeds, and what it learns
        # from here derives from the replicated send matrix
        mex._plan_seed_symmetric = True
        if self.logger.enabled:
            self.logger.line(event="plan_store_load", path=path,
                             entries=seeded, broadcast=True)
        if self.decisions.enabled:
            self.decisions.record(
                "store_broadcast", "plan_store",
                "warm-start" if seeded else "cold",
                rejected=[("per-rank-read", None)],
                reason="rank-0 load broadcast over ctx.net "
                       "keeps SPMD plan seeds symmetric",
                entries=seeded, path=path)

    def _construct_host_group(self):
        """The host group of the processes (reference:
        ``api/context.py:395-437``): when the mesh spans processes, the
        MPI world under ``THRILL_TPU_NET=mpi`` (net/mpi.py, one
        tag-namespace group over ``COMM_WORLD``), else the TCP group
        from the environment, either checked against the mesh's process
        count and rank; a group of one otherwise."""
        from ..net import tcp
        mex = self.mesh_exec
        if mex.multiprocess:
            if os.environ.get("THRILL_TPU_NET") == "mpi":
                from ..net import mpi as mpi_net
                grp = mpi_net.construct(1)[0]
                if grp.num_hosts != mex.num_processes:
                    raise ValueError(
                        f"the MPI world has {grp.num_hosts} ranks but the "
                        f"mesh spans {mex.num_processes} processes")
                if grp.my_rank != mex.process_index:
                    raise ValueError(
                        f"MPI rank {grp.my_rank} disagrees with the mesh's "
                        f"process index {mex.process_index}: the host "
                        f"control plane and the device mesh must use the "
                        f"same rank order")
                return grp
            grp = tcp.construct_from_env()
            if grp is not None:
                if grp.num_hosts != mex.num_processes:
                    raise ValueError(
                        f"THRILL_TPU_HOSTLIST has {grp.num_hosts} hosts "
                        f"but the mesh spans {mex.num_processes} processes")
                if grp.my_rank != mex.process_index:
                    raise ValueError(
                        f"THRILL_TPU_RANK={grp.my_rank} disagrees with the "
                        f"mesh's process index {mex.process_index}: the "
                        f"host control plane and the device mesh must use "
                        f"the same rank order")
                return grp
            print("thrill_tpu_torch: multi-process run without "
                  "THRILL_TPU_HOSTLIST: the host control plane is "
                  "process-local, and host-storage pipelines raise",
                  file=sys.stderr)
        return tcp.TcpGroup(0, 1, {})

    @property
    def num_workers(self) -> int:
        return self.mesh_exec.num_workers

    def _register_node(self, node) -> int:
        # ids count from 0 in construction order, as the reference's do:
        # checkpoint epochs and sort run stores are named by them
        nid = self._next_id
        self._next_id += 1
        self._nodes.append((weakref.ref(node), nid, node.label,
                            [p.node.id for p in node.parents]))
        return nid

    # -- the service plane (service/) --------------------------------------
    def submit(self, pipeline_fn: Callable[["Context"], Any],
               tenant: str = "default", name: str = "",
               weight: Optional[float] = None):
        """Queue ``pipeline_fn(ctx) -> result`` on this Context and return
        a :class:`~thrill_tpu_torch.service.scheduler.JobFuture`
        (reference: ``api/context.py:456-489``).

        Thread-safe: any number of client threads may submit; the jobs
        run one after another on the scheduler's dispatcher thread, in
        weighted-fair order across tenants (service/scheduler.py), each
        in its own :meth:`pipeline` failure domain with
        ``current_tenant`` set: a failing job raises its
        :class:`PipelineError` from ``future.result()`` while the
        Context heals and later jobs run. Once a Context serves, run all
        its pipelines through submit(): a pipeline on another thread
        would interleave its device work with the dispatcher's. A submit
        after ``close()`` resolves failed."""
        svc = self.service
        if svc is None:
            # the first submit may race across client threads: one
            # scheduler, one dispatcher thread, ever owns the mesh
            with self._service_lock:
                if self._closed:
                    from ..service.scheduler import JobFuture
                    return JobFuture.failed(
                        0, tenant, name or "job-0",
                        RuntimeError("Context is closed"))
                svc = self.service
                if svc is None:
                    from ..service.scheduler import Scheduler
                    svc = self.service = Scheduler(self)
        return svc.submit(pipeline_fn, tenant=tenant, name=name,
                          weight=weight)

    # -- elasticity: W is a property of a generation -----------------------
    def resize(self, num_workers: int) -> float:
        """Resize the mesh to ``num_workers`` workers at a generation
        boundary; returns the seconds it took (reference:
        ``api/context.py:493``).

        Every live cached result (a node's shards held by ``Keep`` or a
        pending consumer) is re-split across the new W in the layout a
        fresh W'-wide run makes (data/shards.py :func:`resplit`), so
        later pipelines compute bit-identical to a fixed-W' Context; on
        the card a device result re-splits on the card. The old W's plan
        state is parked per W in the mesh (a later resize back finds it
        warm); the HBM ledger re-admits each moved result at its new
        size. One process only.

        On a serving Context the swap runs on the dispatcher thread at
        the next job boundary (``Scheduler.fence``), ahead of the queued
        jobs: the job in flight finishes at the old W, every queued job
        runs at the new one, and no job sees a half-swapped mesh. The
        front door's verdict gate is closed around it, so an accept frame
        names the generation after the swap (reference:
        ``api/context.py:544-558``). ``THRILL_TPU_RESIZE=0`` makes this
        raise."""
        from ..net.group import resize_enabled
        if self._closed:
            raise RuntimeError("Context is closed")
        if not resize_enabled():
            raise RuntimeError(
                "THRILL_TPU_RESIZE=0 pins the worker count for this "
                "process; unset it to allow Context.resize")
        new_w = int(num_workers)
        if new_w < 1:
            raise ValueError("cannot resize to an empty mesh")
        if self.mesh_exec.multiprocess or self.net.num_workers > 1:
            raise RuntimeError(
                "Context.resize is one-process only: on a mesh of several "
                "processes the membership changes in the host group "
                "(net.Group.resize, net.tcp.join_tcp_group) and the job "
                "relaunches at the new W")
        if new_w == self.num_workers:
            return 0.0
        svc = self.service
        if svc is not None and svc.alive:
            fd = self.front_door
            if fd is not None:
                fd.begin_resize_fence()
            try:
                return svc.fence(lambda: self._resize_now(new_w))
            finally:
                if fd is not None:
                    fd.end_resize_fence()
        return self._resize_now(new_w)

    def _resize_now(self, new_w: int) -> float:
        from ..mem.hbm import SpilledShards
        from .checkpoint import commit_repartition, stage_repartition
        t0 = time.monotonic()
        mex = self.mesh_exec
        old_w = mex.num_workers
        # 1) stage every live result: reads only, and the
        # ckpt.repartition site fires before anything changed
        live = []
        for ref, *_ in self._nodes:
            node = ref()
            if node is None or getattr(node, "_shards", None) is None:
                continue
            if isinstance(node._shards, SpilledShards):
                self.hbm.touch(node)
            live.append((node, stage_repartition(node._shards)))
        # 2) swap the mesh's W (its per-W plan state parks inside)
        mex.resize(new_w)
        # 3) rebuild each staged result at W' and re-admit it to the
        # ledger at its new size
        moved = 0
        for node, staged in live:
            self.hbm.on_release(node, None)
            node._shards = commit_repartition(mex, staged)
            moved += staged.get("bytes", 0)
            self.hbm.on_cache(node)
        # 4) a fresh generation: what is computed from here belongs to
        # the W' failure domain
        self._gen_counter += 1
        self.generation = self._gen_counter
        self.net.group.begin_generation(self.generation)
        dt = time.monotonic() - t0
        self.stats_resizes += 1
        self.stats_resize_time_s += dt
        self.last_resize = {"workers_old": old_w, "workers_new": new_w,
                            "nodes_moved": len(live), "bytes": moved,
                            "seconds": dt}
        if self.logger.enabled:
            self.logger.line(event="resize", workers_old=old_w,
                             workers_new=new_w, nodes_moved=len(live),
                             bytes_moved=moved,
                             generation=self.generation,
                             resize_time_s=round(dt, 4))
        return dt

    def resize_processes(self, num_workers: int, state=None,
                         drain_timeout_s: Optional[float] = None):
        """The supervised process-level move (reference:
        ``api/context.py:620-729``): drain the service plane (the front
        door, then the scheduler's queue), seal a RESIZE checkpoint epoch of
        ``state`` re-split to ``num_workers`` workers, pass the relaunch
        gate of the host group, commit the RESIZE marker and raise
        :class:`ResizeRelaunch`, which exits the process with
        :data:`RESIZE_EXIT_CODE`; ``run-scripts/supervise.sh`` then
        relaunches the job at W' with ``THRILL_TPU_RESUME=1``, and the
        resume restores the sealed epoch. Never returns. On a mesh of
        several processes every process calls it at the same point: W'
        must be a multiple of the workers each process holds, the marker
        names ``target_procs`` (W' over them), which ``supervise.sh -w``
        launches, and every process exits on its own from the marker's
        barrier on (``close`` and ``overall_stats`` run no collective
        then).

        ``state`` is the DIA whose materialized shards carry across
        (``Execute()``/``Keep`` it first); None commits a move without
        data. The steps and their fault sites: SEAL
        (``ckpt.resize_manifest``: a SIGKILL leaves an uncommitted
        epoch, swept at the next resume; a committed epoch without a
        marker is inert), GATE (``net.group.relaunch``: nothing changed
        yet), MARKER (``ckpt.resize_manifest`` at stage ``marker``: the
        point of no return; a relaunch after it completes the move),
        EXIT. DRAIN comes first and changes nothing durable: the front
        door rejects new submits with ``draining``, the queue runs dry
        (``drain_timeout_s``, default ``THRILL_TPU_RESIZE_TIMEOUT_S``),
        and across processes the scheduler closes collectively, so the
        move's collectives cannot race a follower's wait for ordering
        frames. Call it on the main thread, not from a job."""
        from ..net.group import resize_enabled, resize_timeout_s
        if self._closed:
            raise RuntimeError("Context is closed")
        if not resize_enabled():
            raise RuntimeError(
                "THRILL_TPU_RESIZE=0 pins the worker count for this "
                "job; unset it to allow Context.resize_processes")
        if self.checkpoint is None:
            raise ValueError(
                "resize_processes needs THRILL_TPU_CKPT_DIR: the RESIZE "
                "epoch and the relaunch marker live in the checkpoint "
                "directory")
        new_w = int(num_workers)
        if new_w < 1:
            raise ValueError("cannot resize to an empty mesh")
        old_w = self.num_workers
        if new_w == old_w:
            raise ValueError(
                f"already running W={old_w}: resize_processes is a "
                f"whole-process relaunch, a same-W move would restart "
                f"the job for nothing")
        procs = self.mesh_exec.num_processes
        local = max(1, old_w // procs)
        if procs > 1 and new_w % local:
            raise ValueError(
                f"W'={new_w} is not a multiple of the {local} workers each "
                f"process contributes; the supervisor relaunches whole "
                f"processes")
        target_procs = new_w // local if procs > 1 else 1
        timeout = (drain_timeout_s if drain_timeout_s is not None
                   else resize_timeout_s())
        t0 = time.monotonic()
        # 0) drain
        if self.front_door is not None:
            self.front_door.drain()
        self._quiesce_service(timeout)
        # 1) seal
        epoch = None
        if state is not None:
            node = getattr(state, "node", state)
            shards = getattr(node, "_shards", None)
            if shards is None:
                raise ValueError(
                    f"resize_processes state {node.label!r} has no "
                    f"materialized shards; Execute()/Keep() it before "
                    f"the move")
            epoch = self.checkpoint.seal_resize(node, shards, new_w)
        # 2) gate: settle the move's generation over the old group
        gen = self._gen_counter + 1
        self.net.group.prepare_relaunch(target_procs, gen)
        self._gen_counter = gen
        self.generation = gen
        # 3) marker: the point of no return
        self.checkpoint.commit_resize_marker(new_w, epoch=epoch,
                                             generation=gen,
                                             procs=target_procs)
        # 4) exit
        self._resize_exiting = True
        self.stats_resizes_proc += 1
        dt = time.monotonic() - t0
        self.stats_resize_time_s += dt
        faults.note("recovery", what="ctx.resize_processes",
                    old_w=old_w, new_w=new_w, epoch=epoch,
                    generation=gen, _quiet=True)
        if self.logger.enabled:
            self.logger.line(event="resize_processes", workers_old=old_w,
                             workers_new=new_w, procs_old=procs,
                             procs_new=target_procs,
                             epoch=epoch, generation=gen,
                             seconds=round(dt, 4))
        raise ResizeRelaunch(new_w, epoch=epoch, generation=gen)

    def _quiesce_service(self, timeout: float) -> None:
        """Wait until the scheduler has no queued or running job
        (reference: ``api/context.py:731-768``). The front door is
        draining already, so no new work arrives from a socket; direct
        ``submit`` callers stop submitting around a move (under
        sustained direct traffic this times out and the move aborts with
        nothing changed). Across processes the scheduler then closes:
        rank 0's close broadcasts the drain sentinel, every dispatcher
        exits at the same point of the host group, and a submit after an
        aborted move builds a fresh scheduler."""
        svc = self.service
        if svc is None or not svc.alive:
            return
        deadline = time.monotonic() + max(0.1, float(timeout))
        while True:
            with svc._cv:
                idle = (svc.queue.depth == 0
                        and svc.jobs_done >= svc.jobs_submitted)
            if idle:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"resize_processes: service did not drain within "
                    f"{timeout:.1f}s (queued={svc.queue.depth}, "
                    f"in_flight="
                    f"{svc.jobs_submitted - svc.jobs_done}); the move "
                    f"aborted with nothing mutated")
            time.sleep(0.02)
        if self.net.num_workers > 1:
            svc.close(timeout=timeout)
            self.service = None

    # -- memory grants (reference: the StageBuilder's DIAMemUse split,
    # api/dia_base.cpp:121-270). A node negotiates as its compute starts
    # and holds the grant until it ends; a "max" request gets half of
    # what is left, so nested requesters get smaller shares and the pool
    # is never over-committed.
    @property
    def ram_workers(self) -> int:
        """The operators' share of the RAM: a third of the configured RAM,
        else of the physical RAM."""
        if self._ram_workers is None:
            total = self.config.ram or self.config.host_ram
            if not total:
                try:
                    total = (os.sysconf("SC_PAGE_SIZE")
                             * os.sysconf("SC_PHYS_PAGES"))
                except (ValueError, OSError):
                    total = 8 << 30
            self._ram_workers = MemoryConfig.split(total).ram_workers
        return self._ram_workers

    def negotiate_mem(self, node) -> bool:
        """Set ``node.mem_limit`` from its ``mem_use()`` request; True
        when something was granted (then ``release_mem`` after its
        compute)."""
        req = node.mem_use()
        if req is None:
            node.mem_limit = None
            return False
        remaining = max(self.ram_workers - self._mem_reserved, 4096)
        if req == "max":
            grant = max(remaining // 2, 4096)
        else:
            grant = min(int(req), remaining)
        self._mem_reserved += grant
        node.mem_limit = grant
        node._mem_grant = grant
        short = req != "max" and grant < int(req)
        if self.logger.enabled:
            self.logger.line(event="mem_negotiate", node=node.label,
                             dia_id=node.id, grant=grant,
                             reserved=self._mem_reserved,
                             short=short or None)
        if short:
            print(f"thrill_tpu_torch: mem_negotiate short grant for "
                  f"{node.label}: requested {req}, granted {grant}",
                  file=sys.stderr)
        return True

    def release_mem(self, node) -> None:
        self._mem_reserved -= node._mem_grant
        node._mem_grant = 0

    def Generate(self, size: int, fn: Optional[Callable] = None,
                 storage: Optional[str] = None):
        """Items ``fn(i)`` of ``i`` in ``[0, size)``: on the device
        ``fn`` maps a batch of int64 indices, on the host one int."""
        from .ops.sources import Generate
        return Generate(self, size, fn, storage)

    def Distribute(self, items, storage: Optional[str] = None):
        from .ops.sources import Distribute
        return Distribute(self, items, storage)

    def EqualToDIA(self, items, storage: Optional[str] = None):
        """Data every worker holds alike, as a DIA (reference:
        api/equal_to_dia.hpp:30); one process holds it for every worker,
        so this is Distribute."""
        from .ops.sources import Distribute
        return Distribute(self, items, storage)

    def ConcatToDIA(self, per_worker_items, storage: Optional[str] = None):
        from .ops.sources import ConcatToDIA
        return ConcatToDIA(self, per_worker_items, storage)

    def ReadLines(self, path_or_glob: str):
        """The text lines of the files (host storage)."""
        from .ops import read_write
        return read_write.ReadLines(self, path_or_glob)

    def ReadWordsPacked(self, path_or_glob: str, max_word: int = 16):
        """The whitespace-separated words of the files as a device DIA of
        ``{"w": [max_word] uint8}`` rows, tokenized on the device."""
        from .ops import read_write
        return read_write.ReadWordsPacked(self, path_or_glob, max_word)

    def ReadBinary(self, path_or_glob: str, dtype, record_shape=()):
        """Fixed-size records of ``dtype`` and ``record_shape`` as a
        device DIA."""
        from .ops import read_write
        return read_write.ReadBinary(self, path_or_glob, dtype,
                                     record_shape)

    def explain(self, pipeline_fn: Optional[Callable] = None,
                name: str = "") -> str:
        """The physical plan as an annotated tree: ops, fused segments,
        the exchange strategy of each shuffle, and every recorded
        decision with its reason and audit. ``ctx.explain(fn)`` runs
        ``fn(ctx)`` and renders the nodes it made; ``ctx.explain()``
        every node still alive. It reads the ledger and changes no
        plan."""
        from ..common.decisions import render_plan
        lo = 0
        if pipeline_fn is not None:
            lo = len(self._nodes)
            pipeline_fn(self)
        nodes = []
        for ref, nid, label, parents in self._nodes[lo:]:
            n = ref()
            nodes.append({"id": nid, "label": label, "parents": parents,
                          "state": n.state if n is not None
                          else "DISPOSED"})
        return render_plan(
            nodes,
            self.decisions.snapshot(), W=self.num_workers,
            title=name or (getattr(pipeline_fn, "__name__", "")
                           if pipeline_fn is not None else ""))

    # -- failure domains ---------------------------------------------------
    @contextlib.contextmanager
    def pipeline(self, name: str = ""):
        """A failure domain for one pipeline run (reference:
        ``api/context.py:1187``). An error escaping the block aborts
        only this run: the Context heals (:meth:`_heal`) and the block
        raises a :class:`PipelineError` with the root cause and the
        failed generation; the next pipeline runs as on a fresh
        Context. An unrecoverable verdict (a heartbeat's dead peer, a
        sticky CUDA error, a heal that failed) raises the original
        error. Entering starts a fresh generation (never re-used), so
        results cached by earlier pipelines survive this block's abort;
        a nested block's clean exit restores the enclosing domain.
        Across processes every process enters and leaves the block at
        the same program points. Yields the generation id."""
        parent = self.generation
        self._gen_counter += 1
        self.generation = self._gen_counter
        self.net.group.generation = self.generation
        gen = self.generation
        try:
            yield gen
            # a deferred check crossing the boundary belongs to this run
            self.mesh_exec.drain_checks()
        except PipelineError:
            # a nested block already healed and wrapped this failure
            self.generation = parent
            raise
        except Exception as e:
            replacement = self._pipeline_failed(e, name)
            if replacement is e:
                raise
            # healed: stamping resumes in the enclosing domain, the wire
            # generation stays past the failed one (its frames are stale)
            self.generation = parent
            try:
                raise replacement from e
            finally:
                # the frame would hold the error (and through its
                # traceback the failed run's tensors) in a cycle
                replacement = None
        else:
            self.generation = parent
            self.net.group.generation = parent

    def _pipeline_failed(self, exc: BaseException,
                         name: str = "") -> BaseException:
        """The abort's bookkeeping and the heal; returns what the caller
        raises: a PipelineError after a heal, ``exc`` itself when the
        failure cannot be healed."""
        from ..net.group import ClusterAbort
        failed_gen = self.generation
        unrecoverable = ((isinstance(exc, ClusterAbort)
                          and not getattr(exc, "recoverable", True))
                         or sticky_cuda_error(exc)
                         or (self.mesh_exec.multiprocess
                             and device_plane_broken(exc)))
        origin = int(getattr(exc, "origin", self.host_rank))
        cause = str(getattr(exc, "cause", "") or
                    f"{type(exc).__name__}: {exc}")
        self.stats_pipeline_aborts += 1
        if self.logger.enabled:
            self.logger.line(event="pipeline_abort", origin=origin,
                             generation=failed_gen, pipeline=name or None,
                             recoverable=not unrecoverable,
                             cause=cause[:300])
        try:
            self.decisions.dump_beside(
                self.tracer.dump_flight(cause, generation=failed_gen))
        except Exception:
            pass
        if self.net.num_workers > 1 and not isinstance(exc, ClusterAbort):
            # a failure of this process alone: the peers abort this
            # generation too and meet this process at the barrier
            try:
                self.net.group.poison_peers(cause)
            except Exception:
                pass
        if not unrecoverable:
            try:
                self._heal(failed_gen)
            except Exception as he:
                unrecoverable = True
                faults.note("recovery", what="heal_failed",
                            gen=failed_gen, error=repr(he)[:300])
        if unrecoverable:
            self._aborted = True
            if self.mesh_exec.multiprocess:
                # a peer may wait inside a gloo collective this process
                # will not enter: closing the device plane releases it
                # now (it then escalates too) rather than after gloo's
                # own timeout
                from ..common.platform import abandon_process_group
                abandon_process_group()
            return exc
        return PipelineError(origin, cause, failed_gen, root=exc)

    def _heal(self, failed_gen: int) -> None:
        """Tear generation ``failed_gen`` down (reference:
        ``api/context.py:1306``): drop the mesh's per-run state (the
        deferred checks and a loop capture), wait for the card's queue (the failed run's kernels
        and copies end before any of their buffers is reused; a sticky
        CUDA error shows here and fails the heal), dispose the failed
        run's nodes (their HBM ledger entries, spilled blocks and
        memory grants), then run the generation barrier over the host
        group. Raises when the mesh cannot be healed."""
        from .dia_base import DISPOSED
        t0 = time.monotonic()
        mex = self.mesh_exec
        self._gen_counter = max(self._gen_counter, failed_gen) + 1
        self.generation = self._gen_counter
        checks_dropped = mex.reset_run_state()
        if mex.device.type == "cuda":
            torch.cuda.synchronize(mex.device)
        released = 0
        for ref, *_ in self._nodes:
            node = ref()
            if node is None or getattr(node, "_generation", 0) != failed_gen:
                continue
            self.release_mem(node)
            if node.state == DISPOSED:
                continue
            try:
                node.dispose()
                released += 1
            except Exception:
                pass           # best effort: the ledger entry is gone
        stale = self.net.group.begin_generation(self.generation)
        # a process that missed the abort adopts the generation its
        # peers' barrier markers announced
        self.generation = max(self.generation, self.net.group.generation)
        self._gen_counter = max(self._gen_counter, self.generation)
        hb = getattr(self.net.group, "_heartbeat", None)
        if hb is not None and (hb._thread is None
                               or not hb._thread.is_alive()):
            from ..net import heartbeat
            self.net.group._heartbeat = heartbeat.maybe_start(
                self.net.group)
        self._aborted = False
        gc.collect()
        dt = time.monotonic() - t0
        self.stats_heal_time_s += dt
        if self.logger.enabled:
            self.logger.line(event="heal", generation=self.generation,
                             heal_time_s=round(dt, 4),
                             nodes_released=released,
                             checks_dropped=checks_dropped,
                             stale_frames=stale)

    def abort(self, cause: Any) -> None:
        """Coordinated abort (reference: ``api/context.py:1367``): send
        ``cause`` as a poison frame to every process (each surfaces it
        as a ClusterAbort with this root cause), log ``event=abort``,
        then raise it here."""
        from ..net.group import ClusterAbort
        self._aborted = True
        if self.logger.enabled:
            cause_s = (f"{type(cause).__name__}: {cause}"
                       if isinstance(cause, BaseException) else str(cause))
            self.logger.line(event="abort", origin=self.host_rank,
                             generation=self.generation,
                             cause=cause_s[:300])
        try:
            self.decisions.dump_beside(self.tracer.dump_flight(
                cause, generation=self.generation))
        except Exception:
            pass
        if self.net.num_workers > 1:
            self.net.group.poison_peers(cause)
        if isinstance(cause, BaseException):
            raise cause
        raise ClusterAbort(self.host_rank, str(cause),
                           generation=self.generation)

    def collective_mean_stdev(self, value: float):
        """(mean, stdev) of a per-process scalar over the processes: a
        collective every process calls (reference:
        PrintCollectiveMeanStdev, api/context.hpp:352-375)."""
        vals = [float(v) for v in self.net.all_gather(float(value))]
        mean = sum(vals) / len(vals)
        var = sum((v - mean) ** 2 for v in vals) / len(vals)
        return mean, var ** 0.5

    def print_collective_mean_stdev(self, label: str,
                                    value: float) -> None:
        """Rank 0 prints the mean and stdev of a per-process scalar."""
        mean, stdev = self.collective_mean_stdev(value)
        if self.host_rank == 0:
            print(f"{label}: mean {mean:.6g} stdev {stdev:.6g} over "
                  f"{self.net.num_workers} hosts", flush=True)

    def overall_stats(self, local_only: bool = False) -> dict:
        """The counters the port keeps, under the reference's names
        (OverallStats): the mesh's exchange traffic, the nodes created,
        the HBM governor's ledger peak (``hbm_peak``: the most bytes of
        cached device results at once, not the allocator's peak), its
        spills and restores, its tenant ledger's peaks
        (``tenant_hbm_peaks``) and spills (``tenant_spills``), the runs
        of the external Sort adopted from departed processes
        (``runs_adopted``), the pressure ladder's counters, the
        dispatch choke point's (``device_dispatches``,
        ``device_fetches``: host syncs), stitching's
        (``fused_dispatches``, ``fused_ops``, ``fused_stages``: each
        stitched stage's ops and launches), the hinted join's lineage
        retries (``join_overflow_retries``), the loop layer's five
        (``loop_plan_builds``, ``loop_replays``, ``loop_fori_iters``,
        ``loop_replay_fallbacks``, ``loop_donated_bytes``), the plan
        layer's (``exchanges_overlapped``: phase B with no host read;
        ``cap_cache_hits``/``_misses``; ``bytes_wire_device`` and its
        full-width ``_raw``; ``device_uploads``; ``plan_builds``,
        ``plan_store_hits``; ``planner_replans``/``_switches``;
        ``decisions_recorded``/``_joined``, ``decision_accuracy``) and,
        with a checkpoint manager, its five (epochs, bytes written, ops
        and sort runs skipped by resume, restore seconds). The service
        plane adds the scheduler's (``jobs_submitted``, ``jobs_failed``,
        ``jobs_rejected``, ``jobs_rate_limited``, ``queue_depth_peak``),
        the front door's ``fd_*`` and the autoscaler's
        (``autoscale_decisions``, ``autoscale_ticks``), all zero without
        them, and per tenant the accept-to-result quantiles
        ``serve_p50_ms``/``serve_p99_ms`` (reference:
        ``api/context.py:1013-1080``). Across processes (unless
        ``local_only``, once the Context has served, or once a committed
        resize move is exiting) the counters are gathered: items and bytes
        moved, waits, delayed faults, adopted runs and tenant spills sum
        over the processes, ``hbm_peak`` and ``skew_ratio`` take the
        largest, every other counter is process 0's (a plan counter is
        the same on every process), and ``hosts`` counts the processes
        (reference: ``api/context.py:911``)."""
        mex = self.mesh_exec
        fstats = faults.REGISTRY.stats()
        stats = {
            "workers": self.num_workers,
            "nodes_created": self._next_id,
            "exchanges": mex.stats_exchanges,
            "items_moved": mex.stats_items_moved,
            "bytes_moved": mex.stats_bytes_moved,
            "device_dispatches": mex.stats_dispatches,
            "device_fetches": mex.stats_fetches,
            "fused_dispatches": mex.stats_fused_dispatches,
            "fused_ops": mex.stats_fused_ops,
            # a snapshot: the metrics thread reads this while the
            # dispatch inserts stages
            "fused_stages": {" + ".join(ops): n for ops, n in
                             dict(mex.fused_stage_counts).items()},
            "join_overflow_retries": mex.stats_join_overflow_retries,
            "loop_plan_builds": mex.stats_loop_plan_builds,
            "loop_replays": mex.stats_loop_replays,
            "loop_fori_iters": mex.stats_loop_fori_iters,
            "loop_replay_fallbacks": mex.stats_loop_fallbacks,
            "loop_donated_bytes": mex.stats_loop_donated_bytes,
            "exchanges_overlapped": mex.stats_exchanges_overlapped,
            "cap_cache_hits": mex.stats_cap_cache_hits,
            "cap_cache_misses": mex.stats_cap_cache_misses,
            "bytes_wire_device": mex.stats_bytes_wire_device,
            "bytes_wire_device_raw": mex.stats_bytes_wire_device_raw,
            "device_uploads": mex.stats_uploads,
            "plan_builds": mex.stats_plan_builds,
            "plan_store_hits": mex.stats_plan_store_hits,
            **(self.planner.stats() if self.planner is not None else
               {"planner_replans": 0, "planner_switches": 0}),
            "decisions_recorded": sum(self.decisions.kind_counts.values()),
            "decisions_joined": sum(self.decisions.joined_counts.values()),
            "decision_accuracy": {
                k: v["mae_log2"]
                for k, v in self.decisions.accuracy().items()
                if v.get("mae_log2") is not None},
            "hbm_peak": self.hbm.mem.peak,
            "tenant_hbm_peaks": dict(self.hbm.tenant_peaks),
            "tenant_spills": self.hbm.tenant_spill_count,
            "hbm_spills": self.hbm.spill_count,
            "hbm_restores": self.hbm.restore_count,
            **self.pressure.stats(),
            **(self.doctor.stats() if self.doctor is not None else
               {"collective_wait_s": 0.0, "wait_net_s": 0.0,
                "wait_exchange_s": 0.0, "wait_io_s": 0.0,
                "wait_skew_s": 0.0, "straggler_waits": {},
                "skew_ratio": 0.0}),
            "faults_delayed": (fstats["faults_delayed"]
                               - self._faults_base["faults_delayed"]),
            # failure domains and elasticity
            "generation": self.generation,
            "pipeline_aborts": self.stats_pipeline_aborts,
            "heal_time_s": round(self.stats_heal_time_s, 4),
            "resizes": self.stats_resizes,
            "resize_time_s": round(self.stats_resize_time_s, 4),
            "resizes_proc": self.stats_resizes_proc,
            **(self.autoscaler.stats() if self.autoscaler is not None
               else {"autoscale_decisions": 0, "autoscale_ticks": 0}),
            "runs_adopted": adopted_total(),
            "conn_reconnects": getattr(self.net.group, "stats_reconnects",
                                       0),
            "stale_frames_dropped": getattr(self.net.group,
                                            "stats_stale_dropped", 0),
            **(self.service.stats() if self.service is not None else
               {"jobs_submitted": 0, "jobs_failed": 0,
                "jobs_rejected": 0, "jobs_rate_limited": 0,
                "queue_depth_peak": 0}),
            **(self.front_door.stats() if self.front_door is not None
               else {"fd_conns_accepted": 0, "fd_conns_dropped": 0,
                     "fd_jobs_submitted": 0, "fd_jobs_rejected": 0,
                     "fd_chunks_sent": 0, "fd_slow_clients": 0,
                     "fd_deadline_expired": 0}),
            **({"serve_p50_ms": {}, "serve_p99_ms": {}}
               if self.service is None
               else self.service.latency_quantiles()),
        }
        if self.checkpoint is not None:
            stats.update(self.checkpoint.stats())
        # the spill tier's I/O since this Context was made: spilled runs,
        # columnar blocks, readahead, write-behind bytes, object-store
        # requests (reference: api/context.py:1093-1095); the write-behind
        # queue's high-water mark is the process's, not this Context's,
        # so it stays out
        from ..common.iostats import IO as _iostats
        io = _iostats.delta(_iostats.snapshot(), self._io_base)
        io.pop("writeback_queue_peak")
        stats.update(io)
        # bytes between processes: the device exchanges' and the host
        # frames' (reference: bytes_on_wire, api/context.py:937-960)
        stats["bytes_wire_host"] = getattr(mex, "stats_bytes_wire_host", 0)
        _wire_totals(stats)
        # once a process has served, its view stays local: a follower's
        # dispatcher waits on the host group for rank 0's ordering frames,
        # and a gather from this thread would race it for them (the
        # scheduler is made in lockstep, so every process skips alike)
        if self.net.num_workers > 1 and not local_only \
                and not self._aborted and self.service is None \
                and not self._resize_exiting:
            per_host = self.net.all_gather(stats)
            peaks = {"hbm_peak", "skew_ratio"}
            # runs adopted and tenant spills are each process's own
            # events; tenant_hbm_peaks stays process 0's (the
            # reference's rule)
            sums = {"items_moved", "bytes_moved", "faults_delayed",
                    "collective_wait_s", "wait_net_s", "wait_exchange_s",
                    "wait_io_s", "wait_skew_s", "runs_adopted",
                    "tenant_spills", "bytes_wire_host",
                    # the spill tier's I/O is each process's own
                    "prefetch_hits", "prefetch_misses", "io_wait_s",
                    "io_busy_s", "writeback_bytes", "spill_runs",
                    "prefetch_submits", "records_blocks", "runs_reused",
                    "restore_overlaps", "remote_gets", "remote_puts"}
            stats = {k: (max(h[k] for h in per_host) if k in peaks
                         else sum(h[k] for h in per_host) if k in sums
                         else per_host[0][k]) for k in stats}
            _wire_totals(stats)
            stats["hosts"] = len(per_host)
        return stats

    def doctor_report(self, k: int = 5) -> dict:
        """The performance doctor's diagnosis: its stats, the wait and
        skew tables, and the critical path over the tracer's ring (the
        top ``k`` edges by exclusive time). Empty with
        ``THRILL_TPU_DOCTOR=0``."""
        if self.doctor is None:
            return {}
        ring = self.tracer.ring if self.tracer.enabled else None
        return self.doctor.report(ring=ring or (), k=k)

    def note_failure(self, exc: BaseException) -> None:
        """The job raised ``exc``: the flight recorder dumps its ring
        with the decision ledger beside it (best-effort: a failing dump
        never masks the failure), the other processes of a mesh are
        poisoned with the cause (a received abort is not sent back), and
        ``close()`` then drops this run's
        uncommitted epoch and the spill files of dead processes. Its
        deferred checks and a loop capture in progress are dropped. The
        exit of a committed resize move (:class:`ResizeRelaunch`) is no
        failure: it changes nothing."""
        if isinstance(exc, ResizeRelaunch) and self._resize_exiting:
            return
        self._aborted = True
        try:
            self.decisions.dump_beside(self.tracer.dump_flight(
                f"{type(exc).__name__}: {exc}"))
        except Exception:
            pass
        from ..net.group import ClusterAbort
        if self.net.num_workers > 1 and not isinstance(exc, ClusterAbort):
            # the other processes, blocked in a host collective, abort
            # with this root cause instead of waiting on this process
            self.net.group.poison_peers(exc)
        self.mesh_exec.reset_run_state()

    def close(self) -> None:
        """Stop the service plane (the autoscaler, then the front door,
        which flushes its streams while the dispatcher still runs their
        jobs, then the scheduler, which drains its queue), save the plan
        store (across processes rank 0 alone holds it), log the stats,
        detach the log and free the spill store (a spilled result cannot
        be pulled after this). It runs no collective: after a committed
        resize move every process exits at its own pace."""
        if self._metrics is not None:
            self._metrics.close()
            self._metrics = None
        with self._service_lock:
            self._closed = True
        if self.autoscaler is not None:
            try:
                self.autoscaler.stop()
            except Exception as e:
                faults.note("recovery", what="autoscale.stop_failed",
                            error=repr(e)[:200])
            self.autoscaler = None
        if self.front_door is not None:
            try:
                self.front_door.close()
            except Exception as e:
                faults.note("recovery", what="front_door.close_failed",
                            error=repr(e)[:200])
            self.front_door = None
        if self.service is not None:
            try:
                self.service.close()
            except Exception as e:
                faults.note("recovery", what="service.close_failed",
                            error=repr(e)[:200])
        if self._profiler is not None:
            self._profiler.stop()
            self._profiler = None
        if self.plan_store is not None:
            # plans are an optimization: a failing store must not fail
            # the close of the run that learned them
            try:
                self.plan_store.save(self.mesh_exec)
                if self.decisions.enabled and self.decisions.kind_counts:
                    self.plan_store.save_ledger(self.decisions.summary())
            except Exception as e:
                faults.note("recovery", what="plan_store.save_failed",
                            error=repr(e)[:200])
        if self.logger.enabled:
            self.logger.line(event="overall_stats",
                             **self.overall_stats(local_only=True))
        if faults.REGISTRY._log == self.logger.line:
            faults.REGISTRY.set_logger(None)
        self.logger.close()
        self.hbm.close()
        self.net.group.close()
        if self._aborted:
            if self.checkpoint is not None:
                self.checkpoint.abort_cleanup()
            from ..data.block_pool import purge_stale_spills
            purge_stale_spills(self.config.spill_dir)


def Run(job: Callable[[Context], Any], num_workers: int = 1,
        device: DeviceLike = None, config: Optional[Config] = None,
        resume: bool = False) -> Any:
    """Run ``job`` on a fresh Context of ``num_workers`` workers; the
    Context is closed when the job ends, however it ends.
    ``resume=True`` (or ``THRILL_TPU_RESUME=1``) restores the newest
    committed epoch of the configured checkpoint directory, and only
    the work after it runs again (api/checkpoint.py)."""
    ctx = Context(num_workers=num_workers, device=device, config=config,
                  resume=resume)
    try:
        return job(ctx)
    except BaseException as e:
        ctx.note_failure(e)
        raise
    finally:
        ctx.close()


def RunLocalTests(job: Callable[[Context], Any],
                  worker_counts: Sequence[int] = (1, 2, 4),
                  device: DeviceLike = None) -> List[Any]:
    """Sweep ``job`` over several worker counts on one device
    (reference: api::RunLocalTests)."""
    return [Run(job, w, device) for w in worker_counts]


def RunLocalMock(job: Callable[[Context], Any], workers: int,
                 config: Optional[Config] = None,
                 device: DeviceLike = "cpu") -> Any:
    """Run on a fixed-size mesh of ``workers`` workers on the CPU
    (reference: RunLocalMock, ``api/context.py:1634``)."""
    return Run(job, workers, device=device, config=config)


def RunSupervised(job: Callable[[Context], Any], num_workers: int = 1,
                  device: DeviceLike = None,
                  config: Optional[Config] = None,
                  max_restarts: int = 2) -> Any:
    """Run with supervised re-execution (reference: ``api/context.py:
    1604``): an abort-class failure (a ClusterAbort, a lost link, a
    timeout) runs the same job again with ``resume=True``, so a
    committed checkpoint epoch bounds the work done again."""
    from ..net.group import ClusterAbort
    attempt = 0
    while True:
        try:
            return Run(job, num_workers, device=device, config=config,
                       resume=attempt > 0)
        except (ClusterAbort, ConnectionError, TimeoutError) as e:
            if attempt >= max_restarts:
                raise
            attempt += 1
            faults.note("recovery", what="supervised_restart",
                        attempt=attempt, error=repr(e))
            print(f"thrill_tpu_torch: supervised restart {attempt}/"
                  f"{max_restarts} after {e!r} (resume=True)",
                  file=sys.stderr)


def RunDistributed(job: Callable[[Context], Any],
                   coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   workers_per_process: int = 1,
                   device: DeviceLike = None,
                   config: Optional[Config] = None,
                   resume: bool = False) -> Any:
    """Run ``job`` as process ``process_id`` of ``num_processes``, each
    with ``workers_per_process`` workers on its device (``cuda`` unless
    the caller names another; the processes may share one card), so the
    mesh has ``num_processes * workers_per_process`` workers (reference:
    ``api/context.py:1653-1709``). Every process runs this function with
    the same job. ``coordinator_address`` (``host:port``) is where the
    ``torch.distributed`` process group meets; the host control plane
    is the TCP group of ``THRILL_TPU_HOSTLIST``/``_RANK``/``_SECRET``.
    Sources that take global data (Distribute, Generate) expect the same
    input on every process, and each keeps its workers' part; per-process
    data enters through ConcatToDIA. The process group is destroyed when
    the job ends, however it ends."""
    P = int(num_processes or 1)
    rank = int(process_id or 0)
    dev = resolve_device(device)
    if P > 1:
        from ..common.platform import init_process_group
        if not coordinator_address:
            raise ValueError("RunDistributed needs a coordinator_address "
                             "for more than one process")
        init_process_group(coordinator_address, P, rank, dev)
    try:
        mex = MeshExec(num_workers=P * int(workers_per_process),
                       device=dev, process_index=rank, num_processes=P)
        ctx = Context(mex, config=config, resume=resume)
        try:
            return job(ctx)
        except BaseException as e:
            ctx.note_failure(e)
            raise
        finally:
            ctx.close()
    finally:
        if P > 1:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()
