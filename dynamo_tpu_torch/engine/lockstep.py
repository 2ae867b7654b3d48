"""The plan channel of a tp group: the leader runs the scheduler, and every
device operation it issues is replayed by tp - 1 follower processes on
their own shards.

The port of the JAX package's multihost lockstep (`_plan_pack` /
`_plan_unpack`, `_lockstep_send`, `follower_loop`,
`dynamo_tpu/engine/engine.py:1284-1310`, `:4275-4375`) for the ranks of
one host:

- a plan is a dict (``kind`` plus the dispatch's host arrays), packed
  with the port's msgpack (`runtime/transport/wire.py`; numpy arrays as
  (dtype, shape, bytes)) and broadcast over the group's CPU gloo group by
  `parallel.collectives.broadcast_plan`;
- the leader sends a plan before its own device work of that dispatch
  (`TorchEngine._plan`), then every rank reports whether it could take it
  (an all-reduce of a ready flag over the same group).  A follower that
  cannot (its dispatch raised before any model collective) makes the
  leader's step raise `FollowerError`: the leader fails the step's
  requests and broadcasts ``recover``, on which every rank zeroes its
  pool and opens fresh device groups;
- a follower whose device work fails midway is poisoned: the leader's
  next model collective times out (`parallel.mesh.tp_timeout_s`) and
  recovers as above; until ``recover`` the poisoned follower refuses
  every plan, so no rank streams tokens from a diverged pool;
- the kinds: ``prefill`` (a prefill pass, also the prefill half of a
  mixed dispatch; with media, the rows' embeddings, masks and M-RoPE
  streams the leader's tower made: followers hold no tower), ``decode`` (one-step or multi-step blocks, a chain of
  them, also a mixed dispatch's decode half), ``spec`` (a speculative
  verify), ``embed``, ``kv_export`` (pages of every rank's pool joined
  into full kv heads, JAX's plan of that name), ``kv_import`` (full-head
  pages the leader broadcasts, each rank scattering its heads; or the
  CUDA IPC lane's windows, each rank reading its heads from a source
  group's pools), ``ipc_export`` (each rank's CUDA IPC entry for its
  pools) and ``kv_read`` (each rank's own heads of some pages, on the
  host), both gathered like ``stats``, ``recover``, ``stats`` and
  ``shutdown``; every plan reaches every rank of every replica, and
  ``recover``, ``stats``, the ready check and ``shutdown`` cover them
  all;
- every wait is bounded: model collectives by the device group's timeout,
  a follower's wait for the next plan by a day (the leader may idle) and
  at once when the leader's process goes (its sockets close; a watchdog
  thread also checks the parent), the leader's joins of its followers by
  `JOIN_TIMEOUT_S`.

`start_group` is called by a leader `TorchEngine`; `follower_main` runs
in each follower process.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.collectives import broadcast_plan
from ..parallel.mesh import (
    ParallelConfig,
    TpGroup,
    choose_backend,
    free_port,
    group_devices,
)
from ..runtime.transport.wire import pack, unpack

logger = logging.getLogger(__name__)

JOIN_TIMEOUT_S = 60.0


class FollowerError(RuntimeError):
    """A follower could not take the leader's plan."""


# -- the plan codec ------------------------------------------------------------ #


def _enc(o: Any) -> Any:
    if isinstance(o, np.ndarray):
        return {"__nd__": [str(o.dtype), list(o.shape),
                           np.ascontiguousarray(o).tobytes()]}
    if isinstance(o, dict):
        return {k: _enc(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_enc(v) for v in o]
    if isinstance(o, np.generic):
        return o.item()
    return o


def _dec(o: Any) -> Any:
    if isinstance(o, dict):
        if "__nd__" in o:
            dtype, shape, buf = o["__nd__"]
            return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        return {k: _dec(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_dec(v) for v in o]
    return o


def plan_pack(desc: Dict[str, Any]) -> bytes:
    return pack(_enc(desc))


def plan_unpack(data: bytes) -> Dict[str, Any]:
    return _dec(unpack(data))


def _all_ready(ok: bool) -> bool:
    """Every rank took the plan (a MIN all-reduce over the plan group)."""
    t = torch.tensor([1 if ok else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def _gather(obj) -> List[Any]:
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


# -- the leader ----------------------------------------------------------------- #


class Leader:
    """The leader's end of the channel: sends plans, recovers the group,
    gathers the followers' stats and stops them."""

    def __init__(self, group: TpGroup, procs: List[mp.Process]):
        self.group = group
        self.procs = procs
        self.plans = 0
        self.lost: Optional[str] = None
        # the kind of the last plan sent while its op has not completed
        # (the engine clears it when the op returns): a failed op with a
        # plan out recovers the group
        self.open: Optional[str] = None
        # per rank: its kernel launches (the followers' as of the last
        # `stats` or `shutdown` plan), and all it reported (`_own_stats`)
        self.rank_launches: Dict[int, Dict[str, int]] = {}
        self.rank_stats: Dict[int, Dict[str, Any]] = {}

    def _bcast(self, desc: Dict[str, Any]) -> None:
        if self.lost:
            raise RuntimeError(f"the tp group is lost: {self.lost}")
        try:
            broadcast_plan(plan_pack(desc))
        except RuntimeError as e:
            self.lost = f"plan channel failed: {e}"
            raise
        self.plans += 1

    def send(self, desc: Dict[str, Any]) -> None:
        """Broadcast one plan and wait until every rank has taken it;
        raises `FollowerError` when a follower could not."""
        self._bcast(desc)
        self.open = desc["kind"]
        if not _all_ready(True):
            raise FollowerError(
                f"a follower could not replay the {desc['kind']!r} plan")

    def recover(self) -> None:
        """Every rank zeroes its pool and opens a fresh device group."""
        self.open = None
        self._bcast({"kind": "recover"})
        self.group.rebuild()

    def stats(self, engine=None) -> Dict[int, Dict[str, int]]:
        """Every rank's launches (the leader reports its `engine` beside
        them); the rest of each rank's report lands in `rank_stats`."""
        self._bcast({"kind": "stats"})
        self._take_stats(_gather(_own_stats(engine)))
        return dict(self.rank_launches)

    def ipc_entries(self, own: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Every rank's CUDA IPC entry for its pools (the leader's is
        `own`), in rank order; raises if a follower could not make one."""
        self._bcast({"kind": "ipc_export"})
        entries = _gather(own)
        bad = [r for r, e in enumerate(entries) if e is None]
        if bad:
            raise RuntimeError(f"tp ranks {bad} could not export their pools "
                               f"through CUDA IPC (see their logs)")
        return entries

    def read_pages(self, pages: List[int], own) -> List[Any]:
        """Every rank's own heads of `pages` (host tensors; the leader's
        are `own`), in rank order."""
        self._bcast({"kind": "kv_read", "pages": pages})
        return _gather(own)

    def _take_stats(self, per_rank: List[dict]) -> None:
        for rank, s in enumerate(per_rank):
            if s is not None:
                self.rank_launches[rank] = s["launches"]
                self.rank_stats[rank] = s

    def abort(self) -> None:
        """The leader failed to build its engine: the followers' handshake
        fails (they exit), and the leader leaves the group."""
        try:
            handshake(False, "build its engine")
        except RuntimeError:
            pass
        self.lost = "the leader failed to build its engine"
        self.shutdown()

    def shutdown(self) -> None:
        """Stop the followers (their last stats come back first), join
        them within `JOIN_TIMEOUT_S` each, terminate stragglers, and leave
        the group."""
        if not self.lost:
            try:
                self._bcast({"kind": "shutdown"})
                self._take_stats(_gather(_own_stats()))
            except RuntimeError:
                logger.exception("tp shutdown: the followers did not answer")
        for p in self.procs:
            p.join(JOIN_TIMEOUT_S)
            if p.is_alive():
                logger.error("tp follower %s did not exit; terminating", p.pid)
                p.terminate()
                p.join(JOIN_TIMEOUT_S)
        self.group.close()


def _own_ipc_entry(engine) -> Optional[Dict[str, Any]]:
    from ..disagg.device_transfer import ipc_export

    try:
        return ipc_export(engine)
    except Exception:  # noqa: BLE001 — the leader raises for the group
        logger.exception("tp rank %d cannot export its pools", engine.group.rank)
        return None


def _own_stats(engine=None) -> dict:
    """This rank's kernel launches and, given its engine, its pipeline
    stage, sequence slot, stage handoffs or ring rotations (sends, bytes,
    host ms) and sequence gathers, the layout rows of its
    recent media splices and the parameters of its vision tower (none but
    the leader's)."""
    from ..ops._launches import LAUNCHES

    out = {"rank": dist.get_rank(), "launches": dict(LAUNCHES)}
    if engine is not None:
        out["stage"] = engine.group.stage
        out["sp_rank"] = engine.group.sp_rank
        out["handoffs"] = dict(engine.group.handoffs)
        out["gathers"] = dict(engine.group.gathers)
        tower = engine.vision[0] if engine.vision else None
        out["media_rows"] = list(engine.media_rows)
        out["tower_params"] = (0 if tower is None else
                               sum(p.numel() for p in tower.parameters()))
    return out


def start_group(pcfg: ParallelConfig, devices: Optional[Sequence],
                follower_args: Dict[str, Any]):
    """Spawn the followers of a dp x pp x tp group and join it as rank 0:
    returns (TpGroup, [processes], each rank's device).  `follower_args`
    are what each follower needs to build its engine (pickled to it): the
    model config, the model source, the engine config and the eos ids
    (never a vision tower: the leader alone runs it).  The followers run
    torch's host ops on as many threads as the leader: ranks sharing a
    host's cores (the CPU groups) spin less in their collectives."""
    devs = group_devices(pcfg, devices)
    backend = choose_backend(devs)
    init = f"tcp://127.0.0.1:{free_port()}"
    ctx = _follower_context()
    procs = []
    for rank in range(1, pcfg.world):
        spec = dict(follower_args, rank=rank, parallel=pcfg,
                    devices=[str(d) for d in devs], backend=backend,
                    init_method=init, env=dict(os.environ),
                    threads=torch.get_num_threads())
        p = ctx.Process(target=follower_main, args=(spec,),
                        name=f"tp-follower-{rank}", daemon=True)
        p.start()
        procs.append(p)
    try:
        group = TpGroup(0, pcfg.world, devs[0], backend, init, dp=pcfg.dp,
                        pp=pcfg.pp, sp=pcfg.sp)
    except BaseException:
        for p in procs:
            p.terminate()
            p.join(JOIN_TIMEOUT_S)
        raise
    return group, procs, devs


def build_shard(source, group: TpGroup):
    """This rank's model from its source (`parallel.SeededShards` and
    its kin): its tensor rank's shard of its stage's layers."""
    if group.pp > 1:
        return source(group.tp_rank, group.tp, group.device,
                      stage=group.stage, pp=group.pp)
    return source(group.tp_rank, group.tp, group.device)


def build_in_turn(rank: int, devices: Sequence, build):
    """This rank's ``build()`` (its model shard).  Ranks that share a
    device take turns, in rank order, so one full tensor at a time is
    drawn on the device (`init_params` draws each tensor whole before
    keeping the rank's slice), each rank emptying its cache after its
    turn so what stays on the card is the shards.  Every rank passes
    every turn's barrier,
    even when its build raises, which it then re-raises."""
    if len(set(map(str, devices))) == len(devices):
        return build()
    out, err = None, None
    for turn in range(len(devices)):
        if turn == rank:
            try:
                out = build()
            except Exception as e:  # noqa: BLE001 — re-raised after the turns
                err = e
            if devices[rank].type == "cuda":
                # hand the turn's full-size draws back to the card before
                # the next rank draws (the caching allocator keeps them)
                torch.cuda.empty_cache()
        dist.barrier()
    if err is not None:
        raise err
    return out


def handshake(ok: bool, what: str) -> None:
    """Every rank has built its shard and engine (or one could not)."""
    if not _all_ready(ok):
        raise RuntimeError(f"a rank of the tp group failed to {what}")


# -- the followers ------------------------------------------------------------ #


def _follower_context():
    """Followers start from a fork server that has imported the port once
    (its first group starts it; later groups of the process reuse it), so
    each follower forks with torch and the engine already imported, where
    a spawned one would import them anew: seconds a rank.  Importing the
    port touches no CUDA device, so a forked follower opens its own CUDA
    context as a spawned one does.  A forked follower inherits the fork
    server's environment: `follower_main` takes the leader's, as it was
    when the group started."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["dynamo_tpu_torch.engine"])
    return ctx


def _watch_parent() -> None:
    """Exit when this follower's parent goes: the leader, or the fork
    server, which exits with the leader."""
    parent = os.getppid()

    def loop():
        while True:
            time.sleep(1.0)
            if os.getppid() != parent:
                os._exit(3)

    threading.Thread(target=loop, name="tp-parent-watch", daemon=True).start()


def follower_main(spec: Dict[str, Any]) -> None:
    """A follower process: join the group, build this rank's shard and
    engine, then replay the leader's plans until ``shutdown``."""
    from .engine import TorchEngine

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    os.environ.clear()
    os.environ.update(spec["env"])
    _watch_parent()
    torch.set_num_threads(spec["threads"])
    rank, pcfg = spec["rank"], spec["parallel"]
    devs = [torch.device(d) for d in spec["devices"]]
    group = TpGroup(rank, pcfg.world, devs[rank], spec["backend"],
                    spec["init_method"], dp=pcfg.dp, pp=pcfg.pp, sp=pcfg.sp)
    engine = None
    try:
        # every replica builds the same shards
        model = build_in_turn(rank, devs,
                              lambda: build_shard(spec["model"], group))
        engine = TorchEngine(spec["model_cfg"], model, spec["engine_cfg"],
                             eos_token_ids=spec["eos"], parallel=pcfg,
                             devices=devs, group=group)
    except Exception:  # noqa: BLE001 — tell the leader, then exit
        logger.exception("tp follower %d failed to build its engine", rank)
    handshake(engine is not None, "build its engine")
    follow(engine, group)
    group.close()


def follow(engine, group: TpGroup) -> None:
    """Replay plans on `engine` until ``shutdown`` (JAX `follower_loop`)."""
    poisoned = False
    while True:
        desc = plan_unpack(broadcast_plan(b""))
        kind = desc["kind"]
        if kind in ("shutdown", "stats"):
            _gather(_own_stats(engine))
            if kind == "shutdown":
                return
            continue
        if kind == "recover":
            engine.reset_kv()
            group.rebuild()
            poisoned = False
            continue
        if kind == "ipc_export":
            _gather(_own_ipc_entry(engine))
            continue
        if kind == "kv_read":
            _gather(engine.local_pages(desc["pages"]))
            continue
        ready = not poisoned
        inputs = None
        if ready:
            try:
                inputs = engine.replay_inputs(desc)
            except Exception:  # noqa: BLE001 — the leader recovers the group
                logger.exception("tp follower %d cannot take a %r plan",
                                 group.rank, kind)
                ready = False
        if not _all_ready(ready):
            continue
        try:
            engine.replay(desc, inputs)
        except Exception:  # noqa: BLE001 — refuse plans until recover
            logger.exception("tp follower %d: %r dispatch failed; awaiting "
                             "the leader's recover", group.rank, kind)
            poisoned = True
