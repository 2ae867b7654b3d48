"""`ParallelConfig` and the dp x pp x tp (or dp x sp x tp) group of the
port.

The JAX package lays its local devices out as a ``(dp, pp, tp)`` or
``(dp, sp, tp)`` mesh in one process and lets GSPMD insert the
collectives (`dynamo_tpu/parallel/mesh.py`, `pp_engine.py`,
`sp_prefill.py`).  PyTorch's idiom is one process per rank and explicit
collectives, so here `make_mesh` joins THIS process to a group of ``dp *
pp * sp * tp`` processes over `torch.distributed`.  pp and sp exclude
each other (as in JAX), so the middle axis is the one of them above 1:
rank ``r = (d * pp + s) * tp + t`` is tensor rank ``t`` of pipeline
stage ``s`` of data-parallel replica ``d``, and ``r = (d * sp + i) * tp +
t`` tensor rank ``t`` of sequence slot ``i`` (tp innermost, as JAX's
``np.array(devices).reshape(dp, pp|sp, tp)``; with both 1 it is ``d * tp
+ t``).  The leader, rank 0, is stage (or slot) 0 of replica 0.

- the default process group is ``gloo`` on the CPU and spans every rank;
  it carries the leader's plans (`engine/lockstep.py`) and the
  followers' answers;
- device groups: one tp group per (replica, stage or slot) carries its
  model collectives (`collectives.py`); one dp group per (stage or slot,
  tensor rank) carries the replicas' result and KV gathers (the ranks
  that hold the same layers, heads and sequence slot); one pp group per
  (replica, tensor rank) carries the KV moves' layer gathers and the
  results' way from the last stage to the leader; one sp group per
  (replica, tensor rank) carries the sequence gathers of the ring
  prefill (`parallel/sp_prefill.py`); under sp one pool group per tensor
  rank spans every (replica, slot), in partition order (a partitioned
  pool's ``dp * sp`` partitions; the dp group when sp is 1); and one
  two-rank group per pair of adjacent stages or slots of a (replica,
  tensor rank) carries the stage handoffs and the ring's K/V rotation
  (`collectives.stage_handoff`, `collectives.ring_shift`: a broadcast
  inside the pair, which gloo takes for CUDA tensors where it refuses
  ``send`` / ``recv``).  Device groups are ``nccl`` when every rank has
  a card of its own, ``gloo`` on the CPU and when ranks share a card
  (gloo takes CUDA tensors for ``broadcast`` and ``all_reduce``, which is
  all the port needs).  Two ranks on one device under ``nccl`` are
  refused, and so are fewer distinct cards than ranks when the caller
  did not name the devices: nothing puts the group onto the CPU or onto
  one card unless the caller asks for it.

Every degree of JAX's ``ParallelConfig`` is served; pp with sp is refused
as JAX refuses it.
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

# JAX's refusal of pp with sp (`dynamo_tpu/parallel/mesh.py:43-52`)
_PP_WITH_SP = ("pp composes with dp and tp (sp ring prefill within a pp stage "
               "is not supported — set sp = 1)")

# seconds a rank waits inside one model collective for the others before
# the collective raises (a rank that skipped or failed a dispatch); the
# leader then recovers the group (`engine/lockstep.py`)
DEFAULT_TIMEOUT_S = 120.0
# a follower waits for the leader's next plan as long as the leader idles;
# the wait also ends at once when the leader's process goes (its sockets
# close, and `lockstep.follower_main` watches its parent)
PLAN_TIMEOUT_S = 24 * 3600.0


@dataclass(frozen=True)
class ParallelConfig:
    """The JAX package's serving-mesh degrees (`dynamo_tpu/parallel/
    mesh.py`): data, tensor, sequence and pipeline parallelism."""

    dp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1

    @property
    def world(self) -> int:
        return self.dp * self.tp * self.sp * self.pp

    def validate(self, n_devices: int) -> None:
        if self.world != n_devices:
            raise ValueError(
                f"dp*tp*sp*pp = {self.world} != available devices {n_devices}")
        if self.pp > 1 and self.sp > 1:
            raise ValueError(_PP_WITH_SP)


def check_ported(pcfg: ParallelConfig) -> None:
    """Refuse degrees below 1 and pp with sp (dp x pp x tp and dp x sp x
    tp are served)."""
    for axis in ("dp", "tp", "sp", "pp"):
        n = getattr(pcfg, axis)
        if n < 1:
            raise ValueError(f"{axis} must be >= 1, got {n}")
    if pcfg.pp > 1 and pcfg.sp > 1:
        raise ValueError(_PP_WITH_SP)


def tp_timeout_s() -> float:
    """The model collectives' timeout: ``DYN_TORCH_TP_TIMEOUT_S`` (a
    deployment setting, like the group's address), else 120 s."""
    return float(os.environ.get("DYN_TORCH_TP_TIMEOUT_S", DEFAULT_TIMEOUT_S))


def group_devices(pcfg: ParallelConfig,
                  devices: Optional[Sequence[Union[str, torch.device]]] = None
                  ) -> List[torch.device]:
    """The device of each of the ``dp * pp * sp * tp`` ranks, in rank order.
    Without `devices`: one distinct card per rank (``cuda:0`` ..
    ``cuda:world-1``), refused when the machine has fewer; a caller who
    wants the CPU or one shared card names them."""
    check_ported(pcfg)
    world = pcfg.world
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"a parallel group runs on CUDA cards and none is available; "
                f"pass devices=['cpu'] * {world} to run the group on the CPU")
        n = torch.cuda.device_count()
        if n < world:
            raise RuntimeError(
                f"dp*pp*sp*tp={world} needs {world} distinct cards, this machine "
                f"has {n}; name the devices (e.g. ['cuda:0'] * {world}, "
                f"which shares one card over gloo) to run it anyway")
        return [torch.device("cuda", i) for i in range(world)]
    devs = [torch.device(d) for d in devices]
    pcfg.validate(len(devs))
    kinds = {d.type for d in devs}
    if not kinds <= {"cpu", "cuda"} or len(kinds) > 1:
        raise ValueError(f"a group's ranks are all cpu or all cuda: {devs}")
    if kinds == {"cuda"}:
        devs = [torch.device("cuda", 0 if d.index is None else d.index)
                for d in devs]
    return devs


def choose_backend(devs: Sequence[torch.device],
                   backend: Optional[str] = None) -> str:
    """``nccl`` for ranks on distinct cards, ``gloo`` on the CPU and for
    ranks that share a card; an explicit `backend` is checked against the
    devices (NCCL refuses two ranks of one communicator on one device)."""
    shared = len(set(devs)) < len(devs)
    cpu = devs[0].type == "cpu"
    if backend is None:
        return "gloo" if cpu or shared else "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if backend == "nccl" and cpu:
        raise ValueError("nccl runs on CUDA cards; a CPU group uses gloo")
    if backend == "nccl" and shared:
        raise ValueError(
            f"nccl refuses two ranks on one device ({list(map(str, devs))}); "
            f"ranks that share a card use gloo")
    return backend


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class TpGroup:
    """This process's rank in a dp x pp x tp or dp x sp x tp group: its
    global rank and the group's size, its replica ``d``, stage ``s`` (0
    without pp), sequence slot ``sp_rank`` (0 without sp) and tensor rank
    ``t``, its device, the device backend, and the process groups (the
    default gloo group for plans; its (replica, stage or slot)'s tp device
    group for the model's collectives, `dev_group`; its (stage or slot,
    tensor rank)'s dp device group for the replicas' gathers, `dp_group`;
    its (replica, tensor rank)'s pp or sp device group, `pp_group` /
    `sp_group`; its tensor rank's pool group over every (replica, slot),
    `pool_group` (the dp group without sp); and the two-rank groups to its
    neighbouring stages or slots, `prev_group` and `next_group`; each None
    when its axis is 1).  One per process: `torch.distributed` keeps the
    default group per process, so a second live group in one process is
    refused."""

    # the sequence axis of a group without one (a layout check may set
    # only the others)
    sp = 1

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str, init_method: str, dp: int = 1, pp: int = 1,
                 sp: int = 1):
        if dist.is_initialized():
            raise RuntimeError(
                "this process already belongs to a torch.distributed group; "
                "shut the other group's engine down first")
        if pp > 1 and sp > 1:
            raise ValueError(f"pp={pp} and sp={sp} exclude each other")
        if world % (dp * pp * sp):
            raise ValueError(f"dp={dp} x pp={pp} x sp={sp} does not divide "
                             f"the world {world}")
        self.rank = rank
        self.world = world
        self.dp = dp
        self.pp = pp
        self.sp = sp
        self.tp = world // (dp * pp * sp)
        self.replica, rest = divmod(rank, pp * sp * self.tp)
        mid, self.tp_rank = divmod(rest, self.tp)
        self.stage = mid if pp > 1 else 0
        self.sp_rank = mid if sp > 1 else 0
        self.device = device
        self.backend = backend
        self.timeout_s = tp_timeout_s()
        # this rank's stage handoffs and ring rotations (sends, bytes, host
        # ms; `collectives.stage_handoff` / `ring_shift`) and sequence
        # gathers (`collectives.gather_seq`): a rank's stats report
        self.handoffs = {"sends": 0, "bytes": 0, "ms": 0.0}
        self.gathers = {"calls": 0, "bytes": 0, "ms": 0.0}
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            "gloo", init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=PLAN_TIMEOUT_S))
        self._new_device_groups()
        self.closed = False

    @property
    def mid(self) -> int:
        """Slots of the middle axis (the stages, or the sequence slots)."""
        return self.pp * self.sp

    @property
    def mid_rank(self) -> int:
        """This rank's slot on the middle axis (its stage or sequence
        slot)."""
        return self.stage + self.sp_rank

    @property
    def part(self) -> int:
        """This rank's partition of a pool partitioned over (dp, sp)."""
        return self.replica * self.sp + self.sp_rank

    def rank_of(self, replica: int, stage: int, tp_rank: int) -> int:
        """The global rank of (replica, stage or sequence slot, tensor
        rank)."""
        return (replica * self.mid + stage) * self.tp + tp_rank

    def part_rank(self, part: int, tp_rank: int = 0) -> int:
        """The global rank of tensor rank `tp_rank` of partition `part`."""
        d, i = divmod(part, self.sp)
        return self.rank_of(d, i, tp_rank)

    def tp_ranks(self, replica: Optional[int] = None) -> List[int]:
        """The global ranks of a replica's tp group at this rank's stage
        or slot (this rank's)."""
        d = self.replica if replica is None else replica
        return [self.rank_of(d, self.mid_rank, t) for t in range(self.tp)]

    def dp_ranks(self) -> List[int]:
        """The global ranks of this (stage or slot, tensor rank)'s dp
        group (one a replica, in replica order)."""
        return [self.rank_of(d, self.mid_rank, self.tp_rank)
                for d in range(self.dp)]

    def pp_ranks(self) -> List[int]:
        """The global ranks of this (replica, tensor rank)'s pp group (one
        a stage, in stage order)."""
        return [self.rank_of(self.replica, s, self.tp_rank)
                for s in range(self.pp)]

    def sp_ranks(self) -> List[int]:
        """The global ranks of this (replica, tensor rank)'s sp group (one
        a slot, in slot order)."""
        return [self.rank_of(self.replica, i, self.tp_rank)
                for i in range(self.sp)]

    def pool_ranks(self) -> List[int]:
        """The global ranks of this tensor rank's pool group: every
        (replica, slot), in partition order (``d * sp + i``)."""
        return [self.part_rank(p, self.tp_rank)
                for p in range(self.dp * self.sp)]

    @property
    def last_stage(self) -> bool:
        return self.stage == self.pp - 1

    def _new_device_groups(self) -> None:
        """Every rank creates every device group, in the same order: the
        tp groups of the (replica, stage or slot) pairs, the dp groups of
        the (stage or slot, tensor rank) pairs, the pp or sp groups of the
        (replica, tensor rank) pairs, the pool groups (under sp), then the
        adjacent pairs' groups (`new_group` is collective over the default
        group).  A one-rank axis has no group."""
        timeout = datetime.timedelta(seconds=self.timeout_s)
        self.dev_group = self.dp_group = self.pp_group = None
        self.sp_group = self.pool_group = None
        self.prev_group = self.next_group = None

        def make(ranks):
            return dist.new_group(ranks=ranks, backend=self.backend,
                                  timeout=timeout)

        D, S, T = self.dp, self.mid, self.tp
        me = self.mid_rank
        if T > 1:
            for d in range(D):
                for s in range(S):
                    g = make([self.rank_of(d, s, t) for t in range(T)])
                    if (d, s) == (self.replica, me):
                        self.dev_group = g
        if D > 1:
            for s in range(S):
                for t in range(T):
                    g = make([self.rank_of(d, s, t) for d in range(D)])
                    if (s, t) == (me, self.tp_rank):
                        self.dp_group = g
        if S > 1:
            for d in range(D):
                for t in range(T):
                    g = make([self.rank_of(d, s, t) for s in range(S)])
                    if (d, t) == (self.replica, self.tp_rank):
                        if self.pp > 1:
                            self.pp_group = g
                        else:
                            self.sp_group = g
            if self.sp > 1 and D > 1:
                for t in range(T):
                    g = make([self.part_rank(p, t) for p in range(D * S)])
                    if t == self.tp_rank:
                        self.pool_group = g
            # one pair group per pair of adjacent slots (s, s + 1 mod S);
            # at 2 slots the two directions share the one pair
            pairs = [(s, (s + 1) % S) for s in range(S if S > 2 else 1)]
            for d in range(D):
                for t in range(T):
                    for a, b in pairs:
                        g = make(sorted([self.rank_of(d, a, t),
                                         self.rank_of(d, b, t)]))
                        if (d, t) != (self.replica, self.tp_rank):
                            continue
                        if a == me or (S == 2 and b == me):
                            self.next_group = g
                        if b == me or (S == 2 and a == me):
                            self.prev_group = g
        if self.sp == 1:
            self.pool_group = self.dp_group
        elif D == 1:
            self.pool_group = self.sp_group

    def rebuild(self) -> None:
        """Fresh device groups on every rank (collective over the plan
        group): after a collective timed out, the old groups' sequence
        numbers differ between ranks."""
        old = {id(g): g for g in (self.dev_group, self.dp_group, self.pp_group,
                                  self.sp_group, self.pool_group,
                                  self.prev_group, self.next_group)
               if g is not None}
        self._new_device_groups()
        for g in old.values():
            dist.destroy_process_group(g)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            dist.destroy_process_group()


def make_mesh(pcfg: ParallelConfig, devices=None, *, rank: int = 0,
              init_method: Optional[str] = None,
              backend: Optional[str] = None) -> TpGroup:
    """Join this process to the dp x pp x sp x tp group of `pcfg` as
    `rank` (the JAX `make_mesh`).  Every rank calls it with the
    same devices and `init_method` (``tcp://127.0.0.1:<port>``); the
    engine's leader spawns the other ranks (`engine/lockstep.py`)."""
    devs = group_devices(pcfg, devices)
    return TpGroup(rank, pcfg.world, devs[rank], choose_backend(devs, backend),
                   init_method or f"tcp://127.0.0.1:{free_port()}", dp=pcfg.dp,
                   pp=pcfg.pp, sp=pcfg.sp)
