"""`ParallelConfig` and the dp x tp group of the port.

The JAX package lays its local devices out as a ``(dp, tp)`` mesh in one
process and lets GSPMD insert the collectives (`dynamo_tpu/parallel/
mesh.py`).  PyTorch's idiom is one process per rank and explicit
collectives, so here `make_mesh` joins THIS process to a group of
``dp * tp`` processes over `torch.distributed`.  Rank ``r = d * tp + t``
is tensor rank ``t`` of data-parallel replica ``d`` (tp innermost, as
JAX's ``np.array(devices).reshape(dp, tp)``):

- the default process group is ``gloo`` on the CPU and spans every rank;
  it carries the leader's plans (`engine/lockstep.py`) and the
  followers' answers;
- one tp device group per replica carries that replica's model
  collectives (`collectives.py`), and one dp device group per tensor
  rank carries the replicas' result and KV gathers (the ranks that hold
  the same heads): ``nccl`` when every rank has a card of its own,
  ``gloo`` on the CPU and when ranks share a card (gloo takes CUDA
  tensors for ``broadcast`` and ``all_reduce``, which is all the port
  needs).  Two ranks on one device under ``nccl`` are refused, and so
  are fewer distinct cards than ranks when the caller did not name the
  devices: nothing puts the group onto the CPU or onto one card unless
  the caller asks for it.

``sp`` and ``pp`` above 1 are refused with the roadmap item that ports
them.
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

# the later slices that bring the other axes (ROADMAP.md queue 1)
_LATER = {"sp": "ROADMAP 2.4 (sp prefill)", "pp": "ROADMAP 2.3 (pipeline stages)"}

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
            raise ValueError(
                "pp composes with dp and tp (sp ring prefill within a "
                "pp stage is not supported — set sp = 1)")


def check_ported(pcfg: ParallelConfig) -> None:
    """Refuse the degrees the port does not serve (dp x tp is served)."""
    for axis in ("dp", "tp", "sp", "pp"):
        n = getattr(pcfg, axis)
        if n < 1:
            raise ValueError(f"{axis} must be >= 1, got {n}")
    for axis in ("sp", "pp"):
        n = getattr(pcfg, axis)
        if n > 1:
            raise ValueError(f"{axis}={n} is not ported to dynamo_tpu_torch "
                             f"yet: {_LATER[axis]}; the port serves dp x tp")


def tp_timeout_s() -> float:
    """The model collectives' timeout: ``DYN_TORCH_TP_TIMEOUT_S`` (a
    deployment setting, like the group's address), else 120 s."""
    return float(os.environ.get("DYN_TORCH_TP_TIMEOUT_S", DEFAULT_TIMEOUT_S))


def group_devices(pcfg: ParallelConfig,
                  devices: Optional[Sequence[Union[str, torch.device]]] = None
                  ) -> List[torch.device]:
    """The device of each of the ``dp * tp`` ranks, in rank order.
    Without `devices`: one distinct card per rank (``cuda:0`` ..
    ``cuda:dp*tp-1``), refused when the machine has fewer; a caller who
    wants the CPU or one shared card names them."""
    check_ported(pcfg)
    world = pcfg.world
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"a dp x tp group runs on CUDA cards and none is available; "
                f"pass devices=['cpu'] * {world} to run the group on the CPU")
        n = torch.cuda.device_count()
        if n < world:
            raise RuntimeError(
                f"dp*tp={world} needs {world} distinct cards, this machine "
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
    """This process's rank in a dp x tp group: its global rank and the
    group's size, its replica ``d`` and tensor rank ``t``, its device,
    the device backend, and the process groups (the default gloo group
    for plans; its replica's tp device group for the model's
    collectives, `dev_group`; its tensor rank's dp device group for the
    replicas' gathers, `dp_group`, None when dp is 1).  One per process:
    `torch.distributed` keeps the default group per process, so a second
    live group in one process is refused."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str, init_method: str, dp: int = 1):
        if dist.is_initialized():
            raise RuntimeError(
                "this process already belongs to a torch.distributed group; "
                "shut the other group's engine down first")
        if world % dp:
            raise ValueError(f"dp={dp} does not divide the world {world}")
        self.rank = rank
        self.world = world
        self.dp = dp
        self.tp = world // dp
        self.replica, self.tp_rank = divmod(rank, self.tp)
        self.device = device
        self.backend = backend
        self.timeout_s = tp_timeout_s()
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            "gloo", init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=PLAN_TIMEOUT_S))
        self._new_device_groups()
        self.closed = False

    def tp_ranks(self, replica: Optional[int] = None) -> List[int]:
        """The global ranks of a replica's tp group (this rank's)."""
        d = self.replica if replica is None else replica
        return [d * self.tp + t for t in range(self.tp)]

    def dp_ranks(self) -> List[int]:
        """The global ranks of this tensor rank's dp group (one a
        replica, in replica order)."""
        return [d * self.tp + self.tp_rank for d in range(self.dp)]

    def _new_device_groups(self) -> None:
        """Every rank creates every device group, in the same order: the
        tp groups of the replicas, then the dp groups of the tensor ranks
        (`new_group` is collective over the default group).  A one-rank
        axis has no group."""
        timeout = datetime.timedelta(seconds=self.timeout_s)
        self.dev_group = self.dp_group = None
        if self.tp > 1:
            for d in range(self.dp):
                g = dist.new_group(ranks=self.tp_ranks(d), backend=self.backend,
                                   timeout=timeout)
                if d == self.replica:
                    self.dev_group = g
        if self.dp > 1:
            for t in range(self.tp):
                g = dist.new_group(ranks=[d * self.tp + t
                                          for d in range(self.dp)],
                                   backend=self.backend, timeout=timeout)
                if t == self.tp_rank:
                    self.dp_group = g

    def rebuild(self) -> None:
        """Fresh device groups on every rank (collective over the plan
        group): after a collective timed out, the old groups' sequence
        numbers differ between ranks."""
        old = [g for g in (self.dev_group, self.dp_group) if g is not None]
        self._new_device_groups()
        for g in old:
            dist.destroy_process_group(g)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            dist.destroy_process_group()


def make_mesh(pcfg: ParallelConfig, devices=None, *, rank: int = 0,
              init_method: Optional[str] = None,
              backend: Optional[str] = None) -> TpGroup:
    """Join this process to the dp x tp group of `pcfg` as `rank` (the JAX
    `make_mesh` for the dp and tp axes).  Every rank calls it with the
    same devices and `init_method` (``tcp://127.0.0.1:<port>``); the
    engine's leader spawns the other ranks (`engine/lockstep.py`)."""
    devs = group_devices(pcfg, devices)
    return TpGroup(rank, pcfg.world, devs[rank], choose_backend(devs, backend),
                   init_method or f"tcp://127.0.0.1:{free_port()}", dp=pcfg.dp)
