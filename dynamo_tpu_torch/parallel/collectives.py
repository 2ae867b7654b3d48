"""The dp x pp|sp x tp group's collectives, built from ``broadcast`` and
``all_reduce`` only: that is what gloo offers for CUDA tensors, and what
NCCL offers everywhere.  The JAX package gets the same collectives from
GSPMD (XLA inserts them; no Pallas kernel computes them).  A source
rank is always named by its GLOBAL rank (`torch.distributed`'s
convention for subgroups).

- `all_reduce_sum`: the row-parallel outputs (after ``wo`` and
  ``w_down``, and the experts' combine) summed over the ranks in place;
- `embed_lookup`: the vocab-parallel embedding: each rank looks up the
  tokens of its vocabulary rows, the others' rows are zero, and the sum
  over ranks is exact (one nonzero term per element);
- `gather_logits`: the full vocabulary from each rank's slice, as an
  all-reduce into a zeroed full-width buffer (exact, as above);
- `broadcast_bytes` / `gather_heads`: a tensor's bytes from one rank to
  every rank (any dtype, moved as uint8, so bit for bit), and the
  full-head KV pages from each rank's head slice, every rank
  broadcasting its slice in turn (the KV moves of `engine/lockstep.py`:
  a parked sequence, a tier block and a disagg export hold every head);
- `all_parts`: every rank's tensor of a group, each broadcast in turn,
  of sizes every rank knows: the dp replicas' packed results reaching
  the leader, and the new K/V rows of a replicated pool reaching every
  replica (`engine/engine.py`);
- `stage_handoff`: a stage's output to the next stage (an activation, or
  the last stage's sampled token ids to stage 0), as a broadcast inside
  the two ranks of the adjacent stages (`parallel.mesh.TpGroup`'s
  `next_group` / `prev_group`): gloo refuses ``send`` / ``recv`` of CUDA
  tensors but broadcasts them, and on the one card every group is gloo;
  a broadcast inside a pair is a send under NCCL too;
- `ring_shift`: the ring prefill's K/V block to the next sequence slot
  and the previous slot's block in (`parallel/ring_attention.py`), over
  the same pair groups and in the same order as `stage_handoff`;
- `gather_seq`: each sequence slot's tensor joined along the sequence
  axis over the sp group (the chunk's K/V for the pool write);
- `broadcast_plan`: the leader's plan bytes to every rank, length first
  and then the payload padded to a power of two (`dynamo_tpu/parallel/
  multihost.py` `broadcast_plan`).

A collective's result is the same on every rank (ring all-reduce and
NCCL hand each rank the same reduced values), so every rank samples the
same token from the same logits.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over the ranks of `group`, in place; returns `t`."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, rank: int,
                 group) -> torch.Tensor:
    """Rows of the full embedding for `tokens`, from this rank's slice
    ``embed`` [V/tp, h]: local rows where the token is ours, zeros
    elsewhere, summed over the ranks (in the table's dtype, exact)."""
    n = embed.shape[0]
    lo = rank * n
    local = tokens - lo
    mine = (local >= 0) & (local < n)
    x = embed[torch.where(mine, local, torch.zeros_like(local))]
    x = x * mine[..., None].to(x.dtype)
    return all_reduce_sum(x, group)


def gather_logits(local: torch.Tensor, rank: int, tp: int,
                  group) -> torch.Tensor:
    """The full-vocabulary logits [..., V] from this rank's slice
    [..., V/tp]: an all-reduce into a zeroed full-width buffer."""
    n = local.shape[-1]
    full = local.new_zeros((*local.shape[:-1], n * tp))
    full[..., rank * n:(rank + 1) * n] = local
    return all_reduce_sum(full, group)


def broadcast_bytes(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Broadcast the contiguous `t` from rank `src` in place, as its raw
    bytes (exact for every dtype: no arithmetic touches them); returns
    `t`."""
    dist.broadcast(t.view(-1).view(torch.uint8), src=src, group=group)
    return t


def all_parts(own: torch.Tensor, me: int, ranks, group,
              shapes=None) -> list:
    """Every member's tensor, in member order, on every member: member i
    (global rank ``ranks[i]``; this process is member `me`) broadcasts
    its tensor in turn.  `shapes[i]` is member i's shape when the
    members' sizes differ (every member knows them); by default each is
    `own`'s.  Empty parts are not sent."""
    parts = []
    for i, src in enumerate(ranks):
        shape = tuple(own.shape) if shapes is None else tuple(shapes[i])
        if i == me:
            buf = own.contiguous()
        else:
            buf = own.new_empty(shape)
        if buf.numel():
            broadcast_bytes(buf, src, group)
        parts.append(buf)
    return parts


def gather_heads(local: torch.Tensor, rank: int, ranks, group,
                 axis: int = 3) -> torch.Tensor:
    """Every member's `local` slice (the same shape on every member)
    joined along `axis` in member order, on every member (`rank`: this
    process's index in `ranks`, the group's global ranks)."""
    return torch.cat(all_parts(local, rank, ranks, group), dim=axis)


def _pair_exchange(group, slot: int, n: int, send=None, recv=None) -> None:
    """`send` to the next slot and `recv` from the previous one on this
    rank's middle axis (its `slot` of `n` stages or sequence slots, of
    its replica and tensor rank), each a broadcast inside the two ranks'
    pair group; even slots send first and then receive, odd slots the
    other way round (see `stage_handoff`).  Counted in
    ``group.handoffs``: sends, bytes sent, host ms of the broadcasts."""
    prev = group.rank_of(group.replica, (slot - 1) % n, group.tp_rank)
    ops = []
    if send is not None:
        ops.append((send.contiguous(), group.rank, group.next_group))
        group.handoffs["sends"] += 1
        group.handoffs["bytes"] += send.numel() * send.element_size()
    if recv is not None:
        ops.append((recv, prev, group.prev_group))
    if slot % 2:
        ops.reverse()
    t0 = time.perf_counter()
    for t, src, pg in ops:
        broadcast_bytes(t, src, pg)
    group.handoffs["ms"] += (time.perf_counter() - t0) * 1e3


def stage_handoff(group, send=None, recv=None) -> None:
    """One tick's handoffs of this rank's stage (`group`: its `TpGroup`):
    `send` (a tensor or None) goes to the next stage (stage 0 after the
    last); `recv` (a buffer of the size the previous stage sends, or
    None) is filled from the previous stage.  Each is a broadcast inside
    the two ranks of the adjacent stages, of the same tensor rank and
    replica.

    Every stage may both send and receive in a tick (the decode ring), so
    blocking pair operations could wait on each other all around the
    ring: even stages send first and then receive, odd stages receive
    first and then send.  Every send of an even stage meets an odd stage
    that receives first, and each of the second operations then meets a
    stage whose first has returned (at an odd pp the last stage, even,
    sends to stage 0, which has sent to stage 1 first), so no cycle of
    waits can form.  At pp 2 the two directions share one pair group,
    whose broadcasts both ranks issue in the same order (stage 0's,
    then stage 1's)."""
    _pair_exchange(group, group.stage, group.pp, send, recv)


def ring_shift(group, send: torch.Tensor, recv: torch.Tensor) -> None:
    """One rotation of the ring prefill (`group`: this rank's `TpGroup`
    under sp): `send` goes to the next sequence slot (slot 0 after the
    last), `recv` is filled with the previous slot's block.  The pair
    groups and the even/odd order of `stage_handoff`, so no odd or even
    ring size can deadlock; a broadcast inside a pair is what gloo takes
    for CUDA tensors (the ranks sharing one card), and a send under
    NCCL."""
    _pair_exchange(group, group.sp_rank, group.sp, send, recv)


def gather_seq(local: torch.Tensor, group) -> torch.Tensor:
    """Every sequence slot's `local` [B, S/sp, ...] (the same shape on
    each) joined along the sequence in slot order, on every slot of this
    rank's sp group (counted in ``group.gathers``: calls, bytes received,
    host ms)."""
    t0 = time.perf_counter()
    out = torch.cat(all_parts(local, group.sp_rank, group.sp_ranks(),
                              group.sp_group), dim=1)
    g = group.gathers
    g["calls"] += 1
    g["bytes"] += (group.sp - 1) * local.numel() * local.element_size()
    g["ms"] += (time.perf_counter() - t0) * 1e3
    return out


def broadcast_plan(payload: bytes, group=None, src: int = 0) -> bytes:
    """Broadcast `src`'s bytes to every rank of `group` (the default group
    when None), over CPU tensors: first the length (a fixed 8-byte round
    every rank can join without knowing the size), then the payload,
    padded to a power of two (at least 64 bytes) so plans of any size fit
    in few buffer sizes.  Other ranks pass ``b""``."""
    is_src = dist.get_rank() == src
    n = torch.tensor([len(payload) if is_src else 0], dtype=torch.int64)
    dist.broadcast(n, src=src, group=group)
    size = int(n.item())
    if size == 0:
        return b""
    width = 1 << max(6, (size - 1).bit_length())
    buf = torch.zeros(width, dtype=torch.uint8)
    if is_src:
        buf[:size] = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    dist.broadcast(buf, src=src, group=group)
    return buf[:size].numpy().tobytes()
