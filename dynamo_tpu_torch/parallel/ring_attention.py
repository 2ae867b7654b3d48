"""Ring attention of the sequence-parallel prefill: each sequence slot keeps
its queries while the K/V blocks travel around the sp ring, a flash
accumulator carried across the rounds (the port of JAX
`dynamo_tpu/parallel/ring_attention.py`, `ring_attention_local`).

- the cached prefix (``prefix``: the pool, the rows' page tables and
  prefix lengths) is folded first, read from the pages in place
  (`ops.ring_attention.ring_prefix`); its keys sit at positions
  0 .. prefix_len - 1;
- then N rounds: in round r slot i holds the block of source
  ``(i - r) mod N``, whose keys sit at ``q_offset + src * Sk + j``
  (`ring_rounds`), folded by `ops.ring_attention.ring_block`; between
  rounds the blocks move one slot on (`Ring.shift`);
- last, the sink joins the denominator, clamped at 1e-20, and the output
  is cast to q's dtype (`ops.ring_attention.ring_finish`).

Padding keys (a chunk padded to a multiple of sp) sit past every valid
query's position, so the causal mask alone keeps them out, as in JAX.
The same code runs on the CPU (the ops' plain versions) and on the card
(the kernels); JAX rotates once more after the last round, which changes
nothing it returns, and the port does not.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops.ring_attention import ring_block, ring_finish, ring_prefix, ring_state


def ring_rounds(slot: int, n: int) -> List[int]:
    """The source slot of the block slot `slot` of `n` holds in each round
    (JAX's ``(my - r) % n``)."""
    return [(slot - r) % n for r in range(n)]


class Ring:
    """A rank's place in the sp ring: its slot, the ring's size, and the
    rotation.  Without a group (or at sp 1) the ring is one slot."""

    def __init__(self, group=None):
        self.group = group
        self.slot = 0 if group is None else group.sp_rank
        self.size = 1 if group is None else group.sp

    def shift(self, blk: torch.Tensor) -> torch.Tensor:
        """This slot's block out to the next slot, the previous slot's in
        (`collectives.ring_shift`)."""
        from .collectives import ring_shift

        nxt = torch.empty_like(blk)
        ring_shift(self.group, blk, nxt)
        return nxt


class SimRing(Ring):
    """A ring of `blocks` (every slot's block, in slot order) seen from
    slot `slot`, moved without collectives: what `Ring.shift` delivers in
    each round, for checks of the ring on one process."""

    def __init__(self, blocks: Sequence[torch.Tensor], slot: int):
        self.group = None
        self.blocks = list(blocks)
        self.slot = slot
        self.size = len(self.blocks)
        self._round = 0

    def shift(self, blk: torch.Tensor) -> torch.Tensor:
        self._round += 1
        return self.blocks[(self.slot - self._round) % self.size]


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         ring: Optional[Ring] = None, causal: bool = True,
                         q_offset: Optional[torch.Tensor] = None,
                         window: Optional[int] = None,
                         sink: Optional[torch.Tensor] = None,
                         prefix=None) -> torch.Tensor:
    """This slot's attention output [B, Sq, H, hd] in q's dtype: q [B, Sq,
    H, hd] at positions ``q_offset + slot * Sq + s`` (``q_offset`` [B]
    int32, the rows' cached-prefix lengths; zeros when None), this slot's
    k, v [B, Sk, n_kv, hd]; ``prefix`` is (k_pages, v_pages, table [B, W]
    int32, prefix_lens [B] int32) of the cached prefix, or None."""
    ring = ring or Ring()
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    dev = q.device
    off = (torch.zeros((B,), dtype=torch.int32, device=dev) if q_offset is None
           else q_offset.to(torch.int32))
    q_base = off + ring.slot * Sq
    m, l, o = ring_state(B, Sq, H, hd, dev)
    if prefix is not None:
        k_pages, v_pages, table, prefix_lens = prefix
        ring_prefix(q, k_pages, v_pages, table, prefix_lens, m, l, o, q_base,
                    window)
    blk = torch.stack([k, v])  # one rotation moves K and V together
    for r, src in enumerate(ring_rounds(ring.slot, ring.size)):
        if r:
            blk = ring.shift(blk)
        ring_block(q, blk[0], blk[1], m, l, o, q_base, off + src * Sk, causal,
                   window)
    return ring_finish(m, l, o, sink, q.dtype)
