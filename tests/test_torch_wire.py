"""The port's msgpack codec (`dynamo_tpu_torch.runtime.transport.wire`)
against `msgpack`: the same bytes as ``msgpack.packb(obj,
use_bin_type=True)`` for hypothesis-drawn nested values, the boundary
values of every length and integer form, and real frames; each side reads
what the other writes."""

import asyncio

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.runtime.transport import wire as jax_wire
from dynamo_tpu_torch.runtime.transport import wire

_SCALARS = (st.none() | st.booleans() | st.integers(-(1 << 63), (1 << 64) - 1)
            | st.floats(allow_nan=False) | st.text() | st.binary())
_VALUES = st.recursive(
    _SCALARS,
    lambda kids: st.lists(kids, max_size=20)
    | st.dictionaries(st.text() | st.binary(), kids, max_size=20),
    max_leaves=40,
)

BOUNDARIES = [
    0, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32, (1 << 64) - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -(1 << 31), -(1 << 31) - 1,
    -(1 << 63), 0.0, -0.0, 1.5, float("inf"), -float("inf"),
    "", "x" * 31, "x" * 32, "x" * 255, "x" * 256, "é" * 40000, "x" * 65536,
    b"", b"y" * 255, b"y" * 256, b"y" * 65535, b"y" * 65536,
    list(range(15)), list(range(16)), list(range(65536)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): None for i in range(65536)},
]


def _same(v):
    want = msgpack.packb(v, use_bin_type=True)
    assert wire.pack(v) == want
    assert wire.unpack(want) == msgpack.unpackb(want, raw=False)
    assert msgpack.unpackb(wire.pack(v), raw=False) == v


@pytest.mark.parametrize("i", range(len(BOUNDARIES)))
def test_boundary_values(i):
    _same(BOUNDARIES[i])


@settings(max_examples=150, deadline=None, derandomize=True)
@given(_VALUES)
def test_hypothesis_values(v):
    _same(v)


def test_tuples_and_bytearrays_pack_like_msgpack():
    for v in ((1, (2, b"x")), bytearray(b"abc"), memoryview(b"de")):
        assert wire.pack(v) == msgpack.packb(v, use_bin_type=True)


def test_errors_match_msgpack_kinds():
    for bad in (object(), 1 << 64, -(1 << 63) - 1):
        with pytest.raises((TypeError, OverflowError)) as mine:
            wire.pack(bad)
        with pytest.raises(type(mine.value)):
            msgpack.packb(bad, use_bin_type=True)
    with pytest.raises(ValueError):
        wire.unpack(msgpack.packb(1) + b"\x00")  # msgpack: ExtraData
    with pytest.raises(ValueError):
        wire.unpack(b"\x92\x01")  # truncated
    with pytest.raises(ValueError):
        wire.unpack(msgpack.packb({1: 2}))  # msgpack: strict_map_key


FRAMES = [
    (wire.K_REQ, 7, {"endpoint": "dynamo.backend.generate", "rid": "ab" * 16},
     {"token_ids": list(range(300)), "sampling_options": {"temperature": 0.8,
      "seed": 7, "top_p": None}, "stop_conditions": {"max_tokens": 32}}),
    (wire.K_DATA, 7, {}, {"token_ids": [5], "finish_reason": None,
                          "log_probs": [-0.25], "ttft": {"prefill_ms": 1.5}}),
    (wire.K_CTRL, 1 << 20, {"op": "put"},
     {"key": "/models/dynamo/tiny/1000", "value": b"\x81\xa1a\x01", "lease": 1000}),
    (wire.K_ERR, 3, {"code": "handler"}, {"message": "boom"}),
    (wire.K_END, 3, {}, None),
]


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_frames_equal_and_cross_read(i):
    kind, sid, hdr, body = FRAMES[i]
    payload = b"" if body is None else msgpack.packb(body, use_bin_type=True)
    mine = wire.Frame(kind, sid, dict(hdr), payload).encode()
    assert mine == jax_wire.Frame(kind, sid, dict(hdr), payload).encode()

    async def read(module, data):
        r = asyncio.StreamReader()
        r.feed_data(data)
        r.feed_eof()
        return await module.read_frame(r)

    for reader in (wire, jax_wire):
        f = asyncio.run(read(reader, mine))
        assert (f.kind, f.stream_id, f.header, f.payload) == (kind, sid, hdr, payload)
