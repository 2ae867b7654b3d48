"""Wire protocol: length-prefixed msgpack frames over asyncio streams.

The port's copy of the JAX package's `runtime/transport/wire.py`, with its
own msgpack codec (the GPU machine has no `msgpack`).  Every frame is a
(header, payload) pair: ``u32 header_len | u32 payload_len | header |
payload``, the header a msgpack map carrying routing/control metadata.

`pack` produces the bytes of ``msgpack.packb(obj, use_bin_type=True)`` for
the types the transport sends (None, bool, int, float, str, bytes, list or
tuple, dict) and `unpack` reads what that writes (``raw=False``), so a
port process and a JAX process share one control plane and one data
plane.
"""

from __future__ import annotations

import asyncio
import struct
from dataclasses import dataclass
from typing import Any, List, Tuple

_LEN = struct.Struct("!II")

# Frame kinds used by both the control plane and the service transport.
K_REQ = 1  # open a request stream (header: stream_id, endpoint, ...)
K_DATA = 2  # response/stream data
K_END = 3  # end of stream (sentinel)
K_ERR = 4  # error; payload = msgpack {message, code}
K_CANCEL = 5  # client -> server: stop generating (graceful)
K_KILL = 6  # client -> server: hard cancel
K_PING = 7
K_PONG = 8
K_CTRL = 9  # control-plane RPC


class WireError(Exception):
    pass


# -- msgpack codec ------------------------------------------------------------ #

_B, _H, _I, _Q = (struct.Struct(f">{c}") for c in "BHIQ")
_b, _h, _i, _q = (struct.Struct(f">{c}") for c in "bhiq")
_D, _F = struct.Struct(">d"), struct.Struct(">f")


def _pack_int(v: int, out: List[bytes]) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(_B.pack(v))
        elif v < 0x100:
            out.append(b"\xcc" + _B.pack(v))
        elif v < 0x10000:
            out.append(b"\xcd" + _H.pack(v))
        elif v < 0x100000000:
            out.append(b"\xce" + _I.pack(v))
        elif v < 1 << 64:
            out.append(b"\xcf" + _Q.pack(v))
        else:
            raise OverflowError("int too big to pack")
    elif v >= -32:
        out.append(_B.pack(v & 0xFF))
    elif v >= -0x80:
        out.append(b"\xd0" + _b.pack(v))
    elif v >= -0x8000:
        out.append(b"\xd1" + _h.pack(v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + _i.pack(v))
    elif v >= -(1 << 63):
        out.append(b"\xd3" + _q.pack(v))
    else:
        raise OverflowError("int too big to pack")


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
              out: List[bytes]) -> None:
    """A length header: fixed form below `fix_max`, else the 8/16/32-bit
    form among `codes` (None where the type has no such form)."""
    if n < fix_max:
        out.append(_B.pack(fix | n))
    elif codes[0] is not None and n < 0x100:
        out.append(_B.pack(codes[0]) + _B.pack(n))
    elif n < 0x10000:
        out.append(_B.pack(codes[1]) + _H.pack(n))
    elif n < 0x100000000:
        out.append(_B.pack(codes[2]) + _I.pack(n))
    else:
        raise ValueError("object too large to pack")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _D.pack(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        n = len(data)
        if n < 0x100:
            out.append(b"\xc4" + _B.pack(n))
        elif n < 0x10000:
            out.append(b"\xc5" + _H.pack(n))
        elif n < 0x100000000:
            out.append(b"\xc6" + _I.pack(n))
        else:
            raise ValueError("bytes too large to pack")
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def pack(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("unpack: truncated msgpack data")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def num(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map key")
        out[k] = _unpack(r)
    return out


def _unpack(r: _Reader) -> Any:
    c = r.num(_B)
    if c < 0x80:
        return c
    if c >= 0xE0:
        return c - 0x100
    if c < 0x90:
        return _map(r, c & 0x0F)
    if c < 0xA0:
        return [_unpack(r) for _ in range(c & 0x0F)]
    if c < 0xC0:
        return bytes(r.take(c & 0x1F)).decode("utf-8")
    if c == 0xC0:
        return None
    if c in (0xC2, 0xC3):
        return c == 0xC3
    if c in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(r.num((_B, _H, _I)[c - 0xC4])))
    if c == 0xCA:
        return r.num(_F)
    if c == 0xCB:
        return r.num(_D)
    if 0xCC <= c <= 0xCF:
        return r.num((_B, _H, _I, _Q)[c - 0xCC])
    if 0xD0 <= c <= 0xD3:
        return r.num((_b, _h, _i, _q)[c - 0xD0])
    if c in (0xD9, 0xDA, 0xDB):
        return bytes(r.take(r.num((_B, _H, _I)[c - 0xD9]))).decode("utf-8")
    if c in (0xDC, 0xDD):
        return [_unpack(r) for _ in range(r.num((_H, _I)[c - 0xDC]))]
    if c in (0xDE, 0xDF):
        return _map(r, r.num((_H, _I)[c - 0xDE]))
    raise ValueError(f"unpack: msgpack type 0x{c:02x} not ported (ext types)")


def unpack(data: bytes) -> Any:
    r = _Reader(memoryview(data) if not isinstance(data, memoryview) else data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("unpack: extra data after the msgpack object")
    return obj


# -- frames -------------------------------------------------------------------- #


@dataclass(slots=True)
class Frame:
    kind: int
    stream_id: int
    header: dict
    payload: bytes

    def encode(self) -> bytes:
        hdr = pack({"k": self.kind, "s": self.stream_id, **self.header})
        return _LEN.pack(len(hdr), len(self.payload)) + hdr + self.payload


async def read_frame(reader: asyncio.StreamReader) -> Frame:
    """Read one frame; raises IncompleteReadError at clean EOF."""
    raw = await reader.readexactly(_LEN.size)
    hlen, plen = _LEN.unpack(raw)
    if hlen > 1 << 24 or plen > 1 << 31:
        raise WireError(f"oversized frame header={hlen} payload={plen}")
    hdr_raw = await reader.readexactly(hlen)
    payload = await reader.readexactly(plen) if plen else b""
    hdr = unpack(hdr_raw)
    kind = hdr.pop("k")
    stream_id = hdr.pop("s", 0)
    return Frame(kind=kind, stream_id=stream_id, header=hdr, payload=payload)



def write_frame(writer: asyncio.StreamWriter, frame: Frame) -> None:
    writer.write(frame.encode())
