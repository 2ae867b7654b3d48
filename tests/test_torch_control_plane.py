"""The port's control plane (dynamo_tpu_torch.runtime.transport.
control_plane) against the JAX package's: pub/sub with NATS subjects and
queue groups, durable streams with bounded retention, and the object
store.

One scripted sequence of ops runs on every pairing of server and client
(JAX server + JAX client is the reference): each raw reply, each
delivered message and each stream entry must equal the reference's, so
the port's server answers as the JAX server does and either package's
client talks to either package's server.
"""

import asyncio

import pytest

from dynamo_tpu.runtime.transport import control_plane as jax_cp
from dynamo_tpu_torch.runtime.transport import control_plane as torch_cp

PKGS = {"jax": jax_cp, "torch": torch_cp}
RETENTION = 3


async def _next(sub_iter, n):
    return [await asyncio.wait_for(sub_iter.__anext__(), 5) for _ in range(n)]


async def scripted_ops(client) -> list:
    """Every reply of the script, in order (the raw reply dicts of the
    request/response ops, the (subject, payload) pairs each subscription
    receives)."""
    out = []
    call = client._call

    # -- pub/sub: wildcards, '>' needs a token, round-robin queue groups -- #
    star = await client.subscribe("metrics.*.a")
    rest = await client.subscribe("metrics.>")
    g1 = await client.subscribe("work.q", group="g")
    g2 = await client.subscribe("work.q", group="g")
    exact = await client.subscribe("x.y")
    await asyncio.sleep(0.05)  # subscribe sends no reply
    for subject, data in (("metrics.v2.a", b"1"), ("metrics", b"2"),
                          ("metrics.v2.a.b", b"3"), ("metrics.v2.b", b"4"),
                          ("x.y", b"5"), ("x.y.z", b"6"),
                          ("work.q", b"w0"), ("work.q", b"w1"),
                          ("work.q", b"w2"), ("work.q", b"w3")):
        out.append(("publish", subject,
                    await call("publish", {"subject": subject, "data": data})))
    its = {n: s.__aiter__() for n, s in (("star", star), ("rest", rest),
                                         ("g1", g1), ("g2", g2),
                                         ("exact", exact))}
    for name, n in (("star", 1), ("rest", 3), ("g1", 2), ("g2", 2),
                    ("exact", 1)):
        out.append((name, await _next(its[name], n)))
    await star.cancel()
    out.append(("after unsubscribe",
                await call("publish", {"subject": "metrics.v2.a",
                                       "data": b"7"})))
    out.append(("rest", await _next(its["rest"], 1)))
    # the convenience method reads the same reply
    out.append(("publish()", await client.publish("nobody.listens", b"")))

    # -- durable streams: seqs, retention, blocking fetch, limit ----------- #
    for i in range(5):
        out.append(await call("stream_append", {"stream": "ev",
                                                "data": bytes([i]),
                                                "subject": f"s{i}"}))
    out.append(await call("stream_fetch", {"stream": "ev", "after": 0}))
    out.append(await call("stream_fetch", {"stream": "ev", "after": 3,
                                           "limit": 1}))
    out.append(await call("stream_len", {"stream": "ev"}))
    out.append(await call("stream_fetch", {"stream": "ev", "after": 5,
                                           "timeout_ms": 50}))
    out.append(await call("stream_fetch", {"stream": "none", "after": 0}))
    out.append(await call("stream_len", {"stream": "none"}))

    async def append_later():
        await asyncio.sleep(0.1)
        return await client.stream_append("ev", b"late")

    waiter = asyncio.ensure_future(client.stream_fetch("ev", after=5,
                                                       timeout_ms=5000))
    seq = await append_later()
    out.append(("blocking fetch", await asyncio.wait_for(waiter, 5), seq))
    out.append(("stream_fetch()", await client.stream_fetch("ev", after=0)))

    # -- object store --------------------------------------------------------- #
    out.append(await call("obj_put", {"bucket": "b", "name": "n2",
                                      "data": b"two"}))
    out.append(await call("obj_put", {"bucket": "b", "name": "n1",
                                      "data": b"\x00" * 300}))
    out.append(await call("obj_get", {"bucket": "b", "name": "n1"}))
    out.append(await call("obj_get", {"bucket": "b", "name": "missing"}))
    out.append(await call("obj_list", {"bucket": "b"}))
    out.append(await call("obj_list", {"bucket": "empty"}))
    out.append(("obj methods", await client.obj_get("b", "n2"),
                await client.obj_get("b", "nope"), await client.obj_list("b")))

    # -- an op neither server has --------------------------------------------- #
    with pytest.raises(RuntimeError) as e:
        await call("no_such_op", {})
    out.append(("error", str(e.value)))
    for s in (rest, g1, g2, exact):
        await s.cancel()
    return out


async def run_script(server_pkg: str, client_pkg: str) -> list:
    server = await PKGS[server_pkg].ControlPlaneServer(
        stream_retention=RETENTION).start()
    client = await PKGS[client_pkg].ControlPlaneClient(server.address).connect()
    try:
        return await scripted_ops(client)
    finally:
        await client.close()
        await server.stop()


@pytest.fixture(scope="module")
def reference():
    return asyncio.run(run_script("jax", "jax"))


@pytest.mark.parametrize("server,client", [("torch", "torch"),
                                           ("jax", "torch"),
                                           ("torch", "jax")])
def test_scripted_ops_equal_the_jax_server(reference, server, client):
    got = asyncio.run(run_script(server, client))
    assert got == reference


def test_reference_script_reads_as_specified(reference):
    """What the reference replies are: the script checks semantics, not
    only equality."""
    replies = dict((r[1], r[2]) for r in reference[:10])
    assert replies["metrics.v2.a"] == {"delivered": 2}
    assert replies["metrics"] == {"delivered": 0}  # '>' needs a token
    assert replies["metrics.v2.a.b"] == {"delivered": 1}
    assert replies["x.y.z"] == {"delivered": 0}
    groups = {name: msgs for name, msgs in reference[10:15]}
    assert [m[1] for m in groups["g1"]] == [b"w0", b"w2"]
    assert [m[1] for m in groups["g2"]] == [b"w1", b"w3"]
    fetch_all = reference[23]
    assert [e["seq"] for e in fetch_all["entries"]] == [3, 4, 5]
    assert fetch_all["first_available"] == 3 and fetch_all["last_seq"] == 5
    assert reference[25] == {"last_seq": 5, "len": RETENTION}
    blocking = next(r for r in reference
                    if isinstance(r, tuple) and r[0] == "blocking fetch")
    entries, last, first = blocking[1]
    assert [e["data"] for e in entries] == [b"late"] and last == blocking[2] == 6
    assert first == 4
    assert reference[-1] == ("error", "unknown op 'no_such_op'")


@pytest.mark.parametrize("pattern,subject", [
    ("a.b", "a.b"), ("a.*", "a.b"), ("a.*", "a.b.c"), ("a.>", "a"),
    ("a.>", "a.b.c"), ("*.b", "a.b"), ("*", "a.b"), (">", "a"),
    ("a.*.c", "a.b.c"), ("a.*.c", "a.b.d"), ("a", "a.b"),
])
def test_subject_matches_as_jax(pattern, subject):
    assert (torch_cp._subject_matches(pattern, subject)
            == jax_cp._subject_matches(pattern, subject))


async def test_subscription_ends_when_the_server_goes():
    """A live SubStream ends (as watches do) when its connection drops,
    so the KV router's metrics loop re-subscribes."""
    server = await torch_cp.ControlPlaneServer().start()
    client = await torch_cp.ControlPlaneClient(server.address).connect()
    sub = await client.subscribe("m.>")
    await asyncio.sleep(0.05)
    assert await client.publish("m.x", b"1") == 1
    got = []

    async def read():
        async for item in sub:
            got.append(item)

    reader = asyncio.ensure_future(read())
    await asyncio.sleep(0.05)
    await server.stop()
    await asyncio.wait_for(reader, 5)
    assert got == [("m.x", b"1")]
    await client.close()


@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
async def test_port_client_stream_len(server_pkg):
    """The port client's `stream_len` (the JAX client has none) reads
    (last seq, retained entries) from either server."""
    server = await PKGS[server_pkg].ControlPlaneServer(
        stream_retention=RETENTION).start()
    client = await torch_cp.ControlPlaneClient(server.address).connect()
    try:
        assert await client.stream_len("s") == (0, 0)
        for i in range(RETENTION + 2):
            await client.stream_append("s", b"x")
        assert await client.stream_len("s") == (RETENTION + 2, RETENTION)
    finally:
        await client.close()
        await server.stop()


async def scripted_queue_ops(client) -> list:
    """The work queues: FIFO order, depth, an empty pop with and without a
    wait, and a blocked pop woken by a later push."""
    out = []
    call = client._call
    for i in range(3):
        out.append(await call("queue_push", {"queue": "q", "data": bytes([i])}))
    out.append(await call("queue_depth", {"queue": "q"}))
    out.append(await call("queue_pop", {"queue": "q"}))
    out.append(await call("queue_pop", {"queue": "q", "timeout_ms": 50}))
    out.append(await call("queue_depth", {"queue": "other"}))
    out.append(await call("queue_pop", {"queue": "other"}))
    out.append(await call("queue_pop", {"queue": "other", "timeout_ms": 50}))
    waiter = asyncio.ensure_future(client.queue_pop("late", timeout_ms=5000))
    await asyncio.sleep(0.1)
    out.append(("push to a waiter", await client.queue_push("late", b"w")))
    out.append(("blocked pop", await asyncio.wait_for(waiter, 5)))
    out.append(("methods", await client.queue_pop("q"),
                await client.queue_pop("q"), await client.queue_depth("q")))
    return out


async def run_queue_script(server_pkg: str, client_pkg: str) -> list:
    server = await PKGS[server_pkg].ControlPlaneServer().start()
    client = await PKGS[client_pkg].ControlPlaneClient(server.address).connect()
    try:
        return await scripted_queue_ops(client)
    finally:
        await client.close()
        await server.stop()


@pytest.mark.parametrize("server,client", [("torch", "torch"),
                                           ("jax", "torch"),
                                           ("torch", "jax")])
def test_queue_ops_equal_the_jax_server(server, client):
    reference = asyncio.run(run_queue_script("jax", "jax"))
    assert asyncio.run(run_queue_script(server, client)) == reference
    # and the reference reads as a FIFO with a blocking pop
    assert [r["depth"] for r in reference[:3]] == [1, 2, 3]
    assert reference[3] == {"depth": 3}
    assert reference[4] == {"found": True, "data": b"\x00"}
    assert reference[5] == {"found": True, "data": b"\x01"}
    assert reference[6] == {"depth": 0}
    assert reference[7] == reference[8] == {"found": False, "data": b""}
    assert reference[9] == ("push to a waiter", 0)
    assert reference[10] == ("blocked pop", b"w")
    assert reference[11] == ("methods", b"\x02", None, 0)
