"""Control-plane server CLI: `python -m dynamo_tpu_torch.runtime [--port N]`.

The single infrastructure process of a multi-process deployment
(discovery/leases, pub/sub, durable streams and the object store),
wire-compatible with the JAX package's `python -m dynamo_tpu.runtime`.
Prints ``READY host:port``.
"""

import argparse
import asyncio
import logging
import signal


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dynamo_tpu_torch control plane")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=6380)
    ap.add_argument("--log-level", default="info")
    args = ap.parse_args(argv)
    logging.basicConfig(level=args.log_level.upper(),
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    asyncio.run(_run(args))


async def _run(args) -> None:
    from .transport.control_plane import ControlPlaneServer

    server = await ControlPlaneServer(host=args.host, port=args.port).start()
    print(f"READY {server.address}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await server.stop()


if __name__ == "__main__":
    main()
