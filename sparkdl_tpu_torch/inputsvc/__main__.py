"""``python -m sparkdl_tpu_torch.inputsvc serve --port N``: one
:class:`~sparkdl_tpu_torch.inputsvc.server.DecodeServer` in the
foreground, which prints one READY line naming the bound host:port
(``--port 0``, the default, binds an ephemeral port, so a launcher
learns the port from that line). ``SPARKDL_TPU_FAULTS`` arms fault
drills here as everywhere.
"""

from __future__ import annotations

import argparse
import logging
import sys

#: the READY line's prefix; the bound ``host:port`` follows it
READY = "SPARKDL_TPU_TORCH_INPUTSVC READY"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.inputsvc",
        description="sparkdl_tpu_torch decode-fleet worker")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser(
        "serve", help="run one decode worker in the foreground")
    serve.add_argument("--host", default="127.0.0.1",
                       help="bind address (default 127.0.0.1)")
    serve.add_argument("--port", type=int, default=0,
                       help="bind port (default 0 = ephemeral; the "
                            "READY line names the bound port)")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    from sparkdl_tpu_torch.inputsvc.server import DecodeServer
    server = DecodeServer(host=args.host, port=args.port)
    # one parseable line, flushed before serving
    print(f"{READY} {server.host}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
