"""Headless IQ server: serve any registered source over rtl_tcp.

The SdrGarage equivalent (SdrGarage/sdrserver.{h,cpp}: headless
QCoreApplication that loads a device plugin and speaks rtl_tcp).

  python -m pebblesdr_tpu.serve.server --source synthetic --port 1234
  python -m pebblesdr_tpu.serve.server --source file --path capture.wav
  # then from any rtl_tcp client (including our own chain):
  #   RtlTcpSource("host", 1234) -> Receiver
"""

from __future__ import annotations

import argparse
import sys

from pebblesdr_tpu.io import registry
from pebblesdr_tpu.io.rtl_tcp import RtlTcpServer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", default="synthetic",
                   help=f"one of: {', '.join(registry.available())}")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=1234)
    p.add_argument("--sample-rate", type=int, default=2_048_000)
    p.add_argument("--path", help="wav path for --source file")
    p.add_argument("--block", type=int, default=16384)
    args = p.parse_args(argv)

    from pebblesdr_tpu.utils import compile_cache

    compile_cache.enable()
    kwargs = {}
    if args.source == "file":
        if not args.path:
            p.error("--source file requires --path")
        kwargs = {"path": args.path, "pace": True}
    elif args.source in ("synthetic", "morsegen"):
        kwargs = {"sample_rate": args.sample_rate}
    src = registry.create(args.source, **kwargs)

    server = RtlTcpServer(src, host=args.host, port=args.port, block=args.block)
    print(f"serving {args.source} ({src.info.sample_rate} sps) "
          f"on rtl_tcp://{args.host}:{server.port}", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
