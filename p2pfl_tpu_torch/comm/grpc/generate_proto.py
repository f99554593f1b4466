"""Regenerate ``node_pb2.py`` from ``node.proto`` (the port's copy of
``p2pfl_tpu/comm/grpc/generate_proto.py``).

The transport registers its RPC methods itself (grpc_protocol.py builds
``grpc.unary_unary`` handlers through grpc's generic handler), so plain
``protoc --python_out`` is the whole job: no ``_grpc`` stub module exists
and grpcio-tools is not needed. The schema and the generated descriptor are
the JAX package's, byte for byte: both packages register ``node.proto``
(package ``p2pfl_tpu``) in protobuf's default pool, which accepts an
identical second registration and refuses a different one.

Usage::

    python -m p2pfl_tpu_torch.comm.grpc.generate_proto [--check]

``--check`` regenerates into a temp dir and exits nonzero if the committed
``node_pb2.py`` is stale; it skips (exit 0) where ``protoc`` is absent.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent


def generate(out_dir: Path) -> Path:
    protoc = shutil.which("protoc")
    if protoc is None:
        raise RuntimeError("protoc not found on PATH")
    subprocess.run(
        [protoc, f"--proto_path={HERE}", f"--python_out={out_dir}", "node.proto"],
        check=True,
    )
    return out_dir / "node_pb2.py"


def main(argv: list[str]) -> int:
    if "--check" in argv and shutil.which("protoc") is None:
        print("protoc not found on PATH: check skipped")
        return 0
    if "--check" in argv:
        with tempfile.TemporaryDirectory() as td:
            fresh = generate(Path(td)).read_bytes()
        committed = (HERE / "node_pb2.py").read_bytes()
        if fresh != committed:
            print(
                "node_pb2.py is stale (or protoc version drift): regenerate "
                "with `python -m p2pfl_tpu_torch.comm.grpc.generate_proto`",
                file=sys.stderr,
            )
            return 1
        print("node_pb2.py is up to date")
        return 0
    path = generate(HERE)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
