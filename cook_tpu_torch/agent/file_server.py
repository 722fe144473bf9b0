"""The port's copy of ``cook_tpu/agent/file_server.py`` (imports re-rooted).

Sandbox file server.

The sidecar's file-access API (reference: sidecar/cook/sidecar/
file_server.py:136-235, replicating the Mesos agent /files endpoints over
COOK_WORKDIR):

  GET /files/read?path=&offset=&length=   -> {"data": ..., "offset": n}
  GET /files/download?path=               -> raw bytes
  GET /files/browse?path=                 -> [{path, size, mode, mtime, nlink}]

All paths are resolved under the sandbox root; traversal outside it is a
404 (the reference hides existence of outside paths).
"""

from __future__ import annotations

import json
import os
import stat
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

MAX_READ_LENGTH = 4 * 1024 * 1024


class _FilesHandler(BaseHTTPRequestHandler):
    root: Path = Path(".")
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # pragma: no cover
        pass

    def _respond_json(self, status: int, payload) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _resolve(self, raw_path: str) -> Optional[Path]:
        if not raw_path:
            return None
        candidate = (self.root / raw_path.lstrip("/")).resolve()
        root = self.root.resolve()
        if candidate != root and root not in candidate.parents:
            return None
        return candidate if candidate.exists() else None

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path == "/readiness-probe":
            # kubelet readiness for the sidecar container (the probe
            # endpoint pod_spec wires into the pod's readinessProbe)
            return self._respond_json(200, {"status": "ok"})
        params = urllib.parse.parse_qs(parsed.query)
        raw_path = (params.get("path") or [""])[0]
        target = self._resolve(raw_path)
        if parsed.path == "/files/read":
            if target is None or not target.is_file():
                return self._respond_json(404, {"error": "no such file"})
            if "offset" not in params:
                # Mesos files/read semantics (kept by the reference sidecar):
                # omitting offset returns the current file size, which is how
                # clients (e.g. tail) discover where the end is.
                return self._respond_json(
                    200, {"data": "", "offset": target.stat().st_size})
            offset = int(params["offset"][0])
            length = min(int((params.get("length") or [str(MAX_READ_LENGTH)])[0]),
                         MAX_READ_LENGTH)
            if offset < 0 or length < 0:
                return self._respond_json(400, {"error": "negative offset/length"})
            with open(target, "rb") as f:
                f.seek(offset)
                data = f.read(length)
            # surrogateescape keeps arbitrary bytes round-trippable: a chunk
            # boundary may split a multibyte character, and the client glues
            # chunks back together with .encode('utf-8', 'surrogateescape')
            return self._respond_json(200, {
                "data": data.decode("utf-8", errors="surrogateescape"),
                "offset": offset})
        if parsed.path == "/files/download":
            if target is None or not target.is_file():
                return self._respond_json(404, {"error": "no such file"})
            data = target.read_bytes()
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Disposition",
                             f'attachment; filename="{target.name}"')
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        if parsed.path == "/files/browse":
            if not raw_path:
                target = self.root.resolve()  # empty path = sandbox root
            if target is None or not target.is_dir():
                return self._respond_json(404, {"error": "no such directory"})
            entries = []
            for child in sorted(target.iterdir()):
                st = child.stat()
                entries.append({
                    "path": str(child.relative_to(self.root.resolve())),
                    "size": st.st_size,
                    "nlink": st.st_nlink,
                    "mtime": int(st.st_mtime),
                    "mode": stat.filemode(st.st_mode),
                })
            return self._respond_json(200, entries)
        return self._respond_json(404, {"error": "no such endpoint"})


class SandboxFileServer:
    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0):
        handler = type("BoundFiles", (_FilesHandler,), {"root": Path(root)})
        self.server = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self.server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


def main(argv: Optional[list] = None) -> int:
    """The ``cook-sidecar`` entrypoint pod_spec wires into the sidecar
    container (``cook-sidecar <port>``; the sidecar image maps that name
    to ``python -m cook_tpu_torch.agent.file_server``).  Serves the sandbox
    (``$COOK_SANDBOX``, default cwd) on 0.0.0.0:<port> until killed."""
    import signal
    import sys
    args = list(sys.argv[1:] if argv is None else argv)
    port = int(args[0]) if args else 28101
    root = os.environ.get("COOK_SANDBOX") or os.environ.get(
        "COOK_WORKDIR") or "."
    srv = SandboxFileServer(root, host="0.0.0.0", port=port)
    srv.start()
    print(f"cook-sidecar: serving {root} on :{srv.port}", flush=True)
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    signal.signal(signal.SIGINT, lambda *_: done.set())
    done.wait()
    srv.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover - container entrypoint
    raise SystemExit(main())
