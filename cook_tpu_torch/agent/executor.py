"""The port's copy of ``cook_tpu/agent/executor.py`` (imports re-rooted).
``python -m cook_tpu_torch.agent.executor`` loads neither PyTorch nor
numpy: the package's ``__init__`` imports torch only inside
``resolve_device``, so an agent host needs no PyTorch.

On-node task executor.

The port of the reference's executor agent (reference: executor/cook/
executor.py:421-510, subprocess.py, progress.py:123-297):

 - runs the user command in its own process group/session so the whole tree
   can be signalled;
 - streams stdout/stderr into sandbox files;
 - watches a configurable progress regex in the output (and an optional
   explicit progress file), publishing sequenced updates to the scheduler's
   ``POST /progress/<task-id>`` endpoint (the sidecar path) or a local
   callback;
 - graceful kill via escalating signals to the process group
   (subprocess.py:102-232): SIGTERM, grace period, SIGKILL;
 - writes an exit-code sentinel into the sandbox.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import threading
import time
import urllib.request
from pathlib import Path
from typing import Callable, Dict, Optional

DEFAULT_PROGRESS_REGEX = r"progress:?\s+([0-9]*\.?[0-9]+)%?(?:\s+(.*))?"


class ProgressWatcher:
    """Extract monotone progress updates from output lines (reference:
    progress.py:123-297: latest-by-sequence, capped message length)."""

    def __init__(self, regex: str = DEFAULT_PROGRESS_REGEX,
                 publish: Optional[Callable[[int, int, str], None]] = None,
                 max_message_length: int = 512):
        self.pattern = re.compile(regex)
        self.publish = publish
        self.max_message_length = max_message_length
        self.sequence = 0
        self.last_percent: Optional[int] = None
        self.last_message = ""

    def observe_line(self, line: str) -> None:
        match = self.pattern.search(line)
        if not match:
            return
        try:
            percent = int(float(match.group(1)))
        except ValueError:
            return
        percent = max(0, min(100, percent))
        has_msg = match.lastindex is not None and match.lastindex >= 2
        message = ((match.group(2) if has_msg else "") or "") \
            .strip()[:self.max_message_length]
        self.sequence += 1
        self.last_percent = percent
        self.last_message = message
        if self.publish:
            self.publish(self.sequence, percent, message)


def rest_progress_publisher(api_url: str, task_id: str
                            ) -> Callable[[int, int, str], None]:
    """Publish to the scheduler's progress endpoint (the sidecar tracker's
    path, sidecar/cook/sidecar/tracker.py)."""

    def publish(sequence: int, percent: int, message: str) -> None:
        body = json.dumps({"progress_sequence": sequence,
                           "progress_percent": percent,
                           "progress_message": message}).encode()
        req = urllib.request.Request(
            f"{api_url}/progress/{task_id}", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=10)
        except OSError:
            pass  # progress is best-effort

    return publish


class TaskExecutor:
    def __init__(self, command: str, sandbox: str,
                 env: Optional[Dict[str, str]] = None,
                 progress_regex: str = DEFAULT_PROGRESS_REGEX,
                 progress_publish: Optional[Callable] = None,
                 progress_file: Optional[str] = None,
                 kill_grace_period_s: float = 2.0,
                 shell: str = "/bin/sh",
                 resize_file: Optional[str] = None):
        self.command = command
        self.sandbox = Path(sandbox)
        self.env = dict(env or {})
        self.kill_grace_period_s = kill_grace_period_s
        self.shell = shell
        self.watcher = ProgressWatcher(progress_regex, progress_publish)
        # explicit progress file, tailed alongside stdout/stderr
        # (reference: :job/progress-output-file; progress.py watches the
        # EXECUTOR_PROGRESS_OUTPUT_FILE location)
        self.progress_file = (self.sandbox / progress_file
                              if progress_file else None)
        # elastic-gang resize event file (docs/GANG.md elasticity): the
        # checkpoint/grace protocol appends one JSON line per resize
        # advisory here, and its path is advertised to the task as
        # COOK_GANG_RESIZE_FILE before the fork
        self.resize_file = (self.sandbox / resize_file
                            if resize_file else None)
        self.process: Optional[subprocess.Popen] = None
        self.exit_code: Optional[int] = None
        self._reader_threads = []
        self._killed = False

    # ------------------------------------------------------------------ run
    def start(self) -> None:
        self.sandbox.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ)
        env.update(self.env)
        env["COOK_WORKDIR"] = str(self.sandbox)
        if self.progress_file is not None:
            # advertised BEFORE the fork so the task can locate its file
            env["EXECUTOR_PROGRESS_OUTPUT_FILE"] = str(self.progress_file)
        if self.resize_file is not None:
            # advertised BEFORE the fork so an elastic-gang workload can
            # watch for resize advisories (docs/GANG.md: SIGUSR1 says
            # "look at the file"; the file says what is happening)
            env["COOK_GANG_RESIZE_FILE"] = str(self.resize_file)
        self.process = subprocess.Popen(
            [self.shell, "-c", self.command],
            cwd=str(self.sandbox), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            start_new_session=True)  # own process group + session
        for stream, name in ((self.process.stdout, "stdout"),
                             (self.process.stderr, "stderr")):
            t = threading.Thread(target=self._pump, args=(stream, name),
                                 daemon=True)
            t.start()
            self._reader_threads.append(t)
        if self.progress_file is not None:
            t = threading.Thread(target=self._tail_progress_file,
                                 daemon=True)
            t.start()
            # joined by wait() so the final pass (after process exit) can
            # publish a progress line written just before the task exited
            self._reader_threads.append(t)

    def _tail_progress_file(self) -> None:
        """Tail the job's explicit progress file while the task runs; the
        file may not exist until the task writes it."""
        pos = 0
        while True:
            alive = self.process is not None and self.process.poll() is None
            try:
                with open(self.progress_file, "rb") as f:
                    f.seek(pos)
                    for raw in iter(f.readline, b""):
                        if not raw.endswith(b"\n") and alive:
                            break  # partial line: re-read next pass
                        pos += len(raw)
                        try:
                            self.watcher.observe_line(
                                raw.decode("utf-8", errors="replace"))
                        except Exception:
                            pass
            except OSError:
                pass
            if not alive:
                return
            time.sleep(0.1)

    def _pump(self, stream, name: str) -> None:
        """Stream output to the sandbox file, watching for progress
        (interleaving-safe: one writer per stream, io_helper.py)."""
        path = self.sandbox / name
        with open(path, "ab") as f:
            for raw in iter(stream.readline, b""):
                f.write(raw)
                f.flush()
                try:
                    self.watcher.observe_line(
                        raw.decode("utf-8", errors="replace"))
                except Exception:
                    pass

    def wait(self, timeout_s: Optional[float] = None) -> Optional[int]:
        if self.process is None:
            return None
        try:
            self.exit_code = self.process.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            return None
        for t in self._reader_threads:
            t.join(timeout=5)
        (self.sandbox / "exit_code").write_text(str(self.exit_code))
        return self.exit_code

    # ----------------------------------------------------------------- kill
    def kill(self) -> int:
        """Escalating kill of the whole process group (reference:
        subprocess.py:102-232). Returns the exit code."""
        if self.process is None:
            return -1
        self._killed = True
        pgid = os.getpgid(self.process.pid)
        try:
            os.killpg(pgid, signal.SIGTERM)
        except ProcessLookupError:
            pass
        deadline = time.time() + self.kill_grace_period_s
        while time.time() < deadline:
            if self.process.poll() is not None:
                break
            time.sleep(0.05)
        if self.process.poll() is None:
            try:
                os.killpg(pgid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        return self.wait(timeout_s=10) or self.process.returncode

    def notify_resize(self, event: Dict) -> None:
        """Relay an elastic-gang resize advisory to the workload
        (docs/GANG.md checkpoint/grace protocol): append one JSON line
        to the resize file, then SIGUSR1 the task's process group so a
        checkpoint-aware trainer wakes up and reads it.  Best-effort on
        both legs — the shrink itself executes through the ordinary
        kill at the grace deadline regardless."""
        if self.resize_file is not None:
            try:
                line = json.dumps({"ts": time.time(), **event})
                with open(self.resize_file, "a") as f:
                    f.write(line + "\n")
            except OSError:
                pass
        if self.process is not None and self.process.poll() is None:
            try:
                os.killpg(os.getpgid(self.process.pid), signal.SIGUSR1)
            except (ProcessLookupError, PermissionError):
                pass

    @property
    def running(self) -> bool:
        return self.process is not None and self.process.poll() is None


def main(argv=None) -> int:
    """``python -m cook_tpu_torch.agent.executor`` — run one task command
    under the progress-tracking executor (the reference's :job/executor
    "cook" choice: the custom executor instead of the bare shell,
    executor/cook/executor.py:421-510).

    Configuration comes from the environment the launch path already
    provides (COOK_SANDBOX, COOK_TASK_ID) plus:
      COOK_PROGRESS_URL        scheduler base URL for POST /progress/:id
      COOK_PROGRESS_REGEX      per-job regex (:job/progress-regex-string)
      COOK_PROGRESS_FILE       per-job explicit progress file
      COOK_GANG_UUID/MIN/MAX   gang membership + elastic bounds (set by
                               the launch path, docs/GANG.md)
      COOK_GANG_RESIZE_FILE    resize-advisory file name (default
                               ``.cook-gang-resize.jsonl`` for gang
                               members; re-advertised to the task as an
                               absolute sandbox path)
      COOK_TRACEPARENT         W3C trace context propagated from the
                               launch path (sched/matcher.py): the
                               wrapper opens an ``agent.exec`` span
                               under it — retained in this process's
                               local span ring and appended to the
                               sandbox's ``trace_spans.jsonl`` so the
                               fleet trace collector can stitch the
                               exec leg onto the job's client-minted
                               timeline (docs/OBSERVABILITY.md)
    The command is argv (joined), exit code is the task's exit code.
    SIGUSR1 relays an elastic shrink advisory (checkpoint window open):
    the event is appended to the resize file and the signal forwarded to
    the task's process group (docs/GANG.md checkpoint/grace protocol).
    """
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print("usage: python -m cook_tpu_torch.agent.executor <command...>",
              file=sys.stderr)
        return 2
    command = " ".join(args)
    sandbox = os.environ.get("COOK_SANDBOX", ".")
    task_id = os.environ.get("COOK_TASK_ID", "")
    publish = None
    api_url = os.environ.get("COOK_PROGRESS_URL", "")
    if api_url and task_id:
        publish = rest_progress_publisher(api_url, task_id)
    resize_file = os.environ.get("COOK_GANG_RESIZE_FILE") or (
        ".cook-gang-resize.jsonl" if os.environ.get("COOK_GANG_UUID")
        else None)
    ex = TaskExecutor(
        command, sandbox=sandbox,
        progress_regex=os.environ.get("COOK_PROGRESS_REGEX",
                                      DEFAULT_PROGRESS_REGEX),
        progress_publish=publish,
        progress_file=os.environ.get("COOK_PROGRESS_FILE") or None,
        resize_file=resize_file)

    # The agent kills tasks by signalling the WRAPPER's process group, but
    # TaskExecutor puts the user command in its own session — forward the
    # kill (escalating SIGTERM -> grace -> SIGKILL on the child's tree,
    # reference: executor.py graceful-kill) or the workload would survive
    # its own task being killed.
    def forward_kill(signum, _frame):
        code = ex.kill()
        raise SystemExit(128 + signum if code is None else code)

    signal.signal(signal.SIGTERM, forward_kill)
    signal.signal(signal.SIGINT, forward_kill)

    # SIGUSR1 = elastic shrink advisory from the agent (docs/GANG.md
    # checkpoint/grace): relay to the workload — file event + forwarded
    # signal — and keep running; the kill comes separately at the grace
    # deadline
    def forward_resize(_signum, _frame):
        ex.notify_resize({"kind": "gang-resize", "direction": "shrink",
                          "gang": os.environ.get("COOK_GANG_UUID", ""),
                          "signal": "SIGUSR1"})

    signal.signal(signal.SIGUSR1, forward_resize)

    # Adopt a propagated trace context (W3C traceparent stamped into the
    # task env by the launch path): the exec leg joins the job's
    # client-minted trace under this process's own identity, so the
    # fleet-wide stitched export (GET /debug/trace) shows the agent-side
    # execution next to the leader's txn and the submission request.
    from ..utils import tracing
    remote = tracing.parse_traceparent(os.environ.get("COOK_TRACEPARENT"))
    if remote is not None:
        tracing.set_process_identity(
            "agent-" + (os.environ.get("COOK_HOSTNAME")
                        or os.uname().nodename))

    def run() -> int:
        ex.start()
        code = None
        while code is None:
            code = ex.wait(timeout_s=1.0)
        return code

    if remote is None:
        return run()
    with tracing.tracer.span("agent.exec", remote_parent=remote,
                             task=task_id or None,
                             gang=os.environ.get("COOK_GANG_UUID") or None
                             ) as sp:
        code = run()
        sp.set_tag("exit_code", code)
    # spans for this trace land in the sandbox as one JSON line each —
    # retrievable after the wrapper exits (the ring dies with it)
    try:
        with open(Path(sandbox) / "trace_spans.jsonl", "a") as f:
            for doc in tracing.tracer.traces(remote[0]):
                f.write(json.dumps(doc) + "\n")
    except OSError:
        pass  # trace retention is best-effort
    return code


if __name__ == "__main__":  # pragma: no cover - exercised via agent tests
    raise SystemExit(main())
