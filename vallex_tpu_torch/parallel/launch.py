"""Child processes of the port: the ranks of dp × tp training and the
serving workers of engine/batch.py.

Every child is a fresh interpreter (`python -m vallex_tpu_torch.parallel.
launch <fd>`, never a fork: the parent may hold CUDA state) that imports
only the port. It reads one pickled `(fn, args)` from its end of a socket
pair and runs `fn(link, *args)`; `fn` lives in the port, so unpickling it
imports nothing else (not the caller's main module, not a test module).
Messages both ways are plain pickles behind an 8-byte length (tensors go
by value, on the CPU; a message is read into one preallocated buffer, so
a model's weights cross in one copy); a child answers ("ok", value) or
("error", traceback).

    results = run_ranks(make_mesh(2, 1, ["cpu"] * 2), fn, arg)

runs fn(ranks, arg) in each rank after `init_process_groups` and returns
the per-rank values; a rank that fails or dies ends every rank.
"""

from __future__ import annotations

import os
import pickle
import select
import socket
import struct
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, List, Optional

ROOT = str(Path(__file__).resolve().parents[2])  # the directory holding the package


class Link:
    """One end of a socket pair carrying length-prefixed pickles."""

    def __init__(self, sock: socket.socket):
        self.sock = sock

    def send(self, obj: Any) -> None:
        data = pickle.dumps(obj, protocol=5)
        self.sock.sendall(struct.pack("<Q", len(data)))
        self.sock.sendall(data)

    def _exact(self, n: int) -> bytearray:
        buf = bytearray(n)
        view, got = memoryview(buf), 0
        while got < n:
            k = self.sock.recv_into(view[got:])
            if not k:
                raise EOFError("the other end closed the link")
            got += k
        return buf

    def recv(self) -> Any:
        (n,) = struct.unpack("<Q", self._exact(8))
        return pickle.loads(self._exact(n))

    def poll(self, timeout: float = 0.0) -> bool:
        return bool(select.select([self.sock], [], [], timeout)[0])

    def close(self) -> None:
        self.sock.close()


class Child:
    """A child interpreter running fn(conn, *args) (see the module doc)."""

    def __init__(self, fn, args=(), threads: Optional[int] = None):
        mine, theirs = socket.socketpair()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
        if threads:
            env["OMP_NUM_THREADS"] = str(threads)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "vallex_tpu_torch.parallel.launch", str(theirs.fileno())],
            pass_fds=[theirs.fileno()], env=env)
        theirs.close()
        self.conn = Link(mine)
        self._job = (fn, tuple(args))

    def start(self) -> "Child":
        """Send the job (it waits until the child reads it: start every
        child's process first, then their jobs)."""
        self.conn.send(self._job)
        self._job = None
        return self

    def ready(self) -> bool:
        """A message is waiting; raises if the child ended without one."""
        if self.conn.poll(0):
            return True
        if self.proc.poll() is not None and not self.conn.poll(0):
            raise RuntimeError(f"child process ended with code {self.proc.returncode}")
        return False

    def get(self, timeout: Optional[float] = None) -> Any:
        """The child's next answer (raises its error)."""
        end = None if timeout is None else time.monotonic() + timeout
        while not self.ready():
            if end is not None and time.monotonic() > end:
                raise TimeoutError(f"no answer from the child process in {timeout} s")
            self.conn.poll(0.05)
        try:
            status, value = self.conn.recv()
        except EOFError:
            self.proc.wait()
            raise RuntimeError(f"child process ended with code {self.proc.returncode}") from None
        if status != "ok":
            raise RuntimeError(f"child process failed:\n{value}")
        return value

    def put(self, obj: Any) -> None:
        self.conn.send(obj)

    def close(self, wait: float = 30.0) -> None:
        """Ask the child to stop (None), then end it if it does not."""
        if self.proc.poll() is None:
            try:
                self.conn.send(None)
                self.proc.wait(wait)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()
        self.conn.close()


def gather(children: List[Child], timeout: Optional[float] = None) -> List[Any]:
    """Each child's next answer; the first failure ends them all and raises."""
    out: List[Any] = [None] * len(children)
    pending = set(range(len(children)))
    end = None if timeout is None else time.monotonic() + timeout
    try:
        while pending:
            for i in sorted(pending):
                if children[i].ready():
                    out[i] = children[i].get()
                    pending.discard(i)
            if pending:
                if end is not None and time.monotonic() > end:
                    raise TimeoutError(f"children {sorted(pending)} gave no answer in {timeout} s")
                time.sleep(0.01)
    except BaseException:
        for c in children:
            c.proc.kill()
        raise
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(conn, mesh, rank, backend, init_method, fn, args, threads):
    import torch
    import torch.distributed as dist

    from .mesh import init_process_groups

    if threads:
        torch.set_num_threads(threads)
    ranks = init_process_groups(mesh, rank, backend, init_method)
    try:
        out = fn(ranks, *args)
    finally:
        dist.destroy_process_group()
    conn.send(("ok", out))


def run_ranks(mesh, fn, *args, backend: Optional[str] = None,
              init_method: Optional[str] = None, threads: Optional[int] = None,
              timeout: Optional[float] = None) -> List[Any]:
    """Run fn(ranks, *args) in one child per rank of `mesh` (ranks from
    init_process_groups: nccl on CUDA, gloo on the CPU unless `backend`
    says; `init_method` defaults to a free localhost port) → the ranks'
    return values, in rank order."""
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    children = [Child(_rank, (mesh, r, backend, init_method, fn, args, threads), threads)
                for r in range(mesh.size)]
    try:
        for c in children:
            c.start()
        return gather(children, timeout)
    finally:
        for c in children:
            c.close()


def _main(fd: int) -> None:
    conn = Link(socket.socket(fileno=fd))
    try:
        fn, args = conn.recv()
        fn(conn, *args)
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise SystemExit(1)


if __name__ == "__main__":
    _main(int(sys.argv[1]))
