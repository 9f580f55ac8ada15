"""Start a world of ranks as processes and collect what each returns.

Nothing on a single host tells a program of its cluster: the launcher gives
each rank its rank, the world size and the rendezvous address
(``tcp://127.0.0.1:<free port>``), and a rank program builds its mesh from
them (``parallel/mesh.py:build_mesh``). Every rank is a fresh interpreter
(``python -m <module>`` or a script; ``OMP_NUM_THREADS=1`` unless the
caller sets it), so the ranks never share a CUDA context or a fork of the
caller's state.

A rank that fails fails the world: the others are killed at once and its
error (the tail of its stderr) is raised. So is a world that does not
finish within the limit: every rank is killed and a ``TimeoutError``
names the ranks still running. No rank outlives :func:`run_ranks`.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from typing import Any, List, Optional, Sequence

import torch

RANK_FLAGS = ("--rank", "--world", "--init", "--out")
POLL_S = 0.05


class RankFailed(RuntimeError):
    """A rank exited with an error; ``rank`` and the tail of its stderr."""

    def __init__(self, rank: int, code: int, tail: str):
        self.rank, self.code, self.tail = rank, code, tail
        super().__init__(f"rank {rank} exited with {code}:\n{tail}")


def free_port() -> int:
    """A TCP port on the loopback that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_args(argv: Sequence[str]) -> dict:
    """The launcher's flags out of a rank program's argv: rank, world,
    init (the rendezvous address) and out (where to save its result)."""
    out = {}
    argv = list(argv)
    for flag in RANK_FLAGS:
        i = argv.index(flag)
        out[flag[2:]] = argv[i + 1]
    out["rank"], out["world"] = int(out["rank"]), int(out["world"])
    return out


def save_result(path: str, result: Any) -> None:
    """A rank's picklable result, written whole (a temporary name, then
    renamed): the launcher never reads half a file."""
    torch.save(result, path + ".tmp")
    os.replace(path + ".tmp", path)


def _tail(path: str, n: int = 6000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return ""


def run_ranks(command: Sequence[str], world: int, timeout_s: float,
              log_dir: Optional[str] = None) -> List[Any]:
    """Run ``command`` (argv, e.g. ``[sys.executable, "-m", mod, ...]``)
    once per rank with ``--rank r --world n --init addr --out file``
    appended; return each rank's saved result, in rank order. Raises
    :class:`RankFailed` when a rank exits non-zero or saves nothing, and
    ``TimeoutError`` past ``timeout_s``; every rank is dead by then.
    ``log_dir`` keeps each rank's stdout and stderr there."""
    init = f"tcp://127.0.0.1:{free_port()}"
    child_env = dict(os.environ)
    child_env.setdefault("OMP_NUM_THREADS", "1")
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        logs = log_dir or tmp
        procs, outs, errs = [], [], []
        try:
            for r in range(world):
                out = os.path.join(tmp, f"rank{r}.pt")
                err = os.path.join(logs, f"rank{r}.stderr")
                stdout = os.path.join(logs, f"rank{r}.stdout")
                with open(stdout, "wb") as so, open(err, "wb") as se:
                    procs.append(subprocess.Popen(
                        [*command, "--rank", str(r), "--world", str(world),
                         "--init", init, "--out", out],
                        stdout=so, stderr=se, env=child_env))
                outs.append(out)
                errs.append(err)
            deadline = time.monotonic() + timeout_s
            while True:
                codes = [p.poll() for p in procs]
                for r, code in enumerate(codes):
                    if code not in (None, 0):
                        raise RankFailed(r, code, _tail(errs[r]))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    running = [r for r, c in enumerate(codes) if c is None]
                    raise TimeoutError(
                        f"ranks {running} of {world} still running after "
                        f"{timeout_s:.0f} s; killed. Rank "
                        f"{running[0]}'s stderr:\n{_tail(errs[running[0]])}")
                time.sleep(POLL_S)
            results = []
            for r, out in enumerate(outs):
                if not os.path.exists(out):
                    raise RankFailed(r, 0, "saved no result\n"
                                     + _tail(errs[r]))
                results.append(torch.load(out, weights_only=False))
            return results
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass

