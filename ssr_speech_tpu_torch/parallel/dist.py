"""Process-group launch for the port's parallel paths.

``init_distributed`` joins the group ``torchrun`` describes in the environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``);
it is what ``train_lm`` and ``train_codec`` call. :func:`spawn` starts
``world_size`` ranks of one function on this host itself, each a fresh
interpreter joined through a ``FileStore`` under a directory (no TCP port, so
concurrent runs never collide); the tests and ``chip_smoke.py`` use it.

The backend is the caller's choice, never switched behind its back: ``nccl``
for one rank per GPU, ``gloo`` on the CPU or when ranks share one card
(NCCL refuses two ranks on one device). :func:`default_backend` gives the
CLIs' default: ``nccl`` on CUDA, ``gloo`` on the CPU.

    python -m ssr_speech_tpu_torch.parallel.dist TASK RANK WORLD
runs one rank of a task :func:`spawn` wrote (not for direct use).
"""

from __future__ import annotations

import logging
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

REPO_ROOT = Path(__file__).resolve().parents[2]


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(backend: Optional[str] = None, device="cuda"):
    """Join the process group of a ``torchrun`` launch and return
    ``(rank, world_size, device)``; ``device`` "cuda" becomes this rank's
    card ``cuda:LOCAL_RANK`` under ``nccl`` (ranks sharing one card under
    ``gloo`` keep the device they name). Without ``WORLD_SIZE`` in the
    environment this is a single process: (0, 1, device), no group."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and not dist.is_initialized():
        return 0, 1, device
    backend = backend or default_backend(device)
    if device.type == "cuda" and backend == "nccl" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend=backend)
    return dist.get_rank(), dist.get_world_size(), device


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0 (or a process without a group): the one that writes files and
    returns results."""
    return rank() == 0


def synced_clock(clock, device):
    """``clock`` as read on rank 0, the same value on every rank (one
    broadcast a read), so that host-side decisions taken on the time (which
    request has arrived) are the same on every rank of a sharded server and
    the ranks stay in step. In one process it is ``clock`` itself."""
    if not dist.is_initialized() or dist.get_world_size() == 1 \
            or getattr(clock, "synced", False):
        return clock
    from .collectives import broadcast

    def read():
        t = torch.tensor([clock() if dist.get_rank() == 0 else 0.0],
                         dtype=torch.float64, device=device)
        return float(broadcast(t, 0, dist.group.WORLD)[0])

    read.synced = True
    return read


# ------------------------------------------------------------------- spawn

class RankFailed(RuntimeError):
    """A spawned rank exited with an error (its stderr's end attached)."""


def spawn(fn: Callable, world_size: int, *, backend: str = "gloo",
          device: str = "cpu", store_dir: Optional[str] = None,
          args: Sequence[Any] = (), threads: int = 1,
          timeout: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` in ``world_size`` fresh processes joined in one
    process group and return the ranks' results in rank order.

    ``fn`` must be importable by module path (a top-level function); it runs
    after ``init_process_group(backend, FileStore)`` with
    ``torch.set_num_threads(threads)``, and ``device`` is set as the current
    CUDA device when it names one. Arguments and results are pickled. A rank
    that raises, or a run longer than ``timeout`` seconds, kills the others
    and raises :class:`RankFailed`."""
    owned = store_dir is None
    root = Path(tempfile.mkdtemp(prefix="ssr_spawn_") if owned else store_dir)
    root.mkdir(parents=True, exist_ok=True)
    task = root / "task.pkl"
    with open(task, "wb") as f:
        pickle.dump(dict(fn=fn, args=tuple(args), backend=backend,
                         device=device, threads=threads,
                         store=str(root / "store")), f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                            if p])
    procs = []
    try:
        for r in range(world_size):
            err = open(root / f"rank{r}.err", "wb")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "ssr_speech_tpu_torch.parallel.dist",
                 str(task), str(r), str(world_size)],
                env=env, stdout=err, stderr=subprocess.STDOUT), err))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None and any(p.poll() is None for p, _ in procs):
            for r, (p, _) in enumerate(procs):
                if p.poll() not in (None, 0):
                    failed = r
            if time.monotonic() > deadline:
                failed = -1
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, (p, _) in enumerate(procs)
                           if p.returncode != 0), None)
        if failed is not None:
            what = (f"timed out after {timeout:.0f} s" if failed < 0
                    else f"rank {failed} exited with {procs[failed][0].returncode}")
            r = max(failed, 0)
            tail = (root / f"rank{r}.err").read_bytes()[-6000:].decode(
                "utf-8", "replace")
            raise RankFailed(f"spawned {world_size} ranks: {what}; rank {r} "
                             f"output:\n{tail}")
        results = []
        for r in range(world_size):
            with open(root / f"rank{r}.out", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            err.close()
        if owned:
            import shutil

            shutil.rmtree(root, ignore_errors=True)


def _run_rank(task_path: str, rank_: int, world: int) -> None:
    with open(task_path, "rb") as f:
        task = pickle.load(f)
    torch.set_num_threads(task["threads"])
    device = torch.device(task["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(task["store"], world)
    dist.init_process_group(task["backend"], store=store, rank=rank_,
                            world_size=world)
    try:
        out = task["fn"](*task["args"])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    tmp = Path(task_path).parent / f"rank{rank_}.out.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, tmp.with_suffix(""))


if __name__ == "__main__":
    _run_rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
