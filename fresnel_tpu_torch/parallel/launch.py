"""Process launch for data parallelism: one process per rank.

* `launcher_env()` reads a rank's place from its environment: torchrun's
  RANK, WORLD_SIZE and LOCAL_RANK (with MASTER_ADDR / MASTER_PORT), or
  the same written by `spawn`, which adds FRESNEL_DIST_INIT, the
  process group's init URL (a `file://` store, so concurrent launches
  need no free port).
* `init_distributed` joins the process group on the rank's device,
  `cuda:{local_rank}` by default (a missing card raises, as at every
  entry point; the CPU must be asked for): NCCL for CUDA, gloo for the
  CPU, or the backend asked for (gloo on one shared card, where NCCL
  refuses two ranks).
* `spawn` starts ranks as `python ARGV` processes with that environment.
* `run_job` runs a job (a list of `parallel.jobs` rank programs) on N
  fresh ranks: `python -m fresnel_tpu_torch.parallel.launch DIR` reads
  DIR/job.pt and writes DIR/rank{r}.pt, each rank's results, and
  DIR/rank{r}.log, its output.

`train_gaussian_decoder --num_devices N` uses `spawn` when no launcher
environment is present (it is rank 0 and starts ranks 1 .. N - 1).
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from fresnel_tpu_torch.device import resolve_device

ENV_INIT = "FRESNEL_DIST_INIT"
# The directory holding the package, put on each spawned rank's path.
ROOT = str(Path(__file__).resolve().parents[2])
# Seconds a collective waits for its peers before it fails.
TIMEOUT_S = 600.0


def launcher_env() -> Optional[Dict]:
    """{rank, world_size, local_rank, init_method} from the environment of
    a launched rank; None when no launcher set it."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank = int(os.environ["RANK"])
    return {"rank": rank, "world_size": int(os.environ["WORLD_SIZE"]),
            "local_rank": int(os.environ.get("LOCAL_RANK", rank)),
            "init_method": os.environ.get(ENV_INIT, "env://")}


def rank_device(local_rank: int, device=None) -> torch.device:
    """The rank's device: `device` resolved as the entry points resolve it
    (None means CUDA, and raises where CUDA is absent), "cuda" meaning
    `cuda:{local_rank}`."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return dev


def init_distributed(rank: int, world_size: int, init_method: str,
                     device=None, backend: Optional[str] = None,
                     local_rank: Optional[int] = None) -> torch.device:
    """Join the process group; returns the rank's device."""
    dev = rank_device(rank if local_rank is None else local_rank, device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def file_init(directory) -> str:
    """A fresh `file://` init URL in `directory`."""
    fd, path = tempfile.mkstemp(prefix="dist_store_", dir=directory)
    os.close(fd)
    os.unlink(path)
    return "file://" + str(Path(path).resolve())


def spawn(argv: Sequence[str], world_size: int, init_method: str,
          ranks: Sequence[int], logs: Optional[Sequence] = None
          ) -> List[subprocess.Popen]:
    """Start `python ARGV` once for each rank in `ranks`, its place in the
    environment; each rank's output goes to `logs[i]` (a path) if given,
    else to this process's output."""
    procs = []
    for i, r in enumerate(ranks):
        e = dict(os.environ)
        e.update(RANK=str(r), WORLD_SIZE=str(world_size),
                 LOCAL_RANK=str(r), **{ENV_INIT: init_method})
        e["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + [p for p in e.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        out = open(logs[i], "w") if logs else None
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=e, stdout=out,
            stderr=subprocess.STDOUT if out else None))
        if out:
            out.close()
    return procs


def terminate(procs: Sequence[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def run_job(tasks: List[Dict], world_size: int, workdir, device=None,
            backend: Optional[str] = None, threads: Optional[int] = None,
            timeout: float = 600.0) -> List[List]:
    """Run the rank programs `tasks` (dicts with a "task" key naming a
    function of `parallel.jobs`) in order on `world_size` fresh ranks, in
    one start-up; returns each rank's list of results.  `device` is each
    rank's device ("cuda" is cuda:{rank}; "cuda:0" puts every rank on
    card 0), `threads` each rank's intra-op threads; the ranks take this
    process's TF32 settings (cuDNN's is on by default, and a rank that
    convolves in TF32 parts from a caller that does not by ~1e-3).  A
    rank that fails, or a job over `timeout` seconds, ends every rank and
    raises RuntimeError with the ranks' output."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save({"tasks": tasks, "device": device, "backend": backend,
                "threads": threads,
                "tf32": (torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32)},
               workdir / "job.pt")
    for r in range(world_size):
        (workdir / f"rank{r}.pt").unlink(missing_ok=True)
    logs = [workdir / f"rank{r}.log" for r in range(world_size)]
    procs = spawn(["-m", "fresnel_tpu_torch.parallel.launch", str(workdir)],
                  world_size, file_init(workdir), range(world_size), logs)
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        failed = any(c not in (None, 0) for c in codes)
        if failed or all(c == 0 for c in codes) \
                or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    terminate(procs)
    if not all(c == 0 for c in codes):
        tails = "\n".join(f"--- rank {r} (exit {c}) ---\n"
                          + logs[r].read_text()[-4000:]
                          for r, c in enumerate(codes))
        raise RuntimeError(f"parallel job failed: exit codes {codes}\n"
                           + tails)
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(world_size)]


def main(argv=None) -> None:
    """One rank of `run_job`: python -m fresnel_tpu_torch.parallel.launch
    DIR."""
    faulthandler.enable()      # a rank that crashes leaves its stack
    argv = sys.argv[1:] if argv is None else argv
    workdir = Path(argv[0])
    env = launcher_env()
    if env is None:
        raise SystemExit("run by parallel.launch.run_job (RANK, WORLD_SIZE "
                         f"and {ENV_INIT} unset)")
    job = torch.load(workdir / "job.pt", weights_only=False)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = job["tf32"]
    if job["threads"]:
        torch.set_num_threads(job["threads"])
    dev = init_distributed(env["rank"], env["world_size"],
                           env["init_method"], job["device"], job["backend"],
                           env["local_rank"])
    from fresnel_tpu_torch.parallel import jobs

    results = [getattr(jobs, t["task"])(t, dev) for t in job["tasks"]]
    dist.barrier()
    out = workdir / f"rank{env['rank']}.pt"
    with tempfile.NamedTemporaryFile(dir=workdir, delete=False) as f:
        torch.save(results, f)
    os.replace(f.name, out)
    shutdown()


if __name__ == "__main__":
    main()
