"""Ranks of a gloo process group on the CPU for tests/test_torch_mesh.py:
each runs the port's sharded recognizer trainer and saves what it holds.

Imported by spawned processes, so it imports torch and the port only
(not JAX, not pytest): a rank starts in about a second.
"""

import multiprocessing
import time

import torch
import torch.distributed as dist

from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer
from pero_ocr_tpu_torch.parallel import mesh as mesh_lib
from pero_ocr_tpu_torch.parallel import train


def train_rank(rank: int, world: int, tp: int, init_file: str, job_path: str,
               out_path: str) -> None:
    """One rank: a (world / tp, tp) CPU mesh, ``job["steps"]`` sharded
    steps on ``job["batch"]`` from ``job["state_dict"]``; saves the
    losses, the rank's weight and moment shards, their tp axes and the
    module's weights."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        job = torch.load(job_path, weights_only=False)
        mesh = mesh_lib.make_mesh(world, tp=tp, device_type="cpu")
        model = CTCRecognizer(job["spec"])
        model.load_state_dict(job["state_dict"])
        optimizer = train.make_optimizer(job["lr"])
        state = train.shard_train_state(train.init_train_state(model, optimizer, device="cpu"),
                                        mesh)
        step = train.make_sharded_train_step(model, optimizer, mesh)
        losses = []
        for _ in range(job["steps"]):
            state, loss = step(state, *job["batch"])
            losses.append(float(loss))
        names = list(state.params)
        torch.save({
            "losses": losses, "axes": state.shard_axes, "count": state.opt_state.count,
            "params": {n: w.detach().clone() for n, w in state.params.items()},
            "mu": dict(zip(names, state.opt_state.mu)), "nu": dict(zip(names, state.opt_state.nu)),
            "module": {n: t.clone() for n, t in model.state_dict().items()},
        }, out_path)
    finally:
        dist.destroy_process_group()


class Ranks:
    """``world`` spawned ranks of :func:`train_rank` on ``job``, started
    at once: the caller may work while they run, then calls
    :meth:`join`."""

    def __init__(self, world: int, tp: int, job: dict, folder, timeout: float = 120.0):
        folder.mkdir(parents=True, exist_ok=True)
        job_path = str(folder / "job.pt")
        torch.save(job, job_path)
        context = multiprocessing.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.outs = [str(folder / f"rank{r}.pt") for r in range(world)]
        self.procs = [context.Process(target=train_rank, args=(
            r, world, tp, str(folder / "init"), job_path, self.outs[r])) for r in range(world)]
        for proc in self.procs:
            proc.start()
        self.deadline = time.monotonic() + timeout

    def join(self) -> list:
        """Join every rank by ``timeout`` seconds after the start, killing
        every rank and raising if one is late or fails (a gloo group
        whose ranks disagree waits forever).  Returns each rank's saved
        outputs, in rank order."""
        try:
            for proc in self.procs:
                proc.join(max(0.0, self.deadline - time.monotonic()))
        finally:
            late = [r for r, proc in enumerate(self.procs) if proc.is_alive()]
            for proc in self.procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        if late:
            raise TimeoutError(f"ranks {late} of {self.world} did not finish within "
                               f"{self.timeout} s")
        failed = {r: proc.exitcode for r, proc in enumerate(self.procs) if proc.exitcode != 0}
        if failed:
            raise RuntimeError(f"ranks failed with exit codes {failed}")
        return [torch.load(path, weights_only=False) for path in self.outs]
