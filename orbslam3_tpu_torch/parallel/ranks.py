"""Process groups on one machine: spawned ranks on a localhost TCP store.

Nothing on a machine tells a program of a cluster, so the launcher picks a
free localhost port and gives every rank the address, the world size and
its rank. `run_ranks` spawns the ranks (never forks: a forked child of a
process that holds a CUDA context or a thread pool can hang), waits for
them, and returns what each rank's function returned; a rank that raises
makes `run_ranks` raise, with the rank's traceback.

`gba_rank` is the rank function of a `distributed_global_ba` solve on a
problem given as numpy arrays: the tests, `entry.dryrun_multichip` and
`chip_smoke.py` run it.
"""
from __future__ import annotations

import socket
import time
import traceback

import numpy as np
import torch


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, fn, args, queue):
    import torch.distributed as dist

    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, args: tuple = (), backend: str = "gloo",
              timeout_s: float = 900.0) -> list:
    """Run fn(rank, world, *args) in `world` spawned processes joined in one
    process group (`backend`: "gloo" or "nccl") on a localhost TCP store.
    `fn` and `args` must pickle (a module-level function). Returns the ranks'
    return values in rank order."""
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, backend, fn, args, queue))
             for r in range(world)]
    for pr in procs:
        pr.start()
    results: dict = {}
    failures = []
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) + len(failures) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(results)} of {world} ranks did not report "
                                   f"within {timeout_s:.0f} s")
            try:
                rank, ok, out = queue.get(timeout=min(left, 5.0))
            except Exception:  # queue.Empty: check that the ranks are still alive
                dead = [r for r, pr in enumerate(procs)
                        if pr.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited with codes "
                                       f"{[procs[r].exitcode for r in dead]} before reporting")
                continue
            if ok:
                results[rank] = out
            else:
                failures.append((rank, out))
        if failures:
            raise RuntimeError("".join(f"rank {r} of {world} failed:\n{tb}" for r, tb in failures))
    finally:
        for pr in procs:
            pr.join(timeout=30)
            if pr.is_alive():
                pr.kill()
                pr.join()
    return [results[r] for r in range(world)]


def gba_rank(rank: int, world: int, problem: dict, iters: int, tile: int, device: str,
             repeat: int = 1) -> dict:
    """One rank of a `distributed_global_ba` solve. `problem` holds numpy
    arrays: the GlobalBAPoints fields, q, p, opt_cam, and as `cam` a port
    Camera or its (fx, fy, cx, cy, baseline, width, height). `device` is the
    tensors' device ("cuda" puts rank r on card r % count). Runs the solve
    `repeat` times and returns the last result as numpy, with each run's
    milliseconds (CUDA events on a card, the wall clock on the CPU)."""
    from orbslam3_tpu_torch.frontend.camera import Camera
    from orbslam3_tpu_torch.parallel.distributed_ba import GlobalBAPoints, distributed_global_ba

    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    t = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in problem.items() if k != "cam"}
    pts = GlobalBAPoints(*[t[f] for f in GlobalBAPoints._fields])
    cam = problem["cam"]
    cam = (cam if isinstance(cam, Camera) else Camera.create(*cam)).to(dev)
    ms = []
    for _ in range(repeat):
        if dev.type == "cuda":
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        q, p, Xw = distributed_global_ba(pts, t["q"], t["p"], t["opt_cam"], cam, iters=iters,
                                         tile=tile)
        if dev.type == "cuda":
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        else:
            ms.append(1e3 * (time.perf_counter() - t0))
    return dict(q=q.cpu().numpy(), p=p.cpu().numpy(), Xw=Xw.cpu().numpy(), ms=ms)
