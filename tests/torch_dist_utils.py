"""Ranks for the port's data-parallel tests: ``run_ranks`` spawns ``world``
processes that join one gloo group through a ``FileStore`` in a temporary
directory (so that pytest-xdist workers never share a port), each with one
torch thread, runs ``fn(rank, world, *args)`` in each and returns their
results in rank order (``torch.save``d to files). Imports no JAX: the ranks
load the port only."""

import faulthandler
import os
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(fn, rank, world, store, out, args):
    faulthandler.enable()
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save({"result": result}, out)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world, *args, timeout=600):
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each in a
    spawned process of a gloo group of ``world``; raises with a rank's
    traceback if any rank fails or outlasts ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="torch_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, store, outs[r], args))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = []
        for r, (p, out) in enumerate(zip(procs, outs)):
            if os.path.exists(out + ".err"):
                with open(out + ".err") as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return [torch.load(out, weights_only=False)["result"] for out in outs]

