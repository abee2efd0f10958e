"""Multi-process entry: process-group set-up, the global mesh, and a local
launcher (port of loc_lib_tpu/parallel/multihost.py).

`init` joins this process to a torch.distributed world: from its
arguments, or from the usual MASTER_ADDR / MASTER_PORT / RANK /
WORLD_SIZE. A rank computes on the card unless it asks for the CPU: its
LOCAL_RANK's card, else the first, over NCCL; on the CPU over gloo.
Several ranks on ONE card must ask for gloo (NCCL refuses two ranks on one
GPU), which stages CUDA tensors through host memory for its all-reduces
while the compute stays on the card. Without anything configured it is a
no-op (a single-process run).

`launch` runs a function in `world` local processes
(`torch.multiprocessing`), one rank each, joined through a file store, and
returns what each rank's function returned: how the tests drive the
distributed layer on the CPU and how `chip_smoke.py` puts several ranks on
one card. A rank that fails ends the launch: the others are stopped and it
raises with that rank's traceback.
"""

from __future__ import annotations

import importlib
import os
import pickle
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard
from torch.multiprocessing.spawn import ProcessException

from ..ops.pointcloud import card_device
from . import mesh as mesh_mod


def init(init_method: Optional[str] = None, world_size: Optional[int] = None,
         rank: Optional[int] = None, device=None, backend: Optional[str] = None) -> bool:
    """Join the process group; returns False (and does nothing) when no
    world is configured. `device`: the card or CPU this rank computes on
    (default: the card of LOCAL_RANK, else the first; it raises without a
    card); a CUDA device becomes the current one. `backend` defaults to
    NCCL for a CUDA device and gloo otherwise."""
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            if world_size not in (None, 1) or rank not in (None, 0):
                raise ValueError("a world of several ranks needs init_method or "
                                 "MASTER_ADDR / MASTER_PORT")
            return False                      # single-process run
        init_method = "env://"
    if device is None:
        device = card_device(None)
        if "LOCAL_RANK" in os.environ:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size or 1,
                            rank=rank or 0, device_id=device if backend == "nccl" else None)
    return True


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(dp: Optional[int] = None, mp: int = 1) -> DeviceMesh:
    """(dp, mp) mesh over every rank (dp defaults to world_size / mp): map
    shards of one slab group are consecutive ranks."""
    n = dist.get_world_size()
    return mesh_mod.make_mesh_2d(n // mp if dp is None else dp, mp)


def host_local_to_global(mesh: DeviceMesh, local) -> DTensor:
    """A global DTensor assembled from each rank's local block of the
    leading axis, split over every mesh axis (the rank order of
    P(("dp", "mp")))."""
    t = torch.as_tensor(np.asarray(local), device=mesh.device_type)
    return DTensor.from_local(t, mesh, [Shard(0) for _ in mesh.mesh_dim_names],
                              run_check=False)


# ---------------------------------------------------------------------------
# Local launcher
# ---------------------------------------------------------------------------

def launch(target: str, world: int, args=(), *, device="cuda", backend: Optional[str] = None,
           threads: int = 1, timeout: float = 600.0, extra_paths=()) -> list:
    """Run `target` ("module:function") in `world` processes, rank r calling
    function(*args) after `init` on `device` with `backend` (`device="cuda"`:
    rank r on card r mod the number of cards; it raises without a card).
    Returns the list of the ranks' return values. `extra_paths` go on each
    rank's sys.path. Raises RuntimeError if a rank fails or the launch
    outlives `timeout` seconds; every rank process has ended when it
    returns."""
    if str(device) == "cuda":
        card_device(None)
    with tempfile.TemporaryDirectory() as out:
        ctx = torch_mp.start_processes(
            _rank_main, (target, args, world, str(device), backend, threads, out,
                         [str(p) for p in extra_paths]), nprocs=world, join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{target}: {world} ranks outlived {timeout} s")
        except ProcessException as e:
            # every rank that raised wrote its traceback (a peer's failure
            # may end this rank's collectives too)
            errors = sorted(Path(out).glob("error*.txt"), key=lambda f: int(f.stem[5:]))
            ranks = ", ".join(f.stem[5:] for f in errors) or str(e.error_index)
            raise RuntimeError(f"{target}: rank {ranks} of {world} failed:\n"
                               + ("\n".join(f.read_text() for f in errors) or str(e))) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [pickle.loads((Path(out) / f"result{r}.pkl").read_bytes()) for r in range(world)]


def _rank_main(rank: int, target: str, args, world: int, device: str,
               backend: Optional[str], threads: int, out: str, extra_paths: list) -> None:
    sys.path[:0] = extra_paths
    torch.set_num_threads(threads)
    if device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    init(f"file://{out}/store", world, rank, device, backend)
    module, name = target.split(":")
    try:
        result = getattr(importlib.import_module(module), name)(*args)
        dist.barrier()
    except BaseException:
        (Path(out) / f"error{rank}.txt").write_text(f"--- rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()
    (Path(out) / f"result{rank}.pkl").write_bytes(pickle.dumps(result))
