"""CPU rank groups for the parity tests of ``rvgrt_tpu_torch/parallel``.

``run_ranks(fn, n, args)`` starts ``n`` processes with
``torch.multiprocessing`` (spawn), joins them into a gloo process group on
a free localhost port, calls ``fn(rank, *args)`` in each and returns the
ranks' results, in rank order.  Each rank runs torch on one thread (the
suite shares the host with other workers and their JAX children).  ``fn``
must be a module-level function (spawn pickles it by name).  The whole
group has one timeout; a rank that fails or a group that overruns raises,
and every process is stopped.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, fn, args, out_dir: str):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        res = fn(rank, *args)
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int = 4, args=(), timeout: float = 600.0) -> list:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(_rank_main,
                                 args=(n, free_port(), fn, tuple(args), d),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{n} ranks of {fn.__name__} ran "
                                       f"over {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(n):
            with open(os.path.join(d, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
