"""Which collectives the gloo backend takes on CUDA tensors.

Starts two gloo ranks on one card (``torch.multiprocessing.spawn``) and
calls each collective the multi-rank LM training path uses
(``all_to_all_single``, ``all_reduce`` SUM and MAX, ``all_gather``,
``broadcast``) on CUDA tensors of float32, bfloat16 and int32, then checks
the result against the same call's expected values. Prints one line per
call, "ok", "wrong" or the error's first line. A probe: it records what
the installed torch does, nothing in the package depends on it.

  python3 tools/gloo_cuda_probe.py
"""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DTYPES = (torch.float32, torch.bfloat16, torch.int32)


def _calls(rank, dev, dtype):
    """(name, thunk returning (got, want)) for each collective."""
    def a2a():
        src = torch.arange(4, device=dev).to(dtype) + 10 * rank
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src)
        want = torch.tensor([0, 1, 10, 11] if rank == 0 else [2, 3, 12, 13],
                            device=dev).to(dtype)
        return out, want

    def reduce(op, want):
        def f():
            t = torch.full((3,), rank + 1, device=dev).to(dtype)
            dist.all_reduce(t, op=op)
            return t, torch.full((3,), want, device=dev).to(dtype)
        return f

    def gather():
        t = torch.full((2,), rank, device=dev).to(dtype)
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t)
        return torch.cat(parts), torch.tensor([0, 0, 1, 1],
                                              device=dev).to(dtype)

    def bcast():
        t = torch.full((2,), 7 if rank == 0 else 0, device=dev).to(dtype)
        dist.broadcast(t, 0)
        return t, torch.full((2,), 7, device=dev).to(dtype)

    return (("all_to_all_single", a2a),
            ("all_reduce SUM", reduce(dist.ReduceOp.SUM, 3)),
            ("all_reduce MAX", reduce(dist.ReduceOp.MAX, 2)),
            ("all_gather", gather), ("broadcast", bcast))


def _rank(rank, port):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for dtype in DTYPES:
        for name, fn in _calls(rank, dev, dtype):
            try:
                got, want = fn()
                res = "ok" if torch.equal(got.cpu(), want.cpu()) else "wrong"
            except Exception as e:   # a probe: the error is the reading
                res = "error: " + str(e).splitlines()[0][:120]
            dist.barrier()
            if rank == 0:
                print(f"gloo, cuda {str(dtype):15s} {name:18s} {res}",
                      flush=True)
    dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("gloo_cuda_probe: no CUDA device")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    mp.spawn(_rank, args=(port,), nprocs=2, join=True)


if __name__ == "__main__":
    main()
